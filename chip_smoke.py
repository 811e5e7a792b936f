#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (socioreasoner_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printing one JSON line; any failure exits non-zero:
  1. device   — nvidia-smi name and power limit; requires CUDA and sm_90.
  2. build    — nvcc builds the kernel library from socioreasoner_tpu_torch/csrc.
  3. kernels  — each CUDA kernel against its plain PyTorch version at the
                shapes of the main path: the error against the plain version
                run in f32 on the same bf16 values, CUDA-event timings of the
                kernel, of the plain version on the bf16 tensors and of the
                one library call that computes the same function (where one
                exists; the port never calls it), and the kernel's bound
                (bytes over the memory rate or operations over the bf16
                peak, whichever is larger); kernels 1, 2, 4, 5 and 6 also at
                edge shapes (GQA ratios 1, 5, 7 and 8 among them) and row by
                row, with their device time and host time a launch; kernel 2
                also at the two_stage phase's stage-2 prefill (L=4096) and at
                each prefill bucket of the grpo phase; kernels 3 and 3q row by
                row at 4, 8 and 32 slots (a zero-length slot exactly 0, two
                calls bit-equal), timed at 4 and 32, and kernel 3 at the
                two_stage phase's cache (Lalloc 4352) and the grpo phase's (24
                slots); kernels 4-6 at the grpo phase's train micro-batch
                (B=2, L=4160) and kernel 4 at its log-prob chunk (B=8); the
                host copies of kernel 2's tile bounds and of the GQA work
                items against the C++ formulas; kernel 6's plan, its refusal
                of other kv lengths (a child process that must fail with a
                CUDA error) and, with kernel 5, determinism.
  4. engine   — DecodeEngine greedy stream (kernels) against a teacher-forced
                uncached forward (dense attention) at Qwen2.5-VL-3B head dims.
  5. train_parity — one GRPO train step with the trainable flash kernels
                against one with dense attention, from identical bf16 params
                at Qwen2.5-VL-3B widths with 2 layers.
  6. quant_parity — at Qwen2.5-VL-3B widths with 2 layers: the quantized
                engine (single-copy int8 weights, int8 KV cache, w8a8
                prefill) greedy against a teacher-forced cache-mode forward
                on the same int8 tree (bf16 cache, no w8a8); one int4
                request; logit figures of each quantized stack against bf16.
  7. main     — Qwen2.5-VL-3B at full width with random bf16 weights answers
                four SocioSeg stage-1 requests (768x768 map + satellite tiles)
                through TorchDecodeStrategy's server; kernels 1-3 must launch.
  8. train    — the GRPO actor path at full width and depth on the main
                phase's params: a rollout of one tile x 4 samples through the
                server, postprocess to 2304 tokens, reference and old
                log-probs, group-normalised rewards and advantages, three
                PPO train steps, model_update and a greedy request with the
                trained weights; kernels 4-6 must launch.
  9. main_quant — the main phase's four requests with every quantization
                knob on (single-copy int8 weights, int8 ViT, int8 KV cache,
                w8a8 prefill), the image embeddings from the strategy's int8
                vision tree; kernels 1, 2 and 3q must launch, kernel 3 not;
                plus the quantized stacks' logit figures at full depth.
  10. two_stage — SocioSegInferPipeline.run() at full width: Qwen2.5-VL-3B
                (the main phase's tree, served as int8 single-copy weights
                with examples/infer/rlvr_tpu.yaml's knobs) and SAM2-hiera-
                large with random bf16 weights over four 768x768 tiles, cut
                to rollout_batch_size 4, response_length 64,
                infer_batch_size 4; after a sequential pass, each stage's
                ViT ms on its batch, then run() measured: tiles/s, the
                engine's figures, 4 PNGs and 2 texts a tile and iou_acc.txt;
                kernels 1-3 must launch in run(), at the attention shapes
                the kernels phase checked; then one decode chunk at the
                stage-2 prompt length under torch.profiler (device ms a step
                and the device's busy share).
  11. sam2    — on the same pipeline, _segment of the four tiles with a
                crafted stage-1 answer (boxes), then a stage-2 answer (boxes
                and points): one encode a tile over both (stage 2 hits the
                cache), (768, 768) uint8 masks, an all-zero mask for an
                answer without answer tags; encoder ms a tile, decoder ms a
                prompt batch; one tile in bf16 against f32.
  12. grpo    — SocioSegPipeline.run(), GRPO over both stages with the
                SocioSeg rule reward, at full width with
                examples/train/rlvr_tpu.yaml's settings (n = 8, int8
                single-copy rollout weights, prefix fork, generate_opt_level
                1, backward_batch_size 8 over 4 accumulation steps, the k3
                KL loss, the reward worker_cls) on the main phase's tree, a
                copy of it as the reference, and SAM2-hiera-large; two 768²
                tiles, cut to response_length 64, two steps and a validation.
                Pass 1 through the real engine: kernels 1-6 must launch, at
                the prefill buckets, cache and train shapes the kernels phase
                checked (GRPO_PREFILL, GRPO_SLOTS/GRPO_LALLOC, GRPO_TRAIN),
                the metrics finite, the reference's log-probs fixed. Pass 2,
                one step through crafted answers: SAM2 masks, rewards that
                differ in each group and equal compute_socioseg_rewards
                recomputed from the pass's texts and masks, grad_norm > 0,
                the actor's log-probs moved and the reference's not;
                kernels 4-6 must launch. Peak memory < 80 GB.
  13. entry   — the system started as users start it: the main phase's
                tree (trained by the grpo phase) written with the port's
                save_pretrained (BF16 shards, config.json) beside an offline
                byte-level HF tokenizer and read back bit for bit; a
                SocioSeg directory of 768² tiles (4 test, 2 train); then
                both entry scripts' main() on examples/{infer,train}/
                rlvr_tpu.yaml overlaid with those paths and the two_stage
                and grpo phases' cuts (the train run: one step, the
                pipeline state saved after it, a jsonl tracker). Every
                policy tree the build functions read must equal the exported one
                (checksums); the infer run must write iou_acc.txt and 4
                PNGs and 2 texts a tile with kernels 1-3 launched, the
                train run finish its step with finite metrics, the tracker
                file and the pipeline checkpoint, kernels 1-6 launched, both
                at the shapes the kernels phase checked. Then a
                TorchTrainStrategy checkpoint round trip at 3B widths with 2
                layers: params and optimizer state restored bit for bit, the
                resumed step against the uninterrupted one. Peak < 80 GB.
  14. row_writer — kernel 7's own path: one decode step's K/V row writes
                into the stacked cache at the diagnostic script's shape (36
                layers, 24 slots, Lalloc 1536), held against the indexed
                assignment.

TF32 is off for matmuls and convolutions, so float32 references are full
float32. Imports nothing of JAX. The last line is the device summary
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

KERNEL_TOL = 2e-2       # max-abs, bf16 output rounding at |out| up to ~4
# Kernels 1-4 are also held row by row: in each (query row, head) the
# max-abs error is at most ROW_TOL of that row's largest |reference| (a row
# that sees no key gives exactly 0). Over a full ViT layer's 2916 keys an
# output is ~0.03, so KERNEL_TOL alone would pass a kernel that dropped or
# doubled a k tile (a change of ~20% of a row); bf16 rounding of P and of
# the output moves a row by a few 2^-9 of its largest element.
ROW_TOL = 2e-2
LSE_TOL = 1e-3          # max-abs of the f32 log-sum-exp (logits of size ~10)
# dq/dk/dv max-abs error as a share of each gradient's max-abs: the outputs
# are bf16 (2^-9 relative rounding) and the kernels round p and ds to bf16
# before their products, as the Pallas kernels do; over sums of thousands of
# such terms the error stays a few tenths of a percent of the largest element
GRAD_REL_TOL = 2e-2
# Kernel 6's dk and dv are held to GRAD_REL_TOL of the largest |reference|
# of the two together (both sum the same p weights; on unit-variance inputs
# their terms are of one size), and row by row, each (key row, kv head) to
# ROW_TOL of its largest |reference| but never of less than GRAD_ROW_FLOOR of
# that joint largest: where ds = p (dP - delta) scale cancels, the reference
# is f32 rounding noise itself (a batch row of kv_len 1, or Lq = 1, sees one
# key, so p = 1 and dP = delta for every query, and dk is 0 exactly).
GRAD_ROW_FLOOR = 1e-3
GAP_TOL = 0.05          # a greedy flip is a tie when the top-2 gap is below this


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, n: int = 20) -> float:
    """Median of n CUDA-event timings of fn() after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, n: int = 20) -> float:
    """Median of n CUDA-event timings of one replay of fn() captured as a
    CUDA graph: fn's device work without the host's launch time."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):          # warm-up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, n)


def graph_call_ms(fn, reps: int = 10) -> float:
    """Device time of one fn() from a CUDA graph of `reps` calls back to back
    (the graph's own launch cost spread over them): kernels 1 and 2 report it
    as their device_ms."""
    return graph_ms(lambda: [fn() for _ in range(reps)]) / reps


def device_ms(fn, kernels, n: int = 5) -> float:
    """Device time of one fn() in the CUDA kernels whose names contain one
    of `kernels` ("" for all), from torch.profiler over n calls after a
    warm-up call: the kernels' own time, without the host's launch time.
    Only device events count (a runtime call carries its kernels' time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and any(k in e.key for k in kernels))
    return us / n / 1e3


# ------------------------------------------------------------------ phases

def _smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    print(_smi_line(), flush=True)
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "capability": list(cap),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build():
    from socioreasoner_tpu_torch.ops import _build
    path, seconds = _build.build(verbose=True)
    _build.library()
    emit({"phase": "build", "library": path.name, "build_s": seconds})


def _check(name, got, want):
    import torch
    err = (got.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    if not finite or not err <= KERNEL_TOL:
        raise AssertionError(f"{name}: max_abs_err {err} > {KERNEL_TOL} (finite={finite})")
    return err


def _check_rows(name, got, want, floor=0.0):
    """_check, and each row (the last dim) held to ROW_TOL of its own largest
    |want|, or of `floor` where that is more. Returns (max-abs error, the
    largest row ratio)."""
    import torch
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(max(floor, torch.finfo(torch.float32).tiny))
    ratio = (diff / scale).max().item()
    if not ratio <= ROW_TOL:
        raise AssertionError(f"{name}: a row's error is {ratio} of its largest |value| "
                             f"> {ROW_TOL}")
    return _check(name, got, want), ratio


# The card's published peaks (NVIDIA H100 SXM data sheet, dense): a kernel's
# bound is the larger of its bytes over the memory rate and its operations
# over the bf16 tensor-core rate, each input byte read once and each output
# byte written once, the operations those of this run's data.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def bound(nbytes: float, flops: float):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _seg_pairs(seg_np) -> int:
    """(query, key) pairs a segment-id mask keeps: the sum of squared
    segment lengths."""
    _, counts = np.unique(np.asarray(seg_np), return_counts=True)
    return int((counts.astype(np.int64) ** 2).sum())


def _causal_pairs(Lq: int, lens, causal: bool = True) -> int:
    """(query, key) pairs of a prefix mask of kv_len keys per batch row,
    under a causal mask: row t sees min(kv_len, t + 1) keys."""
    t = np.arange(Lq)
    return int(sum((np.minimum(int(n), t + 1) if causal else np.full(Lq, int(n))).sum()
                   for n in lens))


def host_us(fn, n: int = 50) -> float:
    """Host microseconds a call of fn() takes to return (its launch cost),
    over n calls queued behind one synchronisation."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _row(name, source, replaces, shape, err, ms, plain_ms, bound_ms, bound_by, library_ms,
         library, **extra):
    """One kernel's record, in the keys of the kernels line."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "library_ms": library_ms, "library": library,
            "library_ratio": None if library_ms is None else ms / library_ms, **extra}


def _check_grad(name, got, want, scale):
    """A gradient held to GRAD_REL_TOL of `scale` (the largest |reference| of
    dk and dv together) and row by row (ROW_TOL, GRAD_ROW_FLOOR of `scale`).
    Returns (max-abs error, its share of `scale`, the largest row ratio)."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    if not finite or not err <= GRAD_REL_TOL * scale:
        raise AssertionError(f"{name}: max_abs_err {err} > {GRAD_REL_TOL} x {scale} "
                             f"(finite={finite})")
    scale = max(scale, torch.finfo(torch.float32).tiny)
    ratio = _check_rows(name, got / scale, want / scale, GRAD_ROW_FLOOR)[1]
    return err, err / scale, ratio


# Kernels 4-6 at edge shapes: (B, Lq, H, Hkv, causal, kv lens, piece cap or
# None for the plan's own); GQA ratios 8, 1, 5 (Qwen2.5-VL-32B's 40 / 8
# heads) and 7 (-7B's 28 / 4), the last two leaving rows of the kernels'
# 128-row items idle
TRAIN_EDGES = ((1, 1, 16, 2, True, [1], None), (2, 63, 16, 2, True, [63, 0], None),
               (2, 65, 16, 2, False, [65, 1], None), (3, 129, 16, 16, True, [129, 1, 0], None),
               (2, 129, 16, 16, False, [129, 64], 1), (2, 200, 16, 2, True, [200, 77], 1),
               (1, 2304, 16, 2, True, [2304], None), (2, 200, 40, 8, True, [200, 77], None),
               (1, 129, 28, 4, False, [129], None))


def _train_edge_checks(randn):
    """Kernels 4-6 at TRAIN_EDGES against their plain versions in f32 on
    the same bf16 values, row by row (kernels 5 and 6 get the plain lse and
    delta; dq is held to the largest |reference| of dq, dk and dv together,
    since where every query sees one key ds cancels and dq is 0 exactly).
    Returns (kernel 4's largest max-abs error, row ratio and lse error;
    kernel 5's and kernel 6's largest share of the gradients' largest value
    and row ratio; the split tiles of each case's plan)."""
    import torch
    from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb
    dev = torch.device("cuda")
    fwd, dq, dkv, splits = [0.0, 0.0, 0.0], [0.0, 0.0], [0.0, 0.0], []
    for B, Lq, H, Hkv, causal, lens, cap in TRAIN_EDGES:
        q, k, v, do = randn(B, Lq, H, 128), randn(B, Lq, Hkv, 128), randn(B, Lq, Hkv, 128), \
            randn(B, Lq, H, 128)
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        tag = f"B={B} Lq={Lq} H={H}/{Hkv} causal={causal} kv_len={lens}"
        out, lse = fb.flash_attention_fwd_lse(q, k, v, lt, causal=causal)
        ref_out, ref_lse = fb.flash_attention_fwd_lse_reference(q.float(), k.float(), v.float(),
                                                                lt, causal)
        err, ratio = _check_rows(f"train fwd edge {tag}", out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"train fwd edge {tag}: lse max_abs_err {lse_err} > {LSE_TOL}")
        fwd = [max(fwd[0], err), max(fwd[1], ratio), max(fwd[2], lse_err)]
        delta = (do.float() * ref_out).sum(-1).transpose(1, 2).contiguous()
        plan = fb.dkv_plan(lt, B, Lq, Lq, H, Hkv, causal, dev, cap=cap)
        splits.append(plan.counters.numel() // 2)
        got = fb.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, lt, causal=causal,
                                         plan=plan)
        want = fb.flash_attention_bwd_reference(q.float(), k.float(), v.float(), do.float(),
                                                ref_lse, delta, lt, causal)
        scale = max(w.abs().max().item() for w in want[1:])
        for name, g, w in zip(("dk", "dv"), got, want[1:]):
            _, rel, ratio = _check_grad(f"train {name} edge {tag}", g, w, scale)
            dkv = [max(dkv[0], rel), max(dkv[1], ratio)]
        got_dq = fb.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, lt, causal=causal)
        _, rel, ratio = _check_grad(f"train dq edge {tag}", got_dq, want[0],
                                    max(scale, want[0].abs().max().item()))
        dq = [max(dq[0], rel), max(dq[1], ratio)]
    if not (0 in splits and max(splits) > 0):
        raise AssertionError(f"the edge plans split no key tile, or every case: {splits}")
    return fwd, dq, dkv, splits


def _edge_checks(randn):
    """Kernels 1, 2, 4 and 6 at edge shapes against their plain versions in
    f32. Returns, for kernels 1 and 2, the largest (max-abs error, row ratio)
    over their cases, and _train_edge_checks' figures."""
    import torch
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda")
    worst = lambda a, b: (max(a[0], b[0]), max(a[1], b[1]))   # noqa: E731
    seg_err = (0.0, 0.0)
    rng = np.random.default_rng(1)
    for S, H, D, kind in ((200, 4, 80, "runs"), (129, 2, 128, "runs"), (300, 2, 80, "single"),
                          (1000, 4, 128, "single"), (333, 3, 80, "dense"),
                          (4100, 2, 128, "two")):
        if kind == "runs":        # random nondecreasing ids, runs of 1-70 tokens
            seg_np = np.repeat(np.arange(S), rng.integers(1, 70, S))[:S]
        elif kind == "single":    # one token per segment
            seg_np = np.arange(S)
        elif kind == "two":       # two long segments (the full layers' shape)
            seg_np = (np.arange(S) >= 1700).astype(np.int64)
        else:                     # arbitrary ids: the dense-safe path
            seg_np = rng.integers(0, 5, S)
        q, k, v = randn(S, H, D), randn(S, H, D), randn(S, H, D)
        seg = torch.as_tensor(seg_np.astype(np.int32))
        span = None if kind == "dense" else fa.seg_max_span_blocks(seg_np, 128, 128)
        got = fa.flash_attention_segmented(q, k, v, seg, max_span_blocks=span)
        want = fa.flash_attention_segmented_reference(q.float(), k.float(), v.float(), seg)
        seg_err = worst(seg_err, _check_rows(f"segmented edge S={S} D={D} {kind}", got, want))
    pre_err = (0.0, 0.0)
    # (B, Lq, D, causal, H, Hkv): GQA ratios 8 and, leaving rows of the
    # 128-row items idle, 5 and 7
    for B, Lq, D, causal, H, Hkv in ((1, 1, 128, True, 16, 2), (4, 63, 128, True, 16, 2),
                                     (4, 129, 80, True, 16, 2), (1, 2048, 128, True, 16, 2),
                                     (4, 129, 128, False, 16, 2), (1, 63, 80, False, 16, 2),
                                     (2, 200, 128, True, 40, 8), (3, 129, 128, False, 28, 4),
                                     (2, 150, 80, True, 14, 2)):
        q, k, v = randn(B, Lq, H, D), randn(B, Lq, Hkv, D), randn(B, Lq, Hkv, D)
        lens = [Lq, 0, 1, max(Lq // 2, 1)][:B]
        mask = (torch.arange(Lq, device=dev)[None]
                < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
        got = fa.flash_attention(q, k, v, mask, causal=causal)
        want = fa.flash_attention_reference(q.float(), k.float(), v.float(), mask,
                                            causal=causal)
        pre_err = worst(pre_err, _check_rows(
            f"prefill edge B={B} Lq={Lq} H={H}/{Hkv} D={D} causal={causal}", got, want))
    return seg_err, pre_err, _train_edge_checks(randn)


def _prefill_bounds_check() -> int:
    """fa.prefill_tile_bounds and fa.gqa_work_item, the host copies of the
    k-tile formula and the work items of kernels 2, 4 and 5 that the CPU
    tests check, against the C++ formulas themselves (socio_prefill_tile_bounds
    runs prefill_k_tiles and socio_gqa_item gqa_item on the host), over the
    CPU tests' grid and out-of-range kv_len. Returns the cases compared."""
    import ctypes
    from socioreasoner_tpu_torch.ops import _build
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    lib = _build.library()
    out = (ctypes.c_int * 4)()
    n = 0
    for B, Lq, Hkv in ((1, 1, 1), (3, 200, 2), (2, 129, 3), (4, 2304, 2)):
        for rep in (1, 2, 5, 7, 8):
            toks = fa.KERNEL_Q_TILE // rep
            for item in range(-(-Lq // toks) * B * Hkv):
                _build.check(lib.socio_gqa_item(item, B, Lq, Hkv, rep, ctypes.addressof(out)),
                             "socio_gqa_item")
                host = (*fa.gqa_work_item(item, B, Lq, Hkv, rep), toks)
                if tuple(out) != host:
                    raise AssertionError(f"gqa_work_item{(item, B, Lq, Hkv, rep)} = {host}, "
                                         f"the kernels' formula gives {tuple(out)}")
                n += 1
    for Lq in (1, 63, 129, 200, 2048):
        for rep in (1, 2, 5, 7, 8):
            toks = fa.KERNEL_Q_TILE // rep
            for causal in (True, False):
                for Lk in sorted({Lq, Lq + 37}):
                    for kv_len in sorted({-1, 0, 1, Lk // 2, Lk, Lk + 5}):
                        for tt in range(-(-Lq // toks)):
                            _build.check(lib.socio_prefill_tile_bounds(
                                tt, kv_len, Lq, Lk, rep, int(causal), ctypes.addressof(out)),
                                "socio_prefill_tile_bounds")
                            host = fa.prefill_tile_bounds(tt, kv_len, Lq, Lk, rep, causal)
                            if tuple(out)[:2] != host:
                                raise AssertionError(
                                    f"prefill_tile_bounds{(tt, kv_len, Lq, Lk, rep, causal)} "
                                    f"= {host}, the kernel's formula gives {tuple(out)[:2]}")
                            n += 1
    return n


def _window_library(q, k, v, seg_np):
    """One library call of segment-wise attention over the window layers'
    segments, with the layout copy it needs: varlen flash attention on
    cu_seqlens from the ids where torch has it, else SDPA on a jagged nested
    tensor of the windows. Returns (fn, name)."""
    import torch
    import torch.nn.functional as F
    _, counts = np.unique(seg_np, return_counts=True)
    cu = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32,
                         device=q.device)
    longest = int(counts.max())
    try:
        from torch.nn.attention.varlen import varlen_attn
    except ImportError:
        varlen_attn = None
    if varlen_attn is not None:
        return (lambda: varlen_attn(q, k, v, cu, cu, longest, longest),
                "torch.nn.attention.varlen.varlen_attn")
    offsets = cu.long()

    def nested():
        qn, kn, vn = (torch.nested.nested_tensor_from_jagged(x, offsets).transpose(1, 2)
                      for x in (q, k, v))
        return F.scaled_dot_product_attention(qn, kn, vn)
    return nested, "scaled_dot_product_attention on a jagged nested tensor"


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes, with
    its bound and the time of the one library call that computes the same
    function (a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import VisionConfig
    from socioreasoner_tpu_torch.models.qwen2_5_vl.rope import vision_window_index
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    results = []
    seg_edge, pre_edge, train_edge = _edge_checks(randn)

    # segmented: two 756x756 images (the resize of a 768-px tile), 16 x 80
    vcfg = VisionConfig()
    grid = np.array([[1, 54, 54], [1, 54, 54]])
    _, window_seg, full_seg = vision_window_index(grid, vcfg)
    S, H, D = len(window_seg), 16, 80
    q, k, v = randn(S, H, D), randn(S, H, D), randn(S, H, D)
    bq, bk = fa.seg_block_sizes(S)
    maxk = max(fa.seg_max_span_blocks(window_seg, bq, bk),
               fa.seg_max_span_blocks(full_seg, bq, bk))
    errs, layer = [], {}
    for seg_np, span in ((window_seg, maxk), (full_seg, maxk), (window_seg, None)):
        seg = torch.as_tensor(seg_np)
        # as the ViT calls it: the plan built once for all its layers
        make_plan = lambda: fa.seg_plan(   # noqa: E731
            seg, H, dev, block_q=bq, block_k=bk, max_span_blocks=span)
        plan = make_plan()
        run = lambda: fa.flash_attention_segmented(   # noqa: E731
            q, k, v, seg, block_q=bq, block_k=bk, max_span_blocks=span, plan=plan)
        ref = lambda: fa.flash_attention_segmented_reference(   # noqa: E731
            q.float(), k.float(), v.float(), seg)
        errs.append(_check_rows(f"segmented span={span}", run(), ref()))
        if span is not None:
            plain = lambda: fa.flash_attention_segmented_reference(   # noqa: E731
                q, k, v, seg)
            full = seg_np is full_seg
            if full:   # the two images as two batch rows of one SDPA call
                qb, kb, vb = (x.reshape(2, S // 2, H, D).transpose(1, 2) for x in (q, k, v))
                lib = lambda: F.scaled_dot_product_attention(qb, kb, vb)   # noqa: E731
                lib_name = "scaled_dot_product_attention (2, 16, 2916, 80)"
            else:
                lib, lib_name = _window_library(q, k, v, seg_np)
            layer[full] = {"ms": cuda_ms(run), "plain_ms": cuda_ms(plain, n=10),
                           "device_ms": graph_call_ms(run),
                           "library_ms": cuda_ms(lib), "library": lib_name,
                           "host_us": host_us(run), "plan_us": host_us(make_plan, n=10),
                           "bound": bound(4 * S * H * D * 2, 4 * D * H * _seg_pairs(seg_np))}
    try:
        fa.flash_attention_segmented(q, k, v, torch.as_tensor(full_seg),
                                     block_q=bq, block_k=bk,
                                     max_span_blocks=maxk - 1)
    except ValueError:
        pass
    else:
        raise AssertionError("an underestimated max_span_blocks did not raise")
    # per tile: the tower's 28 window layers and 4 full-attention layers
    n_full = len(vcfg.fullatt_block_indexes)
    n_win = vcfg.depth - n_full
    win, full = layer[False], layer[True]
    per_tile = lambda key: n_win * win[key] + n_full * full[key]   # noqa: E731
    tile_bound = n_win * win["bound"][0] + n_full * full["bound"][0]
    results.append(_row(
        "flash_attention_segmented", "socioreasoner_tpu_torch/csrc/flash_segmented.cu",
        "socioreasoner_tpu/ops/flash_attention.py:95",
        f"S={S} H=16 D=80, ms per tile = {n_win} window + {n_full} full layers",
        max(e for e, _ in errs), per_tile("ms"), per_tile("plain_ms"), tile_bound,
        # the window layers' bytes outweigh the full layers' operations
        "bytes" if n_win * win["bound"][0] >= n_full * full["bound"][0] else "operations",
        per_tile("library_ms"), f"{n_win} x {win['library']} + {n_full} x {full['library']}",
        window=win, full_layer=full, device_ms=per_tile("device_ms"),
        max_row_ratio=max(r for _, r in errs), edge_max_abs_err=seg_edge[0],
        edge_max_row_ratio=seg_edge[1]))
    emit({"phase": "kernel", **results[-1]})

    # prefill: 16 q / 2 kv heads, D=128; checked and timed at the L=2048
    # bucket at B=2 with kv lens {2016, 1} and at the main phase's prefill
    # (four 2016-token prompts), and at the two_stage phase's stage-2 prefill
    def prefill_case(lens, L=2048):
        B = len(lens)
        q, k, v = randn(B, L, 16, 128), randn(B, L, 2, 128), randn(B, L, 2, 128)
        mask = (torch.arange(L, device=dev)[None]
                < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
        run = lambda: fa.flash_attention(q, k, v, mask, causal=True)   # noqa: E731
        # the f32 reference a batch row at a time: at B=16, L=4096 its
        # scores alone would take 17 GB
        err, ratio = _check_rows(f"prefill kv_len={lens}", run(), torch.cat([
            fa.flash_attention_reference(q[b:b + 1].float(), k[b:b + 1].float(),
                                         v[b:b + 1].float(), mask[b:b + 1], causal=True)
            for b in range(B)]))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        return {"err": err, "ratio": ratio, "ms": cuda_ms(run), "device_ms": graph_call_ms(run),
                "library_ms": cuda_ms(lib), "host_us": host_us(run),
                "bound": bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                               4 * 128 * 16 * _causal_pairs(L, lens)),
                "plain": lambda: fa.flash_attention_reference(q, k, v, mask, causal=True)}

    def summary(case, shape):
        return {"shape": shape, **{key: case[key] for key in (
            "err", "ratio", "ms", "device_ms", "library_ms")},
            "bound_ms": case["bound"][0], "bound_by": case["bound"][1]}

    check, main = prefill_case([2016, 1]), prefill_case([2016] * 4)
    L2, n2 = TWO_STAGE_PREFILL["L"], TWO_STAGE_PREFILL["kv_len"]
    stage2 = {B: prefill_case([n2] * B, L2) for B in TWO_STAGE_PREFILL["batches"]}
    grpo = {(B, L): prefill_case(_grpo_prefill_lens(B, L), L) for B, L in GRPO_PREFILL}
    cases = (check, main, *stage2.values(), *grpo.values())
    results.append(_row(
        "flash_attention", "socioreasoner_tpu_torch/csrc/flash_prefill.cu",
        "socioreasoner_tpu/ops/flash_attention.py:37",
        "B=2 L=2048 H=16 Hkv=2 D=128 kv_len=2016,1", max(c["err"] for c in cases),
        check["ms"], cuda_ms(check["plain"], n=10), *check["bound"], check["library_ms"],
        "scaled_dot_product_attention(is_causal=True, enable_gqa=True) on (B, H, L, D) "
        "views; it differs from the kernel only on rows past kv_len, which the engine "
        "discards", device_ms=check["device_ms"], host_us=check["host_us"],
        max_row_ratio=max(c["ratio"] for c in cases),
        main_prefill=summary(main, "B=4 L=2048 kv_len=2016 x 4, one layer of the main "
                                   "phase's prefill"),
        # B=4: the sequential pass; B=2: each restage group of run()
        two_stage_prefill={f"B{B}": summary(case, f"B={B} L={L2} kv_len={n2} x {B}, one "
                                                  "layer of the two_stage phase's stage-2 "
                                                  "prefill")
                           for B, case in stage2.items()},
        # each (B, L) bucket the grpo phase's engine may prefill
        grpo_prefill={f"B{B}_L{L}": summary(case, f"B={B} L={L} kv_len="
                                                  f"{_grpo_prefill_lens(B, L)}")
                      for (B, L), case in grpo.items()},
        edge_max_abs_err=pre_edge[0], edge_max_row_ratio=pre_edge[1],
        bounds_checked=_prefill_bounds_check()))
    emit({"phase": "kernel", **results[-1]})

    results.extend(_decode_kernels(randn))
    results.extend(_train_kernels(randn, train_edge))
    for row, grpo_cases in zip(results[-3:], _grpo_train_kernels(randn)):
        row["grpo"] = grpo_cases
        emit({"phase": "kernel_grpo_shapes", "name": row["name"], **grpo_cases})
    results.append(_row_writer_kernel(randn))
    return results


# The two_stage phase's attention shapes, checked in phase_kernels and held to
# that phase's engine: stage-2 prompts of 2155 tokens (stage 1's are 2016) in
# the prompt_length bucket, prefilled four at a time by the sequential pass
# and two at a time by each restage group of run(); the cache of
# sequence_length 4096 + 64, Lalloc = ceil((4160 + 64) / 256) * 256.
TWO_STAGE_PREFILL = {"L": 4096, "kv_len": 2155, "batches": (4, 2)}
TWO_STAGE_LALLOC = 4352
# the main phase's cache: max_len 2560 + 64, decode_chunk 16
MAIN_LALLOC = -(-(2560 + 64 + 16) // 256) * 256
# The grpo phase's attention shapes, checked in phase_kernels and held to
# that phase's pass over the real engine. Prefill (B, L) buckets: stage-1
# prompts of 2016 tokens at L=2048, one or two distinct prompts a prefill
# (the 8 samples of a prompt fork its prefill); stage-2 prompts of ~2155 at
# L=4096, a restage group of 8 or up to 11 waiting requests (16,384 image
# rows) a prefill, padded to a batch bucket. The cache: 24 slots
# (actor_infer.infer_batch_size) of sequence_length 4096 + 64 with
# decode_chunk 64, Lalloc 4352. Training at sequence_length 4160: micro-
# batches of backward_batch_size 8 / gradient_accumulation_steps 4 = 2
# rows (kernels 4-6) and log-prob chunks of infer_batch_size 8 (kernel 4),
# the kv lengths those of a stage-1 (2016 + 64) and a stage-2 (~2155 + 64)
# sample; 4160 is no multiple of 128, so each row ends in a 64-token tile.
GRPO_PREFILL = ((1, 2048), (2, 2048), (1, 4096), (2, 4096), (4, 4096), (8, 4096),
                (16, 4096))
GRPO_SLOTS = 24
GRPO_LALLOC = TWO_STAGE_LALLOC
GRPO_TRAIN = {"L": 4160, "train_batch": 2, "logprob_batch": 8, "kv_lens": (2080, 2219)}


def _grpo_prefill_lens(B: int, L: int):
    """kv lengths of a grpo prefill bucket: its prompts, and a padded row
    (one valid token) where B > 1."""
    n = 2016 if L == 2048 else TWO_STAGE_PREFILL["kv_len"]
    return [n] * (B - 1) + [1] if B > 1 else [n]


# Kernels 3 and 3q: (case, slots, Lalloc, lengths) of the checks. "main" is
# the main phase's decode (prompts of 2016 tokens and fewer); "edges" the
# edges of a block; "slots32" the production slot count
# (examples/infer/rlvr_tpu.yaml:25) with mixed lengths; "two_stage" that
# phase's bf16 cache with an idle slot and stage-1 and stage-2 lengths, and
# "grpo" the grpo phase's 24-slot cache likewise (kernel 3 only: neither
# phase runs an int8 cache). All but "edges" are timed.
DECODE_CASES = (
    ("main", 4, MAIN_LALLOC, (0, 1, 1500, -3)),
    ("edges", 8, MAIN_LALLOC, (0, 1, 2, 63, 64, 65, 2016, -1)),
    ("slots32", 32, MAIN_LALLOC, (0, 1, 64, -1) + tuple((97 * i) % 2816 for i in range(1, 29))),
    ("two_stage", 4, TWO_STAGE_LALLOC, (0, 2079, 2155, 2218)),
    ("grpo", GRPO_SLOTS, GRPO_LALLOC, (0, 1, 2016, 2017, 2040, 2079, 2080, 2155, 2156, 2180,
                                       2218, 2219) + tuple(2016 + 9 * i for i in range(12))))


def _decode_caches(randn, slots, Lalloc, quant):
    """The stacked 36-layer caches (k, v) or, for kernel 3q, (k codes, v
    codes, k scales, v scales) from quantize_kv, scales (36, S, 2, Lalloc)."""
    from socioreasoner_tpu_torch.ops import decode_attention as da
    if not quant:
        return randn(36, slots, Lalloc, 2, 128), randn(36, slots, Lalloc, 2, 128)
    codes, scales = [], []
    for _ in range(2):
        code, scale = da.quantize_kv(randn(36 * slots, Lalloc, 2, 128))
        codes.append(code.reshape(36, slots, Lalloc, 2, 128))
        scales.append(scale.reshape(36, slots, Lalloc, 2).transpose(-1, -2).contiguous())
        del code, scale
    return (*codes, *scales)


def _decode_kernels(randn):
    """Kernels 3 (bf16 cache) and 3q (int8 codes with f32 scales) over the
    stacked cache (36, S, Lalloc, 2, 128) at DECODE_CASES: each (slot, q head)
    row against the plain version in f32 on the same values (ROW_TOL; a
    zero-length slot exactly 0) at layers 0, 17 and 35, two calls bit-equal;
    per layer over a sweep of all 36 layers (a layer's blocks come from HBM as
    in the decode step, not L2): ms, device ms from a CUDA graph of the sweep
    (the torch.profiler figure beside it), host us a call, the plain
    version's and the library call's ms, the bound."""
    import torch
    import torch.nn.functional as F
    from socioreasoner_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    rows = []
    for quant in (False, True):
        name = "paged_decode_attention_int8" if quant else "paged_decode_attention"
        plain_fn = (da.paged_decode_attention_int8_reference if quant
                    else da.paged_decode_attention_reference)
        errs, ratios, timed = [], [], {}
        for case, slots, Lalloc, lens in DECODE_CASES:
            if quant and case in ("two_stage", "grpo"):
                continue
            lens = [n % Lalloc if n < 0 else n for n in lens]
            caches = _decode_caches(randn, slots, Lalloc, quant)
            k, v, scales = caches[0], caches[1], caches[2:]
            q = randn(slots, 16, 128)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            for layer in (0, 17, 35):
                got = da.paged_decode_attention(q, k, v, lengths, *scales, layer=layer)
                tag = f"{name} {case} S={slots} Lalloc={Lalloc} layer={layer}"
                if not torch.equal(got, da.paged_decode_attention(q, k, v, lengths, *scales,
                                                                  layer=layer)):
                    raise AssertionError(f"{tag}: two calls on the same inputs differ")
                if got[lengths == 0].any():
                    raise AssertionError(f"{tag}: a zero-length slot is not 0")
                if quant:
                    want = plain_fn(q.float(), k, v, lengths, *scales, layer=layer)
                else:
                    want = plain_fn(q.float(), k[layer].float(), v[layer].float(), lengths)
                err, ratio = _check_rows(tag, got, want)
                errs.append(err)
                ratios.append(ratio)
            if case != "edges":
                sweep = lambda: [da.paged_decode_attention(   # noqa: E731
                    q, k, v, lengths, *scales, layer=i) for i in range(36)]
                plain = lambda: [plain_fn(q, k, v, lengths, *scales, layer=i)   # noqa: E731
                                 for i in range(36)]
                n_keys = sum(lens)
                # q read and the output written (bf16), and each valid key's K
                # and V rows of both kv heads once: bf16, or int8 codes and an
                # f32 scale a row
                row_bytes = 128 + 4 if quant else 128 * 2
                figures = {
                    "lengths": lens, "n_split": da.decode_plan(
                        q, k, v, lengths, *scales, stacked=True).n_split,
                    "ms": cuda_ms(sweep) / 36, "device_ms": graph_call_ms(sweep, reps=1) / 36,
                    "profiler_device_ms": device_ms(sweep, ("paged_decode",)) / 36,
                    "host_us": host_us(lambda: da.paged_decode_attention(
                        q, k, v, lengths, *scales, layer=17)),
                    "plain_ms": cuda_ms(plain, n=10) / 36,
                    "bound": bound(2 * (2 * q.numel()) + n_keys * 2 * 2 * row_bytes,
                                   4 * 128 * 16 * n_keys)}
                if not quant:
                    # the library call: one query per slot over the layer's
                    # cache view with a boolean length mask (rows of length 0
                    # give NaN there)
                    keep = (torch.arange(Lalloc, device=dev)[None]
                            < lengths[:, None])[:, None, None]
                    q4 = q[:, :, None]
                    figures["library_ms"] = cuda_ms(lambda: [F.scaled_dot_product_attention(
                        q4, k[i].transpose(1, 2), v[i].transpose(1, 2), attn_mask=keep,
                        enable_gqa=True) for i in range(36)], n=10) / 36
                timed[case] = figures
            del caches, k, v, scales
            torch.cuda.empty_cache()

        def summary(fig):
            return {key: fig[key] for key in ("lengths", "n_split", "ms", "device_ms",
                                              "profiler_device_ms", "host_us", "plain_ms")} \
                | {"bound_ms": fig["bound"][0], "bound_by": fig["bound"][1],
                   "library_ms": fig.get("library_ms")}

        main = timed["main"]
        kind = "int8 cache + f32 scales" if quant else "cache"
        shapes = f"(36, 4|8|32, {MAIN_LALLOC}, 2, 128)" + (
            "" if quant else f" and (36, 4|{GRPO_SLOTS}, {TWO_STAGE_LALLOC}, 2, 128)")
        extra = {} if quant else {"two_stage": summary(timed["two_stage"]),
                                  "grpo": summary(timed["grpo"])}
        rows.append(_row(
            name, "socioreasoner_tpu_torch/csrc/paged_decode.cu",
            "socioreasoner_tpu/ops/decode_attention.py:36",
            f"{kind} {shapes}, 16 q heads, ms per layer at S=4",
            max(errs), main["ms"], main["plain_ms"], *main["bound"],
            main.get("library_ms"),
            "none: no single call dequantizes and attends" if quant else
            "scaled_dot_product_attention(enable_gqa=True), one query per slot, boolean "
            "length mask, per layer",
            device_ms=main["device_ms"], profiler_device_ms=main["profiler_device_ms"],
            host_us=main["host_us"], n_split=main["n_split"], max_row_ratio=max(ratios),
            bit_equal_twice=True, slots32=summary(timed["slots32"]), **extra))
        emit({"phase": "kernel", **rows[-1]})
    return rows


ROW_WRITER_SHAPE = (36, 24, 1536, 2, 128)   # scripts/profile_decode2.py:17-18, 33-36


def _row_writer_kernel(randn):
    """Kernel 7 at the diagnostic script's shape: one layer's rows written
    at positions that include both ends of the cache and three out of
    range, against the plain version (must be equal: it is a copy), and
    every other row untouched; then both timed over all 36 layers for k
    and v, the script's own comparison."""
    import torch
    from socioreasoner_tpu_torch.ops import cache_write as cw

    L, S, Lalloc = ROW_WRITER_SHAPE[:3]
    k0, v0 = randn(*ROW_WRITER_SHAPE), randn(*ROW_WRITER_SHAPE)
    knew, vnew = randn(S, 1, 2, 128), randn(S, 1, 2, 128)
    pos_np = np.random.default_rng(7).integers(0, Lalloc, S)
    pos_np[:5] = [0, Lalloc - 1, -1, Lalloc, 100000]
    positions = torch.as_tensor(pos_np, dtype=torch.int32, device=k0.device)
    layer = 17
    kk, vk = cw.write_rows(k0.clone(), v0.clone(), knew, vnew, positions, layer)
    kp, vp = cw.write_rows_reference(k0.clone(), v0.clone(), knew, vnew, positions, layer)
    if not (torch.equal(kk, kp) and torch.equal(vk, vp)):
        raise AssertionError("write_rows differs from its plain version")
    valid = (pos_np >= 0) & (pos_np < Lalloc)
    want = torch.zeros(L, S, Lalloc, dtype=torch.bool, device=k0.device)
    want[layer, torch.as_tensor(np.flatnonzero(valid)), torch.as_tensor(pos_np[valid])] = True
    for got, old in ((kk, k0), (vk, v0)):
        if not torch.equal((got != old).any(-1).any(-1), want):
            raise AssertionError("write_rows changed rows other than the written ones")
    del kk, vk, kp, vp
    # the script's comparison: all 36 layers, k and v, every slot at 520
    positions = torch.full((S,), 520, dtype=torch.int32, device=k0.device)
    bidx = torch.arange(S, device=k0.device)[:, None]
    pos2 = positions.long()[:, None]

    def kernel_sweep():
        for i in range(L):
            cw.write_rows(k0, v0, knew, vnew, positions, i)

    def plain_sweep():
        for i in range(L):
            k0[i, bidx, pos2] = knew
            v0[i, bidx, pos2] = vnew

    # per layer and cache: the new rows read once and written once
    out = _row("write_rows", "socioreasoner_tpu_torch/csrc/cache_write.cu",
               "scripts/profile_decode2.py:50",
               f"caches {ROW_WRITER_SHAPE} bf16, rows (24, 1, 2, 128), ms per sweep of 36 "
               "layers x (k and v) replayed as one CUDA graph (the script times one jitted "
               "loop); eager_ms with the host's launches",
               0.0, graph_ms(kernel_sweep), graph_ms(plain_sweep),
               *bound(L * 2 * 2 * knew.numel() * 2, 0), None,
               "none beyond the two index_put_ calls, which are its plain version",
               eager_ms=cuda_ms(kernel_sweep), plain_eager_ms=cuda_ms(plain_sweep),
               device_ms=device_ms(kernel_sweep, ("write_rows",)),
               plain_device_ms=device_ms(plain_sweep, ("",)))
    emit({"phase": "kernel", **out})
    del k0, v0
    torch.cuda.empty_cache()
    return out


def _train_kernels(randn, edge):
    """Kernels 4-6 at the train shape (B=4, L=2304, 16/2 heads x 128, causal,
    kv lengths 2304, 2080, 1000, 1) against their plain versions in f32 on
    the same bf16 values, row by row; the backward kernels get the plain lse
    and delta, so each kernel is held alone. Kernel 6 runs on a plan built
    once, as the train step builds it, and must refuse a plan built for other
    kv lengths; two calls of kernel 5 and two of kernel 6 must agree bit for
    bit. `edge`: _train_edge_checks' figures."""
    import torch
    import torch.nn.functional as F
    from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb

    B, L = 4, 2304
    q, k, v, do = randn(B, L, 16, 128), randn(B, L, 2, 128), randn(B, L, 2, 128), \
        randn(B, L, 16, 128)
    lens = torch.tensor([2304, 2080, 1000, 1], dtype=torch.int32, device=q.device)
    shape = "B=4 L=2304 H=16 Hkv=2 D=128 causal kv_len=2304,2080,1000,1"
    fwd_edge, dq_edge, dkv_edge, edge_splits = edge
    out, lse = fb.flash_attention_fwd_lse(q, k, v, lens)
    ref_out, ref_lse = fb.flash_attention_fwd_lse_reference(q.float(), k.float(),
                                                            v.float(), lens)
    err, ratio = _check_rows("train fwd out", out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"train fwd lse: max_abs_err {lse_err} > {LSE_TOL}")
    # the library calls take the kv heads expanded to the 16 q heads (made
    # here, outside the timing) in (B, H, L, D) views; they differ from the
    # kernels only on rows past kv_len
    qt, dot = q.transpose(1, 2), do.transpose(1, 2)
    kt, vt = (x.repeat_interleave(8, dim=2).transpose(1, 2) for x in (k, v))
    pairs = 16 * _causal_pairs(L, lens.tolist())       # (query head, key) pairs
    f32_rows = B * 16 * L * 4                          # one f32 per (b, head, row)
    qkv_bytes = 2 * (q.numel() + k.numel() + v.numel())
    fwd_lib = lambda: torch.ops.aten._scaled_dot_product_flash_attention(   # noqa: E731
        qt, kt, vt, is_causal=True)
    run_fwd = lambda: fb.flash_attention_fwd_lse(q, k, v, lens)   # noqa: E731
    results = [_row(
        "flash_attention_fwd_lse", "socioreasoner_tpu_torch/csrc/flash_train_fwd.cu",
        "socioreasoner_tpu/ops/flash_attention_bwd.py:32", shape, err, cuda_ms(run_fwd),
        cuda_ms(lambda: fb.flash_attention_fwd_lse_reference(q, k, v, lens), n=10),
        *bound(qkv_bytes + 2 * q.numel() + f32_rows, 4 * 128 * pairs),
        cuda_ms(fwd_lib), "torch.ops.aten._scaled_dot_product_flash_attention(is_causal=True), "
        "which also returns the lse", device_ms=graph_call_ms(run_fwd),
        host_us=host_us(run_fwd), max_row_ratio=ratio, lse_max_abs_err=lse_err,
        edge_max_abs_err=fwd_edge[0], edge_max_row_ratio=fwd_edge[1],
        edge_lse_max_abs_err=fwd_edge[2])]
    emit({"phase": "kernel", **results[-1]})
    del out, lse

    delta = (do.float() * ref_out).sum(-1).transpose(1, 2).contiguous()
    # kernel 6's plan, built once for the shape as the train step builds it
    # for its 36 layers
    make_plan = lambda: fb.dkv_plan(lens, B, L, L, 16, 2, True, q.device)   # noqa: E731
    plan = make_plan()
    items = plan.items.cpu().numpy()
    per_cta = np.add.reduceat(items[:, 6], plan.cta_start.cpu().numpy()[:-1])
    plan_info = {"items": len(items), "ctas": plan.n_cta, "pairs": int(items[:, 6].sum()),
                 "even_share": float(items[:, 6].sum()) / plan.n_cta,
                 "heaviest_piece": int(items[:, 6].max()), "busiest_cta": int(per_cta.max()),
                 "split_tiles": plan.counters.numel() // 2,
                 "workspace_bytes": plan.workspace.numel() * 4,
                 "plan_us": host_us(make_plan, n=10)}
    emit({"phase": "dkv_plan", "shape": shape, **plan_info})
    run_dkv = lambda: fb.flash_attention_bwd_dkv(   # noqa: E731
        q, k, v, do, ref_lse, delta, lens, plan=plan)
    run_dq = lambda: fb.flash_attention_bwd_dq(   # noqa: E731
        q, k, v, do, ref_lse, delta, lens)
    got = {"dq": run_dq()}
    if not torch.equal(run_dq(), got["dq"]):
        raise AssertionError("kernel 5: two calls on the same inputs differ")
    got["dk"], got["dv"] = run_dkv()
    again = run_dkv()
    if not (torch.equal(again[0], got["dk"]) and torch.equal(again[1], got["dv"])):
        raise AssertionError("kernel 6: two calls on the same inputs differ")
    del again
    want = dict(zip(("dq", "dk", "dv"), fb.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), do.float(), ref_lse, delta, lens)))
    errs = {}
    for g in ("dq", "dk", "dv"):
        scale = want[g].abs().max().item()
        errs[g] = (got[g].float() - want[g]).abs().max().item()
        finite = bool(torch.isfinite(got[g].float()).all())
        if not finite or not errs[g] <= GRAD_REL_TOL * scale:
            raise AssertionError(f"train {g}: max_abs_err {errs[g]} > {GRAD_REL_TOL} x "
                                 f"{scale} (finite={finite})")
        errs[g + "_rel"] = errs[g] / scale
    scale = max(want["dk"].abs().max().item(), want["dv"].abs().max().item())
    dkv_ratio = max(_check_grad(f"train {g}", got[g], want[g], scale)[2] for g in ("dk", "dv"))
    dq_ratio = _check_grad("train dq", got["dq"], want["dq"], want["dq"].abs().max().item())[2]
    del got, want
    # the plain backward computes dq, dk and dv together, and so does the
    # library's (SDPA's autograd backward): each time stands beside both
    # backward kernels
    plain_bwd = cuda_ms(lambda: fb.flash_attention_bwd_reference(
        q, k, v, do, ref_lse, delta, lens), n=10)
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, dot, retain_graph=True))
    del lib_out, leaves
    lib_name = "scaled_dot_product_attention(is_causal=True) autograd backward (dq, dk, dv)"
    note = "plain_ms is the whole plain backward (dq, dk and dv)"
    bwd_in = qkv_bytes + 2 * do.numel() + 2 * f32_rows     # q, k, v, do, lse, delta
    results.append(_row(
        "flash_attention_bwd_dq", "socioreasoner_tpu_torch/csrc/flash_train_dq_sm90.cu",
        "socioreasoner_tpu/ops/flash_attention_bwd.py:75", shape, errs["dq"], cuda_ms(run_dq),
        plain_bwd, *bound(bwd_in + 2 * q.numel(), 6 * 128 * pairs), lib_bwd, lib_name,
        rel_err=errs["dq_rel"], max_row_ratio=dq_ratio, device_ms=graph_call_ms(run_dq),
        host_us=host_us(run_dq), bit_equal_twice=True, edge_max_rel_err=dq_edge[0],
        edge_max_row_ratio=dq_edge[1], note=note))
    emit({"phase": "kernel", **results[-1]})
    results.append(_row(
        "flash_attention_bwd_dkv", "socioreasoner_tpu_torch/csrc/flash_train_dkv_sm90.cu",
        "socioreasoner_tpu/ops/flash_attention_bwd.py:111", shape,
        max(errs["dk"], errs["dv"]), cuda_ms(run_dkv),
        plain_bwd, *bound(bwd_in + 2 * (k.numel() + v.numel()), 8 * 128 * pairs),
        lib_bwd, lib_name, rel_err=max(errs["dk_rel"], errs["dv_rel"]),
        dk_max_abs_err=errs["dk"], dv_max_abs_err=errs["dv"], max_row_ratio=dkv_ratio,
        device_ms=graph_call_ms(run_dkv), host_us=host_us(run_dkv), plan=plan_info,
        bit_equal_twice=True, edge_max_rel_err=dkv_edge[0], edge_max_row_ratio=dkv_edge[1],
        edge_split_tiles=edge_splits, plan_mismatch=_dkv_plan_mismatch(),
        note=note + "; ms with the plan built once, as the train step builds it (plan_us "
        "apart)"))
    emit({"phase": "kernel", **results[-1]})
    torch.cuda.empty_cache()
    return results


def _grpo_train_kernels(randn):
    """Kernels 4-6 at the grpo phase's train micro-batch (B=2, L=4160) and
    kernel 4 at its log-prob chunk (B=8), kv lengths of stage-1 and stage-2
    samples (GRPO_TRAIN), against their plain versions in f32 a batch row at
    a time, row by row (kernel 6 on a plan built once, against the joint
    scale of dk and dv with GRAD_ROW_FLOOR), each timed with its bound and
    library call. Returns one dict of cases for each of kernels 4, 5, 6."""
    import torch
    import torch.nn.functional as F
    from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb

    dev = torch.device("cuda")
    L = GRPO_TRAIN["L"]
    out = ({}, {}, {})
    for B, backward in ((GRPO_TRAIN["train_batch"], True),
                        (GRPO_TRAIN["logprob_batch"], False)):
        lens_l = [GRPO_TRAIN["kv_lens"][b % 2] - 3 * (b // 2) for b in range(B)]
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        q, k, v, do = randn(B, L, 16, 128), randn(B, L, 2, 128), randn(B, L, 2, 128), \
            randn(B, L, 16, 128)
        tag = f"B={B} L={L} H=16 Hkv=2 D=128 causal kv_len={lens_l}"
        refs = [fb.flash_attention_fwd_lse_reference(
            q[b:b + 1].float(), k[b:b + 1].float(), v[b:b + 1].float(), lens[b:b + 1])
            for b in range(B)]
        ref_out, ref_lse = torch.cat([r[0] for r in refs]), torch.cat([r[1] for r in refs])
        del refs
        run_fwd = lambda: fb.flash_attention_fwd_lse(q, k, v, lens)   # noqa: E731
        got, lse = run_fwd()
        err, ratio = _check_rows(f"grpo train fwd {tag}", got, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"grpo train fwd {tag}: lse max_abs_err {lse_err} > {LSE_TOL}")
        del got, lse
        qt, dot = q.transpose(1, 2), do.transpose(1, 2)
        kt, vt = (x.repeat_interleave(8, dim=2).transpose(1, 2) for x in (k, v))
        pairs = 16 * _causal_pairs(L, lens_l)
        f32_rows = B * 16 * L * 4
        qkv_bytes = 2 * (q.numel() + k.numel() + v.numel())
        case = "train_micro_batch" if backward else "logprob_chunk"
        out[0][case] = {
            "shape": tag, "err": err, "ratio": ratio, "lse_err": lse_err,
            "ms": cuda_ms(run_fwd), "device_ms": graph_call_ms(run_fwd),
            "library_ms": cuda_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kt, vt, is_causal=True)),
            **dict(zip(("bound_ms", "bound_by"),
                       bound(qkv_bytes + 2 * q.numel() + f32_rows, 4 * 128 * pairs)))}
        if not backward:
            continue
        delta = (do.float() * ref_out).sum(-1).transpose(1, 2).contiguous()
        plan = fb.dkv_plan(lens, B, L, L, 16, 2, True, dev)
        run_dq = lambda: fb.flash_attention_bwd_dq(   # noqa: E731
            q, k, v, do, ref_lse, delta, lens)
        run_dkv = lambda: fb.flash_attention_bwd_dkv(   # noqa: E731
            q, k, v, do, ref_lse, delta, lens, plan=plan)
        got = (run_dq(), *run_dkv())
        want = [torch.cat(g) for g in zip(*(fb.flash_attention_bwd_reference(
            q[b:b + 1].float(), k[b:b + 1].float(), v[b:b + 1].float(), do[b:b + 1].float(),
            ref_lse[b:b + 1], delta[b:b + 1], lens[b:b + 1]) for b in range(B)))]
        scale = max(w.abs().max().item() for w in want[1:])
        dq_err = _check_grad(f"grpo train dq {tag}", got[0], want[0],
                             want[0].abs().max().item())
        dkv_err = [_check_grad(f"grpo train {name} {tag}", g, w, scale)
                   for name, g, w in zip(("dk", "dv"), got[1:], want[1:])]
        del got, want
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, dot, retain_graph=True))
        del lib_out, leaves
        bwd_in = qkv_bytes + 2 * do.numel() + 2 * f32_rows
        for i, (run, err_t, out_bytes, ops) in enumerate((
                (run_dq, [dq_err], 2 * q.numel(), 6 * 128 * pairs),
                (run_dkv, dkv_err, 2 * (k.numel() + v.numel()), 8 * 128 * pairs)), start=1):
            out[i][case] = {
                "shape": tag, "err": max(e[0] for e in err_t),
                "rel_err": max(e[1] for e in err_t), "ratio": max(e[2] for e in err_t),
                "ms": cuda_ms(run), "device_ms": graph_call_ms(run),
                "library_ms": lib_bwd, "library": "SDPA autograd backward, dq+dk+dv",
                **dict(zip(("bound_ms", "bound_by"), bound(bwd_in + out_bytes, ops)))}
        del plan
    torch.cuda.empty_cache()
    return out


# Kernel 6 on a plan built for kv lengths [8, 3], called with [8, 3] and
# then with [8, 5]: the second call must end in a CUDA error (the kernel's
# trap), which leaves the process's CUDA context unusable, so it runs in a
# child process of its own.
PLAN_MISMATCH_CHILD = """
import json, torch
from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
q, do = (torch.randn(2, 8, 4, 128, generator=g, device=dev).bfloat16() for _ in range(2))
k, v = (torch.randn(2, 8, 2, 128, generator=g, device=dev).bfloat16() for _ in range(2))
stats = torch.zeros(2, 4, 8, device=dev)
plan = fb.dkv_plan(torch.tensor([8, 3]), 2, 8, 8, 4, 2, True, dev)
for lens in ([8, 3], [8, 5]):
    try:
        fb.flash_attention_bwd_dkv(q, k, v, do, stats, stats,
                                   torch.tensor(lens, dtype=torch.int32, device=dev), plan=plan)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(json.dumps({"lens": lens, "error": str(e).splitlines()[0]}))
        raise SystemExit(0 if lens == [8, 5] else 4)
raise SystemExit(3)
"""


def _dkv_plan_mismatch() -> str:
    """Runs PLAN_MISMATCH_CHILD from the repository's root; returns the
    CUDA error of its mismatched call, raises unless the matching call ran
    and the mismatched one failed with a CUDA error."""
    child = subprocess.run([sys.executable, "-c", PLAN_MISMATCH_CHILD],
                           cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                           timeout=300)
    lines = child.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines else {}
    if child.returncode != 0 or "CUDA" not in result.get("error", ""):
        raise AssertionError(f"kernel 6 on a plan for other kv lengths: exit "
                             f"{child.returncode}, {result}, {child.stderr[-2000:]}")
    return result["error"]


def _short_3b_config(vocab: int = 8192):
    """Qwen2.5-VL-3B text widths (hidden 2048, 16/2 heads x 128) with 2 text
    layers, a small vocabulary and a token ViT."""
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import (
        Qwen25VLConfig, TextConfig, VisionConfig)
    return Qwen25VLConfig(
        vision=VisionConfig(depth=1, hidden_size=64, intermediate_size=128,
                            num_heads=4, out_hidden_size=2048, window_size=28,
                            fullatt_block_indexes=(0,)),
        text=TextConfig(vocab_size=vocab, hidden_size=2048,
                        intermediate_size=4096, num_hidden_layers=2,
                        num_attention_heads=16, num_key_value_heads=2,
                        head_dim=128, mrope_section=(16, 24, 24),
                        tie_word_embeddings=False),
        image_token_id=vocab - 3, video_token_id=vocab - 2,
        vision_start_token_id=vocab - 4, bos_token_id=0, eos_token_id=1,
        pad_token_id=0)


def phase_engine():
    """DecodeEngine greedy (kernels) vs a teacher-forced uncached forward
    (dense attention), 2 text layers at 3B head dims, bf16."""
    import torch
    from socioreasoner_tpu_torch.generation.engine import DecodeEngine, Request
    from socioreasoner_tpu_torch.generation.sampling import SamplingParams
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    from socioreasoner_tpu_torch.models.qwen2_5_vl.rope import get_rope_index

    config = _short_3b_config()
    vocab = config.text.vocab_size
    dev = torch.device("cuda")
    params = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(7),
                                dtype=torch.bfloat16, device=dev,
                                with_vision=False)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab - 8, size=n).tolist() for n in (37, 61, 120)]
    max_new = 12
    engine = DecodeEngine(config, params, max_slots=4, max_len=256,
                          decode_chunk=4, prefill_buckets=(64, 128), device=dev)
    sp = SamplingParams(temperature=0.0, do_sample=False, max_new_tokens=max_new)
    outs = engine.generate([Request(request_id=i, prompt_ids=p, sampling=sp)
                            for i, p in enumerate(prompts)])
    W = 256
    flips, failures = 0, []
    with torch.no_grad():
        for r, prompt in enumerate(prompts):
            got = list(outs[r].output_ids)
            toks = list(prompt)
            for step in range(min(max_new, len(got))):
                ids = np.zeros((1, W), np.int64)
                ids[0, :len(toks)] = toks
                attn = np.zeros((1, W), np.int64)
                attn[0, :len(toks)] = 1
                pos, _ = get_rope_index(config, ids, None, attn)
                logits, _ = qmodel.forward(
                    config, params, torch.as_tensor(ids, device=dev),
                    torch.as_tensor(pos, device=dev),
                    torch.as_tensor(attn, device=dev))
                row = logits[0, len(toks) - 1].float().cpu().numpy()
                top2 = np.argsort(row)[-2:][::-1]
                gap = float(row[top2[0]] - row[top2[1]])
                if got[step] != int(top2[0]):
                    if got[step] == int(top2[1]) and gap < GAP_TOL:
                        flips += 1
                    else:
                        failures.append((r, step, got[step], int(top2[0]), gap))
                toks.append(got[step])
    emit({"phase": "engine", "requests": len(prompts),
          "tokens": sum(len(o.output_ids) for o in outs), "tie_flips": flips,
          "failures": failures, "steps_executed": engine.steps_executed})
    if failures:
        raise AssertionError(f"engine greedy diverged beyond ties: {failures}")


def _synthetic_tiles(n_tiles: int, tile_px: int):
    """n synthetic map+sat tiles with a gt mask and ids (as bench.py makes them)."""
    from PIL import Image
    rng = np.random.default_rng(0)
    tiles = []
    for i in range(n_tiles):
        mask = np.zeros((tile_px, tile_px), np.uint8)
        mask[tile_px // 4:tile_px // 2, tile_px // 5:tile_px // 2] = 255
        tiles.append({
            "id": f"tile{i}",
            "map": Image.fromarray(rng.integers(0, 255, (tile_px, tile_px, 3),
                                                dtype=np.uint8)),
            "sat": Image.fromarray(rng.integers(0, 255, (tile_px, tile_px, 3),
                                                dtype=np.uint8)),
            "mask": Image.fromarray(mask),
            "question": "residential area",
        })
    return tiles


def _processor(config, img_cfg):
    from socioreasoner_tpu_torch.datasets.processor import SimpleTokenizer, SocioProcessor
    return SocioProcessor(SimpleTokenizer(config.text.vocab_size), img_cfg,
                          image_token_id=config.image_token_id)


def _stage1_batch(config, n_tiles: int, tile_px: int, img_cfg, prompt_length: int):
    """n synthetic map+sat tiles → stage-1 batch."""
    from socioreasoner_tpu_torch.datasets.socioseg import encode_sample
    from socioreasoner_tpu_torch.datasets.collator import SocioSegCollator

    features = [encode_sample(t, img_cfg) for t in _synthetic_tiles(n_tiles, tile_px)]
    collator = SocioSegCollator(_processor(config, img_cfg), config,
                                prompt_length=prompt_length, out_prefix="")
    return collator(features)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _serve(strategy, requests, dev, timeout=600):
    """Each request (keyword dicts of GenerateRequestType.ADD, without id and
    callback) through the strategy's server, then ALIVE_CHECK and STOP.
    Returns (outputs in request order, wall s from the first ADD, alive)."""
    import threading
    from socioreasoner_tpu_torch.generation.server import GenerateRequestType

    strategy.start_server()
    done, lock, finished = {}, threading.Lock(), threading.Event()

    def callback(out):
        with lock:
            done[out.request_id] = out
            if len(done) == len(requests):
                finished.set()

    t0 = time.perf_counter()
    for i, req in enumerate(requests):
        strategy.add_request(GenerateRequestType.ADD,
                             {**req, "request_id": i, "callback": callback})
    ok = finished.wait(timeout=timeout)
    _sync(dev)
    wall = time.perf_counter() - t0
    alive = strategy.add_request(GenerateRequestType.ALIVE_CHECK, None)["alive"]
    strategy.stop_server()
    if not ok or len(done) != len(requests):
        raise AssertionError(f"only {len(done)} of {len(requests)} requests finished")
    return [done[i] for i in range(len(requests))], wall, alive


def _check_outputs(config, outs):
    for o in outs:
        if o.finish_reason not in ("stop", "length") or not o.output_ids:
            raise AssertionError(f"request {o.request_id}: {o.finish_reason} {o.meta}")
        if not all(0 <= t < config.text.vocab_size for t in o.output_ids):
            raise AssertionError(f"request {o.request_id}: token out of range")


# quantized serving: the int8 single-copy weights that examples/infer/rlvr_tpu.yaml
# ships, with the int8 ViT, the int8 KV cache and w8a8 prefill on as well
QUANT_ENGINE_KWARGS = {"weight_quant": "int8", "single_copy_quant": True,
                       "kv_quant": "int8", "act_quant": "int8", "vit_quant": "int8"}


def run_main_path(config, params, dev, *, n_tiles=4, tile_px=768, img_cfg=None,
                  buckets=(2048, 2560), max_new=64, decode_chunk=16, engine_extra=None):
    """Stage-1 requests through the port's user-facing path:
    TorchDecodeStrategy.initialize (which quantizes the served tree under
    `engine_extra`'s strategy knobs) → collator → batch_image_embeds (ViT,
    on the strategy's tree) → the strategy's server (ADD ×n, then
    ALIVE_CHECK and STOP). Returns (outputs, engine, stats)."""
    import torch
    from socioreasoner_tpu_torch.datasets.processor import ImageProcessorConfig
    from socioreasoner_tpu_torch.distributed.torch_strategies import (
        TorchDecodeStrategy, batch_image_embeds)
    from socioreasoner_tpu_torch.generation.sampling import SamplingParams

    img_cfg = img_cfg or ImageProcessorConfig(defer_patchify=True)
    batch = _stage1_batch(config, n_tiles, tile_px, img_cfg, buckets[-1])
    attn = np.asarray(batch.batch["attention_mask"])
    ids = np.asarray(batch.batch["input_ids"])
    pos = np.asarray(batch.batch["position_ids"])
    with torch.no_grad():
        _sync(dev)
        t_init = time.perf_counter()
        strategy = TorchDecodeStrategy()
        strategy.initialize(config, params, engine_kwargs={
            "max_slots": n_tiles, "prefill_buckets": tuple(buckets),
            "max_len": buckets[-1] + max_new, "decode_chunk": decode_chunk,
            "device": dev, **(engine_extra or {})})
        _sync(dev)
        t_vit = time.perf_counter()
        embeds = batch_image_embeds(config, strategy.param_store.get("rollout"), batch,
                                    image_config=img_cfg)
        _sync(dev)
        vit_ms = (time.perf_counter() - t_vit) * 1e3 / n_tiles
        sp = SamplingParams(temperature=0.0, do_sample=False, max_new_tokens=max_new)
        outs, gen_s, alive = _serve(strategy, [
            {"prompt_ids": ids[i][attn[i] == 1].tolist(), "sampling": sp,
             "image_embeds": embeds[i], "position_ids": pos[i][:, attn[i] == 1]}
            for i in range(n_tiles)], dev)
    _check_outputs(config, outs)
    for e in embeds:
        if tuple(e.shape[1:]) != (config.text.hidden_size,) or \
                not bool(torch.isfinite(e.float()).all()):
            raise AssertionError("ViT embeddings of the wrong shape or not finite")
    engine = strategy.engine
    n_tokens = sum(len(o.output_ids) for o in outs)
    stats = {"prompt_lens": attn.sum(axis=1).tolist(),
             "image_rows": [int(e.shape[0]) for e in embeds],
             "strategy_init_s": t_vit - t_init,
             "vit_ms_per_tile": vit_ms,
             "prefill_ms": engine.prefill_device_time * 1e3,
             "prefill_calls": sum(engine.prefill_hist.values()),
             "decode_s": engine.decode_time, "generated_tokens": n_tokens,
             # the first token of each request comes from its prefill
             "decode_tok_s": (n_tokens - n_tiles) / max(engine.decode_time, 1e-9),
             "request_wall_s": gen_s, "steps_executed": engine.steps_executed,
             "host_syncs": engine.host_syncs, "alive": alive,
             "finish": [o.finish_reason for o in outs],
             # what the server holds: the served tree (ViT included) and the
             # KV cache with its scales
             "served_weights_gb": _tree_bytes(strategy.param_store.get("rollout")) / 2**30,
             "kv_cache_gb": sum(c.nbytes for c in engine.caches.values()) / 2**30}
    return outs, engine, stats


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    return tree.nbytes


def phase_main():
    """Qwen2.5-VL-3B at full width: ViT + server-mode decode of 4 stage-1
    requests, twice; returns the kernels' launch counts over the second
    (measured) pass, the config, the params and the pass's stats."""
    import torch
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    config = Qwen25VLConfig()
    t0 = time.perf_counter()
    params = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(0),
                                dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # first pass: cuBLAS handles, allocator pools and first-launch costs;
    # its wall times are printed but the measured pass is the second one
    _, _, warm = run_main_path(config, params, dev)
    emit({"phase": "main_warmup", "vit_ms_per_tile": warm["vit_ms_per_tile"],
          "prefill_ms": warm["prefill_ms"], "decode_s": warm["decode_s"]})
    kernels = (fa.flash_attention_segmented, fa.flash_attention,
               da.paged_decode_attention)
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    _, _, stats = run_main_path(config, params, dev)
    launches = {fn.__name__: fn.launches for fn in kernels}
    stats["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 2**30
    emit({"phase": "main", "model": "Qwen2.5-VL-3B (36 layers, ViT depth 32), "
          "random bf16 weights", "init_s": init_s, **stats, "launches": launches})
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return launches, config, params, stats


# ------------------------------------------------------------- training

def _train_kernel_fns():
    from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb
    return (fb.flash_attention_fwd_lse, fb.flash_attention_bwd_dq,
            fb.flash_attention_bwd_dkv)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


# train_parity bounds, kernels against dense attention in bf16. The two
# paths round attention differently (the kernel rounds unnormalised p to
# bf16, dense rounds the normalised probabilities; both round the output), a
# ~2^-9 relative difference per element that reaches the logits through two
# layers and the head.
PARITY_LOSS_TOL = 1e-3      # max-abs on the PPO loss (terms of size ~1)
PARITY_NORM_TOL = 2e-2      # relative, on the pre-clip grad norm
PARITY_LP_TOL = 0.1         # max-abs on a response token's log-prob (~ -9)
PARITY_LP_MEAN_TOL = 1e-2   # mean-abs over the response tokens


PARITY_LENS = (2304, 2080, 1000, 600)   # valid tokens a row; L is the first


def parity_batch(config, params, dev, lens=PARITY_LENS, seed=9):
    """A GRPO batch of random tokens as device tensors: rows of `lens` valid
    tokens right-padded to lens[0], the last 256 of each the response, old
    log-probs from a log-prob step on `params`, reference log-probs and
    advantages drawn around them."""
    import torch
    from socioreasoner_tpu_torch.distributed import trainer as T
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens)
    B, L = len(lens), int(lens[0])
    cols = np.arange(L)[None]
    attn = (cols < lens[:, None]).astype(np.int64)
    ids = np.where(attn == 1, rng.integers(2, config.text.vocab_size - 8, (B, L)), 0)
    resp = ((cols >= lens[:, None] - 256) & (attn == 1)).astype(np.int64)
    pos = np.broadcast_to(np.clip(np.cumsum(attn, -1) - 1, 0, None)[:, None], (B, 3, L))
    batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev) for k, v in {
        "input_ids": ids, "attention_mask": attn, "position_ids": pos,
        "response_mask": resp}.items()}
    mask = batch["response_mask"][:, 1:].float()
    old = T.make_logprob_step(config)(params, batch)["log_probs"]
    batch["old_log_probs"] = old
    batch["ref_log_probs"] = old + 0.1 * mask * torch.as_tensor(
        rng.normal(size=(B, L - 1)), dtype=torch.float32, device=dev)
    batch["advantages"] = mask * torch.as_tensor(rng.normal(size=(B, L - 1)),
                                                 dtype=torch.float32, device=dev)
    return batch


def phase_train_parity():
    """One make_train_step with the kernels and one with allow_flash=False
    (dense attention) from identical bf16 params and the same GRPO batch, at
    Qwen2.5-VL-3B widths with 2 layers: loss, grad norm and the log-probs
    after the step."""
    import torch
    from socioreasoner_tpu_torch.distributed import trainer as T
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    from socioreasoner_tpu_torch.pipeline.losses import PPOLossConfig

    config = _short_3b_config()
    dev = torch.device("cuda")
    params = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(9),
                                dtype=torch.bfloat16, device=dev, with_vision=False)
    lens = PARITY_LENS
    batch = parity_batch(config, params, dev, lens)
    B, L = len(lens), lens[0]
    mask = batch["response_mask"][:, 1:].float()
    res = {}
    for flash in (True, False):
        opt = T.make_optimizer()
        state = T.TrainState.create(_clone(params), opt)
        fns = _train_kernel_fns()
        before = [fn.launches for fn in fns]
        step = T.make_train_step(config, PPOLossConfig(), opt, allow_flash=flash)
        state, metrics = step(state, batch)
        lp = T.make_logprob_step(config, allow_flash=flash)(state.params, batch)["log_probs"]
        res[flash] = (metrics["actor_train/loss"].item(),
                      metrics["actor_train/grad_norm"].item(), lp,
                      [fn.launches - b for fn, b in zip(fns, before)])
        del state
    (loss_k, norm_k, lp_k, n_k), (loss_d, norm_d, lp_d, n_d) = res[True], res[False]
    diff = (lp_k - lp_d).abs() * mask
    out = {"phase": "train_parity", "shape": f"B={B} L={L} kv_len={list(lens)}, "
           "3B widths, 2 layers, vocab 8192, bf16",
           "loss_kernels": loss_k, "loss_dense": loss_d,
           "grad_norm_kernels": norm_k, "grad_norm_dense": norm_d,
           "logprob_max_abs_diff": diff.max().item(),
           "logprob_mean_abs_diff": (diff.sum() / mask.sum()).item(),
           "launches_kernels": n_k, "launches_dense": n_d,
           "bounds": {"loss_abs": PARITY_LOSS_TOL, "grad_norm_rel": PARITY_NORM_TOL,
                      "logprob_max_abs": PARITY_LP_TOL,
                      "logprob_mean_abs": PARITY_LP_MEAN_TOL},
           "bounds_why": "bf16: the kernel rounds unnormalised p, dense attention the "
                         "normalised probabilities; ~2^-9 relative per attention "
                         "output, through 2 layers and the head"}
    emit(out)
    ok = (abs(loss_k - loss_d) <= PARITY_LOSS_TOL
          and abs(norm_k - norm_d) <= PARITY_NORM_TOL * norm_d
          and out["logprob_max_abs_diff"] <= PARITY_LP_TOL
          and out["logprob_mean_abs_diff"] <= PARITY_LP_MEAN_TOL
          and min(n_k) > 0 and max(n_d) == 0
          and np.isfinite([loss_k, norm_k]).all())
    if not ok:
        raise AssertionError(f"train parity out of bounds: {out}")
    del params
    torch.cuda.empty_cache()


def run_train_path(config, params, dev, *, tile_px=768, img_cfg=None, n=4,
                   max_new=64, prompt_length=2048, sequence_length=2304, steps=3,
                   decode_chunk=16, seed=0):
    """The GRPO actor path through the port's strategies, as the SocioSeg
    pipeline's stage-1 half runs it: one tile x n sampled rollouts through
    TorchDecodeStrategy's server → postprocess_generate → reference log-probs
    (TorchInferStrategy, its own copy of the weights) and old log-probs
    (TorchTrainStrategy) → seeded response rewards, group_reward_norm,
    apply_kl_penalty, compute_advantage("grpo") → `steps` train steps
    (make_optimizer defaults, remat, chunked head) → model_update → one
    greedy request with the trained weights. The seeded rewards keep this
    phase's figures comparable with its earlier runs; the SocioSeg reward
    over both stages runs in the grpo phase (run_grpo_path). Returns stats;
    raises on a failed check."""
    import torch
    from socioreasoner_tpu_torch.datasets.processor import ImageProcessorConfig
    from socioreasoner_tpu_torch.protocol import BatchProto
    from socioreasoner_tpu_torch.distributed.strategy import ParamStore
    from socioreasoner_tpu_torch.distributed.torch_strategies import (
        TorchDecodeStrategy, TorchInferStrategy, TorchTrainStrategy, batch_image_embeds)
    from socioreasoner_tpu_torch.generation.sampling import SamplingParams
    from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb
    from socioreasoner_tpu_torch.pipeline.losses import PPOLossConfig
    from socioreasoner_tpu_torch.utils import functionals as F

    img_cfg = img_cfg or ImageProcessorConfig(defer_patchify=True)
    tile = _stage1_batch(config, 1, tile_px, img_cfg, prompt_length)
    ids = np.asarray(tile.batch["input_ids"])
    attn = np.asarray(tile.batch["attention_mask"])
    pos = np.asarray(tile.batch["position_ids"])
    store = ParamStore()
    with torch.no_grad():
        embeds = batch_image_embeds(config, params, tile, image_config=img_cfg)
        decode = TorchDecodeStrategy(param_store=store)
        decode.initialize(config, params, engine_kwargs={
            "max_slots": n, "prefill_buckets": (prompt_length,),
            "max_len": prompt_length + max_new, "decode_chunk": decode_chunk,
            "device": dev})
        valid = attn[0] == 1
        sampled = SamplingParams(temperature=1.0, do_sample=True, max_new_tokens=max_new)
        request = {"prompt_ids": ids[0][valid].tolist(), "image_embeds": embeds[0],
                   "position_ids": pos[0][:, valid]}
        outs, rollout_s, _ = _serve(decode, [dict(request, sampling=sampled)] * n, dev)
    _check_outputs(config, outs)

    # [left-padded prompt | right-padded response] rows → the train layout
    resp_len = max(len(o.output_ids) for o in outs)
    rows = np.full((n, ids.shape[1] + resp_len), config.pad_token_id, np.int64)
    rows[:, :ids.shape[1]] = ids[0]
    for i, o in enumerate(outs):
        rows[i, ids.shape[1]:ids.shape[1] + len(o.output_ids)] = o.output_ids
    post = F.postprocess_generate(
        input_ids=ids, attention_mask=attn, position_ids=pos, output=rows,
        num_return_sequences=n, sequence_length=sequence_length,
        eos_token_id=config.eos_token_id, pad_token_id=config.pad_token_id)
    batch = BatchProto.from_dict(
        tensors={k: post[k] for k in ("input_ids", "attention_mask", "position_ids",
                                      "response_mask")},
        meta={"image_embeds": torch.cat([embeds[0]] * n)})

    fns = _train_kernel_fns()
    for fn in fns:
        fn.launches = 0
    reference = TorchInferStrategy(param_store=store)
    reference.initialize(config, _clone({k: v for k, v in params.items() if k != "vision"}))
    train = TorchTrainStrategy(param_store=store)
    train.initialize(config, params, PPOLossConfig())
    _sync(dev)
    t0 = time.perf_counter()
    ref_lp = reference.compute_log_probs(batch)["log_probs"]
    _sync(dev)
    t1 = time.perf_counter()
    old_lp = train.compute_log_probs(batch)["log_probs"]
    _sync(dev)
    t2 = time.perf_counter()

    # rewards: seeded, as in this phase's earlier runs
    rewards = torch.as_tensor(np.random.default_rng(seed).random(n), dtype=torch.float32)
    t = {k: torch.as_tensor(v) for k, v in post.items()}
    resp = t["response_mask"][:, 1:]
    token_rewards, current_kl = F.apply_kl_penalty(
        F.group_reward_norm(rewards, n), t["attention_mask"], t["position_ids"], resp,
        torch.as_tensor(old_lp), torch.as_tensor(ref_lp), kl_coef=0.0)
    adv = F.compute_advantage(token_rewards, resp, adv_estimator="grpo")["advantages"]
    batch.batch.update(advantages=adv.numpy(), old_log_probs=old_lp, ref_log_probs=ref_lp)

    step_ms, metrics = [], []
    for _ in range(steps):
        _sync(dev)
        t_step = time.perf_counter()
        metrics.append(train.train_step(batch))
        _sync(dev)
        step_ms.append((time.perf_counter() - t_step) * 1e3)
    launches = {fn.__name__: fn.launches for fn in fns}
    new_lp = train.compute_log_probs(batch)["log_probs"]
    ref_after = reference.compute_log_probs(batch)["log_probs"]
    mask = post["response_mask"][:, 1:] == 1
    moved = float(np.abs(new_lp - old_lp)[mask].max())
    for i, m in enumerate(metrics):
        if not (np.isfinite(m["actor_train/loss"]) and np.isfinite(m["actor_train/grad_norm"])
                and m["actor_train/grad_norm"] > 0):
            raise AssertionError(f"train step {i}: loss or grad_norm not finite and > 0: {m}")
    if not moved > 0:
        raise AssertionError("the actor's log-probs did not move in the train steps")
    if not np.array_equal(ref_after, ref_lp):
        raise AssertionError("the reference policy's log-probs changed")

    # hand-off: the trained weights serve the next rollout
    train.model_update()
    decode.model_update()
    if decode.engine.params["embed"] is not train.params["embed"]:
        raise AssertionError("model_update did not hand the trained weights to the engine")
    with torch.no_grad():
        greedy = SamplingParams(temperature=0.0, do_sample=False, max_new_tokens=max_new)
        answer, _, alive = _serve(decode, [dict(request, sampling=greedy)], dev)
    _check_outputs(config, answer)

    valid_tokens = int(post["attention_mask"].sum())
    step_s = float(np.median(step_ms)) / 1e3
    # the dk/dv kernel's workspace for this batch's lengths (its plan, as
    # the text decoder builds it once a forward)
    t_cfg = config.text
    n_slots = fb.dkv_tile_plan(post["attention_mask"].sum(-1), sequence_length,
                               sequence_length, t_cfg.num_key_value_heads,
                               t_cfg.num_attention_heads // t_cfg.num_key_value_heads,
                               True)[3]
    return {"rollout_s": rollout_s, "response_lens": [len(o.output_ids) for o in outs],
            "train_batch": list(post["input_ids"].shape), "valid_tokens": valid_tokens,
            "ref_logprob_ms": (t1 - t0) * 1e3, "logprob_ms": (t2 - t1) * 1e3,
            "train_step_ms": step_ms, "train_tok_s": valid_tokens / step_s,
            "train_padded_tok_s": post["input_ids"].size / step_s,
            "current_kl": float(current_kl),
            "loss": [m["actor_train/loss"] for m in metrics],
            "grad_norm": [m["actor_train/grad_norm"] for m in metrics],
            "logprob_max_abs_move": moved, "launches": launches,
            "dkv_workspace_bytes": n_slots * fb.DKV_SLOT_FLOATS * 4,
            "handoff_tokens": len(answer[0].output_ids), "alive": alive}


def phase_train(config, params):
    """The GRPO actor path at full width and depth on the main phase's bf16
    params; returns the launch counts of kernels 4-6 over it."""
    import torch
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stats = run_train_path(config, params, dev)
    emit({"phase": "train", "model": "Qwen2.5-VL-3B (36 layers), random bf16 weights, "
          "AdamW (make_optimizer defaults), remat, chunked head", **stats,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30})
    missing = [k for k, c in stats["launches"].items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the train path: {missing}")
    return stats["launches"]


# ------------------------------------------------------------ quantization

# quant_parity's bound on a greedy flip, from int8 rounding. A rounding
# moves a value by at most half a code, amax/254 of its row; uniform in that
# interval, it gives a product a relative RMS error of (amax/rms)/(127 x
# sqrt(12)), about 1.1% for rows of a few thousand near-Gaussian values
# (amax/rms ~ 4.5). The engine's path has 18 roundings the reference lacks
# (the w8a8 activations of 7 products and the K and V codes, in each of 2
# layers); in quadrature ~4.8% of the logits' RMS, and a difference of two
# logits moves by sqrt(2) of that, ~6.7%. At three standard deviations a
# flip is a tie when the top-2 gap is below 0.2 x the RMS of the logits.
QUANT_GAP_REL = 0.2


def _cache_forward(config, params, ids_np, dev, act_quant=False, last_only=False):
    """(B, P) prompts through the cache-mode forward (the path that serves
    quantized trees) into a fresh cache of the params' dtype: f32 logits at
    every position, or at the last one."""
    import torch
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    from socioreasoner_tpu_torch.models.qwen2_5_vl.rope import get_rope_index
    t = config.text
    B, P = ids_np.shape
    pos, _ = get_rope_index(config, ids_np, None, np.ones((B, P), np.int64))
    shape = (t.num_hidden_layers, B, P, t.num_key_value_heads, t.head_dim)
    dt = params["embed"].dtype
    cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev),
             "kv_valid": torch.ones((B, P), dtype=torch.int32, device=dev)}
    with torch.no_grad():
        hidden, _ = qmodel.forward(
            config, params, torch.as_tensor(ids_np, device=dev),
            torch.as_tensor(pos, device=dev), None, cache=cache,
            cache_positions=torch.arange(P, device=dev)[None].expand(B, P),
            logits=False, act_quant=act_quant)
        if last_only:
            hidden = hidden[:, -1]
        return qmodel.head_logits(params, hidden).float()


def quant_figures(config, params, dev, *, n_prompts=4, prompt_len=256, seed=0):
    """scripts/quant_accuracy.py's figures of each quantized stack against the
    float tree: last-position logit cosine, max relative error (max |diff| /
    max |ref|) and top-1 agreement over seeded prompts. Random weights: the
    figures carry no bound."""
    from socioreasoner_tpu_torch.ops.quant import quantize_decode_params
    ids = np.random.default_rng(seed).integers(10, config.text.vocab_size - 10,
                                               size=(n_prompts, prompt_len))
    ref = _cache_forward(config, params, ids, dev, last_only=True)
    out = {}
    for name, mode, a8 in (("int8w", "int8", False), ("int8w+w8a8", "int8", True),
                           ("int4w", "int4", False)):
        got = _cache_forward(config, quantize_decode_params(params, mode=mode), ids, dev,
                             act_quant=a8, last_only=True)
        a, b = got.double().flatten(), ref.double().flatten()
        out[name] = {"logit_cos": float(a @ b / (a.norm() * b.norm())),
                     "logit_rel_err": float((got - ref).abs().max() / ref.abs().max()),
                     "top1_agree": float((got.argmax(-1) == ref.argmax(-1)).double().mean())}
    return out


def run_quant_parity(config, params, dev, *, max_new=16, prompt_lens=(37, 61, 120),
                     decode_chunk=4, figure_prompt=256):
    """The quantized engine (single-copy int8 weights, int8 KV cache, w8a8
    prefill) greedy against a teacher-forced cache-mode forward on the same
    int8 tree with a float cache and no w8a8 (a flip only where the top-2
    gap is below QUANT_GAP_REL x the logits' RMS); one greedy request of an
    int4 (hybrid) engine; the quantized stacks' logit figures. Returns
    stats; raises on a failed check."""
    import torch
    from socioreasoner_tpu_torch.generation.engine import DecodeEngine, Request
    from socioreasoner_tpu_torch.generation.sampling import SamplingParams
    from socioreasoner_tpu_torch.ops.quant import quantize_decode_params

    vocab = config.text.vocab_size
    text = {k: v for k, v in params.items() if k != "vision"}
    qtree = quantize_decode_params(text, mode="int8")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, vocab - 8, size=n).tolist() for n in prompt_lens]
    sp = SamplingParams(temperature=0.0, do_sample=False, max_new_tokens=max_new)
    kw = dict(max_slots=4, max_len=256, decode_chunk=decode_chunk,
              prefill_buckets=(64, 128), device=dev)
    engine = DecodeEngine(config, qtree, weight_quant="int8", kv_quant="int8",
                          act_quant="int8", **kw)
    if engine.params_q is not None or engine.caches["k"].dtype != torch.int8:
        raise AssertionError("the quantized engine is not single-copy with an int8 cache")
    outs = engine.generate([Request(request_id=i, prompt_ids=p, sampling=sp)
                            for i, p in enumerate(prompts)])
    _check_outputs(config, outs)
    flips, failures = [], []
    for r, prompt in enumerate(prompts):
        got = list(outs[r].output_ids)
        logits = _cache_forward(config, qtree, np.array([prompt + got[:-1]]), dev)[0]
        for step, tok in enumerate(got):
            row = logits[len(prompt) - 1 + step]
            top2 = torch.topk(row, 2)
            gap = float(top2.values[0] - top2.values[1])
            bound = QUANT_GAP_REL * float(row.square().mean().sqrt())
            if tok != int(top2.indices[0]):
                if tok == int(top2.indices[1]) and gap < bound:
                    flips.append((r, step, gap, bound))
                else:
                    failures.append((r, step, tok, int(top2.indices[0]), gap, bound))
    int4 = DecodeEngine(config, text, weight_quant="int4", **kw)
    if int4.params_q["layers"]["q_w"].dtype != torch.uint8:
        raise AssertionError("the int4 engine holds no nibble-packed weights")
    ans = int4.generate([Request(request_id=0, prompt_ids=prompts[0], sampling=sp)])[0]
    _check_outputs(config, [ans])
    return {"requests": len(prompts), "tokens": sum(len(o.output_ids) for o in outs),
            "steps_executed": engine.steps_executed, "tie_flips": flips,
            "failures": failures, "int4_tokens": len(ans.output_ids),
            "figures": quant_figures(config, text, dev, prompt_len=figure_prompt)}


def phase_quant_parity():
    import torch
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    config = _short_3b_config()
    dev = torch.device("cuda")
    params = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(5),
                                dtype=torch.bfloat16, device=dev, with_vision=False)
    stats = run_quant_parity(config, params, dev)
    emit({"phase": "quant_parity", "model": "Qwen2.5-VL-3B widths, 2 layers, vocab 8192, "
          "random bf16 weights", "gap_bound": f"{QUANT_GAP_REL} x RMS of the logits",
          **stats})
    if stats["failures"]:
        raise AssertionError(f"quantized greedy diverged beyond ties: {stats['failures']}")
    del params
    torch.cuda.empty_cache()


MAIN_KEYS = ("vit_ms_per_tile", "prefill_ms", "decode_s", "decode_tok_s", "request_wall_s",
             "steps_executed", "host_syncs", "max_memory_allocated_gb", "served_weights_gb",
             "kv_cache_gb")


def phase_main_quant(config, params, main_stats):
    """The main phase's requests with QUANT_ENGINE_KWARGS, twice (the second
    pass measured), beside the main phase's figures; then the quantized
    stacks' logit figures at full depth. The bf16 tree stays as it was:
    the strategy quantizes copies. Returns the int8 decode kernel's launch
    count over the measured pass."""
    import torch
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    from socioreasoner_tpu_torch.ops.quant import QUANT_KEYS, VISION_QUANT_KEYS

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    _, _, warm = run_main_path(config, params, dev, engine_extra=QUANT_ENGINE_KWARGS)
    emit({"phase": "main_quant_warmup", "vit_ms_per_tile": warm["vit_ms_per_tile"],
          "prefill_ms": warm["prefill_ms"], "decode_s": warm["decode_s"]})
    kernels = (fa.flash_attention_segmented, fa.flash_attention,
               da.paged_decode_attention, da.paged_decode_attention_int8)
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    _, engine, stats = run_main_path(config, params, dev, engine_extra=QUANT_ENGINE_KWARGS)
    launches = {fn.__name__: fn.launches for fn in kernels}
    stats["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 2**30
    floats = [params["layers"][k] for k in QUANT_KEYS if k in params["layers"]] + \
        [params["vision"]["blocks"][k] for k in VISION_QUANT_KEYS
         if k in params["vision"]["blocks"]]
    if any(t.dtype != torch.bfloat16 for t in floats):
        raise AssertionError("the quantized strategy changed the bf16 tree")
    if engine.params_q is not None or engine.params["layers"]["q_w"].dtype != torch.int8:
        raise AssertionError("the engine does not serve the single-copy int8 tree")
    del engine
    torch.cuda.empty_cache()
    figures = quant_figures(config, {k: v for k, v in params.items() if k != "vision"}, dev)
    emit({"phase": "main_quant", "model": "Qwen2.5-VL-3B (36 layers, ViT depth 32), "
          "random weights (the main phase's, after the train phase's steps), served as "
          "int8 single-copy weights, int8 ViT, int8 KV cache, w8a8 prefill", **stats,
          "main": {k: main_stats[k] for k in MAIN_KEYS}, "launches": launches,
          "figures_depth36": figures})
    missing = [n for n in ("flash_attention_segmented", "flash_attention",
                           "paged_decode_attention_int8") if launches[n] <= 0]
    if missing or launches["paged_decode_attention"]:
        raise AssertionError(f"main_quant launches: {launches}")
    return {"paged_decode_attention_int8": launches["paged_decode_attention_int8"]}


# ------------------------------------------------------- two-stage pipeline

# examples/infer/rlvr_tpu.yaml:14-28, set in code: the decode strategy's knobs
INFER_STRATEGY = {"kv_quant": None, "weight_quant": "int8", "single_copy_quant": True,
                  "act_quant": None, "prefix_fork": True}
# the two_stage phase's cuts of the yaml's scale (rollout_batch_size 250,
# response_length 2048, infer_batch_size 16)
TWO_STAGE_CUTS = {"rollout_batch_size": 4, "response_length": 64, "infer_batch_size": 4}
# crafted answers in the 756×756 space of the resized tile (as
# tests/test_infer_pipeline_e2e.py:106-118 crafts them)
S1_ANSWER = ('<think>two blocks</think><answer>[{"bbox_2d": [100, 120, 400, 380]}, '
             '{"bbox_2d": [420, 60, 700, 300]}]</answer>')
S2_ANSWER = ('<think>points</think><answer>[{"bbox_2d": [100, 120, 400, 380], '
             '"points": [[200, 200], [300, 330]]}, {"bbox_2d": [420, 60, 700, 300], '
             '"points": [[560, 180]]}]</answer>')
# sam2's bf16-against-f32 bounds on one tile: the share of mask pixels (the
# sign of every multimask logit) that must agree, and the IoU scores' max-abs.
# On random weights the IoU head's sigmoid outputs lie within ~5e-3 of 0.5
# (0.4951-0.5034 at hiera-large on the H100), so their bound must sit well
# below that spread to hold anything: bf16 reads 1.6e-6 from f32 there
# (5.96e-8 at the tiny config on the CPU).
SAM2_PIXEL_AGREE = 0.99
SAM2_IOU_TOL = 1e-5


def socioseg_infer_config(out_dir: str, *, rollout_batch_size: int, response_length: int,
                          infer_batch_size: int, prompt_length: int = 4096):
    """SocioSegConfig with examples/infer/rlvr_tpu.yaml's settings set in
    code (seed 42, track_with stdout, no checkpoints, prompt_length 4096,
    top_p 0.8, temperature 1.0, one sample a prompt, INFER_STRATEGY), at the
    given scale; output under out_dir."""
    from socioreasoner_tpu_torch.configs.rlvr_config import SocioSegConfig
    cfg = SocioSegConfig(exp_name="qwen2_5_vl_3B_socioseg_infer", seed=42,
                         output_dir=out_dir, track_with="stdout", save_steps=-1,
                         rollout_batch_size=rollout_batch_size,
                         prompt_length=prompt_length, response_length=response_length)
    ga = cfg.actor_infer.generating_args
    ga.max_new_tokens, ga.top_p, ga.temperature = cfg.response_length, 0.8, 1.0
    ga.num_return_sequences = 1
    cfg.actor_infer.strategy_args.strategy_name = "jax_decode"
    cfg.actor_infer.strategy_args.strategy_config = dict(INFER_STRATEGY)
    cfg.actor_infer.infer_batch_size = infer_batch_size
    cfg.seg_infer.strategy_args.strategy_name = "seg_infer"
    return cfg


def build_two_stage(config, params, sam_config, sam_params, out_dir, *, n_tiles=4,
                    tile_px=768, img_cfg=None, prompt_length=4096, **cuts):
    """SocioSegInferPipeline over n synthetic tiles, built as the entry
    script builds it (default_engine_kwargs of the config)."""
    from socioreasoner_tpu_torch.datasets.processor import ImageProcessorConfig
    from socioreasoner_tpu_torch.datasets.socioseg import encode_sample
    from socioreasoner_tpu_torch.pipeline.rlvr.build import default_engine_kwargs
    from socioreasoner_tpu_torch.pipeline.rlvr.socioseg_infer_pipeline import (
        SocioSegInferPipeline)

    img_cfg = img_cfg or ImageProcessorConfig(defer_patchify=True)
    cfg = socioseg_infer_config(out_dir, prompt_length=prompt_length,
                                **{**TWO_STAGE_CUTS, **cuts})
    dataset = [encode_sample(t, img_cfg) for t in _synthetic_tiles(n_tiles, tile_px)]
    return SocioSegInferPipeline(
        cfg, model_config=config, policy_params=params, sam_config=sam_config,
        sam_params=sam_params, processor=_processor(config, img_cfg), dataset=dataset,
        engine_kwargs=default_engine_kwargs(cfg))


def wall_ms(fn, dev, reps=3) -> float:
    """Median wall ms of fn() between device syncs over `reps` calls."""
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_two_stage(pipeline, dev, kernels=()):
    """A sequential _two_stage pass (warm-up, and its wall and engine figures
    beside run()'s), each stage's ViT timed on its batch (the tiles, then the
    sequential pass's stage-2 prompts and renders), then run() with the
    config's overlapped restage, measured, the `kernels`' launch counts set
    to 0 just before it and read just after; the outputs checked (4 PNGs and
    2 texts a tile, iou_acc.txt equal to the returned giou_acc). Returns
    stats."""
    from socioreasoner_tpu_torch.datasets.collator import collate_restage
    from socioreasoner_tpu_torch.datasets.socioseg import format_stage2_prompt
    from socioreasoner_tpu_torch.pipeline.rlvr.parsing import parse_bboxes

    cfg = pipeline.pipeline_config
    rows = pipeline.dataset
    n = len(rows)
    engine = pipeline.actor_infer.engine

    def engine_counts():
        return (engine.prefill_device_time, engine.decode_time, engine.steps_executed,
                engine.prefill_rows, engine.host_syncs, sum(engine.prefill_hist.values()))

    before = engine_counts()
    _sync(dev)
    t0 = time.perf_counter()
    seq = pipeline._two_stage_sequential(rows)
    seq_wall = time.perf_counter() - t0
    seq_d = [a - b for a, b in zip(engine_counts(), before)]

    s1 = pipeline.collator(rows)
    s2 = collate_restage(pipeline.processor, pipeline.model_config,
                         [format_stage2_prompt(r["question"], b)
                          for r, b in zip(rows, seq["bbox_texts"])],
                         seq["s2_images"], cfg.prompt_length)
    vit_s1 = wall_ms(lambda: pipeline._embeds(s1, "map_"), dev) / n
    vit_s2 = wall_ms(lambda: pipeline._embeds(s2, ""), dev) / n

    for fn in kernels:
        fn.launches = 0
    before = engine_counts()
    _sync(dev)
    t0 = time.perf_counter()
    giou_acc = pipeline.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    d = [a - b for a, b in zip(engine_counts(), before)]

    written, n_files = check_infer_outputs(pipeline)
    if written != giou_acc:
        raise AssertionError(f"iou_acc.txt {written} != giou_acc {giou_acc}")
    timer = pipeline.state.log_history[-1]["time/two_stage"]
    return {"tiles": n, "tiles_per_s": n / wall, "run_wall_s": wall,
            "per_tile_wall_s": wall / n, "two_stage_timer_s": timer,
            "vit_ms_per_tile_s1": vit_s1, "vit_ms_per_tile_s2": vit_s2,
            "prefill_ms": d[0] * 1e3, "decode_s": d[1], "steps_executed": d[2],
            "prefill_rows": d[3], "host_syncs": d[4], "prefill_calls": d[5],
            "prefill_buckets": sorted({key[1] for key in engine.prefill_hist}),
            "s1_prompt_lens": np.asarray(s1.batch["map_attention_mask"]).sum(1).tolist(),
            "s2_prompt_lens": np.asarray(s2.batch["attention_mask"]).sum(1).tolist(),
            "cache_lalloc": engine.Lalloc,
            # the sequential pass beside run()
            "sequential": {"wall_s": seq_wall, "prefill_ms": seq_d[0] * 1e3,
                           "decode_s": seq_d[1], "steps_executed": seq_d[2],
                           "prefill_calls": seq_d[5]},
            "giou_acc": giou_acc, "files_written": n_files,
            # answers with a box in the sequential pass: on random weights
            # none, so SegStrategy returns empty masks without encoding
            "s1_answers_with_boxes": sum(bool(parse_bboxes(t)) for t in seq["map_texts"]),
            "launches": launches}


def check_infer_outputs(pipeline):
    """The files of SocioSegInferPipeline.run(): 4 PNGs and 2 texts a tile
    (stage1/stage2 mask and answer, render1/render2) and iou_acc.txt, which
    must hold a giou in [0, 1]. Returns (that giou, the number of files)."""
    import os
    res = pipeline.result_dir
    files = {sub: sorted(os.listdir(os.path.join(res, sub)))
             for sub in ("stage1", "stage2", "render1", "render2")}
    ids = [str(r["id"]) for r in pipeline.dataset]
    want = {"stage1": sorted([f"{i}.png" for i in ids] + [f"{i}.txt" for i in ids]),
            "render1": sorted(f"{i}.png" for i in ids)}
    want["stage2"], want["render2"] = want["stage1"], want["render1"]
    if files != want:
        raise AssertionError(f"result files {files} != {want}")
    with open(os.path.join(res, "iou_acc.txt")) as f:
        written = float(f.read())
    if not 0.0 <= written <= 1.0:
        raise AssertionError(f"iou_acc.txt holds {written}")
    return written, sum(len(v) for v in files.values()) + 1


def _float_tree(tree):
    if isinstance(tree, dict):
        return {k: _float_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float_tree(v) for v in tree]
    return tree.float()


def run_sam2_checks(pipeline, dev, *, reps=3):
    """SAM2 through the pipeline's SegStrategy: _segment of every tile with
    S1_ANSWER, then S2_ANSWER; the encoder must run once a tile over both
    (stage 2 hits the cache), the masks be (768, 768) uint8, and an answer
    without answer tags give an all-zero mask. Then the encoder's ms a tile
    and the decoder's ms a prompt batch (medians of `reps`), and one tile in
    the tree's dtype against an f32 copy of it. Returns stats."""
    import torch
    from socioreasoner_tpu_torch.models.sam2.model import Sam2Predictor, predict_masks
    from socioreasoner_tpu_torch.distributed.seg_strategy import SEG_INPUT_SIZE, SEG_OUTPUT_SIZE
    from socioreasoner_tpu_torch.pipeline.rlvr.parsing import parse_visual_prompts_s2

    seg = pipeline.seg_infer
    pred = seg.predictor
    seg.clear_embed_cache()
    batch = pipeline.collator(pipeline.dataset)
    n = len(batch)
    encoded = []
    plain_set_images = pred.set_images

    def counting(images):
        encoded.append(len(images))
        return plain_set_images(images)

    pred.set_images = counting
    try:
        m1 = pipeline._segment(batch, [S1_ANSWER] * n, stage=1)
        m2 = pipeline._segment(batch, [S2_ANSWER] * n, stage=2)
        empty = pipeline._segment_idxs(batch, [0], ["no answer tags at all"], stage=2)
    finally:
        pred.set_images = plain_set_images
    for m in m1 + m2 + empty:
        if m.shape != SEG_OUTPUT_SIZE or m.dtype != np.uint8:
            raise AssertionError(f"a mask of {m.shape} {m.dtype}")
    if sum(encoded) != n:
        raise AssertionError(f"the encoder ran over {encoded} tiles for {n} tiles, two stages")
    if empty[0].any():
        raise AssertionError("an answer without answer tags gave a non-empty mask")

    images = [im.resize(SEG_INPUT_SIZE) for im in batch.non_tensor["seg_image"]]
    prompts = [parse_visual_prompts_s2(S2_ANSWER)] * n

    encoder_ms = wall_ms(lambda: pred.set_images(images), dev, reps) / n
    emb = pred._embeddings
    decoder_ms = wall_ms(lambda: pred.predict_objects_mask_batch(
        prompts, SEG_OUTPUT_SIZE, embeddings=emb), dev, reps)

    # one tile in the tree's dtype against an f32 copy of the same values
    ref = Sam2Predictor(pred.config, _float_tree(pred.params))
    outs = []
    for p in (pred, ref):
        p.set_images(images[:1])
        pts, lbl, boxes, valid = p.prompt_tensors(prompts[:1])
        with torch.no_grad():
            masks, iou = predict_masks(p.config, p.params, p._embeddings, p.image_pe,
                                       pts, lbl, boxes, multimask_output=True)
        outs.append((masks.float(), iou.float(),
                     p._union_masks(masks, iou, valid, SEG_OUTPUT_SIZE)[0]))
    (mb, ib, ub), (mf, i_f, uf) = outs
    agree = ((mb > 0) == (mf > 0)).float().mean().item()
    iou_err = (ib - i_f).abs().max().item()
    stats = {"tiles": n, "encoded_tiles": sum(encoded), "encoder_calls": len(encoded),
             "s1_mask_px": [int(m.sum()) for m in m1], "s2_mask_px": [int(m.sum()) for m in m2],
             "encoder_ms_per_tile": encoder_ms, "decoder_ms_per_batch": decoder_ms,
             "decoder_batch": f"{n} tiles x {len(prompts[0])} objects",
             "dtype": str(pred.dtype), "mask_pixels_agree_f32": agree,
             "union_pixels_agree_f32": float((ub == uf).mean()),
             "iou_max_abs_err_f32": iou_err, "iou_range_f32": [i_f.min().item(), i_f.max().item()],
             "mask_logit_max_abs": mf.abs().max().item()}
    del ref
    if not (agree >= SAM2_PIXEL_AGREE and iou_err <= SAM2_IOU_TOL):
        raise AssertionError(f"SAM2 {pred.dtype} against f32: {stats}")
    return stats


def profile_decode_chunk(engine, dev, prompt_len: int, seed: int = 0):
    """The engine's decode at its full slot count: one request a slot of
    prompt_len random text tokens (decode reads no image), admitted with the
    first chunk; then a chunk timed between syncs, and one under
    torch.profiler with device activity only: its kernels' time a step, the
    device's busy share of the chunk's wall (kernel time over wall; streams
    do not overlap in decode) and the kernels that take most of it. Returns
    stats."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from socioreasoner_tpu_torch.generation.engine import Request
    from socioreasoner_tpu_torch.generation.sampling import SamplingParams

    c = engine.config
    rng = np.random.default_rng(seed)
    # the first token comes from the prefill: three whole chunks follow it
    sp = SamplingParams(temperature=1.0, top_p=0.8, max_new_tokens=3 * engine.decode_chunk + 1)
    top = min(c.image_token_id, c.eos_token_id, 10000)
    engine.waiting.extend(Request(("decode_profile", i), rng.integers(10, top, prompt_len)
                                  .tolist(), sp) for i in range(engine.S))
    engine.step()

    def chunk():
        steps = engine.steps_executed
        ms = wall_ms(engine.step, dev, reps=1)
        return ms, engine.steps_executed - steps

    ms, steps = chunk()
    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        prof_ms, prof_steps = chunk()
    while engine.has_work():
        engine.step()
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.device_time_total)
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    return {"slots": engine.S, "prompt_len": prompt_len, "chunk_ms": ms, "steps": steps,
            "ms_per_step": ms / steps, "profiled_chunk_ms": prof_ms,
            "profiled_steps": prof_steps, "device_ms_per_step": device_ms / prof_steps,
            "busy_share": device_ms / prof_ms,
            "kernel_launches_per_step": sum(e.count for e in kernels) / prof_steps,
            "top_kernels": [{"name": e.key[:80], "ms_per_step": e.device_time_total / 1e3
                             / prof_steps, "launches_per_step": e.count / prof_steps}
                            for e in kernels[:8]]}


def phase_two_stage(config, params):
    """SocioSegInferPipeline.run() at full width: Qwen2.5-VL-3B (the main
    phase's bf16 tree, served by the strategy as its int8 single-copy tree)
    and SAM2-hiera-large with random bf16 weights, four 768² tiles, into a
    temporary directory; then the sam2 phase on the same pipeline. Returns
    the launch counts of kernels 1-3 over run()."""
    import tempfile
    import torch
    from socioreasoner_tpu_torch.models.sam2 import model as smodel
    from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    sam_config = Sam2Config.large()
    sam_params = smodel.init_params(sam_config, torch.Generator(device=dev).manual_seed(1),
                                    dtype=torch.bfloat16, device=dev)
    kernels = (fa.flash_attention_segmented, fa.flash_attention, da.paged_decode_attention)
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        pipeline = build_two_stage(config, params, sam_config, sam_params, out_dir)
        _sync(dev)
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        stats = run_two_stage(pipeline, dev, kernels)
        emit({"phase": "two_stage",
              "model": "Qwen2.5-VL-3B (36 layers, ViT depth 32) served as int8 single-copy "
                       "weights + SAM2-hiera-large, random bf16 weights",
              "cuts": {"rollout_batch_size": "250 -> 4", "response_length": "2048 -> 64",
                       "infer_batch_size": "16 -> 4"},
              "strategy_config": INFER_STRATEGY, "build_s": build_s, **stats,
              "sam2_params_gb": _tree_bytes(sam_params) / 2**30,
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30})
        missing = [k for k, c in stats["launches"].items() if c <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the two-stage pass: {missing}")
        # the kernels phase checked kernels 2 and 3 at these shapes
        if (stats["prefill_buckets"] != [2048, TWO_STAGE_PREFILL["L"]]
                or stats["cache_lalloc"] != TWO_STAGE_LALLOC
                or max(stats["s2_prompt_lens"]) > TWO_STAGE_PREFILL["L"]):
            raise AssertionError(f"the two-stage pass left the checked shapes: {stats}")
        decode = profile_decode_chunk(pipeline.actor_infer.engine, dev,
                                      max(stats["s2_prompt_lens"]))
        emit({"phase": "two_stage_decode_profile", **decode})
        torch.cuda.reset_peak_memory_stats()
        sam = run_sam2_checks(pipeline, dev)
        emit({"phase": "sam2", "model": "SAM2-hiera-large, random bf16 weights", **sam,
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30})
    return stats["launches"]


# ------------------------------------------------------------ GRPO pipeline

# examples/train/rlvr_tpu.yaml:73-79, set in code: the decode strategy's knobs
TRAIN_STRATEGY = {"kv_quant": None, "weight_quant": "int8", "single_copy_quant": True,
                  "act_quant": None, "prefix_fork": True}
# the grpo phase's cuts of the yaml's scale (rollout_batch_size 128,
# response_length 2048, steps from 10 epochs, eval and save every 20 steps)
GRPO_CUTS = {"rollout_batch_size": 2, "response_length": 64, "max_steps": 2, "eval_steps": 2}
# the yaml's reward worker_cls; the pipeline resolves it by class name
REWARD_WORKER_CLS = "socioreasoner_tpu.pipeline.base_worker.SocioSegRuleRewardWorker"


def socioseg_train_config(out_dir: str, *, rollout_batch_size: int, response_length: int,
                          max_steps: int, eval_steps: int, prompt_length: int = 4096):
    """SocioSegConfig with examples/train/rlvr_tpu.yaml's settings set in
    code (n = 8, top_p 0.99, top_k 100, temperature 0.99, TRAIN_STRATEGY,
    generate_opt_level 1, lr 1e-6, weight decay 1e-2, backward_batch_size 8,
    gradient_accumulation_steps 4, the k3 KL loss at 5e-3, reward and
    advantage clip 10, the rule reward's worker_cls) at the given scale,
    tracked to stdout, no checkpoints; output under out_dir."""
    from socioreasoner_tpu_torch.configs.rlvr_config import SocioSegConfig
    from socioreasoner_tpu_torch.configs.worker_config import WorkerConfig
    cfg = SocioSegConfig(
        exp_name="qwen2_5_vl_3B_socioseg_tpu", seed=42, output_dir=out_dir,
        track_with="stdout", save_steps=-1, eval_steps=eval_steps, max_steps=max_steps,
        rollout_batch_size=rollout_batch_size, num_return_sequences_in_group=8,
        is_num_return_sequences_expand=True, prompt_length=prompt_length,
        response_length=response_length, generate_opt_level=1, ppo_epochs=1,
        reward_clip=10, advantage_clip=10.0, whiten_advantages=False, init_kl_coef=0.0,
        adv_estimator="grpo", use_kl_loss=True, kl_loss_coef=5e-3,
        rewards={"socioseg_rule": WorkerConfig(worker_cls=REWARD_WORKER_CLS, world_size=16,
                                               infer_batch_size=4)})
    at = cfg.actor_train
    ta = at.training_args
    ta.learning_rate, ta.weight_decay, ta.warmup_steps = 1e-6, 1e-2, 0
    ta.per_device_train_batch_size, ta.gradient_accumulation_steps = 2, 4
    ta.num_train_epochs = 10
    at.strategy_args.strategy_name = "jax_train"
    at.infer_batch_size, at.backward_batch_size = 8, 8
    ai = cfg.actor_infer
    ga = ai.generating_args
    ga.max_new_tokens, ga.top_p, ga.top_k, ga.temperature = response_length, 0.99, 100, 0.99
    ga.num_return_sequences = cfg.num_return_sequences_in_group
    ai.strategy_args.strategy_name = "jax_decode"
    ai.strategy_args.strategy_config = dict(TRAIN_STRATEGY)
    ai.infer_batch_size = 24
    cfg.seg_infer.strategy_args.strategy_name = "seg_infer"
    cfg.seg_infer.strategy_args.strategy_config = {"seg_encode_batch": 8}
    cfg.seg_infer.infer_batch_size = 32
    cfg.reference.strategy_args.strategy_name = "jax_infer"
    cfg.reference.infer_batch_size = 8
    return cfg


def build_grpo(config, params, sam_config, sam_params, out_dir, *, n_tiles=2, tile_px=768,
               img_cfg=None, processor=None, prompt_length=4096, **cuts):
    """SocioSegPipeline over n synthetic tiles (also its validation split),
    built as the entry script builds it (default_engine_kwargs of the
    config), with `processor` or a SimpleTokenizer one of the config. The
    reference is `params` without the ViT (it reads the rollout's image
    embeddings), which the pipeline copies: the trainer updates `params` in
    place."""
    from socioreasoner_tpu_torch.datasets.processor import ImageProcessorConfig
    from socioreasoner_tpu_torch.datasets.socioseg import encode_sample
    from socioreasoner_tpu_torch.pipeline.rlvr.build import default_engine_kwargs
    from socioreasoner_tpu_torch.pipeline.rlvr.socioseg_pipeline import SocioSegPipeline

    img_cfg = img_cfg or ImageProcessorConfig(defer_patchify=True)
    cfg = socioseg_train_config(out_dir, prompt_length=prompt_length, **{**GRPO_CUTS, **cuts})
    dataset = [encode_sample(t, img_cfg) for t in _synthetic_tiles(n_tiles, tile_px)]
    return SocioSegPipeline(
        cfg, model_config=config, policy_params=params,
        reference_params={k: v for k, v in params.items() if k != "vision"},
        sam_config=sam_config, sam_params=sam_params,
        processor=processor or _processor(config, img_cfg), dataset=dataset,
        val_dataset=dataset, engine_kwargs=default_engine_kwargs(cfg))


def grpo_answers(n_samples: int, n: int):
    """Crafted (stage-1, stage-2) answers, one a sample, in the 756 x 756
    space of the resized tile, that differ within each group of n: a box at
    the synthetic tiles' gt region (153-383, 192-383 of a 768-px tile)
    shifted by the sample, a second box or another place, points inside
    their box or on its edge, with or without think tags, and one answer a
    group that does not parse."""
    s1, s2 = [], []
    for k in range(n_samples):
        j = k % n
        if j == n - 1:
            s1.append('<think>x</think><answer>[{"bbox_2d": [1, 2</answer>')
            s2.append("no answer tags")
            continue
        d = 6 * j
        boxes = [[40 + d, 500, 300, 740]] if j % 4 == 3 else [[153 + d, 192, 383, 383 - d]]
        if j % 2:
            boxes.append([420, 60 + d, 700, 300])
        pts = [[[(b[0] + b[2]) // 2 + 5 * t, (b[1] + b[3]) // 2] for t in range(j % 3 + 1)]
               for b in boxes]
        if j % 4 == 2:
            pts[0][0] = [boxes[0][0], pts[0][0][1]]        # on the box's left edge
        think = "" if j == 5 else f"<think>sample {j}</think>"
        s1.append(f"{think}<answer>{json.dumps([{'bbox_2d': b} for b in boxes])}</answer>")
        s2.append(f"{think}<answer>" + json.dumps(
            [{"bbox_2d": b, "points": p} for b, p in zip(boxes, pts)]) + "</answer>")
    return s1, s2


class ScriptedDecodeWorker:
    """A decode worker that answers each request at once with the tokens of
    a crafted answer: stage-1 sample k with s1[k], stage 2 with s2[k] (the
    overlapped rollout's ("s1" | "s2", k, worker) ids, or the scheduler's
    (prompt, sample, worker))."""

    def __init__(self, tokenizer, s1, s2, n: int):
        self.s1 = [list(tokenizer.encode(a)) for a in s1]
        self.s2 = [list(tokenizer.encode(a)) for a in s2]
        self.n = n

    def start_server(self, data=None):
        pass

    def stop_server(self):
        pass

    def add_request(self, command, data):
        from types import SimpleNamespace
        if command.name != "ADD":
            return {"alive": True} if command.name == "ALIVE_CHECK" else None
        rid = data["request_id"]
        if rid[0] == "s2":
            ids = self.s2[rid[1]]
        else:
            ids = self.s1[rid[1] if rid[0] == "s1" else rid[0] * self.n + rid[1]]
        data["callback"](SimpleNamespace(request_id=rid, output_ids=list(ids),
                                         finish_reason="stop"))


def run_grpo_path(config, params, sam_config, sam_params, out_dir, dev, *, kernels=(),
                  n_tiles=2, tile_px=768, img_cfg=None, processor=None, prompt_length=4096,
                  **cuts):
    """SocioSegPipeline.run() through the port's entry points, twice on one
    pipeline (build_grpo). Pass 1, the real engine: every step of the
    yaml's GRPO loop for GRPO_CUTS' max_steps, validation included, the
    `kernels`' launch counts set to 0 just before and read just after. Pass
    2, the reward flow: one more step with the decode group replaced by
    ScriptedDecodeWorker, so that SAM2 masks and non-zero rewards flow, the
    rewards held to compute_socioseg_rewards recomputed from the pass's own
    texts and masks. Across both: the reference's log-probs on the first
    map batch never move, the actor's move in pass 2. Returns stats; raises
    on a failed check."""
    from socioreasoner_tpu_torch.pipeline.rlvr.parsing import parse_bboxes
    from socioreasoner_tpu_torch.pipeline.rlvr.rewards.socioseg import (
        compute_socioseg_rewards)
    from socioreasoner_tpu_torch.runtime.generate_scheduler import LocalGenerateGroup

    pipe = build_grpo(config, params, sam_config, sam_params, out_dir, n_tiles=n_tiles,
                      tile_px=tile_px, img_cfg=img_cfg, processor=processor,
                      prompt_length=prompt_length, **cuts)
    cfg = pipe.pipeline_config
    n = cfg.num_return_sequences
    engine = pipe.actor_infer.engine
    shapes = {"train": set(), "logprob": set()}
    seen = {"train_s": [], "rollouts": [], "rewards": [], "ref": []}

    def record(kind, step_fn):
        def wrapped(*args):
            shapes[kind].add(tuple(args[-1]["input_ids"].shape))
            return step_fn(*args)
        return wrapped

    actor, reference = pipe.actor_train, pipe.reference
    actor._train_step = record("train", actor._train_step)
    actor._logprob_step = record("logprob", actor._logprob_step)
    reference._logprob_step = record("logprob", reference._logprob_step)
    plain = {name: getattr(pipe, name) for name in ("_train_stage", "_rollout",
                                                    "_compute_rewards")}
    ref_lp = reference.compute_log_probs

    def train_stage(*args):
        _sync(dev)
        t0 = time.perf_counter()
        out = plain["_train_stage"](*args)
        _sync(dev)
        seen["train_s"].append(time.perf_counter() - t0)
        return out

    def rollout(*args):
        seen["rollouts"].append(plain["_rollout"](*args))
        return seen["rollouts"][-1]

    def compute_rewards(*args):
        seen["rewards"].append((args, plain["_compute_rewards"](*args)))
        return seen["rewards"][-1][1]

    def reference_log_probs(batch):
        out = ref_lp(batch)
        if not seen["ref"]:
            seen["ref"] = [batch, out["log_probs"]]
        return out

    pipe._train_stage, pipe._rollout, pipe._compute_rewards = train_stage, rollout, \
        compute_rewards
    reference.compute_log_probs = reference_log_probs

    # ---- pass 1: the real engine
    for fn in kernels:
        fn.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    metrics = pipe.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    history = list(pipe.state.log_history)
    bad = sorted(k for h in history for k, v in h.items()
                 if isinstance(v, float) and not np.isfinite(v))
    stage_keys = [f"{s}/{k}" for s in ("map", "sat") for k in (
        "critic/kl", "critic/reward_mean", "actor_train/total_loss", "actor_train/pg_loss",
        "actor_train/kl_loss", "actor_train/grad_norm")]
    missing = [k for k in stage_keys + ["val_iou/mean"] if k not in metrics]
    if pipe.state.step != cfg.max_steps or bad or missing:
        raise AssertionError(f"grpo pass 1: step {pipe.state.step} of {cfg.max_steps}, "
                             f"not finite {bad}, missing {missing}")
    batch0, ref0 = seen["ref"]
    if not np.array_equal(ref_lp(batch0)["log_probs"], ref0):
        raise AssertionError("the reference policy's log-probs changed in pass 1")
    timers = ("step", "rollout", "logprobs", "rewards", "model_update", "validation")
    pass1 = {
        "wall_s": wall, "steps": pipe.state.step,
        "step_wall_s": [h["time/step"] for h in history],
        "timers_s": [{k: h[f"time/{k}"] for k in timers if f"time/{k}" in h} for h in history],
        "train_s_per_stage": list(seen["train_s"]),
        "actor_infer_tps": [h["system/actor_infer/tps"] for h in history],
        "actor_train_tps": [h["system/actor_train/tps"] for h in history],
        "engine_steps": engine.steps_executed, "prefill_rows": engine.prefill_rows,
        "forked_requests": engine.forked_requests,
        "prefill_buckets": sorted({(key[0], key[1]) for key in engine.prefill_hist}),
        "cache_slots": engine.S, "cache_lalloc": engine.Lalloc,
        "train_shapes": sorted(shapes["train"]), "logprob_shapes": sorted(shapes["logprob"]),
        # tokens a response, per step and stage: (fewest, most)
        "response_lens": [{stage: [int(x) for x in (lens.min(), lens.max())] for stage, lens in (
            (s, (r[f"seqs{s[-1]}"][:, cfg.prompt_length:] != config.pad_token_id).sum(1))
            for s in ("s1", "s2"))} for r in seen["rollouts"]],
        "metrics": {k: metrics[k] for k in stage_keys + sorted(
            k for k in metrics if k.startswith("val_iou/"))},
        "launches": launches}

    # ---- pass 2: crafted answers through SAM2, the reward and the train steps
    rows = pipe.dataset[:cfg.rollout_batch_size]
    worker = ScriptedDecodeWorker(pipe.processor.tokenizer,
                                  *grpo_answers(len(rows) * n, n), n)
    saved = (pipe.decode_replicas, pipe.decode_group)
    pipe.decode_replicas = [worker]
    pipe.decode_group = pipe.generate_scheduler.cluster = LocalGenerateGroup([worker])
    actor0 = actor.compute_log_probs(batch0)["log_probs"]
    cfg.max_steps = pipe.state.step + 1
    for fn in kernels:
        fn.launches = 0
    try:
        metrics2 = pipe.run()
    finally:
        pipe.decode_replicas, pipe.decode_group = saved
        pipe.generate_scheduler.cluster = saved[1]
    launches2 = {fn.__name__: fn.launches for fn in kernels}
    ro = seen["rollouts"][-1]
    (expanded, map_texts, sat_texts, map_masks, sat_masks, bbox_texts), got = seen["rewards"][-1]
    want = compute_socioseg_rewards(
        map_responses=map_texts, sat_responses=sat_texts, map_masks=map_masks,
        sat_masks=sat_masks,
        gt_masks=[np.asarray(m.convert("L")) for m in expanded.non_tensor["gt_mask"]],
        gt_bbox_texts=[str(t) for t in expanded.non_tensor["gt_bbox"]],
        stage1_bbox_texts=bbox_texts)
    keys = ("map_response_level_rewards", "sat_response_level_rewards", "seg_iou_rewards")
    recomputed = all(np.array_equal(got[k], want[k]) for k in keys) \
        and got["metrics"] == want["metrics"]
    with_boxes = [k for k, t in enumerate(map_texts) if parse_bboxes(t)]
    masks_ok = all(ro["map_masks"][k].any() and ro["sat_masks"][k].any() for k in with_boxes) \
        and not any(ro["sat_masks"][k].any() for k in range(len(map_texts))
                    if k not in with_boxes)
    groups = {k: got[k].reshape(-1, n) for k in keys[:2]}
    differ = all((g != 0).any() and all(len(set(r.tolist())) > 1 for r in g)
                 for g in groups.values())
    actor1 = actor.compute_log_probs(batch0)["log_probs"]
    mask = np.asarray(batch0.batch["response_mask"])[:, 1:] == 1
    moved = float(np.abs(actor1 - actor0)[mask].max())
    ref_same = np.array_equal(ref_lp(batch0)["log_probs"], ref0)
    grad_norms = [metrics2[f"{s}/actor_train/grad_norm"] for s in ("map", "sat")]
    pass2 = {
        "step_wall_s": pipe.state.log_history[-1]["time/step"],
        "rewards": {k: got[k].tolist() for k in keys},
        "reward_means": got["metrics"], "recomputed_equal": recomputed,
        "mask_px_s1": [int(m.sum()) for m in ro["map_masks"]],
        "mask_px_s2": [int(m.sum()) for m in ro["sat_masks"]],
        "grad_norm": grad_norms, "actor_logprob_max_abs_move": moved,
        "reference_logprobs_unchanged": ref_same,
        "metrics": {k: metrics2[k] for k in stage_keys}, "launches": launches2}
    if not (recomputed and masks_ok and differ and min(grad_norms) > 0 and moved > 0
            and ref_same and np.isfinite(list(pass2["metrics"].values())).all()):
        raise AssertionError(f"grpo pass 2 (crafted answers): {pass2}")
    return {"tiles": len(rows), "samples_per_step": len(rows) * n, "pass1": pass1,
            "pass2": pass2}


def phase_grpo(config, params):
    """SocioSegPipeline.run() at full width: the main phase's Qwen2.5-VL-3B
    tree as the policy (trained in place), a copy of it as the reference,
    the yaml's int8 single-copy rollout weights, SAM2-hiera-large with
    random bf16 weights, two 768² tiles x n = 8; kernels 1-6 must launch in
    pass 1 at the shapes the kernels phase checked, kernels 4-6 in pass 2.
    Returns the launch counts of pass 1."""
    import gc
    import tempfile
    import torch
    from socioreasoner_tpu_torch.models.sam2 import model as smodel
    from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    sam_config = Sam2Config.large()
    sam_params = smodel.init_params(sam_config, torch.Generator(device=dev).manual_seed(2),
                                    dtype=torch.bfloat16, device=dev)
    kernels = (fa.flash_attention_segmented, fa.flash_attention, da.paged_decode_attention,
               *_train_kernel_fns())
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        stats = run_grpo_path(config, params, sam_config, sam_params, out_dir, dev,
                              kernels=kernels)
        phase_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    p1, p2 = stats["pass1"], stats["pass2"]
    emit({"phase": "grpo", "card": _smi_line(),
          "model": "Qwen2.5-VL-3B (36 layers, ViT depth 32) trained in bf16, rolled out as "
                   "int8 single-copy weights + SAM2-hiera-large, random bf16 weights",
          "cuts": {"rollout_batch_size": "128 -> 2", "response_length": "2048 -> 64",
                   "max_steps": "10 epochs -> 2", "eval_steps": "20 -> 2",
                   "save_steps": "20 -> -1", "track_with": "tensorboard -> stdout"},
          "strategy_config": TRAIN_STRATEGY, "phase_s": phase_s,
          "max_memory_allocated_gb": peak, **stats})
    missing = [k for k, c in p1["launches"].items() if c <= 0] + \
        [k for k in ("flash_attention_fwd_lse", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv") if p2["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the grpo path: {missing}")
    L = GRPO_TRAIN["L"]
    left = ([b for b in p1["prefill_buckets"] if tuple(b) not in GRPO_PREFILL]
            + ([] if (p1["cache_slots"], p1["cache_lalloc"]) == (GRPO_SLOTS, GRPO_LALLOC)
               else ["cache"])
            + [s for s in p1["train_shapes"] if s != (GRPO_TRAIN["train_batch"], L)]
            + [s for s in p1["logprob_shapes"] if s != (GRPO_TRAIN["logprob_batch"], L)])
    if left:
        raise AssertionError(f"the grpo pass left the checked shapes: {left}")
    if not peak < 80:
        raise AssertionError(f"the grpo phase peaked at {peak} GiB")
    return p1["launches"]


# ------------------------------------------------------------- entry scripts

# examples/{infer,train}/rlvr_tpu.yaml as users start them, cut in scale as
# the two_stage and grpo phases cut them (rollout_batch_size 250 -> 4 and
# 128 -> 2, response_length 2048 -> 64, infer_batch_size 16 -> 4); the
# train run takes one step (10 epochs -> 1 step), saves the pipeline state
# after it (save_steps 20 -> 1) and logs to a jsonl file (tensorboard ->
# file: the card has no tensorboardX). The train entry builds no
# validation split, as in the JAX package.
ENTRY_INFER_CUTS = {"rollout_batch_size": 4, "response_length": 64,
                    "actor_infer": {"infer_batch_size": 4}}
ENTRY_TRAIN_CUTS = {"rollout_batch_size": 2, "response_length": 64, "max_steps": 1,
                    "save_steps": 1, "track_with": "file"}
ENTRY_TILES = {"test": 4, "train": 2}
ENTRY_TIMERS = ("step", "rollout", "logprobs", "rewards", "model_update")


def _bytes_to_unicode():
    """GPT-2's byte → printable character table of byte-level BPE."""
    bs = list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256))
    cs = bs[:]
    extra = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + extra)
            extra += 1
    return dict(zip(bs, map(chr, cs)))


def write_byte_tokenizer(path, special, vocab_size):
    """An HF tokenizer (tokenizer.json + tokenizer_config.json) built offline
    with `tokenizers`: byte-level BPE without merges, byte b at id b + 3 and
    the special tokens at the ids `special` names, so it encodes as
    SimpleTokenizer does; every other id below vocab_size is a filler token,
    so any id the model samples decodes."""
    import os
    from tokenizers import AddedToken, Tokenizer, decoders, models, pre_tokenizers
    chars = _bytes_to_unicode()
    vocab = {chars[b]: b + 3 for b in range(256)}
    vocab.update(special)
    used = set(vocab.values())
    vocab.update({f"<|r{i}|>": i for i in range(vocab_size) if i not in used})
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False) for t in special])
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<|im_end|>",
                   "pad_token": "<|endoftext|>", "clean_up_tokenization_spaces": False}, f)


def write_socioseg_dir(root, tile_px):
    """load_socioseg_dir's layout of _synthetic_tiles, ENTRY_TILES of each
    split: root/<split>/<id>/{map.png,sat.png,mask.png,question.json}."""
    import os
    tiles = _synthetic_tiles(max(ENTRY_TILES.values()), tile_px)
    for split, n in ENTRY_TILES.items():
        for t in tiles[:n]:
            d = os.path.join(root, split, t["id"])
            os.makedirs(d, exist_ok=True)
            for key in ("map", "sat", "mask"):
                t[key].save(os.path.join(d, f"{key}.png"))
            with open(os.path.join(d, "question.json"), "w") as f:
                json.dump({"question": t["question"]}, f)


def write_entry_yaml(example, path, *overlays):
    """examples/<example> through the port's load_yaml, with `overlays`
    merged over it, written to `path` as JSON (which is YAML)."""
    from socioreasoner_tpu_torch.configs.loader import _deep_merge, load_yaml
    data = load_yaml(str(Path(__file__).resolve().parent / "examples" / example))
    for overlay in overlays:
        data = _deep_merge(data, overlay)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def _checksum(t):
    """[sum of the bit patterns, sum weighted by position] of a tensor,
    computed where it lives."""
    import torch
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    flat = t.detach().reshape(-1).view(ints[t.element_size()])
    s = w = 0
    chunk = 1 << 26
    for i in range(0, flat.numel(), chunk):
        part = flat[i:i + chunk].to(torch.int64)
        pos = torch.arange(i, i + part.numel(), device=part.device) % 65521 + 1
        s += int(part.sum())
        w += int((part * pos).sum())
    return [s, w]


def tree_checksums(tree):
    """{leaf path: _checksum} of a nest of tensors."""
    from socioreasoner_tpu_torch.utils.checkpoint import flatten
    return {path: _checksum(t) for path, t in flatten(tree).items()}


def export_main_tree(config, params, export_dir, dev):
    """The main phase's tree through the port's save_pretrained into
    export_dir (BF16 shards + config.json) and the tokenizer beside it; read
    back once with load_pretrained and held to the tree leaf by leaf
    (torch.equal). Returns stats and the tree's checksums, against which
    the entry scripts' reads are held once the tree is gone."""
    import os
    import torch
    from socioreasoner_tpu_torch.datasets.processor import QWEN_SPECIAL_TOKENS
    from socioreasoner_tpu_torch.models.qwen2_5_vl import export, loader
    from socioreasoner_tpu_torch.utils.checkpoint import flatten

    _sync(dev)
    t0 = time.perf_counter()
    export.save_pretrained(config, params, export_dir)
    export_s = time.perf_counter() - t0
    gb = sum(os.path.getsize(os.path.join(export_dir, f)) for f in os.listdir(export_dir)
             if f.endswith(".safetensors")) / 1e9
    special = (QWEN_SPECIAL_TOKENS if config.text.vocab_size > max(QWEN_SPECIAL_TOKENS.values())
               else _TINY_SPECIAL)
    write_byte_tokenizer(export_dir, special, config.text.vocab_size)
    sums = tree_checksums(params)
    t0 = time.perf_counter()
    config2, back = loader.load_pretrained(export_dir, dtype=torch.bfloat16, device=dev)
    _sync(dev)
    load_s = time.perf_counter() - t0
    flat, flat_back = flatten(params), flatten(back)
    mismatch = [k for k, v in flat.items()
                if k not in flat_back or not torch.equal(v, flat_back[k])]
    mismatch += sorted(set(flat_back) - set(flat))
    if config2 != config or mismatch or tree_checksums(back) != sums:
        raise AssertionError(f"the exported tree did not read back bit for bit: {mismatch}")
    del back
    return {"export_s": export_s, "export_gb": gb, "export_gb_per_s": gb / export_s,
            "read_back_s": load_s, "read_back_gb_per_s": gb / load_s,
            "shards": sorted(f for f in os.listdir(export_dir) if f.endswith(".safetensors"))
            }, sums


# Qwen special tokens at Qwen25VLConfig.tiny()'s ids, for a tiny rehearsal
_TINY_SPECIAL = {"<|endoftext|>": 0, "<|im_end|>": 1, "<|im_start|>": 300,
                 "<|vision_start|>": 508, "<|image_pad|>": 509, "<|video_pad|>": 510,
                 "<|vision_end|>": 511}


@contextlib.contextmanager
def _patched(module, name, make):
    """module.name replaced by make(plain) inside the block."""
    plain = getattr(module, name)
    setattr(module, name, make(plain))
    try:
        yield
    finally:
        setattr(module, name, plain)


def run_entry_path(export_dir, data_dir, out_dir, dev, *, want_sums, kernels=(),
                   infer_overlay=None, train_overlay=None):
    """Both entry scripts' main() on examples/{infer,train}/rlvr_tpu.yaml,
    overlaid with the paths under out_dir (pretrain = export_dir, with its
    tokenizer; dataset_dir = data_dir; SAM2's path stays the yaml's, which is
    no directory, so a random SAM2-hiera-large), the ENTRY cuts and the
    given overlays: the infer entry over the test split, then the train
    entry for one step. Every policy tree the build functions read is held to
    want_sums; the `kernels`' launch counts are set to 0 just before each
    main() and read just after; the engines' prefill buckets and caches and
    the train and log-prob batch shapes are recorded. Checks the infer
    files, the finite train metrics, the tracker's jsonl and the pipeline
    checkpoint. Returns stats."""
    import gc
    import os
    import torch
    from socioreasoner_tpu_torch.distributed import torch_strategies as ts
    from socioreasoner_tpu_torch.examples import start_rlvr_socioseg_pipeline as train_entry
    from socioreasoner_tpu_torch.examples import (
        start_rlvr_socioseg_pipeline_infer as infer_entry)
    from socioreasoner_tpu_torch.pipeline.rlvr import build

    reads, builds = [], {}
    shapes = {"train": set(), "logprob": set()}

    def load_policy(plain):
        def run(*args, **kwargs):
            _sync(dev)
            t0 = time.perf_counter()
            model_config, params = plain(*args, **kwargs)
            _sync(dev)
            s = time.perf_counter() - t0
            gb = _tree_bytes(params) / 1e9
            reads.append({"s": s, "gb": gb, "gb_per_s": gb / s,
                          "bit_equal": tree_checksums(params) == want_sums})
            return model_config, params
        return run

    def timed(name):
        def make(plain):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                out = plain(*args, **kwargs)
                _sync(dev)
                builds[name] = time.perf_counter() - t0
                return out
            return run
        return make

    def recording(kind):
        def make(plain):
            def factory(*args, **kwargs):
                step = plain(*args, **kwargs)

                def run(*step_args):
                    shapes[kind].add(tuple(step_args[-1]["input_ids"].shape))
                    return step(*step_args)
                return run
            return factory
        return make

    paths = {"pretrain": export_dir, "actor_train": {"data_args": {"dataset_dir": data_dir}}}
    yaml_dir = os.path.join(out_dir, "yaml")
    os.makedirs(yaml_dir, exist_ok=True)
    infer_out, train_out = os.path.join(out_dir, "infer"), os.path.join(out_dir, "train")
    write_entry_yaml("infer/rlvr_tpu.yaml", os.path.join(yaml_dir, "infer.yaml"), paths, {
        "output_dir": infer_out,
        "checkpoint_config": {"output_dir": os.path.join(infer_out, "checkpoint")}},
        ENTRY_INFER_CUTS, infer_overlay or {})
    write_entry_yaml("train/rlvr_tpu.yaml", os.path.join(yaml_dir, "train.yaml"), paths, {
        "output_dir": train_out, "logging_dir": os.path.join(train_out, "logs"),
        "tracker_kwargs": {"log_dir": os.path.join(train_out, "tracker")},
        "checkpoint_config": {"output_dir": os.path.join(train_out, "checkpoint")}},
        ENTRY_TRAIN_CUTS, train_overlay or {})
    argv = ["--config_path", yaml_dir] + (["--device", "cpu"] if dev.type == "cpu" else [])
    out = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(build, "load_policy", load_policy))
        stack.enter_context(_patched(build, "build_infer_pipeline", timed("infer")))
        stack.enter_context(_patched(build, "build_train_pipeline", timed("train")))
        stack.enter_context(_patched(ts, "make_train_step", recording("train")))
        stack.enter_context(_patched(ts, "make_logprob_step", recording("logprob")))

        # ---- infer entry
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        pipe = infer_entry.main(argv + ["--config_name", "infer.yaml"])
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in kernels}
        giou, n_files = check_infer_outputs(pipe)
        engine = pipe.actor_infer.engine
        run_s = wall - builds["infer"]
        out["infer"] = {
            "main_s": wall, "build_s": builds["infer"], "run_s": run_s,
            "tiles": len(pipe.dataset), "tiles_per_s": len(pipe.dataset) / run_s,
            "tokenizer": type(pipe.processor.tokenizer).__name__,
            "prefill_buckets": sorted({key[1] for key in engine.prefill_hist}),
            "cache_lalloc": engine.Lalloc, "giou_acc": giou, "files_written": n_files,
            "launches": launches}
        del pipe, engine
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # ---- train entry
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        pipe = train_entry.main(argv + ["--config_name", "train.yaml"])
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in kernels}
    cfg = pipe.pipeline_config
    history = list(pipe.state.log_history)
    bad = sorted(k for h in history for k, v in h.items()
                 if isinstance(v, float) and not np.isfinite(v))
    with open(os.path.join(train_out, "tracker", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    ckpt = os.path.join(train_out, "pipeline", "checkpoint-1", "state.json")
    if (pipe.state.step != 1 or len(history) != 1 or bad or len(logged) != 1
            or logged[0]["step"] != 0 or not os.path.exists(ckpt)):
        raise AssertionError(f"the train entry: step {pipe.state.step}, {len(history)} "
                             f"records, not finite {bad}, {len(logged)} tracker lines, "
                             f"checkpoint {os.path.exists(ckpt)}")
    engine = pipe.actor_infer.engine
    h = history[-1]
    out["train"] = {
        "main_s": wall, "build_s": builds["train"], "run_s": wall - builds["train"],
        "samples": cfg.rollout_batch_size * cfg.num_return_sequences,
        "step_wall_s": h["time/step"],
        "timers_s": {k: h[f"time/{k}"] for k in ENTRY_TIMERS if f"time/{k}" in h},
        "metrics": {k: h[k] for k in sorted(h) if k.endswith(("/grad_norm", "/total_loss",
                                                              "/reward_mean"))},
        "prefill_buckets": sorted({(key[0], key[1]) for key in engine.prefill_hist}),
        "cache_slots": engine.S, "cache_lalloc": engine.Lalloc,
        "train_shapes": sorted(shapes["train"]), "logprob_shapes": sorted(shapes["logprob"]),
        "tracker_lines": len(logged), "launches": launches}
    out["reads"] = reads
    del pipe, engine
    gc.collect()
    if not reads or not all(r["bit_equal"] for r in reads) or len(reads) != 3:
        raise AssertionError(f"the build functions' reads of the exported tree: {reads}")
    return out


def checkpoint_round_trip(config, params, batch, dev, ckpt_dir, *, steps_before=3):
    """TorchTrainStrategy checkpoints: a strategy on a copy of `params`
    (gradient accumulation 2, so that the accumulator and its counters
    carry across) takes steps_before steps on `batch` and saves; a fresh
    strategy on another copy loads that checkpoint, and its params and
    optimizer state must equal the first's bit for bit; then each takes one
    more step. Returns the resumed and the uninterrupted step's loss and
    grad norm, and the save and load times."""
    from types import SimpleNamespace
    import torch
    from socioreasoner_tpu_torch.distributed.torch_strategies import TorchTrainStrategy
    from socioreasoner_tpu_torch.protocol import BatchProto
    from socioreasoner_tpu_torch.utils.checkpoint import flatten

    proto = BatchProto.from_dict(tensors={k: v.cpu().numpy() for k, v in batch.items()})
    args = SimpleNamespace(learning_rate=1e-5, weight_decay=0.01,
                           gradient_accumulation_steps=2)

    def strategy():
        s = TorchTrainStrategy()
        s.initialize(config, _clone(params), training_args=args, checkpoint_dir=ckpt_dir)
        return s

    first = strategy()
    for _ in range(steps_before):
        first.train_step(proto)
    _sync(dev)
    t0 = time.perf_counter()
    first.save_checkpoint(steps_before, meta={"step": steps_before}, wait=True)
    save_s = time.perf_counter() - t0
    second = strategy()
    t0 = time.perf_counter()
    meta = second.load_checkpoint()
    _sync(dev)
    load_s = time.perf_counter() - t0
    a, b = flatten(first._checkpoint_tree()), flatten(second._checkpoint_tree())
    differ = [k for k in a if not (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                                   else a[k] == b[k])]
    if meta != {"step": steps_before} or sorted(a) != sorted(b) or differ \
            or second.params["embed"].device != params["embed"].device:
        raise AssertionError(f"the checkpoint did not restore bit for bit: {differ[:5]}")
    m1, m2 = first.train_step(proto), second.train_step(proto)
    keys = ("actor_train/loss", "actor_train/grad_norm")
    return {"uninterrupted": {k: m1[k] for k in keys}, "resumed": {k: m2[k] for k in keys},
            "bit_equal": m1 == m2 and all(torch.equal(x, y) for x, y in zip(
                flatten(first.params).values(), flatten(second.params).values())),
            "state_gb": sum(v.nbytes for v in a.values() if isinstance(v, torch.Tensor)) / 1e9,
            "save_s": save_s, "load_s": load_s, "optimizer_count": b["opt_state/count"],
            "mini_step": b.get("opt_state/mini_step")}


def phase_entry(export_dir, export_stats, want_sums, work_dir):
    """The system started as users start it: the two entry scripts on the
    yamls of examples/, the policy read from the main phase's exported tree
    (export_main_tree), at full width; kernels 1-3 must launch in the infer
    run and 1-6 in the train run, at the shapes the kernels phase checked
    (the two_stage and grpo phases' buckets and caches, GRPO_TRAIN). Then
    the model-checkpoint round trip at 3B widths with 2 layers. Returns the
    launch counts over both runs."""
    import gc
    import os
    import torch
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    kernels = (fa.flash_attention_segmented, fa.flash_attention, da.paged_decode_attention,
               *_train_kernel_fns())
    data_dir = os.path.join(work_dir, "socioseg")
    write_socioseg_dir(data_dir, 768)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = run_entry_path(export_dir, data_dir, os.path.join(work_dir, "runs"), dev,
                           want_sums=want_sums, kernels=kernels)
    entry_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    inf, tr = stats["infer"], stats["train"]
    L = GRPO_TRAIN["L"]
    left = ([k.__name__ for k in kernels[:3] if inf["launches"][k.__name__] <= 0]
            + [k.__name__ for k in kernels if tr["launches"][k.__name__] <= 0]
            + ([] if inf["prefill_buckets"] == [2048, TWO_STAGE_PREFILL["L"]]
               and inf["cache_lalloc"] == TWO_STAGE_LALLOC else ["infer shapes"])
            + [b for b in tr["prefill_buckets"] if tuple(b) not in GRPO_PREFILL]
            + ([] if (tr["cache_slots"], tr["cache_lalloc"]) == (GRPO_SLOTS, GRPO_LALLOC)
               else ["train cache"])
            + [s for s in tr["train_shapes"] if s != (GRPO_TRAIN["train_batch"], L)]
            + [s for s in tr["logprob_shapes"] if s != (GRPO_TRAIN["logprob_batch"], L)])

    config = _short_3b_config()
    params = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(9),
                                dtype=torch.bfloat16, device=dev, with_vision=False)
    round_trip = checkpoint_round_trip(config, params, parity_batch(config, params, dev),
                                       dev, os.path.join(work_dir, "ckpt"))
    uninterrupted, resumed = round_trip["uninterrupted"], round_trip["resumed"]
    held = "bit_equal" if round_trip["bit_equal"] else "train_parity tolerances"
    emit({"phase": "entry", "card": _smi_line(),
          "model": "Qwen2.5-VL-3B (36 layers, ViT depth 32), the main phase's bf16 tree "
                   "exported and read back; SAM2-hiera-large random bf16",
          "yamls": ["examples/infer/rlvr_tpu.yaml", "examples/train/rlvr_tpu.yaml"],
          "cuts": {"infer": ENTRY_INFER_CUTS, "train": ENTRY_TRAIN_CUTS},
          "tokenizer": inf["tokenizer"], **export_stats, **stats, "entry_s": entry_s,
          "max_memory_allocated_gb": peak,
          "checkpoint_round_trip": {"model": "3B widths, 2 layers, vocab 8192, bf16",
                                    **round_trip, "held": held}})
    if left:
        raise AssertionError(f"the entry runs left the checked kernels or shapes: {left}")
    if not peak < 80:
        raise AssertionError(f"the entry phase peaked at {peak} GiB")
    if not round_trip["bit_equal"] and not (
            abs(resumed["actor_train/loss"] - uninterrupted["actor_train/loss"])
            <= PARITY_LOSS_TOL
            and abs(resumed["actor_train/grad_norm"] - uninterrupted["actor_train/grad_norm"])
            <= PARITY_NORM_TOL * uninterrupted["actor_train/grad_norm"]):
        raise AssertionError(f"the resumed step left the uninterrupted one: {round_trip}")
    return {k.__name__: inf["launches"].get(k.__name__, 0) + tr["launches"][k.__name__]
            for k in kernels}


def phase_row_writer():
    """Kernel 7's path: one decode step's new K/V rows written into every
    layer of the stacked cache at the diagnostic script's shape and
    positions (24 slots at row 520), held against the indexed assignment
    the engine uses. Returns write_rows' launch count over the step."""
    import torch
    from socioreasoner_tpu_torch.ops import cache_write as cw

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    L, S = ROW_WRITER_SHAPE[:2]
    k_all = torch.zeros(ROW_WRITER_SHAPE, dtype=torch.bfloat16, device=dev)
    v_all = torch.zeros_like(k_all)
    rows = torch.randn((L, 2, S, 1, 2, 128), generator=gen, device=dev).to(torch.bfloat16)
    positions = torch.full((S,), 520, dtype=torch.int32, device=dev)
    cw.write_rows.launches = 0
    for i in range(L):
        cw.write_rows(k_all, v_all, rows[i, 0], rows[i, 1], positions, i)
    launches = cw.write_rows.launches
    k_ref, v_ref = torch.zeros_like(k_all), torch.zeros_like(v_all)
    k_ref[:, :, 520] = rows[:, 0, :, 0]
    v_ref[:, :, 520] = rows[:, 1, :, 0]
    equal = torch.equal(k_all, k_ref) and torch.equal(v_all, v_ref)
    emit({"phase": "row_writer", "shape": list(ROW_WRITER_SHAPE), "launches": launches,
          "equal_to_indexed_assignment": equal})
    if not equal or launches != L:
        raise AssertionError("the row writer's decode step is wrong")
    return {"write_rows": launches}


def main() -> int:
    try:
        import torch
        from socioreasoner_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: {e} (run from the root of the repository)",
              file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    if _build.PKG_DIR.parent != here:
        # the kernels must build from the sources of this checkout
        print(f"chip_smoke: the port was imported from {_build.PKG_DIR}, not "
              f"from {here}", file=sys.stderr)
        return 1
    name = phase_device()
    phase_build()
    kernels = phase_kernels()
    phase_engine()
    phase_train_parity()
    phase_quant_parity()
    launches, config, params, main_stats = phase_main()
    launches.update(phase_train(config, params))
    launches.update(phase_main_quant(config, params, main_stats))
    two_stage = phase_two_stage(config, params)
    grpo = phase_grpo(config, params)
    with tempfile.TemporaryDirectory() as work_dir:
        export_dir = str(Path(work_dir) / "qwen2_5_vl_3b")
        export_stats, sums = export_main_tree(config, params, export_dir,
                                              torch.device("cuda"))
        del params
        entry = phase_entry(export_dir, export_stats, sums, work_dir)
    launches.update(phase_row_writer())
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
        if kern["name"] in two_stage:
            kern["launches_two_stage"] = two_stage[kern["name"]]
        if kern["name"] in grpo:
            kern["launches_grpo"] = grpo[kern["name"]]
        if kern["name"] in entry:
            kern["launches_entry"] = entry[kern["name"]]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
