#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (socioreasoner_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printing one JSON line; any failure exits non-zero:
  1. device   — nvidia-smi name and power limit; requires CUDA and sm_90.
  2. build    — nvcc builds the kernel library from socioreasoner_tpu_torch/csrc.
  3. kernels  — each CUDA kernel against its plain PyTorch version at the
                shapes of the main path: the error against the plain version
                run in f32 on the same bf16 values, and CUDA-event timings of
                the kernel and of the plain version on the bf16 tensors.
  4. engine   — DecodeEngine greedy stream (kernels) against a teacher-forced
                uncached forward (dense attention) at Qwen2.5-VL-3B head dims.
  5. main     — Qwen2.5-VL-3B at full width with random bf16 weights answers
                four SocioSeg stage-1 requests (768x768 map + satellite tiles)
                through TorchDecodeStrategy's server; every kernel must launch.

TF32 is off for matmuls and convolutions, so float32 references are full
float32. Imports nothing of JAX. The last line is the device summary
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

KERNEL_TOL = 2e-2       # max-abs, bf16 output rounding at |out| up to ~4
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


# ------------------------------------------------------------------ phases

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
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


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from socioreasoner_tpu.models.qwen2_5_vl.config import VisionConfig
    from socioreasoner_tpu_torch.models.qwen2_5_vl.rope import vision_window_index
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    results = []

    # segmented: two 756x756 images (the resize of a 768-px tile), 16 x 80
    vcfg = VisionConfig()
    grid = np.array([[1, 54, 54], [1, 54, 54]])
    _, window_seg, full_seg = vision_window_index(grid, vcfg)
    S = len(window_seg)
    q, k, v = randn(S, 16, 80), randn(S, 16, 80), randn(S, 16, 80)
    bq, bk = fa.seg_block_sizes(S)
    maxk = max(fa.seg_max_span_blocks(window_seg, bq, bk),
               fa.seg_max_span_blocks(full_seg, bq, bk))
    errs, times = [], {}
    for seg_np, span in ((window_seg, maxk), (full_seg, maxk), (window_seg, None)):
        seg = torch.as_tensor(seg_np, device=dev)
        run = lambda: fa.flash_attention_segmented(   # noqa: E731
            q, k, v, seg, block_q=bq, block_k=bk, max_span_blocks=span)
        ref = lambda: fa.flash_attention_segmented_reference(   # noqa: E731
            q.float(), k.float(), v.float(), seg)
        errs.append(_check(f"segmented span={span}", run(), ref()))
        if span is not None:
            plain = lambda: fa.flash_attention_segmented_reference(   # noqa: E731
                q, k, v, seg)
            times[seg_np is full_seg] = (cuda_ms(run), cuda_ms(plain, n=10))
    # per tile: the tower's 28 window layers and 4 full-attention layers
    n_full = len(vcfg.fullatt_block_indexes)
    n_win = vcfg.depth - n_full
    try:
        fa.flash_attention_segmented(q, k, v, torch.as_tensor(full_seg),
                                     block_q=bq, block_k=bk,
                                     max_span_blocks=maxk - 1)
    except ValueError:
        pass
    else:
        raise AssertionError("an underestimated max_span_blocks did not raise")
    results.append({
        "name": "flash_attention_segmented", "route": "cuda",
        "source": "socioreasoner_tpu_torch/csrc/flash_segmented.cu",
        "replaces": "socioreasoner_tpu/ops/flash_attention.py:95",
        "shape": f"S={S} H=16 D=80, ms per tile = {n_win} window + {n_full} full layers",
        "window_ms": times[False][0], "full_ms": times[True][0],
        "max_abs_err": max(errs),
        "ms": n_win * times[False][0] + n_full * times[True][0],
        "plain_ms": n_win * times[False][1] + n_full * times[True][1]})
    emit({"phase": "kernel", **results[-1]})

    # prefill: B=2, L=2048 bucket, 16 q / 2 kv heads, D=128, kv lens {2016, 1}
    B, L = 2, 2048
    q, k, v = randn(B, L, 16, 128), randn(B, L, 2, 128), randn(B, L, 2, 128)
    mask = torch.zeros(B, L, dtype=torch.int32, device=dev)
    mask[0, :2016] = 1
    mask[1, :1] = 1
    run = lambda: fa.flash_attention(q, k, v, mask, causal=True)   # noqa: E731
    ref = lambda: fa.flash_attention_reference(   # noqa: E731
        q.float(), k.float(), v.float(), mask, causal=True)
    err = _check("prefill", run(), ref())
    plain = lambda: fa.flash_attention_reference(q, k, v, mask, causal=True)   # noqa: E731
    results.append({
        "name": "flash_attention", "route": "cuda",
        "source": "socioreasoner_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "socioreasoner_tpu/ops/flash_attention.py:37",
        "shape": "B=2 L=2048 H=16 Hkv=2 D=128 kv_len=2016,1",
        "max_abs_err": err, "ms": cuda_ms(run), "plain_ms": cuda_ms(plain, n=10)})
    emit({"phase": "kernel", **results[-1]})

    # decode: the stacked 36-layer cache of the main phase (max_len 2624)
    Lalloc = -(-(2560 + 64 + 16) // 256) * 256
    errs, timing = [], None
    for slots, lens in ((4, [0, 1, 1500, Lalloc - 3]),
                        (8, [0, 1, 2, 63, 64, 65, 2016, Lalloc - 1])):
        kc, vc = randn(36, slots, Lalloc, 2, 128), randn(36, slots, Lalloc, 2, 128)
        q = randn(slots, 16, 128)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for layer in (0, 17, 35):
            run = lambda: da.paged_decode_attention(   # noqa: E731
                q, kc, vc, lengths, layer=layer)
            ref = lambda: da.paged_decode_attention_reference(   # noqa: E731
                q.float(), kc[layer].float(), vc[layer].float(), lengths)
            errs.append(_check(f"decode S={slots} layer={layer}", run(), ref()))
        if slots == 4:
            # per layer, over a sweep of all 36 layers: 415 MB of cache, so
            # each layer's blocks come from HBM as in the decode step, not L2
            sweep = lambda: [da.paged_decode_attention(   # noqa: E731
                q, kc, vc, lengths, layer=i) for i in range(36)]
            plain = lambda: [da.paged_decode_attention_reference(   # noqa: E731
                q, kc, vc, lengths, layer=i) for i in range(36)]
            timing = (cuda_ms(sweep) / 36, cuda_ms(plain, n=10) / 36)
        del kc, vc
    results.append({
        "name": "paged_decode_attention", "route": "cuda",
        "source": "socioreasoner_tpu_torch/csrc/paged_decode.cu",
        "replaces": "socioreasoner_tpu/ops/decode_attention.py:36",
        "shape": f"cache (36, 4|8, {Lalloc}, 2, 128), ms per layer at S=4",
        "max_abs_err": max(errs), "ms": timing[0], "plain_ms": timing[1]})
    emit({"phase": "kernel", **results[-1]})
    torch.cuda.empty_cache()
    return results


def phase_engine():
    """DecodeEngine greedy (kernels) vs a teacher-forced uncached forward
    (dense attention), 2 text layers at 3B head dims, bf16."""
    import torch
    from socioreasoner_tpu.models.qwen2_5_vl.config import (
        Qwen25VLConfig, TextConfig, VisionConfig)
    from socioreasoner_tpu_torch.generation.engine import DecodeEngine, Request
    from socioreasoner_tpu_torch.generation.sampling import SamplingParams
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    from socioreasoner_tpu_torch.models.qwen2_5_vl.rope import get_rope_index

    vocab = 8192
    config = Qwen25VLConfig(
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


def _stage1_batch(config, n_tiles: int, tile_px: int, img_cfg, prompt_length: int):
    """n synthetic map+sat tiles (as bench.py makes them) → stage-1 batch."""
    from PIL import Image
    from socioreasoner_tpu.datasets.processor import SimpleTokenizer, SocioProcessor
    from socioreasoner_tpu.datasets.socioseg import encode_sample
    from socioreasoner_tpu_torch.datasets.collator import SocioSegCollator

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
    features = [encode_sample(t, img_cfg) for t in tiles]
    processor = SocioProcessor(SimpleTokenizer(config.text.vocab_size), img_cfg,
                               image_token_id=config.image_token_id)
    collator = SocioSegCollator(processor, config, prompt_length=prompt_length,
                                out_prefix="")
    return collator(features)


def run_main_path(config, params, dev, *, n_tiles=4, tile_px=768, img_cfg=None,
                  buckets=(2048, 2560), max_new=64, decode_chunk=16):
    """Stage-1 requests through the port's user-facing path: collator →
    batch_image_embeds (ViT) → TorchDecodeStrategy server (ADD ×n, then
    ALIVE_CHECK and STOP). Returns (outputs, engine, stats)."""
    import threading
    import torch
    from socioreasoner_tpu.datasets.processor import ImageProcessorConfig
    from socioreasoner_tpu_torch.distributed.torch_strategies import (
        TorchDecodeStrategy, batch_image_embeds)
    from socioreasoner_tpu_torch.generation.sampling import SamplingParams
    from socioreasoner_tpu_torch.generation.server import GenerateRequestType

    img_cfg = img_cfg or ImageProcessorConfig(defer_patchify=True)
    batch = _stage1_batch(config, n_tiles, tile_px, img_cfg, buckets[-1])
    attn = np.asarray(batch.batch["attention_mask"])
    ids = np.asarray(batch.batch["input_ids"])
    pos = np.asarray(batch.batch["position_ids"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with torch.no_grad():
        sync()
        t_vit = time.perf_counter()
        embeds = batch_image_embeds(config, params, batch, image_config=img_cfg)
        sync()
        vit_ms = (time.perf_counter() - t_vit) * 1e3 / n_tiles

        strategy = TorchDecodeStrategy()
        strategy.initialize(config, params, engine_kwargs={
            "max_slots": n_tiles, "prefill_buckets": tuple(buckets),
            "max_len": buckets[-1] + max_new, "decode_chunk": decode_chunk,
            "device": dev})
        strategy.start_server()
        done, lock, finished = {}, threading.Lock(), threading.Event()

        def callback(out):
            with lock:
                done[out.request_id] = out
                if len(done) == n_tiles:
                    finished.set()

        sp = SamplingParams(temperature=0.0, do_sample=False, max_new_tokens=max_new)
        t_gen = time.perf_counter()
        for i in range(n_tiles):
            valid = attn[i] == 1
            strategy.add_request(GenerateRequestType.ADD, {
                "request_id": i, "prompt_ids": ids[i][valid].tolist(),
                "sampling": sp, "image_embeds": embeds[i],
                "position_ids": pos[i][:, valid], "callback": callback})
        ok = finished.wait(timeout=600)
        sync()
        gen_s = time.perf_counter() - t_gen
        alive = strategy.add_request(GenerateRequestType.ALIVE_CHECK, None)["alive"]
        strategy.stop_server()
    if not ok or len(done) != n_tiles:
        raise AssertionError(f"only {len(done)} of {n_tiles} requests finished")
    outs = [done[i] for i in range(n_tiles)]
    for o in outs:
        if o.finish_reason not in ("stop", "length") or not o.output_ids:
            raise AssertionError(f"request {o.request_id}: {o.finish_reason} {o.meta}")
        if not all(0 <= t < config.text.vocab_size for t in o.output_ids):
            raise AssertionError(f"request {o.request_id}: token out of range")
    for e in embeds:
        if tuple(e.shape[1:]) != (config.text.hidden_size,) or \
                not bool(torch.isfinite(e.float()).all()):
            raise AssertionError("ViT embeddings of the wrong shape or not finite")
    engine = strategy.engine
    n_tokens = sum(len(o.output_ids) for o in outs)
    stats = {"prompt_lens": attn.sum(axis=1).tolist(),
             "image_rows": [int(e.shape[0]) for e in embeds],
             "vit_ms_per_tile": vit_ms,
             "prefill_ms": engine.prefill_device_time * 1e3,
             "prefill_calls": sum(engine.prefill_hist.values()),
             "decode_s": engine.decode_time, "generated_tokens": n_tokens,
             # the first token of each request comes from its prefill
             "decode_tok_s": (n_tokens - n_tiles) / max(engine.decode_time, 1e-9),
             "request_wall_s": gen_s, "steps_executed": engine.steps_executed,
             "host_syncs": engine.host_syncs, "alive": alive,
             "finish": [o.finish_reason for o in outs]}
    return outs, engine, stats


def phase_main():
    """Qwen2.5-VL-3B at full width: ViT + server-mode decode of 4 stage-1
    requests, twice; returns the kernels' launch counts over the second
    (measured) pass."""
    import torch
    from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
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
    emit({"phase": "main", "model": "Qwen2.5-VL-3B (36 layers, ViT depth 32), "
          "random bf16 weights", "init_s": init_s, **stats,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
          "launches": launches})
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return launches


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
    launches = phase_main()
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
