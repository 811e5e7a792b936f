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
                rlvr phase's shapes: kernel 1 at one 756² image, kernel 2
                at its prefill buckets (L=256 and 1024), kernel 3 at its two
                caches, kernels 4-6 at its train batches (B=32 L=512, B=8
                L=1152) and kernel 4 at its log-prob chunks; kernel 2
                at the workers phase's judge buckets (L=512); the families
                phase's shapes: kernel 2 at B=4 L=512 with 32/4 and 16/16
                heads and B=4 L=2048 with 12/2, kernel 3 over its three caches
                (rep 8, 1, 6; 48, 8 and 28 layers), kernels 4-6 at B=2 L=2048
                with 32/4, kernel 1 per tile of the qwen2 ViT (its full-layer
                case in all 32 blocks); head dim 64: kernel 2 and kernels
                4-6 at Qwen2.5-0.5B's 14/2 and Llama-3.2-1B's 32/8 heads
                (edges, the agentic text pipeline's shapes, kernel 6's
                plan refusal at 64); the agentic phase's shapes: kernel 1
                on a 112² frame, kernel 2 at its prefill buckets, kernel 3
                at its cache, kernels 4-6 at its episode batch; the parallel
                phase's tp shard: kernel 2 at B=4 L=2048 with 8/1 heads,
                kernels 3 and 3q over its (36, 4, 2816, 1, 128) cache; the host
                copies of kernel 2's tile
                bounds and of the GQA work items against the C++ formulas;
                kernel 6's plan, its refusal of other kv lengths (a child
                process that must fail with a CUDA error) and, with kernel 5,
                determinism; kernel 7 bit for bit, and timed in turns beside
                the launch floor (the library's empty kernel, 36 launches in
                a CUDA graph, with and without programmatic dependent
                launch). The phase's wall time: kernels_seconds.
  4. engine   — DecodeEngine greedy stream (kernels) against a teacher-forced
                uncached forward (dense attention) at Qwen2.5-VL-3B head dims.
  5. train_parity — one GRPO train step with the trainable flash kernels
                against one with dense attention, from identical bf16 params
                at Qwen2.5-VL-3B widths with 2 layers; then the ViT trained
                through the model call (vision_inputs) at 3B ViT widths cut
                to 4 blocks, one 448² tile: every block's qkv_w gradient
                non-zero, each ViT leaf's gradient norm in bf16 within 2% of
                f32's, and the segmented kernel's wrapper refusing a q that
                requires grad.
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
  11b. parallel — serving over several devices, on the one card: (a) the
                main phase's four stage-1 requests (2016 tokens, 16 greedy
                tokens: PARALLEL_MAX_NEW) through the tensor-parallel DecodeEngine at full
                width, tp = 2 with both shards on cuda:0 (8 q heads over 1
                kv head a shard, its own contiguous cache), with bf16
                weights, then with int8 single-copy weights and an int8 KV
                cache, then with int4 single-copy weights (split by their
                scale groups); each against the unsharded engine on the same
                requests (tp_tie_check: both engines teacher-forced along
                the unsharded tokens, every logit within TP_DELTA_LIMIT of
                the unsharded one, every differing argmax a tie), both
                engines' prefill and decode profiled through
                utils/profiling.py; (b)
                SocioSegInferPipeline.run() over the two_stage phase's four
                tiles at greedy with actor_infer dp_size 1, then 2 (two
                decode replicas on cuda:0): every file of the dp = 2 run
                equal to the dp = 1 run's, tiles/s of both, each pass at
                the two_stage phase's checked shapes; (c) the infer yaml's
                16 slots of sequence length 6144 a replica, two replicas,
                allocated beside SAM2-hiera-large. Kernels 1, 2, 3 and 3q
                must launch (launches_parallel), peak < 80 GB; kernels 2, 3
                and 3q are checked at the shard's local shapes in the
                kernels phase. Two shards on one card measure the sharded
                code, not multi-GPU speed.
  12. grpo    — SocioSegPipeline.run(), GRPO over both stages with the
                SocioSeg rule reward, at full width with
                examples/train/rlvr_tpu.yaml's settings (n = 8, int8
                single-copy rollout weights, prefix fork, generate_opt_level
                1, backward_batch_size 8 over 4 accumulation steps, the k3
                KL loss, the reward worker_cls) on the main phase's tree, a
                copy of it as the reference, and SAM2-hiera-large; two 768²
                tiles, cut to response_length 64, one step and a validation.
                Pass 1 through the real engine: kernels 1-6 must launch, at
                the prefill buckets, cache and train shapes the kernels phase
                checked (GRPO_PREFILL, GRPO_SLOTS/GRPO_LALLOC, GRPO_TRAIN),
                the metrics finite, the reference's log-probs fixed. Pass 2,
                one step through crafted answers: SAM2 masks, rewards that
                differ in each group and equal compute_socioseg_rewards
                recomputed from the pass's texts and masks, grad_norm > 0,
                the actor's log-probs moved and the reference's not;
                kernels 4-6 must launch. Peak memory < 80 GB.
  13. rlvr    — the generic RLVR slice on the main phase's tree:
                RLVRPipeline.run() over a jsonl of math prompts read with
                datasets.loader.get_dataset, the dynamic sampler on (4
                prompts x 8 samples, 256 new tokens, 32 running requests,
                2 additional prompts, a query filter that rejects the first
                finished group), one step through the real engine (kernels
                2-6), then a step of crafted answers, half of each group
                right (rewards equal to compute_math_rewards recomputed on
                the texts, critic/score_mean 0.5, the actor moved, kernels
                4-6); then MathVLMPipeline.run() for a step of 2 prompts x 4
                samples, one 768² image each (kernels 1-6, kernel 1 32 times
                a tile). A frozen reference, each pass at the shapes the
                kernels phase checked (RLVR_*, MATH_VLM_*), peak < 80 GB.
  14. workers — the worker runtime, every reward, the reward model, the
                critic, SFT and DPO at full width on the main phase's tree,
                which must not move (checksums): (a) RLVRPipeline from a
                yaml read with configs/loader.py whose rewards: block names
                four reward clusters by the JAX package's dotted paths
                (math over 2 workers, code over 2 in local subprocesses,
                crossthinkqa, general), on a jsonl of 24 prompts, 6 a
                domain, cut to 4 prompts x 8 and 256 new tokens on the
                plain route: a step through the real engine (kernels 2-6),
                then a step of crafted answers, half of each group right
                (each domain's rewards equal its reward function called
                directly, critic/score_mean 0.5, the domain metrics,
                sandboxed subprocesses run, kernels 4-6), a copy of the
                tree as the policy and the tree as the frozen reference;
                (b) compute_llm_judge_rewards with greedy
                TorchDecodeStrategy.generate over the tree as the judge, 8
                prompts, 32 new tokens (kernels 2, 3), the scores equal
                parse_judge_score of its texts; (c) RewardWorker through a
                Cluster over TorchRewardStrategy on a copy with a seeded
                value head, pass 2's 32 rows of 512: the reward at the eos
                index exactly, bf16 values within RM_VALUE_TOL of f32; (d)
                two critic steps on that copy (loss finite and falling, the
                head and a backbone leaf moved); (e) pack_sequences of 16
                samples of 200-1800 tokens into rows of 2048, held to a
                recomputation, and two SFT steps in micro-batches of 2 rows
                (loss falling); (f) two DPO steps on 4 pairs of 512 (loss
                log 2 and margin 0 at step 1, margin > 0 at step 2). (c)-(f)
                attend densely, as the JAX package's steps do: kernels 4-6
                must not launch there. Each pass at the shapes the kernels
                phase checked; peak < 80 GB.
  15. agentic — the agentic slice at full width: (a) AgenticVLMPipeline
                on a copy of the main tree (the tree the frozen reference,
                checksummed): grid_goal in 2 groups x 2 envs, 3 turns of 32
                sampled tokens, 112² frames, 2 steps with a validation, each
                episode's response mask exactly the engine's sampled ids
                less the vision special ids (counted: vision_ids_dropped)
                and 16 image rows and tokens a frame, then one
                AgenticRolloutPipeline step;
                kernels 1-6 must launch. (b) Qwen2.5-0.5B-Instruct (head dim
                64) from its published config: greedy against a
                teacher-forced dense forward, one PPO step with kernels 4-6
                against dense attention, then AgenticPipeline on
                guess_number for two steps (train_family's log-probs at the
                initial params held to the LOGPROB_* bounds, as in the
                families and head_dims phases); kernels 2 and 4-6 must launch,
                kernel 3 never (head dim 64 decodes densely, as in JAX).
                Every pass at checked shapes; peak < 80 GiB.
  15b. train_mesh — the train plane over a device mesh on the one card,
                at Qwen2.5-VL-3B's text widths (vocab 151936, tied head) cut
                to 4 layers, random bf16 weights from a seed: (a) the same
                tree and GRPO batch (3 rows of L = 4160, ~2,150 valid tokens:
                a pad row runs) through TorchTrainStrategy and
                TorchInferStrategy unsharded, over fsdp 2 ([cuda:0] x 2) and
                over fsdp 2 x tp 2 ([cuda:0] x 4): two train steps, the
                log-probs and entropy, held to the unsharded run within the
                TRAIN_MESH_* limits (loss, grad norm, ratio_mean with the
                pad row counted 0, log-probs, every param after the steps;
                the log-probs before any step within MESH_LP0_*);
                the vocab-parallel head against the gathered head on the
                same shards; (b) kernels 4-6 counted by shard: every data
                rank's rows at the shard's local heads (8/1 at tp = 2), as
                many launches as layers x ranks x shards x passes; (c) one
                SocioSegPipeline step of crafted answers over
                build_train_mesh's fsdp 2 (the train yaml's fsdp_size -1
                over [cuda:0] x 2) against the same step unsharded, within
                (a)'s limits, at rank shapes the kernels phase checked, the
                decode engine's tree after model_update the int8 single
                copy of the gathered shards bit for bit; (d) two processes
                on cuda:0 through runtime/initialize.py (gloo: NCCL refuses
                two ranks on one card), a tensor and a host object
                broadcast, one train step with dp across the processes:
                both losses equal, within (a)'s limit of the one-process
                step over the same mesh shape. Kernels 1 and 4-6 launch
                (launches_train_mesh); the meshes' devices are one card
                listed several times, so the figures measure the sharded
                code, not multi-GPU speed.
  15c. seq_pipe — context and pipeline parallelism of the train plane on
                the train_mesh phase's model (3B text widths, 4 layers,
                vocab 151936): (a) 4 rows of L = 4160 (~2,150 valid)
                through TorchTrainStrategy unsharded, cp 2 ring over sp 2
                x tp 2 ([cuda:0] x 4), cp 2 Ulysses ([cuda:0] x 2), pp 2
                GPipe and pp 2 x vpp 2 interleaved ([cuda:0] x 2): the
                log-probs before any step (MESH_LP0_*), two train steps
                and the log-probs after them held to the unsharded run
                within the TRAIN_MESH_* limits, the ring's loss within
                SEQ_PIPE_RING_ULYSSES of Ulysses'; (b) kernels 4-6 counted
                by shape: layers x sp shards x passes at B=4 8/1 under
                Ulysses, layers x micro-batches at B=2 16/2 under pp, none
                in the ring (plain f32 attention, as JAX's is plain jnp),
                whose attention a layer is timed beside kernel 4 on the
                same rows; (c) one SocioSegPipeline step of crafted
                answers with the train yaml's context_parallel_size 2 over
                [cuda:0] x 2 against the same step unsharded; (d) the
                port's dry runs (tools/dryrun.py): dryrun_multichip over
                [cuda:0] x 8 and dryrun_multiprocess over two gloo
                processes on cuda:0. Kernels 1-6 launch
                (launches_seq_pipe); one card listed several times, so the
                figures measure the sharded code, not multi-GPU speed.
  16. entry   — the system started as users start it: the main phase's
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
  17. row_writer — kernel 7's own path: one decode step's K/V row writes
                into the stacked cache at the diagnostic script's shape (36
                layers, 24 slots, Lalloc 1536), held against the indexed
                assignment.
  18. families — the other model families at full width, from their
                published configs (random bf16 weights), each freed before
                the next: (a) Qwen3-30B-A3B (qwen3_moe, 128 experts top-8,
                48 layers, 61 GB) serves four random-token prompts of
                300-500 tokens (one prefill at B=4 in the bucket of 512,
                32 greedy tokens over 4 slots), each held against one
                teacher-forced uncached forward on dense attention (a
                mismatch is a tie where the runner-up is within GAP_TOL, or
                where a layer's k-th and (k+1)-th router probabilities lie
                within one bf16 ulp); (b) its width at 4 layers: two PPO
                steps on B=2 rows of 2048 (kv 2048, 1500) with kernels 4-6
                against dense attention (PARITY_LOSS_TOL, PARITY_NORM_TOL,
                the log-probs at the initial params within the LOGPROB_*
                bounds; the router, experts and q/k norms given finite non-zero
                gradients), then save_pretrained and llm.load_text_model bit
                for bit; (c) Qwen1.5-MoE-A2.7B (qwen2_moe with its shared
                expert, 16/16 heads) at 8 of 24 layers serves as (a), 16
                tokens; (d) Qwen2-VL-2B-Instruct from an HF checkpoint the
                phase writes (config.json, BF16 shards), loaded with
                load_pretrained, through run_main_path over four 768² tiles
                (the qwen2 ViT on kernel 1 in all 32 blocks, 12/2 heads),
                its ViT on the kernel against dense attention. Every
                launch at the shapes the kernels phase checked (kernel 2 at
                (4, 512) with 32/4 and 16/16 heads and (4, 2048) with 12/2,
                kernel 3 at rep 8, 1 and 6, kernels 4-6 at (2, 2048) with
                32/4); peak < 80 GiB.
  19. head_dims — kernels 2-6 at head dims other than 64 and 128,
                through public checkpoints at full width from their
                published configs, each written with save_pretrained and
                read back through llm.load_text_model: H2O-Danube3-4B
                (32/8 x 120) served at 24 layers (four prompts of 300-500
                tokens in the bucket of 512, 32 greedy tokens, held to the
                dense forward with a tie bound measured by teacher-forcing
                the engine: forced_against_forward) and trained at 4 (two PPO
                steps on B=2 rows of 2048 against dense attention),
                Danube3-500M (16/8 x 96) served and trained at 16,
                Danube2-1.8B (32/8 x 80) trained at 4, OpenLLaMA-3B v2
                (32/32 x 100, through the host pad to 104) served at 4,
                Falcon3-7B (12/4 x 256) served at 28 of 28 layers, again at
                4 with the int8 KV cache, and trained at 4. Kernel 2
                launches in every served pass and 4-6 in every trained one,
                at the shapes the kernels phase checked (HEAD_DIMS_PREFILL,
                HEAD_DIMS_TRAIN); kernel 3 (3q with the int8 cache) in
                Falcon3's served passes and never in the others (head dims
                that are no multiple of 128 decode densely, as in the JAX
                package). The kernels phase
                also holds kernels 1, 2 and 4-6 at other widths (132
                through the host pad, 136, 192, 200, 256) and GQA ratios
                (HEAD_DIM_EDGES, HEAD_DIM_TRAIN_EDGES, HEAD_DIM_SEG_WIDTHS),
                kernels 3 and 3q at 256 (HEAD_DIM_DECODE_CASES), a D=192
                call on the 256 instance against its D=256 twin, and the
                host's head_dim_plan against the kernels' formula.

TF32 is off for matmuls and convolutions, so float32 references are full
float32. Profiles are read through socioreasoner_tpu_torch/utils/profiling.py.
It refuses to run with SOCIO_DISABLE_FLASH=1 (the knob asks for dense
attention, which the engine, trainer and ViT refuse on the card). Imports nothing of JAX. The last line is the device summary
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import shutil
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
# The largest difference the tp = 2 engine's partial-product sums may make
# to a logit of the 3B on random weights (logits' RMS ~0.9, top ~4), along
# the same tokens. Sound runs read 0.15-0.18 at their first divergences, a
# few bf16 steps of 0.03125 at |logit| 4-8; a misplaced shard (a wrong block
# of o_proj, down_proj, the embedding or the head) moves the logits by
# their own size, several units at the top of a 151936-entry row.
TP_DELTA_LIMIT = 0.5


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


_TRACE_DIR = None


def _trace_dir() -> str:
    """A temporary directory for the profiler's Chrome traces, removed at
    exit."""
    global _TRACE_DIR
    if _TRACE_DIR is None:
        import atexit
        import shutil
        _TRACE_DIR = tempfile.mkdtemp(prefix="chip_smoke_traces_")
        atexit.register(shutil.rmtree, _TRACE_DIR, True)
    return _TRACE_DIR


def profiled(fn):
    """fn() under torch.profiler, read through the port's
    utils/profiling.trace_summary: (result, wall ms, every device row)."""
    from socioreasoner_tpu_torch.utils.profiling import trace_summary
    summary = trace_summary(fn, log_dir=_trace_dir(), top=1 << 30)
    return summary["result"], summary["wall_s"] * 1e3, summary["ops"]


def device_ms(fn, kernels, n: int = 5) -> float:
    """Device time of one fn() in the CUDA kernels whose names contain one
    of `kernels` ("" for all), from the profiler's trace of n calls after a
    warm-up call: the kernels' own time, without the host's launch time."""
    import torch
    fn()
    torch.cuda.synchronize()
    _, _, rows = profiled(lambda: [fn() for _ in range(n)])
    us = sum(r["total_us"] for r in rows
             if r["plane"].startswith("/device:") and any(k in r["name"] for k in kernels))
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
# The same at head_dim 64: Qwen2.5-0.5B's 14 / 2 heads (rep 7), Llama-3.2-1B's
# 32 / 8 (rep 4), a GQA-1 edge, a length-1 row, a row of no key, a split plan
TRAIN_EDGES_64 = ((1, 1, 14, 2, True, [1], None), (2, 200, 14, 2, True, [200, 77], 1),
                  (3, 129, 32, 8, True, [129, 1, 0], None), (2, 129, 4, 4, False, [129, 64], None),
                  (2, 300, 32, 8, True, [300, 150], None), (1, 1024, 14, 2, True, [1024], None))


def _train_edge_checks(randn, edges=TRAIN_EDGES, D=128):
    """Kernels 4-6 at `edges` (head dim D) against their plain versions in
    f32 on the same bf16 values, row by row (kernels 5 and 6 get the plain
    lse and delta; dq is held to the largest |reference| of dq, dk and dv
    together, since where every query sees one key ds cancels and dq is 0
    exactly).
    Returns (kernel 4's largest max-abs error, row ratio and lse error;
    kernel 5's and kernel 6's largest share of the gradients' largest value
    and row ratio; the split tiles of each case's plan)."""
    import torch
    from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb
    dev = torch.device("cuda")
    fwd, dq, dkv, splits = [0.0, 0.0, 0.0], [0.0, 0.0], [0.0, 0.0], []
    for B, Lq, H, Hkv, causal, lens, cap in edges:
        q, k, v, do = randn(B, Lq, H, D), randn(B, Lq, Hkv, D), randn(B, Lq, Hkv, D), \
            randn(B, Lq, H, D)
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        tag = f"B={B} Lq={Lq} H={H}/{Hkv} D={D} causal={causal} kv_len={lens}"
        out, lse = fb.flash_attention_fwd_lse(q, k, v, lt, causal=causal)
        ref_out, ref_lse = fb.flash_attention_fwd_lse_reference(q.float(), k.float(), v.float(),
                                                                lt, causal)
        err, ratio = _check_rows(f"train fwd edge {tag}", out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"train fwd edge {tag}: lse max_abs_err {lse_err} > {LSE_TOL}")
        fwd = [max(fwd[0], err), max(fwd[1], ratio), max(fwd[2], lse_err)]
        delta = (do.float() * ref_out).sum(-1).transpose(1, 2).contiguous()
        plan = fb.dkv_plan(lt, B, Lq, Lq, H, Hkv, causal, dev, cap=cap, head_dim=D)
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
    f32 (kernel 2 also at head dim 64). Returns, for kernels 1 and 2, the
    largest (max-abs error, row ratio) over their cases, and
    _train_edge_checks' figures at head dims 128 and 64."""
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
    # 128-row items idle, 5 and 7; head dim 64 at Qwen2.5-0.5B's 14 / 2
    # heads, Llama-3.2-1B's 32 / 8 and GQA 1
    for B, Lq, D, causal, H, Hkv in ((1, 1, 128, True, 16, 2), (4, 63, 128, True, 16, 2),
                                     (4, 129, 80, True, 16, 2), (1, 2048, 128, True, 16, 2),
                                     (4, 129, 128, False, 16, 2), (1, 63, 80, False, 16, 2),
                                     (2, 200, 128, True, 40, 8), (3, 129, 128, False, 28, 4),
                                     (2, 150, 80, True, 14, 2), (1, 1, 64, True, 14, 2),
                                     (4, 300, 64, True, 14, 2), (3, 129, 64, True, 32, 8),
                                     (4, 200, 64, False, 4, 4), (2, 63, 64, True, 32, 8)):
        q, k, v = randn(B, Lq, H, D), randn(B, Lq, Hkv, D), randn(B, Lq, Hkv, D)
        lens = [Lq, 0, 1, max(Lq // 2, 1)][:B]
        mask = (torch.arange(Lq, device=dev)[None]
                < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
        got = fa.flash_attention(q, k, v, mask, causal=causal)
        want = fa.flash_attention_reference(q.float(), k.float(), v.float(), mask,
                                            causal=causal)
        pre_err = worst(pre_err, _check_rows(
            f"prefill edge B={B} Lq={Lq} H={H}/{Hkv} D={D} causal={causal}", got, want))
    return (seg_err, pre_err, _train_edge_checks(randn),
            _train_edge_checks(randn, TRAIN_EDGES_64, 64))


def _one_image_seg_checks(randn, grid=None, D=80):
    """Kernel 1 at one image's tower call (`grid`: the rlvr phase's MathVLM
    756² image, S = 2916, or the agentic phase's 112² frame, S = 64) with
    16 heads of D columns, window and full-layer ids on the plans the tower
    builds, row by row against the plain version in f32; timed with its
    bound."""
    import torch
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import VisionConfig
    from socioreasoner_tpu_torch.models.qwen2_5_vl.rope import vision_window_index
    from socioreasoner_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    grid = MATH_VLM_GRID if grid is None else grid
    _, window_seg, full_seg = vision_window_index(np.array(grid), VisionConfig())
    S, H = len(window_seg), 16
    q, k, v = randn(S, H, D), randn(S, H, D), randn(S, H, D)
    bq, bk = fa.seg_block_sizes(S)
    span = max(fa.seg_max_span_blocks(window_seg, bq, bk),
               fa.seg_max_span_blocks(full_seg, bq, bk))
    out = {"S": S}
    for name, seg_np in (("window", window_seg), ("full", full_seg)):
        seg = torch.as_tensor(seg_np)
        plan = fa.seg_plan(seg, H, dev, block_q=bq, block_k=bk, max_span_blocks=span)
        run = lambda: fa.flash_attention_segmented(   # noqa: E731
            q, k, v, seg, block_q=bq, block_k=bk, max_span_blocks=span, plan=plan)
        err, ratio = _check_rows(f"segmented one image {name}", run(),
                                 fa.flash_attention_segmented_reference(
                                     q.float(), k.float(), v.float(), seg))
        b_ms, b_by = bound(4 * S * H * D * 2, 4 * D * H * _seg_pairs(seg_np))
        if name == "window" and D % 8:       # varlen_attn refuses such a head size
            lib, lib_name = None, "none: varlen_attn takes head sizes that are multiples of 8"
        elif name == "window":
            lib, lib_name = _window_library(q, k, v, seg_np)
        else:      # one image: full attention over its S patches
            qb, kb, vb = (x.transpose(0, 1)[None] for x in (q, k, v))
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(   # noqa: E731
                qb, kb, vb)
            lib_name = f"scaled_dot_product_attention (1, 16, {S}, {D})"
        out[name] = {"err": err, "ratio": ratio, "ms": cuda_ms(run),
                     "device_ms": graph_call_ms(run), "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None if lib is None else cuda_ms(lib), "library": lib_name}
    return out


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
    tensor of the windows; above 256 columns (which no flash backend takes)
    SDPA under the ids' block-diagonal mask. Returns (fn, name)."""
    import torch
    import torch.nn.functional as F
    if q.shape[-1] > 256:
        ids = torch.as_tensor(seg_np, device=q.device)
        mask = ids[:, None] == ids[None, :]
        qb, kb, vb = (x.transpose(0, 1)[None] for x in (q, k, v))
        return (lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask),
                "scaled_dot_product_attention under the block-diagonal mask of the ids")
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

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    results = []
    seg_edge, pre_edge, train_edge, train_edge_64 = _edge_checks(randn)

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
    one_image = _one_image_seg_checks(randn)
    agentic_frame = _one_image_seg_checks(randn, AGENTIC_GRID)
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
        # the families phase's Qwen2-VL tower: the same tile's per-image ids
        # (and plan) in all of its blocks
        families_qwen2_vit={key: vcfg.depth * full[key] for key in (
            "ms", "device_ms", "plain_ms", "library_ms")} | {
            "shape": f"S={S} H=16 D=80, ms per tile = {vcfg.depth} full layers",
            "bound_ms": vcfg.depth * full["bound"][0], "bound_by": full["bound"][1]},
        max_row_ratio=max(r for _, r in errs), edge_max_abs_err=seg_edge[0],
        edge_max_row_ratio=seg_edge[1], math_vlm_one_image=one_image,
        agentic_frame=agentic_frame))
    emit({"phase": "kernel", **results[-1]})

    # prefill: 16 q / 2 kv heads, D=128; checked and timed at the L=2048
    # bucket at B=2 with kv lens {2016, 1} and at the main phase's prefill
    # (four 2016-token prompts), and at the two_stage phase's stage-2 prefill
    def prefill_case(lens, L=2048, H=16, Hkv=2, D=128):
        B = len(lens)
        q, k, v = randn(B, L, H, D), randn(B, L, Hkv, D), randn(B, L, Hkv, D)
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
                               4 * D * H * _causal_pairs(L, lens)),
                "plain": lambda: fa.flash_attention_reference(q, k, v, mask, causal=True)}

    def summary(case, shape):
        return {"shape": shape, **{key: case[key] for key in (
            "err", "ratio", "ms", "device_ms", "library_ms")},
            "bound_ms": case["bound"][0], "bound_by": case["bound"][1]}

    check, main = prefill_case([2016, 1]), prefill_case([2016] * 4)
    L2, n2 = TWO_STAGE_PREFILL["L"], TWO_STAGE_PREFILL["kv_len"]
    stage2 = {B: prefill_case([n2] * B, L2) for B in TWO_STAGE_PREFILL["batches"]}
    grpo = {(B, L): prefill_case(_grpo_prefill_lens(B, L), L) for B, L in GRPO_PREFILL}
    rlvr = {(B, L): prefill_case(_rlvr_prefill_lens(B, L), L)
            for B, L in RLVR_PREFILL + MATH_VLM_PREFILL}
    judge = {(B, L): prefill_case(_judge_prefill_lens(B), L) for B, L in JUDGE_PREFILL}
    families = {name: prefill_case(list(lens), L, H, Hkv)
                for name, (lens, L, H, Hkv) in FAMILY_PREFILL.items()}
    head_dim_64 = {name: prefill_case(list(lens), L, H, Hkv, 64)
                   for name, (lens, L, H, Hkv) in HEAD_DIM_64_PREFILL.items()}
    agentic = {(B, L): prefill_case(_agentic_prefill_lens(B, L), L) for B, L in AGENTIC_PREFILL}
    agentic_text = {(B, L): prefill_case(_agentic_text_prefill_lens(B, L), L, 14, 2, 64)
                    for B, L in AGENTIC_TEXT_PREFILL}
    parallel = prefill_case([PARALLEL_PREFILL["kv_len"]] * PARALLEL_PREFILL["B"],
                            PARALLEL_PREFILL["L"], *PARALLEL_HEADS)
    cases = (check, main, *stage2.values(), *grpo.values(), *rlvr.values(), *judge.values(),
             *families.values(), *head_dim_64.values(), *agentic.values(),
             *agentic_text.values(), parallel)
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
        # each (B, L) bucket the rlvr phase's two pipelines may prefill
        rlvr_prefill={f"B{B}_L{L}": summary(case, f"B={B} L={L} kv_len="
                                                  f"{_rlvr_prefill_lens(B, L)}")
                      for (B, L), case in rlvr.items()},
        # each (B, L) bucket the workers phase's judge may prefill
        judge_prefill={f"B{B}_L{L}": summary(case, f"B={B} L={L} kv_len="
                                                   f"{_judge_prefill_lens(B)}")
                       for (B, L), case in judge.items()},
        # each family's prefill in the families phase
        families_prefill={name: summary(families[name], f"B={len(lens)} L={L} H={H} "
                                                        f"Hkv={Hkv} kv_len={list(lens)}")
                          for name, (lens, L, H, Hkv) in FAMILY_PREFILL.items()},
        # head dim 64: Qwen2.5-0.5B's prefill in the agentic phase and
        # Llama-3.2-1B's heads at the same shape (no phase serves it)
        head_dim_64={name: summary(head_dim_64[name], f"B={len(lens)} L={L} H={H} Hkv={Hkv} "
                                                      f"D=64 kv_len={list(lens)}")
                     | {"host_us": head_dim_64[name]["host_us"]}
                     for name, (lens, L, H, Hkv) in HEAD_DIM_64_PREFILL.items()},
        # each (B, L) bucket the agentic phase's two pipelines may prefill
        agentic_prefill={f"B{B}_L{L}": summary(case, f"B={B} L={L} kv_len="
                                                     f"{_agentic_prefill_lens(B, L)}")
                         for (B, L), case in agentic.items()},
        agentic_text_prefill={f"B{B}_L{L}": summary(case, f"B={B} L={L} H=14 Hkv=2 D=64 "
                                                          f"kv_len="
                                                          f"{_agentic_text_prefill_lens(B, L)}")
                              for (B, L), case in agentic_text.items()},
        # one shard's prefill in the parallel phase's tensor-parallel engine
        parallel_local=summary(parallel, "B={B} L={L} kv_len={kv_len} x {B}".format(
            **PARALLEL_PREFILL) + " H={} Hkv={}, one layer of one tp shard's prefill".format(
            *PARALLEL_HEADS)) | {"host_us": parallel["host_us"],
                                 "plain_ms": cuda_ms(parallel["plain"], n=10)},
        edge_max_abs_err=pre_edge[0], edge_max_row_ratio=pre_edge[1],
        bounds_checked=_prefill_bounds_check()))
    emit({"phase": "kernel", **results[-1]})

    results.extend(_decode_kernels(randn))
    results.extend(_train_kernels(randn, train_edge))
    for phase, spec in (("grpo", GRPO_TRAIN), ("rlvr", RLVR_TRAIN),
                        ("math_vlm", MATH_VLM_TRAIN), ("families", FAMILY_TRAIN),
                        ("agentic_vlm", AGENTIC_VLM_TRAIN), ("train_mesh", TRAIN_MESH_TRAIN),
                        ("train_mesh_pipeline", TRAIN_MESH_PIPELINE_TRAIN),
                        ("seq_pipe_ulysses", SEQ_PIPE_ULYSSES_TRAIN),
                        ("seq_pipe_pp", SEQ_PIPE_PP_TRAIN)):
        for row, cases in zip(results[-3:], _phase_train_kernels(randn, spec)):
            row[phase] = cases
            emit({"phase": f"kernel_{phase}_shapes", "name": row["name"], **cases})
    # head dim 64: the agentic phase's Qwen2.5-0.5B train batches (its text
    # pipeline's episodes, its 24-layer parity step) and Llama-3.2-1B's heads
    fwd64, dq64, dkv64, splits64 = train_edge_64
    edges64 = ({"edge_max_abs_err": fwd64[0], "edge_max_row_ratio": fwd64[1],
                "edge_lse_max_abs_err": fwd64[2]},
               {"edge_max_rel_err": dq64[0], "edge_max_row_ratio": dq64[1]},
               {"edge_max_rel_err": dkv64[0], "edge_max_row_ratio": dkv64[1],
                "edge_split_tiles": splits64, "plan_mismatch": _dkv_plan_mismatch(64)})
    for row, edge in zip(results[-3:], edges64):
        row["head_dim_64"] = dict(edge)
    for name, spec in HEAD_DIM_64_TRAIN.items():
        for row, cases in zip(results[-3:], _phase_train_kernels(randn, spec)):
            row["head_dim_64"][name] = cases
            emit({"phase": f"kernel_head_dim_64_{name}", "name": row["name"], **cases})
    # every head dim up to 128: the head_dims phase's widths
    widths = _head_dim_kernels(randn)
    for row in results:
        if row["name"] in widths:
            row["head_dims"] = widths[row["name"]]
    results.append(_row_writer_kernel(randn))
    emit({"phase": "kernels_seconds", "seconds": time.perf_counter() - t0})
    return results


# The two_stage phase's attention shapes, checked in phase_kernels and held to
# that phase's engine: stage-2 prompts of 2155 tokens (stage 1's are 2016) in
# the prompt_length bucket, prefilled four at a time by the sequential pass
# and two at a time by each restage group of run(); the cache of
# sequence_length 4096 + 64, Lalloc = ceil((4160 + 64) / 256) * 256.
# (the parallel phase's two decode replicas split each restage group of two
# and prefill its stage-2 prompts one at a time)
TWO_STAGE_PREFILL = {"L": 4096, "kv_len": 2155, "batches": (4, 2, 1)}
TWO_STAGE_LALLOC = 4352
# the main phase's cache: max_len 2560 + 64, decode_chunk 16
MAIN_LALLOC = -(-(2560 + 64 + 16) // 256) * 256
# The parallel phase's tensor-parallel engine: the main phase's four stage-1
# requests over tp = 2 shards of 8 q heads over 1 kv head each (16 / 2 heads
# cut in two), both on the one card; each shard's prefill at B=4, L=2048
# (kv 2016) and its own cache of 4 slots at MAIN_LALLOC, checked in
# phase_kernels at these local shapes (kernels 2, 3 and 3q).
PARALLEL_TP = 2
PARALLEL_HEADS = (16 // PARALLEL_TP, 2 // PARALLEL_TP)
PARALLEL_PREFILL = {"B": 4, "L": 2048, "kv_len": 2016}
PARALLEL_INT8 = {"weight_quant": "int8", "single_copy_quant": True, "kv_quant": "int8"}
# int4 single-copy weights under tp: q/k/v and gate/up split on their output
# channels, o_proj and down_proj on their packed rows and scale groups (the
# 3B's 2048 / 2 and 11008 / 2 contraction rows hold whole 128-row groups),
# the int4 head whole on each shard
PARALLEL_INT4 = {"weight_quant": "int4", "single_copy_quant": True}
# New tokens a request of the tp engines: one decode chunk (the main path
# generates 64), so the six engines' decode and teacher-forced tie checks fit
# the script's time limit; the cache is main's (MAIN_LALLOC) all the same.
PARALLEL_MAX_NEW = 16
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


# The rlvr phase's attention shapes, checked in phase_kernels and held to that
# phase's passes over the real engine. RLVRPipeline, text only: chat-templated
# math prompts of RLVR_PROMPT_TOKENS tokens or fewer in the prompt_length
# bucket of 256, one to four distinct prompts a prefill (the 8 samples of a
# group fork its prefill; max_running_requests 32 holds four groups), padded to
# a batch bucket; a cache of 32 slots of sequence_length 256 + 256 with
# decode_chunk 64 (Lalloc 768); one train step over the 4 x 8 samples at
# sequence_length 512 (kernels 4-6) and log-prob chunks of 8 (kernel 4).
# MathVLMPipeline: one 768² image a prompt (a 756² resize: one tower call of
# S = 2916, kernel 1), prompts of MATH_VLM_KV tokens in the bucket of 1024,
# one or two distinct prompts a prefill, 8 slots of 1024 + 128 (Lalloc 1280),
# train and log-prob batches of 8 at 1152.
RLVR_PROMPT_TOKENS = 141      # write_math_jsonl's prompts: 135-141 tokens
RLVR_PREFILL = ((1, 256), (2, 256), (4, 256))
RLVR_SLOTS, RLVR_LALLOC = 32, 768
RLVR_TRAIN = {"L": 512, "train_batch": 32, "logprob_batch": 8, "kv_lens": (397, 391)}
MATH_VLM_GRID = [[1, 54, 54]]
MATH_VLM_KV = 941             # 729 image rows and the templated question
MATH_VLM_PREFILL = ((1, 1024), (2, 1024))
MATH_VLM_SLOTS, MATH_VLM_LALLOC = 8, 1280
MATH_VLM_TRAIN = {"L": 1152, "train_batch": 8, "logprob_batch": 8, "kv_lens": (1069, 1040)}
# The workers phase's RLVR passes take the RLVR_* shapes. Its judge: 8
# chat-templated judge prompts of 412-439 tokens (JUDGE_PROMPT_TOKENS the
# most) in the bucket of 512, prefilled up to 8 at a time, decoded in the
# rlvr cache's shape (32 slots of max_len 512 + decode_chunk 64, Lalloc 768).
JUDGE_PROMPT_TOKENS = 439
JUDGE_PREFILL = tuple((B, 512) for B in (1, 2, 4, 8))


def _rlvr_prefill_lens(B: int, L: int):
    """kv lengths of an rlvr-phase prefill bucket: its prompts, 3 tokens
    apart, and a padded row (one valid token) where B > 1."""
    n = MATH_VLM_KV if L == 1024 else RLVR_PROMPT_TOKENS
    return [n - 3 * i for i in range(B - 1)] + [1] if B > 1 else [n]


def _judge_prefill_lens(B: int):
    """kv lengths of a judge prefill bucket: B of its prompts, 13 tokens
    apart, the longest JUDGE_PROMPT_TOKENS."""
    return [JUDGE_PROMPT_TOKENS - 13 * i for i in range(B)]


# The agentic phase's attention shapes, checked in phase_kernels and held to
# that phase. (a) AgenticVLMPipeline on the main tree: grid_goal frames of
# 112² (4 cells of 28 px: 8 x 8 patches, one window; 16 rows after the
# merge), one more a turn; prompts of ~176 tokens at the first turn (the
# system block, a user block with the frame, the assistant header) and
# ~260-350 at the second and third (each action's 32 tokens, the next
# frame's block), prefilled 1, 2 or 4 at a time in the buckets of 256 and
# 512; 4 slots of prompt_length 1024 + response_length 32 with decode_chunk
# 16 (Lalloc 1280); the episode batch of 4 rows right-padded to the longest
# episode (data-dependent: held after the run at the rows it had). (b)
# AgenticPipeline on Qwen2.5-0.5B (14 / 2 heads x 64): one request a turn,
# templated prompts of ~100-200 tokens in the buckets of 128 and 256, decoded
# densely (head dim 64, as the JAX package routes it); the batch of each
# episode's last turn at prompt_length 256 + response_length 32.
AGENTIC_GRID = [[1, 8, 8]]
AGENTIC_SLOTS, AGENTIC_DECODE_CHUNK = 4, 16
AGENTIC_VLM_CUTS = {"prompt_length": 1024, "response_length": 32, "max_steps": 2,
                    "max_steps_per_traj": 3, "env_groups": 2, "group_size": 2,
                    "val_batch_size": 2, "eval_steps": 1}
AGENTIC_LALLOC = -(-(1024 + 32 + AGENTIC_DECODE_CHUNK) // 256) * 256
AGENTIC_BUCKETS = (256, 512, 1024)
AGENTIC_PREFILL = tuple((B, L) for L in (256, 512) for B in (1, 2, 4))
AGENTIC_VLM_TRAIN = {"L": 384, "train_batch": 4, "logprob_batch": 4, "kv_lens": (380, 347)}
AGENTIC_TEXT_CUTS = {"prompt_length": 256, "response_length": 32, "max_steps": 2,
                     "episodes": 4, "max_turns": 3}
AGENTIC_TEXT_BUCKETS = (128, 256)
AGENTIC_TEXT_PREFILL = ((1, 128), (1, 256))
AGENTIC_TEXT_LALLOC = -(-(256 + 32 + AGENTIC_DECODE_CHUNK) // 256) * 256
AGENTIC_TEXT_TRAIN = {"L": 256 + 32, "train_batch": 4, "logprob_batch": 4,
                      "kv_lens": (230, 190), "H": 14, "Hkv": 2, "D": 64}


def _agentic_prefill_lens(B: int, L: int):
    """kv lengths of an agentic VLM prefill bucket: B prompts 37 tokens
    apart, a first turn's (176) in the bucket of 256, a third turn's (347)
    in that of 512."""
    return [(176 if L == 256 else 347) - 37 * i for i in range(B)]


def _agentic_text_prefill_lens(B: int, L: int):
    """kv lengths of an agentic text prefill bucket (one request)."""
    return [L - 8 - 37 * i for i in range(B)]


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
                                       2218, 2219) + tuple(2016 + 9 * i for i in range(12))),
    ("rlvr", RLVR_SLOTS, RLVR_LALLOC, (0, 1, 63, 64, 65, 100, 127, 128, 129, 140, 200, 255,
                                       256, 257, 300, 383, 384, 385, 396, 400, 511, 512, 513,
                                       639, 640, 641, 700, 703, 704, 705, 767, 768)),
    ("math_vlm", MATH_VLM_SLOTS, MATH_VLM_LALLOC, (0, 941, 942, 980, 1040, 1068, 1069, 1280)),
    ("agentic", AGENTIC_SLOTS, AGENTIC_LALLOC, (177, 211, 262, 300, 347, 380, 0, 1)[:AGENTIC_SLOTS]))
# the parallel phase's per-shard cache (kernels 3 and 3q): 36 layers, 8 q
# heads over 1 kv head, lengths of its 2016-token prompts mid-decode
PARALLEL_DECODE_CASES = (
    ("parallel", 4, MAIN_LALLOC, (2016, 2040, 2079, 0), 36, *PARALLEL_HEADS),)

# The families phase's attention shapes, checked in phase_kernels and held to
# the phase: four text prompts of these lengths in the prefill bucket of 512,
# prefilled together (kernel 2 at B=4), then greedy decode over 4 slots of
# max_len 512 + 32 with decode_chunk 16 (Lalloc 768; kernel 3); the MoE
# train step on B=2 rows of 2048 with kv lengths 2048 and 1500 (kernels
# 4-6, and kernel 4 for the batch's log-probs); Qwen2-VL through the main
# phase's shapes (prefill B=4 at 2048, kv 2016; MAIN_LALLOC) with 12/2
# heads and its ViT, full attention over each tile's two 2916-patch images
# in all 32 blocks (kernel 1 on the per-image ids of the main phase's tile).
FAMILY_PROMPT_LENS = (500, 433, 377, 300)
FAMILY_BUCKET = 512
FAMILY_MAX_NEW = {"qwen3_moe": 32, "qwen2_moe": 16}
FAMILY_LALLOC = -(-(FAMILY_BUCKET + 32 + 16) // 256) * 256
FAMILY_TRAIN = {"L": 2048, "train_batch": 2, "logprob_batch": 2, "kv_lens": (2048, 1500),
                "H": 32, "Hkv": 4}
FAMILY_TRAIN_LAYERS = 4
FAMILY_QWEN2_MOE_LAYERS = 8
# (name, layers, q heads, kv heads, Lalloc) of each served family's cache
# Kernel 2's checks: (prompt lengths, bucket, q heads, kv heads) of each
# family's one prefill; kernel 3's: each family's cache as a DECODE_CASES
# entry with its (layers, q heads, kv heads), at lengths mid-decode
FAMILY_PREFILL = {"qwen3_moe": (FAMILY_PROMPT_LENS, FAMILY_BUCKET, 32, 4),
                  "qwen2_moe": (FAMILY_PROMPT_LENS, FAMILY_BUCKET, 16, 16),
                  "qwen2_vl": ((2016,) * 4, 2048, 12, 2)}
FAMILY_DECODE_CASES = (
    ("qwen3_moe", 4, FAMILY_LALLOC, tuple(n + 17 for n in FAMILY_PROMPT_LENS), 48, 32, 4),
    ("qwen2_moe", 4, FAMILY_LALLOC, tuple(n + 9 for n in FAMILY_PROMPT_LENS),
     FAMILY_QWEN2_MOE_LAYERS, 16, 16),
    ("qwen2_vl", 4, MAIN_LALLOC, (2049, 2048, 2017, 2079), 28, 12, 2))
# Head dim 64: Qwen2.5-0.5B (14 / 2 heads) served and trained in the agentic
# phase as the families are (its four prompts in the bucket of 512, its
# 24-layer PPO step on B=2 rows of 2048 against dense attention, decode
# dense), and Llama-3.2-1B's 32 / 8 heads at the same shapes (no phase serves
# it); kernels 2 and 4-6 are checked at both.
HEAD_DIM_64_PREFILL = {"qwen2_5_0_5b": (FAMILY_PROMPT_LENS, FAMILY_BUCKET, 14, 2),
                       "llama_3_2_1b": (FAMILY_PROMPT_LENS, FAMILY_BUCKET, 32, 8)}
HEAD_DIM_64_TRAIN = {
    "qwen2_5_0_5b": {"L": 2048, "train_batch": 2, "logprob_batch": 2, "kv_lens": (2048, 1500),
                     "H": 14, "Hkv": 2, "D": 64},
    "llama_3_2_1b": {"L": 2048, "train_batch": 2, "logprob_batch": 2, "kv_lens": (2048, 1500),
                     "H": 32, "Hkv": 8, "D": 64},
    "agentic_text": AGENTIC_TEXT_TRAIN}

# The head_dims phase: public checkpoints whose head dim is none of the
# instances' widths or needs a padded instance in training, typed in from
# each repository's config.json (the fields that set a kernel's shape; the
# others, rope_theta, rms_norm_eps, the special token ids, are not at hand
# offline and take config_from_hf_dict's defaults: they change no kernel
# shape, and the weights are random). Head dim = hidden / heads, or the
# config's own head_dim (Falcon3).
DANUBE3_4B = {        # h2oai/h2o-danube3-4b-base: head dim 120, rep 4
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_size": 3840,
    "num_hidden_layers": 24, "num_attention_heads": 32, "num_key_value_heads": 8,
    "intermediate_size": 10240, "vocab_size": 32000}
DANUBE3_500M = {      # h2oai/h2o-danube3-500m-base: head dim 96, rep 2
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_size": 1536,
    "num_hidden_layers": 16, "num_attention_heads": 16, "num_key_value_heads": 8,
    "intermediate_size": 4096, "vocab_size": 32000}
DANUBE2_1_8B = {      # h2oai/h2o-danube2-1.8b-base: head dim 80, rep 4
    "architectures": ["MistralForCausalLM"], "model_type": "mistral", "hidden_size": 2560,
    "num_hidden_layers": 24, "num_attention_heads": 32, "num_key_value_heads": 8,
    "intermediate_size": 6912, "vocab_size": 32000}
OPEN_LLAMA_3B_V2 = {  # openlm-research/open_llama_3b_v2: head dim 100 (host pad), rep 1
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_size": 3200,
    "num_hidden_layers": 26, "num_attention_heads": 32, "num_key_value_heads": 32,
    "intermediate_size": 8640, "vocab_size": 32000}
FALCON3_7B = {        # tiiuae/Falcon3-7B-Base: head dim 256, rep 3
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_size": 3072,
    "num_hidden_layers": 28, "num_attention_heads": 12, "num_key_value_heads": 4,
    "head_dim": 256, "intermediate_size": 23040, "vocab_size": 131072,
    "rope_theta": 1000042}
# Head dims above 256: no published checkpoint of the families llm.py loads
# has one, so these are regroupings of Falcon3-7B's published config, not
# published checkpoints. Its 12/4 x 256 attention as 6/2 x 512 (rep 3) keeps
# every projection's shape (q 3072 x 3072, k and v 1024 x 3072), the
# parameter count and the work a layer, so the phase reads Falcon3's shards
# back under this config.json; as 8/2 x 384 (rep 4) the kv projections are
# 768 wide. The kernels run them in two column slices of 256.
FALCON3_7B_D512 = dict(FALCON3_7B, num_attention_heads=6, num_key_value_heads=2, head_dim=512)
FALCON3_7B_D384 = dict(FALCON3_7B, num_attention_heads=8, num_key_value_heads=2, head_dim=384)
# name: (config, repository, layers served, layers trained; None: not run).
# Danube3-4B served at full depth and trained at FAMILY_TRAIN_LAYERS,
# Danube3-500M served and trained at full depth, Danube2-1.8B trained at
# FAMILY_TRAIN_LAYERS (kernels 4-6 at 80 on the 128 instance of 5 and 6),
# OpenLLaMA-3B v2 served at FAMILY_TRAIN_LAYERS (kernel 2 through the pad),
# Falcon3-7B served at full depth (kernels 2 and 3 at 256) and trained at
# FAMILY_TRAIN_LAYERS (kernels 4-6 at 256); its 6/2 x 512 regrouping the
# same (kernels 2, 3 and 4-6 at 512), its 8/2 x 384 one served and trained
# at FAMILY_TRAIN_LAYERS (kernels 2, 3 and 4-6 at 384).
HEAD_DIM_MODELS = {
    "danube3_4b": (DANUBE3_4B, "h2oai/h2o-danube3-4b-base", 24, FAMILY_TRAIN_LAYERS),
    "danube3_500m": (DANUBE3_500M, "h2oai/h2o-danube3-500m-base", 16, 16),
    "danube2_1_8b": (DANUBE2_1_8B, "h2oai/h2o-danube2-1.8b-base", None, FAMILY_TRAIN_LAYERS),
    "open_llama_3b_v2": (OPEN_LLAMA_3B_V2, "openlm-research/open_llama_3b_v2",
                         FAMILY_TRAIN_LAYERS, None),
    "falcon3_7b": (FALCON3_7B, "tiiuae/Falcon3-7B-Base", 28, FAMILY_TRAIN_LAYERS),
    "falcon3_7b_d512": (FALCON3_7B_D512, "tiiuae/Falcon3-7B-Base regrouped 6/2 x 512", 28,
                        FAMILY_TRAIN_LAYERS),
    "falcon3_7b_d384": (FALCON3_7B_D384, "tiiuae/Falcon3-7B-Base regrouped 8/2 x 384",
                        FAMILY_TRAIN_LAYERS, FAMILY_TRAIN_LAYERS)}
# Models served again with the int8 KV cache (kernel 3q) at these layers.
HEAD_DIM_INT8_LAYERS = {"falcon3_7b": FAMILY_TRAIN_LAYERS, "falcon3_7b_d512": FAMILY_TRAIN_LAYERS}
# A regrouping read back from the shards of the model it regroups (written
# just before it, in HEAD_DIM_MODELS' order): the same tensors under another
# config.json.
HEAD_DIM_REGROUPED = {"falcon3_7b_d512": "falcon3_7b"}


def _heads(hf):
    """(q heads, kv heads, head dim) of an HF text config."""
    H = hf["num_attention_heads"]
    return H, hf.get("num_key_value_heads", H), hf.get("head_dim", hf["hidden_size"] // H)


# The shapes the phase's passes take, checked in phase_kernels: each served
# model's one prefill of FAMILY_PROMPT_LENS in the bucket of 512 (kernel 2),
# each trained model's PPO step on FAMILY_TRAIN's rows (kernels 4-6) and its
# log-prob pass (kernel 4).
HEAD_DIMS_PREFILL = {name: (FAMILY_PROMPT_LENS, FAMILY_BUCKET, *_heads(hf))
                     for name, (hf, _, serve, _) in HEAD_DIM_MODELS.items() if serve}
HEAD_DIMS_TRAIN = {name: {**FAMILY_TRAIN, **dict(zip(("H", "Hkv", "D"), _heads(hf)))}
                   for name, (hf, _, _, train) in HEAD_DIM_MODELS.items() if train}
# Edge shapes at other head dims: kernel 2's (B, Lq, H, Hkv, D, causal), GQA
# ratios 4, 1, 2, 3, 5 and 8 at widths 32 (the 64 instance), 72 (the 80
# one), 96, 100 (padded to 104), 120 (the 128 one), 132 (padded to 136),
# 136, 192, 200 and 256 (the 256 one), and GQA ratios 1, 3 and 4 at 264,
# 300 (padded to 304), 320, 384, 512 and 640 (the 256 one in column
# slices); kernels 4-6's TRAIN_EDGES-style cases at each width of
# HEAD_DIM_TRAIN_WIDTHS (a length-1 row, a split plan, a row of no key, rep
# 1 and 3).
HEAD_DIM_EDGES = ((2, 129, 32, 8, 120, True), (1, 1, 32, 8, 120, True),
                  (2, 300, 20, 4, 120, False), (3, 129, 32, 32, 100, True),
                  (2, 63, 16, 8, 96, True), (3, 200, 4, 4, 96, False),
                  (2, 150, 16, 2, 72, True), (2, 129, 8, 2, 32, True),
                  (3, 300, 12, 4, 256, True), (2, 129, 4, 4, 256, False),
                  (3, 200, 16, 4, 256, True), (1, 1, 12, 4, 256, True),
                  (3, 257, 12, 4, 192, True), (2, 129, 16, 4, 192, False),
                  (3, 200, 4, 4, 200, True), (3, 129, 12, 4, 136, True),
                  (2, 300, 16, 4, 132, True), (2, 63, 4, 4, 132, False),
                  (3, 300, 6, 2, 512, True), (1, 1, 6, 2, 512, True), (2, 129, 4, 4, 512, False),
                  (3, 200, 8, 2, 384, True), (2, 63, 12, 4, 384, False),
                  (3, 257, 12, 4, 264, True), (2, 129, 4, 1, 300, True),
                  (2, 200, 16, 4, 320, False), (3, 150, 6, 2, 640, True),
                  (1, 63, 4, 4, 640, False))
HEAD_DIM_TRAIN_EDGES = ((1, 1, 32, 8, True, [1], None), (2, 200, 32, 8, True, [200, 77], 1),
                        (3, 129, 16, 8, True, [129, 1, 0], None),
                        (2, 129, 4, 4, False, [129, 64], None),
                        (2, 300, 32, 32, True, [300, 150], None),
                        (2, 300, 12, 4, True, [300, 150], 2))
HEAD_DIM_TRAIN_WIDTHS = (120, 96, 80, 100, 32, 132, 136, 192, 200, 256, 264, 300, 320, 384,
                         512, 640)
# kernel 1's width cases: one 756² image's ids (the rlvr phase's MathVLM
# grid) at 16 heads (no ViT is wider than 128: above 256 these are the
# sliced kernel's only launches)
HEAD_DIM_SEG_WIDTHS = (96, 120, 132, 136, 192, 200, 256, 264, 300, 320, 384, 512, 640)
# Kernels 3 and 3q at head dims 256, 512 and 384: (case, slots, Lalloc,
# lengths, layers, q heads, kv heads, head dim) as DECODE_CASES. Falcon3-7B's
# served cache and its regroupings' mid-decode (timed; 3q at an int8 pass's
# HEAD_DIM_INT8_LAYERS), GQA ratio 8 with zero-length and full slots, ratio
# 3 at 32 slots, at each width.
_SLOTS32 = (0, 1, 63, 64, 65, 576) + tuple(17 * i for i in range(1, 27))
HEAD_DIM_DECODE_CASES = (
    ("falcon3_7b", 4, FAMILY_LALLOC, tuple(n + 17 for n in FAMILY_PROMPT_LENS), 28, 12, 4,
     256),
    ("falcon3_7b_d512", 4, FAMILY_LALLOC, tuple(n + 17 for n in FAMILY_PROMPT_LENS), 28, 6, 2,
     512),
    ("falcon3_7b_d384", 4, FAMILY_LALLOC, tuple(n + 17 for n in FAMILY_PROMPT_LENS),
     FAMILY_TRAIN_LAYERS, 8, 2, 384),
    ("d256_rep8", 4, 640, (0, 1, 337, 640), 3, 16, 2, 256),
    ("d256_rep3_slots32", 32, 576, _SLOTS32, 3, 12, 4, 256),
    ("d512_rep8", 4, 640, (0, 1, 337, 640), 3, 16, 2, 512),
    ("d512_rep3_slots32", 32, 576, _SLOTS32, 3, 12, 4, 512),
    ("d384_rep8", 4, 640, (0, 1, 337, 640), 3, 16, 2, 384),
    ("d384_rep3_slots32", 32, 576, _SLOTS32, 3, 12, 4, 384))
HEAD_DIM_DECODE_EDGES = tuple(c[0] for c in HEAD_DIM_DECODE_CASES if not c[0].startswith("falcon"))


def _decode_caches(randn, slots, Lalloc, quant, layers=36, Hkv=2, D=128):
    """The stacked caches (k, v), (layers, S, Lalloc, Hkv, D), or, for
    kernel 3q, (k codes, v codes, k scales, v scales) from quantize_kv,
    scales (layers, S, Hkv, Lalloc)."""
    from socioreasoner_tpu_torch.ops import decode_attention as da
    if not quant:
        return (randn(layers, slots, Lalloc, Hkv, D),
                randn(layers, slots, Lalloc, Hkv, D))
    codes, scales = [], []
    for _ in range(2):
        code, scale = da.quantize_kv(randn(layers * slots, Lalloc, Hkv, D))
        codes.append(code.reshape(layers, slots, Lalloc, Hkv, D))
        scales.append(scale.reshape(layers, slots, Lalloc, Hkv).transpose(-1, -2)
                      .contiguous())
        del code, scale
    return (*codes, *scales)


def _decode_kernels(randn):
    """Kernels 3 (bf16 cache) and 3q (int8 codes with f32 scales) over the
    stacked cache (36, S, Lalloc, 2, 128) at DECODE_CASES (and the other
    phases' caches, head dim 256 included: HEAD_DIM_DECODE_CASES): each
    (slot, q head) row against the plain version in f32 on the same values
    (ROW_TOL; a zero-length slot exactly 0) at the first, a middle and the
    last layer, two calls bit-equal; per layer over a sweep of all the
    cache's layers (a layer's blocks come from HBM as in the decode step,
    not L2): ms, device ms from a CUDA graph of the sweep (the
    torch.profiler figure beside it), host us a call, the plain version's
    and the library call's ms, the bound."""
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
        for case, slots, Lalloc, lens, *heads in (DECODE_CASES + FAMILY_DECODE_CASES
                                                  + PARALLEL_DECODE_CASES
                                                  + HEAD_DIM_DECODE_CASES):
            if quant and case in ("two_stage", "grpo", "rlvr", "math_vlm", "agentic") + tuple(
                    c[0] for c in FAMILY_DECODE_CASES):
                continue
            layers, H, Hkv, D = (*(heads or (36, 16, 2)), 128)[:4]
            if quant and case in HEAD_DIM_INT8_LAYERS:     # the model's int8 pass
                layers = HEAD_DIM_INT8_LAYERS[case]
            lens = [n % Lalloc if n < 0 else n for n in lens]
            caches = _decode_caches(randn, slots, Lalloc, quant, layers, Hkv, D)
            k, v, scales = caches[0], caches[1], caches[2:]
            q = randn(slots, H, D)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            for layer in (0, layers // 2, layers - 1):
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
            if case not in ("edges",) + HEAD_DIM_DECODE_EDGES:
                sweep = lambda: [da.paged_decode_attention(   # noqa: E731
                    q, k, v, lengths, *scales, layer=i) for i in range(layers)]
                plain = lambda: [plain_fn(q, k, v, lengths, *scales, layer=i)   # noqa: E731
                                 for i in range(layers)]
                n_keys = sum(lens)
                # q read and the output written (bf16), and each valid key's K
                # and V rows of every kv head once: bf16, or int8 codes and an
                # f32 scale a row
                row_bytes = D + 4 if quant else D * 2
                figures = {
                    "shape": f"({layers}, {slots}, {Lalloc}, {Hkv}, {D}) under {H} q heads",
                    "lengths": lens, "heads": f"{layers} layers, {H}/{Hkv} heads",
                    "n_split": da.decode_plan(q, k, v, lengths, *scales, stacked=True).n_split,
                    "ms": cuda_ms(sweep) / layers,
                    "device_ms": graph_call_ms(sweep, reps=1) / layers,
                    "profiler_device_ms": device_ms(sweep, ("paged_decode",)) / layers,
                    "host_us": host_us(lambda: da.paged_decode_attention(
                        q, k, v, lengths, *scales, layer=layers // 2)),
                    "plain_ms": cuda_ms(plain, n=10) / layers,
                    "bound": bound(2 * (2 * q.numel()) + n_keys * Hkv * 2 * row_bytes,
                                   4 * D * H * n_keys)}
                if not quant:
                    # the library call: one query per slot over the layer's
                    # cache view with a boolean length mask (rows of length 0
                    # give NaN there)
                    keep = (torch.arange(Lalloc, device=dev)[None]
                            < lengths[:, None])[:, None, None]
                    q4 = q[:, :, None]
                    figures["library_ms"] = cuda_ms(lambda: [F.scaled_dot_product_attention(
                        q4, k[i].transpose(1, 2), v[i].transpose(1, 2), attn_mask=keep,
                        enable_gqa=True) for i in range(layers)], n=10) / layers
                timed[case] = figures
            del caches, k, v, scales
            torch.cuda.empty_cache()

        def summary(fig):
            return {key: fig[key] for key in ("lengths", "heads", "n_split", "ms", "device_ms",
                                              "profiler_device_ms", "host_us", "plain_ms")} \
                | {"bound_ms": fig["bound"][0], "bound_by": fig["bound"][1],
                   "library_ms": fig.get("library_ms")}

        main = timed["main"]
        kind = "int8 cache + f32 scales" if quant else "cache"
        shapes = f"(36, 4|8|32, {MAIN_LALLOC}, 2, 128)" + (
            "" if quant else f", (36, 4|{GRPO_SLOTS}, {TWO_STAGE_LALLOC}, 2, 128), "
            f"(36, {RLVR_SLOTS}, {RLVR_LALLOC}, 2, 128), "
            f"(36, {MATH_VLM_SLOTS}, {MATH_VLM_LALLOC}, 2, 128), "
            f"(36, {AGENTIC_SLOTS}, {AGENTIC_LALLOC}, 2, 128) and the families' "
            + ", ".join(f"({c[4]}, {c[1]}, {c[2]}, {c[6]}, 128) under {c[5]} q heads"
                        for c in FAMILY_DECODE_CASES))
        extra = {} if quant else {case: summary(timed[case]) for case in (
            "two_stage", "grpo", "rlvr", "math_vlm", "agentic")} | {"families_decode": {
                c[0]: summary(timed[c[0]]) for c in FAMILY_DECODE_CASES}}
        # the parallel phase's local shard: 3 on its bf16 cache, 3q on its int8 one
        extra["parallel_local"] = summary(timed["parallel"])
        # Falcon3-7B's cache at head dim 256 and its regroupings' at 512 and
        # 384 (the head_dims phase; an int8 pass at HEAD_DIM_INT8_LAYERS), and
        # the edge cases checked with them
        for case, D in (("falcon3_7b", 256), ("falcon3_7b_d512", 512), ("falcon3_7b_d384", 384)):
            extra[f"head_dim_{D}"] = summary(timed[case]) | {
                "shape": timed[case]["shape"],
                "edge_cases": [c for c in HEAD_DIM_DECODE_EDGES if c.startswith(f"d{D}_")]}
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
    and v, the script's own comparison. device_ms is the profiler's sum of
    the kernel's time, as before the kernel was launched with programmatic
    dependent launch (PDL), which now counts each kernel's wait for the one
    before it; graph_device_ms a sweep's time from a CUDA graph of ten,
    taken in turns with the launch floor: 36 launches of the library's
    empty kernel in a graph, with and without PDL. `seconds` is the
    check's own wall time."""
    import torch
    from socioreasoner_tpu_torch.ops import cache_write as cw

    t0 = time.perf_counter()
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

    def floor_sweep(pdl):
        for _ in range(L):
            cw.launch_noop(k0.device, pdl)

    # a sweep from a graph of ten, in turns (a, b, c, c, b, a, ...): the
    # medians of four timings each
    sweeps = {"kernel": kernel_sweep, "floor_pdl": functools.partial(floor_sweep, True),
              "floor_no_pdl": functools.partial(floor_sweep, False)}
    order = list(sweeps)
    timed = {key: [] for key in order}
    for turn in range(4):
        for key in (order if turn % 2 == 0 else order[::-1]):
            timed[key].append(graph_call_ms(sweeps[key]))
    graph_dev = {key: statistics.median(ts) for key, ts in timed.items()}
    # per layer and cache: the new rows read once and written once
    bound_ms, bound_by = bound(L * 2 * 2 * knew.numel() * 2, 0)
    out = _row("write_rows", "socioreasoner_tpu_torch/csrc/cache_write.cu",
               "scripts/profile_decode2.py:50",
               f"caches {ROW_WRITER_SHAPE} bf16, rows (24, 1, 2, 128), ms per sweep of 36 "
               "layers x (k and v) replayed as one CUDA graph (the script times one jitted "
               "loop); eager_ms with the host's launches; device_ms the profiler's sum; "
               "graph_device_ms a sweep from a graph of ten; launched with PDL",
               0.0, graph_ms(kernel_sweep), graph_ms(plain_sweep), bound_ms, bound_by, None,
               "none beyond the two index_put_ calls, which are its plain version",
               eager_ms=cuda_ms(kernel_sweep), plain_eager_ms=cuda_ms(plain_sweep),
               device_ms=device_ms(kernel_sweep, ("write_rows",)),
               plain_device_ms=device_ms(plain_sweep, ("",)),
               graph_device_ms=graph_dev["kernel"],
               plain_graph_device_ms=graph_call_ms(plain_sweep),
               graph_device_ms_turns=timed,
               us_per_launch={key: ms / L * 1e3 for key, ms in graph_dev.items()},
               floor_ms=graph_dev["floor_pdl"], floor_no_pdl_ms=graph_dev["floor_no_pdl"],
               gap_to_floor_ms=graph_dev["kernel"] - graph_dev["floor_pdl"])
    out["share_of_bound_device"] = bound_ms / out["device_ms"]
    out["share_of_bound_graph_device"] = bound_ms / out["graph_device_ms"]
    out["seconds"] = time.perf_counter() - t0
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


def _phase_train_kernels(randn, spec, name_library=False):
    """Kernels 4-6 at a phase's train micro-batch and kernel 4 at its
    log-prob chunk (`spec`: GRPO_TRAIN, RLVR_TRAIN, MATH_VLM_TRAIN, ...: L,
    the two batch sizes, and two kv lengths that the rows alternate, each
    pair of rows 3 shorter, or the rows' own `lens`; the heads H / Hkv and
    head dim D, 16 / 2 x 128 unless named), against their plain versions in
    f32 a batch row at a time, row by row (kernel 6 on a plan built once,
    against the joint scale of dk and dv with GRAD_ROW_FLOOR; kernels 5 and
    6 two calls bit-equal), each timed with its bound, host us and library
    call (with name_library, the device kernels that call runs: which
    backend SDPA picked). Returns one dict of cases for each of kernels 4,
    5, 6."""
    import torch
    import torch.nn.functional as F
    from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb

    dev = torch.device("cuda")
    L, H, Hkv, D = spec["L"], spec.get("H", 16), spec.get("Hkv", 2), spec.get("D", 128)
    out = ({}, {}, {})
    for B, backward in ((spec["train_batch"], True), (spec["logprob_batch"], False)):
        lens_l = list(spec["lens"][:B]) if "lens" in spec else \
            [spec["kv_lens"][b % 2] - 3 * (b // 2) for b in range(B)]
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        q, k, v, do = randn(B, L, H, D), randn(B, L, Hkv, D), randn(B, L, Hkv, D), \
            randn(B, L, H, D)
        tag = f"B={B} L={L} H={H} Hkv={Hkv} D={D} causal kv_len={lens_l}"
        refs = [fb.flash_attention_fwd_lse_reference(
            q[b:b + 1].float(), k[b:b + 1].float(), v[b:b + 1].float(), lens[b:b + 1])
            for b in range(B)]
        ref_out, ref_lse = torch.cat([r[0] for r in refs]), torch.cat([r[1] for r in refs])
        del refs
        run_fwd = lambda: fb.flash_attention_fwd_lse(q, k, v, lens)   # noqa: E731
        got, lse = run_fwd()
        err, ratio = _check_rows(f"train fwd {tag}", got, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"train fwd {tag}: lse max_abs_err {lse_err} > {LSE_TOL}")
        del got, lse
        qt, dot = q.transpose(1, 2), do.transpose(1, 2)
        kt, vt = (x.repeat_interleave(H // Hkv, dim=2).transpose(1, 2) for x in (k, v))
        pairs = H * _causal_pairs(L, lens_l)
        f32_rows = B * H * L * 4
        qkv_bytes = 2 * (q.numel() + k.numel() + v.numel())
        case = "train_micro_batch" if backward else "logprob_chunk"
        if D <= 256:
            fwd_lib = lambda: torch.ops.aten._scaled_dot_product_flash_attention(  # noqa: E731
                qt, kt, vt, is_causal=True)
        else:      # no flash backend takes D > 256: the memory-efficient one, with lse
            fwd_lib = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(  # noqa: E731
                qt, kt, vt, None, True, is_causal=True)
        out[0][case] = {
            "shape": tag, "err": err, "ratio": ratio, "lse_err": lse_err,
            "ms": cuda_ms(run_fwd), "device_ms": graph_call_ms(run_fwd),
            "host_us": host_us(run_fwd), "library_ms": cuda_ms(fwd_lib),
            **dict(zip(("bound_ms", "bound_by"),
                       bound(qkv_bytes + 2 * q.numel() + f32_rows, 4 * D * pairs)))}
        if name_library:
            out[0][case]["library_kernels"] = library_kernels(fwd_lib)
        if not backward:
            continue
        delta = (do.float() * ref_out).sum(-1).transpose(1, 2).contiguous()
        plan = fb.dkv_plan(lens, B, L, L, H, Hkv, True, dev, head_dim=D)
        run_dq = lambda: fb.flash_attention_bwd_dq(   # noqa: E731
            q, k, v, do, ref_lse, delta, lens)
        run_dkv = lambda: fb.flash_attention_bwd_dkv(   # noqa: E731
            q, k, v, do, ref_lse, delta, lens, plan=plan)
        got = (run_dq(), *run_dkv())
        again = (run_dq(), *run_dkv())
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"kernels 5/6 {tag}: two calls on the same inputs differ")
        del again
        want = [torch.cat(g) for g in zip(*(fb.flash_attention_bwd_reference(
            q[b:b + 1].float(), k[b:b + 1].float(), v[b:b + 1].float(), do[b:b + 1].float(),
            ref_lse[b:b + 1], delta[b:b + 1], lens[b:b + 1]) for b in range(B)))]
        scale = max(w.abs().max().item() for w in want[1:])
        dq_err = _check_grad(f"train dq {tag}", got[0], want[0],
                             want[0].abs().max().item())
        dkv_err = [_check_grad(f"train {name} {tag}", g, w, scale)
                   for name, g, w in zip(("dk", "dv"), got[1:], want[1:])]
        del got, want
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        bwd_lib = lambda: torch.autograd.grad(   # noqa: E731
            lib_out, leaves, dot, retain_graph=True)
        lib_bwd = cuda_ms(bwd_lib)
        lib_names = library_kernels(bwd_lib) if name_library else None
        del lib_out, leaves, bwd_lib
        bwd_in = qkv_bytes + 2 * do.numel() + 2 * f32_rows
        for i, (run, err_t, out_bytes, ops) in enumerate((
                (run_dq, [dq_err], 2 * q.numel(), 6 * D * pairs),
                (run_dkv, dkv_err, 2 * (k.numel() + v.numel()), 8 * D * pairs)), start=1):
            out[i][case] = {
                "shape": tag, "err": max(e[0] for e in err_t),
                "rel_err": max(e[1] for e in err_t), "ratio": max(e[2] for e in err_t),
                "ms": cuda_ms(run), "device_ms": graph_call_ms(run), "host_us": host_us(run),
                "bit_equal_twice": True,
                "library_ms": lib_bwd, "library": "SDPA autograd backward, dq+dk+dv",
                **dict(zip(("bound_ms", "bound_by"), bound(bwd_in + out_bytes, ops))),
                **({"library_kernels": lib_names} if name_library else {})}
        del plan
    torch.cuda.empty_cache()
    return out


# Kernel 6 on a plan built for kv lengths [8, 3], called with [8, 3] and
# then with [8, 5]: the second call must end in a CUDA error (the kernel's
# trap), which leaves the process's CUDA context unusable, so it runs in a
# child process of its own.
PLAN_MISMATCH_CHILD = """
import json, sys, torch
from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb
dev = torch.device("cuda")
D = int(sys.argv[1])
g = torch.Generator(device=dev).manual_seed(0)
q, do = (torch.randn(2, 8, 4, D, generator=g, device=dev).bfloat16() for _ in range(2))
k, v = (torch.randn(2, 8, 2, D, generator=g, device=dev).bfloat16() for _ in range(2))
stats = torch.zeros(2, 4, 8, device=dev)
plan = fb.dkv_plan(torch.tensor([8, 3]), 2, 8, 8, 4, 2, True, dev, head_dim=D)
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


def _dkv_plan_mismatch(D: int = 128) -> str:
    """Runs PLAN_MISMATCH_CHILD at head dim D from the repository's root;
    returns the CUDA error of its mismatched call, raises unless the
    matching call ran and the mismatched one failed with a CUDA error."""
    child = subprocess.run([sys.executable, "-c", PLAN_MISMATCH_CHILD, str(D)],
                           cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                           timeout=300)
    lines = child.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines else {}
    if child.returncode != 0 or "CUDA" not in result.get("error", ""):
        raise AssertionError(f"kernel 6 on a plan for other kv lengths: exit "
                             f"{child.returncode}, {result}, {child.stderr[-2000:]}")
    return result["error"]


def library_kernels(fn, top: int = 3) -> list:
    """The device kernels one fn() runs, the longest first, by name from
    torch.profiler (for an SDPA call: the backend it picked)."""
    _, _, rows = profiled(fn)
    kernels = sorted((r for r in rows if r["plane"].startswith("/device:")),
                     key=lambda r: -r["total_us"])
    return [r["name"][:90] for r in kernels[:top]]


def _head_dim_instance_check() -> int:
    """fa.head_dim_plan, the host's choice of width, instance and column
    slices for kernels 1, 2, 4, 5 and 6, against the kernels' own formulas
    (socio_head_dim_instance and socio_head_dim_slices run head_dim_instance
    and head_dim_slices on the host) at every head dim 1-1100: the instance
    and slices of the padded width, and no instance for a width that is no
    multiple of HEAD_DIM_ALIGN. Returns the cases compared."""
    from socioreasoner_tpu_torch.ops import _build
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb
    lib = _build.library()
    n = 0
    for kernel, instances in ((1, fa.SEG_HEAD_DIMS), (2, fa.KERNEL_HEAD_DIMS),
                              (4, fa.KERNEL_HEAD_DIMS), (5, fb.TRAIN_HEAD_DIMS),
                              (6, fb.TRAIN_HEAD_DIMS)):
        for D in range(1, 1101):
            plan = fa.head_dim_plan(D, instances)
            got = (lib.socio_head_dim_instance(kernel, plan.width),
                   lib.socio_head_dim_slices(kernel, plan.width))
            bare = lib.socio_head_dim_instance(kernel, D)
            if got != plan[1:] or (D % fa.HEAD_DIM_ALIGN and bare):
                raise AssertionError(f"kernel {kernel} D={D}: the host plans {plan}, the "
                                     f"kernels' formulas give {got} ({bare} unpadded)")
            n += 1
    return n


def _twin_ms(randn, B, L, H, Hkv, lens, train: bool, D: int = 128) -> dict:
    """Device ms (CUDA graph) of kernel 2 (or kernels 4, 5 and 6) on inputs
    of the same shape at head dim D: at D=128, the instance a narrower head
    dim runs on (what the zero-filled columns cost against a native 128);
    at D=192, a head dim on the 256 instance beside its native twin."""
    import torch
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb
    q, k, v = randn(B, L, H, D), randn(B, L, Hkv, D), randn(B, L, Hkv, D)
    lt = torch.tensor(lens, dtype=torch.int32, device=q.device)
    if not train:
        mask = (torch.arange(L, device=q.device)[None] < lt[:, None]).to(torch.int32)
        return {"flash_attention": graph_call_ms(lambda: fa.flash_attention(q, k, v, mask))}
    do = randn(B, L, H, D)
    out, lse = fb.flash_attention_fwd_lse(q, k, v, lt)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    plan = fb.dkv_plan(lt, B, L, L, H, Hkv, True, q.device, head_dim=D)
    return {"flash_attention_fwd_lse": graph_call_ms(lambda: fb.flash_attention_fwd_lse(
                q, k, v, lt)),
            "flash_attention_bwd_dq": graph_call_ms(lambda: fb.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, lt)),
            "flash_attention_bwd_dkv": graph_call_ms(lambda: fb.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, lt, plan=plan))}


def _head_dim_kernels(randn):
    """The kernels at the head_dims phase's widths against their plain
    versions in f32 on the same bf16 values, row by row: kernel 2 at each
    served model's prefill (HEAD_DIMS_PREFILL: 120, 96 and 100, the last
    through the host pad, timed apart) and at HEAD_DIM_EDGES; kernels 4-6 at
    each trained model's step (HEAD_DIMS_TRAIN: 120, 96, 80; kernels 5 and
    6 two calls bit-equal) and at HEAD_DIM_TRAIN_EDGES for each width of
    HEAD_DIM_TRAIN_WIDTHS; kernel 1 on one 756² image at
    HEAD_DIM_SEG_WIDTHS; each with its bound and the library call (the
    device kernels it runs named); then head_dim_plan against the C
    formula. Returns {kernel name: its head-dim figures}."""
    import torch
    import torch.nn.functional as F
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda")
    worst = lambda a, b: (max(a[0], b[0]), max(a[1], b[1]))   # noqa: E731
    out = {"flash_attention_segmented": {}, "flash_attention": {},
           "flash_attention_fwd_lse": {}, "flash_attention_bwd_dq": {},
           "flash_attention_bwd_dkv": {}}
    for D in HEAD_DIM_SEG_WIDTHS:
        out["flash_attention_segmented"][f"D{D}"] = _one_image_seg_checks(randn, D=D)
    pre = (0.0, 0.0)
    for B, Lq, H, Hkv, D, causal in HEAD_DIM_EDGES:
        q, k, v = randn(B, Lq, H, D), randn(B, Lq, Hkv, D), randn(B, Lq, Hkv, D)
        lens = [Lq, 0, 1, max(Lq // 2, 1)][:B]
        mask = (torch.arange(Lq, device=dev)[None]
                < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
        pre = worst(pre, _check_rows(
            f"prefill edge B={B} Lq={Lq} H={H}/{Hkv} D={D} causal={causal}",
            fa.flash_attention(q, k, v, mask, causal=causal),
            fa.flash_attention_reference(q.float(), k.float(), v.float(), mask,
                                         causal=causal)))
    out["flash_attention"]["edges"] = {"max_abs_err": pre[0], "max_row_ratio": pre[1],
                                       "cases": len(HEAD_DIM_EDGES)}
    for name, (lens, L, H, Hkv, D) in HEAD_DIMS_PREFILL.items():
        B = len(lens)
        q, k, v = randn(B, L, H, D), randn(B, L, Hkv, D), randn(B, L, Hkv, D)
        mask = (torch.arange(L, device=dev)[None]
                < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
        run = lambda: fa.flash_attention(q, k, v, mask, causal=True)   # noqa: E731
        err, ratio = _check_rows(f"prefill {name}", run(), fa.flash_attention_reference(
            q.float(), k.float(), v.float(), mask, causal=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        width, inst, slices = fa.head_dim_plan(D, fa.KERNEL_HEAD_DIMS)
        case = {"shape": f"B={B} L={L} H={H} Hkv={Hkv} D={D} kv_len={list(lens)}",
                "instance": inst, "width": width, "slices": slices, "err": err, "ratio": ratio,
                "ms": cuda_ms(run), "device_ms": graph_call_ms(run),
                "kernel_device_ms": device_ms(run, ["attention_sm90"]),
                "host_us": host_us(run),
                "plain_ms": cuda_ms(lambda: fa.flash_attention_reference(
                    q, k, v, mask, causal=True), n=10),
                "library_ms": cuda_ms(lib), "library_kernels": library_kernels(lib),
                **dict(zip(("bound_ms", "bound_by"), bound(
                    2 * (2 * q.numel() + k.numel() + v.numel()),
                    4 * D * H * _causal_pairs(L, lens))))}
        if width != D:     # the host pad of q, k and v, inside ms and device_ms
            case["pad_ms"] = cuda_ms(lambda: [fa.pad_head_dim(x, width) for x in (q, k, v)])
            case["pad_device_ms"] = graph_call_ms(
                lambda: [fa.pad_head_dim(x, width) for x in (q, k, v)])
        # beside a narrower head dim its instance's native twin; beside a
        # 256 one, a D=192 call on the same instance; a sliced one stands
        # beside the model it regroups
        twin = 192 if inst == 256 else 128
        if slices == 1:
            case[f"d{twin}_device_ms"] = _twin_ms(randn, B, L, H, Hkv, lens, False,
                                                  twin)["flash_attention"]
        out["flash_attention"][name] = case
        emit({"phase": f"kernel_head_dims_{name}", "name": "flash_attention", **case})
        del q, k, v
    rows = ("flash_attention_fwd_lse", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    for name, spec in HEAD_DIMS_TRAIN.items():
        B = spec["train_batch"]
        D = 192 if spec["D"] > 128 else 128
        twin = {} if spec["D"] > 256 else _twin_ms(
            randn, B, spec["L"], spec["H"], spec["Hkv"],
            [spec["kv_lens"][b % 2] - 3 * (b // 2) for b in range(B)], True, D)
        for row, cases in zip(rows, _phase_train_kernels(randn, spec, name_library=True)):
            if twin:
                cases["train_micro_batch"][f"d{D}_device_ms"] = twin[row]
            out[row][name] = cases
            emit({"phase": f"kernel_head_dims_{name}", "name": row, **cases})
    for D in HEAD_DIM_TRAIN_WIDTHS:
        fwd, dq, dkv, splits = _train_edge_checks(randn, HEAD_DIM_TRAIN_EDGES, D)
        for row, fig in zip(rows, (
                {"max_abs_err": fwd[0], "max_row_ratio": fwd[1], "lse_max_abs_err": fwd[2]},
                {"max_rel_err": dq[0], "max_row_ratio": dq[1]},
                {"max_rel_err": dkv[0], "max_row_ratio": dkv[1], "split_tiles": splits})):
            out[row][f"edges_D{D}"] = fig
    out["flash_attention"]["instance_cases"] = _head_dim_instance_check()
    out["flash_attention_segmented"]["model_path"] = (
        "none above 128: no ViT of the supported families has a wider head dim, so the "
        "wider instances and the sliced kernel are launched and checked here only")
    torch.cuda.empty_cache()
    return out



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
                  buckets=(2048, 2560), max_new=64, decode_chunk=16, engine_extra=None,
                  mesh=None, keep=None):
    """Stage-1 requests through the port's user-facing path:
    TorchDecodeStrategy.initialize (which quantizes the served tree under
    `engine_extra`'s strategy knobs; tensor-parallel over `mesh`, a device
    list, when given) → collator → batch_image_embeds (ViT, on the
    strategy's tree) → the strategy's server (ADD ×n, then ALIVE_CHECK and
    STOP). Returns (outputs, engine, stats); `keep`, a dict, receives the
    requests and the served tree."""
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
            **({"device": dev} if mesh is None else {}), **(engine_extra or {})}, mesh=mesh)
        _sync(dev)
        t_vit = time.perf_counter()
        embeds = batch_image_embeds(config, strategy.param_store.get("rollout"), batch,
                                    image_config=img_cfg)
        _sync(dev)
        vit_ms = (time.perf_counter() - t_vit) * 1e3 / n_tiles
        sp = SamplingParams(temperature=0.0, do_sample=False, max_new_tokens=max_new)
        requests = [{"prompt_ids": ids[i][attn[i] == 1].tolist(), "sampling": sp,
                     "image_embeds": embeds[i], "position_ids": pos[i][:, attn[i] == 1]}
                    for i in range(n_tiles)]
        outs, gen_s, alive = _serve(strategy, requests, dev)
    if keep is not None:
        keep.update(requests=requests, tree=strategy.param_store.get("rollout"))
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
             "kv_cache_gb": sum(c.nbytes for caches in engine.cache_dicts()
                                for c in caches.values()) / 2**30}
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


def _f32(tree):
    """An f32 copy of a tree's floating leaves (others shared)."""
    return {k: _f32(v) if isinstance(v, dict) else v.float() if v.is_floating_point() else v
            for k, v in tree.items()}


# train_parity bounds, kernels against dense attention in bf16. The two
# paths round attention differently (the kernel rounds unnormalised p to
# bf16, dense rounds the normalised probabilities; both round the output), a
# ~2^-9 relative difference per element that reaches the logits through two
# layers and the head.
PARITY_LOSS_TOL = 1e-3      # max-abs on the PPO loss (terms of size ~1)
PARITY_NORM_TOL = 2e-2      # relative, on the pre-clip grad norm
PARITY_LP_TOL = 0.1         # max-abs on a response token's log-prob (~ -9)
PARITY_LP_MEAN_TOL = 1e-2   # mean-abs over the response tokens
# logprobs_at_init's bounds, which train_family raises past, set from the
# readings on an H100 of every caller (Falcon3-7B's rows at head dims 256,
# 512 and 384, Qwen3-30B-A3B, Qwen2.5-0.5B, the Danube rows):
LOGPROB_WINDOW_EXCESS_TOL = 5e-3   # the worst 256-token window; read <= 0.0025
LOGPROB_KERNELS_DENSE_TOL = 0.2    # max-abs; read <= 0.094 (Qwen3-30B-A3B)
LOGPROB_F32_RATIO_TOL = 1.25       # mean-abs from f32, kernels / dense; read within 10%


PARITY_LENS = (2304, 2080, 1000, 600)   # valid tokens a row; L is the first


def parity_batch(config, params, dev, lens=PARITY_LENS, seed=9, L=None, response=256):
    """A GRPO batch of random tokens as device tensors: rows of `lens` valid
    tokens right-padded to L (default lens[0]), the last `response` of each
    the response, old log-probs from a log-prob step on `params`, reference
    log-probs and advantages drawn around them."""
    import torch
    from socioreasoner_tpu_torch.distributed import trainer as T
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens)
    B, L = len(lens), int(lens[0] if L is None else L)
    cols = np.arange(L)[None]
    attn = (cols < lens[:, None]).astype(np.int64)
    ids = np.where(attn == 1, rng.integers(2, config.text.vocab_size - 8, (B, L)), 0)
    resp = ((cols >= lens[:, None] - response) & (attn == 1)).astype(np.int64)
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
    vit = run_vit_grad_check(_vit_parity_config(), dev)
    emit({"phase": "train_parity_vit", **vit})
    torch.cuda.empty_cache()


def _named_leaves(tree, prefix=""):
    """(name, tensor) of every leaf of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _vit_parity_config():
    """_short_3b_config with the Qwen2.5-VL-3B ViT (hidden 1280, 16 heads x
    80, window 112) cut to 4 blocks, the last a full-attention layer."""
    import dataclasses
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import VisionConfig
    return dataclasses.replace(_short_3b_config(), vision=VisionConfig(
        depth=4, fullatt_block_indexes=(3,)))


def run_vit_grad_check(config, dev, *, tile_px=448, text_tokens=128, seed=9):
    """The ViT trained through the model call (vision_inputs), as full ViT
    finetuning runs it: one tile of tile_px² in row 0 of a GRPO batch of two
    rows, one train step in bf16 (the trainer's kernels in the decoder) and
    one in f32 (dense decoder attention) from the same weights, each with an
    optimizer that keeps the step's gradients. Every block's qkv_w gradient
    in bf16 must be there and not zero, and every ViT leaf's gradient norm
    within PARITY_NORM_TOL of f32's; on the GPU, the segmented kernel's
    wrapper must refuse a q that requires grad. Returns the figures; raises
    on a failed check."""
    import torch
    from PIL import Image
    from socioreasoner_tpu_torch.datasets.processor import (ImageProcessorConfig,
                                                             process_images)
    from socioreasoner_tpu_torch.distributed import trainer as T
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    from socioreasoner_tpu_torch.models.qwen2_5_vl.vision import vision_host_inputs
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    from socioreasoner_tpu_torch.pipeline.losses import PPOLossConfig

    class KeepGrads(T.Optimizer):
        def __init__(self):
            super().__init__(schedule=lambda count: 0.0)

        def init(self, params):
            return {}

        def update(self, grads, state, params):
            state["grads"] = list(grads)

    rng = np.random.default_rng(seed)
    pix = process_images(
        [Image.fromarray(rng.integers(0, 255, (tile_px, tile_px, 3), dtype=np.uint8))],
        ImageProcessorConfig(min_pixels=tile_px * tile_px, max_pixels=tile_px * tile_px))
    host = vision_host_inputs(config.vision, pix["pixel_values"], pix["image_grid_thw"])
    n_img = len(host["inv_perm"])
    L = 1 + n_img + text_tokens
    lens = np.array([L, L - 40])
    cols = np.arange(L)[None]
    attn = (cols < lens[:, None]).astype(np.int64)
    ids = np.where(attn == 1, rng.integers(2, config.text.vocab_size - 8, (2, L)), 0)
    ids[0, 1:1 + n_img] = config.image_token_id
    pos = np.broadcast_to(np.clip(np.cumsum(attn, -1) - 1, 0, None)[:, None], (2, 3, L))
    resp = ((cols >= lens[:, None] - 64) & (attn == 1)).astype(np.int64)
    base = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev) for k, v in {
        "input_ids": ids, "attention_mask": attn, "position_ids": pos,
        "response_mask": resp}.items()}
    mask = base["response_mask"][:, 1:].float()
    noise = [torch.as_tensor(rng.normal(size=(2, L - 1)), dtype=torch.float32, device=dev)
             for _ in range(2)]
    params = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(seed),
                                dtype=torch.bfloat16, device=dev)
    names = [name for name, _ in _named_leaves(params["vision"], "vision/")]
    results = {}
    for dtype, flash in ((torch.bfloat16, True), (torch.float32, False)):
        tree = _clone(params) if dtype == torch.bfloat16 else _float_tree(params)
        vi = {k: torch.as_tensor(host[k], device=dev) for k in (
            "cos", "sin", "window_seg", "full_seg", "inv_perm")}
        vi["patches"] = torch.as_tensor(host["patches"], device=dev).to(dtype)
        vi["is_full_layer"] = host["is_full_layer"]
        batch = dict(base, vision_inputs=vi)
        old = T.make_logprob_step(config, allow_flash=flash)(tree, batch)["log_probs"]
        batch.update(old_log_probs=old, ref_log_probs=old + 0.1 * mask * noise[0],
                     advantages=mask * noise[1])
        opt = KeepGrads()
        state = T.TrainState.create(tree, opt)
        state, metrics = T.make_train_step(config, PPOLossConfig(), opt,
                                           allow_flash=flash)(state, batch)
        leaves = T.tree_leaves(state.params)
        grads = dict(zip((id(t) for t in leaves), state.opt_state["grads"]))
        vit = {name: grads[id(t)] for name, t in _named_leaves(state.params["vision"],
                                                                "vision/")}
        results[dtype] = (metrics["actor_train/loss"].item(), vit)
        del state, tree
    loss_b, g_b = results[torch.bfloat16]
    loss_f, g_f = results[torch.float32]
    missing = [k for k in names if g_b[k] is None or g_f[k] is None]
    if missing:
        raise AssertionError(f"ViT leaves without a gradient: {missing}")
    qkv = g_b["vision/blocks/qkv_w"].float().abs().flatten(1).amax(1)
    norms = {k: (g_b[k].float().norm().item(), g_f[k].float().norm().item()) for k in names}
    rel = {k: abs(b - f) / f for k, (b, f) in norms.items() if f > 0}
    refused = None
    if dev.type == "cuda":
        S = 256
        q, k, v = (torch.randn(S, 16, 80, device=dev).to(torch.bfloat16) for _ in range(3))
        before = fa.flash_attention_segmented.launches
        try:
            fa.flash_attention_segmented(q.requires_grad_(), k, v,
                                         torch.zeros(S, dtype=torch.int32))
        except RuntimeError:
            refused = fa.flash_attention_segmented.launches == before
        else:
            refused = False
    out = {"shape": f"one {tile_px}² tile, {len(host['patches'])} patches ({n_img} merged "
                    f"rows) in row 0 of B=2 L={L}; ViT 1280 x 16 heads x 80, "
                    f"{config.vision.depth} blocks (full-attention {list(config.vision.fullatt_block_indexes)}); "
                    "2 text layers at 3B widths, vocab 8192",
           "loss_bf16": loss_b, "loss_f32": loss_f,
           "qkv_w_grad_max_abs_per_block": qkv.tolist(),
           "vit_grad_norms_bf16_f32": norms, "max_rel_norm_diff": max(rel.values()),
           "bound_rel_norm": PARITY_NORM_TOL, "kernel_refused_grad": refused}
    if not (bool((qkv > 0).all()) and len(rel) == len(names)
            and max(rel.values()) <= PARITY_NORM_TOL and refused in (None, True)
            and abs(loss_b - loss_f) <= PARITY_LOSS_TOL):
        raise AssertionError(f"the ViT's gradient through the model call: {out}")
    return out


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
                    tile_px=768, img_cfg=None, prompt_length=4096, dp_size=None,
                    devices=None, greedy=False, **cuts):
    """SocioSegInferPipeline over n synthetic tiles, built as the entry
    script builds it (default_engine_kwargs of the config); `dp_size` sets
    actor_infer's decode replicas over `devices` (the pipeline's device
    list), `greedy` its temperature to 0."""
    from socioreasoner_tpu_torch.datasets.processor import ImageProcessorConfig
    from socioreasoner_tpu_torch.datasets.socioseg import encode_sample
    from socioreasoner_tpu_torch.pipeline.rlvr.build import default_engine_kwargs
    from socioreasoner_tpu_torch.pipeline.rlvr.socioseg_infer_pipeline import (
        SocioSegInferPipeline)

    img_cfg = img_cfg or ImageProcessorConfig(defer_patchify=True)
    cfg = socioseg_infer_config(out_dir, prompt_length=prompt_length,
                                **{**TWO_STAGE_CUTS, **cuts})
    if dp_size is not None:
        cfg.actor_infer.strategy_args.strategy_config["dp_size"] = dp_size
    if greedy:
        cfg.actor_infer.generating_args.temperature = 0.0
    dataset = [encode_sample(t, img_cfg) for t in _synthetic_tiles(n_tiles, tile_px)]
    return SocioSegInferPipeline(
        cfg, model_config=config, policy_params=params, sam_config=sam_config,
        sam_params=sam_params, processor=_processor(config, img_cfg), dataset=dataset,
        engine_kwargs=default_engine_kwargs(cfg), devices=devices)


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


def profile_decode_chunk(engine, dev, prompt_len, seed: int = 0):
    """The engine's decode at its full slot count: one request a slot of
    prompt_len random text tokens (or prompt_len[i] in slot i; decode reads
    no image), admitted with the first chunk; then a chunk timed between
    syncs, and one under torch.profiler read through utils/profiling: its
    device time a step, the device's busy share of the chunk's wall (device
    time over wall; streams do not overlap in decode) and the kernels that
    take most of it. Returns stats."""
    from socioreasoner_tpu_torch.generation.engine import Request
    from socioreasoner_tpu_torch.generation.sampling import SamplingParams
    from socioreasoner_tpu_torch.utils.profiling import busy_us

    c = engine.config
    rng = np.random.default_rng(seed)
    # the first token comes from the prefill: three whole chunks follow it
    sp = SamplingParams(temperature=1.0, top_p=0.8, max_new_tokens=3 * engine.decode_chunk + 1)
    # random text ids below the special ids (a test config's eos may be 1)
    top = min(t for t in (c.image_token_id, c.eos_token_id, 10000) if t > 10)
    lens = prompt_len if isinstance(prompt_len, (list, tuple)) else [prompt_len] * engine.S
    engine.waiting.extend(Request(("decode_profile", i), rng.integers(10, top, n).tolist(), sp)
                          for i, n in enumerate(lens))
    engine.step()

    def chunk():
        steps = engine.steps_executed
        ms = wall_ms(engine.step, dev, reps=1)
        return ms, engine.steps_executed - steps

    ms, steps = chunk()
    (_, prof_steps), prof_ms, rows = profiled(chunk)
    while engine.has_work():
        engine.step()
    kernels = [r for r in rows if r["plane"].startswith("/device:")]
    device_ms = busy_us(rows) / 1e3
    return {"slots": engine.S, "prompt_len": prompt_len, "chunk_ms": ms, "steps": steps,
            "ms_per_step": ms / steps, "profiled_chunk_ms": prof_ms,
            "profiled_steps": prof_steps, "device_ms_per_step": device_ms / prof_steps,
            "busy_share": device_ms / prof_ms,
            "kernel_launches_per_step": sum(r["count"] for r in kernels) / prof_steps,
            "top_kernels": [{"name": r["name"][:80], "ms_per_step": r["total_us"] / 1e3
                             / prof_steps, "launches_per_step": r["count"] / prof_steps}
                            for r in kernels[:8]]}


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


# ------------------------------------------------------------ multi-device serving

def _free():
    """Collect the dropped engines' reference cycles and return their
    memory to the card."""
    import gc
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _forced_logits(engine, requests, tokens):
    """`requests` through `engine` with each request's `tokens` fed in place
    of the engine's samples (the first from its prefill, the rest one a
    decode step), so the engine's own path (its kernels, weights and cache)
    is teacher-forced along them. Returns, per request, the (len(tokens), V)
    f32 logits that fed each token. Prefix forking is off for the run, so
    every request is prefilled."""
    import torch
    from socioreasoner_tpu_torch.generation import engine as E
    from socioreasoner_tpu_torch.generation.sampling import SamplingParams
    reqs = [E.Request(("forced", i), r["prompt_ids"], SamplingParams(
                temperature=0.0, do_sample=False, max_new_tokens=len(t)),
                image_embeds=r["image_embeds"], position_ids=r["position_ids"])
            for i, (r, t) in enumerate(zip(requests, tokens))]
    rows = [[] for _ in reqs]
    group = []
    prefill_group = engine._prefill_group

    def record_group(g, outputs):
        group[:] = [next(j for j, q in enumerate(reqs) if q is r) for r in g]
        return prefill_group(g, outputs)

    def forced(logits, *_):
        # a prefill's rows follow its group; a decode step's, the slots
        picks = (list(enumerate(group)) if group else
                 [(reqs[j].slot, j) for j in range(len(reqs))
                  if engine.slot_req.get(reqs[j].slot) is reqs[j]])
        group.clear()
        out = torch.full(logits.shape[:1], engine.config.pad_token_id, dtype=torch.long,
                         device=logits.device)
        for row, j in picks:
            n = len(rows[j])
            if n < len(tokens[j]):
                rows[j].append(logits[row].float().cpu())
                out[row] = int(tokens[j][n])
        return out

    fork, sample = engine.prefix_fork, E.sample_tokens
    engine.prefix_fork, engine._prefill_group, E.sample_tokens = False, record_group, forced
    try:
        outs = engine.generate(reqs)
    finally:
        engine.prefix_fork, E.sample_tokens = fork, sample
        del engine._prefill_group
    if [list(o.output_ids) for o in outs] != [list(t) for t in tokens]:
        raise AssertionError("the forced run did not emit the forced tokens")
    return [torch.stack(r).numpy() for r in rows]


def tp_tie_check(ref_engine, tp_engine, requests, ref_outs, tp_outs):
    """The tensor-parallel engine's greedy tokens against the unsharded
    engine's, request by request and token by token. Both engines are
    teacher-forced (_forced_logits) along the unsharded engine's tokens, so
    every step of every request is compared on the same prefix. The shards
    sum o_proj and down_proj as partial products, which round otherwise than
    one matmul: `delta`, the largest difference the sharding makes to a
    logit at a step, must stay within the fixed TP_DELTA_LIMIT,
    and where the tp engine's argmax differs from the unsharded token, both
    must lie within max(GAP_TOL, 2 x delta) of the unsharded top logit (a
    tie flip). The tp engine's own first divergence is held to the same
    rule. Returns (equal requests, tie flips, failures, compared tokens,
    largest delta)."""
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    xs = [list(o.output_ids) for o in ref_outs]
    # the forced runs are comparisons: they leave the path's launch counts
    wrappers = (fa.flash_attention_segmented, fa.flash_attention, da.paged_decode_attention,
                da.paged_decode_attention_int8)
    counts = [w.launches for w in wrappers]
    try:
        ref_rows = _forced_logits(ref_engine, requests, xs)
        tp_rows = _forced_logits(tp_engine, requests, xs)
    finally:
        for w, c in zip(wrappers, counts):
            w.launches = c
    equal, flips, failures, compared, worst = 0, [], [], 0, 0.0
    for r, (x, b, ref, tp) in enumerate(zip(xs, tp_outs, ref_rows, tp_rows)):
        y = list(b.output_ids)
        equal += x == y
        first = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v), None)
        for i, row in enumerate(ref):
            delta = float(np.abs(tp[i] - row).max())
            worst = max(worst, delta)
            compared += 1
            top = float(row.max())
            mine = int(np.argmax(tp[i]))
            cands = {x[i], mine} | ({y[i]} if i == first else set())
            gaps = {t: top - float(row[t]) for t in sorted(cands)}
            bound = max(GAP_TOL, 2 * delta)
            record = {"request": r, "step": i, "gaps": gaps, "delta": delta,
                      "bound": bound, "top": top}
            if delta > TP_DELTA_LIMIT or max(gaps.values()) > bound or gaps[x[i]] > GAP_TOL:
                failures.append(record)
            elif len(cands) > 1:
                flips.append(record)
    return equal, flips, failures, compared, worst


def profile_prefill(engine, dev, prompt_len, seed: int = 1):
    """One prefill of the engine's full slot count (prompt_len random text
    tokens a slot, one new token each, so decode never runs) under
    torch.profiler, read through utils/profiling: its wall ms, device ms
    and busy share."""
    from socioreasoner_tpu_torch.generation.engine import Request
    from socioreasoner_tpu_torch.generation.sampling import SamplingParams
    from socioreasoner_tpu_torch.utils.profiling import busy_us
    c = engine.config
    rng = np.random.default_rng(seed)
    top = min(t for t in (c.image_token_id, c.eos_token_id, 10000) if t > 10)
    sp = SamplingParams(temperature=0.0, do_sample=False, max_new_tokens=1)
    engine.waiting.extend(Request(("prefill_profile", i), rng.integers(10, top, prompt_len)
                                  .tolist(), sp) for i in range(engine.S))
    done, ms, rows = profiled(engine.step)
    if len(done) != engine.S or engine.has_work():
        raise AssertionError("the profiled prefill did not finish every request")
    device_ms = busy_us(rows) / 1e3
    return {"slots": engine.S, "prompt_len": prompt_len, "prefill_ms": ms,
            "device_ms": device_ms, "busy_share": device_ms / ms}


def run_tp_engines(config, params, dev, devices, *, img_cfg=None, tile_px=768, n_tiles=4,
                   buckets=(2048, 2560), max_new=64, decode_chunk=16, profile_len=None):
    """(a) of the parallel phase: the main path's stage-1 requests through
    the unsharded engine and through the tensor-parallel engine over
    `devices`, with bf16 weights, then with int8 single-copy weights and an
    int8 KV cache (PARALLEL_INT8), then with int4 single-copy weights
    (PARALLEL_INT4); the tp tokens held to the unsharded ones under
    tp_tie_check; with `profile_len`, each bf16 and int8 engine's prefill
    and decode at that prompt length profiled. Returns stats."""
    out = {}
    for name, extra in (("bf16", {}), ("int8", PARALLEL_INT8), ("int4", PARALLEL_INT4)):
        kw = dict(img_cfg=img_cfg, tile_px=tile_px, n_tiles=n_tiles, buckets=buckets,
                  max_new=max_new, decode_chunk=decode_chunk, engine_extra=extra)
        keep = {}
        ref_outs, ref_engine, ref_stats = run_main_path(config, params, dev, keep=keep, **kw)
        tp_outs, tp_engine, tp_stats = run_main_path(config, params, dev, mesh=devices, **kw)
        if tp_engine.tp is None or len(tp_engine.tp) != len(devices):
            raise AssertionError(f"{name}: the engine is not tensor-parallel over {devices}")
        equal, flips, failures, compared, delta = tp_tie_check(
            ref_engine, tp_engine, keep["requests"], ref_outs, tp_outs)
        if failures:
            raise AssertionError(f"{name}: tp tokens left the unsharded engine's beyond a "
                                 f"tie: {failures}")
        local = tp_engine.caches[0]["k"].shape
        fig = {"unsharded": {k: ref_stats[k] for k in MAIN_KEYS if k in ref_stats},
               "tp": {k: tp_stats[k] for k in MAIN_KEYS if k in tp_stats},
               "equal_requests": equal, "tie_flips": flips, "compared_tokens": compared,
               "max_logit_delta": delta, "delta_limit": TP_DELTA_LIMIT,
               "tp_shard_cache": list(local), "tp_shard_weights_gb": _tree_bytes(
                   tp_engine.params) / 2**30 / len(devices),
               "prefill_hist": {str(k): v for k, v in tp_engine.prefill_hist.items()},
               "lalloc": tp_engine.Lalloc}
        if profile_len and name != "int4":
            fig["profile"] = {
                "unsharded": {"prefill": profile_prefill(ref_engine, dev, profile_len),
                              "decode": profile_decode_chunk(ref_engine, dev, profile_len)},
                "tp": {"prefill": profile_prefill(tp_engine, dev, profile_len),
                       "decode": profile_decode_chunk(tp_engine, dev, profile_len)}}
        out[name] = fig
        del ref_engine, tp_engine, keep
        _free()
    return out


def _result_files(pipeline):
    """Every file run() wrote under the result directory: {relative path:
    bytes}."""
    import os
    root = pipeline.result_dir
    files = {}
    for dirpath, _, names in os.walk(root):
        for f in names:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                files[os.path.relpath(path, root)] = fh.read()
    return files


def run_dp_pipelines(config, params, sam_config, sam_params, out_dir, dev, devices, *,
                     kernels=(), n_tiles=4, tile_px=768, img_cfg=None, prompt_length=4096,
                     checked=None, **cuts):
    """(b) of the parallel phase: SocioSegInferPipeline.run() with
    actor_infer dp_size 1, then 2 over `devices` (two decode replicas), at
    greedy, each run() timed: every text, mask and iou_acc.txt of the dp = 2
    run equal to the dp = 1 run's; the kernels' launches counted over both
    run() calls; with `checked` (prefill buckets, prefill batch sizes,
    Lalloc), every pass held to those shapes. Returns stats."""
    import os
    runs, files = {}, {}
    counts = {fn.__name__: 0 for fn in kernels}
    for dp in (1, 2):
        pipeline = build_two_stage(config, params, sam_config, sam_params,
                                   os.path.join(out_dir, f"dp{dp}"), n_tiles=n_tiles,
                                   tile_px=tile_px, img_cfg=img_cfg,
                                   prompt_length=prompt_length, dp_size=dp,
                                   devices=devices, greedy=True, **cuts)
        engines = [rep.engine for rep in pipeline.decode_replicas]
        if len(engines) != dp:
            raise AssertionError(f"dp_size={dp} built {len(engines)} replicas")
        for fn in kernels:
            fn.launches = 0
        _sync(dev)
        t0 = time.perf_counter()
        giou_acc = pipeline.run()
        _sync(dev)
        wall = time.perf_counter() - t0
        for fn in kernels:
            counts[fn.__name__] += fn.launches
        written, _ = check_infer_outputs(pipeline)
        if written != giou_acc:
            raise AssertionError(f"iou_acc.txt {written} != giou_acc {giou_acc}")
        served = [e.prefill_rows for e in engines]
        if not all(served):
            raise AssertionError(f"dp_size={dp}: a replica served no prefill: {served}")
        fig = {"tiles_per_s": len(pipeline.dataset) / wall, "run_wall_s": wall,
               "prefill_ms": sum(e.prefill_device_time for e in engines) * 1e3,
               "decode_s": sum(e.decode_time for e in engines),
               "steps_executed": sum(e.steps_executed for e in engines),
               "prefill_buckets": sorted({k[1] for e in engines for k in e.prefill_hist}),
               "prefill_batches": sorted({k[0] for e in engines for k in e.prefill_hist}),
               "cache_lalloc": engines[0].Lalloc, "giou_acc": giou_acc,
               "replica_prefill_rows": served}
        runs[f"dp{dp}"] = fig
        files[dp] = _result_files(pipeline)
        if checked and (fig["prefill_buckets"] != checked[0]
                        or not set(fig["prefill_batches"]) <= set(checked[1])
                        or fig["cache_lalloc"] != checked[2]):
            raise AssertionError(f"dp_size={dp} left the checked shapes: {fig}")
        del pipeline, engines
        _free()
    if files[1].keys() != files[2].keys():
        raise AssertionError(f"dp_size 2 wrote {sorted(files[2])}, dp_size 1 {sorted(files[1])}")
    differ = sorted(k for k in files[1] if files[1][k] != files[2][k])
    if differ:
        raise AssertionError(f"dp_size 2's files differ from dp_size 1's: {differ}")
    return {**runs, "files_equal": len(files[1]), "launches": counts}


def phase_parallel(config, params):
    """Serving over several devices on the one card: (a) the tensor-parallel
    engine, both shards on cuda:0, against the unsharded one, bf16, int8 and
    int4;
    (b) the infer pipeline with two decode replicas on cuda:0 against one;
    (c) the infer yaml's 16 slots a replica, two replicas, allocated beside
    SAM2. Returns the launch counts of kernels 1, 2, 3 and 3q over (a) and
    (b)."""
    import tempfile
    import torch
    from socioreasoner_tpu_torch.models.sam2 import model as smodel
    from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    from socioreasoner_tpu_torch.utils.context_managers import device_memory_stats

    dev = torch.device("cuda")
    devices = [dev] * PARALLEL_TP
    kernels = (fa.flash_attention_segmented, fa.flash_attention, da.paged_decode_attention,
               da.paged_decode_attention_int8)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    engines = run_tp_engines(config, params, dev, devices, max_new=PARALLEL_MAX_NEW,
                             profile_len=PARALLEL_PREFILL["kv_len"])
    launches = {fn.__name__: fn.launches for fn in kernels}
    emit({"phase": "parallel_tp", "model": "Qwen2.5-VL-3B (36 layers, 16/2 x 128 heads, "
          f"vocab 151936), random bf16 weights, tp={PARALLEL_TP} with both shards on "
          "cuda:0: the sharded code, not multi-GPU speed", "wall_s": time.perf_counter() - t0,
          **engines})
    sam_config = Sam2Config.large()
    sam_params = smodel.init_params(sam_config, torch.Generator(device=dev).manual_seed(1),
                                    dtype=torch.bfloat16, device=dev)
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        # held to the two_stage phase's checked shapes
        dp = run_dp_pipelines(config, params, sam_config, sam_params, out_dir, dev,
                              devices, kernels=kernels, checked=(
                                  [2048, TWO_STAGE_PREFILL["L"]],
                                  TWO_STAGE_PREFILL["batches"], TWO_STAGE_LALLOC))
        for k, c in dp["launches"].items():
            launches[k] += c
        emit({"phase": "parallel_dp", "model": "Qwen2.5-VL-3B served as int8 single-copy "
              "weights + SAM2-hiera-large, random bf16 weights, greedy; two decode "
              "replicas on cuda:0", "cuts": TWO_STAGE_CUTS, "wall_s": time.perf_counter() - t0,
              **dp})
        # (c) the infer yaml's own scale: 16 slots of sequence_length 6144 a
        # replica, two replicas, beside SAM2-hiera-large
        t0 = time.perf_counter()
        full = build_two_stage(config, params, sam_config, sam_params, out_dir,
                               dp_size=2, devices=devices, rollout_batch_size=16,
                               response_length=2048, infer_batch_size=16)
        caches = [sum(c.nbytes for c in rep.engine.caches.values()) / 2**30
                  for rep in full.decode_replicas]
        memory = device_memory_stats()
        yaml_scale = {"replicas": len(full.decode_replicas), "slots": full.decode_replicas[0]
                      .engine.S, "lalloc": full.decode_replicas[0].engine.Lalloc,
                      "kv_cache_gb": caches, "build_s": time.perf_counter() - t0,
                      "bytes_in_use_gb": memory["device0/bytes_in_use"] / 2**30}
        del full
        _free()
    peak = device_memory_stats()["device0/peak_bytes_in_use"]
    emit({"phase": "parallel", "launches": launches, "yaml_scale": yaml_scale,
          "peak_gb": peak / 2**30, "peak_gib_limit": 80})
    missing = [k for k, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in the parallel phase: {missing}")
    if peak >= 80e9:
        raise AssertionError(f"parallel phase peak {peak / 1e9:.1f} GB")
    return launches


# ------------------------------------------------------------ GRPO pipeline

# examples/train/rlvr_tpu.yaml:73-79, set in code: the decode strategy's knobs
TRAIN_STRATEGY = {"kv_quant": None, "weight_quant": "int8", "single_copy_quant": True,
                  "act_quant": None, "prefix_fork": True}
# the grpo phase's cuts of the yaml's scale (rollout_batch_size 128,
# response_length 2048, steps from 10 epochs, eval and save every 20 steps):
# one step and its validation through the real engine (pass 2 runs a second
# step after it)
GRPO_CUTS = {"rollout_batch_size": 2, "response_length": 64, "max_steps": 1, "eval_steps": 1}
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
                   "max_steps": "10 epochs -> 1", "eval_steps": "20 -> 1",
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


# ------------------------------------------------------------- generic RLVR

# the rlvr phase's cuts: RLVRPipeline for 1 step of 4 prompts x 8 samples at
# response_length 256, the dynamic sampler with its flow-control knobs and a
# query filter that rejects the first finished group; MathVLMPipeline for one
# step of 2 prompts x 4 samples at response_length 128, one 768² image each
RLVR_CUTS = {"max_steps": 1, "rollout_batch_size": 4, "num_return_sequences_in_group": 8,
             "prompt_length": 256, "response_length": 256, "is_use_additional_prompts": True,
             "max_running_requests": 32, "max_additional_running_prompts": 2}
MATH_VLM_CUTS = {"max_steps": 1, "rollout_batch_size": 2, "num_return_sequences_in_group": 4,
                 "prompt_length": 1024, "response_length": 128}
RLVR_TIMERS = ("step", "generate", "logprobs", "train")
MATH_PROMPT = "What is {a} + {b}? Think it through, then give the sum in <answer> </answer> tags."
MATH_PROMPT_RE = re.compile(r"What is (\d+) \+ (\d+)\?")


def write_math_jsonl(path, n=24, seed=0):
    """n math prompts, each with a tag and a ground truth, as a jsonl file."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            a, b = (int(x) for x in rng.integers(1, 10 ** rng.integers(1, 5), size=2))
            f.write(json.dumps({"prompt": MATH_PROMPT.format(a=a, b=b),
                                "ground_truth": str(a + b), "tag": "math"}) + "\n")


def rlvr_config(out_dir: str, **cuts):
    """RLVRConfig with the train yaml's optimisation settings (lr 1e-6,
    weight decay 1e-2, the k3 KL loss at 5e-3, reward and advantage clip 10,
    sampling at temperature 0.99, top_p 0.99, top_k 100) at the given cuts,
    log-prob chunks of 8, tracked to stdout, no checkpoints."""
    from socioreasoner_tpu_torch.configs.rlvr_config import RLVRConfig
    cfg = RLVRConfig(exp_name="qwen2_5_vl_3B_rlvr_math", seed=42, output_dir=out_dir,
                     track_with="stdout", save_steps=-1, adv_estimator="grpo",
                     use_kl_loss=True, kl_loss_coef=5e-3, reward_clip=10, advantage_clip=10.0,
                     init_kl_coef=0.0, **cuts)
    ta = cfg.actor_train.training_args
    ta.learning_rate, ta.weight_decay, ta.warmup_steps = 1e-6, 1e-2, 0
    cfg.actor_train.infer_batch_size = cfg.reference.infer_batch_size = 8
    ga = cfg.actor_infer.generating_args
    ga.max_new_tokens, ga.top_p, ga.top_k, ga.temperature = cfg.response_length, 0.99, 100, 0.99
    ga.num_return_sequences = cfg.num_return_sequences_in_group
    return cfg


def rlvr_engine_kwargs(cfg, slots: int, prompt_bucket: int):
    return {"max_slots": slots, "max_len": cfg.sequence_length, "decode_chunk": 64,
            "prefill_buckets": (prompt_bucket,),
            "image_buckets": (0, 512, 1024, 2048, 4096, 8192, 16384)}


class MathAnswerWorker:
    """A decode worker that answers each request of the dynamic sampler at
    once: sample j of a "What is a + b?" prompt with the right sum in
    <answer> tags for even j and a wrong one for odd j."""

    def __init__(self, tokenizer):
        self.tok = tokenizer

    def answer(self, prompt_ids, j):
        a, b = (int(x) for x in MATH_PROMPT_RE.search(
            self.tok.decode(list(map(int, prompt_ids)))).groups())
        text = (f"<think>sample {j}</think><answer>{a + b}</answer>" if j % 2 == 0
                else f"<think>sample {j}</think><answer>{a + b + j}</answer>")
        return list(self.tok.encode(text))

    def start_server(self, data=None):
        pass

    def stop_server(self):
        pass

    def add_request(self, command, data):
        from types import SimpleNamespace
        if command.name != "ADD":
            return {"alive": True}
        rid = data["request_id"]
        data["callback"](SimpleNamespace(request_id=rid, finish_reason="stop",
                                         output_ids=self.answer(data["prompt_ids"], rid[1])))


def _shape_recorder(pipe):
    """Wrap the pipeline's train and log-prob steps to record their (B, L),
    and the tokens and response tokens of the train batches."""
    shapes = {"train": set(), "logprob": set(), "train_tokens": [], "response_tokens": []}

    def record(kind, step_fn):
        def wrapped(*args):
            batch = args[-1]
            shapes[kind].add(tuple(batch["input_ids"].shape))
            if kind == "train":
                shapes["train_tokens"].append(int(batch["attention_mask"].sum()))
                shapes["response_tokens"].append(int((batch["response_mask"] > 0).sum()))
            return step_fn(*args)
        return wrapped
    actor, reference = pipe.actor_train, pipe.reference
    actor._train_step = record("train", actor._train_step)
    actor._logprob_step = record("logprob", actor._logprob_step)
    reference._logprob_step = record("logprob", reference._logprob_step)
    return shapes


def _first_reference_log_probs(pipe):
    """Record the reference's first log-prob batch and its output: [batch,
    log_probs], filled by the pipeline's first call."""
    seen = []
    plain = pipe.reference.compute_log_probs

    def compute_log_probs(batch):
        out = plain(batch)
        if not seen:
            seen.extend([batch, out["log_probs"]])
        return out
    pipe.reference.compute_log_probs = compute_log_probs
    return seen


def _rlvr_figures(pipe, history, shapes, launches, wall):
    engine = pipe.actor_infer.engine
    return {
        "wall_s": wall, "steps": len(history),
        "timers_s": [{k: h.get(f"time/{k}") for k in RLVR_TIMERS} for h in history],
        "actor_infer_tps": [h.get("system/actor_infer/tps") for h in history],
        "actor_train_tps": [h.get("system/actor_train/tps") for h in history],
        "prefill_buckets": sorted({(key[0], key[1]) for key in engine.prefill_hist}),
        "prefill_rows": engine.prefill_rows, "forked_requests": engine.forked_requests,
        "engine_steps": engine.steps_executed,
        "cache_slots": engine.S, "cache_lalloc": engine.Lalloc,
        "train_shapes": sorted(shapes["train"]), "logprob_shapes": sorted(shapes["logprob"]),
        "launches": launches}


def _left_shapes(fig, prefill, slots, lalloc, train):
    """What of a pass left the shapes the kernels phase checked."""
    return ([b for b in fig["prefill_buckets"] if tuple(b) not in prefill]
            + ([] if (fig["cache_slots"], fig["cache_lalloc"]) == (slots, lalloc)
               or not fig["prefill_buckets"] else ["cache"])
            + [s for s in fig["train_shapes"] if s != (train["train_batch"], train["L"])]
            + [s for s in fig["logprob_shapes"] if s != (train["logprob_batch"], train["L"])])


def run_rlvr_path(config, params, out_dir, dev, *, kernels=(), processor=None, **cuts):
    """RLVRPipeline.run() through the port's entry points on a jsonl of math
    prompts read with datasets.loader.get_dataset, the dynamic sampler on.
    Pass 1, the real engine, RLVR_CUTS' steps with a query filter that
    rejects the first finished group. Pass 2, one more step with the decode
    group replaced by MathAnswerWorker (half of each group right): the
    scheduler's rewards equal compute_math_rewards recomputed on the
    pipeline's texts, critic/score_mean 0.5, the actor's log-probs moved.
    The reference's log-probs never move. `kernels`' launch counts are set
    to 0 before each pass and read after it. Returns stats; raises on a
    failed check."""
    import os
    from socioreasoner_tpu_torch.configs.worker_config import DataArguments
    from socioreasoner_tpu_torch.datasets.loader import get_dataset
    from socioreasoner_tpu_torch.pipeline.rlvr.rewards.math_rule import compute_math_rewards
    from socioreasoner_tpu_torch.pipeline.rlvr.rlvr_pipeline import RLVRPipeline
    from socioreasoner_tpu_torch.runtime.generate_scheduler import LocalGenerateGroup

    cfg = rlvr_config(out_dir, **{**RLVR_CUTS, **cuts})
    path = os.path.join(out_dir, "math.jsonl")
    write_math_jsonl(path)
    dataset = get_dataset(DataArguments(file_name=path))
    finished = []

    def query_filter(row, outputs):
        """Reject the first finished group; a replacement is pulled."""
        finished.append(row["prompt"])
        return len(finished) > 1

    processor = processor or _processor(config, None)
    pipe = RLVRPipeline(cfg, model_config=config, policy_params=params,
                        reference_params={k: v for k, v in params.items() if k != "vision"},
                        processor=processor, dataset=dataset, query_filter=query_filter,
                        engine_kwargs=rlvr_engine_kwargs(cfg, RLVR_SLOTS, cfg.prompt_length))
    shapes = _shape_recorder(pipe)
    ref_seen = _first_reference_log_probs(pipe)
    seen = {"batches": [], "texts": []}
    get_batch, decode = pipe.sampler.get_batch, pipe._decode

    def recording_get_batch(*args):
        batch = get_batch(*args)
        seen["batches"].append((dict(batch.meta), list(batch.non_tensor["ground_truth"])))
        return batch

    def recording_decode(post):
        seen["texts"].append(decode(post))
        return seen["texts"][-1]

    pipe.sampler.get_batch, pipe._decode = recording_get_batch, recording_decode

    # ---- pass 1: the real engine
    for fn in kernels:
        fn.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    metrics = pipe.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    history = list(pipe.state.log_history)
    pass1 = _rlvr_figures(pipe, history, shapes,
                          {fn.__name__: fn.launches for fn in kernels}, wall)
    first = history[0]
    pass1.update(
        scheduler=[{k: h[k] for k in h if k.startswith("scheduler/")} for h in history],
        metrics={k: metrics[k] for k in ("actor_train/total_loss", "actor_train/grad_norm",
                                         "critic/kl", "critic/reward_mean",
                                         "critic/score_mean")},
        engine_idle=not pipe.actor_infer.engine.has_work(), rejected_first=finished[:1])
    bad = sorted(k for h in history for k, v in h.items()
                 if isinstance(v, float) and not np.isfinite(v))
    if (pipe.state.step != cfg.max_steps or bad or not pass1["engine_idle"]
            or first["scheduler/query_filter_count"] < 1
            or first["scheduler/prompt_use_count"] < cfg.rollout_batch_size + 1):
        raise AssertionError(f"rlvr pass 1: step {pipe.state.step} of {cfg.max_steps}, "
                             f"not finite {bad}, {pass1}")
    batch0, ref0 = ref_seen
    actor0 = pipe.actor_train.compute_log_probs(batch0)["log_probs"]

    # ---- pass 2: crafted answers, half of each group right
    worker = MathAnswerWorker(pipe.processor.tokenizer)
    saved = pipe.sampler.cluster
    pipe.sampler.cluster = LocalGenerateGroup([worker])
    cfg.max_steps = pipe.state.step + 1
    for fn in kernels:
        fn.launches = 0
    try:
        metrics2 = pipe.run()
    finally:
        pipe.sampler.cluster = saved
    launches2 = {fn.__name__: fn.launches for fn in kernels}
    (meta, gts), texts = seen["batches"][-1], seen["texts"][-1]
    n = cfg.num_return_sequences
    want = compute_math_rewards(texts, [g for g in gts for _ in range(n)])
    recomputed = (np.array_equal(meta["response_level_rewards"], want["response_level_rewards"])
                  and np.array_equal(meta["scores"], want["scores"]))
    actor1 = pipe.actor_train.compute_log_probs(batch0)["log_probs"]
    mask = np.asarray(batch0.batch["response_mask"])[:, 1:] == 1
    pass2 = {
        "step_wall_s": pipe.state.log_history[-1]["time/step"],
        "rewards": meta["response_level_rewards"].tolist(), "recomputed_equal": recomputed,
        "metrics": {k: metrics2[k] for k in ("actor_train/total_loss", "actor_train/grad_norm",
                                             "critic/kl", "critic/reward_mean",
                                             "critic/score_mean")},
        "train_shapes": sorted(shapes["train"]), "logprob_shapes": sorted(shapes["logprob"]),
        "actor_logprob_max_abs_move": float(np.abs(actor1 - actor0)[mask].max()),
        "reference_logprobs_unchanged": np.array_equal(
            pipe.reference.compute_log_probs(batch0)["log_probs"], ref0),
        "launches": launches2}
    if not (recomputed and pass2["metrics"]["critic/score_mean"] == 0.5
            and pass2["actor_logprob_max_abs_move"] > 0
            and pass2["reference_logprobs_unchanged"]
            and np.isfinite(list(pass2["metrics"].values())).all()):
        raise AssertionError(f"rlvr pass 2 (crafted answers): {pass2}")
    return {"prompts_per_step": cfg.rollout_batch_size, "samples_per_step":
            cfg.rollout_batch_size * n, "pass1": pass1, "pass2": pass2}


MATH_VLM_QUESTION = "How many buildings are in this image? Count them one by one."


def run_math_vlm_path(config, params, out_dir, dev, *, kernels=(), tile_px=768,
                      img_cfg=None, processor=None, **cuts):
    """MathVLMPipeline.run() for MATH_VLM_CUTS' step: 2 prompts, each one
    synthetic tile_px² image and a counting question, 4 samples each through
    the real engine, the image embeddings from the rollout tree's ViT on the
    device through the log-prob and train steps, a frozen reference.
    Random weights answer nothing right, so the advantages and the gradient
    are 0 (the train step runs all the same). `kernels`' launch counts are
    set to 0 just before and read just after. Returns stats; raises on a
    failed check."""
    from PIL import Image
    from socioreasoner_tpu_torch.datasets.processor import ImageProcessorConfig
    from socioreasoner_tpu_torch.pipeline.rlvr.math_vlm_pipeline import MathVLMPipeline

    cfg = rlvr_config(out_dir, **{**MATH_VLM_CUTS, **cuts})
    img_cfg = img_cfg or ImageProcessorConfig(defer_patchify=True)
    rng = np.random.default_rng(3)
    rows = [{"question": MATH_VLM_QUESTION, "ground_truth": str(3 + i),
             "images": [Image.fromarray(rng.integers(0, 255, (tile_px, tile_px, 3),
                                                     dtype=np.uint8))]}
            for i in range(cfg.rollout_batch_size)]
    pipe = MathVLMPipeline(cfg, model_config=config, policy_params=params,
                           reference_params={k: v for k, v in params.items() if k != "vision"},
                           processor=processor or _processor(config, img_cfg), dataset=rows,
                           engine_kwargs=rlvr_engine_kwargs(cfg, MATH_VLM_SLOTS,
                                                            cfg.prompt_length))
    shapes = _shape_recorder(pipe)
    ref_seen = _first_reference_log_probs(pipe)
    for fn in kernels:
        fn.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    metrics = pipe.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    history = list(pipe.state.log_history)
    fig = _rlvr_figures(pipe, history, shapes, {fn.__name__: fn.launches for fn in kernels},
                        wall)
    fig["metrics"] = {k: metrics[k] for k in ("actor_train/total_loss", "actor_train/grad_norm",
                                              "critic/kl", "critic/math/accuracy")}
    # the pipeline records no throughput (nor does the JAX one): tokens of
    # the train batch over the generate and train timers
    fig["actor_infer_tps"] = [shapes["response_tokens"][0] / history[0]["time/generate"]]
    fig["actor_train_tps"] = [shapes["train_tokens"][0] / history[0]["time/train"]]
    batch0, ref0 = ref_seen
    fig["reference_logprobs_unchanged"] = np.array_equal(
        pipe.reference.compute_log_probs(batch0)["log_probs"], ref0)
    if not (pipe.state.step == cfg.max_steps
            and fig["reference_logprobs_unchanged"]
            and np.isfinite(list(fig["metrics"].values())).all()):
        raise AssertionError(f"math_vlm step: {fig}")
    return fig


def phase_rlvr(config, params):
    """The generic RLVR slice at full width on the main phase's Qwen2.5-VL-3B
    tree (trained in place; a copy without the ViT as each reference):
    RLVRPipeline with the dynamic sampler, text only (run_rlvr_path: kernels
    2-6 must launch in pass 1 and 4-6 in pass 2), then MathVLMPipeline
    (run_math_vlm_path: kernels 1-6, kernel 1 32 times a tile), each pass at
    the shapes the kernels phase checked. Peak memory < 80 GB. Returns the
    launch counts over the phase."""
    import gc
    import tempfile
    import torch
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    kernels = (fa.flash_attention_segmented, fa.flash_attention, da.paged_decode_attention,
               *_train_kernel_fns())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        rlvr = run_rlvr_path(config, params, out_dir, dev, kernels=kernels)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        vlm = run_math_vlm_path(config, params, out_dir, dev, kernels=kernels)
    phase_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    p1, p2 = rlvr["pass1"], rlvr["pass2"]
    emit({"phase": "rlvr", "card": _smi_line(),
          "model": "Qwen2.5-VL-3B (36 layers, ViT depth 32) trained in bf16, random weights",
          "cuts": {"rlvr": RLVR_CUTS, "math_vlm": MATH_VLM_CUTS},
          "phase_s": phase_s, "max_memory_allocated_gb": peak, "rlvr": rlvr, "math_vlm": vlm})
    emit({"phase": "rlvr_figures", "card": _smi_line(), "max_memory_allocated_gb": peak,
          **{name: {"step_wall_s": [t["step"] for t in fig["timers_s"]],
                    "timers_s": fig["timers_s"], "actor_infer_tps": fig["actor_infer_tps"],
                    "actor_train_tps": fig["actor_train_tps"]}
             for name, fig in (("rlvr", p1), ("math_vlm", vlm))}})
    names = [k.__name__ for k in kernels]
    missing = ([k for k in names[1:] if p1["launches"][k] <= 0]
               + [k for k in names[3:] if p2["launches"][k] <= 0]
               + [k for k in names if vlm["launches"][k] <= 0])
    if missing or vlm["launches"][names[0]] != 32 * MATH_VLM_CUTS["rollout_batch_size"]:
        raise AssertionError(f"kernels off the rlvr path: {missing}, kernel 1 launched "
                             f"{vlm['launches'][names[0]]} times in math_vlm")
    left = (_left_shapes(p1, RLVR_PREFILL, RLVR_SLOTS, RLVR_LALLOC, RLVR_TRAIN)
            + _left_shapes(dict(p2, prefill_buckets=[], cache_slots=None, cache_lalloc=None),
                           RLVR_PREFILL, RLVR_SLOTS, RLVR_LALLOC, RLVR_TRAIN)
            + _left_shapes(vlm, MATH_VLM_PREFILL, MATH_VLM_SLOTS, MATH_VLM_LALLOC,
                           MATH_VLM_TRAIN))
    if left:
        raise AssertionError(f"the rlvr phase left the checked shapes: {left}")
    if not peak < 80:
        raise AssertionError(f"the rlvr phase peaked at {peak} GiB")
    return {k: p1["launches"][k] + p2["launches"][k] + vlm["launches"][k] for k in names}


# ------------------------------------------------------------- workers

# The workers phase: the worker runtime, every reward, the reward model, the
# critic, SFT and DPO on the main phase's tree. RLVRPipeline over a jsonl of
# 24 prompts, 6 a domain, scored by the four reward clusters a yaml names
# (the JAX package's dotted paths): one step of 4 prompts x 8 samples at 256
# new tokens on the plain collate-and-generate route, then one step of
# crafted answers; the same RLVR_* shapes as the rlvr phase.
WORKERS_CUTS = {"max_steps": 1, "rollout_batch_size": 4, "num_return_sequences_in_group": 8,
                "prompt_length": 256, "response_length": 256}
WORKER_CLUSTERS = {"math": ("MathRuleRewardWorker", 2), "code": ("CodeSandboxRewardWorker", 2),
                   "crossthinkqa": ("CrossThinkQARewardWorker", 1),
                   "general": ("GeneralValRuleRewardWorker", 1)}
WORKERS_TIMERS = ("step", "generate", "logprobs", "train")
CODE_PROMPT = ("Write a Python program that defines times(n), returning n * {k}, and prints "
               "times(n) for each integer n read from stdin. Answer in a ```python block.")
MCQ = (("a primary color", ("green", "red", "purple", "orange"), "B"),
       ("a mammal", ("whale", "shark", "trout", "eel"), "A"),
       ("a prime number", ("9", "15", "21", "7"), "D"))
CAPITALS = (("France", "Paris"), ("Japan", "Tokyo"), ("Italy", "Rome"), ("Peru", "Lima"))
JUDGE_NEW_TOKENS = 32
# the reward model's bf16 values against an f32 forward of the same rows:
# max-abs over the valid positions, relative to the f32 values' max-abs
# (bf16 rounding through 36 random layers, ~2^-8 a layer, partly cancelling)
RM_VALUE_TOL = 0.05
# the critic, SFT and DPO steps: AdamW at the train yaml's learning rate,
# each on its own copy (at 1e-5 Adam's first step, a step of lr on nearly
# every element of the 3B tree, overshoots: the critic's value loss rose
# 0.437 → 0.628 on the same rows)
STEP_LR = 1e-6
SFT_SPEC = {"samples": 16, "min_len": 200, "max_len": 1800, "row": 2048, "micro": 2}
DPO_SPEC = {"pairs": 4, "L": 512, "prompt": 128, "beta": 0.1}
DPO_LOSS_TOL = 1e-3


def write_workers_jsonl(path, n=24, seed=0):
    """n prompts cycling over the four domains, each with its tag and ground
    truth: math sums, code tasks (a stdin case and an assert case as JSON),
    multiple-choice questions (a letter) and capitals (a city)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            tag = tuple(WORKER_CLUSTERS)[i % 4]
            if tag == "math":
                a, b = (int(x) for x in rng.integers(1, 10 ** rng.integers(1, 5), size=2))
                row = {"prompt": MATH_PROMPT.format(a=a, b=b), "ground_truth": str(a + b)}
            elif tag == "code":
                k = int(rng.integers(3, 10))
                row = {"prompt": CODE_PROMPT.format(k=k), "ground_truth": json.dumps(
                    [{"input": "3\n", "output": str(3 * k)},
                     {"assert": f"assert times(2) == {2 * k}"}])}
            elif tag == "crossthinkqa":
                kind, options, gt = MCQ[(i // 4) % len(MCQ)]
                letters = " ".join(f"{c}) {o}" for c, o in zip("ABCD", options))
                row = {"prompt": f"Which of these is {kind}? {letters}. Give the letter in "
                                 "<answer> </answer> tags.", "ground_truth": gt}
            else:
                country, city = CAPITALS[(i // 4) % len(CAPITALS)]
                row = {"prompt": f"What is the capital of {country}? Give the city in "
                                 "<answer> </answer> tags.", "ground_truth": city}
            f.write(json.dumps({**row, "tag": tag}) + "\n")


def workers_answer(tag: str, ground_truth: str, j: int) -> str:
    """Sample j's crafted answer to a prompt of `tag`: right for even j,
    wrong for odd j (code: a program that fails both cases)."""
    right = j % 2 == 0
    if tag == "code":
        k = int(json.loads(ground_truth)[0]["output"]) // 3
        body = f"n * {k}" if right else f"n + {k}"
        return (f"Here it is.\n```python\nimport sys\ndef times(n):\n    return {body}\n"
                f"for line in sys.stdin:\n    print(times(int(line)))\n```")
    if tag == "math":
        answer = ground_truth if right else str(int(ground_truth) + j)
    elif tag == "crossthinkqa":
        answer = ground_truth if right else "ABCD"[("ABCD".index(ground_truth) + 1) % 4]
    else:
        answer = ground_truth if right else "Atlantis"
    return f"<think>sample {j}</think><answer>{answer}</answer>"


class CraftedGenerate:
    """The decode strategy's batch generate, answering each sample j of row
    i at once with workers_answer(tag, ground truth, j) and EOS: the same
    (rows x n, P + longest) layout, the prompt left as collated."""

    def __init__(self, tokenizer, eos_id: int, pad_id: int):
        self.tok, self.eos, self.pad = tokenizer, eos_id, pad_id

    def generate(self, batch, generating_args):
        ids = np.asarray(batch.batch["input_ids"])
        n = generating_args.num_return_sequences
        tags, gts = batch.non_tensor["tag"], batch.non_tensor["ground_truth"]
        rows = [list(self.tok.encode(workers_answer(str(tags[i]), str(gts[i]), j))) + [self.eos]
                for i in range(len(ids)) for j in range(n)]
        out = np.full((len(rows), ids.shape[1] + max(map(len, rows))), self.pad, np.int64)
        for r, answer in enumerate(rows):
            out[r, :ids.shape[1]] = ids[r // n]
            out[r, ids.shape[1]:ids.shape[1] + len(answer)] = answer
        return out


def write_workers_yaml(path, out_dir, **cuts):
    """The phase's pipeline config as a yaml file (JSON is YAML): the rlvr
    phase's optimisation and sampling settings, `cuts`, and a rewards:
    block naming WORKER_CLUSTERS by the JAX package's dotted paths."""
    cuts = {**WORKERS_CUTS, **cuts}
    doc = {"exp_name": "qwen2_5_vl_3B_rlvr_workers", "seed": 42, "output_dir": out_dir,
           "track_with": "stdout", "save_steps": -1, "adv_estimator": "grpo",
           "use_kl_loss": True, "kl_loss_coef": 5e-3, "reward_clip": 10,
           "advantage_clip": 10.0, "init_kl_coef": 0.0, **cuts,
           "actor_train": {"infer_batch_size": 8, "training_args": {
               "learning_rate": 1e-6, "weight_decay": 1e-2, "warmup_steps": 0}},
           "reference": {"infer_batch_size": 8},
           "actor_infer": {"generating_args": {
               "max_new_tokens": cuts["response_length"], "top_p": 0.99, "top_k": 100,
               "temperature": 0.99, "num_return_sequences": cuts["num_return_sequences_in_group"]}},
           "rewards": {domain: {"worker_cls": f"socioreasoner_tpu.pipeline.base_worker.{cls}",
                                "world_size": n}
                       for domain, (cls, n) in WORKER_CLUSTERS.items()}}
    Path(path).write_text(json.dumps(doc, indent=1))


def direct_rewards(domain, texts, gts):
    """The reward function a domain's worker binds, called directly."""
    from socioreasoner_tpu_torch.pipeline.rlvr.rewards import (code_sandbox, general_rules,
                                                                math_rule)
    if domain == "math":
        return math_rule.compute_math_rewards(texts, gts)
    if domain == "code":
        return code_sandbox.compute_code_rewards(texts, gts)
    if domain == "crossthinkqa":
        return general_rules.compute_crossthink_rewards(texts, gts)
    return general_rules.compute_general_val_scores(texts, gts, [domain] * len(texts))


class _SandboxCounter:
    """Counts the code sandbox's subprocesses and their seconds while on
    (the module function wrapped; the cluster's threads call it)."""

    def __init__(self):
        import threading
        from socioreasoner_tpu_torch.pipeline.rlvr.rewards import code_sandbox
        self.mod, self.plain = code_sandbox, code_sandbox._run_sandboxed
        self.lock = threading.Lock()
        self.count, self.seconds = 0, 0.0

    def __enter__(self):
        def counted(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return self.plain(*args, **kwargs)
            finally:
                with self.lock:
                    self.count += 1
                    self.seconds += time.perf_counter() - t0
        self.mod._run_sandboxed = counted
        return self

    def __exit__(self, *exc):
        self.mod._run_sandboxed = self.plain


def _right_aligned(batch, pad_id):
    """The train rows of a batch (left-padded prompt | response | pad) moved
    to the start of their row, the pads after them, every (B, L) and
    (B, L-1) array rolled alike; advantages zero off the response."""
    attn = np.asarray(batch["attention_mask"])
    starts = attn.argmax(-1)
    out = {}
    for k in ("input_ids", "attention_mask", "position_ids", "response_mask", "advantages"):
        v = np.asarray(batch[k])
        out[k] = np.stack([np.roll(row, -int(s), axis=-1) for row, s in zip(v, starts)])
    out["input_ids"][out["attention_mask"] == 0] = pad_id
    out["advantages"] = out["advantages"] * (out["response_mask"][:, 1:] > 0)
    return out


def _text_tree(params):
    """The main tree without its ViT (a new dict over the same tensors)."""
    return {k: v for k, v in params.items() if k != "vision"}


def _launch_counts(kernels):
    return {fn.__name__: fn.launches for fn in kernels}


def _reset(kernels):
    for fn in kernels:
        fn.launches = 0


def run_multi_domain(config, params, out_dir, dev, *, kernels=(), processor=None, **cuts):
    """(a) RLVRPipeline from write_workers_yaml's config read with
    configs/loader.py, on the jsonl read with datasets.loader.get_dataset,
    the policy a copy of the main tree's text part, the reference the main
    tree itself. Pass 1, one step through the real engine; pass 2, one step
    of CraftedGenerate's answers: each domain's rewards equal its reward
    function called directly on the same texts, critic/score_mean 0.5, the
    domain metrics present, the reference's log-probs fixed. Returns stats
    (and pass 2's train batch and texts for the later parts); raises on a
    failed check."""
    import os
    from socioreasoner_tpu_torch.configs.loader import load_config
    from socioreasoner_tpu_torch.configs.rlvr_config import RLVRConfig
    from socioreasoner_tpu_torch.configs.worker_config import DataArguments
    from socioreasoner_tpu_torch.datasets.loader import get_dataset
    from socioreasoner_tpu_torch.pipeline.rlvr.rlvr_pipeline import RLVRPipeline

    yaml_path = os.path.join(out_dir, "rlvr_workers.yaml")
    write_workers_yaml(yaml_path, out_dir, **cuts)
    cfg = load_config(RLVRConfig, yaml_path)
    data_path = os.path.join(out_dir, "workers.jsonl")
    write_workers_jsonl(data_path)
    dataset = get_dataset(DataArguments(file_name=data_path))
    processor = processor or _processor(config, None)
    prompt_tokens = [len(processor.tokenizer.encode(processor.apply_chat_template(r["prompt"], 0)))
                     for r in dataset]
    if max(prompt_tokens) > cfg.prompt_length:
        raise AssertionError(f"workers prompts of {max(prompt_tokens)} tokens exceed "
                             f"prompt_length {cfg.prompt_length}")
    reference = _text_tree(params)
    pipe = RLVRPipeline(cfg, model_config=config, policy_params=_clone(reference),
                        reference_params=reference, processor=processor, dataset=dataset,
                        engine_kwargs=rlvr_engine_kwargs(cfg, RLVR_SLOTS, cfg.prompt_length))
    clusters = {d: (type(c.workers[0]).__module__ + "." + type(c.workers[0]).__name__,
                    c.world_size) for d, c in pipe.reward_clusters.items()}
    shapes = _shape_recorder(pipe)
    ref_seen = _first_reference_log_probs(pipe)
    calls = []
    for domain, fn in list(pipe.reward_fns.items()):
        def timed(texts, gts, fn=fn, domain=domain):
            t0 = time.perf_counter()
            out = fn(texts, gts)
            calls.append({"domain": domain, "texts": list(texts), "gts": list(gts), "out": out,
                          "s": time.perf_counter() - t0})
            return out
        pipe.reward_fns[domain] = timed
    train_batches = []
    train_step = pipe.actor_train.train_step

    def recording_train_step(batch, *a):
        train_batches.append({k: np.asarray(v) for k, v in batch.batch.items()})
        return train_step(batch, *a)
    pipe.actor_train.train_step = recording_train_step

    def run_pass():
        calls.clear()
        _reset(kernels)
        with _SandboxCounter() as sandbox:
            _sync(dev)
            t0 = time.perf_counter()
            metrics = pipe.run()
            _sync(dev)
        hist = pipe.state.log_history[-1]
        bad = sorted(k for k, v in hist.items() if isinstance(v, float) and not np.isfinite(v))
        return metrics, {
            "wall_s": time.perf_counter() - t0, "launches": _launch_counts(kernels),
            "timers_s": {k: hist.get(f"time/{k}") for k in WORKERS_TIMERS},
            "rewards_s": {c["domain"]: c["s"] for c in calls},
            # RLIMIT_NPROC counts the user's processes unless the user is root
            "sandbox": {"subprocesses": sandbox.count, "seconds": sandbox.seconds,
                        "uid": os.getuid()},
            "not_finite": bad}

    # ---- pass 1: the real engine
    metrics1, pass1 = run_pass()
    engine = pipe.actor_infer.engine
    pass1.update(prefill_buckets=sorted({(key[0], key[1]) for key in engine.prefill_hist}),
                 cache_slots=engine.S, cache_lalloc=engine.Lalloc,
                 train_shapes=sorted(shapes["train"]), logprob_shapes=sorted(shapes["logprob"]),
                 domains_scored=sorted(c["domain"] for c in calls),
                 metrics={k: metrics1[k] for k in ("actor_train/total_loss",
                                                   "actor_train/grad_norm", "critic/kl",
                                                   "critic/score_mean")})
    if pipe.state.step != 1 or pass1["not_finite"] or pass1["domains_scored"] != sorted(
            WORKER_CLUSTERS):
        raise AssertionError(f"workers pass 1: {pass1}")
    batch0, ref0 = ref_seen

    # ---- pass 2: crafted answers, half of each group right
    crafted = CraftedGenerate(pipe.processor.tokenizer, config.eos_token_id, config.pad_token_id)
    plain_generate = pipe.actor_infer.generate
    pipe.actor_infer.generate = crafted.generate
    cfg.max_steps = pipe.state.step + 1
    try:
        metrics2, pass2 = run_pass()
    finally:
        pipe.actor_infer.generate = plain_generate
    recomputed = {}
    for c in calls:
        want = direct_rewards(c["domain"], c["texts"], c["gts"])
        recomputed[c["domain"]] = all(np.array_equal(np.asarray(c["out"][k]), want[k])
                                      for k in ("scores", "response_level_rewards"))
    domain_metrics = sorted(k for k in metrics2 if k.split("/", 1)[0] in WORKER_CLUSTERS)
    pass2.update(
        recomputed_equal=recomputed, domain_metrics=domain_metrics,
        rewards={c["domain"]: np.asarray(c["out"]["response_level_rewards"]).tolist()
                 for c in calls},
        metrics={k: metrics2[k] for k in ("actor_train/total_loss", "actor_train/grad_norm",
                                          "critic/kl", "critic/reward_mean",
                                          "critic/score_mean")},
        train_shapes=sorted(shapes["train"]), logprob_shapes=sorted(shapes["logprob"]),
        reference_logprobs_unchanged=np.array_equal(
            pipe.reference.compute_log_probs(batch0)["log_probs"], ref0))
    want_metrics = {"math/math/accuracy", "code/code/pass_rate", "code/code/all_passed",
                    "crossthinkqa/crossthinkqa/accuracy", "general/val/general/accuracy"}
    if not (all(recomputed.values()) and len(recomputed) == 4
            and pass2["metrics"]["critic/score_mean"] == 0.5
            and want_metrics <= set(domain_metrics) and pass2["sandbox"]["subprocesses"] > 0
            and pass2["reference_logprobs_unchanged"] and not pass2["not_finite"]):
        raise AssertionError(f"workers pass 2 (crafted answers): {pass2}")
    texts = {c["domain"]: (c["texts"], c["gts"]) for c in calls}
    questions = {}
    for row in dataset[cfg.rollout_batch_size:2 * cfg.rollout_batch_size]:
        questions[row["tag"]] = row["prompt"]
    stats = {"yaml": os.path.basename(yaml_path), "clusters": clusters,
             "prompt_tokens": [min(prompt_tokens), max(prompt_tokens)], "pass1": pass1,
             "pass2": pass2}
    del pipe
    return stats, train_batches[-1], texts, questions


def run_judge(config, params, texts, questions, dev, *, kernels=(), processor=None):
    """(b) compute_llm_judge_rewards over 8 of pass 2's answers (math,
    crossthinkqa and general, in turn) with generate_fn = greedy
    TorchDecodeStrategy.generate over the main tree, JUDGE_NEW_TOKENS new
    tokens: the scores equal parse_judge_score of the returned texts."""
    from socioreasoner_tpu_torch.configs.worker_config import GeneratingArguments, WorkerConfig
    from socioreasoner_tpu_torch.distributed.torch_strategies import TorchDecodeStrategy
    from socioreasoner_tpu_torch.models.qwen2_5_vl.rope import get_rope_index
    from socioreasoner_tpu_torch.pipeline.rlvr.rewards.llm_judge import (
        compute_llm_judge_rewards, parse_judge_score)
    from socioreasoner_tpu_torch.protocol import BatchProto

    processor = processor or _processor(config, None)
    strategy = TorchDecodeStrategy(worker_config=WorkerConfig())
    strategy.initialize(config, params, engine_kwargs={
        "max_slots": RLVR_SLOTS, "max_len": 512, "decode_chunk": 64, "prefill_buckets": (512,)})
    args = GeneratingArguments(max_new_tokens=JUDGE_NEW_TOKENS, temperature=0.0,
                               num_return_sequences=1)
    seen = {"prompt_tokens": [], "texts": []}
    pad = config.pad_token_id

    def generate_fn(prompts):
        toks = [processor.tokenizer.encode(processor.apply_chat_template(p, 0)) for p in prompts]
        seen["prompt_tokens"] = [len(t) for t in toks]
        P = max(map(len, toks))
        ids = np.full((len(toks), P), pad, np.int64)
        attn = np.zeros_like(ids)
        for i, t in enumerate(toks):
            ids[i, P - len(t):], attn[i, P - len(t):] = t, 1
        pos, _ = get_rope_index(config, ids, None, attn)
        out = strategy.generate(BatchProto.from_dict(tensors={
            "input_ids": ids, "attention_mask": attn, "position_ids": pos}), args)
        seen["texts"] = [processor.decode(row[P:][row[P:] != pad]) for row in out]
        return seen["texts"]

    picked = [(d, i) for i in range(8) for d in ("math", "crossthinkqa", "general")][:8]
    q = [questions[d] for d, _ in picked]
    r = [texts[d][0][i] for d, i in picked]
    refs = [texts[d][1][i] for d, i in picked]
    _reset(kernels)
    _sync(dev)
    t0 = time.perf_counter()
    out = compute_llm_judge_rewards(q, r, refs, generate_fn)
    _sync(dev)
    engine = strategy.engine
    stats = {"generate_s": time.perf_counter() - t0, "launches": _launch_counts(kernels),
             "prompt_tokens": seen["prompt_tokens"], "scores": out["scores"].tolist(),
             "judgments": seen["texts"],
             "prefill_buckets": sorted({(key[0], key[1]) for key in engine.prefill_hist}),
             "cache_slots": engine.S, "cache_lalloc": engine.Lalloc,
             "scores_equal_parse": out["scores"].tolist()
             == [parse_judge_score(t) for t in seen["texts"]]}
    if not (stats["scores_equal_parse"] and len(seen["texts"]) == 8
            and max(seen["prompt_tokens"]) <= JUDGE_PROMPT_TOKENS):
        raise AssertionError(f"judge: {stats}")
    return stats


def run_reward_model_and_critic(config, params, batch, dev, *, kernels=()):
    """(c) RewardWorker through a one-worker Cluster over TorchRewardStrategy
    on a copy of the main tree's text part with a seeded value head: pass
    2's rows, right-aligned, in micro-batches of 8; the response-level reward
    equals the token-level one at the last valid token exactly; rows 0 and
    1's bf16 values within RM_VALUE_TOL of an f32 value_forward. (d) Two
    make_value_step steps on the same copy and rows, old_values the RM's,
    returns old_values + the pass's advantages: the value loss finite and
    falling, the grad norm finite, the value head and a backbone leaf
    moved."""
    import gc
    import torch
    from socioreasoner_tpu_torch.configs.worker_config import WorkerConfig
    from socioreasoner_tpu_torch.distributed import trainer as TT
    from socioreasoner_tpu_torch.distributed.torch_strategies import TorchRewardStrategy
    from socioreasoner_tpu_torch.pipeline.base_worker import RewardWorker
    from socioreasoner_tpu_torch.protocol import BatchProto
    from socioreasoner_tpu_torch.runtime.cluster import Cluster

    pad = config.pad_token_id
    rows = _right_aligned(batch, pad)
    tree = TT.add_value_head(_clone(_text_tree(params)),
                             torch.Generator(device=dev).manual_seed(5),
                             config.text.hidden_size)
    wc = WorkerConfig(infer_batch_size=8)
    strategy = TorchRewardStrategy(worker_config=wc)
    strategy.initialize(config, tree)
    cluster = Cluster("reward_model", RewardWorker, wc)
    cluster.initialize(strategy=strategy)
    data = BatchProto.from_dict(tensors={k: rows[k] for k in (
        "input_ids", "attention_mask", "position_ids")}, meta={"pad_token_id": pad})
    _reset(kernels)
    _sync(dev)
    t0 = time.perf_counter()
    out = cluster.compute_rewards(data)
    _sync(dev)
    rm_ms = 1e3 * (time.perf_counter() - t0)
    cluster.shutdown()
    token, resp = out.batch["token_level_rewards"], out.batch["response_level_rewards"]
    eos = rows["attention_mask"].sum(-1) - 2
    at_eos = bool(np.array_equal(resp, token[np.arange(len(token)), eos]))
    valid = rows["attention_mask"][:, 1:] == 1
    tree32 = _float_tree(tree)
    _, value_forward = TT.make_value_step(config, TT.make_optimizer())
    two = {k: torch.as_tensor(rows[k][:2], device=dev)
           for k in ("input_ids", "attention_mask", "position_ids")}
    with torch.no_grad():
        v32 = value_forward(tree32, two).cpu().numpy()
    del tree32
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    scale = float(np.abs(v32[valid[:2]]).max())
    rm_err = float(np.abs(token[:2] - v32)[valid[:2]].max())
    rm = {"ms": rm_ms, "rows": list(rows["input_ids"].shape), "launches": _launch_counts(kernels),
          "response_equals_token_at_eos": at_eos, "eos_index": eos.tolist(),
          "bf16_vs_f32_max_abs": rm_err, "f32_max_abs": scale,
          "rewards": resp.tolist()}
    if not (at_eos and rm_err <= RM_VALUE_TOL * scale and np.isfinite(token).all()):
        raise AssertionError(f"reward model: {rm}")

    # ---- (d) the critic
    opt = TT.make_optimizer(lr=STEP_LR)
    state = TT.TrainState.create(tree, opt)
    value_step, _ = TT.make_value_step(config, opt)
    device_batch = {k: torch.as_tensor(rows[k], device=dev) for k in (
        "input_ids", "attention_mask", "position_ids", "response_mask")}
    device_batch["old_values"] = torch.as_tensor(token, device=dev)
    device_batch["returns"] = torch.as_tensor(token + rows["advantages"].astype(np.float32),
                                              device=dev)
    head0, leaf0 = tree["value_head_w"].clone(), tree["layers"]["q_b"].clone()
    _reset(kernels)
    steps = []
    for _ in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = value_step(state, device_batch)
        _sync(dev)
        steps.append({"ms": 1e3 * (time.perf_counter() - t0),
                      **{k: float(v) for k, v in m.items()}})
    critic = {"steps": steps, "launches": _launch_counts(kernels),
              "value_head_moved": not torch.equal(tree["value_head_w"], head0),
              "backbone_moved": not torch.equal(tree["layers"]["q_b"], leaf0)}
    losses = [s["critic_train/value_loss"] for s in steps]
    if not (np.isfinite(losses).all() and losses[1] < losses[0]
            and all(np.isfinite(s["critic_train/grad_norm"]) for s in steps)
            and critic["value_head_moved"] and critic["backbone_moved"]):
        raise AssertionError(f"critic: {critic}")
    return rm, critic


def sft_samples(spec, vocab: int, seed: int = 7):
    """spec["samples"] seeded samples of min_len-max_len tokens, the first
    fifth of each (its prompt) out of the loss."""
    rng = np.random.default_rng(seed)
    out = []
    for n in rng.integers(spec["min_len"], spec["max_len"] + 1, size=spec["samples"]):
        out.append({"input_ids": rng.integers(3, vocab - 1, size=int(n)),
                    "loss_mask": (np.arange(n) >= n // 5).astype(np.int32)})
    return out


def repack(samples, max_len: int, pad_id: int):
    """An independent first-fit-decreasing packing of `samples`: (ids, loss
    mask, positions) a row, for holding pack_sequences to."""
    rows, used = [], []
    for s in sorted(samples, key=lambda s: -len(s["input_ids"])):
        n = len(s["input_ids"])
        r = next((i for i, u in enumerate(used) if u + n <= max_len), None)
        if r is None:
            rows.append((np.full(max_len, pad_id, np.int64), np.zeros(max_len, np.int32),
                         np.ones(max_len, np.int64)))
            used.append(0)
            r = len(rows) - 1
        ids, loss, pos = rows[r]
        ids[used[r]:used[r] + n] = s["input_ids"]
        loss[used[r]:used[r] + n] = s["loss_mask"]
        pos[used[r]:used[r] + n] = np.arange(n)
        used[r] += n
    return rows


def run_sft(config, params, dev, *, kernels=(), spec=SFT_SPEC):
    """(e) pack_sequences over sft_samples into rows of spec["row"], held to
    repack; then two make_sft_step steps on a fresh copy of the main tree's
    text part, each over every row in micro-batches of spec["micro"] rows
    (one update a step, the gradients accumulated): the loss finite and
    lower on the second step."""
    import torch
    from socioreasoner_tpu_torch.distributed import trainer as TT
    from socioreasoner_tpu_torch.distributed.sft import pack_sequences

    samples = sft_samples(spec, config.text.vocab_size)
    rows = pack_sequences(samples, spec["row"], config.pad_token_id)
    want = repack(samples, spec["row"], config.pad_token_id)
    packed_equal = len(rows) == len(want) and all(
        np.array_equal(r["input_ids"], w[0]) and np.array_equal(r["loss_mask"], w[1])
        and all(np.array_equal(r["position_ids"][a], w[2]) for a in range(3))
        for r, w in zip(rows, want))
    micro = [{k: torch.as_tensor(np.stack([r[k] for r in rows[i:i + spec["micro"]]]), device=dev)
              for k in ("input_ids", "attention_mask", "position_ids", "loss_mask")}
             for i in range(0, len(rows), spec["micro"])]
    opt = TT.make_optimizer(lr=STEP_LR, gradient_accumulation_steps=len(micro))
    state = TT.TrainState.create(_clone(_text_tree(params)), opt)
    sft_step = TT.make_sft_step(config, opt)
    tokens = int(sum(int((r["attention_mask"]).sum()) for r in rows))
    _reset(kernels)
    steps = []
    for _ in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        ms = [sft_step(state, mb)[1] for mb in micro]
        _sync(dev)
        wall = time.perf_counter() - t0
        steps.append({"ms": 1e3 * wall, "tokens_per_s": tokens / wall,
                      "loss": float(np.mean([float(m["sft/loss"]) for m in ms])),
                      "grad_norm": [float(m["sft/grad_norm"]) for m in ms]})
    sft = {"rows": len(rows), "row_len": spec["row"], "micro_batches": len(micro),
           "tokens": tokens, "samples": [len(s["input_ids"]) for s in samples],
           "packed_equal_recomputed": packed_equal, "steps": steps,
           "launches": _launch_counts(kernels)}
    del state
    if not (packed_equal and np.isfinite([s["loss"] for s in steps]).all()
            and steps[1]["loss"] < steps[0]["loss"]):
        raise AssertionError(f"sft: {sft}")
    return sft


def dpo_batch(config, spec, dev, seed: int = 9):
    """spec["pairs"] chosen/rejected pairs of spec["L"] tokens sharing a
    prompt of spec["prompt"] tokens, the responses in the loss."""
    import torch
    rng = np.random.default_rng(seed)
    B, L, P = spec["pairs"], spec["L"], spec["prompt"]
    prompt = rng.integers(3, config.text.vocab_size - 1, size=(B, P))
    batch = {}
    for prefix in ("chosen", "rejected"):
        ids = np.concatenate([prompt, rng.integers(3, config.text.vocab_size - 1,
                                                   size=(B, L - P))], axis=1)
        batch.update({f"{prefix}_input_ids": ids,
                      f"{prefix}_attention_mask": np.ones((B, L), np.int64),
                      f"{prefix}_position_ids": np.broadcast_to(
                          np.arange(L)[None, None], (B, 3, L)).copy(),
                      f"{prefix}_loss_mask": (np.arange(L)[None] >= P).repeat(B, 0)
                      .astype(np.int32)})
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def run_dpo(config, params, dev, *, kernels=(), spec=DPO_SPEC):
    """(f) make_dpo_step (sigmoid) on a fresh copy of the main tree's text
    part, the reference's summed log-probs from the main tree through the
    same forward: at step 1 the policy is the reference, so dpo/loss is
    log 2 within DPO_LOSS_TOL and dpo/margin 0; step 2's margin on the same
    pairs is above 0."""
    import torch
    from socioreasoner_tpu_torch.distributed import trainer as TT
    from socioreasoner_tpu_torch.distributed.sft import make_dpo_step

    batch = dpo_batch(config, spec, dev)
    with torch.no_grad():
        for prefix in ("chosen", "rejected"):
            sub = {k: batch[f"{prefix}_{k}"] for k in ("input_ids", "attention_mask",
                                                      "position_ids")}
            lp, _ = TT._model_log_probs(config, params, sub, True, with_entropy=False)
            batch[f"ref_{prefix}_logps"] = (
                lp * batch[f"{prefix}_loss_mask"][:, 1:].float()).sum(-1)
    opt = TT.make_optimizer(lr=STEP_LR)
    state = TT.TrainState.create(_clone(_text_tree(params)), opt)
    dpo_step = make_dpo_step(config, opt, beta=spec["beta"])
    _reset(kernels)
    steps = []
    for _ in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = dpo_step(state, batch)
        _sync(dev)
        steps.append({"ms": 1e3 * (time.perf_counter() - t0),
                      **{k: float(v) for k, v in m.items()}})
    dpo = {"pairs": spec["pairs"], "L": spec["L"], "steps": steps,
           "launches": _launch_counts(kernels)}
    del state
    first, second = steps
    if not (abs(first["dpo/loss"] - float(np.log(2))) <= DPO_LOSS_TOL
            and first["dpo/margin"] == 0.0 and second["dpo/margin"] > 0
            and np.isfinite([s["dpo/grad_norm"] for s in steps]).all()):
        raise AssertionError(f"dpo: {dpo}")
    return dpo


def run_workers_path(config, params, out_dir, dev, *, kernels=(), processor=None,
                     sft_spec=SFT_SPEC, dpo_spec=DPO_SPEC, **cuts):
    """The workers phase's parts (a)-(f) in turn on the main tree, which
    none of them may move (checksums before and after). Returns stats;
    raises on a failed check."""
    import gc
    import torch

    def free():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    sums = tree_checksums(params)
    multi, batch, texts, questions = run_multi_domain(
        config, params, out_dir, dev, kernels=kernels, processor=processor, **cuts)
    free()
    judge = run_judge(config, params, texts, questions, dev, kernels=kernels,
                      processor=processor)
    free()
    rm, critic = run_reward_model_and_critic(config, params, batch, dev, kernels=kernels)
    free()
    sft = run_sft(config, params, dev, kernels=kernels, spec=sft_spec)
    free()
    dpo = run_dpo(config, params, dev, kernels=kernels, spec=dpo_spec)
    free()
    unchanged = tree_checksums(params) == sums
    if not unchanged:
        raise AssertionError("the workers phase moved the main tree")
    return {"rlvr": multi, "judge": judge, "reward_model": rm, "critic": critic, "sft": sft,
            "dpo": dpo, "main_tree_unchanged": unchanged}


def phase_workers(config, params):
    """The workers phase at full width on the main phase's Qwen2.5-VL-3B
    tree (run_workers_path): kernels 2-6 must launch in the RLVR pass
    through the engine, 4-6 in the crafted pass, 2 and 3 for the judge, and
    none of 4-6 in the reward model, critic, SFT and DPO (dense attention,
    as in the JAX package); each pass at the shapes the kernels phase
    checked (RLVR_*, JUDGE_PREFILL). Peak memory < 80 GB. Returns the
    launch counts over the phase."""
    import tempfile
    import torch
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    kernels = (fa.flash_attention_segmented, fa.flash_attention, da.paged_decode_attention,
               *_train_kernel_fns())
    names = [k.__name__ for k in kernels]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        stats = run_workers_path(config, params, out_dir, dev, kernels=kernels)
    phase_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    p1, p2, judge = stats["rlvr"]["pass1"], stats["rlvr"]["pass2"], stats["judge"]
    emit({"phase": "workers", "card": _smi_line(),
          "model": "Qwen2.5-VL-3B (36 text layers) in bf16, random weights",
          "cuts": {"rlvr": WORKERS_CUTS, "sft": SFT_SPEC, "dpo": DPO_SPEC,
                   "judge_new_tokens": JUDGE_NEW_TOKENS},
          "phase_s": phase_s, "max_memory_allocated_gb": peak, **stats})
    dense = ("reward_model", "critic", "sft", "dpo")
    emit({"phase": "workers_figures", "card": _smi_line(), "max_memory_allocated_gb": peak,
          "phase_s": phase_s,
          "pass1": {k: p1[k] for k in ("wall_s", "timers_s", "rewards_s", "sandbox")},
          "pass2": {k: p2[k] for k in ("wall_s", "timers_s", "rewards_s", "sandbox")},
          "judge_generate_s": judge["generate_s"],
          "reward_model_ms_32x512": stats["reward_model"]["ms"],
          "critic_step_ms": [s["ms"] for s in stats["critic"]["steps"]],
          "sft_step_ms": [s["ms"] for s in stats["sft"]["steps"]],
          "sft_tokens_per_s": [s["tokens_per_s"] for s in stats["sft"]["steps"]],
          "dpo_step_ms": [s["ms"] for s in stats["dpo"]["steps"]]})
    missing = ([k for k in names[1:] if p1["launches"][k] <= 0]
               + [k for k in names[3:] if p2["launches"][k] <= 0]
               + [k for k in names[1:3] if judge["launches"][k] <= 0]
               + [f"{part}:{k}" for part in dense for k in names[3:]
                  if stats[part]["launches"][k] != 0])
    if missing:
        raise AssertionError(f"kernels off the workers path (or on a dense step): {missing}")
    left = (_left_shapes(p1, RLVR_PREFILL, RLVR_SLOTS, RLVR_LALLOC, RLVR_TRAIN)
            + _left_shapes(dict(p2, prefill_buckets=[], cache_slots=None, cache_lalloc=None),
                           RLVR_PREFILL, RLVR_SLOTS, RLVR_LALLOC, RLVR_TRAIN)
            + _left_shapes(dict(judge, train_shapes=[], logprob_shapes=[]), JUDGE_PREFILL,
                           RLVR_SLOTS, RLVR_LALLOC, RLVR_TRAIN))
    if left:
        raise AssertionError(f"the workers phase left the checked shapes: {left}")
    if not peak < 80:
        raise AssertionError(f"the workers phase peaked at {peak} GiB")
    parts = (p1, p2, judge, *(stats[p] for p in dense))
    return {k: sum(p["launches"][k] for p in parts) for k in names}


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



# ------------------------------------------------------------- other families

# Published configurations, typed in from the config.json each repository of
# the Hugging Face hub ships (nothing is downloaded; the weights are random).
QWEN3_30B_A3B = {     # Qwen/Qwen3-30B-A3B
    "architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe",
    "vocab_size": 151936, "hidden_size": 2048, "intermediate_size": 6144,
    "num_hidden_layers": 48, "num_attention_heads": 32, "num_key_value_heads": 4,
    "head_dim": 128, "max_position_embeddings": 40960, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "rope_scaling": None, "tie_word_embeddings": False,
    "attention_bias": False, "num_experts": 128, "num_experts_per_tok": 8,
    "moe_intermediate_size": 768, "norm_topk_prob": True, "decoder_sparse_step": 1,
    "mlp_only_layers": [], "router_aux_loss_coef": 0.001, "bos_token_id": 151643,
    "eos_token_id": 151645, "torch_dtype": "bfloat16"}
QWEN15_MOE_A27B = {   # Qwen/Qwen1.5-MoE-A2.7B
    "architectures": ["Qwen2MoeForCausalLM"], "model_type": "qwen2_moe",
    "vocab_size": 151936, "hidden_size": 2048, "intermediate_size": 5632,
    "num_hidden_layers": 24, "num_attention_heads": 16, "num_key_value_heads": 16,
    "max_position_embeddings": 8192, "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
    "tie_word_embeddings": False, "num_experts": 60, "num_experts_per_tok": 4,
    "moe_intermediate_size": 1408, "shared_expert_intermediate_size": 5632,
    "norm_topk_prob": False, "decoder_sparse_step": 1, "router_aux_loss_coef": 0.001,
    "bos_token_id": 151643, "eos_token_id": 151643, "torch_dtype": "bfloat16"}
QWEN2_VL_2B = {       # Qwen/Qwen2-VL-2B-Instruct
    "architectures": ["Qwen2VLForConditionalGeneration"], "model_type": "qwen2_vl",
    "vocab_size": 151936, "hidden_size": 1536, "intermediate_size": 8960,
    "num_hidden_layers": 28, "num_attention_heads": 12, "num_key_value_heads": 2,
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
    "tie_word_embeddings": True, "bos_token_id": 151643, "eos_token_id": 151645,
    "vision_start_token_id": 151652, "vision_end_token_id": 151653,
    "vision_token_id": 151654, "image_token_id": 151655, "video_token_id": 151656,
    "vision_config": {"depth": 32, "embed_dim": 1280, "mlp_ratio": 4, "num_heads": 16,
                      "in_chans": 3, "hidden_size": 1536, "patch_size": 14,
                      "spatial_merge_size": 2, "spatial_patch_size": 14,
                      "temporal_patch_size": 2},
    "torch_dtype": "bfloat16"}


def _bf16_ulp(p: float) -> float:
    """One bf16 unit in the last place at |p| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(p))) - 7) if p else 0.0


@contextlib.contextmanager
def _router_probs(token: int, out: list):
    """Record, for every MoE layer run inside, the router's probabilities
    at flat token index `token`, with the layer's top-k."""
    from socioreasoner_tpu_torch.ops import moe
    plain = moe.moe_router

    def recording(x, router_w, top_k, norm_topk_prob=True):
        res = plain(x, router_w, top_k, norm_topk_prob)
        out.append((res[1][token].float().cpu().numpy(), top_k))
        return res

    moe.moe_router = recording
    try:
        yield
    finally:
        moe.moe_router = plain


def _router_gaps(config, params, ids_t, pos_t, attn_t, token: int):
    """Per layer: (the gap between the k-th and (k+1)-th router probability
    at `token` in the dense forward, that in bf16 ulps of the k-th)."""
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    rows = []
    with _router_probs(token, rows):
        qmodel.forward(config, params, ids_t, pos_t, attn_t, logits=False)
    gaps = []
    for probs, k in rows:
        p = np.sort(probs)[::-1]
        gap = float(p[k - 1] - p[k]) if k < len(p) else float("inf")
        gaps.append((gap, gap / max(_bf16_ulp(float(p[k - 1])), 1e-45)))
    return gaps


def greedy_against_forward(config, params, dev, prompts, outs):
    """Each request's greedy tokens against one teacher-forced uncached
    forward (dense attention) over its prompt and tokens. A token that is
    not the forward's argmax counts as a tie where its logit lies within
    GAP_TOL of the argmax's (phase_engine's rule, which takes the
    runner-up: in a 151,936-token vocabulary of bf16 logits three or more
    tokens can share the top value, so the token may rank third on a gap
    of 0) or, for an MoE family, where at that token some layer's k-th and
    (k+1)-th router probabilities lie within one bf16 ulp (the routing
    flips on rounding); anything else is a failure. Returns (tie flips as
    (request, step, the token's gap, its rank), routing ties, failures,
    checked tokens)."""
    import torch
    from socioreasoner_tpu_torch.models import llm
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    flips, routing, failures, checked = [], [], [], 0
    for r, (prompt, out) in enumerate(zip(prompts, outs)):
        got = list(out.output_ids)
        ids = np.asarray([prompt + got[:-1]])
        attn = np.ones_like(ids)
        ids_t, attn_t = (torch.as_tensor(a, device=dev) for a in (ids, attn))
        pos_t = torch.as_tensor(llm.text_position_ids(ids, attn), device=dev)
        with torch.no_grad():
            logits, _ = qmodel.forward(config, params, ids_t, pos_t, attn_t)
            rows = logits[0, len(prompt) - 1:].float().cpu().numpy()
        del logits
        for step, tok in enumerate(got):
            checked += 1
            top2 = np.argsort(rows[step])[-2:][::-1]
            if tok == int(top2[0]):
                continue
            gap = float(rows[step][top2[0]] - rows[step][tok])
            if gap < GAP_TOL:
                flips.append((r, step, gap, int((rows[step] > rows[step][tok]).sum()) + 1))
                continue
            layers = []
            if config.text.n_experts:
                with torch.no_grad():
                    layers = _router_gaps(config, params, ids_t, pos_t, attn_t,
                                          len(prompt) - 1 + step)
            record = {"request": r, "step": step, "token": tok, "argmax": int(top2[0]),
                      "logit_gap": gap, "router_gap_ulps": [u for _, u in layers]}
            (routing if any(u <= 1.0 for _, u in layers) else failures).append(record)
    return flips, routing, failures, checked


def profile_forward(config, params, dev, prompt):
    """One uncached forward (dense attention) over `prompt` under
    torch.profiler, read through utils/profiling: wall ms, the device's
    kernel ms and the kernels that take most of it."""
    import torch
    from socioreasoner_tpu_torch.models import llm
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    from socioreasoner_tpu_torch.utils.profiling import busy_us
    ids = np.asarray([prompt])
    attn = np.ones_like(ids)
    args = [torch.as_tensor(a, device=dev) for a in (ids, llm.text_position_ids(ids, attn),
                                                      attn)]
    with torch.no_grad():
        _, ms, rows = profiled(lambda: qmodel.forward(config, params, *args))
    kernels = [r for r in rows if r["plane"].startswith("/device:")]
    return {"tokens": len(prompt), "ms": ms, "device_ms": busy_us(rows) / 1e3,
            "top_kernels": [{"name": r["name"][:80], "ms": r["total_us"] / 1e3,
                             "launches": r["count"]} for r in kernels[:6]]}


def forced_against_forward(config, params, engine, dev, prompts, outs):
    """The engine's greedy tokens against the dense uncached forward with a
    measured tie bound (tp_tie_check's rule, for models whose logits pass
    GAP_TOL's bf16 resolution): the engine teacher-forced along its own
    tokens (_forced_logits; the launch counts are left as they were) and the
    forward over the same prefix give each step's logits. `delta`, their
    largest difference at a step, must stay within TP_DELTA_LIMIT (a kernel
    fault moves the logits by their own size), and a token that is not the
    forward's argmax must lie within max(GAP_TOL, 2 x delta) of the
    forward's top logit (a tie flip). Returns (tie flips, failures, checked
    tokens, the largest delta)."""
    import torch
    from socioreasoner_tpu_torch.models import llm
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    from socioreasoner_tpu_torch.ops import decode_attention as da
    tokens = [list(o.output_ids) for o in outs]
    kernels = (*_family_kernels(), da.paged_decode_attention_int8)
    counts = [k.launches for k in kernels]
    try:
        forced = _forced_logits(engine, [{"prompt_ids": p, "image_embeds": None,
                                          "position_ids": None} for p in prompts], tokens)
    finally:
        for k, c in zip(kernels, counts):
            k.launches = c
    flips, failures, checked, worst = [], [], 0, 0.0
    for r, (prompt, got, eng) in enumerate(zip(prompts, tokens, forced)):
        ids = np.asarray([prompt + got[:-1]])
        attn = np.ones_like(ids)
        ids_t, attn_t = (torch.as_tensor(a, device=dev) for a in (ids, attn))
        pos_t = torch.as_tensor(llm.text_position_ids(ids, attn), device=dev)
        with torch.no_grad():
            logits, _ = qmodel.forward(config, params, ids_t, pos_t, attn_t)
            fwd = logits[0, len(prompt) - 1:].float().cpu().numpy()
        del logits
        for step, tok in enumerate(got):
            checked += 1
            delta = float(np.abs(eng[step] - fwd[step]).max())
            worst = max(worst, delta)
            top = int(np.argmax(fwd[step]))
            gap = float(fwd[step][top] - fwd[step][tok])
            record = {"request": r, "step": step, "token": tok, "argmax": top,
                      "logit_gap": gap, "delta": delta, "top": float(fwd[step][top])}
            if delta > TP_DELTA_LIMIT or gap > max(GAP_TOL, 2 * delta):
                failures.append(record)
            elif tok != top:
                flips.append(record)
    return flips, failures, checked, worst


def serve_family(config, params, dev, *, prompt_lens=FAMILY_PROMPT_LENS,
                 bucket=FAMILY_BUCKET, max_new=32, decode_chunk=16, seed=0,
                 forced_ties=False, engine_extra=None):
    """Random-token prompts through the engine of a TorchDecodeStrategy
    initialised on `params` (which serves the tree without a copy; with
    `engine_extra`'s engine knobs, e.g. the int8 KV cache) at greedy (one
    batched prefill, then decode over the slots), held by
    greedy_against_forward (with forced_ties, by forced_against_forward);
    then one decode chunk of new requests at the same prompt lengths under
    torch.profiler (profile_decode_chunk), and the uncached forward over the
    longest prompt (profile_forward). Returns the figures, with the engine's
    prefill buckets and cache shape."""
    from socioreasoner_tpu_torch.distributed.torch_strategies import TorchDecodeStrategy
    from socioreasoner_tpu_torch.generation.engine import Request
    from socioreasoner_tpu_torch.generation.sampling import SamplingParams
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, config.text.vocab_size - 8, n).tolist() for n in prompt_lens]
    strategy = TorchDecodeStrategy()
    strategy.initialize(config, params, engine_kwargs={
        "max_slots": len(prompts), "max_len": bucket + max_new, "decode_chunk": decode_chunk,
        "prefill_buckets": (bucket,), "device": dev, **(engine_extra or {})})
    engine = strategy.engine
    if engine.params["layers"]["gate_w"].data_ptr() != params["layers"]["gate_w"].data_ptr():
        raise AssertionError("the engine serves a copy of the tree")
    sp = SamplingParams(temperature=0.0, do_sample=False, max_new_tokens=max_new)
    _sync(dev)
    t0 = time.perf_counter()
    outs = engine.generate([Request(request_id=i, prompt_ids=p, sampling=sp)
                            for i, p in enumerate(prompts)])
    _sync(dev)
    wall = time.perf_counter() - t0
    _check_outputs(config, outs)
    stats = {"prompt_lens": [len(p) for p in prompts],
             "generated": [len(o.output_ids) for o in outs],
             "generate_wall_s": wall, "prefill_ms": engine.prefill_device_time * 1e3,
             "decode_s": engine.decode_time, "steps_executed": engine.steps_executed,
             "decode_ms_per_step": engine.decode_time * 1e3 / max(engine.steps_executed, 1),
             "prefill_buckets": sorted(engine.prefill_hist),
             "cache": list(engine.caches["k"].shape)}
    t1 = time.perf_counter()
    if forced_ties:
        flips, failures, checked, delta = forced_against_forward(config, params, engine, dev,
                                                                 prompts, outs)
        routing = []
        stats.update(max_logit_delta=delta, delta_limit=TP_DELTA_LIMIT)
    else:
        flips, routing, failures, checked = greedy_against_forward(config, params, dev,
                                                                  prompts, outs)
    stats.update(checked_tokens=checked, tie_flips=flips, routing_ties=routing,
                 failures=failures, check_s=time.perf_counter() - t1)
    stats["decode_profile"] = profile_decode_chunk(engine, dev, list(prompt_lens))
    stats["prefill_buckets"] = sorted(engine.prefill_hist)
    stats["forward_profile"] = profile_forward(config, params, dev, prompts[0])
    del engine, strategy
    if failures:
        raise AssertionError(f"greedy diverged beyond ties: {failures}")
    return stats


# Response tokens a row of train_family's batch. Its first step's loss gap is
# the mean over the response tokens of advantage x (the dense path's log-prob
# minus the kernels'), two bf16 computations that each differ from an f32 dense
# reference by about as much (train_family's `logprobs_at_init`): over 2 x 256
# tokens that noise read 1.67e-3 at head dim 512 on an H100 against
# PARITY_LOSS_TOL's 1e-3, over 2 x 1024 it halves. A fault confined to a few
# positions is diluted in that mean; `logprobs_at_init` reports its largest
# 256-token window of every row undiluted.
FAMILY_TRAIN_RESPONSE = 1024


LOGPROB_WINDOW = 256   # response tokens a window of logprobs_at_init's excess


def logprobs_at_init(config, params, batch):
    """The response log-probs at `params` by the kernels (parity_batch's old
    log-probs) and by dense attention, each against dense attention on an
    f32 copy of the params: the mean-abs error of each over the response
    tokens, the kernels' max-abs gap from dense, and the largest excess of
    the kernels' error over dense's in any LOGPROB_WINDOW consecutive response
    tokens of a row (a fault confined to some positions shows there
    undiluted). train_family holds them to the LOGPROB_* bounds."""
    from socioreasoner_tpu_torch.distributed import trainer as T
    dense = T.make_logprob_step(config, allow_flash=False)
    lp_k, lp_d = batch["old_log_probs"], dense(params, batch)["log_probs"]
    lp_f = dense(_f32(params), batch)["log_probs"]
    mask = batch["response_mask"][:, 1:].bool()
    err_k, err_d = (lp_k - lp_f).abs(), (lp_d - lp_f).abs()
    excess = max(((err_k[b][mask[b]] - err_d[b][mask[b]])
                  .unfold(0, min(LOGPROB_WINDOW, int(mask[b].sum())), 1).mean(-1).max().item())
                 for b in range(mask.shape[0]))
    return {"response_tokens": int(mask.sum()),
            "kernels_vs_f32_mean_abs": err_k[mask].mean().item(),
            "dense_vs_f32_mean_abs": err_d[mask].mean().item(),
            "kernels_vs_dense_max_abs": (lp_k - lp_d).abs()[mask].max().item(),
            f"worst_{LOGPROB_WINDOW}_window_excess": excess}


def train_family(config, params, dev, *, lens=FAMILY_TRAIN["kv_lens"], steps=2):
    """`steps` PPO steps with the trainable flash kernels and as many with
    dense attention (allow_flash=False), each from its own copy of the bf16
    params, on parity_batch's rows of `lens` (the last FAMILY_TRAIN_RESPONSE
    tokens of each row the response): the loss and pre-clip grad norm
    of every step within PARITY_LOSS_TOL / PARITY_NORM_TOL of dense, and the
    MLP's stacks (an MoE family's router, every expert stack and q/k norms)
    given finite, non-zero gradients (AdamW's first moments after the
    steps). Returns the figures, logprobs_at_init's among them."""
    import torch
    from socioreasoner_tpu_torch.distributed import trainer as T
    from socioreasoner_tpu_torch.pipeline.losses import PPOLossConfig
    batch = parity_batch(config, params, dev, lens, response=FAMILY_TRAIN_RESPONSE)
    at_init = logprobs_at_init(config, params, batch)
    k_f32, d_f32 = at_init["kernels_vs_f32_mean_abs"], at_init["dense_vs_f32_mean_abs"]
    # the ratio has no meaning for float32 params (the CPU rehearsals): dense
    # attention on them is the float32 reference itself
    f32 = all(leaf.dtype == torch.float32 for _, leaf in _named_leaves(params)
              if leaf.is_floating_point())
    ratio = None if f32 else (k_f32 / d_f32 if d_f32 > 0 else float("inf"))
    at_init_bounds = {
        "worst_window_excess": [at_init[f"worst_{LOGPROB_WINDOW}_window_excess"],
                                LOGPROB_WINDOW_EXCESS_TOL],
        "kernels_vs_dense_max_abs": [at_init["kernels_vs_dense_max_abs"],
                                     LOGPROB_KERNELS_DENSE_TOL],
        "kernels_over_dense_vs_f32": [ratio, LOGPROB_F32_RATIO_TOL]}
    if not (at_init_bounds["worst_window_excess"][0] <= LOGPROB_WINDOW_EXCESS_TOL
            and at_init["kernels_vs_dense_max_abs"] <= LOGPROB_KERNELS_DENSE_TOL
            and (ratio is None or ratio <= LOGPROB_F32_RATIO_TOL)):
        raise AssertionError(f"the kernels' log-probs at the initial params pass a bound "
                             f"([reading, bound]): {at_init_bounds}, {at_init}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    names = [n for n, _ in _named_leaves(params)]
    watched = [n for n in names if n.split("/")[-1] in (
        "router_w", "gate_w", "up_w", "down_w", "s_gate_w", "s_up_w", "s_down_w", "sgate_w",
        "q_norm", "k_norm") and n.startswith("layers/")]
    res = {}
    for flash in (True, False):
        opt = T.make_optimizer()
        state = T.TrainState.create(_clone(params), opt)
        step = T.make_train_step(config, PPOLossConfig(), opt, allow_flash=flash)
        losses, norms, walls = [], [], []
        for _ in range(steps):
            _sync(dev)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["actor_train/loss"].item())
            norms.append(metrics["actor_train/grad_norm"].item())
            walls.append(time.perf_counter() - t0)
        mu = dict(zip(names, state.opt_state["mu"]))
        moved = {n: bool(torch.isfinite(mu[n]).all()) and bool(mu[n].ne(0).any())
                 for n in watched}
        res[flash] = {"loss": losses, "grad_norm": norms, "step_s": walls,
                      "finite_nonzero_grads": moved}
        del state, mu
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    k, d = res[True], res[False]
    ok = (all(abs(a - b) <= PARITY_LOSS_TOL for a, b in zip(k["loss"], d["loss"]))
          and all(abs(a - b) <= PARITY_NORM_TOL * b for a, b in zip(k["grad_norm"],
                                                                     d["grad_norm"]))
          and np.isfinite(k["loss"] + k["grad_norm"]).all()
          and all(k["finite_nonzero_grads"].values())
          and len(watched) >= (6 if config.text.n_experts else 3))
    out = {"shape": f"B={len(lens)} L={lens[0]} kv_len={list(lens)}",
           "kernels": k, "dense": d, "logprobs_at_init": at_init,
           "logprobs_at_init_bounds": at_init_bounds}
    if not ok:
        raise AssertionError(f"MoE train step out of parity with dense attention: {out}")
    return out


def text_model_round_trip(config, params, hf_config, path, dev):
    """The tree written with the port's save_pretrained (qwen-moe names)
    under the family's own config.json (save_pretrained's names the
    Qwen2.5-VL model type), read back through llm.load_text_model: the
    same config, every leaf bit-equal. Returns (write s, read s, GB)."""
    import torch
    from socioreasoner_tpu_torch.models import llm
    from socioreasoner_tpu_torch.models.qwen2_5_vl.export import save_pretrained
    _sync(dev)
    t0 = time.perf_counter()
    save_pretrained(config, params, path)
    with open(Path(path) / "config.json", "w") as f:
        json.dump(hf_config, f)
    t1 = time.perf_counter()
    config2, back = llm.load_text_model(path, dtype=params["embed"].dtype, device=dev)
    _sync(dev)
    t2 = time.perf_counter()
    want, got = dict(_named_leaves(params)), dict(_named_leaves(back))
    bad = sorted(set(want) ^ set(got)) + [n for n in want if n in got and
                                         not torch.equal(want[n], got[n])]
    if config2 != config or bad:
        raise AssertionError(f"text model round trip differs: config equal "
                             f"{config2 == config}, leaves {bad[:8]}")
    return t1 - t0, t2 - t1, _tree_bytes(params) / 1e9


def write_qwen2_vl_checkpoint(hf_config, path, dev, seed=0):
    """An HF Qwen2VLForConditionalGeneration checkpoint of random bf16
    weights (N(0, 0.02), unit norms, zero biases; the tied head omitted)
    under HF's names and (out, in) layouts, with its config.json, written
    by the port's safetensors writer. Returns its GB."""
    import torch
    from socioreasoner_tpu_torch.utils.safetensors_io import save_sharded
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev).mul_(0.02).to(torch.bfloat16)

    def const(value, *shape):
        return torch.full(shape, value, dtype=torch.bfloat16, device=dev)

    h = hf_config
    H, I, V, L = h["hidden_size"], h["intermediate_size"], h["vocab_size"], \
        h["num_hidden_layers"]
    D = H // h["num_attention_heads"]
    q, kv = h["num_attention_heads"] * D, h["num_key_value_heads"] * D
    v = h["vision_config"]
    E, C, tps, ps = v["embed_dim"], v["in_chans"], v["temporal_patch_size"], v["patch_size"]
    VI, merged = int(E * v["mlp_ratio"]), E * v["spatial_merge_size"] ** 2

    def tensors():
        yield "model.embed_tokens.weight", normal(V, H)
        for i in range(L):
            p = f"model.layers.{i}."
            yield p + "input_layernorm.weight", const(1, H)
            yield p + "post_attention_layernorm.weight", const(1, H)
            for name, rows in (("q_proj", q), ("k_proj", kv), ("v_proj", kv)):
                yield p + f"self_attn.{name}.weight", normal(rows, H)
                yield p + f"self_attn.{name}.bias", const(0, rows)
            yield p + "self_attn.o_proj.weight", normal(H, q)
            yield p + "mlp.gate_proj.weight", normal(I, H)
            yield p + "mlp.up_proj.weight", normal(I, H)
            yield p + "mlp.down_proj.weight", normal(H, I)
        yield "model.norm.weight", const(1, H)
        if not h["tie_word_embeddings"]:
            yield "lm_head.weight", normal(V, H)
        yield "visual.patch_embed.proj.weight", normal(E, C, tps, ps, ps)
        for i in range(v["depth"]):
            p = f"visual.blocks.{i}."
            for norm in ("norm1", "norm2"):
                yield p + f"{norm}.weight", const(1, E)
                yield p + f"{norm}.bias", const(0, E)
            for name, (rows, cols) in (("attn.qkv", (3 * E, E)), ("attn.proj", (E, E)),
                                       ("mlp.fc1", (VI, E)), ("mlp.fc2", (E, VI))):
                yield p + f"{name}.weight", normal(rows, cols)
                yield p + f"{name}.bias", const(0, rows)
        yield "visual.merger.ln_q.weight", const(1, E)
        yield "visual.merger.ln_q.bias", const(0, E)
        yield "visual.merger.mlp.0.weight", normal(merged, merged)
        yield "visual.merger.mlp.0.bias", const(0, merged)
        yield "visual.merger.mlp.2.weight", normal(v["hidden_size"], merged)
        yield "visual.merger.mlp.2.bias", const(0, v["hidden_size"])

    nbytes = 0

    def counted():
        nonlocal nbytes
        for name, t in tensors():
            nbytes += t.nbytes
            yield name, t

    Path(path).mkdir(parents=True, exist_ok=True)
    save_sharded(counted(), path)
    with open(Path(path) / "config.json", "w") as f:
        json.dump(hf_config, f)
    return nbytes / 1e9


def vit_kernel_against_dense(config, params, u8, grid, img_cfg, dev):
    """One sample's tower on the segmented kernel (the serving route) and on
    dense attention (use_flash=False), from the same patches: the max-abs
    and mean-abs difference, and the output's largest and mean |value|."""
    import torch
    from socioreasoner_tpu_torch.models.qwen2_5_vl import vision as V
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    vc = config.vision
    mean = torch.as_tensor(np.asarray(img_cfg.image_mean, np.float32))
    std = torch.as_tensor(np.asarray(img_cfg.image_std, np.float32))
    patches = torch.cat([V.patchify_device(torch.tensor(np.asarray(a, np.uint8)), mean, std,
                                           img_cfg.patch_size, img_cfg.merge_size,
                                           img_cfg.temporal_patch_size) for a in u8])
    prep = V.vision_host_inputs(vc, patches.numpy(), np.asarray(grid))
    wseg, fseg = prep["window_seg"], prep["full_seg"]
    bq, bk = fa.seg_block_sizes(len(wseg))
    span = max(fa.seg_max_span_blocks(wseg, bq, bk), fa.seg_max_span_blocks(fseg, bq, bk))
    dtype = params["vision"]["patch_embed_w"].dtype
    args = (torch.as_tensor(prep["patches"], device=dev).to(dtype),
            torch.as_tensor(prep["cos"], device=dev), torch.as_tensor(prep["sin"], device=dev),
            torch.as_tensor(wseg), torch.as_tensor(fseg), prep["is_full_layer"])
    f32 = {k: {b: w.float() for b, w in v.items()} if isinstance(v, dict) else v.float()
           for k, v in params["vision"].items()}
    with torch.no_grad():
        kern = V.vision_tower(vc, params["vision"], *args, use_flash=True,
                              max_span_blocks=span).float()
        dense = V.vision_tower(vc, params["vision"], *args, use_flash=False).float()
        # the same weights in f32 on dense attention: how far bf16 rounding
        # alone carries the tower
        exact = V.vision_tower(vc, f32, args[0].float(), *args[1:], use_flash=False)
    diff = (kern - dense).abs()
    return {"S": len(wseg), "full_layers": int(np.sum(prep["is_full_layer"])),
            "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
            "max_abs": dense.abs().max().item(), "mean_abs": dense.abs().mean().item(),
            "kernel_vs_f32_max_abs": (kern - exact).abs().max().item(),
            "dense_vs_f32_max_abs": (dense - exact).abs().max().item()}


def run_qwen2_vl(ckpt_dir, dev, *, img_cfg=None, kernels=(), **main_kw):
    """Qwen2-VL from its HF checkpoint through load_pretrained and
    run_main_path (the strategy's server over stage-1 map+sat tiles; the
    `kernels`' launches counted over it), then the first sample's ViT on the
    kernel against dense attention: within KERNEL_TOL of the output's largest
    |value| where that passes 1 (KERNEL_TOL is bf16 rounding at |out| of a
    few units, and the random tower's merger writes values near 7, where
    one bf16 step is 0.031). Returns (config, outputs, engine, stats)."""
    import torch
    from socioreasoner_tpu_torch.datasets.processor import ImageProcessorConfig
    from socioreasoner_tpu_torch.models.qwen2_5_vl.loader import load_pretrained
    img_cfg = img_cfg or ImageProcessorConfig(defer_patchify=True)
    _sync(dev)
    t0 = time.perf_counter()
    config, params = load_pretrained(ckpt_dir, dtype=torch.bfloat16, device=dev)
    _sync(dev)
    load_s = time.perf_counter() - t0
    if config.vision.variant != "qwen2":
        raise AssertionError(f"{ckpt_dir}: read as the {config.vision.variant} ViT")
    _reset(kernels)
    outs, engine, stats = run_main_path(config, params, dev, img_cfg=img_cfg, **main_kw)
    stats["launches"] = _launch_counts(kernels)
    batch = _stage1_batch(config, 1, main_kw.get("tile_px", 768), img_cfg,
                          main_kw.get("buckets", (2048, 2560))[-1])
    vit = vit_kernel_against_dense(config, params, batch.non_tensor["pixel_u8"][0],
                                   batch.non_tensor["grid_thw"][0], img_cfg, dev)
    stats.update(load_s=load_s, vit_kernel_vs_dense=vit)
    if not vit["max_abs_err"] <= KERNEL_TOL * max(1.0, vit["max_abs"]):
        raise AssertionError(f"Qwen2-VL ViT on the kernel against dense: {vit}")
    del params
    return config, outs, engine, stats


def _family_kernels():
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    return (fa.flash_attention_segmented, fa.flash_attention, da.paged_decode_attention,
            *_train_kernel_fns())


def phase_families():
    """Other model families at full width on the card: (a) Qwen3-30B-A3B at
    full depth served, (b) its width at FAMILY_TRAIN_LAYERS layers trained
    (kernels against dense) and round-tripped through save_pretrained and
    llm.load_text_model, (c) Qwen1.5-MoE-A2.7B at FAMILY_QWEN2_MOE_LAYERS of
    24 layers served, (d) Qwen2-VL-2B-Instruct at full width and depth from
    an HF checkpoint through run_main_path. Each model is freed before the
    next is built; every launch lands on the shapes phase_kernels checked.
    Returns the kernels' launches over the phase."""
    import gc
    import torch
    from socioreasoner_tpu_torch.models import llm
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    kernels = _family_kernels()
    launches = {fn.__name__: 0 for fn in kernels}
    t_phase = time.perf_counter()
    out = {"phase": "families", "card": _smi_line()}

    def add(name, counts):
        out.setdefault("launches", {})[name] = counts
        for k, n in counts.items():
            launches[k] += n

    def counted(name, fn):
        _reset(kernels)
        res = fn()
        add(name, _launch_counts(kernels))
        return res

    def shapes_checked(name, stats, want_buckets, want_cache):
        if stats["prefill_buckets"] != want_buckets or stats["cache"] != want_cache:
            raise AssertionError(f"{name}: prefill {stats['prefill_buckets']} / cache "
                                 f"{stats['cache']} left the checked {want_buckets} / "
                                 f"{want_cache}")

    try:
        # (a) Qwen3-30B-A3B, full width and depth, served
        config = llm.config_from_hf_dict(QWEN3_30B_A3B)
        t0 = time.perf_counter()
        params = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(30),
                                    dtype=torch.bfloat16, device=dev, with_vision=False)
        _sync(dev)
        init_s = time.perf_counter() - t0
        gb = _tree_bytes(params) / 1e9
        stats = counted("qwen3_moe", lambda: serve_family(
            config, params, dev, max_new=FAMILY_MAX_NEW["qwen3_moe"]))
        shapes_checked("qwen3_moe", stats, [(4, FAMILY_BUCKET, 0)],
                       [48, 4, FAMILY_LALLOC, 4, 128])
        # a decode step reads every expert's weights once (all compute every token)
        step_bytes = 2 * sum(v.numel() for k, v in params["layers"].items()) + 2 * (
            params["lm_head"].numel() + params["final_ln"].numel())
        stats["decode_step_bound_ms"] = step_bytes / HBM_BYTES_PER_S * 1e3
        out["qwen3_30b_a3b"] = {"model": "Qwen/Qwen3-30B-A3B, 48 layers, random bf16",
                                "params_gb": gb, "init_s": init_s, **stats,
                                "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # (b) its width at FAMILY_TRAIN_LAYERS layers: two PPO steps, then the
        # checkpoint round trip
        hf_cut = dict(QWEN3_30B_A3B, num_hidden_layers=FAMILY_TRAIN_LAYERS)
        config = llm.config_from_hf_dict(hf_cut)
        params = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(31),
                                    dtype=torch.bfloat16, device=dev, with_vision=False)
        train = counted("qwen3_moe_train", lambda: train_family(config, params, dev))
        with tempfile.TemporaryDirectory() as d:
            write_s, read_s, ckpt_gb = text_model_round_trip(config, params, hf_cut, d, dev)
        out["qwen3_moe_train"] = {"model": f"Qwen3-30B-A3B widths, {FAMILY_TRAIN_LAYERS} of 48 "
                                  "layers, random bf16", "params_gb": _tree_bytes(params) / 1e9,
                                  **train, "save_s": write_s, "load_s": read_s,
                                  "checkpoint_gb": ckpt_gb, "round_trip_bit_equal": True}
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # (c) Qwen1.5-MoE-A2.7B at full width, 8 of 24 layers, served
        config = llm.config_from_hf_dict(dict(QWEN15_MOE_A27B,
                                              num_hidden_layers=FAMILY_QWEN2_MOE_LAYERS))
        params = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(15),
                                    dtype=torch.bfloat16, device=dev, with_vision=False)
        stats = counted("qwen2_moe", lambda: serve_family(
            config, params, dev, max_new=FAMILY_MAX_NEW["qwen2_moe"]))
        shapes_checked("qwen2_moe", stats, [(4, FAMILY_BUCKET, 0)],
                       [FAMILY_QWEN2_MOE_LAYERS, 4, FAMILY_LALLOC, 16, 128])
        out["qwen15_moe_a27b"] = {"model": f"Qwen/Qwen1.5-MoE-A2.7B, {FAMILY_QWEN2_MOE_LAYERS} of "
                                  "24 layers, random bf16", "params_gb": _tree_bytes(params) / 1e9,
                                  **stats}
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # (d) Qwen2-VL-2B-Instruct from an HF checkpoint on disk
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            ckpt_gb = write_qwen2_vl_checkpoint(QWEN2_VL_2B, d, dev)
            write_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
            _, outs, engine, stats = run_qwen2_vl(d, dev, kernels=kernels)
        add("qwen2_vl", stats.pop("launches"))
        stats["prefill_buckets"] = sorted(engine.prefill_hist)
        stats["cache"] = list(engine.caches["k"].shape)
        if stats["prompt_lens"] != [2016] * 4 or any(b[:2] != (4, 2048)
                                                      for b in stats["prefill_buckets"]) \
                or stats["cache"] != [28, 4, MAIN_LALLOC, 2, 128] \
                or stats["vit_kernel_vs_dense"]["S"] != 5832 \
                or stats["vit_kernel_vs_dense"]["full_layers"] != 32:
            raise AssertionError(f"qwen2_vl left the checked shapes: {stats}")
        out["qwen2_vl_2b"] = {"model": "Qwen/Qwen2-VL-2B-Instruct, 28 layers, ViT depth 32, "
                              "random bf16 from an HF checkpoint", "checkpoint_gb": ckpt_gb,
                              "checkpoint_write_s": write_s,
                              **{k: v for k, v in stats.items() if k != "finish"}}
        del engine, outs
        gc.collect()
        torch.cuda.empty_cache()
    except BaseException as e:
        out["error"] = repr(e)[:2000]
        out["launches_total"] = launches
        emit(out)
        raise

    out["launches_total"] = launches
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    missing = [n for n, c in launches.items() if c <= 0]
    if missing or out["max_memory_allocated_gb"] >= 80:
        raise AssertionError(f"families: kernels never launched {missing} or peak "
                             f"{out['max_memory_allocated_gb']} GiB")
    return launches


# ------------------------------------------------------------------ head dims

def written_text_model(hf_config, path, dev, seed):
    """A random bf16 tree of the HF text config `hf_config` written with the
    port's save_pretrained under that config.json and read back through
    llm.load_text_model, as a user loads the checkpoint: (config, the tree
    read back, GB). The read is held to the written tree bit for bit."""
    import torch
    from socioreasoner_tpu_torch.models import llm
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    config = llm.config_from_hf_dict(hf_config)
    params = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(seed),
                                dtype=torch.bfloat16, device=dev, with_vision=False)
    write_s, read_s, gb = text_model_round_trip(config, params, hf_config, path, dev)
    del params
    _free()
    config, params = llm.load_text_model(path, dtype=torch.bfloat16, device=dev)
    return config, params, {"checkpoint_gb": gb, "save_s": write_s, "load_s": read_s}


def regrouped_text_model(hf_config, path, dev, want_sums):
    """The checkpoint at `path` read back through llm.load_text_model under
    the config.json `hf_config` (another head split of the same projection
    shapes), as a user loads a regrouped model: (config, tree, figures). The
    tree's checksums are held to `want_sums`, those of the tree the shards
    were read back as before."""
    import torch
    from socioreasoner_tpu_torch.models import llm
    t0 = time.perf_counter()
    with open(Path(path) / "config.json", "w") as f:
        json.dump(hf_config, f)
    config, params = llm.load_text_model(str(path), dtype=torch.bfloat16, device=dev)
    _sync(dev)
    sums = tree_checksums(params)
    if sums != want_sums:
        raise AssertionError(f"regrouped read differs: "
                             f"{sorted(k for k in want_sums if sums.get(k) != want_sums[k])[:8]}")
    return config, params, {"checkpoint_gb": _tree_bytes(params) / 1e9, "save_s": 0.0,
                            "load_s": time.perf_counter() - t0}


def _cut_layers(config, params, layers: int):
    """The first `layers` layers of a text tree (views, no copy) and its
    config."""
    import dataclasses
    cut = dataclasses.replace(config, text=dataclasses.replace(config.text,
                                                               num_hidden_layers=layers))
    return cut, {**params, "layers": {k: v[:layers] for k, v in params["layers"].items()}}


def run_head_dim_model(name, dev, work_dir, *, kernels=(), serve_kw=None, train_kw=None):
    """One HEAD_DIM_MODELS entry on `dev`: its checkpoint written and read
    back (written_text_model) at the larger of its served and trained
    depths; served at its served depth
    (serve_family with forced_ties: greedy against the dense forward, the
    tie bound measured by teacher-forcing the engine; the random logits of
    these widths pass GAP_TOL's bf16 resolution), served again with the
    int8 KV cache at HEAD_DIM_INT8_LAYERS where named, and trained at its
    trained depth (the first layers of the same tree: train_family, kernels
    against dense attention), each pass's launches of `kernels` counted. A
    model that HEAD_DIM_REGROUPED regroups keeps its checkpoint (and its
    checksums) for the regrouping, which reads the same shards back under
    its own config.json (regrouped_text_model) and removes them.
    Returns the figures."""
    hf, source, serve_layers, train_layers = HEAD_DIM_MODELS[name]
    H, Hkv, D = _heads(hf)
    layers = max(n for n in (serve_layers, train_layers) if n)
    cut = dict(hf, num_hidden_layers=layers)
    if name in HEAD_DIM_REGROUPED:
        path = Path(work_dir) / HEAD_DIM_REGROUPED[name]
        with open(path / "sums.json") as f:
            want = json.load(f)
        config, params, io = regrouped_text_model(cut, path, dev, want)
        io["read_from"] = HEAD_DIM_REGROUPED[name]
        shutil.rmtree(path)
    else:
        path = Path(work_dir) / name
        config, params, io = written_text_model(cut, str(path), dev, seed=len(name))
        if name in HEAD_DIM_REGROUPED.values():
            with open(path / "sums.json", "w") as f:
                json.dump(tree_checksums(params), f)
        else:
            shutil.rmtree(path)
    out = {"model": f"{source}, {layers} of {hf['num_hidden_layers']} layers, {H}/{Hkv} "
                    f"heads x {D}, random bf16", "params_gb": _tree_bytes(params) / 1e9, **io}
    if serve_layers:
        c, p = _cut_layers(config, params, serve_layers)
        _reset(kernels)
        out["serve"] = serve_family(c, p, dev, forced_ties=True, **(serve_kw or {}))
        out["serve"]["launches"] = _launch_counts(kernels)
    if name in HEAD_DIM_INT8_LAYERS:
        c, p = _cut_layers(config, params, HEAD_DIM_INT8_LAYERS[name])
        _reset(kernels)
        out["serve_int8_kv"] = serve_family(c, p, dev, forced_ties=True,
                                            engine_extra={"kv_quant": "int8"},
                                            **(serve_kw or {}))
        out["serve_int8_kv"]["launches"] = _launch_counts(kernels)
    if train_layers:
        c, p = _cut_layers(config, params, train_layers)
        _reset(kernels)
        out["train"] = train_family(c, p, dev, **(train_kw or {}))
        out["train"]["launches"] = _launch_counts(kernels)
    del params
    _free()
    return out


def phase_head_dims():
    """Kernels 2-6 at head dims other than 64 and 128, through the models
    that use them, at full width from their published configs, each from a
    checkpoint written and read back through llm.load_text_model
    (run_head_dim_model): H2O-Danube3-4B (120, rep 4) served at 24 layers
    and trained at FAMILY_TRAIN_LAYERS, Danube3-500M (96, rep 2) served and
    trained at 16, Danube2-1.8B (80, rep 4) trained at FAMILY_TRAIN_LAYERS,
    OpenLLaMA-3B v2 (100, rep 1, the host pad) served at
    FAMILY_TRAIN_LAYERS, Falcon3-7B (256, rep 3) served at 28 layers, at
    FAMILY_TRAIN_LAYERS with the int8 KV cache, and trained at
    FAMILY_TRAIN_LAYERS; its 6/2 x 512 regrouping (rep 3, read back from
    Falcon3's shards) the same, its 8/2 x 384 one (rep 4) served and
    trained at FAMILY_TRAIN_LAYERS: head dims above 256, which the kernels
    run in column slices (regroupings of a published config, not published
    checkpoints). Kernel 2 must launch in every served pass and kernels 4-6
    in every trained one, at the shapes phase_kernels checked; kernel 3 (3q
    with the int8 cache) in every served pass of a head dim that is a
    multiple of 128 and never in the others (they decode densely, as in the
    JAX package); kernels 2, 3, 3q and 4-6 at a head dim above 256. Peak <
    80 GiB. Returns the launches over the phase, Falcon3-7B's alone and
    those at head dims above 256."""
    import gc
    import torch
    from socioreasoner_tpu_torch.ops import decode_attention as da
    dev = torch.device("cuda")
    kernels = (*_family_kernels(), da.paged_decode_attention_int8)
    names = [k.__name__ for k in kernels]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    out = {"phase": "head_dims", "card": _smi_line()}
    left = []
    try:
        with tempfile.TemporaryDirectory() as work_dir:
            for name, (hf, _, serve_layers, train_layers) in HEAD_DIM_MODELS.items():
                t0 = time.perf_counter()
                fig = run_head_dim_model(name, dev, work_dir, kernels=kernels)
                fig["wall_s"] = time.perf_counter() - t0
                out[name] = fig
                _, Hkv, D = _heads(hf)
                for p, n in (("serve", serve_layers),
                             ("serve_int8_kv", HEAD_DIM_INT8_LAYERS.get(name))):
                    if n and (fig[p]["prefill_buckets"] != [(4, FAMILY_BUCKET, 0)]
                              or fig[p]["cache"] != [n, 4, FAMILY_LALLOC, Hkv, D]):
                        left.append((name, p, fig[p]["prefill_buckets"], fig[p]["cache"]))
                emit({"phase": f"head_dims_{name}", **fig})
    except BaseException as e:
        out["error"] = repr(e)[:2000]
        emit(out)
        raise
    passes = {f"{name}_{p}": out[name][p]["launches"] for name in HEAD_DIM_MODELS
              for p in ("serve", "serve_int8_kv", "train") if p in out[name]}
    launches = {k: sum(c[k] for c in passes.values()) for k in names}

    def model_launches(models):
        return {k: sum(out[m][p]["launches"][k] for m in models
                       for p in ("serve", "serve_int8_kv", "train") if p in out[m])
                for k in names}
    falcon = model_launches(["falcon3_7b"])
    wide = model_launches([n for n, (hf, *_) in HEAD_DIM_MODELS.items() if _heads(hf)[2] > 256])
    out["launches"] = passes
    out["launches_total"] = launches
    out["launches_falcon3_7b"] = falcon
    out["launches_wide"] = wide
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    emit({k: v for k, v in out.items() if k not in HEAD_DIM_MODELS})
    paged = {f"{name}_{p}": (_heads(HEAD_DIM_MODELS[name][0])[2] % 128 == 0,
                             "paged_decode_attention_int8" if p == "serve_int8_kv"
                             else "paged_decode_attention")
             for name in HEAD_DIM_MODELS for p in ("serve", "serve_int8_kv")}
    missing = ([f"{p}:flash_attention" for p, c in passes.items()
                if p in paged and c["flash_attention"] <= 0]
               + [f"{p}:{k}" for p, c in passes.items() if p.endswith("_train")
                  for k in names[3:6] if c[k] <= 0]
               # the decode kernel where the head dim is a multiple of 128,
               # the matching one of 3 and 3q only, and neither elsewhere
               + [f"{p}:{k}" for p, c in passes.items() for k in names
                  if k.startswith("paged_decode") and (c[k] > 0) != (
                      p in paged and paged[p][0] and paged[p][1] == k)]
               + [f"falcon3_7b:{k}" for k in names if k != "flash_attention_segmented"
                  and falcon[k] <= 0]
               + [f"above 256:{k}" for k in names if k != "flash_attention_segmented"
                  and wide[k] <= 0])
    if missing or left or not out["max_memory_allocated_gb"] < 80:
        raise AssertionError(f"head_dims: kernels off the path (or the decode kernel off "
                             f"its head dims) {missing}, unchecked shapes {left}, peak "
                             f"{out['max_memory_allocated_gb']} GiB")
    return launches, falcon, wide


# ------------------------------------------------------------------ agentic

QWEN25_05B_INSTRUCT = {   # Qwen/Qwen2.5-0.5B-Instruct
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2", "vocab_size": 151936,
    "hidden_size": 896, "intermediate_size": 4864, "num_hidden_layers": 24,
    "num_attention_heads": 14, "num_key_value_heads": 2, "max_position_embeddings": 32768,
    "max_window_layers": 21, "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
    "sliding_window": 32768, "use_sliding_window": False, "tie_word_embeddings": True,
    "bos_token_id": 151643, "eos_token_id": 151645, "hidden_act": "silu",
    "torch_dtype": "bfloat16"}
# the metric keys each agentic pipeline logs a step, as the JAX package's
AGENTIC_VLM_KEYS = (
    "val/score/mean", "val/score/max", "val/score/min", "critic/ref_log_prob/mean",
    "critic/old_log_prob/mean", "critic/entropy/mean", "critic/kl", "critic/score/mean",
    "critic/score/max", "critic/score/min", "critic/penalty/mean", "agentic/solved_rate",
    "tokens/response_length/mean", "tokens/prompt_length/mean", "system/samples",
    "time/rollout", "time/ref_log_probs", "time/old_log_probs_values", "time/adv",
    "time/train", "time/step", "actor_train/grad_norm", "actor_train/loss",
    "actor_train/pg_loss", "actor_train/entropy")
AGENTIC_TEXT_KEYS = ("agentic/return_mean", "agentic/solved_rate", "time/rollout",
                     "time/train", "time/step", "critic/kl", "actor_train/grad_norm",
                     "actor_train/loss", "actor_train/pg_loss", "actor_train/entropy")
AGENTIC_TIMERS = ("step", "rollout", "ref_log_probs", "old_log_probs_values", "adv", "train")


def agentic_vlm_config(out_dir: str, **cuts):
    """AgenticConfig of the agentic phase's VLM run: grid_goal in
    env_groups x group_size envs (one seed a group), mean_std over state,
    an adaptive KL controller, a small entropy bonus (random weights score
    every episode of a group alike, so the normalised rewards are 0), lr
    STEP_LR."""
    from socioreasoner_tpu_torch.configs.agentic_config import (
        AgenticConfig, EnvManagerConfig, RewardNormalizationConfig)
    c = dict(AGENTIC_VLM_CUTS, **cuts)
    cfg = AgenticConfig(
        output_dir=out_dir, track_with="stdout", save_steps=-1, seed=7,
        rollout_batch_size=c["env_groups"] * c["group_size"],
        prompt_length=c["prompt_length"], response_length=c["response_length"],
        max_steps=c["max_steps"], eval_steps=c["eval_steps"],
        max_steps_per_traj=c["max_steps_per_traj"], val_batch_size=c["val_batch_size"],
        adv_estimator="grpo", entropy_loss_coef=1e-3, init_kl_coef=0.05, target_kl=0.1,
        reward_normalization=RewardNormalizationConfig(grouping="state", method="mean_std"),
        train_env_manager=EnvManagerConfig(env_groups=c["env_groups"],
                                           group_size=c["group_size"], tags=["grid_goal"]),
        val_env_manager=EnvManagerConfig(env_groups=c["val_batch_size"], tags=["grid_goal"]))
    ga = cfg.actor_infer.generating_args
    ga.max_new_tokens = c["response_length"]
    if c.get("temperature") is not None:      # 0: greedy
        ga.temperature, ga.do_sample = c["temperature"], c["temperature"] > 0
    cfg.actor_train.training_args.learning_rate = STEP_LR
    return cfg


def _agentic_recorder(pipe):
    """Record every train and log-prob batch's (B, L, kv lengths) at the
    strategies' step functions."""
    seen = {"train": [], "logprob": []}

    def record(kind, step_fn):
        def wrapped(*args):
            batch = args[-1]
            lens = batch["attention_mask"].sum(-1).tolist()
            seen[kind].append((*batch["input_ids"].shape, tuple(int(n) for n in lens)))
            return step_fn(*args)
        return wrapped
    pipe.actor_train._train_step = record("train", pipe.actor_train._train_step)
    for strat in (pipe.actor_train, getattr(pipe, "reference", None)):
        if strat is not None:
            strat._logprob_step = record("logprob", strat._logprob_step)
    return seen


def _episode_checks(group, sampled):
    """Wrap a rollout group's get_batch: each request's sampled ids recorded
    by env, then each episode's response_mask held to cover exactly the
    engine's sampled ids less the vision special ids, its count of those
    dropped to their number among the sampled ids, and its image rows and
    image tokens to 16 a 112² frame (merged 8 x 8 patches). Returns the
    list the episodes are appended to."""
    from socioreasoner_tpu_torch.pipeline.agentic.environment_worker import vision_token_ids
    episodes = []
    plain_get, plain_req = group.get_batch, group.scheduler.generate_one_request
    vision = vision_token_ids(group.processor)
    image_id = group.model_config.image_token_id

    def generate_one_request(req):
        out = plain_req(req)
        if out is not None:
            sampled.setdefault(req.meta["src_rank"], []).extend(out.meta["output_token_ids"][0])
        return out

    def get_batch(*a, **k):
        sampled.clear()
        eps = plain_get(*a, **k)
        for ep in eps:
            got = ep.input_ids[ep.response_mask == 1].tolist()
            ids = sampled.get(ep.env_id, [])
            kept = [t for t in ids if t not in vision]
            if got != kept or not ids or ep.vision_ids_dropped != len(ids) - len(kept):
                raise AssertionError(f"env {ep.env_id}: response_mask covers {len(got)} ids, "
                                     f"the engine sampled {len(ids)}, {len(ids) - len(kept)} "
                                     f"of them vision ids ({ep.vision_ids_dropped} dropped)")
            grids = np.asarray(ep.image_grid_thw)
            tokens = int((ep.input_ids == image_id).sum())
            if (grids != np.array(AGENTIC_GRID)).any() or len(grids) != len(ep.frames) or \
                    not ep.image_embeds.shape[0] == tokens == 16 * len(grids):
                raise AssertionError(f"env {ep.env_id}: {len(grids)} frames, grids {grids}, "
                                     f"{ep.image_embeds.shape[0]} embed rows, {tokens} image "
                                     "tokens")
        episodes.extend(eps)
        return eps
    group.scheduler.generate_one_request = generate_one_request
    group.get_batch = get_batch
    return episodes


def _finite_keys(name, metrics, keys):
    missing = [k for k in keys if k not in metrics]
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if missing or bad:
        raise AssertionError(f"{name}: metrics missing {missing}, not finite {bad}")


def run_agentic_vlm(config, params, out_dir, dev, *, kernels=(), processor=None,
                    buckets=AGENTIC_BUCKETS, decode_chunk=AGENTIC_DECODE_CHUNK, **cuts):
    """(a) AgenticVLMPipeline.run() on grid_goal (agentic_vlm_config), the
    policy a copy of `params`, `params` itself the frozen reference (its
    checksums must not move); each episode's response mask held to the
    engine's sampled ids and its image rows to its frames (_episode_checks);
    then one step of AgenticRolloutPipeline over `params`. Returns the
    figures: metrics per step, timers, episodes, launches of `kernels` in
    each pipeline, the engine's prefill buckets and cache, the train and
    log-prob batches, a profiled decode chunk of the train engine."""
    from socioreasoner_tpu_torch.pipeline.agentic.agentic_vlm_pipeline import (
        AgenticRolloutPipeline, AgenticVLMPipeline)
    processor = processor or _processor(config, None)
    cfg = agentic_vlm_config(out_dir, **cuts)
    engine_kwargs = {"max_slots": AGENTIC_SLOTS, "max_len": cfg.sequence_length,
                     "decode_chunk": decode_chunk, "prefill_buckets": tuple(buckets),
                     "device": dev}
    want = tree_checksums(params)
    pipe = AgenticVLMPipeline(cfg, model_config=config, policy_params=_clone(params),
                              reference_params=params, processor=processor,
                              engine_kwargs=engine_kwargs)
    sampled, shapes = {}, _agentic_recorder(pipe)
    train_eps = _episode_checks(pipe.train_rollout, sampled)
    val_eps = _episode_checks(pipe.val_rollout, sampled)
    kl_before = pipe.kl_ctrl.value
    _reset(kernels)
    _sync(dev)
    t0 = time.perf_counter()
    last = pipe.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _launch_counts(kernels)
    history = pipe.state.log_history
    for h in history:
        _finite_keys("agentic_vlm", {k: v for k, v in h.items() if k != "step"},
                     AGENTIC_VLM_KEYS)
    if tree_checksums(params) != want:
        raise AssertionError("the agentic phase moved the reference tree")
    engine = pipe.actor_infer.engine
    fig = {"wall_s": wall, "steps": len(history),
           "step_wall_s": [h["time/step"] for h in history],
           "timers_s": [{k: h.get(f"time/{k}") for k in AGENTIC_TIMERS} for h in history],
           "metrics": last, "kl_coef": [kl_before, pipe.kl_ctrl.value],
           "episodes": [{"env": e.env_id, "group": e.group_id, "turns": e.turns,
                         "tokens": len(e.input_ids), "action_tokens": int(e.response_mask.sum()),
                         "frames": len(e.frames), "embed_rows": int(e.image_embeds.shape[0]),
                         "score": e.score, "vision_ids_dropped": e.vision_ids_dropped}
                        for e in train_eps],
           "val_episodes": len(val_eps),
           "prefill_buckets": sorted({(key[0], key[1]) for key in engine.prefill_hist}),
           "cache": list(engine.caches["k"].shape), "engine_steps": engine.steps_executed,
           "forked_requests": engine.forked_requests,
           "train_shapes": shapes["train"], "logprob_shapes": shapes["logprob"],
           "launches": launches}
    fig["decode_profile"] = profile_decode_chunk(engine, dev, [176, 211, 262, 347][:engine.S])
    del pipe, engine

    rollout = AgenticRolloutPipeline(agentic_vlm_config(out_dir, **dict(cuts, max_steps=1)),
                                     model_config=config, policy_params=params,
                                     processor=processor, engine_kwargs=engine_kwargs)
    rollout_eps = _episode_checks(rollout.rollout, sampled)
    _reset(kernels)
    t0 = time.perf_counter()
    rmetrics = rollout.run()
    _sync(dev)
    _finite_keys("agentic_rollout", rmetrics, ("rollout/score/mean", "rollout/score/max",
                                               "rollout/score/min", "system/samples"))
    # sampled vision special ids left out of the actions (EnvManager), in
    # every episode of both pipelines: the train steps', validation's and
    # the rollout-only step's
    fig["vision_ids_dropped"] = sum(e.vision_ids_dropped
                                    for e in train_eps + val_eps + rollout_eps)
    fig["rollout_pipeline"] = {
        "wall_s": time.perf_counter() - t0, "metrics": rmetrics, "episodes": len(rollout_eps),
        "prefill_buckets": sorted({(key[0], key[1])
                                   for key in rollout.actor_infer.engine.prefill_hist}),
        "cache": list(rollout.actor_infer.engine.caches["k"].shape),
        "launches": _launch_counts(kernels)}
    return fig


def run_agentic_text(config, params, dev, *, kernels=(), processor=None,
                     buckets=AGENTIC_TEXT_BUCKETS, decode_chunk=AGENTIC_DECODE_CHUNK, **cuts):
    """(b) AgenticPipeline.run() on guess_number 0-9 for the model `config`
    (AGENTIC_TEXT_CUTS: episodes a step, turns of the loop and of the env,
    new tokens), the policy a copy of `params`, `params` the frozen
    reference (checksums unmoved). Returns the figures, with the launches of
    `kernels`, the engine's prefill buckets and cache and the train batches."""
    from socioreasoner_tpu_torch.configs.rlvr_config import RLVRConfig
    from socioreasoner_tpu_torch.datasets.processor import SimpleTokenizer, SocioProcessor
    from socioreasoner_tpu_torch.pipeline.agentic.agentic_pipeline import AgenticPipeline
    c = dict(AGENTIC_TEXT_CUTS, **cuts)
    processor = processor or SocioProcessor(SimpleTokenizer(config.text.vocab_size),
                                            image_token_id=config.image_token_id)
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = RLVRConfig(output_dir=out_dir, track_with="stdout", save_steps=-1, seed=7,
                         rollout_batch_size=c["episodes"], prompt_length=c["prompt_length"],
                         response_length=c["response_length"], max_steps=c["max_steps"],
                         entropy_loss_coef=1e-3, extra_fields={"max_turns": c["max_turns"]})
        cfg.actor_infer.generating_args.max_new_tokens = c["response_length"]
        cfg.actor_train.training_args.learning_rate = STEP_LR
        want = tree_checksums(params)
        pipe = AgenticPipeline(
            cfg, model_config=config, policy_params=_clone(params), reference_params=params,
            processor=processor, env_name="guess_number",
            env_kwargs={"low": 0, "high": 9, "max_turns": c["max_turns"]},
            engine_kwargs={"max_slots": AGENTIC_SLOTS, "max_len": cfg.sequence_length,
                           "decode_chunk": decode_chunk, "prefill_buckets": tuple(buckets),
                           "device": dev})
        shapes = _agentic_recorder(pipe)
        _reset(kernels)
        _sync(dev)
        t0 = time.perf_counter()
        last = pipe.run()
        _sync(dev)
        wall = time.perf_counter() - t0
    launches = _launch_counts(kernels)
    history = pipe.state.log_history
    for h in history:
        _finite_keys("agentic_text", {k: v for k, v in h.items() if k != "step"},
                     AGENTIC_TEXT_KEYS)
    if tree_checksums(params) != want:
        raise AssertionError("the agentic text pipeline moved the reference tree")
    engine = pipe.actor_infer.engine
    return {"wall_s": wall, "steps": len(history),
            "step_wall_s": [h["time/step"] for h in history],
            "timers_s": [{k: h.get(f"time/{k}") for k in ("step", "rollout", "train")}
                         for h in history],
            "metrics": last, "prefill_buckets": sorted({(key[0], key[1])
                                                        for key in engine.prefill_hist}),
            "cache": list(engine.caches["k"].shape), "engine_steps": engine.steps_executed,
            "decode_ms_per_step": engine.decode_time * 1e3 / max(engine.steps_executed, 1),
            "train_shapes": shapes["train"], "logprob_shapes": shapes["logprob"],
            "launches": launches}


def _recheck_train_shapes(randn, shapes, H, Hkv, D):
    """Kernels 4-6 at each train batch a pass ran ((B, L, kv lengths), with
    its data-dependent L), against their plain versions row by row
    (_phase_train_kernels); returns the largest row ratio of each kernel."""
    worst = [0.0, 0.0, 0.0]
    for B, L, lens in sorted(set(shapes)):
        spec = {"L": L, "train_batch": B, "logprob_batch": B, "lens": lens, "H": H,
                "Hkv": Hkv, "D": D}
        for i, cases in enumerate(_phase_train_kernels(randn, spec)):
            worst[i] = max([worst[i]] + [c["ratio"] for c in cases.values()])
    return worst


def phase_agentic(config, params):
    """The agentic slice at full width on the card. (a) AgenticVLMPipeline
    on the main phase's Qwen2.5-VL-3B tree (run_agentic_vlm: 2 steps and a
    validation, then a rollout-only step; kernels 1-6 must launch). (b)
    Qwen2.5-0.5B-Instruct (head dim 64) at full width and depth from its
    published config: its engine greedy against a teacher-forced dense
    forward (serve_family), one PPO step with kernels 4-6 against dense
    attention (train_family), then AgenticPipeline (run_agentic_text);
    kernels 2 and 4-6 must launch, kernel 3 never (head dim 64 decodes
    densely, as in the JAX package). Every pass at the shapes the kernels
    phase checked (the episode batches, whose length the episodes decide,
    are checked again after the run at the rows they had). Peak < 80 GiB.
    Returns the launches over the phase."""
    import gc
    import torch
    from socioreasoner_tpu_torch.models import llm
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    kernels = (fa.flash_attention_segmented, fa.flash_attention, da.paged_decode_attention,
               *_train_kernel_fns())
    names = [k.__name__ for k in kernels]
    gen = torch.Generator(device=dev).manual_seed(14)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    out = {"phase": "agentic", "card": _smi_line(), "cuts": {"vlm": AGENTIC_VLM_CUTS,
                                                             "text": AGENTIC_TEXT_CUTS}}
    try:
        with tempfile.TemporaryDirectory() as d:
            vlm = run_agentic_vlm(config, params, d, dev, kernels=kernels)
        out["vlm"] = vlm
        left = ([b for b in vlm["prefill_buckets"] + vlm["rollout_pipeline"]["prefill_buckets"]
                 if tuple(b) not in AGENTIC_PREFILL]
                + [c for c in (vlm["cache"], vlm["rollout_pipeline"]["cache"])
                   if c != [36, AGENTIC_SLOTS, AGENTIC_LALLOC, 2, 128]])
        if left:
            raise AssertionError(f"agentic VLM left the checked shapes: {left}")
        out["vlm_train_recheck_row_ratio"] = _recheck_train_shapes(
            randn, vlm["train_shapes"] + vlm["logprob_shapes"], 16, 2, 128)
        gc.collect()
        torch.cuda.empty_cache()

        cfg05 = llm.config_from_hf_dict(QWEN25_05B_INSTRUCT)
        t0 = time.perf_counter()
        p05 = qmodel.init_params(cfg05, torch.Generator(device=dev).manual_seed(5),
                                 dtype=torch.bfloat16, device=dev, with_vision=False)
        _sync(dev)
        text = {"model": "Qwen/Qwen2.5-0.5B-Instruct, 24 layers, 14/2 heads x 64, random bf16",
                "params_gb": _tree_bytes(p05) / 1e9, "init_s": time.perf_counter() - t0}
        _reset(kernels)
        text["serve"] = serve_family(cfg05, p05, dev, max_new=32)
        text["serve"]["launches"] = _launch_counts(kernels)
        if text["serve"]["prefill_buckets"] != [(4, FAMILY_BUCKET, 0)] or \
                text["serve"]["cache"] != [24, 4, FAMILY_LALLOC, 2, 64]:
            raise AssertionError(f"Qwen2.5-0.5B serving left the checked shapes: "
                                 f"{text['serve']['prefill_buckets']} {text['serve']['cache']}")
        _reset(kernels)
        text["train_parity"] = train_family(cfg05, p05, dev, steps=1)
        text["train_parity"]["launches"] = _launch_counts(kernels)
        text["pipeline"] = run_agentic_text(cfg05, p05, dev, kernels=kernels)
        pipe = text["pipeline"]
        left = ([b for b in pipe["prefill_buckets"] if tuple(b) not in AGENTIC_TEXT_PREFILL]
                + ([] if pipe["cache"] == [24, AGENTIC_SLOTS, AGENTIC_TEXT_LALLOC, 2, 64]
                   else [pipe["cache"]])
                + [s[:2] for s in pipe["train_shapes"] + pipe["logprob_shapes"]
                   if s[:2] != (AGENTIC_TEXT_TRAIN["train_batch"], AGENTIC_TEXT_TRAIN["L"])])
        if left:
            raise AssertionError(f"agentic text left the checked shapes: {left}")
        text["train_recheck_row_ratio"] = _recheck_train_shapes(
            randn, pipe["train_shapes"] + pipe["logprob_shapes"], 14, 2, 64)
        out["text"] = text
        del p05
    except BaseException as e:
        out["error"] = repr(e)[:2000]
        emit(out)
        raise
    parts = {"vlm": out["vlm"]["launches"], "vlm_rollout": out["vlm"]["rollout_pipeline"]["launches"],
             "text_serve": text["serve"]["launches"],
             "text_train_parity": text["train_parity"]["launches"],
             "text_pipeline": text["pipeline"]["launches"]}
    launches = {k: sum(p[k] for p in parts.values()) for k in names}
    out["launches"] = parts
    out["launches_total"] = launches
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    v, t = out["vlm"], out["text"]
    emit({"phase": "agentic_figures", "card": _smi_line(), "phase_s": out["phase_s"],
          "max_memory_allocated_gb": out["max_memory_allocated_gb"],
          "vlm_step_wall_s": v["step_wall_s"], "vlm_timers_s": v["timers_s"],
          "vlm_decode_profile": {k: v["decode_profile"][k] for k in (
              "ms_per_step", "device_ms_per_step", "busy_share", "kernel_launches_per_step")},
          "rollout_pipeline_s": v["rollout_pipeline"]["wall_s"],
          "text_step_wall_s": t["pipeline"]["step_wall_s"],
          "text_timers_s": t["pipeline"]["timers_s"],
          "text_decode_ms_per_step": t["pipeline"]["decode_ms_per_step"],
          "greedy_tie_flips": len(t["serve"]["tie_flips"]),
          "greedy_checked_tokens": t["serve"]["checked_tokens"],
          "train_parity": {k: t["train_parity"][k] for k in ("kernels", "dense")},
          "logprobs_at_init_bounds": t["train_parity"]["logprobs_at_init_bounds"],
          "vision_ids_dropped": v["vision_ids_dropped"],
          "launches": parts})
    missing = ([f"vlm:{k}" for k in names if parts["vlm"][k] <= 0]
               + [f"text:{k}" for k in names[1:2] + names[3:]
                  if parts["text_pipeline"][k] <= 0]
               + [f"{p}:paged_decode_attention" for p in ("text_serve", "text_train_parity",
                                                          "text_pipeline")
                  if parts[p]["paged_decode_attention"] != 0])
    if missing or not out["max_memory_allocated_gb"] < 80:
        raise AssertionError(f"agentic: kernels off the path (or kernel 3 at head dim 64) "
                             f"{missing}, peak {out['max_memory_allocated_gb']} GiB")
    return launches


# ------------------------------------------------------------ train mesh

# The train_mesh phase: the train plane over several "devices" that are the
# one card listed several times (the sharded code, not multi-GPU speed), at
# Qwen2.5-VL-3B's text widths cut to TRAIN_MESH_LAYERS layers, full vocab.
TRAIN_MESH_LAYERS = 4
TRAIN_MESH_L = GRPO_TRAIN["L"]
TRAIN_MESH_LENS = (2219, 2080, 2150)   # the grpo phase's rows; 3 rows: a pad row runs
TRAIN_MESH_SEED = 16
TRAIN_MESH_LR = 1e-5
TRAIN_MESH_MESHES = {"fsdp2": {"fsdp": 2}, "fsdp2_tp2": {"fsdp": 2, "tp": 2}}
TRAIN_MESH_PROCESSES = {"dp": 2, "tp": 2}   # (d): dp over two processes, tp 2 in each
# (a)'s limits, sharded against unsharded in bf16. Sharding rounds the
# row-parallel partial products to bf16 before their sum (the parallel
# phase's tp engine moved the logits by 0.15-0.21 over 36 layers on an H100
# 80GB HBM3 at 700 W, TP_DELTA_LIMIT) and cuBLAS
# may pick other kernels for a rank's fewer rows; log-probs move by a
# fraction of that over 4 layers, the PPO loss and ratio mean average the
# moves over ~6,000 response tokens, and Adam moves an element by at most
# ~1.5 lr a step whatever its gradient.
TRAIN_MESH_LP_MAX = 0.5        # max-abs on a response token's log-prob or entropy
TRAIN_MESH_LP_MEAN = 0.05      # mean-abs over the response tokens
TRAIN_MESH_LOSS_ABS = 1e-2     # the PPO loss (terms of size ~1)
TRAIN_MESH_NORM_REL = 5e-2     # the pre-clip grad norm, relative
TRAIN_MESH_RATIO_ABS = 1e-2    # actor_train/ratio_mean
TRAIN_MESH_PARAM_LRS = 6       # params after 2 steps: |d| <= 6 lr + one bf16 ulp of the leaf's max
TRAIN_MESH_VP_ABS = 1e-3       # vocab-parallel head against the gathered head, same shards
# the log-probs before any step, sharded against unsharded (PERF.md's
# prediction for the seq_pipe phase): the ring attends in f32 from the bf16
# q/k/v and rounds its output once, where kernel 4 rounds its unnormalised
# p; tp 2 sums the row-parallel partials in bf16; pp runs each layer whole
# on two rows at a time, where cuBLAS may pick other kernels
MESH_LP0_MAX = 0.25            # max-abs on a response token's log-prob or entropy
MESH_LP0_MEAN = 0.02           # mean-abs over the response tokens
# the kernels phase's checks of kernels 4-6 at the phase's rank shapes:
# (a) fsdp 2 x tp 2, rank 0's two rows at the shard's 8/1 heads; (c) the
# pipeline's fsdp 2, one row a rank of each train micro-batch of 2 and four
# of each log-prob chunk of 8, at 16/2 heads
TRAIN_MESH_TRAIN = {"L": TRAIN_MESH_L, "train_batch": 2, "logprob_batch": 2,
                    "lens": TRAIN_MESH_LENS[:2], "H": 8, "Hkv": 1}
TRAIN_MESH_PIPELINE_TRAIN = {"L": TRAIN_MESH_L, "train_batch": 1, "logprob_batch": 4,
                             "kv_lens": GRPO_TRAIN["kv_lens"]}


def train_mesh_config(layers: int = TRAIN_MESH_LAYERS, config=None):
    """Qwen25VLConfig() (or `config`) with its text depth cut to `layers`."""
    import dataclasses
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig
    config = config or Qwen25VLConfig()
    return dataclasses.replace(config, text=dataclasses.replace(config.text,
                                                                num_hidden_layers=layers))


def train_mesh_params(config, dev, dtype=None, seed: int = TRAIN_MESH_SEED):
    """The phase's text tree, drawn from a generator seeded with `seed` on
    `dev` (so that each process of (d) draws the same one)."""
    import torch
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    return qmodel.init_params(config, torch.Generator(device=dev).manual_seed(seed),
                              dtype=dtype or torch.bfloat16, device=dev, with_vision=False)


def train_mesh_batch(config, params, dev, lens=TRAIN_MESH_LENS, L=TRAIN_MESH_L, seed=9):
    """parity_batch's GRPO batch as host arrays (old log-probs from the
    unsharded log-prob step on `params`)."""
    batch = parity_batch(config, params, dev, lens, seed=seed, L=L)
    return {k: v.cpu().numpy() for k, v in batch.items()}


@contextlib.contextmanager
def kernel_shapes():
    """Records (kernel, B, L, H, Hkv, kv lengths) of every launch of kernels
    4-6 through the trainable attention, as a Counter filled when the block
    ends (the lengths are read back then, not at each launch; the wrappers'
    own counts are left as they are)."""
    from collections import Counter
    from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb
    seen, raw = Counter(), []
    names = ("flash_attention_fwd_lse", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    plain = {n: getattr(fb, n) for n in names}

    def wrap(name):
        def recorded(q, k, v, *args, **kwargs):
            lens = args[3] if name != "flash_attention_fwd_lse" else args[0]
            raw.append((name, q.shape[0], q.shape[1], q.shape[2], k.shape[2], lens))
            # the wrapper counts its launch on the module's name, this one
            # while it is patched: carry the count across
            recorded.launches = plain[name].launches
            try:
                return plain[name](q, k, v, *args, **kwargs)
            finally:
                plain[name].launches = recorded.launches
        return recorded
    for n in names:
        setattr(fb, n, wrap(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(fb, n, plain[n])
        for *key, lens in raw:
            seen[(*key, tuple(int(x) for x in lens.tolist()))] += 1


def _rank_lens(lens, pad_src: int, ranks: int):
    """Each data rank's kv lengths: the rows padded to a multiple of the
    ranks with copies of row pad_src (0 for a train batch, -1 for a log-prob
    chunk, as the strategies pad)."""
    rows = list(lens) + [lens[pad_src]] * ((-len(lens)) % ranks)
    b = len(rows) // ranks
    return [tuple(rows[r * b:(r + 1) * b]) for r in range(ranks)]


def _expected_launches(seen, lens, L: int, ranks: int, tp: int, H: int, Hkv: int,
                       layers: int, per_layer: dict, pad_src: int):
    """Problems with the recorded launches: every rank's rows at the
    shard's local heads, `per_layer[kernel]` launches a layer and shard."""
    want = {}
    for rank_lens in _rank_lens(lens, pad_src, ranks):
        for name, n in per_layer.items():
            key = (name, len(rank_lens), L, H // tp, Hkv // tp, rank_lens)
            want[key] = want.get(key, 0) + n * layers * tp
    return {"missing_or_off": sorted(str(k) for k in set(want) | set(seen)
                                     if want.get(k, 0) != seen.get(k, 0)),
            "launches": sum(seen.values())}


def run_mesh_strategies(config, params, dev, meshes, batch, *, lr=TRAIN_MESH_LR, steps=2,
                        vp_mesh="fsdp2_tp2"):
    """(a) and (b) of the train_mesh and seq_pipe phases: TorchTrainStrategy
    unsharded and over each mesh of `meshes` ({name: {"axes", "devices",
    optionally "strategy_config" and "split"}}) from the same weights and
    batch: the log-probs and entropy of TorchInferStrategy, `steps` train
    steps, the train strategy's log-probs and entropy after them; the
    largest differences from the unsharded run, and
    each meshed run's kernel 4-6 launches by shape: `split` (row blocks,
    head shards) a layer pass, by default (data ranks, tp), None for a run
    that launches none. Then TorchInferStrategy over `vp_mesh` (unless
    None) with and without vocab_parallel_logprobs."""
    import types
    from socioreasoner_tpu_torch.configs.worker_config import (StrategyArguments,
                                                               WorkerConfig)
    from socioreasoner_tpu_torch.distributed.strategy import ParamStore
    from socioreasoner_tpu_torch.distributed.torch_strategies import (TorchInferStrategy,
                                                                      TorchTrainStrategy)
    from socioreasoner_tpu_torch.distributed.trainer import tree_leaves
    from socioreasoner_tpu_torch.parallel.mesh import make_mesh
    from socioreasoner_tpu_torch.protocol import BatchProto

    proto = BatchProto.from_dict(tensors=dict(batch))
    ta = types.SimpleNamespace(learning_rate=lr)
    resp = batch["response_mask"][:, 1:] == 1
    B = len(batch["input_ids"])
    t = config.text
    out, base = {}, None
    for name in ["unsharded", *meshes]:
        spec = meshes.get(name, {})
        mesh = None if name == "unsharded" else make_mesh(**spec["axes"],
                                                          devices=spec["devices"])
        def wc():
            return WorkerConfig(strategy_args=StrategyArguments(
                strategy_name="jax_train", strategy_config=dict(spec.get("strategy_config", {}))))
        ref = TorchInferStrategy(worker_config=wc(), param_store=ParamStore())
        ref.initialize(config, params, mesh=mesh)
        with kernel_shapes() as lp0_shapes:
            lp0 = ref.compute_log_probs(proto)
        del ref
        s = TorchTrainStrategy(worker_config=wc(), param_store=ParamStore())
        s.initialize(config, _clone(params) if mesh is None else params, training_args=ta,
                     mesh=mesh)
        _sync(dev)
        t0 = time.perf_counter()
        metrics, step_s = [], []
        with kernel_shapes() as train_shapes:
            for _ in range(steps):
                t1 = time.perf_counter()
                metrics.append(s.train_step(proto))     # its metrics read back: synced
                step_s.append(time.perf_counter() - t1)
        with kernel_shapes() as lp_shapes:
            lp = s.compute_log_probs(proto)
        _sync(dev)
        run = {"wall_s": time.perf_counter() - t0, "step_s": step_s, "metrics": metrics}
        tree = s.state.params if mesh is None else s.state.params.gather(dev)
        if mesh is None:
            base = {"metrics": metrics, "lp0": lp0, "lp": lp, "tree": tree}
        else:
            shape = mesh.shape
            ranks = shape["dp"] * shape["fsdp"]
            split = spec.get("split", (ranks, shape["tp"]))
            args = (_row_lens(batch), batch["input_ids"].shape[1], *(split or (1, 1)),
                    t.num_attention_heads, t.num_key_value_heads, t.num_hidden_layers)
            # remat runs each layer's forward again in the backward
            run["train_launches"] = _expected_launches(
                train_shapes, *args, {} if split is None else {
                    "flash_attention_fwd_lse": 2 * steps, "flash_attention_bwd_dq": steps,
                    "flash_attention_bwd_dkv": steps}, 0)
            run["logprob_launches"] = _expected_launches(
                lp0_shapes + lp_shapes, *args,
                {} if split is None else {"flash_attention_fwd_lse": 2}, -1)
            diffs = {}
            for tag, got, want in (("lp0_", lp0, base["lp0"]), ("", lp, base["lp"])):
                for k in ("log_probs", "entropy"):
                    d = np.abs(got[k] - want[k])[resp]
                    diffs[f"{tag}{k}_max_abs"] = float(d.max())
                    diffs[f"{tag}{k}_mean_abs"] = float(d.mean())
            for step, (m, m0) in enumerate(zip(metrics, base["metrics"])):
                diffs[f"loss_abs_{step}"] = abs(m["actor_train/loss"] - m0["actor_train/loss"])
                diffs[f"grad_norm_rel_{step}"] = abs(
                    m["actor_train/grad_norm"] / m0["actor_train/grad_norm"] - 1)
                # the pad row's masked ratio mean counts 0 (JaxTrainStrategy's padding)
                real = B / (B + (-B) % ranks)
                diffs[f"ratio_mean_abs_{step}"] = abs(
                    m["actor_train/ratio_mean"] - m0["actor_train/ratio_mean"] * real)
            worst = []
            for a, b in zip(tree_leaves(tree), tree_leaves(base["tree"])):
                scale = b.float().abs().max().item()
                limit = TRAIN_MESH_PARAM_LRS * lr + scale * 2.0 ** -7
                worst.append((a.float() - b.float()).abs().max().item() / limit)
            diffs["param_max_over_limit"] = max(worst)
            run["diffs"] = diffs
        out[name] = run
        del s, tree
        _free()
    out["base_metrics"] = base["metrics"]
    if vp_mesh is None:
        return out
    # the vocab-parallel head against the gathered head on the same shards
    spec = meshes[vp_mesh]
    vp = {}
    for knob in (False, True):
        wc = WorkerConfig(strategy_args=StrategyArguments(
            strategy_name="jax_infer", strategy_config={"vocab_parallel_logprobs": knob}))
        s = TorchInferStrategy(worker_config=wc, param_store=ParamStore())
        s.initialize(config, params, mesh=make_mesh(**spec["axes"], devices=spec["devices"]))
        vp[knob] = s.compute_log_probs(proto)
        del s
        _free()
    out["vocab_parallel"] = {
        k + "_max_abs": float(np.abs(vp[True][k] - vp[False][k])[resp].max())
        for k in ("log_probs", "entropy")}
    return out


def _row_lens(batch):
    """The rows' valid lengths."""
    return tuple(int(x) for x in batch["attention_mask"].sum(-1))


def check_mesh_strategies(res) -> list:
    """(a) and (b)'s failures against the limits."""
    bad = []
    for name, run in res.items():
        if name in ("unsharded", "vocab_parallel", "base_metrics"):
            continue
        d = run["diffs"]
        for key, limit in (("lp0_log_probs_max_abs", MESH_LP0_MAX),
                           ("lp0_entropy_max_abs", MESH_LP0_MAX),
                           ("lp0_log_probs_mean_abs", MESH_LP0_MEAN),
                           ("lp0_entropy_mean_abs", MESH_LP0_MEAN),
                           ("log_probs_max_abs", TRAIN_MESH_LP_MAX),
                           ("entropy_max_abs", TRAIN_MESH_LP_MAX),
                           ("log_probs_mean_abs", TRAIN_MESH_LP_MEAN),
                           ("entropy_mean_abs", TRAIN_MESH_LP_MEAN),
                           ("param_max_over_limit", 1.0)):
            if not d[key] <= limit:
                bad.append(f"{name} {key} {d[key]} > {limit}")
        for key, v in d.items():
            limit = (TRAIN_MESH_LOSS_ABS if key.startswith("loss")
                     else TRAIN_MESH_NORM_REL if key.startswith("grad_norm")
                     else TRAIN_MESH_RATIO_ABS if key.startswith("ratio") else None)
            if limit is not None and not v <= limit:
                bad.append(f"{name} {key} {v} > {limit}")
        for kind in ("train_launches", "logprob_launches"):
            if run[kind]["missing_or_off"]:
                bad.append(f"{name} {kind}: {run[kind]}")
        if not all(np.isfinite(list(m.values())).all() for m in run["metrics"]):
            bad.append(f"{name}: metrics not finite")
    for key, v in res.get("vocab_parallel", {}).items():
        if not v <= TRAIN_MESH_VP_ABS:
            bad.append(f"vocab_parallel {key} {v} > {TRAIN_MESH_VP_ABS}")
    return bad


# examples/train/rlvr_tpu.yaml:63-67: actor_train's parallel knobs
TRAIN_YAML_MESH_KNOBS = {"tensor_model_parallel_size": 1, "fsdp_size": -1,
                         "context_parallel_size": 1, "pipeline_model_parallel_size": 1}


def run_mesh_pipeline(config, params, sam_config, sam_params, out_dir, dev, devices, *,
                      n_tiles=2, tile_px=768, img_cfg=None, processor=None,
                      prompt_length=4096, knobs=None, **cuts):
    """(c): one SocioSegPipeline step of grpo_answers' crafted answers
    (ScriptedDecodeWorker) at the grpo phase's cuts, actor_train and the
    reference over build_train_mesh(cfg, devices) with the train yaml's
    knobs (fsdp_size -1: every device on fsdp; None over one device), or
    `knobs` in their place; then
    one model_update, the rollout tree held bit for bit to the quantized
    gathered shards. Returns (the step's metrics, the mesh's shape, the
    rollout check, the pipeline's train shapes and the (B, L, H, Hkv) of
    its kernel 4-6 launches)."""
    import torch
    from socioreasoner_tpu_torch.datasets.processor import ImageProcessorConfig
    from socioreasoner_tpu_torch.datasets.socioseg import encode_sample
    from socioreasoner_tpu_torch.distributed.trainer import tree_leaves
    from socioreasoner_tpu_torch.ops.quant import quantize_decode_params
    from socioreasoner_tpu_torch.pipeline.rlvr.build import (build_train_mesh,
                                                             default_engine_kwargs)
    from socioreasoner_tpu_torch.pipeline.rlvr.socioseg_pipeline import SocioSegPipeline
    from socioreasoner_tpu_torch.runtime.generate_scheduler import LocalGenerateGroup
    from socioreasoner_tpu_torch.utils.checkpoint import flatten

    img_cfg = img_cfg or ImageProcessorConfig(defer_patchify=True)
    cfg = socioseg_train_config(out_dir, prompt_length=prompt_length,
                                **{**GRPO_CUTS, "max_steps": 1, "eval_steps": 0, **cuts})
    cfg.actor_train.strategy_args.strategy_config = dict(knobs or TRAIN_YAML_MESH_KNOBS)
    mesh = build_train_mesh(cfg, devices)
    dataset = [encode_sample(t, img_cfg) for t in _synthetic_tiles(n_tiles, tile_px)]
    pipe = SocioSegPipeline(
        cfg, model_config=config, policy_params=params,
        reference_params={k: v for k, v in params.items() if k != "vision"},
        sam_config=sam_config, sam_params=sam_params,
        processor=processor or _processor(config, img_cfg), dataset=dataset,
        engine_kwargs=default_engine_kwargs(cfg), devices=[dev], mesh=mesh)
    n = cfg.num_return_sequences
    worker = ScriptedDecodeWorker(pipe.processor.tokenizer,
                                  *grpo_answers(len(dataset[:cfg.rollout_batch_size]) * n, n), n)
    pipe.decode_replicas = [worker]
    pipe.decode_group = pipe.generate_scheduler.cluster = LocalGenerateGroup([worker])
    shapes = set()
    step = pipe.actor_train._train_step

    def recorded(state, batch):
        shapes.add(tuple(batch["input_ids"].shape))
        return step(state, batch)
    pipe.actor_train._train_step = recorded
    _sync(dev)
    t0 = time.perf_counter()
    with kernel_shapes() as launched:
        metrics = pipe.run()
        _sync(dev)
    wall = time.perf_counter() - t0
    # the weight flow after the step: the engine's tree is the yaml's int8
    # single copy of what actor_train published, the gathered shards
    pipe.model_update(pipe.state.step)
    engine_tree = flatten(pipe.actor_infer.engine.params)
    trained = pipe.actor_train.params
    gathered = trained.gather(dev) if mesh is not None else trained
    want = flatten(quantize_decode_params(gathered, mode=TRAIN_STRATEGY["weight_quant"]))
    rollout_equal = sorted(engine_tree) == sorted(want) and all(
        torch.equal(engine_tree[k], want[k]) for k in want)
    published_equal = mesh is None or all(
        torch.equal(a, b) for a, b in zip(tree_leaves(gathered),
                                          tree_leaves(trained.gather(dev))))
    keys = [f"{s}/actor_train/{k}" for s in ("map", "sat")
            for k in ("total_loss", "grad_norm", "ratio_mean", "pg_loss", "kl_loss")]
    out = {"wall_s": wall, "mesh": None if mesh is None else mesh.shape,
           "metrics": {k: metrics[k] for k in keys},
           "rollout_equal_quantized_gather": bool(rollout_equal and published_equal),
           "train_shapes": sorted(shapes),
           "kernel_shapes": sorted({k[1:5] for k in launched}),
           "kernel_launches": sum(launched.values())}
    del pipe
    _free()
    return out


TRAIN_MESH_WORKER = """
import sys
import chip_smoke
sys.exit(chip_smoke.train_mesh_worker(sys.argv[1]))
"""


def train_mesh_worker(spec_path: str) -> int:
    """One process of (d): joins through runtime/initialize.py (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), broadcasts a tensor and a host
    object, draws the phase's tree from its seed and runs one train step
    over a mesh whose dp axis spans the processes. Prints one JSON line."""
    import torch
    from socioreasoner_tpu_torch.parallel.mesh import make_mesh
    from socioreasoner_tpu_torch.runtime import initialize
    from socioreasoner_tpu_torch.utils import collective
    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device(spec["device"])
    initialize.init(timeout_s=300)
    import torch.distributed as dist
    rank, world = initialize.get_driver_rank(), initialize.get_driver_world_size()
    axes = dict(spec["axes"])
    mesh = make_mesh(**axes, devices=[dev] * (int(np.prod(list(axes.values()))) // world),
                     process_index=rank, process_count=world)
    value = collective.broadcast(torch.arange(4.0, device=dev) * (1 - rank), mesh, "dp")
    host = collective.broadcast_host_data({"rank": rank, "seed": spec["seed"]})
    collective.barrier()
    config = config_from_dict(spec["config"])
    dtype = getattr(torch, spec["dtype"])
    params = train_mesh_params(config, dev, dtype, spec["seed"])
    batch = dict(np.load(spec["batch"]))
    res = run_mesh_step(config, params, batch, mesh, spec["lr"])
    print(json.dumps({"rank": rank, "backend": dist.get_backend(), "driver":
                      initialize.is_driver(), "broadcast": value.tolist(), "host": host,
                      **res}), flush=True)
    dist.destroy_process_group()
    return 0


def config_from_dict(d):
    """A Qwen25VLConfig from dataclasses.asdict's dict (lists back to
    tuples)."""
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import (
        Qwen25VLConfig, TextConfig, VisionConfig)

    def fields(x):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in x.items()}
    rest = {k: v for k, v in d.items() if k not in ("vision", "text")}
    return Qwen25VLConfig(vision=VisionConfig(**fields(d["vision"])),
                          text=TextConfig(**fields(d["text"])), **fields(rest))


def run_mesh_step(config, params, batch, mesh, lr):
    """One TorchTrainStrategy step over `mesh` from `params` (copied into
    its shards): the loss, its repr, the grad norm and ratio mean."""
    import types
    from socioreasoner_tpu_torch.configs.worker_config import WorkerConfig
    from socioreasoner_tpu_torch.distributed.strategy import ParamStore
    from socioreasoner_tpu_torch.distributed.torch_strategies import TorchTrainStrategy
    from socioreasoner_tpu_torch.protocol import BatchProto
    s = TorchTrainStrategy(worker_config=WorkerConfig(), param_store=ParamStore())
    s.initialize(config, params, training_args=types.SimpleNamespace(learning_rate=lr),
                 mesh=mesh)
    m = s.train_step(BatchProto.from_dict(tensors=dict(batch)))
    return {"loss": m["actor_train/loss"], "loss_repr": repr(m["actor_train/loss"]),
            "grad_norm": m["actor_train/grad_norm"],
            "ratio_mean": m["actor_train/ratio_mean"], "mesh": mesh.shape}


def run_mesh_processes(config, dev, batch, work_dir, *, axes=TRAIN_MESH_PROCESSES,
                       seed=TRAIN_MESH_SEED, lr=TRAIN_MESH_LR, dtype="bfloat16", timeout=600):
    """(d): two processes of train_mesh_worker on `dev` (gloo: the two
    ranks share the card), each drawing train_mesh_params(config) from
    `seed`, against the one-process step over the same mesh shape and tree.
    Returns (the workers' JSON lines, the one-process step); raises when a
    worker fails."""
    import dataclasses
    import os
    import socket
    import torch
    from socioreasoner_tpu_torch.parallel.mesh import make_mesh
    batch_path = str(Path(work_dir) / "train_mesh_batch.npz")
    np.savez(batch_path, **batch)
    spec_path = str(Path(work_dir) / "train_mesh_spec.json")
    with open(spec_path, "w") as f:
        json.dump({"device": str(dev), "axes": axes, "config": dataclasses.asdict(config),
                   "seed": seed, "lr": lr, "dtype": dtype, "batch": batch_path}, f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    here = Path(__file__).resolve().parent
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-c", TRAIN_MESH_WORKER, spec_path],
                                      cwd=here, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"train_mesh worker {rank}: exit {p.returncode}\n"
                                 f"{out[-4000:]}")
        results.append(json.loads(lines[-1]))
    params = train_mesh_params(config, dev, getattr(torch, dtype), seed)
    one = run_mesh_step(config, params, batch, make_mesh(
        **axes, devices=[dev] * int(np.prod(list(axes.values())))), lr)
    del params
    _free()
    return results, one


def check_mesh_processes(workers, one) -> list:
    """(d)'s failures: equal losses, within (a)'s limit of one process's."""
    bad = []
    if workers[0]["loss_repr"] != workers[1]["loss_repr"]:
        bad.append(f"the two processes' losses differ: {[w['loss'] for w in workers]}")
    if not abs(workers[0]["loss"] - one["loss"]) <= TRAIN_MESH_LOSS_ABS:
        bad.append(f"two processes {workers[0]['loss']} against one {one['loss']}")
    if workers[0]["mesh"] != one["mesh"]:
        bad.append(f"mesh {workers[0]['mesh']} against {one['mesh']}")
    if any(w["broadcast"] != [0.0, 1.0, 2.0, 3.0] or w["host"]["rank"] != 0
           or w["backend"] != "gloo" for w in workers):
        bad.append(f"broadcast: {[(w['broadcast'], w['host']) for w in workers]}")
    return bad


def phase_train_mesh(main_config):
    """The train plane over a device mesh on the one card, at Qwen2.5-VL-3B
    text widths (hidden 2048, 16/2 heads x 128, intermediate 11008, vocab
    151936, tied head) cut to TRAIN_MESH_LAYERS layers: (a) the strategies
    unsharded, over fsdp 2 and over fsdp 2 x tp 2 ([cuda:0] x 2 and x 4):
    two train steps, the log-probs and entropy, the vocab-parallel head;
    (b) kernels 4-6 on every rank's rows at the shard's local heads; (c) a
    SocioSegPipeline step over build_train_mesh's fsdp 2 against one
    unsharded, the rollout tree after model_update; (d) two processes with
    dp across them. Returns the launch counts of kernels 1-6 over (a)-(c)."""
    import torch
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    from socioreasoner_tpu_torch.models.sam2 import model as smodel
    from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    from socioreasoner_tpu_torch.utils.context_managers import device_memory_stats

    dev = torch.device("cuda")
    _free()
    torch.cuda.reset_peak_memory_stats()
    kernels = (fa.flash_attention_segmented, fa.flash_attention, da.paged_decode_attention,
               *_train_kernel_fns())
    for fn in kernels:
        fn.launches = 0
    t_phase = time.perf_counter()
    config = train_mesh_config(TRAIN_MESH_LAYERS, main_config)
    params = train_mesh_params(config, dev)
    batch = train_mesh_batch(config, params, dev)
    meshes = {name: {"axes": axes, "devices": [dev] * int(np.prod(list(axes.values())))}
              for name, axes in TRAIN_MESH_MESHES.items()}
    t0 = time.perf_counter()
    res = run_mesh_strategies(config, params, dev, meshes, batch)
    emit({"phase": "train_mesh_strategies", "card": _smi_line(),
          "model": f"Qwen2.5-VL-3B text widths, {TRAIN_MESH_LAYERS} layers, vocab 151936, "
                   "tied head, random bf16 weights; the meshes' devices are cuda:0 listed "
                   "several times: the sharded code, not multi-GPU speed",
          "batch": f"B={len(TRAIN_MESH_LENS)} L={TRAIN_MESH_L} kv_len={list(TRAIN_MESH_LENS)}",
          "wall_s": time.perf_counter() - t0,
          "limits": {"lp0_max": MESH_LP0_MAX, "lp0_mean": MESH_LP0_MEAN,
                     "lp_max": TRAIN_MESH_LP_MAX, "lp_mean": TRAIN_MESH_LP_MEAN,
                     "loss_abs": TRAIN_MESH_LOSS_ABS, "grad_norm_rel": TRAIN_MESH_NORM_REL,
                     "ratio_mean_abs": TRAIN_MESH_RATIO_ABS,
                     "param": f"{TRAIN_MESH_PARAM_LRS} lr + 2^-7 x leaf max",
                     "vocab_parallel_abs": TRAIN_MESH_VP_ABS},
          **{k: v if k in ("vocab_parallel", "base_metrics") else
             {kk: vv for kk, vv in v.items() if kk != "metrics"} for k, v in res.items()}})
    bad = check_mesh_strategies(res)
    if bad:
        raise AssertionError(f"train_mesh (a)/(b): {bad}")
    launches_a = {fn.__name__: fn.launches for fn in kernels}

    # (c) the pipeline over build_train_mesh's fsdp 2, against one device
    sam_config = Sam2Config.large()
    sam_params = smodel.init_params(sam_config, torch.Generator(device=dev).manual_seed(2),
                                    dtype=torch.bfloat16, device=dev)
    # the same text tree with the 3B ViT (32 blocks) beside it
    full = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(TRAIN_MESH_SEED),
                              dtype=torch.bfloat16, device=dev)
    pipes = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for name, devices in (("unsharded", [dev]), ("fsdp2", [dev] * 2)):
            pipes[name] = run_mesh_pipeline(config, _clone(full) if name == "unsharded"
                                            else full, sam_config, sam_params,
                                            str(Path(out_dir) / name), dev, devices)
    del full, sam_params
    _free()
    base, meshed = pipes["unsharded"], pipes["fsdp2"]
    # the rank shapes the kernels phase checked (TRAIN_MESH_PIPELINE_TRAIN)
    spec = TRAIN_MESH_PIPELINE_TRAIN
    checked = {(B, spec["L"], 16, 2) for B in (spec["train_batch"], spec["logprob_batch"])}
    left = sorted(set(map(tuple, meshed["kernel_shapes"])) - checked)
    diffs = {k: abs(meshed["metrics"][k] - base["metrics"][k]) for k in base["metrics"]}
    emit({"phase": "train_mesh_pipeline", "pipelines": pipes, "diffs": diffs})
    bad = [k for k, d in diffs.items() if not d <= (
        TRAIN_MESH_NORM_REL * abs(base["metrics"][k]) if "grad_norm" in k
        else TRAIN_MESH_RATIO_ABS if "ratio" in k else TRAIN_MESH_LOSS_ABS)]
    if (bad or left or meshed["mesh"] != {"dp": 1, "fsdp": 2, "pp": 1, "sp": 1, "tp": 1}
            or not (base["rollout_equal_quantized_gather"]
                    and meshed["rollout_equal_quantized_gather"])):
        raise AssertionError(f"train_mesh (c): {bad}, left the checked shapes {left}, "
                             f"{meshed['mesh']}, "
                             f"{[p['rollout_equal_quantized_gather'] for p in pipes.values()]}")
    launches = {fn.__name__: fn.launches for fn in kernels}

    # (d) two processes on the card, dp across them
    with tempfile.TemporaryDirectory() as work_dir:
        t0 = time.perf_counter()
        workers, one = run_mesh_processes(config, dev, batch, work_dir)
        wall = time.perf_counter() - t0
    emit({"phase": "train_mesh_processes", "axes": TRAIN_MESH_PROCESSES, "wall_s": wall,
          "workers": workers, "one_process": one})
    bad = check_mesh_processes(workers, one)
    if bad:
        raise AssertionError(f"train_mesh (d): {bad}")
    peak = device_memory_stats()["device0/peak_bytes_in_use"] / 2**30
    emit({"phase": "train_mesh", "phase_s": time.perf_counter() - t_phase,
          "launches": launches, "launches_strategies": launches_a, "peak_gib": peak})
    if not all(launches[fn.__name__] > 0 for fn in _train_kernel_fns()):
        raise AssertionError(f"kernels 4-6 never launched in the train_mesh phase: {launches}")
    return launches


# ------------------------------------------------------------ seq_pipe

# The seq_pipe phase: context and pipeline parallelism of the train plane on
# the train_mesh phase's model (Qwen2.5-VL-3B text widths at 4 layers, full
# vocabulary), the meshes' devices cuda:0 listed several times (the sharded
# code, not multi-GPU speed).
SEQ_PIPE_LENS = (2219, 2080, 2150, 2164)    # 4 rows of L = 4160, ~2,150 valid
# name: mesh axes, strategy_config and the kernel 4-6 calls a layer pass
# makes, (row blocks, head shards): Ulysses attends all rows over each of
# its sp 2 head slices, GPipe a micro-batch of 2 rows at a time at the
# full heads, the ring (plain f32 attention, as JAX's is plain jnp) none
SEQ_PIPE_RUNS = {
    "cp2_ring": {"axes": {"sp": 2, "tp": 2}, "split": None,
                 "strategy_config": {"context_parallel_size": 2}},
    "cp2_ulysses": {"axes": {"sp": 2}, "split": (1, 2),
                    "strategy_config": {"context_parallel_size": 2,
                                        "context_parallel_impl": "ulysses"}},
    "pp2": {"axes": {"pp": 2}, "split": (2, 1),
            "strategy_config": {"pipeline_model_parallel_size": 2}},
    "pp2_vpp2": {"axes": {"pp": 2}, "split": (2, 1),
                 "strategy_config": {"pipeline_model_parallel_size": 2,
                                     "virtual_pipeline_model_parallel_size": 2}},
}
SEQ_PIPE_RING_ULYSSES = 1e-3  # the ring's loss against Ulysses', each step
# the kernels phase's checks of kernels 4-6 at the phase's shapes: Ulysses'
# head slice (the 4 rows at full L, 8/1 heads on each of sp 2) and a GPipe
# micro-batch (2 rows at 16/2 heads)
SEQ_PIPE_ULYSSES_TRAIN = {"L": TRAIN_MESH_L, "train_batch": 4, "logprob_batch": 4,
                          "lens": SEQ_PIPE_LENS, "H": 8, "Hkv": 1}
SEQ_PIPE_PP_TRAIN = {"L": TRAIN_MESH_L, "train_batch": 2, "logprob_batch": 2,
                     "lens": SEQ_PIPE_LENS[:2]}
# (c): the train yaml's knobs with context_parallel_size 2 over [cuda:0] x 2
SEQ_PIPE_YAML_KNOBS = dict(TRAIN_YAML_MESH_KNOBS, context_parallel_size=2)


def seq_pipe_runs(dev, runs=None):
    """SEQ_PIPE_RUNS with each mesh's devices: `dev` listed once a device."""
    return {name: dict(spec, devices=[dev] * int(np.prod(list(spec["axes"].values()))))
            for name, spec in (runs or SEQ_PIPE_RUNS).items()}


def check_ring_against_ulysses(res) -> list:
    """The ring's loss against Ulysses' at each step, SEQ_PIPE_RING_ULYSSES."""
    gaps = [abs(r["actor_train/loss"] - u["actor_train/loss"])
            for r, u in zip(res["cp2_ring"]["metrics"], res["cp2_ulysses"]["metrics"])]
    return [f"ring against ulysses loss at step {step}: {gap}"
            for step, gap in enumerate(gaps) if not gap <= SEQ_PIPE_RING_ULYSSES]


def ring_against_kernel(dev, lens=SEQ_PIPE_LENS, L=TRAIN_MESH_L, H=8, Hkv=1, D=128,
                        timed: bool = True):
    """One layer's attention of the cp2_ring run on one tp shard (its rows
    at H / Hkv heads, zigzag over sp 2, K/V repeated to H) against kernel 4
    on the same rows unsplit: the ring's largest difference from kernel
    4's output in the rows' valid queries and, when timed, each one's ms
    (CUDA events) and device ms (the profiler's kernel time)."""
    import torch
    from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb
    from socioreasoner_tpu_torch.parallel.context_parallel import zigzag_indices
    from socioreasoner_tpu_torch.parallel.ring_attention import ring_attention_pos_local
    g = torch.Generator(device=dev).manual_seed(5)
    B = len(lens)
    q, k, v = (torch.randn((B, L, h, D), generator=g, device=dev).to(torch.bfloat16)
               for h in (H, Hkv, Hkv))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lens_t[:, None]).to(torch.int32)
    perm = torch.as_tensor(zigzag_indices(L, 2), device=dev)
    pos = perm[None].expand(B, L)
    qp, kp, vp, mp = (x[:, perm] for x in (q, k.repeat_interleave(H // Hkv, 2),
                                            v.repeat_interleave(H // Hkv, 2), mask))
    half = L // 2
    shards = [(x[:, :half], x[:, half:]) for x in (qp, kp, vp, pos, mp)]

    def ring():
        return ring_attention_pos_local(*[list(s) for s in shards[:3]], list(shards[3]),
                                        list(shards[3]), list(shards[4]), causal=True)

    def kernel():
        return fb.flash_attention_fwd_lse(q, k, v, lens_t)
    with torch.no_grad():
        got = torch.cat(ring(), dim=1)[:, torch.argsort(perm)]
        want = kernel()[0]
        valid = mask.bool()
        err = (got.float() - want.float()).abs()[valid].max().item()
        out = {"shape": f"B={B} L={L} H={H} Hkv={Hkv} D={D} kv_len={list(lens)}, "
                        "one tp shard of a layer",
               "ring_max_abs_diff_from_kernel4": err}
        if timed:
            out.update(ring_ms=cuda_ms(ring, n=5), ring_device_ms=device_ms(ring, ("",), n=3),
                       kernel4_ms=cuda_ms(kernel), kernel4_device_ms=device_ms(kernel, ("",)))
    del q, k, v, qp, kp, vp, shards
    _free()
    return out


def phase_seq_pipe(main_config):
    """Context and pipeline parallelism of the train plane at Qwen2.5-VL-3B
    text widths cut to TRAIN_MESH_LAYERS layers: (a) the strategies
    unsharded, cp 2 ring over sp 2 x tp 2 ([cuda:0] x 4), cp 2 Ulysses
    over [cuda:0] x 2, pp 2 GPipe and pp 2 x vpp 2 interleaved over
    [cuda:0] x 2: the log-probs before any step, two train steps and the
    log-probs after, held to the unsharded run, ring against Ulysses on the
    loss; (b) kernels 4-6 counted by shape (Ulysses' head slices, GPipe's
    micro-batches, none in the ring), the ring's attention a layer timed
    beside kernel 4 on the same rows; (c) a SocioSegPipeline step of crafted
    answers with the train yaml's context_parallel_size 2 over [cuda:0] x 2
    against the same step unsharded; (d) the port's dry runs,
    dryrun_multichip over [cuda:0] x 8 and dryrun_multiprocess over two
    processes on cuda:0. Returns the launch counts of kernels 1-6 over
    (a)-(d) in this process."""
    import torch
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as qmodel
    from socioreasoner_tpu_torch.models.sam2 import model as smodel
    from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
    from socioreasoner_tpu_torch.ops import decode_attention as da
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    from socioreasoner_tpu_torch.tools.dryrun import dryrun_multichip, dryrun_multiprocess
    from socioreasoner_tpu_torch.utils.context_managers import device_memory_stats

    dev = torch.device("cuda")
    _free()
    torch.cuda.reset_peak_memory_stats()
    kernels = (fa.flash_attention_segmented, fa.flash_attention, da.paged_decode_attention,
               *_train_kernel_fns())
    for fn in kernels:
        fn.launches = 0
    t_phase = time.perf_counter()
    config = train_mesh_config(TRAIN_MESH_LAYERS, main_config)
    params = train_mesh_params(config, dev)
    batch = train_mesh_batch(config, params, dev, lens=SEQ_PIPE_LENS)
    t0 = time.perf_counter()
    res = run_mesh_strategies(config, params, dev, seq_pipe_runs(dev), batch, vp_mesh=None)
    emit({"phase": "seq_pipe_strategies", "card": _smi_line(),
          "model": f"Qwen2.5-VL-3B text widths, {TRAIN_MESH_LAYERS} layers, vocab 151936, "
                   "tied head, random bf16 weights; the meshes' devices are cuda:0 listed "
                   "several times: the sharded code, not multi-GPU speed",
          "batch": f"B={len(SEQ_PIPE_LENS)} L={TRAIN_MESH_L} kv_len={list(SEQ_PIPE_LENS)}",
          "wall_s": time.perf_counter() - t0,
          "limits": {"lp0_max": MESH_LP0_MAX, "lp0_mean": MESH_LP0_MEAN,
                     "lp_max": TRAIN_MESH_LP_MAX, "lp_mean": TRAIN_MESH_LP_MEAN,
                     "loss_abs": TRAIN_MESH_LOSS_ABS, "grad_norm_rel": TRAIN_MESH_NORM_REL,
                     "ratio_mean_abs": TRAIN_MESH_RATIO_ABS,
                     "param": f"{TRAIN_MESH_PARAM_LRS} lr + 2^-7 x leaf max",
                     "ring_against_ulysses_loss": SEQ_PIPE_RING_ULYSSES},
          **{k: v if k == "base_metrics" else
             {kk: vv for kk, vv in v.items() if kk != "metrics"} for k, v in res.items()}})
    bad = check_mesh_strategies(res) + check_ring_against_ulysses(res)
    if bad:
        raise AssertionError(f"seq_pipe (a)/(b): {bad}")
    launches_a = {fn.__name__: fn.launches for fn in kernels}
    ring = ring_against_kernel(dev)
    for fn in kernels:      # the comparison's launches are not the path's
        fn.launches = launches_a[fn.__name__]
    emit({"phase": "seq_pipe_ring_attention", "card": _smi_line(), **ring})
    del params
    _free()

    # (c) the pipeline with the yaml's context_parallel_size 2, against one device
    sam_config = Sam2Config.large()
    sam_params = smodel.init_params(sam_config, torch.Generator(device=dev).manual_seed(2),
                                    dtype=torch.bfloat16, device=dev)
    full = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(TRAIN_MESH_SEED),
                              dtype=torch.bfloat16, device=dev)
    pipes = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for name, devices in (("unsharded", [dev]), ("cp2", [dev] * 2)):
            pipes[name] = run_mesh_pipeline(
                config, _clone(full) if name == "unsharded" else full, sam_config,
                sam_params, str(Path(out_dir) / name), dev, devices,
                knobs=SEQ_PIPE_YAML_KNOBS if name == "cp2" else None)
    del full, sam_params
    _free()
    base, meshed = pipes["unsharded"], pipes["cp2"]
    # the reference (no cp) runs sp row 0 at the grpo phase's log-prob chunk
    checked = {(GRPO_TRAIN["logprob_batch"], GRPO_TRAIN["L"], 16, 2)}
    left = sorted(set(map(tuple, meshed["kernel_shapes"])) - checked)
    diffs = {k: abs(meshed["metrics"][k] - base["metrics"][k]) for k in base["metrics"]}
    emit({"phase": "seq_pipe_pipeline", "pipelines": pipes, "diffs": diffs})
    bad = [k for k, d in diffs.items() if not d <= (
        TRAIN_MESH_NORM_REL * abs(base["metrics"][k]) if "grad_norm" in k
        else TRAIN_MESH_RATIO_ABS if "ratio" in k else TRAIN_MESH_LOSS_ABS)]
    if (bad or left or meshed["mesh"] != {"dp": 1, "fsdp": 1, "pp": 1, "sp": 2, "tp": 1}
            or not all(p["rollout_equal_quantized_gather"] for p in pipes.values())):
        raise AssertionError(f"seq_pipe (c): {bad}, left the checked shapes {left}, "
                             f"{meshed['mesh']}, "
                             f"{[p['rollout_equal_quantized_gather'] for p in pipes.values()]}")

    # (d) the port's dry runs on the card
    t0 = time.perf_counter()
    multichip = dryrun_multichip(8, [dev] * 8)
    t1 = time.perf_counter()
    processes = dryrun_multiprocess(2, device=dev)
    emit({"phase": "seq_pipe_dryruns", "multichip": multichip,
          "multichip_s": t1 - t0, "multiprocess": processes,
          "multiprocess_s": time.perf_counter() - t1})
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = device_memory_stats()["device0/peak_bytes_in_use"] / 2**30
    emit({"phase": "seq_pipe", "phase_s": time.perf_counter() - t_phase,
          "launches": launches, "launches_strategies": launches_a, "peak_gib": peak})
    if not all(launches[fn.__name__] > 0 for fn in _train_kernel_fns()):
        raise AssertionError(f"kernels 4-6 never launched in the seq_pipe phase: {launches}")
    return launches


def main() -> int:
    try:
        import torch
        from socioreasoner_tpu_torch.ops import _build
        from socioreasoner_tpu_torch.ops.flags import flash_disabled
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
    if flash_disabled():
        # the knob would send attention to its plain version (the engine,
        # trainer and ViT refuse it for tensors on the card)
        print("chip_smoke: SOCIO_DISABLE_FLASH=1 is set; unset it to run the kernels",
              file=sys.stderr)
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
    parallel = phase_parallel(config, params)
    grpo = phase_grpo(config, params)
    rlvr = phase_rlvr(config, params)
    workers = phase_workers(config, params)
    agentic = phase_agentic(config, params)
    train_mesh = phase_train_mesh(config)
    seq_pipe = phase_seq_pipe(config)
    with tempfile.TemporaryDirectory() as work_dir:
        export_dir = str(Path(work_dir) / "qwen2_5_vl_3b")
        export_stats, sums = export_main_tree(config, params, export_dir,
                                              torch.device("cuda"))
        del params
        entry = phase_entry(export_dir, export_stats, sums, work_dir)
    launches.update(phase_row_writer())
    families = phase_families()
    head_dims, falcon3, wide = phase_head_dims()
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
        if kern["name"] in two_stage:
            kern["launches_two_stage"] = two_stage[kern["name"]]
        if kern["name"] in parallel:
            kern["launches_parallel"] = parallel[kern["name"]]
        if kern["name"] in grpo:
            kern["launches_grpo"] = grpo[kern["name"]]
        if kern["name"] in rlvr:
            kern["launches_rlvr"] = rlvr[kern["name"]]
        # kernels 3q and 7 are on no path of the workers phase (bf16 cache)
        kern["launches_workers"] = workers.get(kern["name"], 0)
        if kern["name"] in entry:
            kern["launches_entry"] = entry[kern["name"]]
        # kernels 3q and 7 are on no path of the families phase (bf16 cache)
        kern["launches_families"] = families.get(kern["name"], 0)
        # kernels 1 and 7 are on no path of the head_dims phase (text models);
        # 3 and 3q run there at Falcon3-7B's head dim 256 and its regroupings'
        # 512 and 384 only
        kern["launches_head_dims"] = head_dims.get(kern["name"], 0)
        kern["launches_head_dims_falcon3_7b"] = falcon3.get(kern["name"], 0)
        kern["launches_head_dims_above_256"] = wide.get(kern["name"], 0)
        # kernels 3q and 7 are on no path of the agentic phase (bf16 cache)
        kern["launches_agentic"] = agentic.get(kern["name"], 0)
        # kernels 2, 3, 3q and 7 are on no path of the train_mesh phase (its
        # pipeline step answers through a scripted decode worker)
        kern["launches_train_mesh"] = train_mesh.get(kern["name"], 0)
        # kernels 3q and 7 are on no path of the seq_pipe phase (bf16 cache)
        kern["launches_seq_pipe"] = seq_pipe.get(kern["name"], 0)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
