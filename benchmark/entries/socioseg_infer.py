"""SocioSeg's two-stage inference through the port's SocioSegInferPipeline,
as `evaluate_batch` calls it: its overlapped `_two_stage` over chunks of
map + satellite tiles (stage-1 decode, SAM2, the restage, stage-2 decode,
SAM2), served by one int8 single-copy Qwen2.5-VL engine with SAM2 beside it.

The pipeline is built as the entry script builds it from the infer yaml
(examples/infer/rlvr_tpu.yaml: int8 single-copy weights, no KV
quantisation, prefix fork, temperature 1.0, top_p 0.8, 16 slots), with the
cuts of the traffic mix. Warm-up runs one chunk; the window holds whole
chunks only and closes at the first chunk boundary at or after --seconds.

tiles_per_s: tiles completed through both stages over the window's time.

The harness sits at the decode servers' request boundary: it makes every
`greedy_every`-th tile of a chunk ask for greedy answers (the traffic
samples its tokens otherwise) and records each request's prompt and served
tokens. It also records, around each engine step, the work that the
per-layer readers count. A `--trace 1` run profiles one whole chunk of
the window (`trace_chunk`), device activity alone: a chunk launches some
700,000 kernels, and the host's own ops would multiply the trace. The
profiler still slows the host's launches, so the readers that divide by wall time take the mean
wall of the same run's untraced chunks, which do the same work: the
traced chunk comes after one untraced chunk.

Correctness: after the window, with the pipeline freed, a sample of the
window's greedy tiles drawn from the seed: the plain reference rebuilds
each stage's prompt (text, tokens, images, positions) from the tile alone
and the stage-1 answer, compares the tokens with the prompt the program
served (exact), runs its own ViT and the int8-weight decoder in float32
over prompt and served tokens, and reads the widest gap of a served token's
logit below the reference's best.
"""

from __future__ import annotations

import dataclasses
import gc
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

import generator
import harness
import peaks
import tracing
import weights
from engine_records import StepRecorder, model_shape
from reference import compare, decoder, prompts, vision


def _pipeline(ctx, tree, out_dir):
    from socioreasoner_tpu_torch.configs.rlvr_config import SocioSegConfig
    from socioreasoner_tpu_torch.datasets.processor import (ImageProcessorConfig,
                                                            SimpleTokenizer, SocioProcessor)
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig
    from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
    from socioreasoner_tpu_torch.models.sam2.model import init_params as sam_init
    from socioreasoner_tpu_torch.pipeline.rlvr.build import default_engine_kwargs
    from socioreasoner_tpu_torch.pipeline.rlvr.socioseg_infer_pipeline import (
        SocioSegInferPipeline)

    tr, dev = ctx.traffic, ctx.device
    mcfg = Qwen25VLConfig.from_hf_dict(ctx.config)
    cfg = SocioSegConfig(exp_name="socioseg_infer_benchmark", seed=42, output_dir=out_dir,
                         track_with="stdout", save_steps=-1,
                         rollout_batch_size=int(tr["tiles_per_chunk"]),
                         prompt_length=int(tr["prompt_length"]),
                         response_length=int(tr["response_length"]))
    ga = cfg.actor_infer.generating_args
    ga.max_new_tokens, ga.top_p, ga.temperature = cfg.response_length, tr["top_p"], tr["temperature"]
    ga.num_return_sequences = 1
    cfg.actor_infer.strategy_args.strategy_name = "jax_decode"
    cfg.actor_infer.strategy_args.strategy_config = dict(tr["strategy_config"])
    cfg.actor_infer.infer_batch_size = int(tr["infer_batch_size"])
    cfg.seg_infer.strategy_args.strategy_name = "seg_infer"
    img_cfg = ImageProcessorConfig(min_pixels=int(tr["min_pixels"]),
                                   max_pixels=int(tr["max_pixels"]), defer_patchify=True)
    processor = SocioProcessor(SimpleTokenizer(), img_cfg, image_token_id=mcfg.image_token_id)
    sam_cfg = getattr(Sam2Config, tr["sam2"])()
    sam_params = sam_init(sam_cfg, torch.Generator(device=dev).manual_seed(
        ctx.seed & generator.SEED_MASK), dtype=torch.bfloat16, device=dev)
    pipe = SocioSegInferPipeline(
        cfg, model_config=mcfg, policy_params=dict(tree), sam_config=sam_cfg,
        sam_params=sam_params, processor=processor, dataset=[],
        engine_kwargs=default_engine_kwargs(cfg))
    return pipe, img_cfg


class Boundary:
    """The decode servers' request boundary: greedy tiles, served tokens."""

    def __init__(self, pipe, tr):
        from socioreasoner_tpu_torch.generation.server import GenerateRequestType as GRT
        self.every = int(tr["greedy_every"])
        self.chunk = -1
        self.served: Dict = {}           # (chunk, stage, tile) -> record
        for w in pipe.decode_replicas:
            orig = w.add_request

            def add(command, data, _orig=orig):
                if command == GRT.ADD:
                    data = self._admit(data)
                return _orig(command, data)
            w.add_request = add

    def _admit(self, data):
        stage, tile = data["request_id"][0], int(data["request_id"][1])
        greedy = tile % self.every == 0
        if greedy:
            data = dict(data, sampling=dataclasses.replace(
                data["sampling"], do_sample=False, temperature=0.0))
        key = (self.chunk, stage, tile)
        rec = {"prompt": list(data["prompt_ids"]), "greedy": greedy, "out": None}
        self.served[key] = rec
        cb = data["callback"]

        def done(out, _rec=rec, _cb=cb):
            _rec["out"] = list(out.output_ids)
            _rec["reason"] = out.finish_reason
            return _cb(out)
        return dict(data, callback=done)


def vit_launch(v: Dict, grid) -> Dict:
    """counts/k1.py's record of one kernel-1 launch of a tower call over a
    map + satellite pair of this grid: the mean pairs of the tower's window
    and full-attention blocks."""
    _, gh, gw = grid
    wp = v["window_size"] // v["patch_size"]
    rows, cols = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    win = (rows // wp) * (gw // wp + 1) + cols // wp
    full = len(v["fullatt_block_indexes"])
    pairs = 2 * ((v["depth"] - full) * peaks.seg_pairs(win) + full * (gh * gw) ** 2) / v["depth"]
    return {"tokens": 2 * gh * gw, "pairs": pairs, "heads": v["num_heads"],
            "head_dim": v["hidden_size"] // v["num_heads"]}


def run(ctx) -> Dict:
    from socioreasoner_tpu_torch.datasets.socioseg import encode_sample
    from PIL import Image

    tr, dev, cfg = ctx.traffic, ctx.device, ctx.config
    v = cfg["vision_config"]
    marks = [("start", time.perf_counter())]
    tree = weights.text_weights(cfg, ctx.seed, dev)
    tree["vision"] = weights.vision_weights(v, ctx.seed, dev)
    marks.append(("weights", time.perf_counter()))
    out_dir = tempfile.mkdtemp(prefix="bench_socioseg_")
    pipe, img_cfg = _pipeline(ctx, tree, out_dir)
    marks.append(("pipeline", time.perf_counter()))
    engine = pipe.actor_infer.engine
    rec = StepRecorder(engine)
    sl = ctx.slice

    def step():                     # the decode server's thread calls it
        with tracing.span(sl, "engine.step"):
            return rec.step()
    engine.step = step
    boundary = Boundary(pipe, tr)

    stream = generator.tile_chunks(tr, ctx.seed)
    chunks = [next(stream) for _ in range(int(tr["chunks_prepared"]))]

    def rows_of(tiles):
        return [encode_sample({k: (Image.fromarray(t[k]) if k in ("map", "sat", "mask")
                                   else t[k]) for k in t}, img_cfg) for t in tiles]
    rows = [rows_of(c) for c in chunks]
    marks.append(("tiles", time.perf_counter()))

    # warm-up: the first chunk's first tiles through both stages
    boundary.chunk = -1
    pipe.evaluate_batch(rows[0][:int(tr["warm_tiles"])])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("warm", time.perf_counter()))

    steps0 = engine.steps_executed
    slice_work, slice_counts = {}, {}
    done_chunks: List[int] = []
    chunk_s: List[float] = []                           # the untraced chunks' walls
    tiles = 0
    t_wall0 = time.time()
    t0 = time.perf_counter()
    k = 0
    while True:
        c = (k + 1) % len(rows)                         # chunk 0 warmed up
        boundary.chunk = k
        traced = sl is not None and k == int(tr["trace_chunk"])
        if traced:                                      # the slice: one whole chunk
            rec.prefill, rec.decode = [], []
            s0 = engine.steps_executed
            sl.start()
        tc = time.perf_counter()
        pipe.evaluate_batch(rows[c])
        if traced:
            sl.stop()
            slice_work = {"prefill": list(rec.prefill), "decode": list(rec.decode)}
            slice_counts = {"decode_steps": engine.steps_executed - s0,
                            "tiles": len(rows[c])}
        else:                                           # timed as the window is
            chunk_s.append(time.perf_counter() - tc)
        done_chunks.append(c)
        tiles += len(rows[c])
        k += 1
        if time.perf_counter() - t0 >= ctx.seconds and (sl is None or k > int(tr["trace_chunk"])):
            break
    window_s = time.perf_counter() - t0
    steps = engine.steps_executed - steps0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    served = boundary.served
    failed = sum(1 for key, r in served.items() if key[0] >= 0
                 and r.get("reason") not in ("stop", "length"))
    attempted = sum(1 for key in served if key[0] >= 0)
    if sl is not None and sl.kernels:
        grid = (1, rows[0][0]["image"][0].height // 14, rows[0][0]["image"][0].width // 14)
        n_k1 = sl.device_time(harness.count_module("k1").match)[1]
        slice_work["vit"] = [vit_launch(v, grid)] * n_k1
    setup = {b[0]: round(b[1] - a[1], 3) for a, b in zip(marks, marks[1:])}

    # ---- free the program's state, then the reference
    del pipe, engine, rec, boundary
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    checks, readings = judge(ctx, cfg, tree, served, chunks, done_chunks,
                             control=getattr(ctx, "control", False))
    return {"e2e": {"tiles_per_s": tiles / window_s},
            "window_start_epoch": t_wall0, "window_s": window_s,
            "attempted": attempted, "failed": failed, "checks": checks,
            "readings": dict(readings, tiles=tiles, decode_steps=steps, setup_parts=setup,
                             chunk_s=chunk_s),
            "memory_peak_bytes": peak,
            "reader": {"shape": dict(model_shape(cfg), vision=vision_shape(v)),
                       "counters": {"decode_steps": steps, "tiles": tiles},
                       "slice_counts": slice_counts, "work": slice_work,
                       "untraced_wall_s": (sum(chunk_s) / len(chunk_s) if chunk_s
                                           else None)}}


def vision_shape(v: Dict) -> Dict:
    return {"hidden": v["hidden_size"], "intermediate": v["intermediate_size"],
            "depth": v["depth"], "merge": v["spatial_merge_size"] ** 2,
            "patch_in": v["in_chans"] * v["temporal_patch_size"] * v["patch_size"] ** 2,
            "out": v["out_hidden_size"]}


def _text_cfg(cfg: Dict) -> Dict:
    return dict(cfg, head_dim=cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"])


def judge(ctx, cfg, tree, served, chunks, done_chunks, control=False):
    """prompt_mismatch (exact) and served_gap_max over a sample of the
    window's greedy tiles. With `control`, the control is put in the
    program's place: served_gap_max is held to its limit at the tokens
    that the control puts first (its reading, control_gap_max), and the
    program's own reading is kept beside it."""
    tr, dev = ctx.traffic, ctx.device
    v = cfg["vision_config"]
    section = cfg["rope_scaling"]["mrope_section"]
    tcfg = _text_cfg(cfg)
    lo, hi = int(tr["min_pixels"]), int(tr["max_pixels"])
    keys = sorted({(ch, tile) for (ch, stage, tile), r in served.items()
                   if ch >= 0 and r["greedy"] and r["out"]})
    rng = generator.rng_for(ctx.seed, 9)
    pick = [keys[i] for i in sorted(rng.permutation(len(keys))[:int(tr["check_tiles"])])]
    weight_fn = compare.int8_channel
    head = decoder.head_weight(tree, weight_fn)
    ctl_fn = compare.int4_groups(128)
    ctl_head = decoder.head_weight(tree, ctl_fn, torch.bfloat16) if control else None
    mismatch = judged = unjudged = 0
    worst = ctl_worst = 0.0
    n_tok = 0
    for ch, tile in pick:
        t = chunks[done_chunks[ch]][tile]
        imgs = [vision.resized(t[k], lo, hi) for k in ("map", "sat")]
        grids = [vision.grid_of(im) for im in imgs]
        embeds = torch.cat([vision.tower(v, tree["vision"], im, dev) for im in imgs])
        s1 = served[(ch, "s1", tile)]
        texts = {"s1": prompts.stage1_text(t["question"])}
        if '"bbox_2d"' in prompts.text_of(s1["out"]):
            unjudged += 1                   # boxes would be rendered: not rebuilt here
        else:
            texts["s2"] = prompts.stage2_text(t["question"], "[]")
        for stage, text in texts.items():
            r = served.get((ch, stage, tile))
            if r is None or not r["out"]:
                continue
            ids = prompts.expand_images(prompts.tokenize(text), grids)
            if ids != r["prompt"]:
                mismatch += 1
                continue
            out = r["out"]
            full = ids + out[:-1]
            pos = prompts.mrope_positions(ids, grids)
            nxt = int(pos.max()) + 1
            gen = np.arange(nxt, nxt + len(out) - 1)[None].repeat(3, 0)
            pos = torch.as_tensor(np.concatenate([pos, gen], axis=1), device=dev)
            idt = torch.as_tensor(full, device=dev)
            hid = decoder.decoder_hidden(tcfg, tree, idt, pos, image_embeds=embeds,
                                         image_token_id=prompts.IMAGE_TOKEN,
                                         weight_fn=weight_fn, mrope_section=section)
            hid = hid[len(ids) - 1:]
            toks = torch.as_tensor(out, device=dev)
            worst = max(worst, float(compare.served_gaps(hid, head, toks).max()))
            if control:
                ctl = decoder.decoder_hidden(tcfg, tree, idt, pos, image_embeds=embeds,
                                             image_token_id=prompts.IMAGE_TOKEN,
                                             weight_fn=ctl_fn, dtype=torch.bfloat16,
                                             mrope_section=section)[len(ids) - 1:]
                ctl_worst = max(ctl_worst, float(compare.control_gaps(hid, head, ctl,
                                                                      ctl_head).max()))
            judged += 1
            n_tok += len(out)
    readings = {"judged_requests": judged, "judged_tokens": n_tok,
                "unjudged_stage2": unjudged, "served_gap_max": worst}
    if control:
        readings["control_gap_max"] = ctl_worst
        worst = ctl_worst
    if not judged:
        worst = float("inf")
    checks = compare.check("served_gap_max", worst, ctx.limits["served_gap_max"])
    checks.update(compare.check("prompt_mismatch", mismatch, 0))
    return checks, readings
