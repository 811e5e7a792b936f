"""RLVR's rollout half through the port's RLVR path, as RLVRPipeline drives it
(examples/train/rlvr_tpu.yaml): DynamicSamplingScheduler.get_batch of
`rollout_batch_size` prompt groups of n samples over one TorchDecodeStrategy
(a DecodeEngine of `max_running_requests` slots, its decode step replayed as
a CUDA graph, prefix fork on, bf16 weights and cache), filters off, each
group's math-rule reward as it completes. A closed loop: a completed group
is replaced by the next prompt the scheduler pulls, and a batch that fills
before the window closes is followed by the next, as RLVRPipeline calls
get_batch once a step (the batch's end aborts what it still holds).

Rows are drawn from the seed: prompt token ids, lognormal prompt lengths
and, as each row's own `max_new_tokens`, a lognormal response length (the
drawn cap stands in for the end of text that random weights never choose).
Every `greedy_every`-th group decodes greedily with at least
`greedy_min_response` tokens, for the check.

The window opens at the first engine step that finds `warm_groups` groups
completed and every slot taken (running or waiting), and closes at the
first engine step at or after --seconds; then the dataset stops and the
scheduler aborts what is in flight. The groups completed are the
scheduler's `groups_done` counter. tiles_per_s: prompt groups rolled
out a second (a group is one dataset row sampled n times: in SocioReasoner's
RLVR, one tile's prompt), at the rate the loop completes them in the long
run: the tokens the engine's decode chunks sampled in the window
(`decode_tokens`) over its seconds, divided by the tokens a group of the
traffic samples on average (`mean_group_tokens`, the same for every seed).
Whole groups ending in a 51 s window are too few to count: ~40, whose
number moves 10-15% with the seed's response lengths. Spans are recorded (utils/profiling.recording) from the batch's
start to the window's end, so that every group completed in the window
has its rollout.group span. A `--trace 1` run profiles the window's last
`trace_steps` engine steps, device activity alone, from the first step
that admits a group (so the slice holds a prefill) once at most
`trace_lead_s` seconds of the window are left, and closes the window where
the slice ends (the trace's export and reading fall after it); the readers
that divide by wall time take the mean wall of the window's untraced runs
of as many engine steps that also begin with an admission. A watchdog ends
the run with an error when no decode step completes for `stall_s` seconds.

Correctness: after the window, with the program freed, the plain reference
rebuilds the greedy sequences served in the window (completed in it, or in
a slot when it closed: the tokens served by then) of up to `check_groups`
groups, longest first, each group's first request and one sibling drawn
from the seed, from their prompts alone: one forward over prompt and
response in float32, and at each served position the gap of the served
token's logit below the reference's best. Two numbers are held to their
limits: the widest gap (served_gap_max), which a single wrong token
exceeds, and the mean gap over every checked position (served_gap_mean).
Rounding flips a token only where the reference's best two logits lie
closer than the rounding's error, and then by less than that error, so the
mean grows as the square of the error: one precision lower moves it by far
more than it moves the widest gap, and no single position dominates it.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np
import torch

import generator
import weights
from engine_records import model_shape
from reference import compare, decoder


class WindowClosed(Exception):
    """Raised by the dataset once the window has closed: the scheduler then
    aborts what is in flight and returns."""


def rows(tr: Dict, vocab: int, seed: int):
    """Endless dataset rows drawn from the seed: {"prompt_ids",
    "max_new_tokens", "temperature", "tag", "ground_truth"}."""
    rng = generator.rng_for(seed, 11)

    def lognormal(median, sigma, lo, hi):
        return int(np.clip(round(float(np.exp(rng.normal(np.log(median), sigma)))), lo, hi))
    r = 0
    while True:
        P = lognormal(tr["prompt_median"], tr["prompt_sigma"], tr["prompt_min"], tr["prompt_max"])
        ids = rng.integers(tr["token_min"], vocab, P)
        cap = lognormal(tr["response_median"], tr["response_sigma"], tr["response_min"],
                        tr["response_max"])
        temp = float(tr["temperature"])
        if r % int(tr["greedy_every"]) == 0:
            cap = int(rng.integers(tr["greedy_min_response"], tr["response_max"] + 1))
            temp = 0.0
        yield {"prompt_ids": ids.tolist(), "max_new_tokens": cap, "temperature": temp,
               "tag": "math", "ground_truth": ""}
        r += 1


def mean_group_tokens(tr: Dict) -> float:
    """The tokens a group of `rows` samples on average: n x the mean drawn
    cap, one group in `greedy_every` drawn uniformly from
    `greedy_min_response` to `response_max`, the others' lognormal cap
    (rounded and clipped) by quadrature over the normal."""
    z = np.linspace(-12.0, 12.0, 480001)
    w = np.exp(-0.5 * z * z)
    caps = np.clip(np.round(np.exp(np.log(tr["response_median"]) + tr["response_sigma"] * z)),
                   tr["response_min"], tr["response_max"])
    sampled = float((w * caps).sum() / w.sum())
    greedy = (tr["greedy_min_response"] + tr["response_max"]) / 2
    g = 1.0 / int(tr["greedy_every"])
    return int(tr["num_return_sequences"]) * ((1.0 - g) * sampled + g * greedy)


def collate(P: int, pad: int):
    """One-row batches of left-padded prompt ids (1-D positions: the engine's
    own arange)."""
    from socioreasoner_tpu_torch.protocol import BatchProto

    def fn(batch_rows):
        ids = np.full((len(batch_rows), P), pad, np.int64)
        attn = np.zeros((len(batch_rows), P), np.int64)
        for i, r in enumerate(batch_rows):
            ids[i, P - len(r["prompt_ids"]):] = r["prompt_ids"]
            attn[i, P - len(r["prompt_ids"]):] = 1
        return BatchProto.from_dict(tensors={"input_ids": ids, "attention_mask": attn},
                                    meta={"pad_token_id": pad})
    return fn


class Boundary:
    """The engine's step and the strategy's request boundary, on the
    server's thread: the window, the traced slice and its work records,
    the requests served and the groups completed."""

    def __init__(self, ctx, strategy):
        from socioreasoner_tpu_torch.generation.server import GenerateRequestType
        self.ctx, self.tr = ctx, ctx.traffic
        self.engine = e = strategy.engine
        self._step = e.step
        e.step = self.step
        self.phase = "warm"
        self.closed = threading.Event()
        self.batch = 0                         # get_batch calls before the current one
        self.requests: Dict = {}               # (batch, request id) -> record
        self.attempted = self.failed = 0
        self.greedy_cut = 0                    # greedy requests in a slot when the window closed
        self.starts: List[float] = []          # every engine step's start (perf_counter)
        self.admits: List[bool] = []           # whether the step began with requests waiting
        self.win = {}                          # the window's bounds and counts
        self.tracing = False
        self.slice_steps = (0, 0)
        self.work = {"prefill": [], "decode": []}
        self.slice_counts: Dict = {}
        self.recorder = None
        orig = strategy.add_request
        add_kind = GenerateRequestType.ADD

        def add(command, data, _orig=orig):
            if command == add_kind:
                data = self._admit(data)
            return _orig(command, data)
        strategy.add_request = add

    def _admit(self, data):
        rec = {"prompt": list(data["prompt_ids"]), "greedy": not data["sampling"].do_sample,
               "out": None, "phase": None}
        self.requests[(self.batch,) + tuple(data["request_id"])] = rec
        cb = data["callback"]

        def done(out, _rec=rec, _cb=cb):
            _rec["out"] = list(out.output_ids)
            _rec["reason"] = out.finish_reason
            _rec["phase"] = self.phase
            if self.phase == "window":
                self.attempted += 1
                self.failed += out.finish_reason not in ("stop", "length")
            return _cb(out)
        return dict(data, callback=done)

    def _groups_done(self) -> int:
        return self.recorder.counters().get("groups_done", 0) if self.recorder else 0

    def _counts(self):
        e = self.engine
        return {"decode_tokens": e.decode_tokens, "decode_steps": e.steps_executed,
                "graph_steps": e.graph_steps, "graph_captures": e.graph_captures,
                "prefill_rows": e.prefill_rows, "forked_requests": e.forked_requests,
                "groups_done": self._groups_done()}

    def step(self):
        e, tr, sl = self.engine, self.tr, self.ctx.slice
        now = time.perf_counter()
        self.starts.append(now)
        self.admits.append(bool(e.waiting))
        i = len(self.starts) - 1
        if (self.phase == "warm" and self._groups_done() >= int(tr["warm_groups"])
                and len(e.slot_req) + len(e.waiting) >= e.S):
            self.phase = "window"
            self.win.update(t0=now, t0_epoch=time.time(), t0_ns=time.time_ns(), first=i,
                            c0=self._counts())
        elif self.phase == "window":
            left = self.ctx.seconds - (now - self.win["t0"])
            if self.tracing:
                if i - self.slice_steps[0] >= int(tr["trace_steps"]):
                    self._close(now, i)        # the trace's export falls after the window
                    self._stop_slice(sl, i)
            elif sl is not None:               # the slice: the window's last engine steps
                if (left <= float(tr["trace_lead_s"])
                        and i - self.win["first"] >= int(tr["trace_after_steps"]) and e.waiting):
                    self.tracing = True
                    self.slice_steps = (i, i)
                    self._s0 = self._counts()
                    sl.start()
            elif left <= 0:
                self._close(now, i)
        if self.tracing:
            return self._recorded_step()
        return self._step()

    def _close(self, now, i):
        e = self.engine
        self.win.update(t1=now, t1_ns=time.time_ns(), last=i, c1=self._counts())
        for r in e.slot_req.values():                       # greedy requests cut here
            rec = self.requests.get((self.batch,) + tuple(r.request_id))
            if rec is not None and rec["greedy"]:
                rec["window_out"] = list(r.output_ids)
                self.greedy_cut += 1
        self.phase = "closed"
        self.closed.set()

    def _stop_slice(self, sl, i):
        rec = self.recorder
        if rec is not None:                 # the program's spans name the slice's idle gaps
            sl.spans.extend((f"{ev['thread']}:{ev['name']}", ev["start_ns"], ev["end_ns"])
                            for ev in rec.events()
                            if ev["end_ns"] > sl.t0_ns and ev["start_ns"] < time.time_ns())
        c = self._counts()
        self.slice_counts = {k: c[k] - self._s0[k] for k in c}
        self.slice_steps = (self.slice_steps[0], i)
        self.tracing = False
        sl.stop()

    def _recorded_step(self):
        """One engine step with its work records: the prefill's prompt
        lengths (the rows admitted that hold their whole prompt: a fork
        holds its prompt less one row, which its first step writes) and the
        decode chunk's slots' cache lengths before it."""
        e = self.engine
        pre = {slot: int(e.lengths[slot]) for slot in e.slot_req}
        pre_ids = {r.request_id for r in e.slot_req.values()}
        steps0, pref0 = e.steps_executed, e.prefill_rows
        outs = self._step()
        steps = e.steps_executed - steps0
        kv0 = list(pre.values())
        prefilled = []
        for slot, r in e.slot_req.items():
            if r.request_id in pre_ids:
                continue
            k = int(e.lengths[slot]) - steps
            kv0.append(k)
            if k == len(r.prompt_ids):
                prefilled.append(k)
        if e.prefill_rows > pref0:
            self.work["prefill"].append({"lens": prefilled[:e.prefill_rows - pref0]})
        if steps:
            self.work["decode"].append({"kv0": kv0, "steps": steps})
        return outs


def _watchdog(engine, done: threading.Event, stall_s: float):
    """End the process with an error once no decode step has completed for
    stall_s seconds while the rollout runs (a kernel that never returns)."""
    last, seen = engine.steps_executed, time.perf_counter()
    while not done.wait(5.0):
        if engine.steps_executed != last:
            last, seen = engine.steps_executed, time.perf_counter()
        elif time.perf_counter() - seen > stall_s:
            print(f"benchmark: no decode step for {stall_s:.0f} s; the rollout is stuck",
                  file=sys.stderr, flush=True)
            os._exit(4)


def run(ctx) -> Dict:
    from socioreasoner_tpu_torch.configs.rlvr_config import RLVRConfig
    from socioreasoner_tpu_torch.distributed.torch_strategies import TorchDecodeStrategy
    from socioreasoner_tpu_torch.models.llm import config_from_hf_dict
    from socioreasoner_tpu_torch.pipeline.rlvr.rewards.math_rule import compute_math_rewards
    from socioreasoner_tpu_torch.runtime.generate_scheduler import (DynamicSamplingScheduler,
                                                                    LocalGenerateGroup)
    from socioreasoner_tpu_torch.utils import profiling

    if not hasattr(profiling, "count"):
        raise RuntimeError("the program keeps no rollout counters (utils/profiling.count): "
                           "it cannot open this cell's window")
    tr, dev, hf = ctx.traffic, ctx.device, ctx.config
    marks = [("start", time.perf_counter())]
    tree = weights.text_weights(hf, ctx.seed, dev)
    marks.append(("weights", time.perf_counter()))
    out_dir = tempfile.mkdtemp(prefix="bench_rollout_")
    n = int(tr["num_return_sequences"])
    cfg = RLVRConfig(exp_name="rlvr_rollout_benchmark", output_dir=out_dir,
                     logging_dir=out_dir, track_with="stdout", save_steps=-1,
                     rollout_batch_size=int(tr["rollout_batch_size"]),
                     num_return_sequences_in_group=n, generate_opt_level=1,
                     prompt_length=int(tr["prompt_max"]),
                     response_length=int(tr["response_max"]),
                     max_running_requests=int(tr["max_running_requests"]),
                     is_use_additional_prompts=False,
                     max_additional_running_prompts=int(tr["max_additional_running_prompts"]))
    ga = cfg.actor_infer.generating_args
    ga.max_new_tokens, ga.num_return_sequences = cfg.response_length, n
    ga.temperature, ga.top_p, ga.top_k = tr["temperature"], tr["top_p"], tr["top_k"]
    mcfg = config_from_hf_dict(hf)
    chunk = int(tr["decode_chunk"])
    strategy = TorchDecodeStrategy(worker_config=cfg.actor_infer)
    strategy.initialize(mcfg, dict(tree), engine_kwargs={
        "max_slots": cfg.max_running_requests,
        # the cache: Lalloc = the longest prompt and response, of which the
        # engine keeps decode_chunk rows of slack
        "max_len": cfg.sequence_length - chunk, "decode_chunk": chunk,
        "prefill_buckets": tuple(tr["prefill_buckets"]), "prefix_fork": True,
        "seed": ctx.seed & generator.SEED_MASK})
    engine = strategy.engine
    sched = DynamicSamplingScheduler(
        LocalGenerateGroup([strategy]), collate(cfg.prompt_length, mcfg.pad_token_id),
        reward_fns={"math": lambda texts, rs: compute_math_rewards(
            texts, [r.get("ground_truth", "") for r in rs])},
        is_use_additional_prompts=cfg.is_use_additional_prompts,
        max_running_requests=cfg.max_running_requests,
        max_additional_running_prompts=cfg.max_additional_running_prompts,
        alive_check_interval=cfg.alive_check_interval)
    boundary = Boundary(ctx, strategy)
    marks.append(("engine", time.perf_counter()))

    def dataset():
        for row in rows(tr, int(hf["vocab_size"]), ctx.seed):
            if boundary.closed.is_set():
                raise WindowClosed
            yield row

    box: Dict = {}
    finished = threading.Event()

    def rollout():
        try:
            with profiling.recording() as rec:
                boundary.recorder = box["rec"] = rec
                pulls = dataset()
                while not boundary.closed.is_set():     # one batch a step, as RLVRPipeline
                    sched.get_batch(pulls, cfg.rollout_batch_size, ga)
                    boundary.batch += 1
        except WindowClosed:
            pass
        except BaseException as exc:  # noqa: BLE001 — reported on the main thread
            box["error"] = exc
        finally:
            finished.set()

    if dev.type == "cuda":
        threading.Thread(target=_watchdog, args=(engine, finished, float(tr["stall_s"])),
                         name="watchdog", daemon=True).start()
    worker = threading.Thread(target=rollout, name="rollout")
    worker.start()
    worker.join()
    if "error" in box:
        raise box["error"]
    if boundary.phase != "closed":
        raise RuntimeError(f"the rollout ended in its {boundary.phase} phase, before the "
                           "window closed")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec = box["rec"]
    win, S = boundary.win, engine.S
    c = {k: win["c1"][k] - win["c0"][k] for k in win["c0"]}
    window_s = win["t1"] - win["t0"]
    counters = dict(c, slots=S)
    kernel3 = {k: v for k, v in rec.counters().items() if k.startswith("k3.")}
    # the untraced wall of the slice's work: the mean wall of the window's
    # untraced runs of as many engine steps, each begun, as the slice is,
    # by a step that admits
    cadence = [b - a for a, b in zip(boundary.starts, boundary.starts[1:])]
    lo, hi = boundary.slice_steps
    walls = [sum(cadence[i:i + hi - lo]) for i in range(win["first"], lo - (hi - lo) + 1)
             if boundary.admits[i]]
    untraced_wall = sum(walls) / len(walls) if hi > lo and walls else None
    setup = {b[0]: round(b[1] - a[1], 3) for a, b in zip(marks, marks[1:])}
    setup["warm"] = round(win["t0"] - marks[-1][1], 3)
    requests = boundary.requests
    attempted, failed = boundary.attempted, boundary.failed

    # ---- free the program's state, then the reference
    del strategy, sched, engine, boundary.engine, boundary._step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    checks, readings = judge(ctx, hf, tree, requests, control=getattr(ctx, "control", False))
    spans = rec.events()
    groups_s = [(ev["end_ns"] - ev["start_ns"]) / 1e9 for ev in spans
                if ev["name"] == "rollout.group" and win["t0_ns"] <= ev["end_ns"] <= win["t1_ns"]]
    gen_tokens_per_s = c["decode_tokens"] / window_s
    group_tokens = mean_group_tokens(tr)
    return {"e2e": {"tiles_per_s": gen_tokens_per_s / group_tokens},
            "window_start_epoch": win["t0_epoch"], "window_s": window_s,
            "attempted": attempted, "failed": failed, "checks": checks,
            "readings": dict(readings, window_counts=c, kernel3_calls=kernel3,
                             setup_parts=setup, window_steps=c["decode_steps"],
                             batches_filled=boundary.batch, greedy_cut=boundary.greedy_cut,
                             gen_tokens_per_s=gen_tokens_per_s,
                             mean_group_tokens=group_tokens,
                             slot_use=c["decode_tokens"] / max(c["decode_steps"] * S, 1),
                             fork_share=c["forked_requests"] / max(
                                 c["forked_requests"] + c["prefill_rows"], 1),
                             groups_in_window=len(groups_s),
                             group_s_mean=(sum(groups_s) / len(groups_s) if groups_s
                                           else None)),
            "memory_peak_bytes": peak,
            "reader": {"shape": model_shape(hf), "counters": counters,
                       "slice_counts": boundary.slice_counts, "work": boundary.work,
                       "untraced_wall_s": untraced_wall, "spans": spans,
                       "window_ns": (win["t0_ns"], win["t1_ns"])}}


def checked_sequences(requests: Dict, groups: int, seed: int) -> List:
    """The greedy sequences served in the window, (prompt, served tokens):
    of the `groups` groups with the longest, each group's first request
    (the prefix's leader) and one sibling drawn from the seed. A request's
    key is (batch, group, sample, replica)."""
    by_group: Dict = {}
    for key, r in requests.items():
        out = r["out"] if r["phase"] == "window" else r.get("window_out")
        if r["greedy"] and out:
            by_group.setdefault(key[:2], {})[key[2]] = (r["prompt"], out)
    order = sorted(by_group, key=lambda g: (-max(len(p) + len(o) for p, o in
                                                  by_group[g].values()), g))
    rng = generator.rng_for(seed, 9)
    picked = []
    for g in order[:groups]:
        members = by_group[g]
        js = sorted(members)
        picked.append(members[js[0]])
        if len(js) > 1:
            picked.append(members[js[1 + int(rng.integers(0, len(js) - 1))]])
    return picked


def gap_readings(who: str, gaps: List[torch.Tensor]) -> Dict:
    """The widest and the mean gap over every checked position, and the
    share of positions whose token is not the reference's best."""
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    if not g.numel():
        return {f"{who}_gap_max": float("inf"), f"{who}_gap_mean": float("inf"),
                f"{who}_flip_share": None}
    return {f"{who}_gap_max": float(g.max()), f"{who}_gap_mean": float(g.mean()),
            f"{who}_flip_share": float((g > 0).float().mean())}


def judge(ctx, hf, tree, requests, control=False):
    """served_gap_max and served_gap_mean over the checked greedy sequences.
    With `control`, the control is put in the program's place: both are
    held to their limits at the tokens the control puts first (its
    readings, control_gap_*), the program's own readings kept beside
    them."""
    tr, dev = ctx.traffic, ctx.device
    seqs = checked_sequences(requests, int(tr["check_groups"]), ctx.seed)
    head = decoder.head_weight(tree)
    ctl_fn = compare.int8_channel
    ctl_head = decoder.head_weight(tree, ctl_fn, torch.bfloat16) if control else None
    gaps, ctl_gaps, lengths = [], [], []
    for prompt, out in seqs:
        ids = torch.as_tensor(prompt + out[:-1], device=dev)
        pos = torch.arange(ids.shape[0], device=dev)
        hid = decoder.decoder_hidden(hf, tree, ids, pos)[len(prompt) - 1:]
        toks = torch.as_tensor(out, device=dev)
        gaps.append(compare.served_gaps(hid, head, toks).cpu())
        if control:
            ctl = decoder.decoder_hidden(hf, tree, ids, pos, weight_fn=ctl_fn,
                                         dtype=torch.bfloat16)[len(prompt) - 1:]
            ctl_gaps.append(compare.control_gaps(hid, head, ctl, ctl_head).cpu())
        lengths.append([len(prompt), len(out)])
        del hid
    readings = {"judged_requests": len(seqs), "judged_tokens": sum(o for _, o in lengths),
                "judged_lengths": lengths, **gap_readings("served", gaps)}
    judged = "served"
    if control:
        readings.update(gap_readings("control", ctl_gaps))
        judged = "control"
    checks = {}
    for name in ("served_gap_max", "served_gap_mean"):
        checks.update(compare.check(name, readings[name.replace("served", judged)],
                                    ctx.limits[name]))
    return checks, readings
