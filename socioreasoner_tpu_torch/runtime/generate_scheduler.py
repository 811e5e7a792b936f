"""Rollout scheduling over in-process decode strategies.

The port's own copy of GlobalCounter, GenerateScheduler and
LocalGenerateGroup from socioreasoner_tpu/runtime/generate_scheduler.py:

  GenerateScheduler — opt level 0: the group's batch generate with
    num_return_sequences expansion; opt level 1: request-level streaming,
    all n samples of a prompt to the least-loaded replica (so the engine's
    prefix fork prefills the prompt once), alive-check pings, ABORT of a
    prompt's sibling requests once it has n, and the output re-padded and
    ordered by (prompt, sample).
  LocalGenerateGroup — the pipelines' cluster facade over the strategies.
  RequestScheduler — one request at a time for the agentic env loops: a
    sticky worker per request source (an env thread), a caller blocked
    until its request finishes, aborts and timeouts.
  DynamicSamplingScheduler — the generic RLVR pipeline's dataset-pulling
    rollout: prompt groups streamed into the servers under flow control,
    rewards per group as it completes, query and response filters whose
    rejected groups are replaced by further pulls, and the ABORT of what is
    still in flight once the target is met. A dataset row may carry its own
    `max_new_tokens` and `temperature` over the batch's generating_args.
    While spans are recorded (utils/profiling.py): `rollout.batch` (one
    get_batch), `rollout.group` (a group's first submission to its n-th
    response: n, prompt_len, tokens), `rollout.reward` (a finished group's
    reward call), and the counters `responses_done` and `groups_done`.

Several decode replicas (actor_infer dp_size) serve side by side, each on
its own device or sharing one, and each behind its own server thread. The
schedulers move host ids and texts only: every CUDA call runs on a server's
thread (or, for LocalGenerateGroup.generate, on one thread a replica), and
the request callbacks fire there.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np

from ..generation.sampling import SamplingParams
from ..generation.server import GenerateRequestType
from ..protocol import BatchProto
from ..utils import profiling


class GlobalCounter:
    """Monotonic id source."""

    def __init__(self):
        self._count = itertools.count()
        self._lock = threading.Lock()

    def get_value(self) -> int:
        with self._lock:
            return next(self._count)


class GenerateScheduler:
    def __init__(self, cluster, pipeline_config=None):
        self.cluster = cluster
        self.pipeline_config = pipeline_config
        self.counter = GlobalCounter()
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- level 0
    def generate(self, batch: BatchProto, generating_args,
                 opt_level: int = 0) -> BatchProto:
        if opt_level == 0:
            return self.cluster.generate(batch, generating_args)
        return self.generate_requests(batch, generating_args)

    # ---------------------------------------------------------------- level 1
    def generate_requests(self, batch: BatchProto, generating_args,
                          alive_check_interval: float = 10.0) -> BatchProto:
        """Request-level streaming with abort-on-complete: a batch with
        output (len(batch) * n, P + max_out) rows of [left-padded prompt |
        right-padded response], ordered by (prompt, sample)."""
        n = generating_args.num_return_sequences
        num_prompts = len(batch)
        collected: Dict[int, List] = {i: [] for i in range(num_prompts)}
        inflight: Dict[Any, int] = {}
        done = threading.Event()
        lock = threading.Lock()

        workers = self.cluster.workers
        loads = [0] * len(workers)

        self.cluster.start_server()

        def report_response(out):
            """Per-request completion callback (on the server's thread)."""
            with lock:
                prompt_id = inflight.pop(out.request_id, None)
                if prompt_id is None:
                    return
                loads[out.request_id[2]] -= 1
                if len(collected[prompt_id]) < n:
                    collected[prompt_id].append(out)
                if len(collected[prompt_id]) >= n:
                    # abort sibling requests still running for this prompt
                    for rid, pid in list(inflight.items()):
                        if pid == prompt_id:
                            workers[rid[2]].add_request(
                                GenerateRequestType.ABORT, {"request_id": rid})
                            inflight.pop(rid, None)
                            loads[rid[2]] -= 1
                if all(len(v) >= n for v in collected.values()):
                    done.set()

        sp = SamplingParams.from_generating_args(generating_args)
        embeds = batch.meta.get("image_embeds_list")
        for i in range(num_prompts):
            ids = np.asarray(batch.batch["input_ids"][i])
            attn = np.asarray(batch.batch["attention_mask"][i])
            valid = attn == 1
            prompt_ids = ids[valid].tolist()
            pos = None
            if "position_ids" in batch.batch:
                pos = np.asarray(batch.batch["position_ids"][i])[:, valid]
            # the least-loaded worker, chosen once a prompt: all n siblings
            # go to one worker so that its prefix fork prefills the prompt
            # once (load still balances at prompt granularity)
            with lock:
                w = int(np.argmin(loads))
                loads[w] += n
            for j in range(n):
                rid = (i, j, w)
                with lock:
                    inflight[rid] = i
                workers[w].add_request(GenerateRequestType.ADD, {
                    "request_id": rid, "prompt_ids": prompt_ids,
                    "sampling": sp, "position_ids": pos,
                    "image_embeds": None if embeds is None else embeds[i],
                    "callback": report_response})

        last_ping = time.time()
        while not done.wait(timeout=0.05):
            if time.time() - last_ping > alive_check_interval:
                for w in workers:
                    w.add_request(GenerateRequestType.ALIVE_CHECK, None)
                last_ping = time.time()
        self.cluster.stop_server()

        pad_id = batch.meta.get(
            "pad_token_id",
            generating_args.extra_fields.get("pad_token_id", 0)
            if hasattr(generating_args, "extra_fields") else 0)
        P = np.asarray(batch.batch["input_ids"]).shape[1]
        max_out = max((len(o.output_ids) for outs in collected.values()
                       for o in outs), default=0)
        result = np.full((num_prompts * n, P + max_out), pad_id, np.int64)
        for i in range(num_prompts):
            outs = sorted(collected[i], key=lambda o: o.request_id[1])
            for j, o in enumerate(outs[:n]):
                row = i * n + j
                result[row, :P] = np.asarray(batch.batch["input_ids"][i])
                result[row, P:P + len(o.output_ids)] = o.output_ids
        return BatchProto.from_dict(tensors={"output": result})


class LocalGenerateGroup:
    """Cluster facade over in-process decode strategies; each must expose
    start_server/stop_server/add_request/generate."""

    def __init__(self, strategies: List):
        self.workers = list(strategies)

    def start_server(self):
        for s in self.workers:
            s.start_server()

    def stop_server(self):
        for s in self.workers:
            s.stop_server()

    def generate(self, batch: BatchProto, generating_args):
        """Batch generate: (len(batch) * n, P + max_out) rows. With more than
        one decode replica the batch splits into one contiguous chunk a
        replica, the chunks generate concurrently on threads (each replica's
        engine on its own device, or sharing one), and each chunk's rows are
        re-padded to the widest before they are concatenated in order."""
        if len(self.workers) == 1:
            return self.workers[0].generate(batch, generating_args)
        n_w = min(len(self.workers), len(batch))
        chunks = batch.chunk(n_w)
        # meta copies whole through slice(): re-split the per-sample image
        # embeddings to match each chunk's rows
        embeds = batch.meta.get("image_embeds_list")
        if embeds is not None:
            start = 0
            for c in chunks:
                c.meta = dict(c.meta)
                c.meta["image_embeds_list"] = embeds[start:start + len(c)]
                start += len(c)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=n_w) as ex:
            outs = list(ex.map(lambda wc: wc[0].generate(wc[1], generating_args),
                               zip(self.workers, chunks)))
        pad_id = batch.meta.get("pad_token_id", 0)
        width = max(o.shape[1] for o in outs)
        full = [np.pad(o, ((0, 0), (0, width - o.shape[1])), constant_values=pad_id)
                for o in outs]
        return np.concatenate(full, axis=0)


def row_sampling(sp: SamplingParams, row, generating_args) -> SamplingParams:
    """The sampling of one dataset row: the batch's `sp`, with the row's
    own `max_new_tokens` and `temperature` where it sets them (a
    temperature of 0 or less decodes greedily, as in generating_args)."""
    if not isinstance(row, Mapping):
        return sp
    over = {}
    if "max_new_tokens" in row:
        over["max_new_tokens"] = int(row["max_new_tokens"])
    if "temperature" in row:
        t = float(row["temperature"])
        over["temperature"] = max(t, 1e-5)
        over["do_sample"] = bool(getattr(generating_args, "do_sample", True)) and t > 0
    return dataclasses.replace(sp, **over) if over else sp


class DynamicSamplingScheduler:
    """Concurrent dataset-pulling rollout with flow control.

    Streams prompts from the dataset into the decode servers, keeping many
    prompt GROUPS (one prompt x n samples) in flight at once:

      * flow control: `max_running_requests` caps the concurrent requests of
        a worker, `max_additional_running_prompts` the groups in flight
        beyond the target batch size;
      * least-loaded routing, one worker a group (so that its prefix fork
        prefills the prompt once);
      * the domain's reward for each group as it completes, on this thread,
        while the server's thread goes on decoding;
      * `response_filter(row, output_ids)` drops single samples,
        `query_filter(row, group_outputs)` drops whole groups; a rejected
        group is REPLACED by pulling more prompts, up to
        `max_prompt_use_factor` times the target;
      * alive-check pings, and the ABORT of every request still in flight
        once the target is met (the server's STOP then drains the engine);
      * scheduler metrics, per domain too.

    `is_use_additional_prompts=False` disables both filters.
    """

    def __init__(self, cluster, collate_fn: Callable, *,
                 reward_fns: Optional[Dict[str, Callable]] = None,
                 detokenize: Optional[Callable] = None,
                 query_filter: Optional[Callable] = None,
                 response_filter: Optional[Callable] = None,
                 is_use_additional_prompts: bool = True,
                 max_running_requests: int = 128,
                 max_additional_running_prompts: int = 16,
                 alive_check_interval: float = 10.0,
                 max_prompt_use_factor: int = 10):
        self.cluster = cluster
        self.collate_fn = collate_fn
        self.reward_fns = reward_fns or {}
        self.detokenize = detokenize or (lambda ids: "")
        if is_use_additional_prompts:
            self.query_filter = query_filter or (lambda row, outs: True)
            self.response_filter = response_filter or (lambda row, out: True)
        else:
            self.query_filter = lambda row, outs: True
            self.response_filter = lambda row, out: True
        self.max_running_requests = max_running_requests
        self.max_additional_running_prompts = max_additional_running_prompts
        self.alive_check_interval = alive_check_interval
        self.max_prompt_use_factor = max_prompt_use_factor

    def get_batch(self, dataset_iter, target_prompts: int, generating_args) -> BatchProto:
        """The collated batch of `target_prompts` accepted prompts, with meta:
        output, (N * n, P + max_out) right-padded sequences ordered by
        (prompt, sample); scores and response_level_rewards, (N * n,), when
        reward_fns are set; metrics, the scheduler's."""
        with profiling.span("rollout.batch", target=target_prompts):
            return self._get_batch(dataset_iter, target_prompts, generating_args)

    def _get_batch(self, dataset_iter, target_prompts: int, generating_args) -> BatchProto:
        n = generating_args.num_return_sequences
        sp = SamplingParams.from_generating_args(generating_args)
        workers = self.cluster.workers
        lock = threading.Lock()
        cond = threading.Condition(lock)
        loads = [0] * len(workers)

        groups: Dict[int, Dict] = {}        # gid -> state
        ready: List[int] = []               # gids with all requests finished
        accepted: List[Dict] = []
        stats = {"query_filter_count": 0, "response_filter_count": 0,
                 "prompt_use_count": 0, "max_inflight_prompts": 0}
        domain_scores: Dict[str, List[float]] = {}
        stopped = threading.Event()

        def on_done(out):
            """A request's completion, on the server's thread."""
            gid, j, w = out.request_id
            with cond:
                g = groups.get(gid)
                if g is None or stopped.is_set():
                    return
                loads[w] -= 1
                g["pending"].discard((gid, j, w))
                if out.finish_reason != "abort":
                    g["outs"].append(out)
                    profiling.count("responses_done")
                if not g["pending"]:
                    profiling.count("groups_done")
                    if g["span"] is not None:
                        g["span"].close(tokens=sum(len(o.output_ids) for o in g["outs"]))
                    ready.append(gid)
                    cond.notify_all()

        self.cluster.start_server()
        gid_counter = itertools.count()
        max_prompt_use = max(target_prompts * self.max_prompt_use_factor,
                             target_prompts + self.max_additional_running_prompts)
        exhausted = False
        last_ping = time.time()
        try:
            while len(accepted) < target_prompts:
                # ---- admit new prompt groups under flow control
                while not exhausted:
                    with lock:
                        room_prompts = (len(groups) + len(accepted)
                                        < target_prompts + self.max_additional_running_prompts)
                        least = int(np.argmin(loads))
                        room_reqs = loads[least] + n <= self.max_running_requests
                    if not (room_prompts and room_reqs):
                        break
                    if stats["prompt_use_count"] >= max_prompt_use:
                        raise RuntimeError(
                            f"dynamic sampling used {stats['prompt_use_count']} prompts "
                            f"without filling {target_prompts} accepted groups; "
                            "filters too strict?")
                    try:
                        row = next(dataset_iter)
                    except StopIteration:
                        exhausted = True
                        break
                    stats["prompt_use_count"] += 1
                    batch = self.collate_fn([row])
                    gid = next(gid_counter)
                    ids = np.asarray(batch.batch["input_ids"][0])
                    valid = np.asarray(batch.batch["attention_mask"][0]) == 1
                    pos = None
                    if "position_ids" in batch.batch:
                        pos = np.asarray(batch.batch["position_ids"][0])[:, valid]
                    embeds = (batch.meta.get("image_embeds_list") or [None])[0]
                    prompt_ids = ids[valid].tolist()
                    row_sp = row_sampling(sp, row, generating_args)
                    with lock:
                        g = {"row": row, "batch": batch, "outs": [], "pending": set(),
                             "span": profiling.begin("rollout.group", group=gid, n=n,
                                                     prompt_len=len(prompt_ids))}
                        groups[gid] = g
                        stats["max_inflight_prompts"] = max(stats["max_inflight_prompts"],
                                                            len(groups))
                        loads[least] += n
                        rids = [(gid, j, least) for j in range(n)]
                        g["pending"].update(rids)
                    for rid in rids:
                        workers[rid[2]].add_request(GenerateRequestType.ADD, {
                            "request_id": rid, "prompt_ids": prompt_ids,
                            "sampling": row_sp, "position_ids": pos,
                            "image_embeds": embeds, "callback": on_done})

                # ---- wait for a completed group (decoding goes on meanwhile)
                with cond:
                    if not ready and not groups and exhausted:
                        break
                    cond.wait(timeout=0.05)
                    done_ids, ready[:] = list(ready), []
                    done = [(gid, groups.pop(gid)) for gid in done_ids if gid in groups]

                if time.time() - last_ping > self.alive_check_interval:
                    for w in workers:
                        w.add_request(GenerateRequestType.ALIVE_CHECK, None)
                    last_ping = time.time()

                # ---- filters and the domain's reward, while decoding goes on
                for gid, g in done:
                    outs = [o for o in g["outs"]
                            if self.response_filter(g["row"], o.output_ids)]
                    stats["response_filter_count"] += len(g["outs"]) - len(outs)
                    if len(outs) < n:
                        continue            # a dead group, replaced by the admit loop
                    outs = sorted(outs, key=lambda o: o.request_id[1])[:n]
                    domain = str(g["row"].get("domain", g["row"].get("tag", "default")))
                    reward_out = None
                    if self.reward_fns:
                        fn_ = self.reward_fns.get(domain) or next(iter(self.reward_fns.values()))
                        with profiling.span("rollout.reward", group=gid, domain=domain):
                            texts = [self.detokenize(o.output_ids) for o in outs]
                            reward_out = fn_(texts, [g["row"]] * n)
                        scores = np.asarray(reward_out.get(
                            "scores", reward_out["response_level_rewards"]), np.float32)
                        domain_scores.setdefault(domain, []).extend(scores.tolist())
                    if not self.query_filter(g["row"], [o.output_ids for o in outs]):
                        stats["query_filter_count"] += 1
                        continue
                    if len(accepted) < target_prompts:
                        accepted.append({"batch": g["batch"], "outs": outs,
                                         "reward": reward_out})
        finally:
            stopped.set()
            with lock:
                leftovers = [rid for g in groups.values() for rid in g["pending"]]
            for rid in leftovers:
                workers[rid[2]].add_request(GenerateRequestType.ABORT, {"request_id": rid})
            self.cluster.stop_server()

        if not accepted:
            return BatchProto()

        out_batch = BatchProto.concat([a["batch"] for a in accepted])
        pad_id = out_batch.meta.get("pad_token_id", 0)
        P = np.asarray(out_batch.batch["input_ids"]).shape[1]
        max_out = max((len(o.output_ids) for a in accepted for o in a["outs"]), default=0)
        N = len(accepted)
        result = np.full((N * n, P + max_out), pad_id, np.int64)
        for i, a in enumerate(accepted):
            prompt_row = np.asarray(a["batch"].batch["input_ids"][0])
            for j, o in enumerate(a["outs"]):
                result[i * n + j, :P] = prompt_row
                result[i * n + j, P:P + len(o.output_ids)] = o.output_ids
        out_batch.meta["output"] = result
        if self.reward_fns:
            out_batch.meta["scores"] = np.concatenate([
                np.asarray(a["reward"].get("scores", a["reward"]["response_level_rewards"]),
                           np.float32) for a in accepted])
            out_batch.meta["response_level_rewards"] = np.concatenate([
                np.asarray(a["reward"]["response_level_rewards"], np.float32)
                for a in accepted])
        metrics = {f"scheduler/{k}": float(v) for k, v in stats.items()}
        metrics["scheduler/collect_query_count"] = float(N)
        for domain, vals in domain_scores.items():
            v = np.asarray(vals, np.float32)
            metrics[f"scheduler/{domain}/score/mean"] = float(v.mean())
            metrics[f"scheduler/{domain}/score/max"] = float(v.max())
            metrics[f"scheduler/{domain}/score/min"] = float(v.min())
        out_batch.meta["metrics"] = metrics
        return out_batch


class RequestScheduler:
    """One-request-at-a-time rollout proxy for the agentic env loops.

    Each request source (an env thread, named by the request's `src_rank`)
    gets a STICKY worker, assigned round robin at its first request, so the
    turns of one episode reach the same engine. `generate_one_request`
    blocks on the request's own event until the engine's callback fires (on
    the server's thread); after `rpc_timeout` seconds (default 3600) it
    aborts the request and raises TimeoutError. `abort_request` routes an
    ABORT to the owning worker and releases the waiter with None."""

    def __init__(self, cluster, pipeline_config=None):
        self.cluster = cluster
        self.pipeline_config = pipeline_config
        self._worker_iter = itertools.cycle(range(len(cluster.workers)))
        self._src2dp: Dict[Any, int] = {}
        self._rid2dp: Dict[Any, int] = {}
        # rid -> [threading.Event, output or None]
        self._pending: Dict[Any, List] = {}
        self._lock = threading.Lock()

    def generate_one_request(self, data: BatchProto) -> Optional[BatchProto]:
        """A single-row request → a single-row batch of [prompt | response]
        (unpadded) with `response_mask`, meta `output_token_ids` and
        `finish_reason`; None when the request was aborted or produced
        nothing."""
        rid = data.meta["request_id"]
        src = data.meta.get("src_rank", rid)
        with self._lock:
            if src not in self._src2dp:
                self._src2dp[src] = next(self._worker_iter)
            dp = self._src2dp[src]
            box = [threading.Event(), None]
            self._pending[rid] = box
            self._rid2dp[rid] = dp

        def callback(out):
            with self._lock:
                b = self._pending.pop(rid, None)
                self._rid2dp.pop(rid, None)
            if b is not None:
                b[1] = out
                b[0].set()

        ids = np.asarray(data.batch["input_ids"][0])
        attn = (np.asarray(data.batch["attention_mask"][0])
                if "attention_mask" in data.batch else np.ones_like(ids))
        valid = attn == 1
        pos = None
        if "position_ids" in data.batch:
            pos = np.asarray(data.batch["position_ids"][0])[:, valid]
        sampling = data.meta.get("sampling")
        if sampling is None:
            sampling = SamplingParams.from_generating_args(data.meta["generating_args"])
        self.cluster.workers[dp].add_request(GenerateRequestType.ADD, {
            "request_id": rid, "prompt_ids": ids[valid].tolist(),
            "sampling": sampling, "position_ids": pos,
            "image_embeds": data.meta.get("image_embeds"),
            "callback": callback})
        timeout = getattr(self.pipeline_config, "rpc_timeout", None) or 3600.0
        if not box[0].wait(timeout):
            self.abort_request(rid)
            raise TimeoutError(f"request {rid!r} timed out after {timeout}s")
        out = box[1]
        if out is None or not getattr(out, "output_ids", None):
            return None                                 # aborted
        # a single unpadded request: [prompt | response] as one row
        prompt_ids = ids[valid]
        seq = np.concatenate([prompt_ids, np.asarray(out.output_ids, np.int64)])[None]
        resp = np.zeros_like(seq)
        resp[:, len(prompt_ids):] = 1
        return BatchProto.from_dict(
            tensors={"input_ids": seq, "attention_mask": np.ones_like(seq),
                     "response_mask": resp},
            meta={**data.meta, "output_token_ids": [list(out.output_ids)],
                  "finish_reason": getattr(out, "finish_reason", None)})

    def abort_request(self, request_id) -> None:
        """Route an ABORT to the worker that owns the request and release its
        waiter with None."""
        with self._lock:
            dp = self._rid2dp.get(request_id)
            box = self._pending.pop(request_id, None)
            self._rid2dp.pop(request_id, None)
        if dp is not None:
            self.cluster.workers[dp].add_request(
                GenerateRequestType.ABORT, {"request_id": request_id})
        if box is not None:
            box[1] = None
            box[0].set()
