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

One GPU serves one decode replica (data-parallel replicas wait for the
multi-GPU slice). DynamicSamplingScheduler and RequestScheduler belong to
the generic RLVR and agentic pipelines and are not ported yet.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List

import numpy as np

from ..generation.sampling import SamplingParams
from ..generation.server import GenerateRequestType
from ..protocol import BatchProto


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
        if len(strategies) != 1:
            raise NotImplementedError(
                "more than one decode replica is not ported yet (ROADMAP: multi-GPU)")
        self.workers = list(strategies)

    def start_server(self):
        for s in self.workers:
            s.start_server()

    def stop_server(self):
        for s in self.workers:
            s.stop_server()

    def generate(self, batch: BatchProto, generating_args):
        """Batch generate on the replica: (len(batch) * n, P + max_out) rows."""
        return self.workers[0].generate(batch, generating_args)
