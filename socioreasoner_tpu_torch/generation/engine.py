"""DecodeEngine — continuous-batching autoregressive decoder in PyTorch.

The counterpart of socioreasoner_tpu/generation/engine.py on one device:

  * Slot-based KV cache: one stacked (layers, S slots, Lalloc, Hkv, D)
    tensor each for k and v. Admission and release are host bookkeeping.
    The JAX engine donates these buffers to its jitted calls; here prefill,
    decode and fork write into them IN PLACE.
  * Batched prefill at bucketed prompt lengths and padded batch sizes. Each
    row's KV is copied into its slot; padded rows are computed and dropped.
  * Chunked decode: up to `decode_chunk` tokens for all active slots per
    chunk, with ONE token readback per chunk. The JAX engine's
    lax.while_loop early exit (every slot hit a stop token or its budget)
    becomes a Python loop whose condition reads one bool per step, so
    `steps_executed` and the emitted tokens equal the JAX engine's.
    `host_syncs` counts every blocking device→host read.
  * Prefix fork: a request whose prompt is resident in another slot copies
    that slot's KV rows instead of prefilling.
  * Per-slot sampling parameters as tensors; random draws from one
    torch.Generator seeded by `seed`.
  * Quantized serving (ops/quant.py), as the JAX engine: `weight_quant`
    int8/int4 keeps a quantized `params_q` copy for decode beside the float
    tree (HYBRID), or serves a pre-quantized tree for prefill and decode
    alike (SINGLE-COPY, detected with params_prequantized); `act_quant`
    runs prefill w8a8 on the int8 tree; `kv_quant="int8"` keeps int8
    caches with f32 per-token scales (L, S, Hkv, Lalloc), read by the int8
    decode kernel; `decode_inner` splits a chunk into chained inner loops
    with one token readback.

Not ported yet (ROADMAP): meshes / tensor parallelism.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.qwen2_5_vl import model as qmodel
from ..models.qwen2_5_vl.config import Qwen25VLConfig
from ..models.qwen2_5_vl.text import check_supported
from ..ops.quant import params_prequantized, quantize_decode_params
from .sampling import SamplingParams, sample_tokens


_MISS = object()                    # sentinel: prompt not yet seen in a group


def _bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


@dataclasses.dataclass
class Request:
    request_id: Any
    prompt_ids: List[int]
    sampling: SamplingParams
    image_embeds: Optional[Any] = None          # (n_img, hidden) tensor or array
    position_ids: Optional[np.ndarray] = None   # (3, P) M-RoPE prompt positions
    callback: Optional[Callable] = None
    meta: Optional[Dict] = None
    # runtime
    slot: int = -1
    output_ids: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    aborted: bool = False


@dataclasses.dataclass
class EngineOutput:
    request_id: Any
    prompt_ids: List[int]
    output_ids: List[int]
    finish_reason: str                  # "stop" | "length" | "abort" | "error"
    meta: Optional[Dict] = None


@dataclasses.dataclass
class _PrefixEntry:
    """A forkable prompt prefix resident in some slot's KV cache, valid while
    `epoch` matches the slot's assignment epoch. `embeds` is a WEAK ref to the
    request's image embeddings: the entry dies with them, and while they live
    the identity comparison is sound."""
    slot: int
    epoch: int
    P: int                              # prompt length (cache rows 0..P-1)
    next_pos: int                       # M-RoPE position AFTER the prompt
    last_token: int                     # prompt_ids[-1]
    embeds: Any                         # weakref.ref | None
    position_ids: Any


class DecodeEngine:
    STOP_SET_K = 8   # per-slot stop-token capacity on the device; overflow
    #                  tokens only lose the in-chunk early exit

    def __init__(self, config: Qwen25VLConfig, params, *, max_slots: int = 8,
                 max_len: int = 8192, decode_chunk: int = 16, decode_inner: int = 0,
                 prefill_buckets: Tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096),
                 image_buckets: Tuple[int, ...] = (0, 512, 1024, 2048, 4096,
                                                   8192, 16384),
                 cache_dtype: torch.dtype = torch.bfloat16,
                 kv_quant: Optional[str] = None, weight_quant: Optional[str] = None,
                 max_prefill_batch: Optional[int] = None, seed: int = 0,
                 device=None, prefill_batch_sizes: Optional[Tuple[int, ...]] = None,
                 prefix_fork: bool = True, act_quant: Optional[str] = None):
        if weight_quant not in (None, "int8", "int4"):
            raise ValueError(f"weight_quant must be None, 'int8' or 'int4', "
                             f"got {weight_quant!r}")
        if act_quant not in (None, "int8"):
            raise ValueError(f"act_quant must be None or 'int8', got {act_quant!r}")
        if act_quant and weight_quant != "int8":
            raise ValueError("act_quant='int8' requires weight_quant='int8' "
                             "(w8a8 runs on the int8 weight tree)")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', got {kv_quant!r}")
        if decode_inner and decode_chunk % decode_inner:
            raise ValueError(f"decode_chunk={decode_chunk} must be a "
                             f"multiple of decode_inner={decode_inner}")
        check_supported(config.text)
        self.config = config
        self.weight_quant = weight_quant
        self.act_quant = bool(act_quant)
        self.kv_quant = kv_quant
        self.decode_inner = decode_inner
        self.device = torch.device(device) if device is not None else params["embed"].device
        self.params = self._to_device(params)
        self.params_q = None              # HYBRID mode's quantized decode copy
        self._derive_params_q()
        self.S = max_slots
        self.Lmax = max_len
        self.decode_chunk = decode_chunk
        self.prefill_buckets = tuple(b for b in prefill_buckets if b <= max_len)
        self.image_buckets = image_buckets
        cap = max_prefill_batch or max_slots
        if prefill_batch_sizes:
            self._prefill_batch_buckets = tuple(sorted(prefill_batch_sizes))
        else:
            self._prefill_batch_buckets = tuple(sorted(
                {b for b in (1, 2, 4, 8, 16, 32) if b < min(max_slots, cap)}
                | {min(max_slots, cap)}))
        t = config.text
        L, Hkv, D = t.num_hidden_layers, t.num_key_value_heads, t.head_dim
        # decode_chunk slack: a chunk may overshoot max_len before the host
        # notices; rounded up to 256 so the decode kernel's blocks tile it
        self.Lalloc = -(-(max_len + decode_chunk) // 256) * 256
        if kv_quant == "int8":
            cache_dtype = torch.int8
        self.caches = {
            "k": torch.zeros((L, self.S, self.Lalloc, Hkv, D), dtype=cache_dtype,
                             device=self.device),
            "v": torch.zeros((L, self.S, self.Lalloc, Hkv, D), dtype=cache_dtype,
                             device=self.device),
        }
        if kv_quant == "int8":
            for name in ("k_scale", "v_scale"):
                self.caches[name] = torch.zeros((L, self.S, Hkv, self.Lalloc),
                                                dtype=torch.float32, device=self.device)
        self.lengths = np.zeros(self.S, np.int32)         # host copy
        self.next_pos = np.zeros(self.S, np.int32)        # next M-RoPE position value
        self.last_token = np.zeros(self.S, np.int32)
        self.free_slots = list(range(self.S))
        self.slot_req: Dict[int, Request] = {}
        self.steps_executed = 0           # diagnostic: total decode steps run
        self.host_syncs = 0               # diagnostic: blocking device→host reads
        self.admit_time = 0.0             # s spent admitting (incl. prefill)
        self.decode_time = 0.0            # s spent in decode chunks
        self.prefill_device_time = 0.0    # s inside prefill, to the first-token readback
        self.prefill_hist: Dict[Tuple[int, int, int], int] = {}
        self.prefix_fork = prefix_fork
        self._slot_epoch = np.zeros(self.S, np.int64)
        self._prefix_registry: Dict[tuple, _PrefixEntry] = {}
        self.prefill_rows = 0             # diagnostic: prompts actually prefilled
        self.forked_requests = 0          # diagnostic: prompts forked instead
        self.waiting: List[Request] = []
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._embed_dtype = params["embed"].dtype
        # device-resident decode state, refreshed only when admission or
        # release changes the slot set
        self._dev_state: Optional[Dict[str, torch.Tensor]] = None
        self._dev_dirty = True

    def _to_device(self, params):
        if isinstance(params, dict):
            return {k: self._to_device(v) for k, v in params.items()}
        return params.to(self.device)

    def _derive_params_q(self):
        """SINGLE-COPY (a pre-quantized tree) serves prefill and decode from
        self.params; HYBRID (weight_quant on a float tree) derives the
        quantized decode copy."""
        if params_prequantized(self.params):
            self.params_q = None
        elif self.weight_quant:
            with torch.no_grad():
                self.params_q = quantize_decode_params(self.params, mode=self.weight_quant)

    # ------------------------------------------------------------------ public
    def set_params(self, params):
        """Swap in new weights and derive the quantized decode copy again.
        The caller drains the engine first."""
        self.params = self._to_device(params)
        self._derive_params_q()
        # prefixes cached under the OLD weights must never fork under the new
        self._prefix_registry.clear()

    def add_request(self, request_id, prompt_ids, sampling: SamplingParams,
                    image_embeds=None, position_ids: Optional[np.ndarray] = None,
                    callback: Optional[Callable] = None, meta: Optional[Dict] = None):
        self.waiting.append(Request(
            request_id=request_id, prompt_ids=list(map(int, prompt_ids)),
            sampling=sampling, image_embeds=image_embeds,
            position_ids=position_ids, callback=callback, meta=meta))

    def abort_request(self, request_id) -> bool:
        for r in self.waiting:
            if r.request_id == request_id:
                r.aborted = True
                self.waiting.remove(r)
                return True
        for slot, r in list(self.slot_req.items()):
            if r.request_id == request_id:
                r.aborted = True
                self._release(slot)
                return True
        return False

    def has_work(self) -> bool:
        return bool(self.waiting or self.slot_req)

    def num_waiting(self) -> int:
        return len(self.waiting)

    def num_running(self) -> int:
        return len(self.slot_req)

    def step(self) -> List[EngineOutput]:
        """Admit waiting requests (batched prefill), decode one chunk, return
        finished outputs. A request that cannot be admitted finishes with
        finish_reason="error" (callback fired) instead of stopping the loop."""
        outputs: List[EngineOutput] = []
        t0 = time.perf_counter()
        while self.waiting and self.free_slots:
            group = self._next_group(outputs)
            if not group:
                break
            try:
                self._admit_group(group, outputs)
            except Exception as e:  # noqa: BLE001 — isolate bad batches
                for req in group:
                    if req.slot >= 0:
                        # the slot's KV may never have been written — any
                        # prefix entry registered against it must die
                        self._slot_epoch[req.slot] += 1
                        if req.slot in self.slot_req:
                            self._release(req.slot)
                    self._finish_error(req, e, outputs)
        t1 = time.perf_counter()
        self.admit_time += t1 - t0
        if self.slot_req:
            outputs.extend(self._decode_chunk())
            self.decode_time += time.perf_counter() - t1
        return outputs

    def generate(self, requests: List[Request]) -> List[EngineOutput]:
        """Batch API: run all requests to completion, in request order."""
        self.waiting.extend(requests)
        done: List[EngineOutput] = []
        while self.has_work():
            done.extend(self.step())
        order = {r.request_id: i for i, r in enumerate(requests)}
        return sorted(done, key=lambda o: order.get(o.request_id, 1 << 30))

    # ---------------------------------------------------------------- internals
    def _finish_error(self, req: Request, e: Exception, outputs: List[EngineOutput]):
        req.finished = True
        meta = dict(req.meta or {})
        meta["error"] = f"{type(e).__name__}: {e}"
        out = EngineOutput(req.request_id, req.prompt_ids, req.output_ids, "error", meta)
        outputs.append(out)
        if req.callback is not None:
            req.callback(out)

    def _next_group(self, outputs: List[EngineOutput]) -> List[Request]:
        """Pull a FIFO run of waiting requests sharing one prompt bucket,
        bounded by free slots and the total image-row budget. Requests that
        can never be admitted are errored here."""
        group: List[Request] = []
        img_total = 0
        key = None
        seen: Dict = {}                    # in-group fork prediction
        cap = min(len(self.free_slots), self._prefill_batch_buckets[-1])
        while self.waiting and len(group) < cap:
            req = self.waiting[0]
            try:
                b = _bucket(len(req.prompt_ids), self.prefill_buckets)
                n_img = 0 if req.image_embeds is None else req.image_embeds.shape[0]
                if n_img:
                    _bucket(n_img, self.image_buckets)
            except Exception as e:  # noqa: BLE001
                self.waiting.pop(0)
                self._finish_error(req, e, outputs)
                continue
            if key is None:
                key = b
            elif b != key:
                break                      # keep FIFO order; next step() turn
            # a duplicate of an earlier request in THIS group will fork (its
            # leader registers in the same admission pass), so its image rows
            # never enter the prefill
            if self.prefix_fork:
                pkey = (tuple(req.prompt_ids), id(req.image_embeds))
                lead_pos = seen.get(pkey, _MISS)
                if lead_pos is not _MISS and (
                        lead_pos is req.position_ids
                        or (lead_pos is not None and req.position_ids is not None
                            and np.array_equal(lead_pos, req.position_ids))):
                    n_img = 0
                elif lead_pos is _MISS:
                    seen[pkey] = req.position_ids
            if group and n_img and img_total + n_img > self.image_buckets[-1]:
                break
            group.append(self.waiting.pop(0))
            img_total += n_img
        return group

    def _release(self, slot: int):
        self.slot_req.pop(slot, None)
        self.lengths[slot] = 0
        self.free_slots.append(slot)
        self._dev_dirty = True

    def _batch_bucket(self, n: int) -> int:
        for b in self._prefill_batch_buckets:
            if n <= b:
                return b
        return self._prefill_batch_buckets[-1]

    def _admit_group(self, reqs: List[Request], outputs: List[EngineOutput]):
        """Requests whose prompt is resident in a slot FORK it; the rest run
        one batched prefill. A fork source resident before this pass is
        copied BEFORE the prefill (its slot may be handed to a prefill request
        in this pass); a fork whose leader prefills in this pass copies AFTER."""
        prefill_reqs: List[Request] = []
        pre_pairs: List[tuple] = []
        post_pairs: List[tuple] = []
        pass_slots = set()
        for req in reqs:
            entry = self._prefix_lookup(req)
            slot = self.free_slots.pop(0)
            self._slot_epoch[slot] += 1
            req.slot = slot
            self.slot_req[slot] = req
            if entry is not None:
                (post_pairs if entry.slot in pass_slots else pre_pairs).append((entry, req))
            else:
                self._register_prefix(req, slot)
                prefill_reqs.append(req)
                pass_slots.add(slot)
        if pre_pairs:
            self._fork_group(pre_pairs)
        if prefill_reqs:
            self._prefill_group(prefill_reqs, outputs)
        if post_pairs:
            self._fork_group(post_pairs)

    # --------------------------------------------------------- prefix forking
    def _prefix_lookup(self, req: Request) -> Optional[_PrefixEntry]:
        """A valid resident prefix for `req`: same prompt, the same embeds
        object, equal position_ids."""
        if not self.prefix_fork:
            return None
        e = self._prefix_registry.get(tuple(req.prompt_ids))
        if e is None or self._slot_epoch[e.slot] != e.epoch:
            return None
        lead_embeds = e.embeds() if e.embeds is not None else None
        if e.embeds is not None and lead_embeds is None:
            return None                      # referent freed → entry dead
        if (lead_embeds is None) != (req.image_embeds is None):
            return None
        if lead_embeds is not None and lead_embeds is not req.image_embeds:
            return None
        if (e.position_ids is None) != (req.position_ids is None):
            return None
        if (e.position_ids is not None and e.position_ids is not req.position_ids
                and not np.array_equal(e.position_ids, req.position_ids)):
            return None
        return e

    def _register_prefix(self, req: Request, slot: int):
        if not self.prefix_fork or not req.prompt_ids:
            return
        last = int(req.prompt_ids[-1])
        if last in (self.config.image_token_id, self.config.video_token_id):
            # the fork's first decode step re-embeds the last prompt token by
            # id; an image position's hidden state came from the ViT instead
            return
        P = len(req.prompt_ids)
        npos = int(req.position_ids.max()) + 1 if req.position_ids is not None else P
        self._prefix_registry[tuple(req.prompt_ids)] = _PrefixEntry(
            slot=slot, epoch=int(self._slot_epoch[slot]), P=P, next_pos=npos,
            last_token=last,
            embeds=None if req.image_embeds is None else weakref.ref(req.image_embeds),
            position_ids=req.position_ids)
        if len(self._prefix_registry) > 2 * self.S:
            self._prefix_registry = {
                k: v for k, v in self._prefix_registry.items()
                if self._slot_epoch[v.slot] == v.epoch}

    def _fork_group(self, fork_pairs: List[tuple]):
        """Copy each entry's slot rows to its fork's slot, and stage the fork
        so its next decode step rewrites the identical KV entry at P-1 and
        samples its own first token from the same last-position logits."""
        srcs, dsts = [], []
        for e, req in fork_pairs:
            slot = req.slot
            self.lengths[slot] = e.P - 1
            self.next_pos[slot] = e.next_pos - 1
            self.last_token[slot] = e.last_token
            srcs.append(e.slot)
            dsts.append(slot)
            self.forked_requests += 1
        self._fork_slots(srcs, dsts)
        self._dev_dirty = True

    @torch.no_grad()
    def _fork_slots(self, srcs: List[int], dsts: List[int]):
        """Gather the source rows, then write them to the destination slots
        in place (slot axis = 1). Sources and destinations are disjoint."""
        src = torch.as_tensor(srcs, device=self.device)
        dst = torch.as_tensor(dsts, device=self.device)
        for c in self.caches.values():
            c[:, dst] = c[:, src]

    def _prefill_group(self, reqs: List[Request], outputs: List[EngineOutput]):
        """One batched prefill for `reqs` (one prompt bucket, slots assigned).
        Image embeds are concatenated in request order: row i feeds the i-th
        image token across the batch."""
        B = len(reqs)
        Bp = self._batch_bucket(B)
        bucket = _bucket(max(len(r.prompt_ids) for r in reqs), self.prefill_buckets)

        ids = np.full((Bp, bucket), self.config.pad_token_id, np.int64)
        attn = np.zeros((Bp, bucket), np.int32)
        attn[B:, 0] = 1                   # padded rows: 1 valid token
        pos = np.zeros((Bp, 3, bucket), np.int64)
        Ps = np.ones(Bp, np.int64)
        temps = np.zeros(Bp, np.float32)
        top_ps = np.ones(Bp, np.float32)
        top_ks = np.zeros(Bp, np.int64)
        next_pos_host = np.zeros(Bp, np.int64)
        imgs = []
        n_img_total = 0
        self.prefill_rows += B
        for i, req in enumerate(reqs):
            P = len(req.prompt_ids)
            ids[i, :P] = req.prompt_ids
            attn[i, :P] = 1
            Ps[i] = P
            s = req.sampling
            temps[i] = s.temperature if s.do_sample else 0.0
            top_ps[i] = s.top_p
            top_ks[i] = s.top_k
            if req.position_ids is not None:
                pos[i, :, :P] = req.position_ids
                next_pos_host[i] = int(req.position_ids.max()) + 1
            else:
                pos[i] = np.clip(np.arange(bucket), 0, P - 1)[None]
                next_pos_host[i] = P
            if req.image_embeds is not None and req.image_embeds.shape[0]:
                imgs.append(torch.as_tensor(req.image_embeds, device=self.device)
                            .to(self._embed_dtype))
                n_img_total += req.image_embeds.shape[0]
        img_bucket = _bucket(n_img_total, self.image_buckets) if n_img_total else 0
        hk = (Bp, bucket, img_bucket)
        self.prefill_hist[hk] = self.prefill_hist.get(hk, 0) + 1
        # unlike a compiled graph, nothing needs the image rows padded to the
        # bucket: scatter_image_embeds reads one row per image token
        img = torch.cat(imgs, dim=0) if imgs else None
        slots = [req.slot for req in reqs]
        tdev = time.perf_counter()
        first_tok = self._prefill(ids, pos, attn, Ps, img, temps, top_ps, top_ks, slots)
        toks = first_tok.cpu().numpy()    # blocks → true device prefill time
        self.host_syncs += 1
        self.prefill_device_time += time.perf_counter() - tdev
        self._dev_dirty = True
        # the cache holds the P prompt tokens; the first sampled token is
        # written at position P (= lengths) by the first decode step
        for i, req in enumerate(reqs):
            slot = req.slot
            self.lengths[slot] = Ps[i]
            self.next_pos[slot] = next_pos_host[i]
            self.last_token[slot] = int(toks[i])
            req.output_ids.append(int(toks[i]))
            self._maybe_finish(req, outputs)

    def _stop_tokens(self, req: Request) -> frozenset:
        base = getattr(self.config, "stop_set", frozenset((self.config.eos_token_id,)))
        extra = getattr(req.sampling, "stop_token_ids", ()) or ()
        return base | frozenset(int(t) for t in extra) if extra else base

    def _maybe_finish(self, req: Request, outputs: List[EngineOutput]):
        tok = req.output_ids[-1] if req.output_ids else None
        reason = None
        if tok is not None and tok in self._stop_tokens(req):
            reason = "stop"
        elif len(req.output_ids) >= req.sampling.max_new_tokens:
            reason = "length"
        elif self.lengths[req.slot] >= self.Lmax:
            reason = "length"
        if reason:
            req.finished = True
            out = EngineOutput(req.request_id, req.prompt_ids, req.output_ids,
                               reason, req.meta)
            self._release(req.slot)
            outputs.append(out)
            if req.callback is not None:
                req.callback(out)

    def _refresh_dev_state(self):
        active = np.zeros(self.S, bool)
        temps = np.zeros(self.S, np.float32)
        top_ps = np.ones(self.S, np.float32)
        top_ks = np.zeros(self.S, np.int64)
        budget = np.zeros(self.S, np.int32)
        stops = np.full((self.S, self.STOP_SET_K), -1, np.int64)
        for slot, req in self.slot_req.items():
            active[slot] = True
            s = req.sampling
            temps[slot] = s.temperature if s.do_sample else 0.0
            top_ps[slot] = s.top_p
            top_ks[slot] = s.top_k
            budget[slot] = max(s.max_new_tokens - len(req.output_ids), 0)
            st = sorted(self._stop_tokens(req))[:self.STOP_SET_K]
            stops[slot, :len(st)] = st
        host = {"last_token": self.last_token.astype(np.int64),
                "lengths": self.lengths.astype(np.int64),
                "next_pos": self.next_pos.astype(np.int64),
                "active": active, "temps": temps, "top_ps": top_ps,
                "top_ks": top_ks, "budget": budget, "stops": stops,
                "running": active.copy()}
        self._dev_state = {k: torch.as_tensor(v, device=self.device)
                           for k, v in host.items()}
        self._dev_dirty = False

    def _decode_chunk(self) -> List[EngineOutput]:
        if self._dev_dirty or self._dev_state is None:
            self._refresh_dev_state()
        n = self.decode_chunk
        inner = self.decode_inner or n
        # chained inner loops (decode_inner), their tokens concatenated on
        # the device: the early exit carries over through the device state
        segs, steps = [], 0
        for _ in range(-(-n // inner)):
            seg, s_i = self._decode_loop(inner)
            segs.append(seg[:, :s_i])
            steps += s_i
        toks = torch.cat(segs, dim=1).cpu().numpy()   # the only token download per chunk
        self.host_syncs += 1
        self.steps_executed += steps
        # host mirrors advance arithmetically (the device did lengths+steps);
        # a released/admitted slot marks the state dirty and forces re-upload
        outputs: List[EngineOutput] = []
        for slot, req in list(self.slot_req.items()):
            emitted = toks[slot][:steps]
            stop = self._stop_tokens(req)
            for t in emitted:
                req.output_ids.append(int(t))
                if int(t) in stop or len(req.output_ids) >= req.sampling.max_new_tokens:
                    break
            self.lengths[slot] += steps
            self.next_pos[slot] += steps
            if emitted.size:
                self.last_token[slot] = int(emitted[-1])
            self._maybe_finish(req, outputs)
        return outputs

    # ------------------------------------------------------------ device work
    @torch.no_grad()
    def _prefill(self, ids, pos, attn, Ps, image_embeds, temps, top_ps, top_ks,
                 slots: List[int]) -> torch.Tensor:
        """Run a BATCH of prompts through the model into a local cache, copy
        each real row's KV into its slot, sample token 1 (returned on device)."""
        cfg = self.config
        dev = self.device
        Bp, bucket = ids.shape
        Lyr = cfg.text.num_hidden_layers
        Hkv, D = cfg.text.num_key_value_heads, cfg.text.head_dim
        attn_t = torch.as_tensor(attn, device=dev)
        local = {name: torch.zeros((Lyr, Bp, bucket, Hkv, D), dtype=self.caches[name].dtype,
                                   device=dev) for name in ("k", "v")}
        if self.kv_quant:
            for name in ("k_scale", "v_scale"):
                local[name] = torch.zeros((Lyr, Bp, Hkv, bucket), dtype=torch.float32,
                                          device=dev)
        local["kv_valid"] = attn_t
        cache_positions = torch.arange(bucket, device=dev)[None].expand(Bp, bucket)
        # w8a8 prefill in HYBRID mode runs on the int8 copy (in SINGLE-COPY
        # mode self.params is the int8 tree already)
        params = (self.params_q if self.act_quant and self.params_q is not None
                  else self.params)
        # logits=False: only each row's LAST position feeds sampling
        hidden, local = qmodel.forward(
            cfg, params, torch.as_tensor(ids, device=dev),
            torch.as_tensor(pos, device=dev), None, image_embeds=image_embeds,
            cache=local, cache_positions=cache_positions, logits=False,
            act_quant=self.act_quant)
        rows = torch.arange(Bp, device=dev)
        last_hidden = hidden[rows, torch.as_tensor(Ps - 1, device=dev)]
        tok = sample_tokens(qmodel.head_logits(params, last_hidden), self._gen,
                            torch.as_tensor(temps, device=dev),
                            torch.as_tensor(top_ps, device=dev),
                            torch.as_tensor(top_ks, device=dev))
        # (L, S, Lalloc, Hkv, D) ← (L, B, bucket, …) and scales (L, S, Hkv,
        # Lalloc) ← (L, B, Hkv, bucket); padded rows are dropped
        slot_idx = torch.as_tensor(slots, device=dev)
        B = len(slots)
        for name, cache in self.caches.items():
            if name in ("k", "v"):
                cache[:, slot_idx, :bucket] = local[name][:, :B]
            else:
                cache[:, slot_idx, :, :bucket] = local[name][:, :B]
        return tok

    @torch.no_grad()
    def _decode_loop(self, n_steps: int) -> Tuple[torch.Tensor, int]:
        """Generate up to n_steps tokens for all active slots; returns the
        (S, n_steps) device tokens and the number of steps run.

        The loop exits early once every active slot has emitted a stop token
        or exhausted its budget (the JAX lax.while_loop condition): one bool
        readback per step. The device state is updated in place for the next
        chunk."""
        cfg = self.config
        st = self._dev_state
        S = self.S
        dev = self.device
        active = st["active"]
        lengths, next_pos = st["lengths"], st["next_pos"]
        last_token, budget = st["last_token"], st["budget"]
        running = st["running"] & active
        toks = torch.zeros((S, n_steps), dtype=torch.int32, device=dev)
        kv_pos = torch.arange(self.Lalloc, device=dev)
        pad = torch.full_like(last_token, cfg.pad_token_id)
        params = self.params_q if self.params_q is not None else self.params
        steps = 0
        while steps < n_steps:
            self.host_syncs += 1
            if not bool(running.any()):
                break
            pos = next_pos[:, None, None].expand(S, 3, 1)
            cache = dict(self.caches,
                         kv_valid=(kv_pos[None, :] < (lengths + 1)[:, None]).to(torch.int32))
            logits, _ = qmodel.forward(cfg, params, last_token[:, None], pos, None,
                                       cache=cache, cache_positions=lengths[:, None])
            tok = sample_tokens(logits[:, 0], self._gen, st["temps"], st["top_ps"],
                                st["top_ks"])
            tok = torch.where(active, tok, pad)
            toks[:, steps] = tok.to(torch.int32)
            lengths = torch.where(active, lengths + 1, lengths)
            next_pos = torch.where(active, next_pos + 1, next_pos)
            budget = torch.where(active, budget - 1, budget)
            stopped = (st["stops"] == tok[:, None]).any(dim=1)
            running = running & ~stopped & (budget > 0)
            last_token = tok
            steps += 1
        st.update(last_token=last_token, lengths=lengths, next_pos=next_pos,
                  budget=budget, running=running)
        return toks, steps
