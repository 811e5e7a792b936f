"""Pipeline parallelism: the GPipe and interleaved micro-batch schedules over
the "pp" devices, the counterpart of
socioreasoner_tpu/parallel/pipeline_parallel.py.

Stage s holds its chunk of the layers on its device (contiguous, or under
vpp the chunks of virtual stages k*S+s); the micro-batches stream through
the stages on the schedule's ticks, each activation moved to the next
stage's device with `.to()`, which autograd carries back, so the backward
flows through every stage. The JAX package runs the same tick loops inside
a shard_map with `jax.lax.ppermute`; here one controller walks them over
the stage devices.

A carry is a tensor, or a plain tuple or dict of them, whose leaves are
(n_micro, mb, ...); a `PerMicro` leaf holds one host object a micro-batch
(a kernel plan, say) that rides along unmoved.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .mesh import tp_devices


@dataclasses.dataclass(frozen=True)
class PPConfig:
    """The pipeline-parallel plan threaded through the train and log-prob
    steps. `mesh` is a parallel.mesh.Mesh whose `axis` has `size` devices."""
    mesh: object
    size: int
    axis: str = "pp"
    n_micro: int = 0          # 0 → one micro-batch a stage
    vpp: int = 1              # virtual pipeline chunks a stage: each device
    #                           holds vpp non-contiguous layer chunks and the
    #                           interleaved schedule shrinks the bubble ~1/vpp

    def __post_init__(self):
        ax = self.mesh.shape
        if ax.get(self.axis, 1) != self.size:
            raise ValueError(
                f"pipeline_model_parallel_size={self.size} but mesh axis "
                f"{self.axis!r} has size {ax.get(self.axis, 1)}")
        if self.vpp < 1:
            raise ValueError(f"vpp must be >= 1, got {self.vpp}")

    @property
    def micro(self) -> int:
        return self.n_micro or self.size

    def stage_layers(self, L: int) -> List[List[int]]:
        """The layers each stage holds, in the order it runs them: its
        contiguous chunk, or under vpp the chunks of its virtual stages
        k*S+s, k-major."""
        S, V = self.size, self.size * self.vpp
        if L % V:
            raise ValueError(f"{L} layers not divisible by pp×vpp={V}")
        per = L // V
        return [[i for k in range(self.vpp) for i in range((k * S + s) * per,
                                                             (k * S + s + 1) * per)]
                for s in range(S)]


def make_pp_config(mesh, pipeline_model_parallel_size: int, n_micro: int = 0,
                   axis: str = "pp", vpp: int = 1) -> Optional[PPConfig]:
    if pipeline_model_parallel_size <= 1:
        return None
    if mesh is None:
        raise ValueError("pipeline_model_parallel_size > 1 requires an "
                         "explicit mesh with a 'pp' axis")
    return PPConfig(mesh=mesh, size=pipeline_model_parallel_size,
                    axis=axis, n_micro=n_micro, vpp=max(int(vpp), 1))


class PerMicro(list):
    """A carry leaf of host objects, one a micro-batch, never moved."""


def _map(fn, tree):
    """fn over the leaves; a plain dict or tuple is a node, anything else
    (a named tuple, a PerMicro item) a leaf."""
    if type(tree) is dict:
        return {k: _map(fn, v) for k, v in tree.items()}
    if type(tree) is tuple:
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if type(tree) is dict:
        return [x for v in tree.values() for x in _leaves(v)]
    if type(tree) is tuple:
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to(tree, device):
    return _map(lambda a: a.to(device) if isinstance(a, torch.Tensor) else a, tree)


def _micro(x, m: int):
    return _map(lambda a: a[m], x)


def _stack(outs: List, device):
    """One carry a micro-batch → one carry of (n_micro, ...) leaves on
    `device`."""
    first = outs[0]
    flat = [_leaves(o) for o in outs]
    stacked = []
    for i, leaf in enumerate(_leaves(first)):
        items = [f[i] for f in flat]
        stacked.append(torch.stack([t.to(device) for t in items])
                       if isinstance(leaf, torch.Tensor) else PerMicro(items))
    it = iter(stacked)
    return _map(lambda _: next(it), first)


def _layers(stacked_params) -> list:
    """Per-layer items: a list as it is, or a (L, ...) pytree unbound."""
    if isinstance(stacked_params, list):
        return stacked_params
    leaves = _leaves(stacked_params)
    L = leaves[0].shape[0]
    unbound = [leaf.unbind(0) for leaf in leaves]
    out = []
    for i in range(L):
        it = iter([u[i] for u in unbound])
        out.append(_map(lambda _: next(it), stacked_params))
    return out


def _n_micro(x) -> int:
    return next(a for a in _leaves(x) if isinstance(a, torch.Tensor)).shape[0]


def _home(x) -> torch.device:
    return next(a for a in _leaves(x) if isinstance(a, torch.Tensor)).device


def pipeline_forward(layer_fn: Callable[[Any, Any], Any], stacked_params: Any, x: Any,
                     mesh, axis: str = "pp") -> Any:
    """Run x through all L layers with a GPipe schedule: n_micro + S - 1
    ticks, at tick t stage s runs micro-batch t - s through its contiguous
    chunk of L / S layers and hands the result to stage s+1's device.

    `stacked_params`: a (L, ...) pytree of tensors, or a list of L per-layer
    items (tensors in them are moved to their stage's device);
    `layer_fn(per_layer_params, carry) -> carry` keeps the carry's
    structure. `mesh`: a Mesh (its `axis` devices) or a device list.
    Returns the carry's structure, (n_micro, mb, ...), on x's device."""
    devices = tp_devices(mesh, axis)
    S = len(devices)
    layers = _layers(stacked_params)
    if len(layers) % S:
        raise ValueError(f"{len(layers)} layers not divisible by pp={S}")
    per = len(layers) // S
    stage_params = [[_to(layers[s * per + j], devices[s]) for j in range(per)]
                    for s in range(S)]
    n_micro = _n_micro(x)
    outputs: List = [None] * n_micro
    recv: List = [None] * S
    for t in range(n_micro + S - 1):
        sent: List = [None] * S
        for s in range(S):
            m = t - s                          # the micro-batch at this stage
            if not 0 <= m < n_micro:
                continue
            h = _to(_micro(x, m) if s == 0 else recv[s], devices[s])
            for p in stage_params[s]:
                h = layer_fn(p, h)
            if s == S - 1:
                outputs[m] = h
            else:
                sent[s + 1] = h
        # hand each activation to the next stage's device
        recv = [None if h is None else _to(h, devices[s]) for s, h in enumerate(sent)]
    return _stack(outputs, _home(x))


# ------------------------------------------------------------ interleaved VPP

def _interleaved_schedule(S: int, vpp: int, n_micro: int):
    """Static list-schedule for the interleaved virtual-pipeline forward.

    Virtual stage v ∈ [0, S*vpp) lives on device v % S as its chunk v // S.
    Work item (m, v) takes one tick; its output transfers to device
    (v%S + 1) % S during the same tick and is usable the next tick. Each
    device runs at most one item per tick, picking the ready item that comes
    first in Megatron's interleaved order (microbatch groups of S: group-major,
    then chunk, then microbatch).

    Returns numpy tables of shape (T, S):
      exec_k, exec_m, exec_valid — what each device computes at tick t
      recv_k, recv_m, recv_valid — where each device stores what it receives
                                   (from device s-1) at the end of tick t
    """
    if n_micro % S:
        # Megatron asserts this for interleaving (microbatch groups of S);
        # without it the greedy schedule degrades to GPipe-round latency
        raise ValueError(f"interleaved vpp needs n_micro % pp == 0 "
                         f"(got {n_micro} % {S})")
    V = S * vpp
    finish = {}
    items = {s: [] for s in range(S)}
    for s in range(S):
        per_dev = [(m, k * S + s) for m in range(n_micro) for k in range(vpp)]
        # Megatron interleaved order: microbatch group (m // S), then chunk,
        # then microbatch within the group
        per_dev.sort(key=lambda it: (it[0] // S, it[1] // S, it[0] % S))
        items[s] = per_dev

    done = {s: set() for s in range(S)}
    exec_k, exec_m, exec_valid = [], [], []
    total = n_micro * V
    scheduled = 0
    t = 0
    max_ticks = total * (S + vpp) + S + 5   # safety bound
    while scheduled < total and t < max_ticks:
        row_k = np.zeros(S, np.int32)
        row_m = np.zeros(S, np.int32)
        row_v = np.zeros(S, bool)
        for s in range(S):
            for (m, v) in items[s]:
                if (m, v) in done[s]:
                    continue
                ready = v == 0 or finish.get((m, v - 1), 1 << 30) < t
                if ready:
                    row_k[s] = v // S
                    row_m[s] = m
                    row_v[s] = True
                    finish[(m, v)] = t
                    done[s].add((m, v))
                    scheduled += 1
                    break
        exec_k.append(row_k)
        exec_m.append(row_m)
        exec_valid.append(row_v)
        t += 1
    assert scheduled == total, "interleaved schedule failed to place all items"
    T = len(exec_k)
    exec_k = np.stack(exec_k)
    exec_m = np.stack(exec_m)
    exec_valid = np.stack(exec_valid)

    recv_k = np.zeros((T, S), np.int32)
    recv_m = np.zeros((T, S), np.int32)
    recv_valid = np.zeros((T, S), bool)
    for t in range(T):
        for s in range(S):
            if not exec_valid[t, s]:
                continue
            v = exec_k[t, s] * S + s
            if v + 1 >= V:
                continue                      # final virtual stage: no send
            dst = (s + 1) % S
            recv_k[t, dst] = (v + 1) // S
            recv_m[t, dst] = exec_m[t, s]
            recv_valid[t, dst] = True
    return exec_k, exec_m, exec_valid, recv_k, recv_m, recv_valid


def pipeline_forward_interleaved(layer_fn: Callable[[Any, Any], Any], stacked_params: Any,
                                 x: Any, mesh, vpp: int, axis: str = "pp") -> Any:
    """Interleaved virtual-pipeline forward: device s holds the vpp layer
    chunks of virtual stages {k*S + s}, and the micro-batches stream through
    all S*vpp chunks ring-wise (stage S-1 hands chunk k's output to stage
    0's chunk k+1), driven tick by tick by _interleaved_schedule's tables.
    Arguments and result as pipeline_forward's; `stacked_params` in the
    original layer order."""
    devices = tp_devices(mesh, axis)
    S = len(devices)
    layers = _layers(stacked_params)
    V = S * vpp
    if len(layers) % V:
        raise ValueError(f"{len(layers)} layers not divisible by pp×vpp={V}")
    per = len(layers) // V
    chunks = [[[_to(layers[i], devices[s]) for i in range((k * S + s) * per,
                                                          (k * S + s + 1) * per)]
               for k in range(vpp)] for s in range(S)]
    n_micro = _n_micro(x)
    ek, em, ev, rk, rm, rv = _interleaved_schedule(S, vpp, n_micro)
    buffers: List[dict] = [dict() for _ in range(S)]   # (chunk, micro-batch) → carry
    outputs: List = [None] * n_micro
    for t in range(ek.shape[0]):
        done = []
        for s in range(S):
            if not ev[t, s]:
                continue
            k, m = int(ek[t, s]), int(em[t, s])
            h = (_to(_micro(x, m), devices[s]) if k == 0 and s == 0
                 else buffers[s].pop((k, m)))
            for p in chunks[s][k]:
                h = layer_fn(p, h)
            if k == vpp - 1 and s == S - 1:
                outputs[m] = h
            done.append((s, h))
        for s, h in done:
            dst = (s + 1) % S
            if rv[t, dst]:
                buffers[dst][(int(rk[t, dst]), int(rm[t, dst]))] = _to(h, devices[dst])
    return _stack(outputs, _home(x))


def pipeline_decoder(cfg, rank, inputs_embeds: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor, attention_mask: Optional[torch.Tensor],
                     q_positions: Optional[torch.Tensor], pp: PPConfig,
                     remat: bool = False, use_flash: bool = False) -> torch.Tensor:
    """Run the text decoder's layers of one train-plane rank
    (parallel/sharding.RankParams) through the pipeline schedule over its
    stage devices (rank.stage_devices).

    Micro-batches the rank's rows (B % pp.micro == 0), carries the rotary
    tables, masks and positions alongside the hidden states (every stage
    needs its micro-batch's slice), runs each layer whole on its stage's
    device (gathered over fsdp and tp inside the layer's checkpoint under
    remat) with the trainable flash kernels under use_flash (one kernel-6
    plan a micro-batch and stage device), and returns the (B, L, hidden)
    hidden states before the final norm on inputs_embeds' device. Dense
    layers only (the MoE aux loss needs the whole stack's router
    statistics)."""
    from ..models.qwen2_5_vl.text import decoder_layer
    from ..ops.flash_attention_bwd import dkv_plan

    if cfg.n_experts:
        raise NotImplementedError("PP + MoE layer stacks not supported")
    B, L, Hd = inputs_embeds.shape
    n_micro = pp.micro
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} microbatches")
    mb = B // n_micro
    home = inputs_embeds.device
    if q_positions is None:
        q_positions = torch.arange(L, device=home)[None].expand(B, L)
    if attention_mask is None:
        attention_mask = torch.ones((B, L), dtype=torch.int32, device=home)
    lens = attention_mask.sum(-1)
    stages = rank.stage_devices
    grad = torch.is_grad_enabled()
    plans = PerMicro([None] * n_micro)
    if use_flash and grad:
        # kernel 6's work list from each micro-batch's lengths, one a stage
        # device (keyed as a tensor there reports its device): one host read
        # a micro-batch
        devs = dict.fromkeys(torch.empty(0, device=d).device for d in stages)
        for m in range(n_micro):
            plans[m] = {dev: dkv_plan(lens[m * mb:(m + 1) * mb], mb, L, L,
                                      cfg.num_attention_heads, cfg.num_key_value_heads,
                                      True, dev, head_dim=cfg.head_dim) for dev in devs}

    def split(a):
        return a.reshape((n_micro, mb) + a.shape[1:])

    def layer_fn(i, carry):
        h, cos_mb, sin_mb, mask_mb, qpos_mb, lens_mb, plan = carry

        def run(h):
            p = rank.stage_layer(i, h.device)
            return decoder_layer(cfg, p, h, cos_mb, sin_mb, mask_mb, qpos_mb, use_flash,
                                 None if plan is None else plan[h.device], lens_mb)[0]
        h = checkpoint(run, h, use_reentrant=False) if remat and grad else run(h)
        return (h, cos_mb, sin_mb, mask_mb, qpos_mb, lens_mb, plan)

    carry = (split(inputs_embeds), split(cos), split(sin), split(attention_mask),
             split(q_positions), split(lens), plans)
    layers = list(range(cfg.num_hidden_layers))
    if pp.vpp > 1:
        out = pipeline_forward_interleaved(layer_fn, layers, carry, stages, vpp=pp.vpp)
    else:
        out = pipeline_forward(layer_fn, layers, carry, stages)
    return out[0].reshape(B, L, Hd)
