"""Collective verbs over mesh axes and processes, the counterpart of
socioreasoner_tpu/utils/collective.py.

The JAX package runs each verb as a shard_map program over one mesh axis
and exchanges host data through jax.experimental.multihost_utils. Here a
mesh axis's devices within a process are a list (parallel/mesh.py): the
verbs move the values between them and, along a dp axis that spans
processes (runtime/initialize.py), through torch.distributed. `barrier` and
`broadcast_host_data` are the process-level verbs.

gloo (the CPU backend, and the backend of processes that share one card)
takes CUDA tensors for only some verbs, so CUDA tensors go through host
memory on gloo: the values leave the card for the exchange only, and the
computation stays there.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

_OPS = ("sum", "max", "min", "mean")


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist else 0


def _staged(t: torch.Tensor) -> torch.Tensor:
    """The tensor the backend exchanges: a host copy of a CUDA tensor on
    gloo, else the tensor itself."""
    if t.is_cuda and _dist().get_backend() == "gloo":
        return t.detach().cpu()
    return t


def _reduce_op(op: str):
    dist = _dist()
    return {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
            "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]


def _all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """t reduced over every process (a new tensor on t's device)."""
    buf = _staged(t).clone()
    _dist().all_reduce(buf, op=_reduce_op(op))
    return buf.to(t.device)


def _combine(parts: List[torch.Tensor], op: str) -> torch.Tensor:
    acc = parts[0].clone()
    for p in parts[1:]:
        p = p.to(acc.device)
        if op in ("sum", "mean"):
            acc = acc + p
        else:
            acc = torch.maximum(acc, p) if op == "max" else torch.minimum(acc, p)
    return acc


def allreduce(x, mesh, axis: str, op: str = "sum"):
    """Reduce over one mesh axis. `x` is one tensor a device of the axis (a
    list, each on its device) or one replicated tensor (the JAX verb's
    input: its copy on every device of the axis); the result has the same
    form. Along a dp axis that spans processes, across them too."""
    if op not in _OPS:
        raise ValueError(op)
    devices = mesh.axis_devices(axis)
    parts = list(x) if isinstance(x, (list, tuple)) else [x] * len(devices)
    acc = _combine(parts, op)
    n = len(parts)
    if axis == "dp" and mesh.process_count > 1:
        acc = _all_reduce(acc, op)
        n *= mesh.process_count
    if op == "mean":
        acc = acc / n
    if isinstance(x, (list, tuple)):
        return [acc.to(p.device) for p in parts]
    return acc.to(x.device)


def broadcast(x, mesh, axis: str, src: int = 0):
    """Every device of the axis takes the value of its `src`-th device (a
    global index along a dp axis that spans processes); `x` as allreduce's."""
    parts = list(x) if isinstance(x, (list, tuple)) else [x] * len(mesh.axis_devices(axis))
    n = len(parts)
    if axis == "dp" and mesh.process_count > 1:
        owner, local = divmod(src, n)
        value = parts[local] if owner == mesh.process_index else torch.empty_like(parts[0])
        buf = _staged(value).clone()
        _dist().broadcast(buf, src=owner)
        value = buf.to(parts[0].device)
    else:
        value = parts[src]
    if isinstance(x, (list, tuple)):
        return [value.to(p.device) for p in parts]
    return value.to(x.device)


def barrier(name: str = "barrier") -> None:
    """A sync point of every process (multi-process runs)."""
    dist = _dist()
    if dist and dist.get_world_size() > 1:
        dist.barrier()


def broadcast_host_data(data: Any, src: int = 0) -> Any:
    """Any picklable object of process `src`, on every process (the other
    processes need not know its structure)."""
    dist = _dist()
    if not dist or dist.get_world_size() <= 1:
        return data
    box = [data if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This process's rows of a batch-major tensor → the rows of every
    process, in process order (equal counts a process). The gathered rows
    of the other processes carry no gradient; this process's keep theirs."""
    dist = _dist()
    staged = _staged(t.detach())
    bufs = [torch.empty_like(staged) for _ in range(mesh.process_count)]
    dist.all_gather(bufs, staged.contiguous())
    parts = [b.to(t.device) for b in bufs]
    parts[mesh.process_index] = t
    return torch.cat(parts)


@torch.no_grad()
def allreduce_across_processes(tensors: Sequence[Optional[torch.Tensor]]
                               ) -> List[Optional[torch.Tensor]]:
    """Sum each tensor over every process (None stays None, the same leaves
    on every process), one flat exchange per device and dtype."""
    out = list(tensors)
    groups = {}
    for i, t in enumerate(out):
        if t is not None:
            groups.setdefault((t.device, t.dtype), []).append(i)
    for idx in groups.values():
        flat = _all_reduce(torch.cat([out[i].reshape(-1) for i in idx]), "sum")
        start = 0
        for i in idx:
            n = out[i].numel()
            out[i] = flat[start:start + n].view_as(out[i])
            start += n
    return out
