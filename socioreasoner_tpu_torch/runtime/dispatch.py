"""Dispatch and collect modes of the cluster's bound worker methods.

The port's copy of socioreasoner_tpu/runtime/dispatch.py. One process
drives every worker, so a data-parallel shard is one logical worker:
DP_MP_COMPUTE chunks the batch over the workers and concatenates their
results.

Modes:
  ONE_TO_ALL           — the same arguments to every worker, a list of results
  ONE_TO_ALL_ONE       — the same arguments to every worker, the first result
  ALL_TO_ALL           — a pre-chunked list of arguments, one per worker
  DP_MP_COMPUTE        — a BatchProto padded to a multiple of the workers,
                         chunked over them, the result protos concatenated
                         and the pad trimmed
  DP_MP_DISPATCH_FIRST — the whole batch to worker 0 only
"""

from __future__ import annotations

import enum
import functools
from typing import Any, Callable, List, Optional

from ..protocol import BatchProto


class Dispatch(enum.Enum):
    ONE_TO_ALL = enum.auto()
    ONE_TO_ALL_ONE = enum.auto()
    ALL_TO_ALL = enum.auto()
    DP_MP_COMPUTE = enum.auto()
    DP_MP_DISPATCH_FIRST = enum.auto()


def register(dispatch_mode: Dispatch = Dispatch.ONE_TO_ALL, blocking: bool = True,
             clear_cache: bool = False):
    """Mark a worker method for binding onto its Cluster with `dispatch_mode`;
    `blocking` is the bound call's default."""

    def decorator(func: Callable) -> Callable:
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            return func(*args, **kwargs)

        wrapper._dispatch_mode = dispatch_mode
        wrapper._blocking = blocking
        wrapper._registered = True
        return wrapper

    return decorator


def dispatch_args(mode: Dispatch, n_workers: int, args: tuple, kwargs: dict) -> tuple:
    """Split a call's arguments into per-worker (args, kwargs). Returns
    (calls, ctx), where ctx carries what the collect needs (the pad of
    DP_MP_COMPUTE)."""
    if mode in (Dispatch.ONE_TO_ALL, Dispatch.ONE_TO_ALL_ONE):
        return [(args, kwargs)] * n_workers, None
    if mode == Dispatch.ALL_TO_ALL:
        split = []
        for i in range(n_workers):
            a = tuple(x[i] if isinstance(x, (list, tuple)) and len(x) == n_workers else x
                      for x in args)
            split.append((a, kwargs))
        return split, None
    if mode == Dispatch.DP_MP_COMPUTE:
        proto = _find_proto(args, kwargs)
        if proto is None:
            return [(args, kwargs)] * n_workers, None
        padded = proto.pad_to_divisor(n_workers)
        pad = padded.meta.get("_pad_size", 0)
        chunks = padded.chunk(n_workers)
        return ([(_replace_proto(args, c), _replace_proto_kwargs(kwargs, c)) for c in chunks],
                {"pad": pad})
    if mode == Dispatch.DP_MP_DISPATCH_FIRST:
        return [(args, kwargs)], None
    raise NotImplementedError(mode)


def collect_results(mode: Dispatch, results: List[Any], ctx=None) -> Any:
    if mode in (Dispatch.ONE_TO_ALL_ONE, Dispatch.DP_MP_DISPATCH_FIRST):
        return results[0]
    if mode == Dispatch.DP_MP_COMPUTE:
        if all(isinstance(r, BatchProto) for r in results):
            out = BatchProto.concat(results)
            pad = (ctx or {}).get("pad", 0)
            if pad and len(out) > pad:
                out = out.slice(0, len(out) - pad)
            return out
        return results
    return results


def _find_proto(args: tuple, kwargs: dict) -> Optional[BatchProto]:
    for x in list(args) + list(kwargs.values()):
        if isinstance(x, BatchProto):
            return x
    return None


def _replace_proto(args: tuple, chunk: BatchProto) -> tuple:
    """args with its first BatchProto replaced by `chunk`."""
    out, replaced = [], False
    for x in args:
        if isinstance(x, BatchProto) and not replaced:
            out.append(chunk)
            replaced = True
        else:
            out.append(x)
    return tuple(out)


def _replace_proto_kwargs(kwargs: dict, chunk: BatchProto) -> dict:
    out, replaced = {}, False
    for k, v in kwargs.items():
        if isinstance(v, BatchProto) and not replaced:
            out[k] = chunk
            replaced = True
        else:
            out[k] = v
    return out
