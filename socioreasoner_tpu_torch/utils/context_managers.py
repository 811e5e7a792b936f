"""Execution context managers: profiling and timing around worker calls, the
counterpart of socioreasoner_tpu/utils/context_managers.py.

There is no offload (roles share resident weights); what remains is the
per-call observability: wall time, device memory stats, and an env-gated
trace (PROFILER_TIMELINE=1 → a torch.profiler Chrome trace,
PROFILER_MEMORY=1 → a CUDA memory snapshot).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
from typing import Dict, Iterator, Optional


def device_memory_stats() -> Dict[str, float]:
    """Per-device memory use in bytes, from torch.cuda.memory_stats: the
    allocator's current and peak allocated bytes of each CUDA device (empty
    without CUDA)."""
    import torch
    stats: Dict[str, float] = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        if s:
            stats[f"device{i}/bytes_in_use"] = float(s.get("allocated_bytes.all.current", 0))
            stats[f"device{i}/peak_bytes_in_use"] = float(s.get("allocated_bytes.all.peak", 0))
    return stats


@contextlib.contextmanager
def local_profiler(name: str, log_dir: Optional[str] = None) -> Iterator[None]:
    """Env-gated: PROFILER_TIMELINE=1 writes `<log_dir>/<name>.json`, a
    torch.profiler Chrome trace of the block (CPU and, with CUDA, device
    activity); PROFILER_MEMORY=1 writes `<log_dir>/<name>_memory.pickle`, the
    CUDA allocator's snapshot after it."""
    timeline = os.environ.get("PROFILER_TIMELINE", "0") == "1"
    memory = os.environ.get("PROFILER_MEMORY", "0") == "1"
    log_dir = log_dir or os.environ.get("PROFILER_OUTPUT_DIR", "./output/profiler")
    prof = None
    if timeline:
        import torch
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        yield
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))
        if memory:
            import torch
            if torch.cuda.is_available():
                os.makedirs(log_dir, exist_ok=True)
                with open(os.path.join(log_dir, f"{name}_memory.pickle"), "wb") as f:
                    pickle.dump(torch.cuda.memory._snapshot(), f)


@contextlib.contextmanager
def state_timing_manager(metrics: Dict, name: str,
                         profile: bool = False) -> Iterator[None]:
    """Wraps a worker call: `time/<name>/total` (s) and each device's
    `memory/<name>/...` bytes into `metrics`."""
    start = time.perf_counter()
    ctx = local_profiler(name) if profile else contextlib.nullcontext()
    with ctx:
        yield
    elapsed = time.perf_counter() - start
    metrics[f"time/{name}/total"] = elapsed
    for k, v in device_memory_stats().items():
        metrics[f"memory/{name}/{k}"] = v


@contextlib.contextmanager
def disable_gradients(*trees):
    """Within the block, the tensors of `trees` (tensors, or dicts and lists
    of them) do not require grad; each gets its flag back afterwards. The
    JAX package's version is a no-op: its gradients are explicit."""
    import torch

    def leaves(t):
        if isinstance(t, torch.Tensor):
            yield t
        elif isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                yield from leaves(v)

    saved = [(t, t.requires_grad) for tree in trees for t in leaves(tree)
             if t.is_leaf]
    for t, _ in saved:
        t.requires_grad_(False)
    try:
        yield
    finally:
        for t, flag in saved:
            t.requires_grad_(flag)
