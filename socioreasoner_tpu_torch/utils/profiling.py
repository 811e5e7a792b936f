"""Trace capture and per-op summary tables, the counterpart of
socioreasoner_tpu/utils/profiling.py.

Where the JAX package parses the XPlane protobuf of `jax.profiler.trace`,
this module reads the Chrome trace that `torch.profiler` exports: every
complete event ("ph": "X") with its duration in µs. Device events (CUDA
kernels, memcpys and memsets) form the `/device:GPU:<i>` planes; the rest
is `/host:CPU`. `trace_summary` runs a callable under the profiler and
returns the same rows as the JAX package: {"plane", "name", "total_us",
"count", "avg_us"}, sorted by total time, device planes only unless there
are none (a CPU run).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

# the Chrome trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def parse_trace(path: str, device_only: bool = True) -> List[Dict]:
    """Aggregate the complete events' durations per (plane, name) of one
    Chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    agg: Dict[tuple, List[float]] = {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        device = ev.get("cat") in DEVICE_CATEGORIES
        plane = f"/device:GPU:{ev.get('pid', 0)}" if device else "/host:CPU"
        tot_cnt = agg.setdefault((plane, device, ev.get("name", "")), [0.0, 0])
        tot_cnt[0] += float(ev["dur"])
        tot_cnt[1] += 1
    has_device = any(dev for _, dev, _ in agg)
    rows = [{"plane": plane, "name": name, "total_us": v[0], "count": v[1],
             "avg_us": v[0] / max(v[1], 1)}
            for (plane, dev, name), v in agg.items()
            if dev or not (device_only and has_device)]
    rows.sort(key=lambda r: -r["total_us"])
    return rows


def busy_us(rows: List[Dict]) -> float:
    """The device time of a summary's device rows (µs)."""
    return sum(r["total_us"] for r in rows if r["plane"].startswith("/device:"))


def trace_summary(fn: Callable, *args, log_dir: Optional[str] = None,
                  top: int = 25, device_only: bool = True, **kwargs) -> Dict:
    """Run fn(*args, **kwargs) under torch.profiler and summarise.

    Returns {"wall_s", "result", "ops": the top rows, "device_us": the
    device time of all device rows, "trace_dir"}. The trace stays in the
    caller's log_dir, or in a temporary directory the caller may delete."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or tempfile.mkdtemp(prefix="socio_trace_")
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    # device rows only: trace the device alone (host tracing would add its
    # own cost to the wall time); on the CPU the host ops are the rows
    acts = ([ProfilerActivity.CUDA] if cuda and device_only else
            [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    ops = parse_trace(path, device_only=device_only)
    return {"wall_s": wall, "result": result, "ops": ops[:top],
            "device_us": busy_us(ops), "trace_dir": log_dir}


def format_op_table(ops: List[Dict], limit: int = 25) -> str:
    lines = [f"{'total_ms':>10} {'count':>7} {'avg_us':>9}  op"]
    for r in ops[:limit]:
        lines.append(f"{r['total_us'] / 1e3:10.3f} {r['count']:7d} "
                     f"{r['avg_us']:9.1f}  {r['name']}")
    return "\n".join(lines)
