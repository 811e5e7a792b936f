"""A profiled slice of a run and its reduction to device and host figures.

`--trace 1` runs profile one steady slice of the measured window with
torch.profiler, export its Chrome trace into a temporary directory, read it
back and delete it. The reading follows the port's utils/profiling.py
(complete events, device categories), copied here so that the yardstick
stays put; on top of it: the union of the device's intervals (busy time),
the idle gaps between them, each named by the innermost host event or
harness span (`span`) that covers it, and device time by kernel name.

Device activity alone is traced where the slice launches hundreds of
thousands of kernels (`host=False`): the host's own ops would multiply the
trace and slow the host they time. The harness's spans, taken on the host
clock, then name the gaps; the trace's `baseTimeNanoseconds` puts them on
its time line.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")
SLICE_MARK = "bench.slice"


class TraceSlice:
    """start() ... stop() around the slice. After stop(): `window_s`,
    `busy_s`, `kernels` [(name, start_us, dur_us)] inside the slice,
    `host` [(name, start_us, dur_us)], `wall_s` (the host clock's)."""

    def __init__(self, host: bool = True):
        self.host_activity = host
        self.spans: List[Tuple[str, int, int]] = []   # (name, start ns, end ns)
        self._prof = None
        self._mark = None
        self.kernels: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        self.window_s = 0.0
        self.busy_s = 0.0
        self.wall_s = 0.0
        self.t0 = self.t1 = 0.0

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.host_activity else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(SLICE_MARK)
        self._mark.__enter__()
        self.t0 = time.perf_counter()
        self.t0_ns = time.time_ns()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.t1_ns = time.time_ns()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.wall_s = self.t1 - self.t0
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            self._read(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            self._prof = None

    def _read(self, path: str):
        with open(path) as f:
            trace = json.load(f)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        base_us = (trace.get("baseTimeNanoseconds", 0) if isinstance(trace, dict) else 0) / 1e3
        lo = hi = None
        kernels, host = [], []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = ev.get("cat", "")
            name = ev.get("name", "")
            ts, dur = float(ev["ts"]), float(ev["dur"])
            if cat in DEVICE_CATEGORIES:
                kernels.append((name, ts, dur))
            elif cat in HOST_CATEGORIES:
                if name == SLICE_MARK and cat == "user_annotation":
                    lo, hi = ts, ts + dur
                else:
                    host.append((name, ts, dur))
        # the harness's spans on the trace's time line
        host += [(n, a / 1e3 - base_us, (b - a) / 1e3) for n, a, b in self.spans]
        if lo is None:          # no mark (device activity alone): the host clock's
            lo, hi = self.t0_ns / 1e3 - base_us, self.t1_ns / 1e3 - base_us
        self.lo, self.hi = lo, hi
        self.kernels = [(n, t, d) for n, t, d in kernels if t + d > lo and t < hi]
        self.host = [(n, t, d) for n, t, d in host if t + d > lo and t < hi]
        self.window_s = (hi - lo) / 1e6
        self.busy_s = sum(b - a for a, b in self._busy_intervals()) / 1e6

    def _busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's intervals, clipped to the slice."""
        spans = sorted((max(t, self.lo), min(t + d, self.hi)) for _, t, d in self.kernels)
        out: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Each idle gap of the device within the slice (seconds), named by
        the innermost host event that covers its middle."""
        busy = self._busy_intervals()
        edges = [self.lo] + [x for ab in busy for x in ab] + [self.hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host, key=lambda e: e[1])
        starts = [t for _, t, _ in host]
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            best = None
            # host events are short next to the slice: look back from mid
            i = bisect.bisect_right(starts, mid)
            for n, t, d in reversed(host[max(0, i - 4000):i]):
                if t + d >= mid and (best is None or d < best[1]):
                    best = (n, d)
            out.append((best[0] if best else "host: outside the traced spans", (b - a) / 1e6))
        return out

    def device_time(self, match) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name `match`es."""
        sel = [d for n, _, d in self.kernels if match(n)]
        return sum(sel) / 1e6, len(sel)

    def n_kernels(self) -> int:
        return sum(1 for n, _, _ in self.kernels)

    def breakdown(self, top: int = 10) -> Dict:
        by_name: Dict[str, float] = {}
        for n, _, d in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + d / 1e6
        gaps: Dict[str, float] = {}
        for n, s in self.idle_gaps():
            gaps[n] = gaps.get(n, 0.0) + s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


class span:
    """Context manager: a harness span (name, host clock) for the slice."""

    def __init__(self, sl: Optional[TraceSlice], name: str):
        self.sl, self.name = sl, name

    def __enter__(self):
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        if self.sl is not None and self.sl._prof is not None:
            self.sl.spans.append((self.name, self.t0, time.time_ns()))
