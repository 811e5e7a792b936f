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

It also holds the port's host spans and counters. A caller switches them
on with `recording()`, the only switch; while it is off, `span` hands out
one shared no-op object, reads no clock and records nothing, and `count`
returns at once. While it is on, `count(name, n)` adds n to the recorder's
counter `name`, and
each span appends one record (id, parent id, thread, name, start, end,
attributes) to the recorder's list, and `Recorder.events()` gives start and
end in epoch nanoseconds, the clock of a torch.profiler trace's
`baseTimeNanoseconds`, so the spans can be laid against the device's
kernels.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

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


# ------------------------------------------------------------------ spans
class Recorder:
    """The spans of one `recording()`: perf_counter_ns stamps, mapped to
    epoch nanoseconds through the (perf_counter_ns, time_ns) pair taken
    when recording started."""

    def __init__(self):
        self.anchor_ns = (time.perf_counter_ns(), time.time_ns())
        self.on = True
        self._records: List[tuple] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._counts: Dict[str, int] = {}
        self._count_lock = threading.Lock()

    def add(self, name: str, n: int = 1):
        with self._count_lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        """The counters' values so far (a copy)."""
        with self._count_lock:
            return dict(self._counts)

    def _stack(self) -> List["_Span"]:
        """The calling thread's open spans (the parents of new ones)."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def events(self) -> List[Dict]:
        """Every closed span in the order it closed: {"id", "parent" (0 at
        the top), "thread", "name", "start_ns", "end_ns" (epoch), "attrs"}."""
        shift = self.anchor_ns[1] - self.anchor_ns[0]
        return [{"id": sid, "parent": parent, "thread": thread, "name": name,
                 "start_ns": t0 + shift, "end_ns": t1 + shift, "attrs": dict(attrs)}
                for sid, parent, thread, name, t0, t1, attrs in list(self._records)]

    def totals(self) -> Dict[str, Tuple[float, int]]:
        """(seconds, count) of the closed spans by name."""
        out: Dict[str, Tuple[float, int]] = {}
        for _, _, _, name, t0, t1, _ in list(self._records):
            s, n = out.get(name, (0.0, 0))
            out[name] = (s + (t1 - t0) / 1e9, n + 1)
        return out


class _Span:
    """One span of the active recorder: a context manager on its thread,
    or, from `begin`, opened on one thread and closed on any. A span closed
    after its recording ended is dropped."""

    __slots__ = ("rec", "name", "attrs", "sid", "parent", "thread", "t0")

    def __init__(self, rec: Recorder, name: str, attrs: Dict):
        stack = rec._stack()
        self.rec, self.name, self.attrs = rec, name, attrs
        self.sid = next(rec._ids)
        self.parent = stack[-1].sid if stack else 0
        self.thread = threading.current_thread().name
        self.t0 = time.perf_counter_ns()

    def set(self, **attrs):
        self.attrs.update(attrs)

    def close(self, **attrs):
        t1 = time.perf_counter_ns()
        if self.rec.on:
            self.attrs.update(attrs)
            self.rec._records.append((self.sid, self.parent, self.thread, self.name,
                                      self.t0, t1, self.attrs))

    def __enter__(self):
        self.rec._stack().append(self)
        return self

    def __exit__(self, *exc):
        self.rec._stack().pop()
        self.close()
        return False


class _Off:
    """The span handed out while recording is off."""

    __slots__ = ()

    def set(self, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_ACTIVE: Optional[Recorder] = None


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record spans on every thread while the block runs; yields the
    recorder, which keeps its records after the block."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("spans are already being recorded")
    rec = _ACTIVE = Recorder()
    try:
        yield rec
    finally:
        rec.on = False
        _ACTIVE = None


def active() -> bool:
    """Whether spans are being recorded: a call site asks before it builds
    costly attributes."""
    return _ACTIVE is not None


def span(name: str, **attrs):
    """A context manager timing its block as the span `name`, the child of
    the thread's innermost open span; its `set(**attrs)` adds attributes."""
    rec = _ACTIVE
    return _OFF if rec is None else _Span(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add n to the active recorder's counter `name` (nothing while
    recording is off)."""
    rec = _ACTIVE
    if rec is not None:
        rec.add(name, n)


def begin(name: str, **attrs) -> Optional[_Span]:
    """An open span that any thread may `close(**attrs)` later, the child of
    the calling thread's innermost open span (None while recording is off)."""
    rec = _ACTIVE
    return None if rec is None else _Span(rec, name, attrs)
