"""Shared arithmetic of the per-layer metric readers (metrics/<name>.py).

A reader gets the run: `slice` (tracing.TraceSlice of the profiled steady
slice, or None), `shape` (the model's widths), `counters` (the engine's
counters over the whole window), `slice_counts` (the same over the slice),
`work` (the slice's work records: prefill rows, decode chunks, ViT
calls), `untraced_wall_s` (the mean wall time of the same run's untraced
slices of the same work, or None), `e2e`. Each returns None where it finds nothing to read, never 0
for a share of a roofline or a peak.
"""

from __future__ import annotations

from typing import Optional

import harness
import peaks


def _slice(run):
    s = getattr(run, "slice", None)
    return s if s is not None and s.window_s > 0 and s.kernels else None


def roofline(run, kernel: str) -> Optional[float]:
    """100 x the kernel's least time for the slice's calls (counts/<kernel>.py
    from the traffic's shapes) over its device time by name in the trace."""
    s = _slice(run)
    if s is None:
        return None
    count = harness.count_module(kernel)
    dev_s, launches = s.device_time(count.match)
    records = (run.work or {}).get(count.RECORDS) or []
    if not launches or not records or dev_s <= 0:
        return None
    flops, nbytes = count.work(records, run.shape)
    return 100.0 * peaks.bound_s(nbytes, flops) / dev_s


def _untraced_wall(run) -> Optional[float]:
    """The wall time of the slice's work as the window runs it: the
    profiler slows the host's launches, so the traced slice's own wall
    would move with its overhead."""
    wall = getattr(run, "untraced_wall_s", None)
    return wall if wall and wall > 0 else None


def idle_share(run) -> Optional[float]:
    """100 x the untraced wall's share that the traced slice's device
    activity does not cover."""
    s, wall = _slice(run), _untraced_wall(run)
    return None if s is None or wall is None else 100.0 * (1.0 - s.busy_s / wall)


def mfu(run) -> Optional[float]:
    """100 x the model FLOPs of the slice's work over the untraced wall of
    the same work at the card's bf16 peak."""
    s, wall = _slice(run), _untraced_wall(run)
    if s is None or wall is None or not run.work:
        return None
    total = harness.count_module("model").flops(run.work, run.shape)
    return 100.0 * total / (wall * peaks.BF16_FLOP_PER_S) if total > 0 else None


def launches_per_step(run) -> Optional[float]:
    s = _slice(run)
    steps = (getattr(run, "slice_counts", None) or {}).get("decode_steps", 0)
    return None if s is None or not steps else s.n_kernels() / steps


def device_s_per_unit(run, unit: str) -> Optional[float]:
    """The traced slice's device busy seconds (the union of its intervals)
    over the units of work it completed (`slice_counts[unit]`)."""
    s = _slice(run)
    n = (getattr(run, "slice_counts", None) or {}).get(unit, 0)
    return None if s is None or not n else s.busy_s / n
