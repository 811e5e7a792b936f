"""Structured metric aggregation: timers, value stats, token throughput,
per-domain grouping, collected per step and reduced for the tracker.

The port's own copy of MetricsManager and batch_value_metrics from
socioreasoner_tpu/utils/metrics.py.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import numpy as np


class MetricsManager:
    def __init__(self):
        self._values: Dict[str, List[float]] = defaultdict(list)
        self._timers: Dict[str, List[float]] = defaultdict(list)
        self._domain_values: Dict[str, Dict[str, List[float]]] = defaultdict(lambda: defaultdict(list))

    # ------------------------------------------------------------------ record
    def add_metric(self, key: str, value: float):
        self._values[key].append(float(value))

    def add_metrics(self, values: Dict[str, Any]):
        for k, v in values.items():
            arr = np.asarray(v, dtype=np.float64).reshape(-1)
            self._values[k].extend(arr.tolist())

    def add_domain_metrics(self, domain: str, values: Dict[str, Any]):
        for k, v in values.items():
            arr = np.asarray(v, dtype=np.float64).reshape(-1)
            self._domain_values[domain][k].extend(arr.tolist())

    @contextmanager
    def timer(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._timers[f"time/{key}"].append(time.perf_counter() - t0)

    def add_time(self, key: str, seconds: float):
        self._timers[f"time/{key}"].append(seconds)

    def add_token_throughput(self, prefix: str, tokens: int, seconds: float,
                             n_chips: int = 1, dp_size: int = 1):
        """system/tps metrics (ref rlvr_socioseg_vlm_pipeline.py:1093-1108)."""
        if seconds <= 0:
            return
        self._values[f"system/{prefix}tps"].append(tokens / seconds)
        self._values[f"system/{prefix}tps_chip"].append(tokens / seconds / n_chips)
        self._values[f"system/{prefix}tps_dp"].append(tokens / seconds / dp_size)

    # ------------------------------------------------------------------ reduce
    def reduce(self, reset: bool = True) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for key, vals in self._values.items():
            if not vals:
                continue
            arr = np.asarray(vals)
            out[f"{key}/mean" if len(vals) > 1 else key] = float(arr.mean())
            if len(vals) > 1:
                out[f"{key}/max"] = float(arr.max())
                out[f"{key}/min"] = float(arr.min())
        for key, vals in self._timers.items():
            out[key] = float(np.sum(vals))
        for domain, metrics in self._domain_values.items():
            for key, vals in metrics.items():
                out[f"{domain}/{key}"] = float(np.mean(vals))
        if reset:
            self._values.clear()
            self._timers.clear()
            self._domain_values.clear()
        return out


def batch_value_metrics(prefix: str, values: np.ndarray,
                        mask: Optional[np.ndarray] = None) -> Dict[str, float]:
    """mean/max/min of a (possibly masked) array, in float64; an empty mask
    gives zeros."""
    values = np.asarray(values, dtype=np.float64)
    if mask is not None:
        m = np.asarray(mask) > 0
        values = values[m] if m.any() else np.zeros(1)
    return {f"{prefix}/mean": float(values.mean()),
            f"{prefix}/max": float(values.max()),
            f"{prefix}/min": float(values.min())}
