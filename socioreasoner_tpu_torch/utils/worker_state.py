"""Pipeline state: the step counter and the metric log history.

The port's own copy of WorkerState from socioreasoner_tpu/utils/worker_state.py,
in memory only: saving and loading it waits for the port's checkpoints.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class WorkerState:
    def __init__(self, step: int = 0, log_history: Optional[List[Dict]] = None):
        self.step = step
        self.log_history: List[Dict[str, Any]] = log_history or []

    def log(self, metrics: Dict[str, Any], step: int):
        self.log_history.append({"step": step, **metrics})
