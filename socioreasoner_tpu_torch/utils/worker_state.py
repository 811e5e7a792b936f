"""Pipeline resume state: the step counter, the metric log history and the
host RNG, saved as JSON and an .npy under output_dir/pipeline/checkpoint-N.

The port's own copy of WorkerState from socioreasoner_tpu/utils/worker_state.py,
with the same files (state.json, rng_state.npy), so either package resumes
from the other's pipeline state.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List, Optional

import numpy as np


class WorkerState:
    def __init__(self, step: int = 0, log_history: Optional[List[Dict]] = None):
        self.step = step
        self.log_history: List[Dict[str, Any]] = log_history or []

    def log(self, metrics: Dict[str, Any], step: int):
        self.log_history.append({"step": step, **metrics})

    def save(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "state.json"), "w") as f:
            json.dump({"step": self.step, "log_history": self.log_history}, f,
                      default=float)
        rng_state = {
            "python": random.getstate(),
            "numpy": np.random.get_state(),
        }
        np.save(os.path.join(directory, "rng_state.npy"),
                np.array([rng_state], dtype=object), allow_pickle=True)

    @classmethod
    def load(cls, directory: str, restore_rng: bool = True) -> "WorkerState":
        """The state saved in `directory`; with restore_rng, Python's and
        numpy's global RNGs continue from where the saving run left them.
        rng_state.npy is unpickled: load only a directory this program wrote."""
        with open(os.path.join(directory, "state.json")) as f:
            data = json.load(f)
        state = cls(step=data["step"], log_history=data.get("log_history", []))
        rng_path = os.path.join(directory, "rng_state.npy")
        if restore_rng and os.path.exists(rng_path):
            rng_state = np.load(rng_path, allow_pickle=True)[0]
            py = rng_state["python"]
            random.setstate((py[0], tuple(py[1]), py[2]))
            np.random.set_state(rng_state["numpy"])
        return state

    @staticmethod
    def latest_checkpoint(pipeline_dir: str) -> Optional[str]:
        if not os.path.isdir(pipeline_dir):
            return None
        ckpts = [d for d in os.listdir(pipeline_dir) if d.startswith("checkpoint-")]
        if not ckpts:
            return None
        latest = max(ckpts, key=lambda d: int(d.split("-")[-1]))
        return os.path.join(pipeline_dir, latest)
