"""Experiment tracker for the port: the stdout backend.

The port's own copy of StdoutTracker and create_tracker from
socioreasoner_tpu/utils/tracking.py. The tensorboard, file and third-party
backends are not ported yet: create_tracker raises for them.
"""

from __future__ import annotations

import json
from typing import Any, Dict


class BaseTracker:
    def log(self, values: Dict[str, Any], step: int):
        raise NotImplementedError

    def log_text(self, tag: str, text: str, step: int):
        pass

    def close(self):
        pass


class StdoutTracker(BaseTracker):
    def log(self, values: Dict[str, Any], step: int):
        compact = {k: (round(v, 5) if isinstance(v, float) else v) for k, v in values.items()}
        print(f"[step {step}] {json.dumps(compact, default=str)}")


def create_tracker(track_with: str = "stdout", **kwargs) -> BaseTracker:
    if track_with in ("stdout", "console"):
        return StdoutTracker()
    raise NotImplementedError(
        f"tracker {track_with!r} is not ported yet (ROADMAP: the rest of the surface)")
