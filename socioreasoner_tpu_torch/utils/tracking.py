"""Experiment trackers: tensorboard / stdout / jsonl-file backends behind
one interface.

The port's own copy of socioreasoner_tpu/utils/tracking.py, kept as it is
there (ref roll/utils/tracking.py:22-129): FileTracker writes the same
jsonl lines, and TensorboardTracker imports tensorboardX when it is made.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


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


class FileTracker(BaseTracker):
    """JSONL metrics log — greppable, machine-readable."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, "a")

    def log(self, values: Dict[str, Any], step: int):
        rec = {"step": step, "ts": time.time(), **values}
        self._f.write(json.dumps(rec, default=float) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class TensorboardTracker(BaseTracker):
    def __init__(self, log_dir: str):
        from tensorboardX import SummaryWriter
        os.makedirs(log_dir, exist_ok=True)
        self.writer = SummaryWriter(log_dir)

    def log(self, values: Dict[str, Any], step: int):
        for key, val in values.items():
            try:
                self.writer.add_scalar(key, float(val), step)
            except (TypeError, ValueError):
                pass

    def log_text(self, tag: str, text: str, step: int):
        self.writer.add_text(tag, text, step)

    def close(self):
        self.writer.close()


class MultiTracker(BaseTracker):
    def __init__(self, *trackers: BaseTracker):
        self.trackers = list(trackers)

    def log(self, values, step):
        for t in self.trackers:
            t.log(values, step)

    def log_text(self, tag, text, step):
        for t in self.trackers:
            t.log_text(tag, text, step)

    def close(self):
        for t in self.trackers:
            t.close()


def create_tracker(track_with: str = "stdout", **kwargs) -> BaseTracker:
    """Factory (ref tracking.py:113-129)."""
    if track_with == "tensorboard":
        return TensorboardTracker(kwargs.get("log_dir", "./output/tensorboard"))
    if track_with == "file":
        return FileTracker(kwargs.get("log_dir", "./output/logs"))
    if track_with in ("stdout", "console"):
        return StdoutTracker()
    if track_with == "multi":
        return MultiTracker(StdoutTracker(),
                            FileTracker(kwargs.get("log_dir", "./output/logs")))
    if track_with in ("wandb", "swanlab"):
        # interface parity with the reference backends (ref tracking.py:22-112);
        # falls back to jsonl files when the package isn't installed
        try:
            mod = __import__(track_with)

            class _ThirdPartyTracker(BaseTracker):
                def __init__(self):
                    self.run = mod.init(**{k: v for k, v in kwargs.items()
                                           if k != "log_dir"})

                def log(self, metrics, step):
                    mod.log(dict(metrics), step=step)

                def close(self):
                    mod.finish()

            return _ThirdPartyTracker()
        except ImportError:
            import warnings
            warnings.warn(f"{track_with} is not installed; logging to files")
            return FileTracker(kwargs.get("log_dir", f"./output/{track_with}"))
    raise ValueError(f"unknown tracker {track_with!r}")
