"""Driver-side log aggregation and exception monitoring, the counterpart of
socioreasoner_tpu/runtime/log_monitor.py.

Worker exceptions surface through the thread pool's futures; this module
adds a per-worker logging handler writing to `<log_dir>/<worker>.log` and
an ExceptionMonitor that counts failures and raises once a threshold is
crossed.
"""

from __future__ import annotations

import logging
import os
import threading
import traceback
from typing import Dict, List, Optional


def setup_worker_logger(name: str, log_dir: Optional[str] = None,
                        level: int = logging.INFO) -> logging.Logger:
    """Per-worker file logger under `log_dir` (default $SOCIO_LOG_DIR or
    ./output/logs)."""
    log_dir = log_dir or os.environ.get("SOCIO_LOG_DIR", "./output/logs")
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(f"worker.{name}")
    logger.setLevel(level)
    if not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
        handler = logging.FileHandler(os.path.join(log_dir, f"{name}.log"))
        handler.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
        logger.addHandler(handler)
    return logger


class ExceptionMonitor:
    """Counts worker exceptions; raises once `stop_threshold` are recorded."""

    def __init__(self, stop_threshold: int = 1):
        self.stop_threshold = stop_threshold
        self._lock = threading.Lock()
        self.errors: List[Dict] = []

    def record(self, worker_name: str, exc: BaseException):
        with self._lock:
            self.errors.append({
                "worker": worker_name,
                "error": repr(exc),
                "traceback": "".join(traceback.format_exception(exc)),
            })
            count = len(self.errors)
        logging.getLogger(__name__).error(
            "worker %s failed (%d/%d): %r", worker_name, count,
            self.stop_threshold, exc)
        if count >= self.stop_threshold:
            raise RuntimeError(
                f"{count} worker failure(s); first: {self.errors[0]['error']}")

    def error_summary(self) -> List[Dict]:
        with self._lock:
            return list(self.errors)
