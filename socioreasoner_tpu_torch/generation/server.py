"""Rollout server: command-queue wrapper around DecodeEngine.

The counterpart of socioreasoner_tpu/generation/server.py, with the same
command contract:

  ADD         — enqueue a request (dict: request_id, prompt_ids, sampling,
                image_embeds, position_ids, callback, meta)
  ABORT       — abort by request_id
  STOP        — abort what is left and exit the loop
  ALIVE_CHECK — liveness ping

The server loop runs in a thread; responses flow through per-request
callbacks, which fire on that thread.
"""

from __future__ import annotations

import enum
import logging
import queue
import threading
import time
import traceback
from typing import Dict, Optional

from .engine import DecodeEngine
from .sampling import SamplingParams

logger = logging.getLogger(__name__)


class GenerateRequestType(enum.Enum):
    """Rollout-server control messages (the JAX package keeps its enum in
    utils/functionals.py, which imports jax)."""
    ADD = enum.auto()
    ABORT = enum.auto()
    STOP = enum.auto()
    ALIVE_CHECK = enum.auto()


class GenerateServer:
    MAX_CONSECUTIVE_ERRORS = 3

    def __init__(self, engine: DecodeEngine, idle_sleep: float = 0.001):
        self.engine = engine
        self.command_queue: "queue.Queue" = queue.Queue()
        self.idle_sleep = idle_sleep
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._alive_ts = 0.0
        self._lock = threading.Lock()

    # ----------------------------------------------------------------- control
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, name="generate-server",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 60.0):
        self.command_queue.put((GenerateRequestType.STOP, None))
        if self._thread is not None:
            self._thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ---------------------------------------------------------------- commands
    def add_request(self, command: GenerateRequestType, data: Optional[Dict] = None):
        """(ADD, request dict) / (ABORT, {request_id}) / (ALIVE_CHECK, None) /
        (STOP, None)."""
        if command == GenerateRequestType.ALIVE_CHECK:
            if not self.is_alive():
                raise RuntimeError("generate server thread died")
            return {"alive": True, "ts": self._alive_ts}
        self.command_queue.put((command, data))

    # -------------------------------------------------------------------- loop
    def _loop(self):
        """Per-request errors are handled inside engine.step; anything that
        still escapes is logged and the loop continues. Only repeated
        failures end the thread (ALIVE_CHECK then reports it)."""
        consecutive_errors = 0
        try:
            while self._running:
                self._alive_ts = time.time()
                if self._drain_commands():
                    break
                if self.engine.has_work():
                    try:
                        with self._lock:
                            self.engine.step()   # callbacks fire inside
                        consecutive_errors = 0
                    except Exception:  # noqa: BLE001 — keep serving
                        consecutive_errors += 1
                        logger.error("generate server step failed (%d/%d):\n%s",
                                     consecutive_errors, self.MAX_CONSECUTIVE_ERRORS,
                                     traceback.format_exc())
                        if consecutive_errors >= self.MAX_CONSECUTIVE_ERRORS:
                            raise
                        time.sleep(0.05)
                else:
                    time.sleep(self.idle_sleep)
        finally:
            self._running = False

    def _drain_commands(self) -> bool:
        while True:
            try:
                command, data = self.command_queue.get_nowait()
            except queue.Empty:
                return False
            if command == GenerateRequestType.STOP:
                for req_id in [r.request_id for r in self.engine.waiting] + \
                              [r.request_id for r in self.engine.slot_req.values()]:
                    self.engine.abort_request(req_id)
                return True
            if command == GenerateRequestType.ABORT:
                self.engine.abort_request(data["request_id"])
            elif command == GenerateRequestType.ADD:
                self.engine.add_request(
                    request_id=data["request_id"],
                    prompt_ids=data["prompt_ids"],
                    sampling=data.get("sampling", SamplingParams()),
                    image_embeds=data.get("image_embeds"),
                    position_ids=data.get("position_ids"),
                    callback=data.get("callback"),
                    meta=data.get("meta"))
