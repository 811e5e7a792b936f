"""Request-level generation facade over in-process decode strategies.

The port's own copy of LocalGenerateGroup from
socioreasoner_tpu/runtime/generate_scheduler.py: the pipelines drive
generation through it without a cluster runtime. One GPU serves one decode
replica (data-parallel replicas wait for the multi-GPU slice).
"""

from __future__ import annotations

from typing import List

from ..protocol import BatchProto


class LocalGenerateGroup:
    """Cluster facade over in-process decode strategies; each must expose
    start_server/stop_server/add_request/generate."""

    def __init__(self, strategies: List):
        if len(strategies) != 1:
            raise NotImplementedError(
                "more than one decode replica is not ported yet (ROADMAP: multi-GPU)")
        self.workers = list(strategies)

    def start_server(self):
        for s in self.workers:
            s.start_server()

    def stop_server(self):
        for s in self.workers:
            s.stop_server()

    def generate(self, batch: BatchProto, generating_args):
        """Batch generate on the replica: (len(batch) * n, P + max_out) rows."""
        return self.workers[0].generate(batch, generating_args)
