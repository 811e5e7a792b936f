"""Worker: the per-role unit a Cluster drives.

The port's copy of socioreasoner_tpu/runtime/worker.py: it holds a
strategy and passes the registered lifecycle calls through to it. One
process and one GPU share every role's weights, so load/offload are the
strategy's no-ops and the weight-sync calls go to its model_update.
"""

from __future__ import annotations

from typing import Optional

from ..configs.worker_config import WorkerConfig
from .cluster import RankInfo
from .dispatch import Dispatch, register


class Worker:
    def __init__(self, worker_config: WorkerConfig, rank_info: Optional[RankInfo] = None,
                 shared: Optional[dict] = None, cluster_name: str = ""):
        self.worker_config = worker_config
        self.rank_info = rank_info or RankInfo()
        self.shared = shared if shared is not None else {}
        self.cluster_name = cluster_name
        self.worker_name = f"{cluster_name}-{self.rank_info.rank}"
        self.strategy = None
        self.pipeline_config = None

    # ------------------------------------------------------------ lifecycle
    @register(dispatch_mode=Dispatch.ONE_TO_ALL)
    def initialize(self, pipeline_config=None):
        self.pipeline_config = pipeline_config

    # ------------------------------------------------- strategy passthroughs
    def _strategy_call(self, name: str, *args, **kwargs):
        fn = getattr(self.strategy, name, None)
        return None if fn is None else fn(*args, **kwargs)

    @register(dispatch_mode=Dispatch.ONE_TO_ALL)
    def load_states(self, *args, **kwargs):
        return self._strategy_call("load_states", *args, **kwargs)

    @register(dispatch_mode=Dispatch.ONE_TO_ALL)
    def offload_states(self, *args, **kwargs):
        return self._strategy_call("offload_states", *args, **kwargs)

    @register(dispatch_mode=Dispatch.ONE_TO_ALL)
    def start_model_update(self, *args, **kwargs):
        return self._strategy_call("model_update", *args, **kwargs)

    @register(dispatch_mode=Dispatch.ONE_TO_ALL)
    def update_parameter(self, *args, **kwargs):
        return self._strategy_call("update_parameter", *args, **kwargs)
