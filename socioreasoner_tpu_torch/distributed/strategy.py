"""Strategy layer: the backend abstraction behind every worker.

The counterpart of socioreasoner_tpu/distributed/strategy.py: one
`ParamStore` holds the live ("actor"), rollout ("rollout") and frozen
weights shared by the strategies of one process, and `model_update` hands
weights from the trainer to the rollout engine through it. The base classes
carry the methods the concrete strategies (torch_strategies.py) override;
load/offload_states and the weight-broadcast hooks are no-ops (one process,
one GPU, no time-sharing).
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.worker_config import WorkerConfig
from ..protocol import BatchProto

from ..utils.functionals import entropy_from_logits, log_probs_from_logits


class ParamStore:
    """Shared weight registry across strategies (one process, one copy)."""

    def __init__(self):
        self._store: Dict[str, Any] = {}
        self.version: Dict[str, int] = {}

    def put(self, name: str, params: Any):
        self._store[name] = params
        self.version[name] = self.version.get(name, 0) + 1

    def get(self, name: str) -> Any:
        return self._store[name]

    def __contains__(self, name: str) -> bool:
        return name in self._store


class BaseStrategy(abc.ABC):
    strategy_name = "base"

    def __init__(self, worker=None, worker_config: Optional[WorkerConfig] = None,
                 param_store: Optional[ParamStore] = None):
        self.worker = worker
        self.worker_config = worker_config or getattr(worker, "worker_config", None)
        self.param_store = param_store or ParamStore()
        self.model_config = None

    @abc.abstractmethod
    def initialize(self, *args, **kwargs):
        ...

    # ------------------------------------------------- reference API surface
    def load_states(self, *args, **kwargs):     # no GPU time-sharing
        pass

    def offload_states(self, *args, **kwargs):
        pass

    def model_update(self, *args, **kwargs):
        pass

    def setup_collective_group(self, *args, **kwargs):
        pass

    def broadcast_bucket(self, *args, **kwargs):
        pass

    def broadcast_parameter(self, *args, **kwargs):
        pass

    def update_parameter(self, *args, **kwargs):
        pass

    def update_parameter_in_bucket(self, *args, **kwargs):
        pass

    # ------------------------------------------------------------- token ops
    def op_compute_log_probs(self, logits: torch.Tensor, input_ids: torch.Tensor,
                             attention_mask: torch.Tensor) -> torch.Tensor:
        """Log-probs of the next-token labels over the masked region."""
        lp = log_probs_from_logits(logits[:, :-1], input_ids[:, 1:])
        return lp * attention_mask[:, 1:].to(lp.dtype)

    def op_compute_entropy(self, logits: torch.Tensor,
                           attention_mask: torch.Tensor) -> torch.Tensor:
        ent = entropy_from_logits(logits[:, :-1])
        return ent * attention_mask[:, 1:].to(ent.dtype)


class InferenceStrategy(BaseStrategy):
    def forward_step(self, batch: BatchProto, forward_func: Callable):
        raise NotImplementedError

    def generate(self, batch: BatchProto, generation_config: Dict):
        raise NotImplementedError

    def start_server(self, data: Optional[BatchProto] = None):
        raise NotImplementedError

    def add_request(self, command, data):
        raise NotImplementedError

    def save_checkpoint(self, *args, **kwargs):
        pass

    def load_checkpoint(self, *args, **kwargs):
        pass


class TrainStrategy(InferenceStrategy):
    def train_step(self, batch: BatchProto, loss_func: Callable):
        raise NotImplementedError
