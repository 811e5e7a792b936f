"""Strategy factory: the port's counterpart of
socioreasoner_tpu/distributed/factory.py. A strategy name → a new strategy
of the port. The yamls' names (jax_train, jax_infer, jax_decode,
seg_infer), the reference system's names (megatron_*, deepspeed_*,
hf_infer, vllm, sglang) and the port's own (torch_*) resolve to the
torch_* strategies and SegStrategy; any other name raises ValueError."""

from __future__ import annotations

from typing import Dict

from .seg_strategy import SegStrategy
from .torch_strategies import TorchDecodeStrategy, TorchInferStrategy, TorchTrainStrategy

STRATEGIES = {"torch_train": TorchTrainStrategy, "torch_infer": TorchInferStrategy,
              "torch_decode": TorchDecodeStrategy, "seg_infer": SegStrategy}

ALIASES: Dict[str, str] = {
    "jax_train": "torch_train",
    "jax_infer": "torch_infer",
    "jax_decode": "torch_decode",
    "megatron_train": "torch_train",
    "megatron_infer": "torch_infer",
    "deepspeed_train": "torch_train",
    "deepspeed_infer": "torch_infer",
    "hf_infer": "torch_infer",
    "vllm": "torch_decode",
    "sglang": "torch_decode",
}


def create_strategy(strategy_name: str, worker=None, worker_config=None, param_store=None):
    cls = STRATEGIES.get(ALIASES.get(strategy_name, strategy_name))
    if cls is None:
        raise ValueError(f"unknown strategy {strategy_name!r}")
    return cls(worker, worker_config, param_store)
