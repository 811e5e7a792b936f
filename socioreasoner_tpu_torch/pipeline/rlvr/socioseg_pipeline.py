"""SocioSeg pipeline helpers shared by the infer pipeline and, later, the
GRPO pipeline.

The port's counterpart of `_build_decode_replicas` from
socioreasoner_tpu/pipeline/rlvr/socioseg_pipeline.py on one GPU. The GRPO
pipeline itself (SocioSegPipeline) is the next slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ...distributed.strategy import ParamStore
from ...distributed.torch_strategies import TorchDecodeStrategy
from ...models.qwen2_5_vl.config import Qwen25VLConfig


def _build_decode_replicas(cfg, model_config: Qwen25VLConfig, param_store: ParamStore,
                           engine_kwargs: Optional[Dict]) -> List[TorchDecodeStrategy]:
    """The actor_infer decode replica: one TorchDecodeStrategy serving the
    param store's "rollout" weights on their device. Data- and
    tensor-parallel decode (actor_infer dp_size / tensor_model_parallel_size
    > 1) wait for the multi-GPU slice."""
    sc = cfg.actor_infer.strategy_args.config
    dp = int(sc.get("dp_size", 1) or 1)
    tp = int(sc.get("tensor_model_parallel_size", 1) or 1)
    if dp > 1 or tp > 1:
        raise NotImplementedError(
            f"actor_infer dp_size={dp}, tensor_model_parallel_size={tp}: decode "
            "replicas over several GPUs are not ported yet (ROADMAP: multi-GPU)")
    s = TorchDecodeStrategy(worker_config=cfg.actor_infer, param_store=param_store)
    s.initialize(model_config, engine_kwargs=dict(engine_kwargs or {}))
    return [s]
