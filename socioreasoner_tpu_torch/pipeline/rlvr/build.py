"""Pipeline construction from a SocioSegConfig: the engine settings.

The port's counterpart of `default_engine_kwargs` from
socioreasoner_tpu/pipeline/rlvr/build.py. Loading the checkpoints, the
processor and the dataset from the paths a yaml names (load_policy,
load_sam, build_processor, load_dataset) waits for the port's HF loaders.
"""

from __future__ import annotations

from typing import Dict

from ...configs.rlvr_config import SocioSegConfig


def default_engine_kwargs(cfg: SocioSegConfig) -> Dict:
    """DecodeEngine / TorchDecodeStrategy kwargs from the config: slots from
    actor_infer.infer_batch_size, the cache from sequence_length, and the
    strategy_config knobs (kv_quant, weight_quant, act_quant,
    single_copy_quant, vit_quant, prefix_fork). `sampler_exact` needs no
    kwarg: the port's sampler is always exact."""
    kwargs = {
        "max_slots": cfg.actor_infer.infer_batch_size,
        "max_len": cfg.sequence_length,
        "decode_chunk": 64,
        "prefill_buckets": (512, 1024, 2048, cfg.prompt_length),
        # large total-row buckets let several VLM requests (~1.5k image rows
        # each) share one batched prefill
        "image_buckets": (0, 512, 1024, 2048, 4096, 8192, 16384),
    }
    sc = cfg.actor_infer.strategy_args.strategy_config or {}
    for key in ("kv_quant", "weight_quant", "act_quant", "vit_quant"):
        if sc.get(key):
            kwargs[key] = sc[key]
    if sc.get("single_copy_quant"):
        kwargs["single_copy_quant"] = True
    if sc.get("prefix_fork") is not None:
        kwargs["prefix_fork"] = bool(sc["prefix_fork"])
    return kwargs
