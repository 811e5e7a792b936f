"""Config-load validation of strategy_config knobs.

The port's own copy of socioreasoner_tpu/configs/validation.py, kept as it
is there: building a pipeline validates every role's strategy_config against
the knobs its backend honors and the parallelism knobs against the devices
the role can see, so a yaml with an unsupported knob raises instead of being
silently ignored. The yamls name the JAX package's backends (and the
reference's aliases for them); the port's strategies take their places.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

from .worker_config import WorkerConfig

# the reference's backend names → the strategy that takes their role
ALIASES: Dict[str, str] = {
    "megatron_train": "jax_train",
    "megatron_infer": "jax_infer",
    "deepspeed_train": "jax_train",
    "deepspeed_infer": "jax_infer",
    "hf_infer": "jax_infer",
    "vllm": "jax_decode",
    "sglang": "jax_decode",
}

# knobs each backend honors (aliases resolve first)
_KNOWN: Dict[str, Set[str]] = {
    "jax_train": {
        "tensor_model_parallel_size", "context_parallel_size",
        "context_parallel_impl",
        "pipeline_model_parallel_size", "virtual_pipeline_model_parallel_size",
        "pp_micro_batches", "fsdp_size", "dp_size", "sequence_parallel",
        "vocab_parallel_logprobs", "expert_model_parallel_size",
    },
    "jax_infer": {
        "tensor_model_parallel_size", "context_parallel_size",
        "context_parallel_impl",
        "pipeline_model_parallel_size", "virtual_pipeline_model_parallel_size",
        "pp_micro_batches", "fsdp_size", "dp_size", "sequence_parallel",
        "vocab_parallel_logprobs",
    },
    "jax_decode": {
        "kv_quant", "weight_quant", "dp_size", "max_slots", "max_len",
        "decode_chunk", "prefill_buckets", "image_buckets",
        "max_prefill_batch", "sampler_exact", "prefill_batch_sizes",
        "tensor_model_parallel_size", "prefix_fork", "single_copy_quant",
        "act_quant", "vit_quant",
    },
    "seg_infer": {"seg_encode_batch", "seg_embed_cache"},
}

_QUANT_VALUES = {"kv_quant": (None, "int8"),
                 "weight_quant": (None, "int8", "int4"),
                 "act_quant": (None, "int8"),
                 "vit_quant": (None, "int8")}


def validate_worker(role: str, wc: Optional[WorkerConfig],
                    n_devices: int) -> None:
    if wc is None:
        return
    name = ALIASES.get(wc.strategy_args.strategy_name,
                       wc.strategy_args.strategy_name)
    sc = wc.strategy_args.config
    known = _KNOWN.get(name)
    if known is None:
        return                       # custom worker_cls strategies: not ours
    unknown = sorted(set(sc) - known)
    if unknown:
        raise ValueError(
            f"role {role} (strategy {name}): unsupported strategy_config "
            f"key(s) {unknown}; supported: {sorted(known)}")
    for key, values in _QUANT_VALUES.items():
        if sc.get(key) not in values:
            raise ValueError(
                f"role {role}: {key}={sc[key]!r} — must be one of {values}")
    if sc.get("single_copy_quant") and not sc.get("weight_quant"):
        raise ValueError(
            f"role {role}: single_copy_quant requires weight_quant "
            "(the single shared tree IS the quantized one)")
    if sc.get("act_quant") and sc.get("weight_quant") != "int8":
        raise ValueError(
            f"role {role}: act_quant requires weight_quant: 'int8' "
            "(w8a8 runs on the int8 weight tree)")
    if sc.get("context_parallel_impl", "ring") not in ("ring", "ulysses"):
        raise ValueError(
            f"role {role}: context_parallel_impl={sc['context_parallel_impl']!r}"
            " — must be 'ring' or 'ulysses'")
    # parallelism divisibility against the devices this role can see
    mapping = wc.resolved_device_mapping()
    n = len(mapping) if mapping else n_devices
    tp = int(sc.get("tensor_model_parallel_size", 1) or 1)
    cp = int(sc.get("context_parallel_size", 1) or 1)
    pp = int(sc.get("pipeline_model_parallel_size", 1) or 1)
    dp = int(sc.get("dp_size", 1) or 1)
    mp = tp * cp * pp * dp
    if name in ("jax_train", "jax_infer") and n % mp != 0:
        raise ValueError(
            f"role {role}: tp({tp})*cp({cp})*pp({pp})*dp({dp})={mp} does not "
            f"divide the {n} available devices")
    if name == "jax_decode" and dp > n:
        raise ValueError(
            f"role {role}: dp_size={dp} decode replicas exceed the {n} "
            "available devices")
    if name == "jax_decode" and tp > 1 and dp * tp > n:
        raise ValueError(
            f"role {role}: dp_size={dp} × tensor_model_parallel_size={tp}"
            f" = {dp * tp} devices needed, only {n} available")
    vpp = int(sc.get("virtual_pipeline_model_parallel_size", 1) or 1)
    if vpp > 1 and pp <= 1:
        raise ValueError(
            f"role {role}: virtual_pipeline_model_parallel_size={vpp} "
            "requires pipeline_model_parallel_size > 1")


def validate_config(cfg, n_devices: int) -> None:
    """Validate every role of an RLVR/SocioSeg config against `n_devices`
    devices; raises ValueError on knobs the built pipeline cannot honor."""
    roles = [("actor_train", getattr(cfg, "actor_train", None)),
             ("actor_infer", getattr(cfg, "actor_infer", None)),
             ("reference", getattr(cfg, "reference", None)),
             ("critic", getattr(cfg, "critic", None)),
             ("seg_infer", getattr(cfg, "seg_infer", None)),
             ("validation", getattr(cfg, "validation", None))]
    for name, wc in getattr(cfg, "rewards", {}).items():
        roles.append((f"rewards.{name}", wc))
    for role, wc in roles:
        validate_worker(role, wc, n_devices)
