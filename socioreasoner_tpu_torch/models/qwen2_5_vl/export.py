"""The port's parameter tree → an HF-format checkpoint directory.

The port's counterpart of socioreasoner_tpu/models/qwen2_5_vl/export.py,
the inverse of loader.py: HF names, (out, in) linear layouts, unstacked
layers, config.json, and safetensors shards written by
utils/safetensors_io.py under the JAX package's shard names. One
difference: leaves are written in their own dtype, so a bf16 tree gives
BF16 tensors, as HF's own save_pretrained writes them; the JAX package
widens bf16 to F32 because numpy has no bfloat16. Either way the values
round-trip exactly.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Tuple

import torch

from ...utils.safetensors_io import save_sharded
from .config import Qwen25VLConfig

TXT_LAYERS = [
    ("input_ln", "input_layernorm.weight", False),
    ("post_ln", "post_attention_layernorm.weight", False),
    ("q_w", "self_attn.q_proj.weight", True),
    ("q_b", "self_attn.q_proj.bias", False),
    ("k_w", "self_attn.k_proj.weight", True),
    ("k_b", "self_attn.k_proj.bias", False),
    ("v_w", "self_attn.v_proj.weight", True),
    ("v_b", "self_attn.v_proj.bias", False),
    ("o_w", "self_attn.o_proj.weight", True),
    ("gate_w", "mlp.gate_proj.weight", True),
    ("up_w", "mlp.up_proj.weight", True),
    ("down_w", "mlp.down_proj.weight", True),
    ("q_norm", "self_attn.q_norm.weight", False),
    ("k_norm", "self_attn.k_norm.weight", False),
]
VIS_LAYERS = [
    ("norm1", "norm1.weight", False), ("norm2", "norm2.weight", False),
    ("norm1_b", "norm1.bias", False), ("norm2_b", "norm2.bias", False),
    ("qkv_w", "attn.qkv.weight", True), ("qkv_b", "attn.qkv.bias", False),
    ("proj_w", "attn.proj.weight", True), ("proj_b", "attn.proj.bias", False),
    ("gate_w", "mlp.gate_proj.weight", True), ("gate_b", "mlp.gate_proj.bias", False),
    ("up_w", "mlp.up_proj.weight", True), ("up_b", "mlp.up_proj.bias", False),
    ("down_w", "mlp.down_proj.weight", True), ("down_b", "mlp.down_proj.bias", False),
    ("fc1_w", "mlp.fc1.weight", True), ("fc1_b", "mlp.fc1.bias", False),
    ("fc2_w", "mlp.fc2.weight", True), ("fc2_b", "mlp.fc2.bias", False),
]


def _hf(x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    return x.T if transpose else x


def iter_hf_tensors(config: Qwen25VLConfig, params: Dict
                    ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(HF name, tensor) of every leaf: (out, in) layouts and unstacked
    layers, as views of the tree's tensors where no reshape copies."""
    t, v = config.text, config.vision
    yield "model.embed_tokens.weight", params["embed"]
    yield "model.norm.weight", params["final_ln"]
    if "lm_head" in params:
        yield "lm_head.weight", _hf(params["lm_head"], True)

    moe_keys = ("gate_w", "up_w", "down_w")
    layers = params["layers"]
    for i in range(t.num_hidden_layers):
        for key, hf_name, transpose in TXT_LAYERS:
            if key not in layers:
                continue
            if not t.attention_bias and key in ("q_b", "k_b", "v_b"):
                continue            # llama-family: no bias tensors in HF ckpt
            if t.n_experts and key in moe_keys:
                continue            # expert stacks exported below
            yield f"model.layers.{i}.{hf_name}", _hf(layers[key][i], transpose)
        if t.n_experts:   # qwen-moe naming (mixtral checkpoints load through the
            # loader's block_sparse_moe aliases; exports use the qwen layout)
            yield f"model.layers.{i}.mlp.gate.weight", _hf(layers["router_w"][i], True)
            for e in range(t.n_experts):
                for key, nm in (("gate_w", "gate_proj"), ("up_w", "up_proj"),
                                ("down_w", "down_proj")):
                    yield (f"model.layers.{i}.mlp.experts.{e}.{nm}.weight",
                           _hf(layers[key][i, e], True))
            if t.shared_expert_intermediate:
                for key, nm in (("s_gate_w", "shared_expert.gate_proj"),
                                ("s_up_w", "shared_expert.up_proj"),
                                ("s_down_w", "shared_expert.down_proj"),
                                ("sgate_w", "shared_expert_gate")):
                    yield f"model.layers.{i}.mlp.{nm}.weight", _hf(layers[key][i], True)

    if "vision" in params:
        vis = params["vision"]
        yield "visual.patch_embed.proj.weight", vis["patch_embed_w"].T.reshape(
            v.hidden_size, v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size)
        yield "visual.merger.ln_q.weight", vis["merger_ln_q"]
        if "merger_ln_q_b" in vis:     # qwen2_vl LayerNorm merger
            yield "visual.merger.ln_q.bias", vis["merger_ln_q_b"]
        yield "visual.merger.mlp.0.weight", _hf(vis["merger_fc1_w"], True)
        yield "visual.merger.mlp.0.bias", vis["merger_fc1_b"]
        yield "visual.merger.mlp.2.weight", _hf(vis["merger_fc2_w"], True)
        yield "visual.merger.mlp.2.bias", vis["merger_fc2_b"]
        for i in range(v.depth):
            for key, hf_name, transpose in VIS_LAYERS:
                if key in vis["blocks"]:   # variant-specific tensors
                    yield f"visual.blocks.{i}.{hf_name}", _hf(vis["blocks"][key][i], transpose)


def config_to_hf_dict(config: Qwen25VLConfig) -> Dict:
    t, v = config.text, config.vision
    moe = {}
    if t.n_experts:
        moe = {"num_experts": t.n_experts,
               "num_experts_per_tok": t.n_experts_per_tok,
               "norm_topk_prob": t.norm_topk_prob,
               "moe_intermediate_size": t.intermediate_size}
    return {
        **moe,
        "architectures": ["Qwen2_5_VLForConditionalGeneration"],
        "model_type": "qwen2_5_vl",
        "vocab_size": t.vocab_size,
        "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads,
        "head_dim": t.head_dim,
        "max_position_embeddings": t.max_position_embeddings,
        "rms_norm_eps": t.rms_norm_eps,
        "rope_theta": t.rope_theta,
        "rope_scaling": {"type": "mrope", "mrope_section": list(t.mrope_section)},
        "tie_word_embeddings": t.tie_word_embeddings,
        "image_token_id": config.image_token_id,
        "video_token_id": config.video_token_id,
        "vision_start_token_id": config.vision_start_token_id,
        "bos_token_id": config.bos_token_id,
        "eos_token_id": config.eos_token_id,
        "vision_config": {
            "depth": v.depth, "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size, "num_heads": v.num_heads,
            "in_channels": v.in_channels, "patch_size": v.patch_size,
            "temporal_patch_size": v.temporal_patch_size,
            "spatial_merge_size": v.spatial_merge_size,
            "out_hidden_size": v.out_hidden_size, "window_size": v.window_size,
            "fullatt_block_indexes": list(v.fullatt_block_indexes),
            "tokens_per_second": v.tokens_per_second,
        },
    }


def save_pretrained(config: Qwen25VLConfig, params: Dict, path: str,
                    max_shard_bytes: int = 4 * 1024 ** 3) -> Dict[str, str]:
    """Write config.json and the safetensors shards (HF layout) of a tree on
    any device; returns the weight map {HF name: file}."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_hf_dict(config), f, indent=2)
    return save_sharded(iter_hf_tensors(config, params), path, max_shard_bytes)
