"""Text-only LLM families over the shared decoder: Llama, Mistral, Qwen2,
Qwen2.5, Qwen2-MoE, Qwen3, Qwen3-MoE, Mixtral.

The counterpart of socioreasoner_tpu/models/llm.py. The families map onto
the Qwen2.5-VL text decoder (qwen2_5_vl/text.py), a standard pre-norm
transformer, through per-family config knobs:

  llama/mistral — no attention bias, 1-D RoPE
  qwen2/qwen2.5 — qkv bias, 1-D RoPE
  qwen3        — no bias, per-head q/k RMS norm (`use_qk_norm`), 1-D RoPE
  qwen3_moe    — qwen3 + routed experts (n_experts / n_experts_per_tok)
  qwen2_moe    — qwen2 + routed experts + sigmoid-gated shared expert
  mixtral      — llama + routed experts with always-renormalised top-k

1-D RoPE is M-RoPE with equal t/h/w ids, so position_ids are (B, 3, L)
built from a plain arange. As in the JAX package, `rope_scaling` (Llama-3.1's
"llama3") and `sliding_window` (Mistral) are not read.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils.safetensors_io import iter_safetensors
from .qwen2_5_vl.config import Qwen25VLConfig, TextConfig, VisionConfig
from .qwen2_5_vl.loader import load_params


def config_from_hf_dict(cfg: dict) -> Qwen25VLConfig:
    """Map an HF text-model config.json (llama/mistral/qwen2/qwen3/qwen2_moe/
    qwen3_moe/mixtral) onto the decoder's config. mrope_section puts all
    head_dim // 2 frequencies on the t axis (1-D RoPE)."""
    model_type = cfg.get("model_type", "llama")
    hidden = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    head_dim = cfg.get("head_dim") or hidden // heads
    n_experts = cfg.get("num_experts") or cfg.get("num_local_experts") or 0
    intermediate = cfg.get("moe_intermediate_size") if n_experts else None
    text = TextConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=hidden,
        intermediate_size=intermediate or cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=heads,
        num_key_value_heads=cfg.get("num_key_value_heads", heads),
        head_dim=head_dim,
        max_position_embeddings=cfg.get("max_position_embeddings", 32768),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 10000.0),
        mrope_section=(head_dim // 2, 0, 0),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        attention_bias=model_type in ("qwen2", "qwen2_5", "qwen2_vl", "qwen2_moe"),
        use_qk_norm=model_type in ("qwen3", "qwen3_moe"),
        n_experts=n_experts,
        n_experts_per_tok=cfg.get("num_experts_per_tok", 2),
        # mixtral always renormalises the top-k weights; qwen-moe by its flag
        norm_topk_prob=(cfg.get("norm_topk_prob", False) or model_type == "mixtral"),
        shared_expert_intermediate=(cfg.get("shared_expert_intermediate_size", 0)
                                    if model_type == "qwen2_moe" else 0),
    )
    if n_experts and (cfg.get("decoder_sparse_step", 1) != 1 or cfg.get("mlp_only_layers")):
        # every layer's leaves are stacked: dense and sparse layers cannot mix
        raise NotImplementedError(
            "decoder_sparse_step != 1 / mlp_only_layers are not supported "
            "(all layers must be MoE)")
    # HF configs may hold an explicit None for special tokens, and a LIST for
    # eos_token_id (Llama-3.x: [128001, 128008, 128009]): the first is the
    # eos, the rest extra stop tokens
    raw_eos = cfg.get("eos_token_id")
    if isinstance(raw_eos, (list, tuple)) and raw_eos:
        eos_list = [int(t) for t in raw_eos]
    elif isinstance(raw_eos, int):
        eos_list = [raw_eos]
    else:
        eos_list = [2]
    eos = eos_list[0]
    return Qwen25VLConfig(text=text, vision=VisionConfig(),
                          bos_token_id=cfg.get("bos_token_id") or 1,
                          eos_token_id=eos,
                          stop_token_ids=tuple(eos_list[1:]),
                          pad_token_id=cfg.get("pad_token_id") or eos)


def text_position_ids(input_ids: np.ndarray, attention_mask: np.ndarray) -> np.ndarray:
    """(B, L) → (B, 3, L) 1-D positions replicated on the three rope axes."""
    p = np.cumsum(attention_mask, axis=-1) - 1
    p = np.where(attention_mask == 0, 1, p)
    return np.broadcast_to(p[:, None, :], (p.shape[0], 3, p.shape[1])).copy()


def load_text_model(path: str, dtype=torch.bfloat16, device=None
                    ) -> Tuple[Qwen25VLConfig, Dict]:
    """(config, tree) of any supported HF text checkpoint directory, the tree
    as `dtype` tensors on `device` (the GPU unless one is named); zero qkv
    biases for families whose checkpoints ship none."""
    with open(os.path.join(path, "config.json")) as f:
        config = config_from_hf_dict(json.load(f))
    return config, load_params(config, iter_safetensors(path), dtype, with_vision=False,
                               device=device)
