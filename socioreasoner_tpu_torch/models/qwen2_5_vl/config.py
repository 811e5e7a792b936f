"""Qwen2.5-VL configuration dataclasses.

The port's own copy of socioreasoner_tpu/models/qwen2_5_vl/config.py, kept
as it is there (host-only code: the port imports nothing of the JAX
package).

Mirrors the fields of HF `Qwen2_5_VLConfig` (the reference loads this family via
mcore_adapter templates — SURVEY.md §2.5, `mcore_adapter/models/qwen2_5_vl/`).
Defaults correspond to Qwen2.5-VL-3B-Instruct.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class VisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    out_hidden_size: int = 2048          # == text hidden size
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    tokens_per_second: int = 2
    rms_norm_eps: float = 1e-6
    # "qwen2_5": RMSNorm + SwiGLU + window attention (default);
    # "qwen2":   LayerNorm + quick-GELU MLP + full attention every block
    #            (ref converter template.py:789 qwen2_vl family)
    variant: str = "qwen2_5"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_input_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def spatial_merge_unit(self) -> int:
        return self.spatial_merge_size ** 2


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 11008
    num_hidden_layers: int = 36
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: int = 128                   # 3B uses 128 (= hidden/16)
    max_position_embeddings: int = 128000
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    tie_word_embeddings: bool = True
    attention_bias: bool = True           # qkv bias, o_proj no bias
    use_qk_norm: bool = False             # per-head q/k RMS norm (qwen3)
    # MoE families (qwen2_moe / qwen3_moe / mixtral; ref converter
    # template.py:508,628,733)
    n_experts: int = 0                    # 0 → dense MLP
    n_experts_per_tok: int = 2
    norm_topk_prob: bool = False          # renorm top-k weights (mixtral: True)
    shared_expert_intermediate: int = 0   # qwen2_moe: sigmoid-gated shared MLP


@dataclass(frozen=True)
class Qwen25VLConfig:
    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    bos_token_id: int = 151643
    eos_token_id: int = 151645
    pad_token_id: int = 151643
    # extra stop tokens beyond eos_token_id (HF checkpoints may carry a
    # list-valued eos_token_id, e.g. Llama-3's [128001, 128008, 128009];
    # eos_token_id holds the first element, the rest land here)
    stop_token_ids: Tuple[int, ...] = ()

    @property
    def stop_set(self) -> frozenset:
        return frozenset((self.eos_token_id,) + tuple(self.stop_token_ids))

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "Qwen25VLConfig":
        """Small config for unit tests / golden parity vs HF random init."""
        return cls(
            vision=VisionConfig(depth=4, hidden_size=64, intermediate_size=128,
                                num_heads=4, out_hidden_size=64, window_size=28,
                                fullatt_block_indexes=(1, 3)),
            text=TextConfig(vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
                            num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=2, head_dim=16,
                            mrope_section=(2, 3, 3), tie_word_embeddings=False),
            image_token_id=vocab_size - 3, video_token_id=vocab_size - 2,
            vision_start_token_id=vocab_size - 4,
            bos_token_id=0, eos_token_id=1, pad_token_id=0,
        )

    @classmethod
    def from_hf_dict(cls, cfg: dict) -> "Qwen25VLConfig":
        v = cfg.get("vision_config", {})
        t = cfg.get("text_config", cfg)  # older configs keep text fields top-level
        if cfg.get("model_type") == "qwen2_vl" or v.get("model_type") == "qwen2_vl":
            # qwen2_vl ViT: embed_dim is the tower width, vision "hidden_size"
            # is the text dim (merger out); full attention in every block
            depth = v.get("depth", 32)
            embed = v.get("embed_dim", 1280)
            vision = VisionConfig(
                depth=depth,
                hidden_size=embed,
                intermediate_size=int(embed * v.get("mlp_ratio", 4)),
                num_heads=v.get("num_heads", 16),
                in_channels=v.get("in_channels", v.get("in_chans", 3)),
                patch_size=v.get("patch_size", 14),
                temporal_patch_size=v.get("temporal_patch_size", 2),
                spatial_merge_size=v.get("spatial_merge_size", 2),
                out_hidden_size=v.get("hidden_size", 3584),
                # window machinery unused (every block is full-attention);
                # keep a valid window size so the host permutation stays legal
                window_size=112,
                fullatt_block_indexes=tuple(range(depth)),
                variant="qwen2",
            )
        else:
            vision = VisionConfig(
                depth=v.get("depth", 32),
                hidden_size=v.get("hidden_size", 1280),
                intermediate_size=v.get("intermediate_size", 3420),
                num_heads=v.get("num_heads", 16),
                in_channels=v.get("in_channels", v.get("in_chans", 3)),
                patch_size=v.get("patch_size", 14),
                temporal_patch_size=v.get("temporal_patch_size", 2),
                spatial_merge_size=v.get("spatial_merge_size", 2),
                out_hidden_size=v.get("out_hidden_size", 2048),
                window_size=v.get("window_size", 112),
                fullatt_block_indexes=tuple(v.get("fullatt_block_indexes", (7, 15, 23, 31))),
                tokens_per_second=v.get("tokens_per_second", 2),
            )
        hidden = t.get("hidden_size", 2048)
        heads = t.get("num_attention_heads", 16)
        text = TextConfig(
            vocab_size=t.get("vocab_size", 151936),
            hidden_size=hidden,
            intermediate_size=t.get("intermediate_size", 11008),
            num_hidden_layers=t.get("num_hidden_layers", 36),
            num_attention_heads=heads,
            num_key_value_heads=t.get("num_key_value_heads", 2),
            head_dim=t.get("head_dim", hidden // heads),
            max_position_embeddings=t.get("max_position_embeddings", 128000),
            rms_norm_eps=t.get("rms_norm_eps", 1e-6),
            rope_theta=t.get("rope_theta", 1000000.0),
            mrope_section=tuple((t.get("rope_scaling") or {}).get("mrope_section", (16, 24, 24))),
            tie_word_embeddings=cfg.get("tie_word_embeddings", t.get("tie_word_embeddings", True)),
        )
        # eos may be int, list (Llama-3 style), or explicit None in the json
        raw_eos = cfg.get("eos_token_id")
        if isinstance(raw_eos, (list, tuple)) and raw_eos:
            eos_list = [int(t) for t in raw_eos]
        elif isinstance(raw_eos, int):
            eos_list = [raw_eos]
        else:
            eos_list = [151645]
        return cls(
            vision=vision, text=text,
            image_token_id=cfg.get("image_token_id", 151655),
            video_token_id=cfg.get("video_token_id", 151656),
            vision_start_token_id=cfg.get("vision_start_token_id", 151652),
            bos_token_id=cfg.get("bos_token_id", 151643),
            eos_token_id=eos_list[0],
            stop_token_ids=tuple(eos_list[1:]),
            pad_token_id=cfg.get("pad_token_id") or cfg.get("bos_token_id", 151643),
        )

    @classmethod
    def from_pretrained(cls, path: str) -> "Qwen25VLConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_hf_dict(json.load(f))
