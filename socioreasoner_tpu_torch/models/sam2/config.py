"""SAM2 configuration (mirrors HF Sam2Config fields; defaults = hiera-tiny,
`large()` = the sam2-hiera-large checkpoint the reference serves).

The port's own copy of socioreasoner_tpu/models/sam2/config.py, kept as it
is there (host-only code: the port imports nothing of the JAX package)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class HieraConfig:
    hidden_size: int = 96
    num_channels: int = 3
    patch_kernel: Tuple[int, int] = (7, 7)
    patch_stride: Tuple[int, int] = (4, 4)
    patch_padding: Tuple[int, int] = (3, 3)
    query_stride: Tuple[int, int] = (2, 2)
    window_pos_bg_size: Tuple[int, int] = (7, 7)
    num_query_pool_stages: int = 3
    blocks_per_stage: Tuple[int, ...] = (1, 2, 7, 2)
    embed_dim_per_stage: Tuple[int, ...] = (96, 192, 384, 768)
    num_heads_per_stage: Tuple[int, ...] = (1, 2, 4, 8)
    window_size_per_stage: Tuple[int, ...] = (8, 4, 14, 7)
    global_attention_blocks: Tuple[int, ...] = (5, 7, 9)
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6

    @property
    def num_blocks(self) -> int:
        return sum(self.blocks_per_stage)

    @property
    def stage_ends(self) -> Tuple[int, ...]:
        out, acc = [], 0
        for b in self.blocks_per_stage:
            acc += b
            out.append(acc - 1)
        return tuple(out)


@dataclass(frozen=True)
class PromptEncoderConfig:
    hidden_size: int = 256
    image_size: int = 1024
    patch_size: int = 16
    mask_input_channels: int = 16
    num_point_embeddings: int = 4
    scale: float = 1.0
    layer_norm_eps: float = 1e-6

    @property
    def image_embedding_size(self) -> Tuple[int, int]:
        return (self.image_size // self.patch_size,) * 2

    @property
    def mask_input_size(self) -> Tuple[int, int]:
        return (4 * self.image_size // self.patch_size,) * 2


@dataclass(frozen=True)
class MaskDecoderConfig:
    hidden_size: int = 256
    mlp_dim: int = 2048
    num_hidden_layers: int = 2
    num_attention_heads: int = 8
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    dynamic_multimask_via_stability: bool = True
    dynamic_multimask_stability_delta: float = 0.05
    dynamic_multimask_stability_thresh: float = 0.98

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


@dataclass(frozen=True)
class Sam2Config:
    hiera: HieraConfig = field(default_factory=HieraConfig)
    prompt: PromptEncoderConfig = field(default_factory=PromptEncoderConfig)
    decoder: MaskDecoderConfig = field(default_factory=MaskDecoderConfig)
    # FPN neck
    backbone_channel_list: Tuple[int, ...] = (768, 384, 192, 96)
    backbone_feature_sizes: Tuple[Tuple[int, int], ...] = ((256, 256), (128, 128), (64, 64))
    fpn_hidden_size: int = 256
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    num_feature_levels: int = 3
    image_size: int = 1024

    @classmethod
    def large(cls) -> "Sam2Config":
        """facebook/sam2-hiera-large."""
        return cls(
            hiera=HieraConfig(
                hidden_size=144,
                blocks_per_stage=(2, 6, 36, 4),
                embed_dim_per_stage=(144, 288, 576, 1152),
                num_heads_per_stage=(2, 4, 8, 16),
                window_size_per_stage=(8, 4, 16, 8),
                global_attention_blocks=(23, 33, 43),
            ),
            backbone_channel_list=(1152, 576, 288, 144),
        )

    @classmethod
    def tiny_test(cls) -> "Sam2Config":
        """Small config for unit tests (image 128, matching scaled-down sizes)."""
        return cls(
            hiera=HieraConfig(
                hidden_size=16,
                blocks_per_stage=(1, 2, 2, 1),
                embed_dim_per_stage=(16, 32, 64, 128),
                num_heads_per_stage=(1, 2, 2, 4),
                window_size_per_stage=(8, 4, 14, 7),
                global_attention_blocks=(4,),
            ),
            prompt=PromptEncoderConfig(hidden_size=32, image_size=128),
            decoder=MaskDecoderConfig(hidden_size=32, mlp_dim=64,
                                      num_attention_heads=2, iou_head_hidden_dim=32),
            backbone_channel_list=(128, 64, 32, 16),
            backbone_feature_sizes=((32, 32), (16, 16), (8, 8)),
            fpn_hidden_size=32,
            image_size=128,
        )
