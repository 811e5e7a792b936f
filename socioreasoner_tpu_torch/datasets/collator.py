"""SocioSeg collators: per-sample multimodal processing → left-padded BatchProto,
for stage 1 (SocioSegCollator) and the stage-2 restage (collate_restage).

The counterpart of socioreasoner_tpu/datasets/collator.py (which imports the
JAX package's rope module). Numeric keys come out as one numpy batch
(input_ids, attention_mask, M-RoPE position_ids); the ragged vision inputs
(pixel_u8 / pixel_values, grid_thw) stay per-sample object columns, since the
decode engine takes per-request image embeddings.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from ..models.qwen2_5_vl.config import Qwen25VLConfig
from ..models.qwen2_5_vl.rope import get_rope_index
from ..protocol import BatchProto
from .processor import SocioProcessor


def left_pad(ids: Sequence[int], length: int, pad_id: int) -> np.ndarray:
    ids = list(ids)[-length:] if len(ids) > length else list(ids)
    return np.array([pad_id] * (length - len(ids)) + ids, np.int64)


class SocioSegCollator:
    """features (from encode_sample) → BatchProto with the stage-1 keys
    prefixed `out_prefix` (default `map_`)."""

    def __init__(self, processor: SocioProcessor, model_config: Qwen25VLConfig,
                 prompt_length: int = 4096, prompt_key: str = "prompt_map",
                 image_key: str = "image", out_prefix: str = "map_"):
        self.processor = processor
        self.config = model_config
        self.prompt_length = prompt_length
        self.prompt_key = prompt_key
        self.image_key = image_key
        self.out_prefix = out_prefix

    def __call__(self, features: List[Dict[str, Any]]) -> BatchProto:
        pad_id = self.config.pad_token_id
        ids_list, attn_list, pos_list = [], [], []
        pixel_list, grid_list, u8_list = [], [], []
        for f in features:
            out = self.processor(f[self.prompt_key], f.get(self.image_key))
            ids = out["input_ids"]
            padded = left_pad(ids, self.prompt_length, pad_id)
            attn = (np.arange(self.prompt_length) >=
                    self.prompt_length - min(len(ids), self.prompt_length)).astype(np.int64)
            grid = out.get("image_grid_thw")
            pos, _ = get_rope_index(self.config, padded[None], grid, attn[None])
            ids_list.append(padded)
            attn_list.append(attn)
            pos_list.append(pos[0])
            pixel_list.append(out.get("pixel_values"))
            u8_list.append(out.get("pixel_u8"))
            grid_list.append(grid)

        prefix = self.out_prefix
        tensors = {
            f"{prefix}input_ids": np.stack(ids_list),
            f"{prefix}attention_mask": np.stack(attn_list),
            f"{prefix}position_ids": np.stack(pos_list),
        }
        non_tensors: Dict[str, Any] = {
            f"{prefix}pixel_values": pixel_list,
            f"{prefix}grid_thw": grid_list,
        }
        if any(u is not None for u in u8_list):   # defer_patchify carrier
            non_tensors[f"{prefix}pixel_u8"] = u8_list
        for key in ("id", "question", "gt_mask", "gt_bbox", "gt_object",
                    "seg_image", "image_map", "image_sat", "tag", "image_flag"):
            if features and key in features[0]:
                non_tensors[key] = [f[key] for f in features]
        return BatchProto.from_dict(tensors=tensors, non_tensors=non_tensors)


def collate_restage(
    processor: SocioProcessor, model_config: Qwen25VLConfig,
    prompts: List[str], image_pairs: List[List], prompt_length: int,
    out_prefix: str = "",
) -> BatchProto:
    """Stage-2 restage collation (the host hot path, ref pipeline :726-840):
    re-tokenize rendered prompts + images into a fresh left-padded batch."""
    collator = SocioSegCollator(processor, model_config, prompt_length,
                                prompt_key="prompt", image_key="image",
                                out_prefix=out_prefix)
    feats = [{"prompt": p, "image": imgs} for p, imgs in zip(prompts, image_pairs)]
    return collator(feats)
