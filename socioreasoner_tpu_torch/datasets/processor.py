"""Self-contained Qwen2.5-VL processor: image preprocessing + chat templating.

The port's own copy of socioreasoner_tpu/datasets/processor.py, kept as it
is there (host-only code: the port imports nothing of the JAX package).

Replaces the reference's dependency on HF AutoProcessor (ref
`roll/models/model_providers.py:49` default_processor_provider and the
collator's per-sample processor calls, `roll/datasets/collator.py:422`).
Implements the exact Qwen2VL image pipeline (smart_resize → PIL bicubic →
CLIP-normalize → merge-block patchify) and the chat template as pure host code,
so the framework runs offline with any tokenizer implementing encode/decode.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56, max_pixels: int = 14 * 14 * 4 * 1280
                 ) -> Tuple[int, int]:
    """Qwen2-VL resize rule: dims divisible by factor, pixel count in range."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


@dataclass
class ImageProcessorConfig:
    patch_size: int = 14
    merge_size: int = 2
    temporal_patch_size: int = 2
    min_pixels: int = 56 * 56
    max_pixels: int = 28 * 28 * 1280
    image_mean: np.ndarray = field(default_factory=lambda: OPENAI_CLIP_MEAN)
    image_std: np.ndarray = field(default_factory=lambda: OPENAI_CLIP_STD)
    # True: process_images returns resized uint8 pixels ("pixel_u8") and the
    # ViT path normalizes+patchifies on device — 4× fewer upload bytes
    defer_patchify: bool = False

    @property
    def factor(self) -> int:
        return self.patch_size * self.merge_size


def resize_image(image: Image.Image, cfg: ImageProcessorConfig) -> Image.Image:
    h, w = smart_resize(image.height, image.width, cfg.factor,
                        cfg.min_pixels, cfg.max_pixels)
    return image.resize((w, h), resample=Image.Resampling.BICUBIC)


def resized_u8(image: Image.Image, cfg: ImageProcessorConfig) -> np.ndarray:
    """Resize only; return (H, W, 3) uint8 — the deferred-patchify carrier.

    Normalize + patchify then run ON DEVICE (models/qwen2_5_vl/vision.py
    patchify_device): uploading uint8 pixels is 4× fewer host→device bytes
    than f32/bf16 patches with the temporal duplication already applied."""
    if image.mode != "RGB":
        image = image.convert("RGB")
    return np.asarray(resize_image(image, cfg), np.uint8)


def patchify_image(image: Image.Image, cfg: ImageProcessorConfig,
                   pre_resized: bool = False) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """One image → (S, C*tps*ps*ps) flattened patches in merge-block order +
    grid (t, h, w). Matches Qwen2VLImageProcessor._preprocess exactly."""
    if image.mode != "RGB":
        image = image.convert("RGB")
    if not pre_resized:
        image = resize_image(image, cfg)
    arr = np.asarray(image, np.float32) / 255.0
    arr = (arr - cfg.image_mean) / cfg.image_std
    arr = arr.transpose(2, 0, 1)                    # (C, H, W)
    H, W = arr.shape[1:]
    ps, ms, tps = cfg.patch_size, cfg.merge_size, cfg.temporal_patch_size
    frames = np.repeat(arr[None], tps, axis=0)      # temporal repeat for images
    grid_t = 1
    grid_h, grid_w = H // ps, W // ps
    p = frames.reshape(grid_t, tps, 3, grid_h // ms, ms, ps, grid_w // ms, ms, ps)
    p = p.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = p.reshape(grid_t * grid_h * grid_w, 3 * tps * ps * ps)
    return flat, (grid_t, grid_h, grid_w)


def process_images(images: Sequence[Image.Image], cfg: ImageProcessorConfig
                   ) -> Dict[str, np.ndarray]:
    """Multiple images → concatenated pixel patches + grid_thw array.

    With cfg.defer_patchify: returns per-image resized uint8 arrays instead
    ("pixel_u8"); patchify happens on device (vision.patchify_device)."""
    if cfg.defer_patchify:
        u8s, grids = [], []
        for img in images:
            arr = resized_u8(img, cfg)
            u8s.append(arr)
            grids.append((1, arr.shape[0] // cfg.patch_size,
                          arr.shape[1] // cfg.patch_size))
        return {"pixel_u8": u8s, "image_grid_thw": np.array(grids, np.int64)}
    all_patches, grids = [], []
    for img in images:
        flat, grid = patchify_image(img, cfg)
        all_patches.append(flat)
        grids.append(grid)
    return {"pixel_values": np.concatenate(all_patches, axis=0),
            "image_grid_thw": np.array(grids, np.int64)}


# ------------------------------------------------------------- chat templating

QWEN_SPECIAL_TOKENS = {
    "<|im_start|>": 151644, "<|im_end|>": 151645,
    "<|vision_start|>": 151652, "<|vision_end|>": 151653,
    "<|image_pad|>": 151655, "<|video_pad|>": 151656,
    "<|endoftext|>": 151643,
}


def build_chat_text(user_text: str, n_images: int,
                    system: Optional[str] = "You are a helpful assistant.") -> str:
    """Qwen chat-template string with add_generation_prompt=True."""
    image_part = "<|vision_start|><|image_pad|><|vision_end|>" * n_images
    parts = []
    if system is not None:
        parts.append(f"<|im_start|>system\n{system}<|im_end|>\n")
    parts.append(f"<|im_start|>user\n{image_part}{user_text}<|im_end|>\n")
    parts.append("<|im_start|>assistant\n")
    return "".join(parts)


def expand_image_tokens(token_ids: List[int], grid_thw: np.ndarray,
                        image_token_id: int, merge_size: int = 2) -> List[int]:
    """Replace each single image_pad token with grid_t*grid_h*grid_w/merge²
    copies (what HF Qwen2VLProcessor does after tokenization)."""
    out: List[int] = []
    img_idx = 0
    unit = merge_size ** 2
    for tok in token_ids:
        if tok == image_token_id:
            t, h, w = (int(x) for x in grid_thw[img_idx])
            out.extend([image_token_id] * (t * h * w // unit))
            img_idx += 1
        else:
            out.append(tok)
    return out


class SocioProcessor:
    """Tokenizer + image processor + template, the reference's `processor` role."""

    def __init__(self, tokenizer, image_config: Optional[ImageProcessorConfig] = None,
                 image_token_id: int = 151655, merge_size: int = 2):
        self.tokenizer = tokenizer
        self.image_config = image_config or ImageProcessorConfig()
        self.image_token_id = image_token_id
        self.merge_size = merge_size

    def __call__(self, text: str, images: Optional[Sequence[Image.Image]] = None
                 ) -> Dict[str, np.ndarray]:
        """text already contains <|image_pad|> placeholders (one per image)."""
        ids = self.tokenizer.encode(text)
        out: Dict[str, np.ndarray] = {}
        if images:
            img = process_images(images, self.image_config)
            out.update(img)
            ids = expand_image_tokens(ids, img["image_grid_thw"],
                                      self.image_token_id, self.merge_size)
        out["input_ids"] = np.asarray(ids, np.int64)
        return out

    def apply_chat_template(self, user_text: str, n_images: int = 0) -> str:
        return build_chat_text(user_text, n_images)

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        return self.tokenizer.decode(list(map(int, ids)),
                                     skip_special_tokens=skip_special_tokens)

    def batch_decode(self, batch_ids, skip_special_tokens: bool = False) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch_ids]


class SimpleTokenizer:
    """Offline byte-level tokenizer with Qwen special tokens — for tests and
    environments without the HF tokenizer files. NOT vocabulary-compatible with
    the real model; production uses load_hf_tokenizer()."""

    def __init__(self, vocab_size: int = 151936):
        self.vocab_size = vocab_size
        self.special = dict(QWEN_SPECIAL_TOKENS)
        self.id_to_special = {v: k for k, v in self.special.items()}
        self.pad_token_id = 151643
        self.eos_token_id = 151645

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        i = 0
        while i < len(text):
            matched = False
            if text[i] == "<":
                for tok, tid in self.special.items():
                    if text.startswith(tok, i):
                        ids.append(tid)
                        i += len(tok)
                        matched = True
                        break
            if not matched:
                ids.extend(b + 3 for b in text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: List[int], skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for tid in ids:
            if tid in self.id_to_special:
                flush()
                if not skip_special_tokens:
                    out.append(self.id_to_special[tid])
            elif 3 <= tid < 259:
                byte_buf.append(tid - 3)
            else:
                flush()
        flush()
        return "".join(out)


def load_hf_tokenizer(path: str):
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(path, trust_remote_code=False)
