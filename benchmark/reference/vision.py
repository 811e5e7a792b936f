"""The plain reference of the Qwen2.5-VL vision tower and its inputs, as
the published description gives them (HF `Qwen2_5_VisionTransformer` and
`Qwen2VLImageProcessor`):

  * an image resized to multiples of 28 (bicubic), scaled to [0, 1],
    normalized by CLIP's mean and std, repeated over the 2 temporal
    frames and cut into 14 x 14 patches in merge-block order (each 2 x 2
    block of patches consecutive);
  * the patch embedding (a 3-D convolution whose kernel equals its stride,
    one matmul), then blocks of RMSNorm, attention with 2-D rotary
    positions (row and column frequencies, rotate-half), RMSNorm and a
    SwiGLU MLP with biases;
  * window attention: a patch attends to the patches of its own window of
    4 x 4 merged units (112 pixels) in every block but the full-attention
    blocks (7, 15, 23, 31), where it attends to its whole image;
  * the merger: RMSNorm, each 2 x 2 block's four patches side by side,
    Linear, exact GELU, Linear.

Computed in the natural patch order under masks, one image at a time, in
float32 with TF32 off. Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .decoder import exact_f32, rms_norm

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resized(image_u8: np.ndarray, min_pixels: int, max_pixels: int, factor: int = 28):
    """The image (H, W, 3) uint8 at the processor's size, bicubic (PIL)."""
    import math
    from PIL import Image
    h, w = image_u8.shape[:2]
    hb, wb = round(h / factor) * factor, round(w / factor) * factor
    if hb * wb > max_pixels:
        beta = math.sqrt(h * w / max_pixels)
        hb = max(factor, math.floor(h / beta / factor) * factor)
        wb = max(factor, math.floor(w / beta / factor) * factor)
    elif hb * wb < min_pixels:
        beta = math.sqrt(min_pixels / (h * w))
        hb, wb = math.ceil(h * beta / factor) * factor, math.ceil(w * beta / factor) * factor
    img = Image.fromarray(image_u8)
    if (wb, hb) != img.size:
        img = img.resize((wb, hb), resample=Image.Resampling.BICUBIC)
    return np.asarray(img, np.uint8)


def patches(image_u8: np.ndarray, patch: int = 14, merge: int = 2, frames: int = 2):
    """(the image's patches (S, 3 * frames * patch^2) in merge-block order,
    its grid (t, h, w))."""
    x = image_u8.astype(np.float64) / 255.0
    x = (x - np.asarray(CLIP_MEAN)) / np.asarray(CLIP_STD)
    x = x.transpose(2, 0, 1)                                   # (3, H, W)
    gh, gw = x.shape[1] // patch, x.shape[2] // patch
    x = np.broadcast_to(x[None], (frames,) + x.shape)           # (T, 3, H, W)
    x = x.reshape(frames, 3, gh // merge, merge, patch, gw // merge, merge, patch)
    # -> (gh/m, gw/m, m, m, 3, T, p, p)
    x = x.transpose(2, 5, 3, 6, 1, 0, 4, 7)
    return x.reshape(gh * gw, 3 * frames * patch * patch).astype(np.float32), (1, gh, gw)


def patch_positions(gh: int, gw: int, merge: int = 2) -> np.ndarray:
    """(S, 2) row and column of each patch in merge-block order."""
    r, c = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    def order(a):
        return a.reshape(gh // merge, merge, gw // merge, merge).transpose(0, 2, 1, 3).reshape(-1)
    return np.stack([order(r), order(c)], axis=-1)


def tower(v: Dict, tree: Dict, image_u8: np.ndarray, device) -> torch.Tensor:
    """One resized image's merged embeddings (S / 4, out_hidden), float32."""
    p, (_, gh, gw) = patches(image_u8, v["patch_size"], v["spatial_merge_size"],
                             v["temporal_patch_size"])
    hid, heads = v["hidden_size"], v["num_heads"]
    D = hid // heads
    merge = v["spatial_merge_size"]
    pos = torch.as_tensor(patch_positions(gh, gw, merge), device=device)
    S = pos.shape[0]
    # 2-D rotary: D/4 frequencies for rows, D/4 for columns, both halves
    inv = 1.0 / (10000.0 ** (torch.arange(0, D // 2, 2, dtype=torch.float64,
                                          device=device) / (D // 2)))
    f = torch.cat([pos[:, :1].double() * inv, pos[:, 1:].double() * inv], dim=-1)
    emb = torch.cat([f, f], dim=-1)
    cos, sin = emb.cos().float(), emb.sin().float()
    # windows of window_size pixels: (row // w, col // w) in patches
    wp = v["window_size"] // v["patch_size"]
    win = (pos[:, 0] // wp) * (gw // wp + 1) + pos[:, 1] // wp
    same_win = win[:, None] == win[None, :]
    full = set(v["fullatt_block_indexes"])
    b = tree["blocks"]
    with exact_f32():
        x = torch.as_tensor(p, device=device) @ tree["patch_embed_w"].float()
        for i in range(v["depth"]):
            w = {k: t[i].float() for k, t in b.items()}
            h = rms_norm(x, w["norm1"], 1e-6)
            qkv = (h @ w["qkv_w"] + w["qkv_b"]).view(S, 3, heads, D)
            q, k, val = qkv.unbind(1)
            half = D // 2
            def rot(t):
                r = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
                return t * cos[:, None] + r * sin[:, None]
            q, k = rot(q).transpose(0, 1), rot(k).transpose(0, 1)  # (heads, S, D)
            s = (q @ k.transpose(1, 2)) * D ** -0.5
            if i not in full:
                s = s.masked_fill(~same_win[None], float("-inf"))
            a = torch.softmax(s, dim=-1) @ val.transpose(0, 1)
            x = x + a.transpose(0, 1).reshape(S, hid) @ w["proj_w"] + w["proj_b"]
            h2 = rms_norm(x, w["norm2"], 1e-6)
            g = torch.nn.functional.silu(h2 @ w["gate_w"] + w["gate_b"])
            x = x + (g * (h2 @ w["up_w"] + w["up_b"])) @ w["down_w"] + w["down_b"]
            del w, s, a, q, k, val, qkv
        h = rms_norm(x, tree["merger_ln_q"].float(), 1e-6).reshape(S // merge ** 2, -1)
        h = torch.nn.functional.gelu(h @ tree["merger_fc1_w"].float() + tree["merger_fc1_b"].float())
        return h @ tree["merger_fc2_w"].float() + tree["merger_fc2_b"].float()


def grid_of(image_u8: np.ndarray, patch: int = 14) -> Tuple[int, int, int]:
    return (1, image_u8.shape[0] // patch, image_u8.shape[1] // patch)
