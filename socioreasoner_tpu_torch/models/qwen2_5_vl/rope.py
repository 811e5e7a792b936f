"""M-RoPE: 3-axis (t/h/w) rotary embeddings for Qwen2.5-VL, plus the host-side
position-index builders.

The counterpart of socioreasoner_tpu/models/qwen2_5_vl/rope.py. The numpy
host helpers (get_rope_index, mrope_channel_axis, make_inv_freq,
vision_rot_pos_ids, vision_rope_cos_sin, vision_window_index) are copies of
the JAX package's, so the port never imports a jax module to reach them; the
device side (mrope_cos_sin, rotate_half, apply_rotary) is torch.

Framework convention: position_ids are (B, 3, L) — t/h/w on axis 1.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Qwen25VLConfig, VisionConfig


# ----------------------------------------------------------- host: rope index

def get_rope_index(
    config: Qwen25VLConfig,
    input_ids: np.ndarray,           # (B, L)
    image_grid_thw: Optional[np.ndarray] = None,   # (n_images, 3)
    attention_mask: Optional[np.ndarray] = None,   # (B, L)
) -> Tuple[np.ndarray, np.ndarray]:
    """Build (B, 3, L) t/h/w position ids and per-sample mrope deltas.

    Text runs use equal t==h==w positions; each image block uses its 3-D grid
    (t constant per frame scaled by tokens_per_second; h/w row/col indices),
    offset so positions continue after the preceding text. Padding positions get 1.
    Vectorized per-segment rather than the reference's per-token python scan.
    """
    B, L = input_ids.shape
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)
    pos = np.ones((B, 3, L), dtype=np.int64)
    deltas = np.zeros((B,), dtype=np.int64)
    if image_grid_thw is None or len(image_grid_thw) == 0:
        # text-only: cumsum over attention mask (same on all 3 axes); pads get 1
        p = np.cumsum(attention_mask, axis=-1) - 1
        p = np.where(attention_mask == 0, 1, p)
        pos = np.broadcast_to(p[:, None, :], (B, 3, L)).copy()
        deltas = pos.max(axis=(1, 2)) + 1 - L
        return pos, deltas

    merge = config.vision.spatial_merge_size
    img_idx = 0
    for b in range(B):
        valid = attention_mask[b] == 1
        ids = input_ids[b][valid]
        n = len(ids)
        image_positions = np.nonzero(ids == config.image_token_id)[0]
        segments: List[np.ndarray] = []
        st = 0
        next_pos = 0
        i = 0
        while i < len(image_positions):
            start = image_positions[i]
            t, h, w = (int(x) for x in image_grid_thw[img_idx])
            gh, gw = h // merge, w // merge
            block = t * gh * gw
            # preceding text
            text_len = start - st
            if text_len > 0:
                seg = np.arange(text_len) + next_pos
                segments.append(np.broadcast_to(seg, (3, text_len)))
                next_pos = next_pos + text_len
            t_idx = np.repeat(np.arange(t) * config.vision.tokens_per_second, gh * gw)
            h_idx = np.tile(np.repeat(np.arange(gh), gw), t)
            w_idx = np.tile(np.arange(gw), t * gh)
            segments.append(np.stack([t_idx, h_idx, w_idx]) + next_pos)
            next_pos = next_pos + max(int(t_idx.max()), gh - 1, gw - 1) + 1
            st = start + block
            img_idx += 1
            i += block  # skip image-token positions inside this block
            # advance i past consecutive positions of the same block
            while i < len(image_positions) and image_positions[i] < st:
                i += 1
        if st < n:
            text_len = n - st
            seg = np.arange(text_len) + next_pos
            segments.append(np.broadcast_to(seg, (3, text_len)))
        llm_pos = np.concatenate(segments, axis=1) if segments else np.zeros((3, 0), np.int64)
        pos[b][:, valid] = llm_pos
        deltas[b] = (llm_pos.max() + 1 - L) if n else 0
    return pos, deltas


# --------------------------------------------------------- device: text mrope

def mrope_channel_axis(head_dim: int, mrope_section: Sequence[int]) -> np.ndarray:
    """Static (head_dim,) map channel → rope axis (0=t,1=h,2=w).

    The HF impl splits cos into 2×len(section) chunks and takes chunk i from axis
    i%3 (modeling: apply_multimodal_rotary_pos_emb). Equivalent static gather.
    """
    half = head_dim // 2
    assert sum(mrope_section) == half, (mrope_section, head_dim)
    axis = np.concatenate([np.full(s, i % 3, np.int32) for i, s in enumerate(list(mrope_section) * 2)])
    return axis  # (head_dim,)


def mrope_cos_sin(position_ids: torch.Tensor, inv_freq: torch.Tensor,
                  channel_axis) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, L) ids → (B, L, head_dim) float32 cos/sin with the mrope
    interleave folded in (channel c takes rope axis channel_axis[c]).
    channel_axis: mrope_channel_axis's array, or that map as a long tensor
    on the ids' device, which is used without a copy."""
    freqs = position_ids[..., None].float() * inv_freq.float()[None, None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)                # (B, 3, L, head_dim)
    axis = torch.as_tensor(channel_axis, dtype=torch.long, device=emb.device)
    index = axis[None, None, None, :].expand(emb.shape[0], 1, emb.shape[2], -1)
    sel = torch.gather(emb, 1, index)[:, 0]                # (B, L, head_dim)
    return torch.cos(sel), torch.sin(sel)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q,k: (B, L, H, D); cos/sin: (B, L, D) float32 → broadcast over heads.
    The product runs in float32 (cos/sin promote), then casts back."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    q2 = q * cos + rotate_half(q) * sin
    k2 = k * cos + rotate_half(k) * sin
    return q2.to(q.dtype), k2.to(k.dtype)


def make_inv_freq(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)).astype(np.float32)


# ------------------------------------------------------- host: vision rotary

def vision_rot_pos_ids(grid_thw: np.ndarray, spatial_merge_size: int) -> np.ndarray:
    """(S, 2) h/w position ids per patch in merge-block order (ref rot_pos_emb)."""
    out = []
    m = spatial_merge_size
    for t, h, w in grid_thw:
        t, h, w = int(t), int(h), int(w)
        hpos = np.arange(h)[:, None].repeat(w, 1)
        wpos = np.arange(w)[None, :].repeat(h, 0)
        def blockify(p):
            return p.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        pair = np.stack([blockify(hpos), blockify(wpos)], axis=-1)
        out.append(np.tile(pair, (t, 1)))
    return np.concatenate(out, axis=0)


def vision_rope_cos_sin(grid_thw: np.ndarray, cfg: VisionConfig, theta: float = 10000.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Precompute (S, head_dim) cos/sin for the ViT (host; shapes static per bucket)."""
    pos = vision_rot_pos_ids(grid_thw, cfg.spatial_merge_size)  # (S, 2)
    dim = cfg.head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    freqs = pos[..., None].astype(np.float64) * inv_freq  # (S, 2, dim//2)
    flat = freqs.reshape(pos.shape[0], -1)                # (S, head_dim//2)
    emb = np.concatenate([flat, flat], axis=-1)           # (S, head_dim)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def vision_window_index(grid_thw: np.ndarray, cfg: VisionConfig
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Window partition bookkeeping (ref get_window_index).

    Returns:
      window_index  — (S_merged,) permutation of merged-patch positions grouping
                      them window-by-window
      window_seg    — (S,) per-patch window id AFTER permutation (for masked attn
                      in windowed blocks; replaces cu_window_seqlens)
      full_seg      — (S,) per-patch image id AFTER permutation (full-attn blocks)
    """
    m = cfg.spatial_merge_size
    unit = cfg.spatial_merge_unit
    vit_ws = cfg.window_size // m // cfg.patch_size
    index_parts, seqlens_parts = [], []
    base = 0
    full_ids_parts = []
    for img_i, (t, h, w) in enumerate(grid_thw):
        t, h, w = int(t), int(h), int(w)
        gh, gw = h // m, w // m
        idx = np.arange(t * gh * gw).reshape(t, gh, gw)
        pad_h = (-gh) % vit_ws
        pad_w = (-gw) % vit_ws
        nh, nw = (gh + pad_h) // vit_ws, (gw + pad_w) // vit_ws
        padded = np.full((t, gh + pad_h, gw + pad_w), -100, dtype=np.int64)
        padded[:, :gh, :gw] = idx
        padded = padded.reshape(t, nh, vit_ws, nw, vit_ws).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t, nh * nw, vit_ws, vit_ws)
        seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        index_parts.append(flat[flat != -100] + base)
        seqlens_parts.append(seqlens)
        base += t * gh * gw
        full_ids_parts.append(np.full(t * gh * gw * unit, img_i, dtype=np.int32))
    window_index = np.concatenate(index_parts)
    seqlens = np.concatenate(seqlens_parts) * unit
    # window segment id per patch (post-permutation ordering is window-contiguous)
    window_seg = np.repeat(np.arange(len(seqlens)), seqlens).astype(np.int32)
    # full-attn segment: per image; order patches by window_index permutation
    full_seg_merged = np.concatenate([np.full(int(t) * (int(h) // m) * (int(w) // m), i, np.int32)
                                      for i, (t, h, w) in enumerate(grid_thw)])
    full_seg = np.repeat(full_seg_merged[window_index], unit)
    return window_index, window_seg, full_seg
