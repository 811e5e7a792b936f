"""Attention reference implementation in plain PyTorch.

The counterpart of socioreasoner_tpu/ops/attention.py and the plain version
every attention kernel of the port is tested against.

Layout convention: (B, L, H, D) — batch, seq, heads, head_dim. GQA by
repeating each kv head over its group of q heads (HF order).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, L, Hkv, D) → (B, L, Hkv*n_rep, D)."""
    if n_rep == 1:
        return x
    B, L, H, D = x.shape
    return x[:, :, :, None, :].expand(B, L, H, n_rep, D).reshape(B, L, H * n_rep, D)


def dense_attention(
    q: torch.Tensor,                      # (B, Lq, H, D)
    k: torch.Tensor,                      # (B, Lk, Hkv, D)
    v: torch.Tensor,                      # (B, Lk, Hkv, D)
    *,
    causal: bool = False,
    attention_mask: Optional[torch.Tensor] = None,   # (B, Lk) 1=valid
    segment_ids_q: Optional[torch.Tensor] = None,    # (B, Lq) attend iff equal
    segment_ids_kv: Optional[torch.Tensor] = None,   # (B, Lk)
    q_positions: Optional[torch.Tensor] = None,      # (B, Lq) absolute positions
    kv_positions: Optional[torch.Tensor] = None,     # (B, Lk)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked softmax attention with float32 logits and softmax."""
    B, Lq, H, D = q.shape
    Hkv = k.shape[2]
    Lk = k.shape[1]
    if Hkv != H:
        k = repeat_kv(k, H // Hkv)
        v = repeat_kv(v, H // Hkv)
    scale = scale if scale is not None else D ** -0.5

    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale

    mask = torch.ones((B, 1, Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        if q_positions is None:
            q_positions = torch.arange(Lq, device=q.device)[None].expand(B, Lq)
        if kv_positions is None:
            kv_positions = torch.arange(Lk, device=q.device)[None].expand(B, Lk)
        mask = mask & (kv_positions[:, None, None, :] <= q_positions[:, None, :, None])
    if attention_mask is not None:
        mask = mask & (attention_mask[:, None, None, :] > 0)
    if segment_ids_q is not None:
        mask = mask & (segment_ids_q[:, None, :, None] == segment_ids_kv[:, None, None, :])

    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(q.dtype))
