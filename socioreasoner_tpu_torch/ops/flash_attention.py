"""Flash attention for the prefill and the ViT: hand-written Hopper kernels.

The counterpart of socioreasoner_tpu/ops/flash_attention.py:

  flash_attention           — causal or full, per-row valid KV length from a
                              contiguous-prefix mask, GQA folded into the
                              kernel (csrc/flash_prefill.cu)
  flash_attention_segmented — segment-id equality mask, non-causal, over a
                              packed ViT sequence (csrc/flash_segmented.cu)

Each wrapper takes its plain PyTorch version (``*_reference``, written with
dense_attention) for tensors on the CPU, and launches its CUDA kernel for
tensors on a GPU — or raises if the kernel cannot take them. There is no
fallback from a GPU tensor to the plain version. ``<wrapper>.launches`` counts
kernel launches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build
from .attention import dense_attention

KERNEL_TILE = 64        # query rows and keys per CTA tile in both kernels
KERNEL_HEAD_DIMS = (80, 128)     # the ViT's and the text decoder's


def check_kernel_inputs(name: str, *tensors: torch.Tensor) -> None:
    """What the CUDA kernels read: bf16 on one GPU, unit stride on the last
    dim, and 16-byte-aligned rows (the kernels load 8 bf16 values at once)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: kernel takes bfloat16, got {t.dtype}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: strides {t.stride()} are not 16-byte rows")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer not 16-byte aligned")


def check_shapes(name: str, ok: bool, **tensors) -> None:
    """Raise unless `ok`, naming every tensor's shape: a kernel reads
    through the pointers of whatever shapes it is given."""
    if not ok:
        shapes = ", ".join(f"{k} {tuple(t.shape)}" for k, t in tensors.items()
                           if t is not None)
        raise ValueError(f"{name}: shapes do not fit: {shapes}")


def _kv_lens(attention_mask: Optional[torch.Tensor], B: int, Lk: int,
             device) -> torch.Tensor:
    if attention_mask is None:
        return torch.full((B,), Lk, dtype=torch.int32, device=device)
    return attention_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)


# ------------------------------------------------------------ causal prefill

def flash_attention_reference(q, k, v, attention_mask=None, *,
                              causal: bool = True) -> torch.Tensor:
    """Plain version of flash_attention: the mask is read as a contiguous
    prefix of sum(mask) valid keys, and rows that see no key give 0."""
    B, Lq = q.shape[:2]
    Lk = k.shape[1]
    kv_lens = _kv_lens(attention_mask, B, Lk, q.device)
    valid = torch.arange(Lk, device=q.device)[None] < kv_lens[:, None]
    out = dense_attention(q, k, v, causal=causal, attention_mask=valid)
    return out * (kv_lens > 0).to(out.dtype)[:, None, None, None]


def flash_attention(
    q: torch.Tensor,                      # (B, Lq, H, D)
    k: torch.Tensor,                      # (B, Lk, Hkv, D)
    v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,   # (B, Lk) 1=valid prefix
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Flash attention with GQA kv heads folded into the kernel. Returns
    (B, Lq, H, D)."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    check_shapes("flash_attention",
                 k.shape == v.shape and k.dim() == 4 and k.shape[0] == B
                 and k.shape[3] == D and (attention_mask is None
                                          or tuple(attention_mask.shape) == (B, Lk)),
                 q=q, k=k, v=v, attention_mask=attention_mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, attention_mask, causal=causal)
    check_kernel_inputs("flash_attention", q, k, v)
    if D not in KERNEL_HEAD_DIMS or H % Hkv or KERNEL_TILE % (H // Hkv):
        raise ValueError(f"flash_attention kernel: unsupported H={H} Hkv={Hkv} D={D}")
    kv_lens = _kv_lens(attention_mask, B, Lk, q.device).contiguous()
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    rc = _build.library().socio_flash_prefill_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kv_lens.data_ptr(), B, Lq, Lk, H, Hkv, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "socio_flash_prefill_bf16")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# ------------------------------------------------------- segmented (ViT)

# default segmented-attention span blocks (the JAX kernel's tuned 512x256)
SEG_BLOCK_Q = 512
SEG_BLOCK_K = 256


def seg_block_sizes(S: int) -> "tuple[int, int]":
    """Block sizes the span bound is stated in for a packed length S: the
    default (SEG_BLOCK_Q, SEG_BLOCK_K), shrunk to the next multiple of 128 ≥ S
    for short sequences."""
    fit = max(128, -(-S // 128) * 128)
    return min(SEG_BLOCK_Q, fit), min(SEG_BLOCK_K, fit)


def _seg_kv_bounds(seg, S0: int, nq: int, block_q: int, block_k: int, xp):
    """Per-q-block k-block bounds for NONDECREASING contiguous segment ids.

    Single source of the starts/ends/kmin/kmax formula for numpy (xp=np, the
    host span computation) and torch (xp=torch, the kernel's tile bounds on
    the device) — the two can never diverge."""
    ar = xp.arange(nq)
    if xp is torch:
        ar = ar.to(seg.device)
    starts = (ar * block_q).clip(max=S0 - 1)
    ends = ((ar + 1) * block_q - 1).clip(max=S0 - 1)
    kmin = xp.searchsorted(seg, seg[starts], side="left")
    kmax = xp.searchsorted(seg, seg[ends], side="right") - 1
    return kmin // block_k, kmax // block_k


def seg_max_span_blocks(segment_ids, block_q: int = 128,
                        block_k: int = 128) -> int:
    """Host helper: max k-block span any q block needs, for NONDECREASING
    contiguous segment ids (the ViT window-permuted layout)."""
    s = np.asarray(segment_ids)
    S0 = s.shape[0]
    if S0 == 0:
        return 1
    nq = -(-S0 // block_q)
    kstart, kend = _seg_kv_bounds(s, S0, nq, block_q, block_k, np)
    return int(np.max(kend - kstart + 1))


def flash_attention_segmented_reference(q, k, v, segment_ids) -> torch.Tensor:
    """Plain version of flash_attention_segmented (every row sees at least
    its own key, so no row is fully masked)."""
    seg = segment_ids.to(q.device)[None]
    return dense_attention(q[None], k[None], v[None], segment_ids_q=seg,
                           segment_ids_kv=seg)[0]


def flash_attention_segmented(
    q: torch.Tensor,                      # (S, H, D) — packed ViT sequence
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,            # (S,) int
    *,
    block_q: int = 128,
    block_k: int = 128,
    max_span_blocks: Optional[int] = None,
) -> torch.Tensor:
    """Segment-masked attention over a packed sequence.

    `max_span_blocks` (from seg_max_span_blocks at block_q x block_k) REQUIRES
    nondecreasing segment ids: the kernel then visits, for each 64-row q tile,
    only the k tiles between the first key of its first row's segment and
    the last key of its last row's segment, computed on the device from the
    ids. Without it the kernel is dense-safe for arbitrary ids (every k tile
    visited, the mask decides). When the ids are given on the host (a CPU
    tensor), an underestimated span raises, as in the JAX wrapper."""
    S, H, D = q.shape
    check_shapes("flash_attention_segmented",
                 q.shape == k.shape == v.shape and tuple(segment_ids.shape) == (S,),
                 q=q, k=k, v=v, segment_ids=segment_ids)
    if max_span_blocks is not None and segment_ids.device.type == "cpu":
        actual = seg_max_span_blocks(segment_ids.numpy(), block_q, block_k)
        if actual > max_span_blocks:
            raise ValueError(
                f"max_span_blocks={max_span_blocks} underestimates the real "
                f"k-block span {actual} for block_q={block_q} "
                f"block_k={block_k}; attention would be silently truncated")
    if q.device.type == "cpu":
        return flash_attention_segmented_reference(q, k, v, segment_ids)
    if S == 0:
        return torch.empty_like(q)
    check_kernel_inputs("flash_attention_segmented", q, k, v)
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention_segmented kernel: unsupported D={D}")
    seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    nq = -(-S // KERNEL_TILE)
    if max_span_blocks is not None:
        kstart, kend = _seg_kv_bounds(seg, S, nq, KERNEL_TILE, KERNEL_TILE, torch)
        kstart = kstart.to(torch.int32).contiguous()
        kend = kend.to(torch.int32).contiguous()
    else:
        kstart = torch.zeros(nq, dtype=torch.int32, device=q.device)
        kend = torch.full((nq,), nq - 1, dtype=torch.int32, device=q.device)
    out = torch.empty((S, H, D), dtype=q.dtype, device=q.device)
    rc = _build.library().socio_flash_segmented_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), seg.data_ptr(),
        kstart.data_ptr(), kend.data_ptr(), S, H, D,
        *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], *out.stride()[:2],
        D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "socio_flash_segmented_bf16")
    flash_attention_segmented.launches += 1
    return out


flash_attention_segmented.launches = 0
