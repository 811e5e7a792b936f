"""Decode attention over the slot KV cache: a hand-written Hopper kernel.

The counterpart of socioreasoner_tpu/ops/decode_attention.py (bf16 cache):
one query token per slot attends over that slot's cache prefix, reading only
the ceil(len / 64) cache blocks it needs (csrc/paged_decode.cu). Each slot's
blocks are split over several CTAs whose partial softmax states a second
kernel merges (flash-decoding), so a handful of slots still fills the card.
With ``layer=`` the caches are the engine's stacked (layers, S, Lalloc, Hkv,
D) buffers and the kernel reads one layer through a view, without a copy.

The wrapper takes its plain PyTorch version for tensors on the CPU and
launches the kernel for tensors on a GPU, or raises. There is no fallback
from a GPU tensor to the plain version. ``paged_decode_attention.launches``
counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import dense_attention
from .flash_attention import check_kernel_inputs, check_shapes

KERNEL_BLOCK = 64         # cache rows per kernel block; Lalloc must be a multiple
KERNEL_HEAD_DIM = 128     # one thread per head dim
KERNEL_MAX_REP = 16       # q heads per kv head


def paged_decode_attention_reference(q, k_cache, v_cache, lengths, *,
                                     layer: Optional[int] = None) -> torch.Tensor:
    """Plain version of paged_decode_attention (a zero-length slot gives 0)."""
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
    Lmax = k_cache.shape[1]
    lengths = lengths.to(q.device)
    valid = torch.arange(Lmax, device=q.device)[None] < lengths[:, None]
    out = dense_attention(q[:, None], k_cache, v_cache, attention_mask=valid)[:, 0]
    return out * (lengths > 0).to(out.dtype)[:, None, None]


def paged_decode_attention(
    q: torch.Tensor,          # (S, H, D) one query token per slot
    k_cache: torch.Tensor,    # (S, Lmax, Hkv, D), or ([layers,] S, Lmax, Hkv, D) with `layer`
    v_cache: torch.Tensor,
    lengths: torch.Tensor,    # (S,) valid KV length per slot (incl. current token)
    *,
    layer: Optional[int] = None,
) -> torch.Tensor:
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]     # views, no copy
    S, H, D = q.shape
    check_shapes("paged_decode_attention",
                 k_cache.shape == v_cache.shape and k_cache.dim() == 4
                 and k_cache.shape[0] == S and k_cache.shape[3] == D
                 and tuple(lengths.shape) == (S,),
                 q=q, k_cache=k_cache, v_cache=v_cache, lengths=lengths)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_cache, v_cache, lengths)
    Lmax, Hkv = k_cache.shape[1], k_cache.shape[2]
    check_kernel_inputs("paged_decode_attention", q, k_cache, v_cache)
    if D != KERNEL_HEAD_DIM or H % Hkv or H // Hkv > KERNEL_MAX_REP:
        raise ValueError(f"paged_decode_attention kernel: unsupported H={H} "
                         f"Hkv={Hkv} D={D}")
    if Lmax % KERNEL_BLOCK:
        raise ValueError(f"cache length {Lmax} must be a multiple of "
                         f"{KERNEL_BLOCK}")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    # split each slot's blocks over enough CTAs for ~2 per SM (flash-decoding)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split = max(1, min(Lmax // KERNEL_BLOCK, -(-2 * sms // (S * Hkv))))
    part_acc = torch.empty((n_split, S, H, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((n_split, S, H, 2), dtype=torch.float32, device=q.device)
    out = torch.empty((S, H, D), dtype=q.dtype, device=q.device)
    rc = _build.library().socio_paged_decode_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        S, H, Hkv, D, Lmax, n_split,
        *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *out.stride()[:2], D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "socio_paged_decode_bf16")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
