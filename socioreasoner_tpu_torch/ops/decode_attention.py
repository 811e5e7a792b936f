"""Decode attention over the slot KV cache: hand-written Hopper kernels.

The counterpart of socioreasoner_tpu/ops/decode_attention.py: one query
token per slot attends over that slot's cache prefix, reading only the
ceil(len / 64) cache blocks it needs (csrc/paged_decode.cu). Each slot's
blocks are split over several CTAs whose partial softmax states a second
kernel merges (flash-decoding), so a handful of slots still fills the card.
With ``layer=`` the caches are the engine's stacked (layers, S, Lalloc, Hkv,
D) buffers and the kernel reads one layer through a view, without a copy.

The cache is bf16, or int8 with f32 per-token, per-kv-head scales
(``quantize_kv``) stored transposed as ([layers,] S, Hkv, Lalloc); given
``k_scale``/``v_scale``, ``paged_decode_attention`` runs the int8 kernel
(``paged_decode_attention_int8``), which dequantises inside the kernel.

A wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for tensors on a GPU, or raises. There is no fallback
from a GPU tensor to the plain version. ``paged_decode_attention.launches``
and ``paged_decode_attention_int8.launches`` count the launches of the two
kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .attention import dense_attention
from .flash_attention import check_kernel_inputs, check_shapes
from .quant import _INV127

KERNEL_BLOCK = 64         # cache rows per kernel block; Lalloc must be a multiple
KERNEL_HEAD_DIM = 128     # one thread per head dim
KERNEL_MAX_REP = 16       # q heads per kv head


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token, per-head int8 codes for K/V: x (B, L, Hkv, D) →
    (int8 (B, L, Hkv, D), f32 scales (B, L, Hkv)), x ≈ codes * scales[..., None];
    amax / 127 with amax floored at 1e-8, as the JAX package computes it
    inside the engine (see ops/quant.py on the reciprocal)."""
    xf = x.float()
    scales = xf.abs().amax(dim=-1).clamp_min(1e-8) * _INV127
    vals = torch.round(xf / scales[..., None]).clamp_(-127, 127)
    return vals.to(torch.int8), scales


def dequantize_kv(vals: torch.Tensor, scales_t: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_kv: vals (B, L, Hkv, D) int8 and scales stored
    transposed (B, Hkv, L) → (B, L, Hkv, D) of `dtype`."""
    scales = scales_t.transpose(-1, -2)                          # (B, L, Hkv)
    return (vals.float() * scales[..., None]).to(dtype)


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


def paged_decode_attention_int8_reference(q, k_cache, v_cache, lengths, k_scale,
                                          v_scale, *, layer: Optional[int] = None
                                          ) -> torch.Tensor:
    """Plain version of the int8 path: dequantize_kv to q's dtype, then
    paged_decode_attention_reference."""
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
        k_scale, v_scale = k_scale[layer], v_scale[layer]
    return paged_decode_attention_reference(
        q, dequantize_kv(k_cache, k_scale, q.dtype),
        dequantize_kv(v_cache, v_scale, q.dtype), lengths)


def _split_buffers(q, S, Hkv, Lmax):
    """Partial-state scratch of the flash-decoding split: each slot's blocks
    over enough CTAs for ~2 per SM."""
    H, D = q.shape[1], q.shape[2]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split = max(1, min(Lmax // KERNEL_BLOCK, -(-2 * sms // (S * Hkv))))
    part_acc = torch.empty((n_split, S, H, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((n_split, S, H, 2), dtype=torch.float32, device=q.device)
    return n_split, part_acc, part_ml


def _check_kernel_shape(name, H, Hkv, D, Lmax):
    if D != KERNEL_HEAD_DIM or H % Hkv or H // Hkv > KERNEL_MAX_REP:
        raise ValueError(f"{name} kernel: unsupported H={H} Hkv={Hkv} D={D}")
    if Lmax % KERNEL_BLOCK:
        raise ValueError(f"cache length {Lmax} must be a multiple of {KERNEL_BLOCK}")


def paged_decode_attention(
    q: torch.Tensor,          # (S, H, D) one query token per slot
    k_cache: torch.Tensor,    # (S, Lmax, Hkv, D), or ([layers,] S, Lmax, Hkv, D) with `layer`
    v_cache: torch.Tensor,
    lengths: torch.Tensor,    # (S,) valid KV length per slot (incl. current token)
    k_scale: Optional[torch.Tensor] = None,   # int8 cache: ([layers,] S, Hkv, Lmax) f32
    v_scale: Optional[torch.Tensor] = None,
    *,
    layer: Optional[int] = None,
) -> torch.Tensor:
    if k_scale is not None:
        return paged_decode_attention_int8(q, k_cache, v_cache, lengths, k_scale,
                                           v_scale, layer=layer)
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
    _check_kernel_shape("paged_decode_attention", H, Hkv, D, Lmax)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    n_split, part_acc, part_ml = _split_buffers(q, S, Hkv, Lmax)
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


def _check_int8_kernel_inputs(name, q, caches, scales):
    check_kernel_inputs(name, q)
    for t in caches + scales:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
    for t in caches:
        if t.dtype != torch.int8:
            raise ValueError(f"{name}: the cache must be int8, got {t.dtype}")
        # the kernel loads 16 int8 values at once
        if t.stride(-1) != 1 or any(s % 16 for s in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: cache strides {t.stride()} are not 16-byte rows")
    for t in scales:
        if t.dtype != torch.float32 or t.stride(-1) != 1:
            raise ValueError(f"{name}: scales must be float32 with unit last stride, "
                             f"got {t.dtype} strides {t.stride()}")


def paged_decode_attention_int8(q, k_cache, v_cache, lengths, k_scale, v_scale, *,
                                layer: Optional[int] = None) -> torch.Tensor:
    """Decode attention over an int8 cache (S, Lmax, Hkv, D) with f32 scales
    (S, Hkv, Lmax), or the stacked ([layers,] ...) buffers with `layer`: the
    kernel dequantises each row in f32 as it reads it."""
    if layer is not None:                                     # views, no copy
        k_cache, v_cache = k_cache[layer], v_cache[layer]
        k_scale, v_scale = k_scale[layer], v_scale[layer]
    S, H, D = q.shape
    check_shapes("paged_decode_attention_int8",
                 k_cache.shape == v_cache.shape and k_cache.dim() == 4
                 and k_cache.shape[0] == S and k_cache.shape[3] == D
                 and tuple(lengths.shape) == (S,)
                 and k_scale.shape == v_scale.shape
                 and tuple(k_scale.shape) == (S, k_cache.shape[2], k_cache.shape[1]),
                 q=q, k_cache=k_cache, v_cache=v_cache, lengths=lengths,
                 k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_int8_reference(q, k_cache, v_cache, lengths,
                                                     k_scale, v_scale)
    Lmax, Hkv = k_cache.shape[1], k_cache.shape[2]
    _check_int8_kernel_inputs("paged_decode_attention_int8", q, (k_cache, v_cache),
                              (k_scale, v_scale))
    _check_kernel_shape("paged_decode_attention_int8", H, Hkv, D, Lmax)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    n_split, part_acc, part_ml = _split_buffers(q, S, Hkv, Lmax)
    out = torch.empty((S, H, D), dtype=q.dtype, device=q.device)
    rc = _build.library().socio_paged_decode_int8(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), lengths.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), S, H, Hkv, D, Lmax, n_split,
        *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *k_scale.stride()[:2], *v_scale.stride()[:2], *out.stride()[:2], D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "socio_paged_decode_int8")
    paged_decode_attention_int8.launches += 1
    return out


paged_decode_attention_int8.launches = 0
