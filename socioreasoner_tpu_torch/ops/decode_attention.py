"""Decode attention over the slot KV cache: hand-written Hopper kernels.

The counterpart of socioreasoner_tpu/ops/decode_attention.py: one query
token per slot attends over that slot's cache prefix, reading only the
ceil(len / 64) cache blocks it needs (csrc/paged_decode.cu). The blocks of
each (slot, kv head) are split over the ``n_split`` CTAs of one thread-block
cluster, which merge their softmax states through distributed shared memory
in rank order, so one launch a call fills the card with a handful of slots
and writes nothing but the output. ``n_split`` comes from the shape alone
(``split_count``); the kernel reads the lengths on the device, so a call
never synchronises and can be captured in a CUDA graph. With ``layer=`` the
caches are the engine's stacked (layers, S, Lalloc, Hkv, D) buffers and the
kernel reads one layer in place, without a copy.

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

import ctypes
import functools
import operator
from typing import Optional, Tuple

import torch

from . import _build
from .attention import dense_attention
from .flash_attention import check_shapes
from .quant import _INV127

KERNEL_BLOCK = 64         # cache rows per kernel block; Lalloc must be a multiple
KERNEL_HEAD_DIM = 128
KERNEL_MAX_REP = 16       # q heads per kv head: the kernel's 16 mma rows
CLUSTER_LIMIT = 8         # CTAs a (slot, kv head) is split over: the portable cluster size


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


# ------------------------------------------------------------------ the plan

def split_count(S: int, Hkv: int, Lalloc: int, sms: int) -> int:
    """CTAs a (slot, kv head) is split over: the largest power of two up to
    CLUSTER_LIMIT and the cache's Lalloc / 64 blocks with S * Hkv * n_split
    CTAs on no more than the card's `sms` SMs (1 where S * Hkv > sms / 2).
    Clusters of 16 (the non-portable size) measured slower at S = 4 on an
    H100 SXM: their scheduling cost more than the split saved."""
    n = 1
    while (2 * n <= CLUSTER_LIMIT and 2 * n * KERNEL_BLOCK <= Lalloc
           and S * Hkv * 2 * n <= sms):
        n *= 2
    return n


def block_range(length: int, Lalloc: int, n_split: int, rank: int) -> Tuple[int, int]:
    """The cache blocks [lo, hi) that CTA `rank` of a slot's cluster reads,
    as the kernel computes them from the slot's length: at least one block
    and never past Lalloc, ceil(nblocks / n_split) consecutive blocks a rank
    (the last ranks may get none)."""
    nblocks = min(max(-(-length // KERNEL_BLOCK), 1), Lalloc // KERNEL_BLOCK)
    chunk = -(-nblocks // n_split)
    lo = min(nblocks, rank * chunk)
    return lo, min(nblocks, lo + chunk)


class _Shape(ctypes.Structure):
    """The kernel's DecodeShape (csrc/paged_decode.cu): strides in elements,
    layer strides 0 for an unstacked cache."""
    _fields_ = ([(n, ctypes.c_int) for n in ("S", "H", "Hkv", "D", "Lalloc", "n_split",
                                             "n_layers")]
                + [(n, ctypes.c_longlong) for n in (
                    "sqs", "sqh", "skl", "sks", "skt", "skh", "svl", "svs", "svt", "svh",
                    "skss", "sksh", "svss", "svsh", "sos", "soh")]
                + [("scale", ctypes.c_float)])


class DecodePlan:
    """One call shape of kernel 3 or 3q, checked once: n_split, the launch's
    shape struct (passed by address), the bytes between layers of the
    stacked scale buffers, and the K/V tensor maps of each pair of cache
    buffers it has met (encoded once a buffer: the engine's caches live
    across decode steps)."""

    def __init__(self, quant: bool, S: int, H: int, Hkv: int, Lalloc: int, n_split: int,
                 n_layers: int, strides, scale_layer_bytes):
        self.quant, self.n_split, self.n_layers = quant, n_split, n_layers
        self.out_shape = (S, H, KERNEL_HEAD_DIM)
        self.scale_layer_bytes = scale_layer_bytes
        self.shape = _Shape(S, H, Hkv, KERNEL_HEAD_DIM, Lalloc, n_split, n_layers, *strides,
                            H * KERNEL_HEAD_DIM, KERNEL_HEAD_DIM, KERNEL_HEAD_DIM ** -0.5)
        self.shape_ptr = ctypes.addressof(self.shape)
        self.maps: dict = {}

    def tensor_maps(self, k_ptr: int, v_ptr: int) -> int:
        """Address of the K and V tensor maps of the buffers at k_ptr, v_ptr."""
        maps = self.maps.get((k_ptr, v_ptr))
        if maps is None:
            if len(self.maps) >= 16:
                self.maps.clear()
            maps = self.maps[(k_ptr, v_ptr)] = (ctypes.c_byte * 256)()
            _build.check(_build.library().socio_paged_decode_encode(
                int(self.quant), k_ptr, v_ptr, self.shape_ptr, ctypes.addressof(maps)),
                "socio_paged_decode_encode")
        return ctypes.addressof(maps)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_tensors(name, quant, q, caches, scales):
    """What the kernel reads: one GPU; bf16 q; bf16 (kernel 3) or int8
    (kernel 3q) caches and f32 scales; unit last strides and 16-byte rows
    (q's 8-byte fragment loads, the 16-byte-aligned row and scale copies)."""
    dev = q.get_device()
    for t in (q, *caches, *scales):
        if t.get_device() != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
    want = torch.int8 if quant else torch.bfloat16
    for t, dtype, unit in ([(q, torch.bfloat16, 8)] + [(t, want, 16 // want.itemsize)
                                                        for t in caches]
                           + [(t, torch.float32, 4) for t in scales]):
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.stride(-1) != 1 or any(s % unit for s in t.stride()[:-1]):
            raise ValueError(f"{name}: strides {t.stride()} are not 16-byte rows")


def _check_decode_shapes(name, q, k_cache, v_cache, lengths, k_scale=None, v_scale=None,
                         lead: int = 0):
    """The shapes fit: one layer's caches (S, Lmax, Hkv, D) and scales (S,
    Hkv, Lmax), behind `lead` (0, or 1 for the stacked buffers' layer dim)
    leading dims that agree. Raises before any kernel or plain version runs."""
    S, _, D = q.shape
    kv = k_cache.shape[lead:]
    ok = (k_cache.shape == v_cache.shape and k_cache.dim() == 4 + lead and kv[0] == S
          and kv[3] == D and tuple(lengths.shape) == (S,))
    if k_scale is not None:
        ok = ok and k_scale.shape == v_scale.shape and k_scale.dim() == 3 + lead \
            and k_scale.shape[:lead] == k_cache.shape[:lead] \
            and tuple(k_scale.shape[lead:]) == (S, kv[2], kv[1])
    check_shapes(name, ok, q=q, k_cache=k_cache, v_cache=v_cache, lengths=lengths,
                 k_scale=k_scale, v_scale=v_scale)


def _make_plan(q, k, v, ks, vs, lengths, stacked) -> DecodePlan:
    quant = ks is not None
    name = "paged_decode_attention_int8" if quant else "paged_decode_attention"
    S, H, D = q.shape
    lead = 1 if stacked else 0
    _check_decode_shapes(name, q, k, v, lengths, ks, vs, lead)
    _check_tensors(name, quant, q, (k, v), (ks, vs) if quant else ())
    Lalloc, Hkv = k.shape[lead + 1], k.shape[lead + 2]
    if D != KERNEL_HEAD_DIM or H % Hkv or H // Hkv > KERNEL_MAX_REP:
        raise ValueError(f"{name} kernel: unsupported H={H} Hkv={Hkv} D={D}")
    if Lalloc % KERNEL_BLOCK:
        raise ValueError(f"cache length {Lalloc} must be a multiple of {KERNEL_BLOCK}")
    n_split = split_count(S, Hkv, Lalloc, _sm_count(q.get_device()))
    layer = lambda t: t.stride(0) if stacked else 0    # noqa: E731
    strides = [*q.stride()[:2], layer(k), *k.stride()[lead:lead + 3],
               layer(v), *v.stride()[lead:lead + 3]]
    strides += [*ks.stride()[lead:lead + 2], *vs.stride()[lead:lead + 2]] if quant else [0] * 4
    scale_layer_bytes = (layer(ks) * 4, layer(vs) * 4) if quant else (0, 0)
    return DecodePlan(quant, S, H, Hkv, Lalloc, n_split, k.shape[0] if stacked else 1,
                      strides, scale_layer_bytes)


_PLANS: dict = {}


def decode_plan(q, k_cache, v_cache, lengths, k_scale=None, v_scale=None,
                stacked: bool = False) -> DecodePlan:
    """The plan of a call on GPU tensors, built and checked on the first
    call of its shapes, strides, dtypes and devices and looked up after."""
    key = (q.get_device(), q.dtype, q.shape, q.stride(), k_cache.get_device(), k_cache.dtype,
           k_cache.shape, k_cache.stride(), v_cache.get_device(), v_cache.dtype,
           v_cache.shape, v_cache.stride(), lengths.shape, stacked)
    if k_scale is not None:
        key += (k_scale.get_device(), k_scale.dtype, k_scale.shape, k_scale.stride(),
                v_scale.get_device(), v_scale.dtype, v_scale.shape, v_scale.stride())
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) >= 256:
            _PLANS.clear()
        plan = _PLANS[key] = _make_plan(q, k_cache, v_cache, k_scale, v_scale, lengths,
                                        stacked)
    return plan


def _launch(plan: DecodePlan, q, k, v, ks, vs, lengths, layer) -> torch.Tensor:
    """One launch of the plan's kernel over layer `layer` of the stacked
    caches (k, v and, for kernel 3q, the scales ks, vs), or over unstacked
    ones (layer None)."""
    if layer is None:
        layer = 0
    else:
        layer = operator.index(layer)
        if not -plan.n_layers <= layer < plan.n_layers:
            raise IndexError(f"layer {layer} of a cache of {plan.n_layers} layers")
        layer %= plan.n_layers
    k_ptr, v_ptr = k.data_ptr(), v.data_ptr()
    if q.data_ptr() % 16 or k_ptr % 16 or v_ptr % 16 or (
            ks is not None and (ks.data_ptr() % 16 or vs.data_ptr() % 16)):
        raise ValueError("decode attention: data pointers not 16-byte aligned")
    dev = q.get_device()
    if lengths.dtype != torch.int32 or lengths.get_device() != dev or not lengths.is_contiguous():
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    scales = (None, None) if ks is None else (      # the layer's scales, in place
        ks.data_ptr() + layer * plan.scale_layer_bytes[0],
        vs.data_ptr() + layer * plan.scale_layer_bytes[1])
    out = q.new_empty(plan.out_shape)
    rc = _build.library().socio_paged_decode(
        int(plan.quant), q.data_ptr(), plan.tensor_maps(k_ptr, v_ptr), *scales,
        out.data_ptr(), lengths.data_ptr(), layer, plan.shape_ptr,
        torch._C._cuda_getCurrentRawStream(dev))
    _build.check(rc, "socio_paged_decode")
    return out


# --------------------------------------------------------------- the wrappers

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
    if q.device.type == "cpu":
        if layer is not None:
            k_cache, v_cache = k_cache[layer], v_cache[layer]     # views, no copy
        _check_decode_shapes("paged_decode_attention", q, k_cache, v_cache, lengths)
        return paged_decode_attention_reference(q, k_cache, v_cache, lengths)
    plan = decode_plan(q, k_cache, v_cache, lengths, None, None, stacked=layer is not None)
    out = _launch(plan, q, k_cache, v_cache, None, None, lengths, layer)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_int8(q, k_cache, v_cache, lengths, k_scale, v_scale, *,
                                layer: Optional[int] = None) -> torch.Tensor:
    """Decode attention over an int8 cache (S, Lmax, Hkv, D) with f32 scales
    (S, Hkv, Lmax), or the stacked ([layers,] ...) buffers with `layer`: the
    kernel dequantises each row in f32 as it reads it."""
    if q.device.type == "cpu":
        if layer is not None:                                 # views, no copy
            k_cache, v_cache = k_cache[layer], v_cache[layer]
            k_scale, v_scale = k_scale[layer], v_scale[layer]
        _check_decode_shapes("paged_decode_attention_int8", q, k_cache, v_cache, lengths,
                             k_scale, v_scale)
        return paged_decode_attention_int8_reference(q, k_cache, v_cache, lengths,
                                                     k_scale, v_scale)
    plan = decode_plan(q, k_cache, v_cache, lengths, k_scale, v_scale,
                       stacked=layer is not None)
    out = _launch(plan, q, k_cache, v_cache, k_scale, v_scale, lengths, layer)
    paged_decode_attention_int8.launches += 1
    return out


paged_decode_attention_int8.launches = 0
