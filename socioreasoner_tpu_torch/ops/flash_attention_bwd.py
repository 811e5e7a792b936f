"""Trainable flash attention: hand-written Hopper kernels under one
torch.autograd.Function.

The counterpart of socioreasoner_tpu/ops/flash_attention_bwd.py:

  flash_attention_fwd_lse  — causal GQA attention over per-row kv lengths plus
                             the per-row logsumexp (csrc/flash_train_fwd.cu,
                             the Pallas `_fwd_kernel`)
  flash_attention_bwd_dq   — dq (csrc/flash_train_bwd.cu, `_dq_kernel`)
  flash_attention_bwd_dkv  — dk and dv, summed over each GQA group
                             (csrc/flash_train_bwd.cu, `_dkv_kernel`)
  flash_attention_trainable — the autograd Function over the three: the
                             forward saves out (q's dtype) and lse (f32); the
                             backward computes delta = rowsum(dO * O) in f32
                             from the saved out, as `_flash_bwd_rule` does in
                             XLA outside the kernels, then runs dq and dk/dv.
                             kv_lens gets no gradient.

Conventions of the JAX kernels, kept by the kernels and the plain versions:
the mask is key < kv_len (a contiguous valid prefix per batch row) and, when
causal, key <= query index; rows with no valid key give out 0 and lse NEG_INF;
query rows >= kv_len are real rows that attend to the keys < kv_len.

Each wrapper takes its plain PyTorch version (``*_reference``) for tensors on
the CPU and launches its CUDA kernel for tensors on a GPU, or raises; there is
no fallback. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .attention import NEG_INF, repeat_kv
from .flash_attention import KERNEL_TILE, check_kernel_inputs, check_shapes

TRAIN_HEAD_DIMS = (128,)      # the text decoder's head dim


def _lens(kv_lens: Optional[torch.Tensor], B: int, Lk: int, device) -> torch.Tensor:
    """(B,) int32 valid kv lengths on `device`; all Lk when None."""
    if kv_lens is None:
        return torch.full((B,), Lk, dtype=torch.int32, device=device)
    return kv_lens.to(device=device, dtype=torch.int32).contiguous()


def _mask(kv_lens: torch.Tensor, Lq: int, Lk: int, causal: bool) -> torch.Tensor:
    """(B, 1, Lq, Lk) bool: key < kv_len and, if causal, key <= query index."""
    cols = torch.arange(Lk, device=kv_lens.device)
    mask = (cols[None, :] < kv_lens[:, None].long())[:, None, None, :]
    if causal:
        rows = torch.arange(Lq, device=kv_lens.device)
        mask = mask & (cols[None, :] <= rows[:, None])[None, None]
    return mask


# ---------------------------------------------------------------- plain versions

def flash_attention_fwd_lse_reference(q, k, v, kv_lens, causal: bool = True
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward: (out (B, Lq, H, D) in q's dtype, lse
    (B, H, Lq) f32), softmax in f32. A row with no valid key gives out 0 and
    lse NEG_INF, as the Pallas kernel's lsafe = 1 does."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    lens = _lens(kv_lens, B, Lk, q.device)
    kf, vf = repeat_kv(k.float(), H // Hkv), repeat_kv(v.float(), H // Hkv)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * D ** -0.5
    mask = _mask(lens, Lq, Lk, causal)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    lsafe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p / lsafe, vf)
    return out.to(q.dtype), (m + torch.log(lsafe))[..., 0]


def flash_attention_bwd_reference(q, k, v, do, lse, delta, kv_lens,
                                  causal: bool = True):
    """Plain version of the backward BY THE KERNELS' FORMULA (no autograd):
    p = exp(s * scale - lse) where the mask holds, else 0; ds = p * (dO V^T -
    delta) * scale; dq = ds K, dk = ds^T q and dv = p^T dO, summed over each
    GQA group. lse and delta are (B, H, Lq) f32. Returns (dq, dk, dv) in the
    inputs' dtypes, computed in f32."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    lens = _lens(kv_lens, B, Lk, q.device)
    qf, dof = q.float(), do.float()
    kf, vf = repeat_kv(k.float(), rep), repeat_kv(v.float(), rep)
    scale = D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = _mask(lens, Lq, Lk, causal)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.float()[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(B, Lk, Hkv, rep, D).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(B, Lk, Hkv, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernels

def _check(name: str, q, k, v, kv_lens, *more) -> None:
    """Shapes, then (for GPU tensors) what the CUDA kernels read."""
    B, Lq, H, D = q.shape
    check_shapes(name, k.dim() == 4 and k.shape == v.shape and k.shape[0] == B
                 and k.shape[3] == D and H % k.shape[2] == 0
                 and (kv_lens is None or tuple(kv_lens.shape) == (B,))
                 and all(t.shape == s for t, s in more),
                 q=q, k=k, v=v, kv_lens=kv_lens)
    if q.device.type != "cpu":
        check_kernel_inputs(name, q, k, v, *(t for t, s in more if len(s) == 4))
        Hkv = k.shape[2]
        if D not in TRAIN_HEAD_DIMS or KERNEL_TILE % (H // Hkv):
            raise ValueError(f"{name} kernel: unsupported H={H} Hkv={Hkv} D={D}")
        for t, s in more:
            if len(s) == 3 and (t.device != q.device or t.dtype != torch.float32
                                or not t.is_contiguous()):
                raise ValueError(f"{name}: lse/delta must be contiguous float32 "
                                 f"on {q.device}")


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_lens: Optional[torch.Tensor] = None, *,
                            causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Lq, H, D), k/v (B, Lk, Hkv, D), kv_lens (B,) → (out (B, Lq, H, D),
    lse (B, H, Lq) f32)."""
    _check("flash_attention_fwd_lse", q, k, v, kv_lens)
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_reference(q, k, v, kv_lens, causal)
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    lens = _lens(kv_lens, B, Lk, q.device)
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    rc = _build.library().socio_flash_train_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        lens.data_ptr(), B, Lq, Lk, H, Hkv, D, *_strides(q, k, v, out),
        int(causal), D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "socio_flash_train_fwd_bf16")
    flash_attention_fwd_lse.launches += 1
    return out, lse


flash_attention_fwd_lse.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, delta, kv_lens=None, *,
                           causal: bool = True) -> torch.Tensor:
    """dq (B, Lq, H, D) from the saved lse and delta ((B, H, Lq) f32)."""
    B, Lq, H, D = q.shape
    stats = (B, H, Lq)
    _check("flash_attention_bwd_dq", q, k, v, kv_lens,
           (do, q.shape), (lse, stats), (delta, stats))
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, do, lse, delta, kv_lens, causal)[0]
    Lk, Hkv = k.shape[1], k.shape[2]
    lens = _lens(kv_lens, B, Lk, q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    rc = _build.library().socio_flash_train_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), lens.data_ptr(), B, Lq, Lk, H, Hkv, D,
        *_strides(q, k, v, do, dq), int(causal), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "socio_flash_train_dq_bf16")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv_lens=None, *,
                            causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, Lk, Hkv, D): the GQA group sum happens in the
    kernel."""
    B, Lq, H, D = q.shape
    stats = (B, H, Lq)
    _check("flash_attention_bwd_dkv", q, k, v, kv_lens,
           (do, q.shape), (lse, stats), (delta, stats))
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, do, lse, delta, kv_lens, causal)[1:]
    Lk, Hkv = k.shape[1], k.shape[2]
    lens = _lens(kv_lens, B, Lk, q.device)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    rc = _build.library().socio_flash_train_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), lens.data_ptr(),
        B, Lq, Lk, H, Hkv, D, *_strides(q, k, v, do, dk, dv), int(causal), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "socio_flash_train_dkv_bf16")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


# ---------------------------------------------------------------- autograd

class _FlashAttentionTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal):
        out, lse = flash_attention_fwd_lse(q, k, v, kv_lens, causal=causal)
        ctx.save_for_backward(q, k, v, kv_lens, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_lens, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        # delta = rowsum(dO * O) in f32 from the saved out, (B, H, Lq)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, kv_lens, causal=ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, kv_lens,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kv_lens: Optional[torch.Tensor] = None,
                              causal: bool = True) -> torch.Tensor:
    """Differentiable flash attention. kv_lens: (B,) valid kv lengths
    (contiguous-prefix masks; no gradient), all keys when None. Returns
    (B, Lq, H, D)."""
    lens = _lens(kv_lens, q.shape[0], k.shape[1], q.device)
    return _FlashAttentionTrainable.apply(q, k, v, lens, causal)
