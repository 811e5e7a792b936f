"""Trainable flash attention: hand-written Hopper kernels under one
torch.autograd.Function.

The counterpart of socioreasoner_tpu/ops/flash_attention_bwd.py:

  flash_attention_fwd_lse  — causal GQA attention over per-row kv lengths plus
                             the per-row logsumexp (kernel 4,
                             csrc/flash_train_fwd.cu, the Pallas
                             `_fwd_kernel`): kernel 2's TMA + wgmma CTA
                             (csrc/attention_sm90.cuh) with an lse epilogue
  flash_attention_bwd_dq   — dq (kernel 5, csrc/flash_train_dq_sm90.cu,
                             `_dq_kernel`): kernel 4's work items and
                             warp-specialised TMA + wgmma CTA, with S, dP
                             and dS in registers and dQ += dS K in place of
                             O += P V
  flash_attention_bwd_dkv  — dk and dv, summed over each GQA group (kernel 6,
                             csrc/flash_train_dkv_sm90.cu, `_dkv_kernel`): a
                             warp-specialised TMA + wgmma kernel over a work
                             list built here (dkv_tile_plan: 128-key tiles
                             whose (q head, 64-row q tile) pairs are cut into
                             pieces of at most an even share of the SMs, the
                             pieces of a split tile added in piece order;
                             the kernel traps where the plan's lengths are
                             not the call's kv_lens)
  flash_attention_trainable — the autograd Function over the three: the
                             forward saves out (q's dtype) and lse (f32); the
                             backward computes delta = rowsum(dO * O) in f32
                             from the saved out, as `_flash_bwd_rule` does in
                             XLA outside the kernels, then runs dq and dk/dv.
                             kv_lens gets no gradient. A caller that runs many
                             layers over the same kv_lens builds kernel 6's
                             plan once (dkv_plan) and passes it as `plan=`.

Head dims: kernel 4 runs on kernel 2's instances (64, 80, 128 columns),
kernels 5 and 6 on 64 and 128 (TRAIN_HEAD_DIMS); any head dim up to 128 runs
on the smallest instance that covers it (head_dim_plan: the tail columns
zero-filled by TMA, q/k/v/dO padded on the host where D is not a multiple of
8), a larger one raises ValueError naming H, Hkv and D.

Conventions of the JAX kernels, kept by the kernels and the plain versions:
the mask is key < kv_len (a contiguous valid prefix per batch row) and, when
causal, key <= query index; rows with no valid key give out 0 and lse NEG_INF;
query rows >= kv_len are real rows that attend to the keys < kv_len. The
kernels take any GQA ratio rep = H / Hkv up to KERNEL_Q_TILE (a 128-row item
holds floor(128 / rep) tokens x rep heads).

Each wrapper takes its plain PyTorch version (``*_reference``) for tensors on
the CPU and launches its CUDA kernel for tensors on a GPU, or raises; there is
no fallback. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build
from .attention import NEG_INF, repeat_kv
from .flash_attention import (KERNEL_HEAD_DIMS, KERNEL_Q_TILE, check_kernel_inputs,
                              check_shapes, head_dim_plan, pad_head_dim)

# the head-dim instances kernels 5 and 6 are compiled for (csrc/sm90_common.cuh
# kBwdDims; kernel 4 is kernel 2's CTA, KERNEL_HEAD_DIMS): any head dim up to
# 128 runs on one of them (head_dim_plan), a larger one raises
TRAIN_HEAD_DIMS = (64, 128)

DKV_K_TILE = 128    # keys per kernel-6 work item (2 consumer warpgroups x 64)
DKV_Q_TILE = 64     # query rows per step of kernel 6's loop
DKV_MIN_CAP = 16    # the smallest share of (key tile, q head, q tile) pairs a CTA gets
# one piece's f32 dK and dV partials at the widest instance (a launch on the
# 64-column one has slots half as long, which fill the first half of the
# workspace)
DKV_SLOT_FLOATS = DKV_K_TILE * max(TRAIN_HEAD_DIMS) * 2
DKV_FIELDS = ("b", "g", "kt", "i_lo", "cnt", "p0", "np", "j", "n", "split", "ws0", "kv_len")
N_SM = 132          # an H100's SMs: the count a plan for a CPU tensor assumes


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


# ---------------------------------------------------------------- kernel 6's plan

def dkv_tile_plan(kv_lens, Lq: int, Lk: int, Hkv: int, rep: int, causal: bool,
                  n_sm: int = N_SM, cap: Optional[int] = None):
    """Kernel 6's work list, built on the host from the kv lengths.

    A key tile is DKV_K_TILE keys of one (batch row b, kv head g); its pairs
    are its (q head, DKV_Q_TILE-row q tile) pairs that the mask leaves
    non-empty: the rep q heads of g times the q tiles from the causal
    diagonal (i_lo) to the last, none when the tile starts at or past
    kv_len. Pair p of a tile is q head g * rep + p // cnt, q tile
    i_lo + p % cnt. All tiles' pairs, in (b, g, key tile) order, are cut into
    consecutive shares of `cap` pairs (default: the even share of the SMs,
    ceil(pairs / n_sm), at least DKV_MIN_CAP; a smaller cap gives more CTAs
    than SMs), one share a persistent CTA: a tile that a cut crosses is split
    into pieces, piece j on the j-th CTA it reaches, so no piece and no CTA
    holds more than `cap` pairs. Tiles without pairs (the kernel writes their
    zeros) go one a CTA from the last CTA back.

    Returns (items, cta_start, n_split, n_slots): items (n, 12) int32, one row
    per piece in DKV_FIELDS order (piece j of n; split: the tile's arrival
    counter, ws0: its first workspace slot, both -1 when n == 1; kv_len: b's
    length clipped to [0, Lk]), grouped by CTA; cta_start (n_cta + 1,) int32,
    CTA c taking rows cta_start[c] .. cta_start[c + 1] - 1 in order; the
    counts of split tiles and of workspace slots (one per piece of a split
    tile)."""
    lens = np.clip(np.asarray(kv_lens, np.int64).reshape(-1), 0, Lk).tolist()
    nq = -(-Lq // DKV_Q_TILE)
    tiles, empty = [], []
    for b, kv_len in enumerate(lens):
        for g in range(Hkv):
            for kt in range(-(-Lk // DKV_K_TILE)):
                k0 = kt * DKV_K_TILE
                i_lo = min(k0 // DKV_Q_TILE, nq) if causal else 0
                cnt = nq - i_lo if k0 < kv_len else 0
                (tiles if cnt else empty).append((b, g, kt, i_lo, cnt, kv_len))
    total = rep * sum(t[4] for t in tiles)
    if cap is None:
        cap = max(-(-total // n_sm), DKV_MIN_CAP)
    n_cta = max(-(-total // cap), min(n_sm, len(empty)))
    per_cta = [[] for _ in range(n_cta)]
    start, n_split, n_slots = 0, 0, 0
    for b, g, kt, i_lo, cnt, kv_len in tiles:
        pairs = rep * cnt
        # the share boundaries inside this tile's pairs
        cuts = [0] + [c * cap - start
                      for c in range(start // cap + 1, -(-(start + pairs) // cap))] + [pairs]
        n = len(cuts) - 1
        split, ws0 = (n_split, n_slots) if n > 1 else (-1, -1)
        if n > 1:
            n_split, n_slots = n_split + 1, n_slots + n
        for j in range(n):
            per_cta[(start + cuts[j]) // cap].append(
                (b, g, kt, i_lo, cnt, cuts[j], cuts[j + 1] - cuts[j], j, n, split, ws0, kv_len))
        start += pairs
    for i, (b, g, kt, i_lo, cnt, kv_len) in enumerate(empty):
        per_cta[n_cta - 1 - i % n_cta].append((b, g, kt, i_lo, cnt, 0, 0, 0, 1, -1, -1, kv_len))
    cta_start = np.zeros(n_cta + 1, np.int32)
    cta_start[1:] = np.cumsum([len(x) for x in per_cta])
    items = np.asarray([r for x in per_cta for r in x], np.int32).reshape(-1, len(DKV_FIELDS))
    return items, cta_start, n_split, n_slots


class DkvPlan(NamedTuple):
    """Kernel 6's plan for one (kv_lens, shape) on one device (dkv_plan)."""
    items: torch.Tensor       # (n_items, 12) int32, dkv_tile_plan's rows in CTA order
    cta_start: torch.Tensor   # (n_cta + 1,) int32
    workspace: torch.Tensor   # (n_slots, DKV_SLOT_FLOATS) f32 partials of split pieces
    counters: torch.Tensor    # (2 x split tiles,) int32 arrival counts, 0 between launches
    key: tuple                # the (B, Lq, Lk, H, Hkv, causal) it was built for
    n_cta: int
    lens: tuple               # the kv lengths it was built for, clipped to [0, Lk], on the host


def dkv_plan(kv_lens: Optional[torch.Tensor], B: int, Lq: int, Lk: int, H: int, Hkv: int,
             causal: bool, device, cap: Optional[int] = None) -> DkvPlan:
    """Kernel 6's plan (dkv_tile_plan, with its `cap`) for these kv lengths
    on `device`, with its workspace and zeroed arrival counters. Reads
    kv_lens on the host (a GPU tensor is copied, a synchronisation), so a
    caller that runs many layers over the same lengths builds it once and
    passes it as `plan=`; the kernel reads the lengths from the plan and
    traps where they are not the call's (the CPU path raises). One launch at
    a time may use a plan (the launch that used the counters resets
    them)."""
    device = torch.device(device)
    lens = np.clip(np.full(B, Lk) if kv_lens is None
                   else torch.as_tensor(kv_lens).detach().to("cpu").numpy(), 0, Lk)
    n_sm = (torch.cuda.get_device_properties(device).multi_processor_count
            if device.type == "cuda" else N_SM)
    items, cta_start, n_split, n_slots = dkv_tile_plan(lens, Lq, Lk, Hkv, H // Hkv, causal,
                                                       n_sm, cap)
    return DkvPlan(torch.as_tensor(items, device=device),
                   torch.as_tensor(cta_start, device=device),
                   torch.empty((n_slots, DKV_SLOT_FLOATS), dtype=torch.float32, device=device),
                   torch.zeros(2 * n_split, dtype=torch.int32, device=device),
                   (B, Lq, Lk, H, Hkv, bool(causal)), len(cta_start) - 1,
                   tuple(int(n) for n in lens.reshape(-1)))


def flash_attention_bwd_dkv_by_plan(q, k, v, do, lse, delta, items, causal: bool = True):
    """Plain version of kernel 6 BY ITS PLAN (dkv_tile_plan's items, in any
    order): each piece's partial dk/dv over its (q head, q tile) pairs by the
    formula of flash_attention_bwd_reference, in f32; the partials of a split
    key tile added in piece order, as the kernel's last piece adds them.
    Returns (dk, dv) in k's and v's dtypes."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    rep, scale = H // Hkv, D ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    lse, delta = lse.float(), delta.float()
    pieces = {}
    for b, g, kt, i_lo, cnt, p0, n_pairs, j, n, _, _, kv_len in np.asarray(items).tolist():
        keys = torch.arange(kt * DKV_K_TILE, min((kt + 1) * DKV_K_TILE, Lk))
        pk = torch.zeros(len(keys), D)
        pv = torch.zeros(len(keys), D)
        for pair in range(p0, p0 + n_pairs):
            h = g * rep + pair // cnt
            rows = torch.arange((i_lo + pair % cnt) * DKV_Q_TILE,
                                min((i_lo + pair % cnt + 1) * DKV_Q_TILE, Lq))
            s = qf[b, rows, h] @ kf[b, keys, g].T * scale
            mask = keys[None] < kv_len
            if causal:
                mask = mask & (keys[None] <= rows[:, None])
            p = torch.where(mask, torch.exp(s - lse[b, h, rows, None]), torch.zeros_like(s))
            dp = dof[b, rows, h] @ vf[b, keys, g].T
            ds = p * (dp - delta[b, h, rows, None]) * scale
            pk += ds.T @ qf[b, rows, h]
            pv += p.T @ dof[b, rows, h]
        pieces.setdefault((b, g, kt), [None] * n)[j] = (keys, pk, pv)
    dk = torch.zeros(B, Lk, Hkv, D)
    dv = torch.zeros(B, Lk, Hkv, D)
    for (b, g, _), parts in pieces.items():
        keys = parts[0][0]
        for _, pk, pv in parts:          # piece order
            dk[b, keys, g] += pk
            dv[b, keys, g] += pv
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernels

def _check(name: str, q, k, v, kv_lens, *more, instances=TRAIN_HEAD_DIMS) -> list:
    """Shapes (H % Hkv == 0), then (for GPU tensors) what the CUDA kernel
    reads: a head dim that one of `instances` serves (head_dim_plan), a GQA
    ratio H / Hkv of at most KERNEL_Q_TILE (the q heads of a kv head fit one
    128-row item), bf16 operands of 16-byte rows once padded to that width.
    Returns q, k, v and the (B, L, H, D) tensors of `more`, each padded to
    the width the kernel takes (as they are on the CPU)."""
    B, Lq, H, D = q.shape
    check_shapes(name, k.dim() == 4 and k.shape == v.shape and k.shape[0] == B
                 and k.shape[3] == D and H % k.shape[2] == 0
                 and (kv_lens is None or tuple(kv_lens.shape) == (B,))
                 and all(t.shape == s for t, s in more),
                 q=q, k=k, v=v, kv_lens=kv_lens)
    operands = [q, k, v, *(t for t, s in more if len(s) == 4)]
    if q.device.type == "cpu":
        return operands
    Hkv = k.shape[2]
    plan = head_dim_plan(D, instances)
    if plan is None or H // Hkv > KERNEL_Q_TILE:
        raise ValueError(f"{name} kernel: unsupported H={H} Hkv={Hkv} D={D}")
    operands = [pad_head_dim(t, plan[0]) for t in operands]
    check_kernel_inputs(name, *operands)
    for t, s in more:
        if len(s) == 3 and (t.device != q.device or t.dtype != torch.float32
                            or not t.is_contiguous()):
            raise ValueError(f"{name}: lse/delta must be contiguous float32 "
                             f"on {q.device}")
    return operands


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_lens: Optional[torch.Tensor] = None, *,
                            causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Lq, H, D), k/v (B, Lk, Hkv, D), kv_lens (B,) → (out (B, Lq, H, D),
    lse (B, H, Lq) f32)."""
    qp, kp, vp = _check("flash_attention_fwd_lse", q, k, v, kv_lens,
                        instances=KERNEL_HEAD_DIMS)
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_reference(q, k, v, kv_lens, causal)
    B, Lq, H, D = q.shape
    Lk, Hkv, Dp = k.shape[1], k.shape[2], qp.shape[-1]
    lens = _lens(kv_lens, B, Lk, q.device)
    out = torch.empty((B, Lq, H, Dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    rc = _build.library().socio_flash_train_fwd_bf16(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(), lse.data_ptr(),
        lens.data_ptr(), B, Lq, Lk, H, Hkv, Dp, *_strides(qp, kp, vp, out),
        int(causal), D ** -0.5, torch._C._cuda_getCurrentRawStream(q.get_device()))
    _build.check(rc, "socio_flash_train_fwd_bf16")
    flash_attention_fwd_lse.launches += 1
    return (out if Dp == D else out[..., :D]), lse


flash_attention_fwd_lse.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, delta, kv_lens=None, *,
                           causal: bool = True) -> torch.Tensor:
    """dq (B, Lq, H, D) from the saved lse and delta ((B, H, Lq) f32)."""
    B, Lq, H, D = q.shape
    stats = (B, H, Lq)
    qp, kp, vp, dop = _check("flash_attention_bwd_dq", q, k, v, kv_lens,
                             (do, q.shape), (lse, stats), (delta, stats))
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, do, lse, delta, kv_lens, causal)[0]
    Lk, Hkv, Dp = k.shape[1], k.shape[2], qp.shape[-1]
    lens = _lens(kv_lens, B, Lk, q.device)
    dq = torch.empty_like(qp, memory_format=torch.contiguous_format)
    rc = _build.library().socio_flash_train_dq_bf16(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), lens.data_ptr(), B, Lq, Lk, H, Hkv, Dp,
        *_strides(qp, kp, vp, dop, dq), int(causal), D ** -0.5,
        torch._C._cuda_getCurrentRawStream(q.get_device()))
    _build.check(rc, "socio_flash_train_dq_bf16")
    flash_attention_bwd_dq.launches += 1
    return dq if Dp == D else dq[..., :D]


flash_attention_bwd_dq.launches = 0


def _check_plan(plan: DkvPlan, key: tuple, q, lens: torch.Tensor) -> None:
    """The plan's shape and device against the call's and, for CPU tensors,
    its kv lengths (on a GPU the kernel compares them, without a host
    synchronisation)."""
    if plan.key != key or plan.items.get_device() != q.get_device():
        raise ValueError(f"flash_attention_bwd_dkv: a plan for (B, Lq, Lk, H, Hkv, causal) "
                         f"{plan.key} on {plan.items.device}, given {key} on {q.device}")
    if q.device.type == "cpu":
        given = tuple(lens.clamp(0, key[2]).tolist())
        if given != plan.lens:
            raise ValueError(f"flash_attention_bwd_dkv: a plan for kv lengths {plan.lens}, "
                             f"given {given}")


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv_lens=None, *, causal: bool = True,
                            plan: Optional[DkvPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, Lk, Hkv, D): the GQA group sum happens in the
    kernel. `plan`: dkv_plan's plan for these kv_lens and shapes (built here,
    a host synchronisation, when None); the kernel takes the lengths from it
    and traps where they are not kv_lens."""
    B, Lq, H, D = q.shape
    stats = (B, H, Lq)
    qp, kp, vp, dop = _check("flash_attention_bwd_dkv", q, k, v, kv_lens,
                             (do, q.shape), (lse, stats), (delta, stats))
    Lk, Hkv = k.shape[1], k.shape[2]
    key = (B, Lq, Lk, H, Hkv, bool(causal))
    lens = _lens(kv_lens, B, Lk, q.device)
    if plan is not None:
        _check_plan(plan, key, q, lens)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, do, lse, delta, kv_lens, causal)[1:]
    if plan is None:
        plan = dkv_plan(kv_lens, *key, q.device)
    Dp = qp.shape[-1]
    dk = torch.empty_like(kp, memory_format=torch.contiguous_format)
    dv = torch.empty_like(vp, memory_format=torch.contiguous_format)
    rc = _build.library().socio_flash_train_dkv_bf16(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), plan.items.data_ptr(),
        plan.cta_start.data_ptr(), plan.workspace.data_ptr(), plan.counters.data_ptr(),
        lens.data_ptr(), plan.n_cta, B, Lq, Lk, H, Hkv, Dp,
        *_strides(qp, kp, vp, dop, dk, dv), int(causal), D ** -0.5,
        torch._C._cuda_getCurrentRawStream(q.get_device()))
    _build.check(rc, "socio_flash_train_dkv_bf16")
    flash_attention_bwd_dkv.launches += 1
    return (dk, dv) if Dp == D else (dk[..., :D], dv[..., :D])


flash_attention_bwd_dkv.launches = 0


# ---------------------------------------------------------------- autograd

class _FlashAttentionTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal, plan):
        out, lse = flash_attention_fwd_lse(q, k, v, kv_lens, causal=causal)
        ctx.save_for_backward(q, k, v, kv_lens, out, lse)
        ctx.causal = causal
        ctx.plan = plan
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_lens, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        # delta = rowsum(dO * O) in f32 from the saved out, (B, H, Lq)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, kv_lens, causal=ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, kv_lens,
                                         causal=ctx.causal, plan=ctx.plan)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kv_lens: Optional[torch.Tensor] = None,
                              causal: bool = True,
                              plan: Optional[DkvPlan] = None) -> torch.Tensor:
    """Differentiable flash attention. kv_lens: (B,) valid kv lengths
    (contiguous-prefix masks; no gradient), all keys when None; plan: the
    dk/dv kernel's dkv_plan for them (built in the backward when None).
    Returns (B, Lq, H, D)."""
    lens = _lens(kv_lens, q.shape[0], k.shape[1], q.device)
    return _FlashAttentionTrainable.apply(q, k, v, lens, causal, plan)
