"""Flash attention for the prefill and the ViT: hand-written Hopper kernels.

The counterpart of socioreasoner_tpu/ops/flash_attention.py:

  flash_attention           — causal or full, per-row valid KV length from a
                              contiguous-prefix mask, GQA folded into the
                              kernel (csrc/flash_prefill.cu)
  flash_attention_segmented — segment-id equality mask, non-causal, over a
                              packed ViT sequence (csrc/flash_segmented.cu)

Both kernels are the persistent TMA + wgmma CTA of csrc/attention_sm90.cuh,
compiled for a few head-dim instances; head_dim_plan maps any head dim up to
128 onto one (zero-filled tail columns, a host pad where D is not a multiple
of 8) and the wrappers raise for a larger one, naming H, Hkv and D.
Kernel 1 walks a work list built here from the segment ids
(seg_tile_plan); kernel 2 derives its k ranges on the device from kv_len
(prefill_tile_bounds is the host copy of that formula).

Each wrapper takes its plain PyTorch version (``*_reference``, written with
dense_attention) for tensors on the CPU, and launches its CUDA kernel for
tensors on a GPU — or raises if the kernel cannot take them. There is no
fallback from a GPU tensor to the plain version. ``<wrapper>.launches`` counts
kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .attention import dense_attention

KERNEL_Q_TILE = 128     # query rows per work item of kernels 1, 2, 4 and 5 (2 warpgroups x 64)
KERNEL_K_TILE = 128     # keys per K/V tile of kernels 1, 2, 4 and 5
# The head-dim instances (the columns of a kernel's tiles) each kernel is
# compiled for, as csrc/sm90_common.cuh lists them (kGqaDims, kSegDims):
# kernels 2 and 4 64, 80 and 128, kernel 1 80 and 128. Any head dim up to
# 128 runs on one of them (head_dim_plan); a larger one raises.
KERNEL_HEAD_DIMS = (64, 80, 128)
SEG_HEAD_DIMS = (80, 128)
HEAD_DIM_ALIGN = 8      # 16-byte rows: what a tensor map's head stride needs


def head_dim_plan(D: int, instances) -> Optional["tuple[int, int]"]:
    """How a kernel compiled for `instances` serves head dim D: (the width
    the wrapper hands it, the instance it runs on), or None where no instance
    covers D. The width is D, or D padded with zero columns to the next
    multiple of HEAD_DIM_ALIGN where D is not one (OpenLLaMA-3B's 100 → 104:
    a row of 200 bytes cannot be a tensor map's stride); the instance is the
    smallest one of at least that width, whose columns past it TMA fills
    with zeros and the epilogue never stores. The host copy of
    head_dim_instance in csrc/sm90_common.cuh (socio_head_dim_instance runs
    it on the host)."""
    width = -(-D // HEAD_DIM_ALIGN) * HEAD_DIM_ALIGN
    inst = next((n for n in instances if n >= width), None)
    return None if D <= 0 or inst is None else (width, inst)


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """x (..., D) with zero columns up to `width` (a new contiguous tensor),
    or x itself where D is `width`: the copy a head dim that is not a
    multiple of HEAD_DIM_ALIGN costs before a kernel reads it."""
    D = x.shape[-1]
    return x if D == width else torch.nn.functional.pad(x, (0, width - D))


def check_kernel_inputs(name: str, *tensors: torch.Tensor) -> None:
    """What the CUDA kernels read: bf16 on one GPU, unit stride on the last
    dim, and 16-byte-aligned rows and base (the TMA tensor maps and 8-value
    vector loads need both). Reads each tensor's device index, not its
    torch.device (a launch's host time is most of a short kernel's call)."""
    dev = tensors[0].get_device()
    for t in tensors:
        if t.get_device() != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {tensors[0].device}")
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


def _kv_lens(attention_mask: Optional[torch.Tensor], B: int, Lk: int, device) -> torch.Tensor:
    if attention_mask is None:
        return torch.full((B,), Lk, dtype=torch.int32, device=device)
    return attention_mask.sum(dim=-1, dtype=torch.int32)


# ------------------------------------------------------------ causal prefill

def flash_attention_reference(q, k, v, attention_mask=None, *, causal: bool = True
                              ) -> torch.Tensor:
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
    """Flash attention with GQA kv heads folded into the kernel (any ratio
    H / Hkv up to KERNEL_Q_TILE). Returns (B, Lq, H, D). The kernel reads
    each batch row's valid prefix length, sum(attention_mask), on the
    device."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.size(1), k.size(2)
    check_shapes("flash_attention",
                 k.shape == v.shape and k.dim() == 4 and k.size(0) == B
                 and k.size(3) == D and (attention_mask is None
                                         or tuple(attention_mask.shape) == (B, Lk)),
                 q=q, k=k, v=v, attention_mask=attention_mask)
    if q.is_cpu:
        return flash_attention_reference(q, k, v, attention_mask, causal=causal)
    plan = head_dim_plan(D, KERNEL_HEAD_DIMS)
    if plan is None or H % Hkv or H // Hkv > KERNEL_Q_TILE:
        raise ValueError(f"flash_attention kernel: unsupported H={H} Hkv={Hkv} D={D}")
    Dp = plan[0]
    q, k, v = (pad_head_dim(x, Dp) for x in (q, k, v))
    check_kernel_inputs("flash_attention", q, k, v)
    kv_lens = _kv_lens(attention_mask, B, Lk, q.device).contiguous()
    out = torch.empty((B, Lq, H, Dp), dtype=q.dtype, device=q.device)
    rc = _build.library().socio_flash_prefill_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kv_lens.data_ptr(), B, Lq, Lk, H, Hkv, Dp,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), D ** -0.5, torch._C._cuda_getCurrentRawStream(q.get_device()))
    _build.check(rc, "socio_flash_prefill_bf16")
    flash_attention.launches += 1
    return out if Dp == D else out[..., :D]


flash_attention.launches = 0


def prefill_tile_bounds(t_tile: int, kv_len: int, Lq: int, Lk: int, rep: int,
                        causal: bool) -> "tuple[int, int]":
    """Kernel 2's bounds for one work item, a host copy of `prefill_k_tiles`
    in csrc/attention_sm90.cuh (the kernel computes them on the device from
    kv_len; chip_smoke.py holds this copy to the C++ formula through
    socio_prefill_tile_bounds): a token tile of KERNEL_Q_TILE // rep tokens
    visits k tiles 0 .. n_tiles - 1 and evaluates the mask only on tiles
    >= n_free (the tiles before reach neither past its first token nor past
    kv_len). Returns (n_tiles, n_free)."""
    toks = KERNEL_Q_TILE // rep
    t0 = t_tile * toks
    kv_len = min(max(kv_len, 0), Lk)
    k_hi, k_free = kv_len, kv_len
    if causal:
        k_hi = min(k_hi, min(t0 + toks, Lq))
        k_free = min(k_free, t0 + 1)
    return -(-k_hi // KERNEL_K_TILE), k_free // KERNEL_K_TILE


def gqa_work_item(item: int, B: int, Lq: int, Hkv: int, rep: int) -> "tuple[int, int, int]":
    """Work item `item` of kernels 2, 4 and 5, a host copy of `gqa_item` in
    csrc/attention_sm90.cuh (chip_smoke.py holds it to the C++ formula
    through socio_gqa_item): the (batch row, kv head, first token) of a token
    tile of KERNEL_Q_TILE // rep tokens x the rep q heads of the kv head,
    row r holding token t0 + r // rep of q head g * rep + r % rep. Items run
    over n_ttiles * B * Hkv, the last token tiles first, the (batch row, kv
    head) order rotated by one from one token tile to the next."""
    toks = KERNEL_Q_TILE // rep
    n_ttiles = -(-Lq // toks)
    bg_n = B * Hkv
    row = item // bg_n
    bg = (item + row) % bg_n
    return bg // Hkv, bg % Hkv, (n_ttiles - 1 - row) * toks


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


def _seg_kv_bounds(seg, S0: int, nq: int, block_q: int, block_k: int):
    """Per-q-block k-block bounds for NONDECREASING contiguous segment ids:
    the blocks from the first key of the block's first row's segment to the
    last key of its last row's segment (the JAX wrapper's formula)."""
    ar = np.arange(nq)
    starts = (ar * block_q).clip(max=S0 - 1)
    ends = ((ar + 1) * block_q - 1).clip(max=S0 - 1)
    kmin = np.searchsorted(seg, seg[starts], side="left")
    kmax = np.searchsorted(seg, seg[ends], side="right") - 1
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
    kstart, kend = _seg_kv_bounds(s, S0, nq, block_q, block_k)
    return int(np.max(kend - kstart + 1))


def seg_tile_plan(segment_ids, H: int, dense: bool) -> "tuple[np.ndarray, np.ndarray]":
    """Kernel 1's work list and tiles, built on the host from the ids.

    tiles (n, 8) int32, per q tile: its first row, its rows (at most
    KERNEL_Q_TILE), the first key of its k tiles, their count (keys k0 + j *
    KERNEL_K_TILE ..), the first and last k tile inside the one segment all
    its rows share (no mask is evaluated there; empty otherwise), and two
    zeros. For NONDECREASING ids a tile starts at a segment start and packs
    whole segments while they fit, so a tile of short segments (the ViT's
    windows) needs one k tile holding exactly its own keys; a longer segment
    is cut into tiles that each see the whole segment. `dense` (arbitrary
    ids) cuts fixed tiles that visit every key and mask them all. work (n *
    H,) int32 lists every (head, tile) once as (head << 16) | tile, the
    tiles with the most k tiles first, so that the persistent CTAs'
    round-robin ends on light items."""
    s = np.asarray(segment_ids)
    S = s.shape[0]
    nk_all = -(-S // KERNEL_K_TILE)
    rows = []
    if dense:
        for t0 in range(0, S, KERNEL_Q_TILE):
            rows.append((t0, min(KERNEL_Q_TILE, S - t0), 0, nk_all, nk_all, -1))
    else:
        starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]]).tolist() + [S]
        i, n_seg = 0, len(starts) - 1
        while i < n_seg:
            a, b = starts[i], starts[i + 1]
            if b - a > KERNEL_Q_TILE:      # a long segment: tiles that each see it all
                nk = -(-(b - a) // KERNEL_K_TILE)
                rows += [(t0, min(KERNEL_Q_TILE, b - t0), a, nk, 0,
                          (b - a) // KERNEL_K_TILE - 1)
                         for t0 in range(a, b, KERNEL_Q_TILE)]
                i += 1
                continue
            m = i + 1                      # whole segments while they fit
            while m < n_seg and starts[m + 1] - a <= KERNEL_Q_TILE:
                m += 1
            n = starts[m] - a
            one = m == i + 1               # one segment: its full k tiles need no mask
            rows.append((a, n, a, -(-n // KERNEL_K_TILE), 0 if one else 1,
                         n // KERNEL_K_TILE - 1 if one else 0))
            i = m
    tiles = np.zeros((len(rows), 8), np.int32)
    tiles[:, :6] = rows
    if len(rows) >= 1 << 16 or H >= 1 << 15:
        raise ValueError(f"seg_tile_plan: {len(rows)} tiles x {H} heads do not fit the work list")
    order = np.argsort(-tiles[:, 3], kind="stable")
    work = (np.arange(H)[None, :] << 16) | order[:, None]
    return work.reshape(-1).astype(np.int32), tiles


def _check_span(segment_ids, block_q: int, block_k: int, max_span_blocks: int) -> None:
    actual = seg_max_span_blocks(segment_ids, block_q, block_k)
    if actual > max_span_blocks:
        raise ValueError(
            f"max_span_blocks={max_span_blocks} underestimates the real "
            f"k-block span {actual} for block_q={block_q} "
            f"block_k={block_k}; attention would be silently truncated")


class SegPlan(NamedTuple):
    """Kernel 1's plan for one id array on one device (seg_plan)."""
    seg: torch.Tensor         # (S,) int32 ids
    work: torch.Tensor        # (n_items,) int32, seg_tile_plan's work list
    tiles: torch.Tensor       # (n_tiles, 8) int32
    heads: int
    spans: tuple              # the (block_q, block_k, max_span_blocks) it was checked for


def seg_plan(segment_ids, H: int, device, *, block_q: int = 128, block_k: int = 128,
             max_span_blocks: Optional[int] = None) -> SegPlan:
    """Kernel 1's work list and tiles (seg_tile_plan) for these ids on
    `device`, after flash_attention_segmented's span check. A caller that
    attends over the same ids many times builds it once and passes it as
    `plan=` (the ViT's 32 layers share two id arrays); otherwise the wrapper
    builds it per call. Reads the ids on the host (a GPU tensor is copied,
    a synchronisation)."""
    host = torch.as_tensor(segment_ids).detach().to("cpu", torch.int32).numpy()
    if max_span_blocks is not None:
        _check_span(host, block_q, block_k, max_span_blocks)
    work, tiles = seg_tile_plan(host, H, max_span_blocks is None)
    return SegPlan(*(torch.as_tensor(a, device=device) for a in (host, work, tiles)), H,
                   (block_q, block_k, max_span_blocks))


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
    plan: Optional[SegPlan] = None,
) -> torch.Tensor:
    """Segment-masked attention over a packed sequence.

    The span arguments are the JAX wrapper's and serve here as a check: the
    kernel's tiles are fixed (KERNEL_Q_TILE x KERNEL_K_TILE). Passing
    `max_span_blocks` (from seg_max_span_blocks at block_q x block_k) states
    that the ids are NONDECREASING: the kernel then visits, for each q tile,
    only the k tiles of the segments its rows belong to (seg_tile_plan), and
    an underestimated span raises, as in the JAX wrapper. Without it the
    kernel is dense-safe for arbitrary ids (every k tile visited, the mask
    decides). The kernel's plan is built on the host from the ids
    (seg_plan), or given as `plan`, built by seg_plan from these ids with
    the same span arguments."""
    S, H, D = q.shape
    check_shapes("flash_attention_segmented",
                 q.shape == k.shape == v.shape and tuple(segment_ids.shape) == (S,),
                 q=q, k=k, v=v, segment_ids=segment_ids)
    if plan is not None and (plan.heads != H or plan.seg.numel() != S
                             or plan.seg.get_device() != q.get_device()
                             or plan.spans != (block_q, block_k, max_span_blocks)):
        raise ValueError(f"flash_attention_segmented: a plan for {plan.seg.numel()} rows, "
                         f"{plan.heads} heads, spans {plan.spans} on {plan.seg.device}, "
                         f"given S={S} H={H} on {q.device}, spans "
                         f"{(block_q, block_k, max_span_blocks)}")
    if q.is_cpu:
        if max_span_blocks is not None:
            _check_span(segment_ids.numpy(), block_q, block_k, max_span_blocks)
        return flash_attention_segmented_reference(q, k, v, segment_ids)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # the kernel writes a fresh tensor with no autograd node: the
        # gradient of q, k and v would be dropped without a word
        raise RuntimeError("flash_attention_segmented: the CUDA kernel has no backward; "
                           "a differentiable call takes the dense attention "
                           "(vision_tower(..., use_flash=False))")
    if S == 0:
        return torch.empty_like(q)
    widths = head_dim_plan(D, SEG_HEAD_DIMS)
    if widths is None:
        raise ValueError(f"flash_attention_segmented kernel: unsupported H={H} D={D}")
    Dp = widths[0]
    q, k, v = (pad_head_dim(x, Dp) for x in (q, k, v))
    check_kernel_inputs("flash_attention_segmented", q, k, v)
    if plan is None:
        plan = seg_plan(segment_ids, H, q.device, block_q=block_q, block_k=block_k,
                        max_span_blocks=max_span_blocks)
    out = torch.empty((S, H, Dp), dtype=q.dtype, device=q.device)
    rc = _build.library().socio_flash_segmented_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), plan.seg.data_ptr(),
        plan.work.data_ptr(), plan.tiles.data_ptr(), S, H, Dp, plan.work.numel(),
        *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], *out.stride()[:2],
        D ** -0.5, torch._C._cuda_getCurrentRawStream(q.get_device()))
    _build.check(rc, "socio_flash_segmented_bf16")
    flash_attention_segmented.launches += 1
    return out if Dp == D else out[..., :D]


flash_attention_segmented.launches = 0


# ------------------------------------------------------- tensor parallelism

def _check_shards(name: str, devices, *shards) -> None:
    """One block a device in every per-shard list."""
    if any(len(x) != len(devices) for x in shards):
        raise ValueError(f"{name}: {[len(x) for x in shards]} shards for "
                         f"{len(devices)} devices")


def flash_attention_tp(q, k, v, attention_mask=None, *, devices, **kw) -> list:
    """Head-sharded flash attention over the tensor-parallel `devices` (the
    decode engine's prefill under tp). Heads are independent: shard t runs
    the unmodified kernel on its contiguous GQA block of q heads and kv heads
    (q-head block t attends kv-head block t), the same grouping as
    paged_decode_attention_tp, so the prefill-written cache shards line up
    with the decode reads.

    q, k, v are lists of per-shard blocks (B, L, H/T, D) / (B, L, Hkv/T, D),
    each contiguous on its device (a view of a head block would fail the
    kernels' stride checks); the result is the list of per-shard outputs.
    The mask is the same on every shard. The engine refuses a tp that does
    not divide the heads."""
    _check_shards("flash_attention_tp", devices, q, k, v)
    return [flash_attention(qt, kt, vt, None if attention_mask is None
                            else attention_mask.to(qt.device), **kw)
            for qt, kt, vt in zip(q, k, v)]
