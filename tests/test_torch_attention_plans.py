"""The host-side plans of the Hopper attention kernels 1 and 2, on the CPU.

Kernel 1 (flash_attention_segmented) walks a work list of (head, q tile)
items whose rows and k ranges the wrapper builds from the segment ids
(seg_tile_plan); kernel 2 (flash_attention) computes each item's k range and
its unmasked tiles on the device from kv_len, by the formula of which
prefill_tile_bounds is the host copy (chip_smoke.py holds the copy to the
C++ formula). Both are held against brute force: every key a
row may see lies in its tile's range, and every tile the kernel leaves
unmasked holds only keys all its rows may see. The wrappers' plain versions
on CPU tensors are held against the JAX functions (Pallas in interpret
mode).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from socioreasoner_tpu.ops import flash_attention as j_fa
from socioreasoner_tpu_torch.ops import flash_attention as t_fa

QT, KT = t_fa.KERNEL_Q_TILE, t_fa.KERNEL_K_TILE


def _check_seg_plan(seg, H, dense):
    S = len(seg)
    work, tiles = t_fa.seg_tile_plan(seg, H, dense)
    n = len(tiles)
    assert work.dtype == np.int32 and tiles.dtype == np.int32 and tiles.shape == (n, 8)
    # every (head, tile) exactly once, the tiles with the most k tiles first
    items = sorted((int(w) >> 16, int(w) & 0xFFFF) for w in work)
    assert items == [(h, i) for h in range(H) for i in range(n)]
    assert (np.diff(tiles[work & 0xFFFF, 3]) <= 0).all()
    # every row in exactly one tile
    owner = np.zeros(S, np.int64)
    for t0, rows, *_ in tiles.tolist():
        assert 0 < rows <= QT and 0 <= t0 and t0 + rows <= S
        owner[t0:t0 + rows] += 1
    assert (owner == 1).all()
    for t0, rows, k0, nk, nm_lo, nm_hi, *_ in tiles.tolist():
        seen = seg[t0:t0 + rows, None] == seg[None, :]      # (rows, keys) the mask keeps
        keys = np.flatnonzero(seen.any(0))
        assert 0 <= k0 <= keys.min() and keys.max() < k0 + nk * KT
        if dense:
            assert (k0, nk) == (0, -(-S // KT)) and nm_lo > nm_hi
        elif nk == 1 and rows < QT:       # packed short segments: exactly their keys
            assert (keys.min(), keys.max()) == (t0, t0 + rows - 1)
        for j in range(nm_lo, nm_hi + 1):
            block = seen[:, k0 + j * KT:k0 + (j + 1) * KT]
            assert block.shape[1] == KT and block.all(), (t0, j)


@settings(max_examples=60, deadline=None)
@given(runs=st.lists(st.integers(1, 300), min_size=1, max_size=24),
       H=st.integers(1, 4))
def test_seg_tile_plan_covers_every_key_and_item(runs, H):
    seg = np.repeat(np.arange(len(runs)), runs).astype(np.int32)
    _check_seg_plan(seg, H, dense=False)


@pytest.mark.parametrize("case", ["vit_windows", "vit_full", "single_tokens", "one_segment",
                                  "arbitrary_dense"])
def test_seg_tile_plan_cases(case):
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import VisionConfig
    from socioreasoner_tpu_torch.models.qwen2_5_vl.rope import vision_window_index
    _, wseg, fseg = vision_window_index(np.array([[1, 54, 54], [1, 20, 36]]), VisionConfig())
    seg, dense = {"vit_windows": (wseg, False), "vit_full": (fseg, False),
                  "single_tokens": (np.arange(300, dtype=np.int32), False),
                  "one_segment": (np.zeros(1000, np.int32), False),
                  "arbitrary_dense": (np.random.default_rng(0).integers(0, 4, 500)
                                      .astype(np.int32), True)}[case]
    _check_seg_plan(np.asarray(seg), 3, dense)
    if case == "one_segment":       # all but the ragged last k tile unmasked
        tiles = t_fa.seg_tile_plan(seg, 1, False)[1]
        assert (tiles[:, 4:6] == (0, 1000 // KT - 1)).all()
    if case == "vit_windows":       # whole windows: one k tile per q tile
        assert (t_fa.seg_tile_plan(seg, 1, False)[1][:, 3] == 1).all()


@pytest.mark.parametrize("Lq", [1, 63, 129, 200, 2048])
@pytest.mark.parametrize("rep", [1, 2, 5, 7, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_prefill_tile_bounds(Lq, rep, causal):
    toks = QT // rep
    n_ttiles = -(-Lq // toks)
    for Lk in sorted({Lq, Lq + 37}):
        for kv_len in sorted({0, 1, Lk // 2, Lk}):
            for tt in range(n_ttiles):
                n_tiles, n_free = t_fa.prefill_tile_bounds(tt, kv_len, Lq, Lk, rep, causal)
                t = np.arange(tt * toks, min((tt + 1) * toks, Lq))[:, None]
                key = np.arange(Lk)[None, :]
                seen = (key < kv_len) & ((key <= t) if causal else True)
                keys = np.flatnonzero(seen.any(0))
                # the visited tiles are exactly those that hold a visible key
                assert n_tiles == (0 if keys.size == 0 else keys.max() // KT + 1)
                assert 0 <= n_free <= n_tiles
                for j in range(n_free):
                    assert seen[:, j * KT:(j + 1) * KT].all()


@pytest.mark.parametrize("rep", [1, 2, 5, 7, 8])
@pytest.mark.parametrize("B,Lq,Hkv", [(1, 1, 1), (3, 200, 2), (2, 129, 3)])
def test_gqa_work_items_cover_every_row_once(rep, B, Lq, Hkv):
    """The work items of kernels 2, 4 and 5 (gqa_work_item, the host copy
    of the kernels' formula): each (batch row, q head, token) in exactly one
    active row of one item, rows rep * (128 // rep) .. 127 idle, the token
    tiles from the last to the first."""
    toks = QT // rep
    n_items = -(-Lq // toks) * B * Hkv
    covered = np.zeros((B, Hkv * rep, Lq), np.int64)
    firsts = []
    for item in range(n_items):
        b, g, t0 = t_fa.gqa_work_item(item, B, Lq, Hkv, rep)
        assert 0 <= b < B and 0 <= g < Hkv and t0 % toks == 0 and 0 <= t0 < Lq
        for r in range(toks * rep):
            if t0 + r // rep < Lq:
                covered[b, g * rep + r % rep, t0 + r // rep] += 1
        firsts.append(t0)
    assert (covered == 1).all()
    assert firsts == sorted(firsts, reverse=True)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_prefix_mask_matches_pallas(causal):
    """Ragged valid prefixes (full, empty, partial), the lengths the kernel
    reads on the device, give the Pallas kernel's result on the same mask."""
    rng = np.random.default_rng(5)
    B, L, H, Hkv, D = 3, 140, 4, 2, 32
    q = rng.normal(size=(B, L, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, Hkv, D)).astype(np.float32)
    lens = np.array([L, 0, 77], np.int32)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    want = j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(mask), causal=causal, block_q=128, block_k=128,
                                interpret=True)
    got = t_fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                               torch.as_tensor(mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_seg_plan_holds_the_checked_tile_plan():
    """seg_plan holds seg_tile_plan's arrays (packed when a span is given,
    dense otherwise), raises on an underestimated span, and the wrapper
    refuses a plan built for other arguments."""
    seg = np.repeat(np.arange(5), 60).astype(np.int32)
    span = t_fa.seg_max_span_blocks(seg, 64, 64)
    for max_span in (span, None):
        plan = t_fa.seg_plan(torch.as_tensor(seg), 2, "cpu", block_q=64, block_k=64,
                             max_span_blocks=max_span)
        work, tiles = t_fa.seg_tile_plan(seg, 2, max_span is None)
        for got, want in zip(plan[:3], (seg, work, tiles)):
            np.testing.assert_array_equal(got.numpy(), want)
        assert plan.heads == 2 and plan.spans == (64, 64, max_span)
    with pytest.raises(ValueError, match="underestimates"):
        t_fa.seg_plan(seg, 2, "cpu", block_q=64, block_k=64, max_span_blocks=span - 1)
    x = torch.zeros(len(seg), 2, 16)
    with pytest.raises(ValueError, match="a plan for"):
        t_fa.flash_attention_segmented(x, x, x, torch.as_tensor(seg), plan=plan)   # no span
    x3 = torch.zeros(len(seg), 3, 16)
    with pytest.raises(ValueError, match="a plan for"):
        t_fa.flash_attention_segmented(x3, x3, x3, torch.as_tensor(seg), block_q=64,
                                       block_k=64, plan=plan)              # 3 heads


def _rounded_attention(N, rows, D, seed, lost_tile=None, doubled_tile=None):
    """One head of attention as the Hopper kernels round it (bf16 inputs, P
    rounded to bf16 for P V, f32 row sum, bf16 output), optionally with one
    128-key tile dropped or counted twice, and its f32 reference."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(n, D, generator=g).bfloat16().float() for n in (rows, N, N))
    s = q @ k.T * D ** -0.5
    want = torch.softmax(s, -1) @ v
    if lost_tile is not None:
        s[:, lost_tile:lost_tile + KT] = -float("inf")
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    if doubled_tile is not None:
        p[:, doubled_tile:doubled_tile + KT] *= 2
    got = ((p.bfloat16().float() @ v) / p.sum(-1, keepdim=True)).bfloat16()
    return got, want


@pytest.mark.parametrize("N,D", [(2916, 80), (36, 80), (2016, 128)])
def test_row_tolerance_passes_rounding_and_fails_a_lost_tile(N, D):
    """chip_smoke holds kernels 1 and 2 row by row to ROW_TOL of each row's
    largest value: the kernels' own rounding stays well inside it, and a k
    tile dropped or counted twice lies far outside, also over a full ViT
    layer's 2916 keys, where the outputs are about KERNEL_TOL in size."""
    import chip_smoke
    got, want = _rounded_attention(N, 128, D, seed=N)
    assert chip_smoke._check_rows("rounding", got, want)[1] < chip_smoke.ROW_TOL / 2
    if N > KT:
        for fault in ({"lost_tile": N - 2 * KT}, {"doubled_tile": KT}):
            got, want = _rounded_attention(N, 128, D, seed=N, **fault)
            with pytest.raises(AssertionError, match="a row's error"):
                chip_smoke._check_rows("fault", got, want)


def _rounded_dkv(rows, D, seed, fault=None):
    """dk and dv of one 128-key tile over `rows` query rows (q heads x
    tokens, 2304 tokens a head) as kernel 6 rounds them (bf16 inputs, p and
    ds rounded to bf16 before their products, f32 sums, bf16 outputs),
    optionally with the first 64-row q tile or the first q head's rows
    dropped or counted twice, and the f32 references."""
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(rows, D, generator=g).bfloat16().float() for _ in range(2))
    k, v = (torch.randn(KT, D, generator=g).bfloat16().float() for _ in range(2))
    scale = D ** -0.5
    s = q @ k.T * scale
    # each row's other 2176 keys weigh as much again as these 128, 17 times
    lse = torch.logsumexp(s, -1, keepdim=True) + np.log(18.0)
    p = torch.exp(s - lse)
    dp = do @ v.T
    delta = 18 * (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    w = torch.ones(rows, 1)
    if fault is not None:
        kind, span = fault
        w[:{"q_tile": 64, "q_head": min(rows, 2304)}[span]] = {"lost": 0.0, "doubled": 2.0}[kind]
    got = ((w * ds.bfloat16().float()).T @ q).bfloat16(), ((w * p.bfloat16().float()).T @ do
                                                           ).bfloat16()
    return got, (ds.T @ q, p.T @ do)


@pytest.mark.parametrize("rows", [8 * 64, 8 * 2304])
def test_row_tolerance_passes_dkv_rounding_and_fails_a_lost_q_tile(rows):
    """chip_smoke holds kernel 6's dk and dv row by row (each key row) to
    ROW_TOL: its rounding of p and ds to bf16 and f32 sums over up to 2304
    tokens x 8 q heads stay well inside, and a q tile or a q head dropped or
    counted twice lies outside."""
    import chip_smoke
    got, want = _rounded_dkv(rows, 128, seed=rows)
    scale = max(w.abs().max().item() for w in want)
    for name, g, w in zip(("dk", "dv"), got, want):
        assert chip_smoke._check_grad(name, g, w, scale)[2] < chip_smoke.ROW_TOL / 2
    for fault in [(kind, span) for kind in ("lost", "doubled") for span in ("q_tile", "q_head")]:
        got, want = _rounded_dkv(rows, 128, seed=rows, fault=fault)
        for name, g, w in zip(("dk", "dv"), got, want):
            with pytest.raises(AssertionError):
                chip_smoke._check_grad(name, g, w, scale)
            # the row check fails on its own, before the gradient-wide one
            with pytest.raises(AssertionError, match="a row's error"):
                chip_smoke._check_rows(name, g / scale, w / scale, chip_smoke.GRAD_ROW_FLOOR)


def _rounded_dq(rows, N, D, seed, fault=None):
    """dq of `rows` query rows over N keys as kernel 5 rounds it (bf16
    inputs, ds rounded to bf16 before ds k, f32 sums, bf16 output),
    optionally with one 128-key tile or one 64-key half of a tile (the
    kernel's step) dropped or counted twice, and the f32 reference."""
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(rows, D, generator=g).bfloat16().float() for _ in range(2))
    k, v = (torch.randn(N, D, generator=g).bfloat16().float() for _ in range(2))
    scale = D ** -0.5
    s = q @ k.T * scale
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    dp = do @ v.T
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    w = torch.ones(1, N)
    if fault is not None:
        kind, span = fault
        w[:, KT:KT + {"tile": KT, "half": KT // 2}[span]] = {"lost": 0.0, "doubled": 2.0}[kind]
    return ((w * ds.bfloat16().float()) @ k).bfloat16(), ds @ k


@pytest.mark.parametrize("N", [200, 2304])
def test_row_tolerance_passes_dq_rounding_and_fails_a_lost_key_tile(N):
    """chip_smoke holds kernel 5's dq row by row (each query row of a head)
    to ROW_TOL: its rounding of ds to bf16 and f32 sums over up to 2304 keys
    stay well inside, and a 128-key tile or a 64-key half dropped or counted
    twice lies outside."""
    import chip_smoke
    got, want = _rounded_dq(128, N, 128, seed=N)
    scale = want.abs().max().item()
    assert chip_smoke._check_grad("dq", got, want, scale)[2] < chip_smoke.ROW_TOL / 2
    for fault in [(kind, span) for kind in ("lost", "doubled") for span in ("tile", "half")]:
        got, want = _rounded_dq(128, N, 128, seed=N, fault=fault)
        with pytest.raises(AssertionError, match="a row's error"):
            chip_smoke._check_rows("dq", got / scale, want / scale, chip_smoke.GRAD_ROW_FLOOR)
