"""Kernel 6's host-side plan (the trainable flash attention's dk/dv kernel),
on the CPU.

dkv_tile_plan cuts the (key tile, q head, q tile) pairs that the causal and
kv_len masks leave non-empty into consecutive shares, one a persistent CTA;
a key tile that a cut crosses is split into pieces whose partials the
kernel adds in piece order. Held here against brute force: every non-empty
pair in exactly one piece, every key tile (the empty ones too, whose zeros
the kernel writes) in pieces 0 .. n - 1, no piece above the cap, slots and
counters consistent; and a plain evaluation by the plan equals the plain
backward to f32 rounding.
"""

import numpy as np
import pytest
import torch

from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb

KT, QT = fb.DKV_K_TILE, fb.DKV_Q_TILE
F = {name: i for i, name in enumerate(fb.DKV_FIELDS)}


def _nonempty_tiles(kv_len, Lq, Lk, causal):
    """(q tiles, key tiles) bool: whether some (row, key) of the tile pair
    passes the mask, from the dense mask."""
    nq, nk = -(-Lq // QT), -(-Lk // KT)
    t = np.arange(nq * QT)[:, None]
    key = np.arange(nk * KT)[None, :]
    seen = (t < Lq) & (key < min(kv_len, Lk)) & ((key <= t) if causal else True)
    return seen.reshape(nq, QT, nk, KT).any(axis=(1, 3))


def _check_plan(lens, Lq, Lk, Hkv, rep, causal, cap=None):
    items, cta_start, n_split, n_slots = fb.dkv_tile_plan(lens, Lq, Lk, Hkv, rep, causal,
                                                          cap=cap)
    B, nk = len(lens), -(-Lk // KT)
    assert items.dtype == np.int32 and items.shape[1] == len(fb.DKV_FIELDS)
    assert cta_start[0] == 0 and cta_start[-1] == len(items) and (np.diff(cta_start) > 0).all()
    # every non-empty (b, g, key tile, q head, q tile) pair in exactly one piece
    covered = np.zeros((B, Hkv * rep, -(-Lq // QT), nk), np.int64)
    pieces = {}
    for row in items.tolist():
        b, g, kt, i_lo, cnt, p0, n_pairs, j, n, split, ws0, kv_len = row
        assert kv_len == min(max(lens[b], 0), Lk)
        for p in range(p0, p0 + n_pairs):
            covered[b, g * rep + p // cnt, i_lo + p % cnt, kt] += 1
        pieces.setdefault((b, g, kt), []).append((j, n, split, ws0, p0, n_pairs))
    for b in range(B):
        want = _nonempty_tiles(lens[b], Lq, Lk, causal)
        np.testing.assert_array_equal(covered[b], np.broadcast_to(want, covered[b].shape))
    # every key tile in pieces 0 .. n - 1 of consecutive pairs; split tiles
    # own distinct counters and workspace slots
    assert sorted(pieces) == [(b, g, kt) for b in range(B) for g in range(Hkv)
                              for kt in range(nk)]
    counters, slots = set(), set()
    for parts in pieces.values():
        parts.sort()
        n = parts[0][1]
        assert [p[0] for p in parts] == list(range(n)) and {p[1] for p in parts} == {n}
        assert [p[4] for p in parts] == [0] + list(np.cumsum([p[5] for p in parts[:-1]]))
        if n == 1:
            assert parts[0][2:4] == (-1, -1)
        else:
            split, ws0 = parts[0][2], parts[0][3]
            assert all(p[2:4] == (split, ws0) for p in parts)
            counters.add(split)
            slots.update(range(ws0, ws0 + n))
    assert counters == set(range(n_split)) and slots == set(range(n_slots))
    # no piece above the cap; the even share holds every CTA to the cap
    total = int(items[:, F["np"]].sum())
    cap = cap or max(-(-total // fb.N_SM), fb.DKV_MIN_CAP)
    assert items[:, F["np"]].max(initial=0) <= cap
    per_cta = [int(items[a:b, F["np"]].sum()) for a, b in zip(cta_start[:-1], cta_start[1:])]
    assert max(per_cta) <= cap
    return items, cta_start, n_split


@pytest.mark.parametrize("shape", ["train", "check"])
@pytest.mark.parametrize("rep", [1, 2, 5, 7, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_len", ["0", "1", "Lq", "odd"])
def test_dkv_tile_plan_covers_every_pair_once(shape, rep, causal, kv_len):
    """The train shape (B = 4, L = 2304) and the CUDA test's check shape
    (B = 3, L = 200), with batch row 0 at the given kv_len and the others
    at a mix of full, odd and empty lengths."""
    B, L = {"train": (4, 2304), "check": (3, 200)}[shape]
    first = {"0": 0, "1": 1, "Lq": L, "odd": L // 2 + 1 - (L // 2) % 2}[kv_len]
    lens = [first, L, 77, 0][:B]
    _check_plan(lens, L, L, 2, rep, causal)


def test_dkv_tile_plan_balances_the_check_shape():
    """chip_smoke's check shape: 15,200 pairs in shares of ceil(15,200 / 132)
    = 116, so the heaviest piece and the busiest CTA stay within one pair of
    the even share; tiles are split there, and the 56 key tiles at or past
    kv_len are pieces without pairs."""
    items, cta_start, n_split = _check_plan([2304, 2080, 1000, 1], 2304, 2304, 2, 8, True)
    assert int(items[:, F["np"]].sum()) == 15200
    assert len(cta_start) - 1 == fb.N_SM and n_split > 0
    assert items[:, F["np"]].max() == 116
    assert int((items[:, F["np"]] == 0).sum()) == 56


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 65, 8), (3, 129, 2), (1, 2304, 8),
                                   (2, 200, 5), (1, 129, 7)])
@pytest.mark.parametrize("cap", [None, 1, 7])
def test_dkv_tile_plan_edges(shape, cap):
    """chip_smoke's edge shapes (Lq 1, 65, 129, 200, 2304; rep 1, 2, 5, 7,
    8) with the plan's own cap and with forced splits."""
    B, L, rep = shape
    _check_plan([L, 1, 0][:B], L, L, 2, rep, True, cap)
    _check_plan([L, 1, 0][:B], L, L, 2, rep, False, cap)


@pytest.mark.parametrize("rep,causal,cap", [(2, True, None), (2, True, 1), (2, False, 3),
                                            (1, True, 2), (8, False, 5)])
def test_dkv_by_plan_matches_the_plain_backward(rep, causal, cap):
    """Per-piece partials summed in piece order, by the formula of
    flash_attention_bwd_reference, equal its dk and dv to f32 rounding, with
    the plan's own shares and with many split tiles (cap 1-5), on ragged
    lengths (full, partial, empty) and a length that is no multiple of the
    tiles."""
    rng = np.random.default_rng(11)
    B, L, Hkv, D = 3, 200, 2, 32
    H = Hkv * rep
    q, k, v, do = (torch.as_tensor(rng.normal(size=(B, L, h, D)).astype(np.float32))
                   for h in (H, Hkv, Hkv, H))
    lens = torch.tensor([L, 77, 0])
    out, lse = fb.flash_attention_fwd_lse_reference(q, k, v, lens, causal)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    items, _, n_split, _ = fb.dkv_tile_plan(lens.numpy(), L, L, Hkv, rep, causal, cap=cap)
    assert n_split > 0 or cap is None
    got = fb.flash_attention_bwd_dkv_by_plan(q, k, v, do, lse, delta, items, causal)
    want = fb.flash_attention_bwd_reference(q, k, v, do, lse, delta, lens, causal)[1:]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)
    assert torch.count_nonzero(got[0][2]) == 0 and torch.count_nonzero(got[1][2]) == 0


def test_dkv_plan_is_checked_against_the_call():
    """dkv_plan holds dkv_tile_plan's rows with its workspace and zeroed
    counters; the wrapper refuses a plan built for another shape, and the
    trainable Function takes one."""
    lens = torch.tensor([8, 3])
    plan = fb.dkv_plan(lens, 2, 8, 8, 4, 2, True, "cpu", cap=1)
    items, cta_start, n_split, n_slots = fb.dkv_tile_plan([8, 3], 8, 8, 2, 2, True, cap=1)
    np.testing.assert_array_equal(plan.items.numpy(), items)
    np.testing.assert_array_equal(plan.cta_start.numpy(), cta_start)
    assert plan.workspace.shape == (n_slots, fb.DKV_SLOT_FLOATS)
    assert plan.counters.shape == (2 * n_split,) and not plan.counters.any()
    assert plan.key == (2, 8, 8, 4, 2, True) and plan.n_cta == len(cta_start) - 1
    q, kv, stats = torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 2, 16), torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="a plan for"):
        fb.flash_attention_bwd_dkv(q, kv, kv, q, stats, stats, lens, causal=False, plan=plan)
    fb.flash_attention_bwd_dkv(q, kv, kv, q, stats, stats, lens, plan=plan)
    leaves = [t.clone().requires_grad_(True) for t in (q, kv, kv)]
    fb.flash_attention_trainable(*leaves, lens, True, plan).sum().backward()
    assert all(leaf.grad is not None for leaf in leaves)


def test_dkv_plan_refuses_other_kv_lengths():
    """A plan built for kv lengths [8, 3] refuses a call over [8, 5] (on the
    GPU the kernel traps on the same difference), and takes lengths that
    clip to the same values."""
    plan = fb.dkv_plan(torch.tensor([8, 3]), 2, 8, 8, 4, 2, True, "cpu")
    assert plan.lens == (8, 3)
    q, kv, stats = torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 2, 16), torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="a plan for kv lengths"):
        fb.flash_attention_bwd_dkv(q, kv, kv, q, stats, stats, torch.tensor([8, 5]), plan=plan)
    leaves = [t.clone().requires_grad_(True) for t in (q, kv, kv)]
    out = fb.flash_attention_trainable(*leaves, torch.tensor([8, 5]), True, plan)
    with pytest.raises(ValueError, match="a plan for kv lengths"):
        out.sum().backward()
    fb.flash_attention_bwd_dkv(q, kv, kv, q, stats, stats, torch.tensor([12, 3]), plan=plan)
    full = fb.dkv_plan(None, 2, 8, 8, 4, 2, True, "cpu")
    assert full.lens == (8, 8)
    fb.flash_attention_bwd_dkv(q, kv, kv, q, stats, stats, None, plan=full)
