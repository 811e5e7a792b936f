"""The host plan of decode attention (kernels 3 and 3q), and a CPU mirror of
the kernels' split and merge, on the CPU.

The kernel splits each (slot, kv head)'s cache blocks over the n_split CTAs
of one thread-block cluster (split_count, from the shape alone); each CTA
takes the consecutive blocks block_range gives it from the slot's length,
its two groups of four warps take alternate blocks and 16 keys of each,
every warp runs its own online softmax (log2 domain), and the states are
merged in warp order inside a CTA and in rank order across the cluster.
The mirror below repeats that arithmetic in float32 numpy and is held to
the port's plain versions in float32 (1e-5 max-abs: the same sums in
another order, over at most 512 keys of unit-variance logits) and to the
JAX package's paged_decode_attention in interpret mode on bf16 inputs (2e-2
max-abs: the bf16 output's rounding at |out| up to ~4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from socioreasoner_tpu.ops import decode_attention as j_dec
from socioreasoner_tpu_torch.ops import decode_attention as t_dec

BLOCK = t_dec.KERNEL_BLOCK
GROUPS, WARP_KEYS = 2, 16        # csrc/paged_decode.cu: kGroups, 16 keys a consumer warp
NEG = np.float32(-1e30)
MIRROR_TOL = 1e-5                # f32 mirror against the f32 plain version
BF16_TOL = 2e-2                  # against the JAX package's bf16 output
H100_SMS = 132


# ------------------------------------------------------------------ the plan

@pytest.mark.parametrize("Hkv", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [1, 2, 4, 5, 8, 32, 64, 128])
def test_split_count_and_block_ownership(S, Hkv):
    """n_split is the largest power of two up to the cluster limit (and the
    cache's blocks) that keeps S * Hkv * n_split CTAs on the SMs; every
    block a length needs is read by exactly one rank, for every length from
    0 to past the cache."""
    for Lalloc in (64, 512, 2816):
        n = t_dec.split_count(S, Hkv, Lalloc, H100_SMS)
        assert n >= 1 and n & (n - 1) == 0 and n <= t_dec.CLUSTER_LIMIT
        assert n * BLOCK <= Lalloc
        if S * Hkv <= H100_SMS:
            assert S * Hkv * n <= H100_SMS
        if S * Hkv > H100_SMS // 2:
            assert n == 1
        # the largest: doubling breaks a limit
        assert (2 * n > t_dec.CLUSTER_LIMIT or 2 * n * BLOCK > Lalloc
                or S * Hkv * 2 * n > H100_SMS)
        for length in range(-1, Lalloc + 2 * BLOCK + 2, 7 if Lalloc > 512 else 1):
            nblocks = min(max(-(-length // BLOCK), 1), Lalloc // BLOCK)
            owner = np.zeros(Lalloc // BLOCK, np.int64)
            for rank in range(n):
                lo, hi = t_dec.block_range(length, Lalloc, n, rank)
                assert 0 <= lo <= hi <= nblocks
                owner[lo:hi] += 1
            assert (owner[:nblocks] == 1).all() and not owner[nblocks:].any()


def test_main_path_plans():
    """The split at the check shape (S=4, 2 kv heads): 8 CTAs a (slot, kv
    head), 64 on the card; at the production 32 slots: 2; and the longest
    slot's 44 blocks in runs of 6."""
    assert t_dec.split_count(4, 2, 2816, H100_SMS) == 8
    assert t_dec.split_count(32, 2, 2816, H100_SMS) == 2
    assert t_dec.split_count(40, 2, 2816, H100_SMS) == 1
    assert [t_dec.block_range(2813, 2816, 8, r) for r in range(8)] == \
        [(0, 6), (6, 12), (12, 18), (18, 24), (24, 30), (30, 36), (36, 42), (42, 44)]


# ---------------------------------------------------------------- the mirror

def _merge(states):
    """(m, l, acc) states merged in list order, log2 domain."""
    M = np.max([m for m, _, _ in states], axis=0)
    L = np.zeros_like(M)
    A = np.zeros_like(states[0][2])
    for m, l, acc in states:
        w = np.exp2(m - M)
        L = L + w * l
        A = A + w[:, None] * acc
    return M, L, A


def mirror(q, k, v, lengths, ks=None, vs=None, n_split=None):
    """Kernels 3/3q's arithmetic in float32: q (S, H, D), k/v (S, Lalloc,
    Hkv, D) (int8 codes as floats), scales (S, Hkv, Lalloc)."""
    S, H, D = q.shape
    Lalloc, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    n_split = n_split or t_dec.split_count(S, Hkv, Lalloc, H100_SMS)
    c = np.float32(D ** -0.5 * np.log2(np.e))
    out = np.zeros((S, H, D), np.float32)
    for s in range(S):
        n = int(lengths[s])
        for g in range(Hkv):
            qg = q[s, g * rep:(g + 1) * rep]
            ranks = []
            for rank in range(n_split):
                lo, hi = t_dec.block_range(n, Lalloc, n_split, rank)
                warps = []
                for w in range(4 * GROUPS):
                    m = np.full(rep, NEG, np.float32)
                    l = np.zeros(rep, np.float32)
                    acc = np.zeros((rep, D), np.float32)
                    for j in range(lo + w // 4, hi, GROUPS):
                        keys = j * BLOCK + WARP_KEYS * (w % 4) + np.arange(WARP_KEYS)
                        if keys[0] >= n:
                            continue
                        f = c * (ks[s, g, keys] if ks is not None else np.float32(1))
                        x = np.where(keys < n, (qg @ k[s, keys, g].T) * f, NEG)
                        m_new = np.maximum(m, x.max(1))
                        corr = np.exp2(m - m_new)
                        m = m_new
                        p = np.where(x > NEG / 2, np.exp2(x - m[:, None]), np.float32(0))
                        l = l * corr + p.sum(1)
                        pv = p * vs[s, g, keys] if vs is not None else p
                        acc = acc * corr[:, None] + pv @ v[s, keys, g]
                    warps.append((m, l, acc))
                ranks.append(_merge(warps))
            _, L, A = _merge(ranks)
            out[s, g * rep:(g + 1) * rep] = np.where(
                L[:, None] == 0, np.float32(0), A / np.where(L == 0, 1, L)[:, None])
    return out


LALLOC = 512
# the block edges, the cache's end and one past it (the clamp), and zero
LENGTHS = [0, 1, 63, 64, 65, LALLOC - 1, LALLOC, LALLOC + 1]


def _bf16(rng, *shape):
    return np.asarray(torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
                      .to(torch.bfloat16).float())


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("rep", [1, 5, 7, 8, 16])
def test_mirror_matches_plain_and_pallas(rep, quant, stacked):
    rng = np.random.default_rng(rep + 10 * quant + 100 * stacked)
    S, Hkv, D = len(LENGTHS), 2, 128
    layers, layer = (3, 1) if stacked else (1, 0)
    q = _bf16(rng, S, rep * Hkv, D)
    lens = np.asarray(LENGTHS, np.int32)
    if quant:
        x = rng.normal(size=(2, layers * S, LALLOC, Hkv, D)).astype(np.float32)
        kc, ks, vc, vs = [], [], [], []
        for codes, scales, xi in ((kc, ks, x[0]), (vc, vs, x[1])):
            code, scale = j_dec.quantize_kv(jnp.asarray(xi))
            codes.append(np.asarray(code).reshape(layers, S, LALLOC, Hkv, D))
            scales.append(np.swapaxes(np.asarray(scale), -1, -2)
                          .reshape(layers, S, Hkv, LALLOC))
        k, v, ks, vs = kc[0], vc[0], ks[0], vs[0]
        scale_args = (ks, vs)
    else:
        k, v = _bf16(rng, layers, S, LALLOC, Hkv, D), _bf16(rng, layers, S, LALLOC, Hkv, D)
        scale_args = ()
    got = mirror(q, k[layer].astype(np.float32), v[layer].astype(np.float32), lens,
                 *(a[layer] for a in scale_args))
    assert not got[0].any()                              # zero length gives exactly 0
    # against the port's plain version in float32 (the CPU path of the wrapper)
    kw = {"layer": layer} if stacked else {}
    t_args = [torch.as_tensor(a if stacked else a[0]) for a in (k, v, *scale_args)]
    plain = t_dec.paged_decode_attention(torch.as_tensor(q), t_args[0], t_args[1],
                                         torch.as_tensor(lens), *t_args[2:], **kw)
    np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=MIRROR_TOL)
    # against the Pallas kernel (interpret mode) on the same bf16 values
    def jax_arr(a):
        a = a if stacked else a[0]
        bf16 = a.dtype == np.float32 and a.shape[-1] == D      # the bf16 caches
        return jnp.asarray(a, dtype=jnp.bfloat16 if bf16 else None)

    want = j_dec.paged_decode_attention(
        jnp.asarray(q, dtype=jnp.bfloat16), *map(jax_arr, (k, v)), jnp.asarray(lens),
        *map(jax_arr, scale_args), block_k=256, interpret=True,
        **({"layer": jnp.int32(layer)} if stacked else {}))
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
def test_mirror_split_counts_agree(n_split):
    """Every split count gives the same attention (up to f32 rounding):
    the merge is exact arithmetic on the ranks' states."""
    rng = np.random.default_rng(3)
    S, Hkv, D, rep = len(LENGTHS), 2, 64, 8
    q = rng.normal(size=(S, rep * Hkv, D)).astype(np.float32)
    k = rng.normal(size=(S, LALLOC, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(S, LALLOC, Hkv, D)).astype(np.float32)
    lens = np.asarray(LENGTHS, np.int32)
    want = t_dec.paged_decode_attention_reference(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(lens))
    got = mirror(q, k, v, lens, n_split=n_split)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=MIRROR_TOL)
