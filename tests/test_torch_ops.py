"""Port ops (socioreasoner_tpu_torch.ops) against the JAX package's ops.

The same numpy inputs go through the JAX function — the Pallas kernels in
interpret mode, as the JAX package's own kernel tests run them — and through
the port's wrapper, which takes its plain PyTorch version for CPU tensors.
Everything runs in float32; the bound is max-abs 1e-5 (float32 rounding of
softmax sums over at most a few hundred keys).

Tests marked `cuda` hold the port's CUDA kernels against their plain versions
on an NVIDIA GPU and skip without one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.ops import attention as j_attn
from socioreasoner_tpu.ops import decode_attention as j_dec
from socioreasoner_tpu.ops import flash_attention as j_fa
from socioreasoner_tpu.ops import flash_attention_bwd as j_fab
from socioreasoner_tpu.ops import norms as j_norms
from socioreasoner_tpu_torch.ops import attention as t_attn
from socioreasoner_tpu_torch.ops import decode_attention as t_dec
from socioreasoner_tpu_torch.ops import flash_attention as t_fa
from socioreasoner_tpu_torch.ops import flash_attention_bwd as t_fab
from socioreasoner_tpu_torch.ops import norms as t_norms

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


def _randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ dense + norms

@pytest.mark.parametrize("case", ["causal_mask_gqa", "segments", "positions"])
def test_dense_attention_matches_jax(case):
    rng = np.random.default_rng(0)
    B, Lq, Lk, H, Hkv, D = 2, 24, 24, 4, 2, 16
    q, k, v = _randn(rng, B, Lq, H, D), _randn(rng, B, Lk, Hkv, D), _randn(rng, B, Lk, Hkv, D)
    kw_np = {}
    if case == "causal_mask_gqa":
        mask = np.ones((B, Lk), np.int32)
        mask[1, 15:] = 0
        kw_np = dict(causal=True, attention_mask=mask)
    elif case == "segments":
        seg = np.repeat(np.arange(3), 8)[None].repeat(B, 0).astype(np.int32)
        kw_np = dict(segment_ids_q=seg, segment_ids_kv=seg)
    else:
        qpos = np.arange(Lq)[None].repeat(B, 0) + 3
        kpos = np.arange(Lk)[None].repeat(B, 0) * 2
        kw_np = dict(causal=True, q_positions=qpos, kv_positions=kpos)
    want = j_attn.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  **{n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                     for n, a in kw_np.items()})
    got = t_attn.dense_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                 **{n: torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                    for n, a in kw_np.items()})
    _close(got, want)


def test_repeat_kv_matches_jax():
    x = _randn(np.random.default_rng(1), 2, 5, 2, 8)
    _close(t_attn.repeat_kv(torch.as_tensor(x), 4), j_attn.repeat_kv(jnp.asarray(x), 4), 0)


@pytest.mark.parametrize("fn", ["rms_norm", "layer_norm", "swiglu", "quick_gelu"])
def test_norms_match_jax(fn):
    rng = np.random.default_rng(2)
    x = _randn(rng, 3, 7, 32)
    w, b = _randn(rng, 32), _randn(rng, 32)
    if fn == "rms_norm":
        args = (x, w)
    elif fn == "layer_norm":
        args = (x, w, b)
    elif fn == "swiglu":
        args = (x, _randn(rng, 32, 48) * 0.1, _randn(rng, 32, 48) * 0.1,
                _randn(rng, 48, 32) * 0.1, _randn(rng, 48), _randn(rng, 48), _randn(rng, 32))
    else:
        args = (x,)
    want = getattr(j_norms, fn)(*map(jnp.asarray, args))
    got = getattr(t_norms, fn)(*map(torch.as_tensor, args))
    _close(got, want)


# -------------------------------------------------------- prefill flash

@pytest.mark.parametrize("Lq,H,Hkv,D,causal,ragged", [
    (256, 4, 2, 64, True, True),      # GQA, aligned, ragged batch
    (200, 2, 2, 64, True, True),      # unaligned → padding path
    (128, 2, 2, 64, False, False),    # non-causal, no mask
])
def test_flash_attention_matches_pallas(Lq, H, Hkv, D, causal, ragged):
    rng = np.random.default_rng(0)
    B = 2
    q, k, v = _randn(rng, B, Lq, H, D), _randn(rng, B, Lq, Hkv, D), _randn(rng, B, Lq, Hkv, D)
    mask = None
    if ragged:
        mask = np.ones((B, Lq), np.int32)
        mask[1, Lq // 2:] = 0
    want = j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                None if mask is None else jnp.asarray(mask),
                                causal=causal, block_q=128, block_k=128, interpret=True)
    before = t_fa.flash_attention.launches
    got = t_fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                               None if mask is None else torch.as_tensor(mask),
                               causal=causal)
    _close(got, want)
    assert t_fa.flash_attention.launches == before     # CPU: plain version, no launch


def test_flash_attention_reference_zero_length_rows():
    """A batch row with kv length 0 gives 0, as the Pallas kernel does."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(_randn(rng, 2, 8, 2, 16)) for _ in range(3))
    mask = torch.ones(2, 8, dtype=torch.int32)
    mask[1] = 0
    out = t_fa.flash_attention_reference(q, k, v, mask, causal=True)
    assert torch.count_nonzero(out[1]) == 0
    assert torch.count_nonzero(out[0]) > 0


# ------------------------------------------------------ trainable flash

@pytest.mark.parametrize("L,Hkv,causal,lens", [
    (128, 2, True, [128, 64]),        # GQA
    (128, 4, False, [128, 64]),       # non-causal
    (128, 4, True, [128, 64]),
    (100, 2, True, [100, 0]),         # L not a multiple of the block; an empty row
])
def test_flash_trainable_matches_pallas_vjp(L, Hkv, causal, lens):
    """The plain forward (out, lse) and backward (by the kernels' formula),
    and the autograd of flash_attention_trainable on CPU tensors, against the
    JAX custom VJP with its Pallas kernels in interpret mode (blocks 64)."""
    _trainable_vs_pallas_vjp(L, 4, Hkv, causal, lens)


@pytest.mark.parametrize("L,H,Hkv,causal,lens", [
    (100, 10, 2, True, [100, 37]),    # rep 5: 25 tokens a kernel item, 3 idle rows
    (72, 14, 2, False, [72, 0]),      # rep 7: 18 tokens a kernel item, 2 idle rows
])
def test_flash_trainable_matches_pallas_vjp_any_rep(L, H, Hkv, causal, lens):
    """test_flash_trainable_matches_pallas_vjp at GQA ratios that do not
    divide the kernels' 128-row item (Qwen2.5-VL-32B's 5, -7B's 7), which the
    Pallas kernels take."""
    _trainable_vs_pallas_vjp(L, H, Hkv, causal, lens)


def _trainable_vs_pallas_vjp(L, H, Hkv, causal, lens):
    rng = np.random.default_rng(8)
    B, D = 2, 64
    q, k, v = _randn(rng, B, L, H, D), _randn(rng, B, L, Hkv, D), _randn(rng, B, L, Hkv, D)
    g = _randn(rng, B, L, H, D)
    jlens = jnp.asarray(np.array(lens, np.float32))
    f = lambda q_, k_, v_: j_fab.flash_attention_trainable(   # noqa: E731
        q_, k_, v_, jlens, causal, 64, 64, True)
    want, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(g))
    _, res = j_fab._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jlens, causal,
                        64, 64, True)
    want_lse = np.asarray(res[5])[:, :L, 0].reshape(B, H, L)

    tq, tk, tv, tg = (torch.as_tensor(x) for x in (q, k, v, g))
    tlens = torch.tensor(lens)
    out, lse = t_fab.flash_attention_fwd_lse_reference(tq, tk, tv, tlens, causal)
    _close(out, want)
    _close(lse, want_lse)
    if 0 in lens:                    # an empty row: out 0, lse NEG_INF
        assert torch.count_nonzero(out[lens.index(0)]) == 0
        assert (lse[lens.index(0)] == t_fab.NEG_INF).all()
    delta = (tg * out).sum(-1).transpose(1, 2).contiguous()
    for got, w in zip(t_fab.flash_attention_bwd_reference(tq, tk, tv, tg, lse, delta,
                                                          tlens, causal), want_grads):
        _close(got, w)

    counts = [fn.launches for fn in (t_fab.flash_attention_fwd_lse, t_fab.flash_attention_bwd_dq,
                                     t_fab.flash_attention_bwd_dkv)]
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    t_fab.flash_attention_trainable(*leaves, tlens, causal).backward(tg)
    for leaf, w in zip(leaves, want_grads):
        _close(leaf.grad, w)
    assert counts == [fn.launches for fn in (t_fab.flash_attention_fwd_lse,      # CPU: no
                                             t_fab.flash_attention_bwd_dq,        # launch
                                             t_fab.flash_attention_bwd_dkv)]


@pytest.mark.parametrize("bad", ["kv_heads", "lens", "do", "lse"])
def test_trainable_wrapper_shape_checks(bad):
    q, kv = torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 2, 16)
    lens, stats = torch.tensor([8, 3]), torch.zeros(2, 4, 8)
    calls = {
        "kv_heads": lambda: t_fab.flash_attention_fwd_lse(q, torch.zeros(2, 8, 3, 16),
                                                          torch.zeros(2, 8, 3, 16)),
        "lens": lambda: t_fab.flash_attention_fwd_lse(q, kv, kv, lens[:1]),
        "do": lambda: t_fab.flash_attention_bwd_dq(q, kv, kv, q[:, :7], stats, stats, lens),
        "lse": lambda: t_fab.flash_attention_bwd_dkv(q, kv, kv, q, stats[:, :2], stats, lens),
    }
    with pytest.raises(ValueError, match="shapes do not fit"):
        calls[bad]()


# ------------------------------------------------------------ segmented

def _seg_case(name):
    if name == "windows":
        return np.repeat(np.arange(4), 64).astype(np.int32), None
    if name == "ragged":
        return np.concatenate([np.zeros(50), np.ones(70), np.full(80, 2)]).astype(np.int32), None
    sizes = [64, 48, 64, 200, 30, 64, 150, 64]
    seg = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)]).astype(np.int32)
    return seg, j_fa.seg_max_span_blocks(seg, block_q=64, block_k=64)


@pytest.mark.parametrize("name", ["windows", "ragged", "block_sparse"])
def test_flash_segmented_matches_pallas(name):
    rng = np.random.default_rng(4)
    seg, span = _seg_case(name)
    S, H, D = len(seg), 2, 64
    q, k, v = _randn(rng, S, H, D), _randn(rng, S, H, D), _randn(rng, S, H, D)
    want = j_fa.flash_attention_segmented(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        block_q=64, block_k=64, max_span_blocks=span, interpret=True)
    got = t_fa.flash_attention_segmented(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(seg),
        block_q=64, block_k=64, max_span_blocks=span)
    _close(got, want)


def test_seg_span_helpers_match_jax():
    """The host span helper and the per-block bound formula (the kernel
    plan's k-tile ranges) equal the JAX wrapper's, in numpy and in jnp."""
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import VisionConfig
    from socioreasoner_tpu_torch.models.qwen2_5_vl.rope import vision_window_index
    _, wseg, fseg = vision_window_index(np.array([[1, 54, 54], [1, 20, 36]]), VisionConfig())
    for seg in (wseg, fseg, _seg_case("block_sparse")[0]):
        S = len(seg)
        assert t_fa.seg_block_sizes(S) == j_fa.seg_block_sizes(S)
        for bq, bk in ((64, 64), (512, 256), (128, 64)):
            assert t_fa.seg_max_span_blocks(seg, bq, bk) == j_fa.seg_max_span_blocks(seg, bq, bk)
            nq = -(-S // bq)
            got = t_fa._seg_kv_bounds(seg, S, nq, bq, bk)
            for xp in (np, jnp):
                want = j_fa._seg_kv_bounds(xp.asarray(seg), S, nq, bq, bk, xp)
                np.testing.assert_array_equal(got[0], np.asarray(want[0]))
                np.testing.assert_array_equal(got[1], np.asarray(want[1]))


def test_flash_segmented_underestimated_span_raises():
    seg, span = _seg_case("block_sparse")
    x = torch.zeros(len(seg), 2, 64)
    with pytest.raises(ValueError, match="underestimates"):
        t_fa.flash_attention_segmented(x, x, x, torch.as_tensor(seg), block_q=64,
                                       block_k=64, max_span_blocks=span - 1)


# --------------------------------------------------------------- decode

@pytest.mark.parametrize("S,Lmax,H,lengths,block_k,slot_group", [
    (4, 512, 16, [100, 256, 1, 512], 128, 8),
    (5, 256, 8, [3, 256, 0, 97, 64], 64, 2),     # odd slots, an empty slot
])
def test_paged_decode_matches_pallas(S, Lmax, H, lengths, block_k, slot_group):
    rng = np.random.default_rng(5)
    Hkv, D = 2, 64
    q = _randn(rng, S, H, D)
    k, v = _randn(rng, S, Lmax, Hkv, D), _randn(rng, S, Lmax, Hkv, D)
    lens = np.asarray(lengths, np.int32)
    want = j_dec.paged_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(lens), block_k=block_k,
                                        slot_group=slot_group, interpret=True)
    got = t_dec.paged_decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                       torch.as_tensor(v), torch.as_tensor(lens))
    _close(got, want)


def test_paged_decode_stacked_layer_matches_pallas():
    rng = np.random.default_rng(6)
    Lyr, S, Lmax, H, Hkv, D = 3, 2, 256, 8, 2, 64
    q = _randn(rng, S, H, D)
    k, v = _randn(rng, Lyr, S, Lmax, Hkv, D), _randn(rng, Lyr, S, Lmax, Hkv, D)
    lens = np.asarray([70, 256], np.int32)
    for layer in range(Lyr):
        want = j_dec.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
            layer=jnp.int32(layer), block_k=128, interpret=True)
        got = t_dec.paged_decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                           torch.as_tensor(v), torch.as_tensor(lens),
                                           layer=layer)
        _close(got, want)


@pytest.mark.parametrize("bad", ["dtype", "stride"])
def test_kernel_input_checks(bad):
    x = torch.zeros(4, 16, 2, 64, dtype=torch.bfloat16)
    if bad == "dtype":
        x = x.float()
    else:
        x = x[..., ::2]
    with pytest.raises(ValueError):
        t_fa.check_kernel_inputs("k", x)


@pytest.mark.parametrize("bad", ["prefill_mask", "prefill_kv", "seg_ids",
                                 "decode_lengths", "decode_slots"])
def test_wrapper_shape_checks(bad):
    """Shapes that do not fit raise before any kernel or plain version runs."""
    q4, kv4 = torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 2, 16)
    q3 = torch.zeros(8, 2, 16)
    qd, cache = torch.zeros(3, 4, 16), torch.zeros(2, 3, 64, 2, 16)
    lens = torch.tensor([1, 2, 3], dtype=torch.int32)
    calls = {
        "prefill_mask": lambda: t_fa.flash_attention(q4, kv4, kv4, torch.ones(2, 7)),
        "prefill_kv": lambda: t_fa.flash_attention(q4, kv4, kv4[:1]),
        "seg_ids": lambda: t_fa.flash_attention_segmented(q3, q3, q3, torch.zeros(7)),
        "decode_lengths": lambda: t_dec.paged_decode_attention(qd, cache, cache, lens[:2],
                                                               layer=1),
        "decode_slots": lambda: t_dec.paged_decode_attention(qd[:2], cache, cache, lens[:2],
                                                             layer=0),
    }
    with pytest.raises(ValueError, match="shapes do not fit"):
        calls[bad]()


# ------------------------------------------------- kernels on the GPU

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(gen, *shape):
    return torch.randn(*shape, generator=gen, device=gen.device).to(torch.bfloat16)


@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _bf16(gen, 2, 200, 16, 128), _bf16(gen, 2, 200, 2, 128), _bf16(gen, 2, 200, 2, 128)
    mask = torch.zeros(2, 200, dtype=torch.int32, device=cuda)
    mask[0, :190] = 1
    mask[1, :1] = 1
    n = t_fa.flash_attention.launches
    got = t_fa.flash_attention(q, k, v, mask, causal=True)
    want = t_fa.flash_attention_reference(q.float(), k.float(), v.float(), mask)
    assert t_fa.flash_attention.launches == n + 1
    assert (got.float() - want).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_cuda_flash_segmented_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    seg, span = _seg_case("block_sparse")
    S = len(seg)
    q, k, v = (_bf16(gen, S, 16, 80) for _ in range(3))
    seg_t = torch.as_tensor(seg, device=cuda)
    for s in (span, None):
        got = t_fa.flash_attention_segmented(q, k, v, seg_t, block_q=64, block_k=64,
                                             max_span_blocks=s)
        want = t_fa.flash_attention_segmented_reference(q.float(), k.float(), v.float(), seg_t)
        assert (got.float() - want).abs().max().item() <= 2e-2


def assert_decode_rows(got, want, lens, tol=2e-2):
    """Kernel 3/3q's output against the plain version in f32: each (slot,
    head) row within `tol` of its own largest |value| (and 2e-2 max-abs), a
    zero-length slot exactly 0."""
    diff = (got.float() - want).abs()
    assert diff.max().item() <= 2e-2
    ratio = diff.amax(-1) / want.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    live = lens.to(got.device) > 0
    assert ratio[live].max().item() <= tol
    assert not got[~live].any()


# (S, H, Hkv, lengths): the GQA ratios 8, 5 (Qwen2.5-VL-32B's 40 / 8 heads) and
# 7 (-7B's 28 / 4), and the production slot count 32 with mixed lengths
DECODE_CASES = [(5, 16, 2, [0, 1, 63, 300, 512]),
                (32, 16, 2, [0, 1, 64, 511] + [(37 * i) % 513 for i in range(28)]),
                (6, 40, 8, [0, 1, 64, 65, 511, 512]),
                (6, 28, 4, [512, 300, 0, 1, 129, 63])]


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,Hkv,lengths", DECODE_CASES)
def test_cuda_paged_decode_matches_plain(cuda, S, H, Hkv, lengths):
    gen = torch.Generator(device=cuda).manual_seed(2)
    kc, vc = _bf16(gen, 3, S, 512, Hkv, 128), _bf16(gen, 3, S, 512, Hkv, 128)
    q = _bf16(gen, S, H, 128)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n = t_dec.paged_decode_attention.launches
    for layer in range(3):
        got = t_dec.paged_decode_attention(q, kc, vc, lens, layer=layer)
        want = t_dec.paged_decode_attention_reference(q.float(), kc[layer].float(),
                                                      vc[layer].float(), lens)
        assert_decode_rows(got, want, lens)
        assert torch.equal(t_dec.paged_decode_attention(q, kc, vc, lens, layer=layer), got)
    assert t_dec.paged_decode_attention.launches == n + 6


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv", [(16, 2), (40, 8), (28, 4)])
def test_cuda_flash_trainable_matches_plain(cuda, H, Hkv):
    """Kernels 4-6 against the plain versions in f32 on the same bf16 values,
    with one empty row, at GQA ratios 8, 5 and 7 (the last two leave rows of
    the kernels' 128-row items idle); the backward kernels get the plain lse
    and delta."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    B, L = 3, 200
    q, k, v, do = (_bf16(gen, B, L, h, 128) for h in (H, Hkv, Hkv, H))
    lens = torch.tensor([200, 77, 0], dtype=torch.int32, device=cuda)
    out, lse = t_fab.flash_attention_fwd_lse(q, k, v, lens)
    ref_out, ref_lse = t_fab.flash_attention_fwd_lse_reference(q.float(), k.float(),
                                                                v.float(), lens)
    assert (out.float() - ref_out).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    delta = (do.float() * ref_out).sum(-1).transpose(1, 2).contiguous()
    got = (t_fab.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, lens),
           *t_fab.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, lens))
    want = t_fab.flash_attention_bwd_reference(q.float(), k.float(), v.float(), do.float(),
                                               ref_lse, delta, lens)
    for g, w in zip(got, want):
        assert (g.float() - w).abs().max().item() <= 2e-2 * w.abs().max().item()

