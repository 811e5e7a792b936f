"""Every head dim on the port's attention routes, against the JAX package,
whose Pallas kernels take any head dim.

  * The host's choice of width, instance and column slices (head_dim_plan,
    pad_head_dim) against the formulas of csrc/sm90_common.cuh
    (head_dim_instance, head_dim_slices), read from the source, at every
    head dim 1-1100: the instance lists, the 16-byte alignment, the first
    instance that covers a width, the 256 instance in ceil(width / 256)
    slices above it; and what padding with zero columns leaves of the
    attention (the kernels' zero-filled tail and slices and the host pad):
    nothing, given the true D^-0.5 scale.
  * The plain versions of kernel 2 and of kernels 4-6 (forward, lse and
    the backward by the kernels' formula, and the autograd of
    flash_attention_trainable) at head dims 32, 80, 96, 100, 120, 132
    (padded to 136), 136, 192, 256, 264, 300 (padded to 304), 320, 384 and
    512 and GQA ratios 1, 2, 3 and 4, against the Pallas kernels in
    interpret mode, as the JAX package's tests run them (float32, max-abs
    1e-5: the float32 rounding of softmax sums over at most a few dozen
    keys); kernel 1's plain version at 192, 256, 384 and 512 against the
    Pallas segmented kernel; kernels 3/3q's plain versions at 256, 384 and
    512 against the Pallas decode kernel, bf16 and int8 caches.
  * A tiny Llama-family model at head dims 120 and 100: a cached prefill
    and three decode steps (dense over the cache, as in JAX) against the
    JAX package's cached model (1e-5); at 256 and 512 the same through the
    decode kernel's route on both sides; and one GRPO train step at 120,
    100, 256 and 384 against JAX's make_train_step with its flash kernels
    in interpret mode (metrics rtol 1e-5, params 1e-5 of a leaf's scale,
    the zero biases' 5e-5).
  * chip_smoke's head_dims phase rehearsed at tiny widths on the CPU, a
    512-wide model among them.
"""

import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.distributed import trainer as JT
from socioreasoner_tpu.models import llm as j_llm
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.ops import decode_attention as j_dec
from socioreasoner_tpu.ops import flags as j_flags
from socioreasoner_tpu.ops import flash_attention as j_fa
from socioreasoner_tpu.ops import flash_attention_bwd as j_fab
from socioreasoner_tpu.pipeline import losses as JL
from socioreasoner_tpu_torch.distributed import trainer as TT
from socioreasoner_tpu_torch.models.qwen2_5_vl import text as t_text
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.ops import decode_attention as t_dec
from socioreasoner_tpu_torch.ops import flash_attention as t_fa
from socioreasoner_tpu_torch.ops import flash_attention_bwd as t_fab
from socioreasoner_tpu_torch.pipeline import losses as TL
from tests.test_torch_engine import _port
from tests.test_torch_head_dims import CSRC, _cached_steps

TOL = 1e-5
WIDTHS = (32, 80, 96, 100, 120, 132, 136, 192, 256)
# above 256: the 256 instance in two column slices (300 padded to 304)
SLICED_WIDTHS = (264, 300, 320, 384, 512)
# GQA ratio: (q heads, kv heads)
REPS = {1: (4, 4), 2: (4, 2), 3: (6, 2), 4: (4, 1)}


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


def _randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ the host's plan

def _c_instances():
    """{kernel: its instance list} as csrc/ names them: socio_head_dim_instance's
    switch over the kernels and the kXxxDims lists of sm90_common.cuh."""
    common = (CSRC / "sm90_common.cuh").read_text()
    lists = {name: tuple(int(n) for n in body.split(","))
             for name, body in re.findall(r"constexpr int (k\w+Dims)\[\d+\] = \{([\d, ]+)\};",
                                          common)}
    text = (CSRC / "flash_prefill.cu").read_text()
    body = text[text.index('extern "C" int socio_head_dim_instance('):]
    body = body[:body.index("\n}\n")]
    out, pending = {}, []
    for line in body.splitlines():
        m = re.match(r"\s*case (\d+):(?: return head_dim_instance\((k\w+Dims), d\);)?", line)
        if m:
            pending.append(int(m.group(1)))
            if m.group(2):
                out.update({k: lists[m.group(2)] for k in pending})
                pending = []
    return out


def _c_formula(instances, d: int) -> int:
    """head_dim_instance of csrc/sm90_common.cuh, as written there."""
    if d <= 0 or d % 8 != 0:
        return 0
    return next((n for n in instances if d <= n), instances[-1])


def _c_slices(d: int) -> int:
    """head_dim_slices of csrc/sm90_common.cuh, as written there."""
    return 1 if d <= 256 else (d + 256 - 1) // 256


def test_host_plan_matches_the_kernels_formula():
    """head_dim_plan's instance and slices are the C formulas' on the padded
    width at every head dim 1-1100 for kernels 1, 2, 4, 5 and 6; the C
    formula refuses what is not a multiple of HEAD_DIM_ALIGN (the host pads
    it); above 256 every kernel runs on its 256 instance in ceil(width /
    256) column slices, and socio_head_dim_slices applies the same rule."""
    common = (CSRC / "sm90_common.cuh").read_text()
    fn = common[common.index("inline int head_dim_instance("):]
    fn = fn[:fn.index("\n}\n")]
    assert f"d % {t_fa.HEAD_DIM_ALIGN} != 0" in fn and "if (d <= dims[i]) return dims[i];" in fn
    assert "return dims[N - 1];" in fn and "constexpr int kSliceCols = 256;" in common
    assert ("inline int head_dim_slices(int d) { return d <= kSliceCols ? 1 : "
            "(d + kSliceCols - 1) / kSliceCols; }") in common
    assert t_fa.SLICE_COLS == 256
    entry = (CSRC / "flash_prefill.cu").read_text()
    assert ("return socio_head_dim_instance(kernel, d) == 0 ? 0 : "
            "socio90::head_dim_slices(d);") in entry
    c = _c_instances()
    host = {1: t_fa.SEG_HEAD_DIMS, 2: t_fa.KERNEL_HEAD_DIMS, 4: t_fa.KERNEL_HEAD_DIMS,
            5: t_fab.TRAIN_HEAD_DIMS, 6: t_fab.TRAIN_HEAD_DIMS}
    assert {k: tuple(v) for k, v in c.items()} == {k: tuple(v) for k, v in host.items()}
    for kernel, instances in host.items():
        for D in range(1, 1101):
            plan = t_fa.head_dim_plan(D, instances)
            width = -(-D // 8) * 8
            assert plan == (width, _c_formula(c[kernel], width), _c_slices(width)), \
                (kernel, D, plan)
            assert plan.width % t_fa.HEAD_DIM_ALIGN == 0 and plan.width - D < 8
            assert (plan.slices > 1) == (D > 256) and plan.instance * plan.slices >= width
            assert _c_formula(c[kernel], D) == (0 if D % 8 else plan.instance)
    assert t_fa.head_dim_plan(0, t_fa.KERNEL_HEAD_DIMS) is None
    assert t_fa.head_dim_plan(120, t_fa.KERNEL_HEAD_DIMS) == (120, 128, 1)
    assert t_fa.head_dim_plan(132, t_fa.KERNEL_HEAD_DIMS) == (136, 256, 1)
    assert t_fa.head_dim_plan(192, t_fab.TRAIN_HEAD_DIMS) == (192, 256, 1)
    assert t_fa.head_dim_plan(256, t_fa.SEG_HEAD_DIMS) == (256, 256, 1)
    assert t_fa.head_dim_plan(264, t_fa.KERNEL_HEAD_DIMS) == (264, 256, 2)
    assert t_fa.head_dim_plan(300, t_fab.TRAIN_HEAD_DIMS) == (304, 256, 2)
    assert t_fa.head_dim_plan(512, t_fa.SEG_HEAD_DIMS) == (512, 256, 2)
    assert t_fa.head_dim_plan(513, t_fa.KERNEL_HEAD_DIMS) == (520, 256, 3)
    assert t_fa.head_dim_plan(100, t_fab.TRAIN_HEAD_DIMS) == (104, 128, 1)
    assert t_fa.head_dim_plan(80, t_fab.TRAIN_HEAD_DIMS) == (80, 128, 1)
    assert t_fa.head_dim_plan(72, t_fa.KERNEL_HEAD_DIMS) == (72, 80, 1)


@pytest.mark.parametrize("D", WIDTHS)
def test_zero_columns_change_no_attention(D):
    """What the kernels compute at a head dim below their instance's width:
    q, k and v with zero columns up to the instance (the host pad, then
    TMA's zero fill), the logits scaled by the true D^-0.5, then the first
    D columns of the output: equal to the attention at D (1e-6), and every
    padded column of the output 0."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.as_tensor(_randn(rng, 2, 24, h, D)) for h in (4, 2, 2))
    width, inst, _ = t_fa.head_dim_plan(D, t_fa.KERNEL_HEAD_DIMS)
    padded = [t_fa.pad_head_dim(x, inst) for x in (q, k, v)]
    assert t_fa.pad_head_dim(q, D) is q and t_fa.pad_head_dim(q, width).shape[-1] == width
    assert all(torch.equal(p[..., :D], x) and not p[..., D:].any() for p, x in zip(padded, (q, k, v)))
    kr, vr = (x.repeat_interleave(2, dim=2) for x in padded[1:])
    s = torch.einsum("bqhd,bkhd->bhqk", padded[0], kr) * D ** -0.5
    s = s.masked_fill(torch.ones(24, 24, dtype=torch.bool).triu(1), float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vr)
    _close(out[..., :D], t_fa.flash_attention_reference(q, k, v), 1e-6)
    assert not out[..., D:].any()


@pytest.mark.parametrize("D", SLICED_WIDTHS)
def test_zero_slices_change_no_attention(D):
    """What the sliced kernels compute above 256 columns, in float64: q, k
    and v with zero columns up to the slices' 256 columns each (the host
    pad, then TMA's zero fill of the last slice), the logits over every
    column scaled by the true D^-0.5, each slice's columns of the output
    from those logits alone; joined, the first D columns equal the
    attention at D (1e-12), and every padded column is 0."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.as_tensor(_randn(rng, 2, 24, h, D)).double() for h in (4, 2, 2))
    width, inst, slices = t_fa.head_dim_plan(D, t_fa.KERNEL_HEAD_DIMS)
    assert inst == t_fa.SLICE_COLS and slices == 2 and width >= D
    padded = [t_fa.pad_head_dim(x, inst * slices) for x in (q, k, v)]
    causal = torch.ones(24, 24, dtype=torch.bool).triu(1)

    def attend(q_, k_, v_, scale):
        kr, vr = (x.repeat_interleave(2, dim=2) for x in (k_, v_))
        s = torch.einsum("bqhd,bkhd->bhqk", q_, kr) * scale
        return torch.einsum("bhqk,bkhd->bqhd", s.masked_fill(causal, float("-inf")).softmax(-1),
                            vr)
    want = attend(q, k, v, D ** -0.5)
    cols = [attend(padded[0], padded[1], padded[2][..., i * inst:(i + 1) * inst], D ** -0.5)
            for i in range(slices)]
    got = torch.cat(cols, -1)
    _close(got[..., :D], want, 1e-12)
    assert not got[..., D:].any()


# ------------------------------------------------------------ plain vs Pallas

@pytest.mark.parametrize("rep", sorted(REPS))
@pytest.mark.parametrize("D", WIDTHS + SLICED_WIDTHS)
def test_prefill_matches_pallas_at_any_head_dim(D, rep):
    """Kernel 2's plain version (the wrapper on CPU tensors) against the
    Pallas kernel, causal over a ragged batch (one row of 20 valid keys)."""
    rng = np.random.default_rng(D + rep)
    B, L = 2, 40
    H, Hkv = REPS[rep]
    q, k, v = _randn(rng, B, L, H, D), _randn(rng, B, L, Hkv, D), _randn(rng, B, L, Hkv, D)
    mask = np.ones((B, L), np.int32)
    mask[1, 20:] = 0
    want = j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(mask), causal=True, block_q=64, block_k=64,
                                interpret=True)
    got = t_fa.flash_attention(*(torch.as_tensor(x) for x in (q, k, v, mask)), causal=True)
    assert got.shape == (B, L, H, D)
    _close(got, want)


@pytest.mark.parametrize("rep", sorted(REPS))
@pytest.mark.parametrize("D", WIDTHS + SLICED_WIDTHS)
def test_trainable_matches_pallas_vjp_at_any_head_dim(D, rep):
    """Kernels 4-6's plain versions (out, lse; dq, dk, dv by the kernels'
    formula) and the autograd of flash_attention_trainable on CPU tensors
    against the JAX custom VJP with its Pallas kernels in interpret mode
    (blocks 64), one row of 25 valid keys."""
    rng = np.random.default_rng(10 * D + rep)
    B, L = 2, 40
    H, Hkv = REPS[rep]
    lens = [L, 25]
    q, k, v = _randn(rng, B, L, H, D), _randn(rng, B, L, Hkv, D), _randn(rng, B, L, Hkv, D)
    g = _randn(rng, B, L, H, D)
    jlens = jnp.asarray(np.array(lens, np.float32))
    # jitted: the interpret-mode grids run as one program, not op by op
    f = jax.jit(lambda q_, k_, v_: j_fab.flash_attention_trainable(
        q_, k_, v_, jlens, True, 64, 64, True))
    want, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(g))
    _, res = j_fab._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jlens, True,
                        64, 64, True)
    want_lse = np.asarray(res[5])[:, :L, 0].reshape(B, H, L)

    tq, tk, tv, tg = (torch.as_tensor(x) for x in (q, k, v, g))
    tlens = torch.tensor(lens)
    out, lse = t_fab.flash_attention_fwd_lse(tq, tk, tv, tlens)
    _close(out, want)
    _close(lse, want_lse)
    delta = (tg * out).sum(-1).transpose(1, 2).contiguous()
    got = (t_fab.flash_attention_bwd_dq(tq, tk, tv, tg, lse, delta, tlens),
           *t_fab.flash_attention_bwd_dkv(tq, tk, tv, tg, lse, delta, tlens))
    for grad, w in zip(got, want_grads):
        _close(grad, w)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    t_fab.flash_attention_trainable(*leaves, tlens).backward(tg)
    for leaf, w in zip(leaves, want_grads):
        _close(leaf.grad, w)


@pytest.mark.parametrize("D", [192, 256, 384, 512])
def test_segmented_matches_pallas_at_wide_head_dims(D):
    """Kernel 1's plain version (the wrapper on CPU tensors) against the
    Pallas segmented kernel in interpret mode at head dims on the 256
    instance, in one slice or two: windows of 64 and 48 tokens and a
    ragged tail, 2 heads, blocks of 64 with the span bound."""
    rng = np.random.default_rng(D)
    sizes = (64, 48, 64, 30, 50)
    seg = np.concatenate([np.full(n, i) for i, n in enumerate(sizes)]).astype(np.int32)
    S, H = len(seg), 2
    q, k, v = (_randn(rng, S, H, D) for _ in range(3))
    span = j_fa.seg_max_span_blocks(seg, block_q=64, block_k=64)
    want = j_fa.flash_attention_segmented(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        block_q=64, block_k=64, max_span_blocks=span, interpret=True)
    got = t_fa.flash_attention_segmented(*(torch.as_tensor(x) for x in (q, k, v, seg)),
                                         block_q=64, block_k=64, max_span_blocks=span)
    assert got.shape == (S, H, D)
    _close(got, want)


def _decode_against_pallas(quant, D):
    rng = np.random.default_rng(11)
    Lyr, S, Lmax, H, Hkv = 2, 4, 256, 6, 2
    q = _randn(rng, S, H, D)
    k, v = (_randn(rng, Lyr, S, Lmax, Hkv, D) for _ in range(2))
    lens = np.asarray([0, 1, 97, 256], np.int32)
    scales = []
    if quant:
        caches = []
        for x in (k, v):
            code, scale = j_dec.quantize_kv(jnp.asarray(x.reshape(-1, Lmax, Hkv, D)))
            caches.append(np.asarray(code).reshape(x.shape))
            scales.append(np.swapaxes(np.asarray(scale), -1, -2).reshape(Lyr, S, Hkv, Lmax))
        k, v = caches
    want = j_dec.paged_decode_attention(
        *(jnp.asarray(x) for x in (q, k, v, lens, *scales)), layer=jnp.int32(1),
        block_k=128, interpret=True)
    counts = (t_dec.paged_decode_attention.launches, t_dec.paged_decode_attention_int8.launches)
    got = t_dec.paged_decode_attention(*(torch.as_tensor(x) for x in (q, k, v, lens, *scales)),
                                       layer=1)
    assert got.shape == (S, H, D) and not got[0].any()      # zero length gives 0
    _close(got, want)
    assert (t_dec.paged_decode_attention.launches,
            t_dec.paged_decode_attention_int8.launches) == counts     # CPU: no launch


@pytest.mark.parametrize("quant", [False, True], ids=["float_cache", "int8_cache"])
def test_decode_matches_pallas_at_head_dim_256(quant):
    """Kernels 3 and 3q's plain versions at head dim 256, GQA ratio 3, on a
    stacked cache of 2 layers (layer 1), lengths 0, 1, a partial block and
    the full cache, against the Pallas decode kernel in interpret mode (1e-5:
    f32 softmax over <= 256 keys); the int8 cache's codes and scales from
    JAX's quantize_kv, per token and head (amax / 127, amax floored at
    1e-8)."""
    _decode_against_pallas(quant, 256)


@pytest.mark.parametrize("D", [384, 512])
@pytest.mark.parametrize("quant", [False, True], ids=["float_cache", "int8_cache"])
def test_decode_matches_pallas_at_wide_head_dims(quant, D):
    """The same at head dims 384 and 512, multiples of 128 that the decode
    kernel takes in two column slices (the JAX package routes them to its
    decode kernel too)."""
    assert t_dec.decode_slices(D) == 2 and D % t_dec.KERNEL_HEAD_DIM_UNIT == 0
    _decode_against_pallas(quant, D)


# ------------------------------------------------------------ a model

def _llama(head_dim: int):
    """A tiny Llama-family config at `head_dim` (4 / 2 heads, 2 layers)."""
    return j_llm.config_from_hf_dict({
        "model_type": "llama", "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": head_dim, "rms_norm_eps": 1e-6, "eos_token_id": 250, "bos_token_id": 0})


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX model's flash routes as on the TPU, its Pallas kernels in
    interpret mode: the prefill kernel on the cached path, the trainable
    kernels (blocks 64) in the train step."""
    monkeypatch.setattr(j_fa, "flash_attention",
                        functools.partial(j_fa.flash_attention, interpret=True))
    monkeypatch.setattr(j_fab, "flash_attention_trainable", functools.partial(
        j_fab.flash_attention_trainable, block_q=64, block_k=64, interpret=True))
    monkeypatch.setattr(j_flags, "use_flash_attention", lambda explicit=None: True)


@pytest.mark.parametrize("head_dim", [120, 100])
def test_llama_head_dim_decodes_as_jax(head_dim, jax_flash, monkeypatch):
    """A cached prefill of 7 tokens (the prefill kernel's route) and three
    decode steps (dense over the cache: head_dim % 128 != 0) against the
    JAX package's cached model, f32 weights; the port's prefill goes
    through flash_attention and no step through the decode kernel."""
    config = _llama(head_dim)
    assert config.text.head_dim == head_dim
    jp = j_model.init_params(config, jax.random.key(5), jnp.float32, with_vision=False)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")

    def refuse(*a, **k):
        raise AssertionError(f"paged_decode_attention called at head_dim {head_dim}")
    monkeypatch.setattr(t_text, "paged_decode_attention", refuse)
    monkeypatch.setattr(j_dec, "paged_decode_attention", refuse)
    calls = []
    plain = t_text.flash_attention
    monkeypatch.setattr(t_text, "flash_attention",
                        lambda q, *a, **k: calls.append(q.shape[-1]) or plain(q, *a, **k))
    ids = np.random.default_rng(1).integers(2, 240, (2, 10))
    want = _cached_steps("jax", config, jp, ids, False)
    got = _cached_steps("port", _port(config), tp, ids, False)
    assert calls == [head_dim] * config.text.num_hidden_layers
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _llama_decodes_through_the_kernel(head_dim, monkeypatch):
    config = _llama(head_dim)
    jp = j_model.init_params(config, jax.random.key(5), jnp.float32, with_vision=False)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    monkeypatch.setattr(j_dec, "paged_decode_attention", functools.partial(
        j_dec.paged_decode_attention, block_k=64, interpret=True))
    calls, prefill = [], []
    plain, plain_fa = t_text.paged_decode_attention, t_text.flash_attention
    monkeypatch.setattr(t_text, "paged_decode_attention",
                        lambda *a, **k: calls.append(k.get("layer")) or plain(*a, **k))
    monkeypatch.setattr(t_text, "flash_attention",
                        lambda q, *a, **k: prefill.append(q.shape[-1]) or plain_fa(q, *a, **k))
    ids = np.random.default_rng(1).integers(2, 240, (2, 10))
    want = _cached_steps("jax", config, jp, ids, False)
    got = _cached_steps("port", _port(config), tp, ids, False)
    assert calls == [0, 1] * 3 and prefill == [head_dim, head_dim]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_llama_head_dim_256_decodes_through_the_kernel_as_jax(jax_flash, monkeypatch):
    """At head_dim 256, a multiple of 128, both packages decode through
    their decode kernels: the port's paged_decode_attention (its plain
    version on the CPU) at every layer of the three decode steps, the JAX
    package's Pallas decode kernel in interpret mode. The cached prefill
    (through flash_attention at 256) and the steps equal the JAX package's
    cached model (f32 weights, 1e-5)."""
    _llama_decodes_through_the_kernel(256, monkeypatch)


def test_llama_head_dim_512_decodes_through_the_kernel_as_jax(jax_flash, monkeypatch):
    """The same at head_dim 512 (two column slices of the port's kernels):
    both packages route every decode step through their decode kernels."""
    _llama_decodes_through_the_kernel(512, monkeypatch)


LR = 1e-3


@pytest.mark.parametrize("head_dim", [120, 100, 256, 384])
def test_llama_head_dim_train_step_matches_jax(head_dim, jax_flash):
    """One GRPO step (remat, the trainable kernels' routes: JAX's Pallas
    kernels in interpret mode, the port's plain versions) from the same f32
    tree: every metric, then every parameter."""
    from tests.test_torch_llm_families import _text_batch
    config = _llama(head_dim)
    np_params = jax.tree.map(np.asarray, j_model.init_params(
        config, jax.random.key(6), jnp.float32, with_vision=False))
    batch = _text_batch(config.pad_token_id)
    jopt = JT.make_optimizer(lr=LR, weight_decay=0.01, eps=1e-4)
    jstate, jm = jax.jit(JT.make_train_step(config, JL.PPOLossConfig(), jopt))(
        JT.TrainState.create(jax.tree.map(jnp.asarray, np_params), jopt),
        {k: jnp.asarray(v) for k, v in batch.items()})
    topt = TT.make_optimizer(lr=LR, weight_decay=0.01, eps=1e-4)
    counts = t_fab.flash_attention_fwd_lse.launches
    calls = []
    trainable = t_text.flash_attention_trainable
    t_text.flash_attention_trainable = lambda q, *a: calls.append(q.shape[-1]) or trainable(q, *a)
    try:
        tstate, tm = TT.make_train_step(_port(config), TL.PPOLossConfig(), topt)(
            TT.TrainState.create(params_from_numpy(np_params, device="cpu"), topt),
            {k: torch.as_tensor(v) for k, v in batch.items()})
    finally:
        t_text.flash_attention_trainable = trainable
    assert calls and set(calls) == {head_dim}
    assert t_fab.flash_attention_fwd_lse.launches == counts      # CPU: no launch
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    jnew = jax.tree.map(np.asarray, jstate.params)
    for key, leaf in tstate.params["layers"].items():
        want = jnew["layers"][key]
        # a Llama's zero q/k/v biases: their gradient sums every token's
        # terms, which cancel to ~eps, where Adam (eps 1e-4) carries the
        # sum's f32 rounding into the update (1.6e-5 of lr seen at 120)
        tol = 5e-5 if key.endswith("_b") else 1e-5
        assert np.abs(leaf.numpy() - want).max() <= tol * max(np.abs(want).max(), LR), key
    for key in ("embed", "final_ln", "lm_head"):
        want = jnew[key]
        assert np.abs(tstate.params[key].numpy() - want).max() <= 1e-5 * max(
            np.abs(want).max(), LR), key


# ------------------------------------------------------------ chip_smoke

TINY_HEAD_DIM_MODELS = {
    # Danube3-4B's shape of run: served and trained, head dim 120, rep 4
    "tiny_120": ({"model_type": "llama", "vocab_size": 512, "hidden_size": 64,
                  "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
                  "num_key_value_heads": 1, "head_dim": 120, "eos_token_id": 500}, "a tiny llama", 2, 1),
    # OpenLLaMA-3B v2's: served only, head dim 100 (the host pad), rep 1
    "tiny_100": ({"model_type": "llama", "vocab_size": 512, "hidden_size": 64,
                  "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 2,
                  "num_key_value_heads": 2, "head_dim": 100, "eos_token_id": 500}, "a tiny llama", 2, None),
    # Falcon3-7B's: served, served with the int8 KV cache and trained, head
    # dim 256 (the decode kernel's route), rep 3
    "tiny_256": ({"model_type": "llama", "vocab_size": 512, "hidden_size": 64,
                  "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 6,
                  "num_key_value_heads": 2, "head_dim": 256, "eos_token_id": 500}, "a tiny llama", 2, 1),
    # the 6/2 x 512 regrouping's: tiny_256's projections as 3/1 x 512 (its
    # shards read back), served, served with the int8 KV cache and trained
    "tiny_512": ({"model_type": "llama", "vocab_size": 512, "hidden_size": 64,
                  "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 3,
                  "num_key_value_heads": 1, "head_dim": 512, "eos_token_id": 500},
                 "a tiny llama regrouped", 2, 1),
}


def test_chip_smoke_head_dims_phase_on_cpu(tmp_path, monkeypatch):
    """chip_smoke's head_dims phase rehearsed at tiny widths on CPU tensors
    (the kernels' plain versions): each model's checkpoint written and read
    back bit for bit through llm.load_text_model (a regrouping's, the shards
    of the model it regroups under its own config.json), served against the
    teacher-forced forward at its served depth and trained (kernels against
    dense attention) on the first layers; the served prefill reaches
    flash_attention at the model's head dim, and the decode kernel's route
    is taken at 256 and 512 only."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "HEAD_DIM_MODELS", TINY_HEAD_DIM_MODELS)
    monkeypatch.setattr(chip_smoke, "HEAD_DIM_INT8_LAYERS", {"tiny_256": 1, "tiny_512": 1})
    monkeypatch.setattr(chip_smoke, "HEAD_DIM_REGROUPED", {"tiny_512": "tiny_256"})
    seen, decoded = [], []
    plain, plain_dec = t_text.flash_attention, t_text.paged_decode_attention
    monkeypatch.setattr(t_text, "flash_attention",
                        lambda q, *a, **k: seen.append(q.shape[-1]) or plain(q, *a, **k))
    monkeypatch.setattr(t_text, "paged_decode_attention", lambda q, k, v, lens, *scales, **kw: (
        decoded.append((q.shape[-1], any(x is not None for x in scales)))
        or plain_dec(q, k, v, lens, *scales, **kw)))
    kernels = chip_smoke._family_kernels()
    serve_kw = dict(prompt_lens=(30, 21), bucket=32, max_new=4, decode_chunk=4)
    cpu = torch.device("cpu")
    fig = chip_smoke.run_head_dim_model("tiny_120", cpu, str(tmp_path), kernels=kernels,
                                        serve_kw=serve_kw, train_kw=dict(lens=(64, 40), steps=1))
    assert fig["checkpoint_gb"] > 0
    assert fig["serve"]["checked_tokens"] == sum(fig["serve"]["generated"]) > 0
    assert fig["serve"]["cache"] == [2, 2, 256, 1, 120] and not fig["serve"]["failures"]
    assert fig["train"]["shape"] == "B=2 L=64 kv_len=[64, 40]"
    assert all(n == 0 for n in fig["serve"]["launches"].values())      # CPU: no launch
    assert set(seen) == {120} and not decoded
    seen.clear()
    fig = chip_smoke.run_head_dim_model("tiny_100", cpu, str(tmp_path), kernels=kernels,
                                        serve_kw=serve_kw)
    assert "train" not in fig and fig["serve"]["cache"][-2:] == [2, 100]
    assert set(seen) == {100} and not decoded
    seen.clear()
    fig = chip_smoke.run_head_dim_model("tiny_256", cpu, str(tmp_path), kernels=kernels,
                                        serve_kw=serve_kw, train_kw=dict(lens=(64, 40), steps=1))
    assert fig["checkpoint_gb"] > 0
    assert fig["serve"]["cache"] == [2, 2, 256, 2, 256] and not fig["serve"]["failures"]
    assert fig["serve_int8_kv"]["cache"] == [1, 2, 256, 2, 256]
    assert not fig["serve_int8_kv"]["failures"]
    assert fig["train"]["shape"] == "B=2 L=64 kv_len=[64, 40]"
    assert set(seen) == {256} and set(decoded) == {(256, False), (256, True)}
    assert [p.name for p in tmp_path.iterdir()] == ["tiny_256"]     # kept for its regrouping
    seen.clear()
    decoded.clear()
    fig = chip_smoke.run_head_dim_model("tiny_512", cpu, str(tmp_path), kernels=kernels,
                                        serve_kw=serve_kw, train_kw=dict(lens=(64, 40), steps=1))
    assert fig["read_from"] == "tiny_256" and fig["checkpoint_gb"] > 0
    assert fig["serve"]["cache"] == [2, 2, 256, 1, 512] and not fig["serve"]["failures"]
    assert fig["serve"]["checked_tokens"] == sum(fig["serve"]["generated"]) > 0
    assert fig["serve_int8_kv"]["cache"] == [1, 2, 256, 1, 512]
    assert not fig["serve_int8_kv"]["failures"]
    assert fig["train"]["shape"] == "B=2 L=64 kv_len=[64, 40]"
    assert set(seen) == {512} and set(decoded) == {(512, False), (512, True)}
    assert list(tmp_path.iterdir()) == []                 # each checkpoint removed
    monkeypatch.undo()
    hd = {name: chip_smoke._heads(hf)[2] for name, (hf, *_) in chip_smoke.HEAD_DIM_MODELS.items()}
    assert hd == {"danube3_4b": 120, "danube3_500m": 96, "danube2_1_8b": 80,
                  "open_llama_3b_v2": 100, "falcon3_7b": 256, "falcon3_7b_d512": 512,
                  "falcon3_7b_d384": 384}
    assert {k: v[2:] for k, v in chip_smoke.HEAD_DIMS_PREFILL.items()} == {
        "danube3_4b": (32, 8, 120), "danube3_500m": (16, 8, 96),
        "open_llama_3b_v2": (32, 32, 100), "falcon3_7b": (12, 4, 256),
        "falcon3_7b_d512": (6, 2, 512), "falcon3_7b_d384": (8, 2, 384)}
    assert {k: (v["H"], v["Hkv"], v["D"], v["L"]) for k, v in
            chip_smoke.HEAD_DIMS_TRAIN.items()} == {
        "danube3_4b": (32, 8, 120, 2048), "danube3_500m": (16, 8, 96, 2048),
        "danube2_1_8b": (32, 8, 80, 2048), "falcon3_7b": (12, 4, 256, 2048),
        "falcon3_7b_d512": (6, 2, 512, 2048), "falcon3_7b_d384": (8, 2, 384, 2048)}
    # the regroupings keep Falcon3's projection widths and its hidden size
    for name in ("falcon3_7b_d512", "falcon3_7b_d384"):
        hf = chip_smoke.HEAD_DIM_MODELS[name][0]
        H, Hkv, D = chip_smoke._heads(hf)
        assert H * D == 3072 == hf["hidden_size"] and Hkv * D in (1024, 768)
        assert {k: v for k, v in hf.items() if k not in (
            "num_attention_heads", "num_key_value_heads", "head_dim")} == {
            k: v for k, v in chip_smoke.FALCON3_7B.items() if k not in (
                "num_attention_heads", "num_key_value_heads", "head_dim")}
    assert chip_smoke.HEAD_DIM_REGROUPED == {"falcon3_7b_d512": "falcon3_7b"}
    names = list(chip_smoke.HEAD_DIM_MODELS)
    assert names.index("falcon3_7b") < names.index("falcon3_7b_d512")
    # the served caches are the ones the kernels phase checks
    cases = {c[0]: c for c in chip_smoke.HEAD_DIM_DECODE_CASES}
    for name, layers, heads in (("falcon3_7b", 28, (12, 4, 256)),
                                ("falcon3_7b_d512", 28, (6, 2, 512)),
                                ("falcon3_7b_d384", 4, (8, 2, 384))):
        assert cases[name][1:3] == (4, chip_smoke.FAMILY_LALLOC)
        assert cases[name][4:] == (layers, *heads)
    assert chip_smoke.HEAD_DIM_INT8_LAYERS == {"falcon3_7b": 4, "falcon3_7b_d512": 4}
