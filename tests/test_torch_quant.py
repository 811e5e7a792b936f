"""The port's quantized serving against the JAX package's: ops/quant.py codes
and products, the int8 KV cache and its decode attention, the quantized
cached text decoder, the int8 ViT, the DecodeEngine's quantization knobs
and TorchDecodeStrategy's single_copy_quant / vit_quant.

Float32 at tiny sizes, inputs from a numpy seed. Quantization codes and
scales must equal JAX's bit for bit (both sides use XLA's f32 reciprocal of
127 / 7 and round half to even); float results are held to the stated
max-abs bounds (float32 rounding through a few layers). Greedy engine
streams and steps_executed must be identical.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.generation import engine as j_engine
from socioreasoner_tpu.generation.sampling import SamplingParams as JSampling
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl import vision as j_vision
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.ops import decode_attention as j_dec
from socioreasoner_tpu.ops import quant as jq
from socioreasoner_tpu_torch.generation import engine as t_engine
from socioreasoner_tpu_torch.generation.sampling import SamplingParams
from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
from socioreasoner_tpu_torch.models.qwen2_5_vl import vision as t_vision
from socioreasoner_tpu_torch.models.qwen2_5_vl import convert

# the tests' trees live on the CPU (the entry point places them on the GPU
# unless a device is named)
params_from_numpy = functools.partial(convert.params_from_numpy, device="cpu")


def _port(obj):
    """The port's own copy of a JAX-package config dataclass, field for field."""
    mod = importlib.import_module(type(obj).__module__.replace(
        "socioreasoner_tpu.", "socioreasoner_tpu_torch.", 1))
    cls = getattr(mod, type(obj).__name__)
    return cls(**{f.name: _port(getattr(obj, f.name))
                  if dataclasses.is_dataclass(getattr(obj, f.name)) else getattr(obj, f.name)
                  for f in dataclasses.fields(obj) if f.init})
from socioreasoner_tpu_torch.ops import decode_attention as t_dec
from socioreasoner_tpu_torch.ops import quant as tq
from test_torch_ops import DECODE_CASES, assert_decode_rows

TOL = 1e-4         # max-abs on f32 logits / embeddings (as test_torch_qwen25vl)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


def _equal(got, want):
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_equal(got[k], w)
        else:
            _equal(got[k], w)


@pytest.fixture
def jax_flash_interpret(monkeypatch):
    """The JAX cache path as it runs on the TPU (use_flash): prefill attends
    over the raw k/v of the local sequence through the Pallas prefill kernel,
    here in interpret mode. Its CPU fallback attends over the dequantised
    int8 cache instead; the port, like the TPU path, uses the raw k/v."""
    from socioreasoner_tpu.ops import flags
    from socioreasoner_tpu.ops import flash_attention as j_fa
    monkeypatch.setattr(j_fa, "flash_attention",
                        functools.partial(j_fa.flash_attention, interpret=True))
    monkeypatch.setattr(flags, "use_flash_attention", lambda explicit=None: True)


@pytest.fixture(scope="module")
def setup():
    config = Qwen25VLConfig.tiny()
    jp = j_model.init_params(config, jax.random.key(11), dtype=jnp.float32,
                             with_vision=True)
    return config, jp


# ------------------------------------------------------------- ops/quant.py

@pytest.mark.parametrize("fn,shape,kw", [
    ("quantize_weight", (3, 256, 40), {}),
    ("quantize_weight", (40, 96), {"axis": -1}),
    ("quantize_weight_int4", (3, 256, 40), {}),
    ("quantize_weight_int4", (2, 64, 24), {}),              # K < group: one group
])
def test_quantize_weight_codes_match_jax(fn, shape, kw):
    w = (np.random.default_rng(0).normal(size=shape) * 0.02).astype(np.float32)
    jcode, jscale = getattr(jq, fn)(jnp.asarray(w), **kw)
    tcode, tscale = getattr(tq, fn)(torch.as_tensor(w), **kw)
    _equal(tcode, jcode)
    _equal(tscale, jscale)


def test_pack_unpack_int4_match_jax():
    vals = np.random.default_rng(5).integers(-8, 8, size=(3, 10, 7))
    packed = tq.pack_int4(torch.as_tensor(vals))
    _equal(packed, jq.pack_int4(jnp.asarray(vals)))
    _equal(tq.unpack_int4(packed), jq.unpack_int4(jnp.asarray(np.asarray(packed))))


def test_quantize_act_and_w8a8_match_jax():
    """Activation codes and scales bit for bit; the w8a8 product (an exact
    int32 accumulate, then two f32 scalings) equal to JAX's jitted one.
    K = 100 and N = 36 are not multiples of 8 and 2 x 5 rows are fewer than
    17: torch._int_mm gets the zero-padded operands."""
    rng = np.random.default_rng(2)
    h = (rng.normal(size=(2, 5, 100)) * 0.7).astype(np.float32)
    w = (rng.normal(size=(100, 36)) * 0.02).astype(np.float32)
    jcode, jscale = jax.jit(jq.quantize_act)(jnp.asarray(h))
    tcode, tscale = tq.quantize_act(torch.as_tensor(h))
    _equal(tcode, jcode)
    _equal(tscale, jscale)
    wq, ws = jq.quantize_weight(jnp.asarray(w))
    want = jax.jit(jq.matmul_w8a8)(jnp.asarray(h), wq, ws)
    got = tq.matmul_w8a8(torch.as_tensor(h), _t(wq), _t(ws))
    _close(got, want, 1e-6)     # same int32 sums and f32 products
    acc = tq.int_matmul(tcode.reshape(10, 100), _t(wq))
    np.testing.assert_array_equal(
        acc.numpy(), np.asarray(tcode, np.int64).reshape(10, 100) @ np.asarray(wq, np.int64))


@pytest.mark.parametrize("mode,a8", [("float", False), ("int8", False), ("int8", True),
                                     ("int4", False)])
def test_matmul_q_matches_jax(mode, a8):
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 6, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 48)) * 0.02).astype(np.float32)
    jp = {"w": jnp.asarray(w)}
    if mode != "float":
        quant = jq.quantize_weight if mode == "int8" else jq.quantize_weight_int4
        jp["w"], jp["w_scale"] = quant(jnp.asarray(w))
    want = jax.jit(lambda h, p: jq.matmul_q(h, p, "w", a8=a8))(jnp.asarray(h), jp)
    got = tq.matmul_q(torch.as_tensor(h), params_from_numpy(_np_tree(jp)), "w", a8=a8)
    _close(got, want, 1e-5)     # f32 dots of 256 terms of size ~0.05


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("tied", [False, True])
def test_quantize_decode_params_matches_jax(setup, mode, tied):
    """Every leaf of the quantized tree bit for bit (both head layouts);
    head_logits within TOL; inplace mutates the caller's dicts and gives the
    same tree, the default leaves them as they were."""
    _, jp = setup
    jp = {k: v for k, v in jp.items() if k != "vision"}
    if tied:
        jp = {k: v for k, v in jp.items() if k != "lm_head"}
    want = _np_tree(jq.quantize_decode_params(jp, mode=mode))
    tree = params_from_numpy(_np_tree(jp))
    got = tq.quantize_decode_params(tree, mode=mode)
    _assert_trees_equal(got, want)
    assert tree["layers"]["q_w"].dtype == torch.float32          # caller's tree kept
    assert tq.params_prequantized(got) and not tq.params_prequantized(tree)
    mine = tq.quantize_decode_params(tree, mode=mode, inplace=True)
    assert mine is tree
    _assert_trees_equal(tree, want)
    hidden = np.random.default_rng(4).normal(size=(3, 64)).astype(np.float32)
    _close(tq.head_logits(got, torch.as_tensor(hidden)),
           jq.head_logits(jax.tree.map(jnp.asarray, want), jnp.asarray(hidden)))


def test_quantize_vision_params_matches_jax(setup):
    _, jp = setup
    want = _np_tree(jq.quantize_vision_params(jp["vision"]))
    tree = params_from_numpy(_np_tree(jp["vision"]))
    got = tq.quantize_vision_params(tree)
    _assert_trees_equal(got, want)
    assert got["patch_embed_w"].dtype == torch.float32          # never quantized
    assert tq.vision_prequantized(got) and not tq.vision_prequantized(tree)


def test_params_from_numpy_keeps_codes_and_f32_scales(setup):
    """A quantized tree under dtype=bfloat16: codes stay int8/uint8, every
    *_scale leaf stays float32, the other float leaves become bf16."""
    _, jp = setup
    qtree = jq.quantize_decode_params({k: v for k, v in jp.items() if k != "vision"},
                                      mode="int4")
    qtree["vision"] = jq.quantize_vision_params(jp["vision"])
    tree = params_from_numpy(_np_tree(qtree), dtype=torch.bfloat16)
    assert tree["layers"]["q_w"].dtype == torch.uint8
    assert tree["vision"]["blocks"]["qkv_w"].dtype == torch.int8
    assert tree["layers"]["q_w_scale"].dtype == torch.float32
    assert tree["vision"]["merger_fc1_w_scale"].dtype == torch.float32
    assert tree["lm_head_scale"].dtype == torch.float32
    assert tree["embed"].dtype == torch.bfloat16
    assert tree["vision"]["patch_embed_w"].dtype == torch.bfloat16
    _equal(tree["layers"]["down_w_scale"], qtree["layers"]["down_w_scale"])


# ------------------------------------------------------- int8 KV + decode

def test_quantize_kv_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 40, 2, 16)).astype(np.float32)
    x[0, 3] = 0.0                                                # amax floor
    jcode, jscale = jax.jit(j_dec.quantize_kv)(jnp.asarray(x))
    tcode, tscale = t_dec.quantize_kv(torch.as_tensor(x))
    _equal(tcode, jcode)
    _equal(tscale, jscale)
    st = np.swapaxes(np.asarray(jscale), 1, 2)
    _equal(t_dec.dequantize_kv(tcode, torch.as_tensor(st)),
           j_dec.dequantize_kv(jcode, jnp.asarray(st)))


def _int8_cache(rng, lead, S, Lmax, Hkv, D):
    k = rng.normal(size=lead + (S, Lmax, Hkv, D)).astype(np.float32)
    v = rng.normal(size=lead + (S, Lmax, Hkv, D)).astype(np.float32)
    out = []
    for x in (k, v):
        code, scale = j_dec.quantize_kv(jnp.asarray(x.reshape((-1, Lmax, Hkv, D))))
        out.append(np.asarray(code).reshape(x.shape))
        out.append(np.swapaxes(np.asarray(scale), -1, -2).reshape(lead + (S, Hkv, Lmax)))
    return out                      # k codes, k scales, v codes, v scales


@pytest.mark.parametrize("layer", [None, 1])
def test_paged_decode_int8_matches_pallas(layer):
    """The int8 path's plain version against the Pallas int8 branch in
    interpret mode, unstacked and at a layer of a stacked cache; lengths
    0, 1, a partial block and the full cache."""
    rng = np.random.default_rng(7)
    S, Lmax, H, Hkv, D = 4, 256, 8, 2, 64
    lead = () if layer is None else (2,)
    kc, ks, vc, vs = _int8_cache(rng, lead, S, Lmax, Hkv, D)
    q = rng.normal(size=(S, H, D)).astype(np.float32)
    lens = np.asarray([0, 1, 97, 256], np.int32)
    kw = {} if layer is None else {"layer": layer}
    want = j_dec.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        jnp.asarray(ks), jnp.asarray(vs), block_k=128, interpret=True,
        **({} if layer is None else {"layer": jnp.int32(layer)}))
    n = t_dec.paged_decode_attention_int8.launches
    got = t_dec.paged_decode_attention(*map(torch.as_tensor, (q, kc, vc, lens, ks, vs)), **kw)
    _close(got, want, 1e-5)         # f32 softmax over <= 256 keys
    assert not got[0].any()         # zero length gives 0
    assert t_dec.paged_decode_attention_int8.launches == n     # the CPU takes no kernel


def test_paged_decode_int8_shape_checks():
    q, cache = torch.zeros(3, 4, 16), torch.zeros(3, 64, 2, 16, dtype=torch.int8)
    lens = torch.ones(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="shapes do not fit"):
        t_dec.paged_decode_attention(q, cache, cache, lens, torch.zeros(3, 64, 2),
                                     torch.zeros(3, 64, 2))        # untransposed scales


# --------------------------------------------------- quantized text decoder

def _cached_forward(fwd, config, params, ids, kv_quant, act_quant, mod, **kw):
    """Prefill of `ids` then one decode step, through `fwd` (JAX or port
    model.forward) with `mod` (jnp or torch) arrays; returns the prefill's
    last logits, the step's logits and the caches."""
    t = config.text
    B, P = ids.shape
    Lyr, Hkv, D, Lmax = t.num_hidden_layers, t.num_key_value_heads, t.head_dim, 32
    as_arr = (lambda x: jnp.asarray(x)) if mod is jnp else (lambda x: torch.as_tensor(x))
    cdt = np.int8 if kv_quant else np.float32
    cache = {"k": as_arr(np.zeros((Lyr, B, Lmax, Hkv, D), cdt)),
             "v": as_arr(np.zeros((Lyr, B, Lmax, Hkv, D), cdt)),
             "kv_valid": as_arr((np.arange(Lmax)[None] < P).astype(np.int32).repeat(B, 0))}
    if kv_quant:
        cache["k_scale"] = as_arr(np.zeros((Lyr, B, Hkv, Lmax), np.float32))
        cache["v_scale"] = as_arr(np.zeros((Lyr, B, Hkv, Lmax), np.float32))
    pos = np.broadcast_to(np.arange(P)[None, None], (B, 3, P)).astype(np.int64)
    cpos = np.broadcast_to(np.arange(P)[None], (B, P)).astype(np.int64)
    logits, cache = fwd(config, params, as_arr(ids), as_arr(pos), None, cache=cache,
                        cache_positions=as_arr(cpos), act_quant=act_quant, **kw)
    first = np.asarray(logits[:, P - 1])
    tok = first.argmax(-1)[:, None]
    cache = dict(cache)
    cache["kv_valid"] = as_arr((np.arange(Lmax)[None] < P + 1).astype(np.int32).repeat(B, 0))
    step, cache = fwd(config, params, as_arr(tok), as_arr(np.full((B, 3, 1), P, np.int64)),
                      None, cache=cache, cache_positions=as_arr(np.full((B, 1), P)),
                      act_quant=act_quant, **kw)
    return first, np.asarray(step[:, 0]), {k: np.asarray(v) for k, v in cache.items()}


@pytest.mark.parametrize("mode,kv_quant,act_quant", [
    ("int8", True, False), ("int8", True, True), ("int4", False, False),
])
def test_cached_decoder_quantized_matches_jax(setup, jax_flash_interpret, mode, kv_quant,
                                             act_quant):
    """Prefill + one decode step of the cached decoder on a quantized tree
    (w8a16 / w8a8 prefill / w4a16) with an int8 or f32 cache, against the
    JAX cache path with use_flash (prefill over the raw k/v): logits within
    TOL; the cache's codes may differ where a value sits within f32 rounding
    of a half-code boundary, so they are held as dequantised values."""
    config, jp = setup
    jq_tree = jq.quantize_decode_params({k: v for k, v in jp.items() if k != "vision"},
                                        mode=mode)
    tp = params_from_numpy(_np_tree(jq_tree))
    ids = np.random.default_rng(8).integers(2, 200, size=(2, 11))
    jf, js, jc = _cached_forward(j_model.forward, config, jq_tree, ids, kv_quant,
                                 act_quant, jnp, use_flash=True)
    with torch.no_grad():
        tf, ts, tc = _cached_forward(t_model.forward, _port(config), tp, ids, kv_quant,
                                     act_quant, torch)
    np.testing.assert_allclose(tf, jf, atol=TOL, rtol=0)
    np.testing.assert_allclose(ts, js, atol=TOL, rtol=0)
    if kv_quant:
        for name in ("k", "v"):
            got = tc[name].astype(np.float32) * np.swapaxes(tc[name + "_scale"], -1, -2)[..., None]
            want = jc[name].astype(np.float32) * np.swapaxes(jc[name + "_scale"], -1, -2)[..., None]
            # one code step at most: the scales are amax / 127 of |x| <~ 3
            np.testing.assert_allclose(got, want, atol=0.03, rtol=0)
            assert (tc[name] == jc[name]).mean() > 0.999


def test_uncached_decoder_refuses_quantized_tree(setup):
    config, jp = setup
    tp = params_from_numpy(_np_tree(jq.quantize_decode_params(
        {k: v for k, v in jp.items() if k != "vision"})))
    ids = torch.ones(1, 4, dtype=torch.long)
    pos = torch.zeros(1, 3, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="cache path"):
        t_model.forward(_port(config), tp, ids, pos)


def test_int8_vit_matches_jax(setup):
    """The int8 (w8a8) tower from JAX's quantize_vision_params through
    run_vision on both sides: it runs (the patch-embed test that refused it
    looked at a leaf that is never quantized) and matches within TOL."""
    config, jp = setup
    cfg = config.vision
    qv = jq.quantize_vision_params(jp["vision"])
    assert qv["patch_embed_w"].dtype == jnp.float32 and qv["blocks"]["qkv_w"].dtype == jnp.int8
    rng = np.random.default_rng(9)
    grid = np.array([[1, 8, 12], [1, 4, 4]])
    patches = rng.normal(size=(int(grid.prod(-1).sum()), cfg.patch_input_dim)).astype(np.float32)
    want = j_vision.run_vision(cfg, qv, patches, grid)
    with torch.no_grad():
        got = t_vision.run_vision(_port(cfg), params_from_numpy(_np_tree(qv)), patches, grid)
    _close(got, want)
    full = j_vision.run_vision(cfg, jp["vision"], patches, grid)
    assert np.abs(np.asarray(want) - np.asarray(full)).max() > 1e-4   # really quantized


# ------------------------------------------------------------------ engine

def _greedy(n):
    return dict(temperature=0.0, do_sample=False, max_new_tokens=n)


ENGINE_CASES = {
    "int8_hybrid": (None, dict(weight_quant="int8")),
    "int4_hybrid": (None, dict(weight_quant="int4")),
    "int8_hybrid_a8": (None, dict(weight_quant="int8", act_quant="int8")),
    "single_copy_a8_kv": ("int8", dict(weight_quant="int8", act_quant="int8",
                                       kv_quant="int8")),
    "kv_int8_inner": (None, dict(kv_quant="int8", decode_chunk=8, decode_inner=2)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_quantized_greedy_matches_jax(setup, jax_flash_interpret, case):
    """Greedy tokens, finish reasons and steps_executed of the port's engine
    equal the JAX engine's (cache path with use_flash, see
    jax_flash_interpret) for each quantization knob (single-copy: both
    engines get the pre-quantized tree); prefix fork included."""
    config, jp = setup
    prequant, kw = ENGINE_CASES[case]
    kw = dict(dict(max_slots=3, max_len=64, decode_chunk=4, prefill_buckets=(16, 32)), **kw)
    tree = {k: v for k, v in jp.items() if k != "vision"}
    if prequant:
        tree = jq.quantize_decode_params(tree, mode=prequant)
    tp = params_from_numpy(_np_tree(tree))
    rng = np.random.default_rng(10)
    prompts = [rng.integers(2, 200, size=n).tolist() for n in (5, 9, 14)]
    specs = [(0, prompts[0], 7), (1, prompts[1], 3), (2, prompts[2], 11), (3, prompts[0], 6)]
    je = j_engine.DecodeEngine(config, tree, cache_dtype=jnp.float32, sampler_exact=True, **kw)
    te = t_engine.DecodeEngine(_port(config), tp, cache_dtype=torch.float32, **kw)
    assert (te.params_q is None) == (je.params_q is None)
    jo = je.generate([j_engine.Request(request_id=i, prompt_ids=p, sampling=JSampling(**_greedy(m)))
                      for i, p, m in specs])
    to = te.generate([t_engine.Request(request_id=i, prompt_ids=p,
                                       sampling=SamplingParams(**_greedy(m)))
                      for i, p, m in specs])
    assert [o.output_ids for o in to] == [o.output_ids for o in jo]
    assert [o.finish_reason for o in to] == [o.finish_reason for o in jo]
    assert te.steps_executed == je.steps_executed
    assert (te.prefill_rows, te.forked_requests) == (je.prefill_rows, je.forked_requests)
    if "kv_quant" in kw:
        assert te.caches["k"].dtype == torch.int8
        assert tuple(te.caches["k_scale"].shape) == tuple(je.caches["k_scale"].shape)


@pytest.mark.parametrize("kw", [
    dict(weight_quant="fp4"), dict(act_quant="int8"),
    dict(weight_quant="int8", act_quant="int4"), dict(kv_quant="fp8"),
    dict(decode_chunk=6, decode_inner=4),
])
def test_engine_argument_errors_match_jax(setup, kw):
    config, jp = setup
    base = dict(max_slots=2, max_len=64, prefill_buckets=(16,))
    with pytest.raises(ValueError) as jerr:
        j_engine.DecodeEngine(config, jp, **base, **kw)
    with pytest.raises(ValueError) as terr:
        t_engine.DecodeEngine(_port(config), params_from_numpy(_np_tree(jp)), **base, **kw)
    assert str(terr.value) == str(jerr.value)


def test_engine_set_params_rederives_quantized_copy(setup):
    config, jp = setup
    tp = params_from_numpy(_np_tree({k: v for k, v in jp.items() if k != "vision"}))
    engine = t_engine.DecodeEngine(_port(config), tp, max_slots=2, max_len=64,
                                   prefill_buckets=(16,), weight_quant="int8")
    assert engine.params_q["layers"]["q_w"].dtype == torch.int8
    doubled = dict(tp, layers={k: v * 2 for k, v in tp["layers"].items()})
    engine.set_params(doubled)
    _equal(engine.params_q["layers"]["q_w_scale"],
           (tq.quantize_weight(doubled["layers"]["q_w"])[1]).numpy())
    qtree = tq.quantize_decode_params(tp)
    engine.set_params(qtree)                   # single-copy mid-flight
    assert engine.params_q is None and engine.params["layers"]["q_w"].dtype == torch.int8


def test_decode_strategy_single_copy_and_vit_quant(setup):
    """single_copy_quant + vit_quant: the store holds the quantized tree and
    the engine serves it single-copy; model_update with new float weights
    quantizes again and leaves the given tree as it was; the knob without
    weight_quant raises."""
    from socioreasoner_tpu_torch.distributed.strategy import ParamStore
    from socioreasoner_tpu_torch.distributed.torch_strategies import TorchDecodeStrategy
    config, jp = setup
    tp = params_from_numpy(_np_tree(jp))
    store = ParamStore()
    strat = TorchDecodeStrategy(param_store=store)
    kw = dict(max_slots=2, max_len=64, decode_chunk=4, prefill_buckets=(16,),
              cache_dtype=torch.float32)
    strat.initialize(_port(config), tp, engine_kwargs=dict(
        kw, weight_quant="int8", single_copy_quant=True, vit_quant="int8"))
    tree = store.get("rollout")
    assert tq.params_prequantized(tree) and tq.vision_prequantized(tree["vision"])
    assert strat.engine.params_q is None
    assert tp["layers"]["q_w"].dtype == torch.float32                 # caller's tree kept
    _assert_trees_equal(tree["vision"], _np_tree(jq.quantize_vision_params(jp["vision"])))
    tp2 = {k: v for k, v in tp.items()}
    tp2["layers"] = {k: v * 0.5 for k, v in tp["layers"].items()}
    before = tp2["layers"]["q_w"].clone()
    strat.model_update(params=tp2)
    tree2 = store.get("rollout")
    assert tree2 is not tp2 and tq.params_prequantized(tree2)
    assert strat.engine.params["layers"]["q_w"].dtype == torch.int8
    assert torch.equal(tp2["layers"]["q_w"], before)
    _equal(tree2["layers"]["q_w_scale"], tq.quantize_weight(before)[1].numpy())
    outs = strat.engine.generate([t_engine.Request(
        request_id=0, prompt_ids=[5, 6, 7], sampling=SamplingParams(**_greedy(3)))])
    assert len(outs[0].output_ids) == 3
    with pytest.raises(ValueError, match="single_copy_quant"):
        TorchDecodeStrategy(param_store=ParamStore()).initialize(
            _port(config), tp, engine_kwargs=dict(kw, single_copy_quant=True))


def test_chip_smoke_quant_paths_on_cpu():
    """chip_smoke's quant_parity and main_quant paths, rehearsed at a tiny
    config on CPU tensors (the kernels' plain versions)."""
    import chip_smoke
    from socioreasoner_tpu_torch.datasets.processor import ImageProcessorConfig
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import (
        Qwen25VLConfig, TextConfig, VisionConfig)
    config = Qwen25VLConfig(
        vision=VisionConfig(depth=2, hidden_size=64, intermediate_size=120,
                            num_heads=4, out_hidden_size=64, window_size=28,
                            fullatt_block_indexes=(1,)),
        text=TextConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                        mrope_section=(2, 3, 3)))
    dev = torch.device("cpu")
    params = t_model.init_params(config, torch.Generator().manual_seed(0), device=dev)
    stats = chip_smoke.run_quant_parity(config, params, dev, max_new=6, prompt_lens=(9, 14),
                                        decode_chunk=4, figure_prompt=12)
    assert stats["failures"] == [] and stats["tokens"] == 12
    assert stats["int4_tokens"] == 6
    assert set(stats["figures"]) == {"int8w", "int8w+w8a8", "int4w"}
    img_cfg = ImageProcessorConfig(min_pixels=56 * 56, max_pixels=56 * 56 * 4,
                                   defer_patchify=True)
    keep = params["layers"]["q_w"].clone()
    outs, engine, stats = chip_smoke.run_main_path(
        config, params, dev, n_tiles=2, tile_px=96, img_cfg=img_cfg,
        buckets=(512, 1024), max_new=5, decode_chunk=4,
        engine_extra=chip_smoke.QUANT_ENGINE_KWARGS)
    assert [len(o.output_ids) for o in outs] == [5, 5]
    assert engine.caches["k"].dtype == torch.int8 and engine.params_q is None
    assert engine.params["layers"]["q_w"].dtype == torch.int8
    assert torch.equal(params["layers"]["q_w"], keep)            # bf16 tree untouched
    assert stats["image_rows"] == [18, 18] and stats["alive"]
    # int8 k/v plus f32 scales per (token, kv head): 2 x (16 + 4) bytes a row
    L, (S, Lalloc) = config.text.num_hidden_layers, engine.caches["k"].shape[1:3]
    assert stats["kv_cache_gb"] * 2**30 == L * S * Lalloc * 2 * 2 * (16 + 4)


# ------------------------------------------------- kernels on the GPU

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,Hkv,lengths", DECODE_CASES)
def test_cuda_paged_decode_int8_matches_plain(cuda, S, H, Hkv, lengths):
    """Kernel 3q against the plain version in f32 on the same codes and
    scales, at every layer of a stacked cache, row by row (bf16 output, as
    the bf16 kernel); lengths 0, 1, partial blocks and the full cache; GQA
    ratios 8, 5 and 7; 5, 6 and 32 slots; two calls bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    code, scale = t_dec.quantize_kv(torch.randn(3 * S, 512, Hkv, 128, generator=gen,
                                                device=cuda))
    kc = code.reshape(3, S, 512, Hkv, 128)
    ks = scale.reshape(3, S, 512, Hkv).transpose(-1, -2).contiguous()
    vc, vs = kc.flip(2).contiguous(), ks.flip(-1).contiguous()
    q = torch.randn(S, H, 128, generator=gen, device=cuda).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n = t_dec.paged_decode_attention_int8.launches
    for layer in range(3):
        got = t_dec.paged_decode_attention(q, kc, vc, lens, ks, vs, layer=layer)
        want = t_dec.paged_decode_attention_int8_reference(q.float(), kc, vc, lens, ks, vs,
                                                           layer=layer)
        assert_decode_rows(got, want, lens)
        assert torch.equal(t_dec.paged_decode_attention(q, kc, vc, lens, ks, vs, layer=layer),
                           got)
    assert t_dec.paged_decode_attention_int8.launches == n + 6


@pytest.mark.cuda
def test_cuda_int_matmul_padding(cuda):
    """torch._int_mm's CUDA shape rules met by zero padding: few rows, K and
    N not multiples of 8 (the ViT's 3420-wide MLP)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randint(-127, 128, (5, 3420), generator=gen, device=cuda, dtype=torch.int8)
    b = torch.randint(-127, 128, (3420, 12), generator=gen, device=cuda, dtype=torch.int8)
    want = a.cpu().long() @ b.cpu().long()
    assert torch.equal(tq.int_matmul(a, b).cpu().long(), want)
