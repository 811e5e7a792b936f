"""The port's serving plane over several devices against the JAX package's.

The JAX side runs on the test run's 8 virtual CPU devices (a tp = 2 mesh,
as tests/test_decode_tp.py builds it), with Pallas in interpret mode; the
port side on device lists of `cpu` entries (the kernels' plain versions):

  * flash_attention_tp and paged_decode_attention_tp (bf16 and int8 KV)
    against JAX's and against the port's unsharded calls;
  * the spec tables of parallel/sharding.py key by key, and shard_params's
    shards concatenated back bit for bit;
  * the tensor-parallel DecodeEngine's greedy tokens against JAX's tp = 2
    engine with bf16 weights, int8 weights and an int8 KV cache (prefix fork
    included), and with int4 weights (whole and split row-parallel leaves,
    teacher-forced logits against the unsharded int4 engine);
  * the decode replicas' tp x dp composition and its refusals,
    LocalGenerateGroup over two replicas, the infer pipeline with dp_size 2
    against JAX's, the train pipeline's replicas;
  * distributed/transfer.py;
  * chip_smoke's parallel phase rehearsed at a tiny config.
"""

import dataclasses
import functools
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.distributed import transfer as j_transfer
from socioreasoner_tpu.generation import engine as j_engine
from socioreasoner_tpu.generation.sampling import SamplingParams as JSampling
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.ops import decode_attention as j_da
from socioreasoner_tpu.ops import flash_attention as j_fa
from socioreasoner_tpu.ops import quant as j_quant
from socioreasoner_tpu.parallel import mesh as j_mesh
from socioreasoner_tpu.parallel import sharding as j_sharding
from socioreasoner_tpu.runtime.generate_scheduler import LocalGenerateGroup as JGroup
from socioreasoner_tpu_torch.distributed import transfer
from socioreasoner_tpu_torch.generation import engine as t_engine
from socioreasoner_tpu_torch.generation.sampling import SamplingParams
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.ops import decode_attention as t_da
from socioreasoner_tpu_torch.ops import flash_attention as t_fa
from socioreasoner_tpu_torch.ops import quant as t_quant
from socioreasoner_tpu_torch.parallel import mesh as t_mesh
from socioreasoner_tpu_torch.parallel import sharding as t_sharding
from socioreasoner_tpu_torch.protocol import BatchProto
from socioreasoner_tpu_torch.runtime.generate_scheduler import LocalGenerateGroup
from tests.test_torch_engine import _port

CPU = torch.device("cpu")
TP2 = [CPU, CPU]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x, np.float32)).to(dtype)


def _heads(x: torch.Tensor, dim: int) -> list:
    """x cut into TP2's contiguous head blocks along `dim`."""
    return [part.contiguous() for part in x.chunk(len(TP2), dim=dim)]


# ------------------------------------------------------------------ the tp ops

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_tp_matches_jax(dtype):
    """Kernel 2 on each shard's contiguous GQA block against JAX's
    shard_map (Pallas interpret) and the port's unsharded call."""
    B, L, H, Hkv, D = 2, 96, 4, 2, 64
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((B, L, h, D)).astype(np.float32) for h in (H, Hkv, Hkv))
    mask = np.ones((B, L), np.int32)
    mask[0, 40:] = 0
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = j_fa.flash_attention_tp(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                   jnp.asarray(mask), mesh=j_mesh.make_mesh(tp=2),
                                   causal=True, interpret=True)
    tq, tk, tv = (_t(x, tdt) for x in (q, k, v))
    parts = t_fa.flash_attention_tp(*(_heads(x, 2) for x in (tq, tk, tv)),
                                    torch.as_tensor(mask), devices=TP2)
    assert len(parts) == 2 and parts[0].shape == (B, L, H // 2, D)
    got = torch.cat(parts, dim=2)
    whole = t_fa.flash_attention(tq, tk, tv, torch.as_tensor(mask))
    tol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(got, whole, rtol=0, atol=1e-6 if dtype == "f32" else 0)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_decode_attention_tp_matches_jax(kv):
    """Kernels 3 / 3q on each shard's local cache (and scales) at two layers
    (the second) of a stacked cache, against JAX's shard_map (Pallas interpret) and the
    port's unsharded call; a zero-length slot gives 0."""
    S, H, Hkv, D, Lmax, Lyr = 3, 4, 2, 128, 256, 2
    rng = np.random.default_rng(0 if kv == "bf16" else 1)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    kf, vf = (rng.standard_normal((Lyr, S, Lmax, Hkv, D)).astype(np.float32) for _ in range(2))
    lengths = np.array([200, 17, 0], np.int32)
    jmesh = j_mesh.make_mesh(tp=2)
    for layer in (1,):
        if kv == "int8":
            (kq, ks), (vq, vs) = (j_da.quantize_kv(jnp.asarray(x)) for x in (kf, vf))
            ks_t, vs_t = jnp.swapaxes(ks, -1, -2), jnp.swapaxes(vs, -1, -2)
            want = j_da.paged_decode_attention_tp(jnp.asarray(q), kq, vq, jnp.asarray(lengths),
                                                  ks_t, vs_t, mesh=jmesh, layer=layer,
                                                  interpret=True)
            args = (_t(q), torch.as_tensor(np.asarray(kq)), torch.as_tensor(np.asarray(vq)),
                    torch.as_tensor(lengths), _t(ks_t), _t(vs_t))
            tol = 1e-5
        else:
            jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, kf, vf)]
            want = j_da.paged_decode_attention_tp(*jb, jnp.asarray(lengths), mesh=jmesh,
                                                  layer=layer, interpret=True)
            args = (*(_t(x, torch.bfloat16) for x in (q, kf, vf)), torch.as_tensor(lengths))
            tol = 2e-2
        q_t, k_t, v_t, len_t, *scales = args
        shards = [_heads(q_t, 1), _heads(k_t, 3), _heads(v_t, 3), len_t,
                  *(_heads(sc, 2) for sc in scales)]
        got = torch.cat(t_da.paged_decode_attention_tp(*shards, devices=TP2, layer=layer),
                        dim=1)
        whole = t_da.paged_decode_attention(*args, layer=layer)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
        torch.testing.assert_close(got, whole, rtol=0, atol=1e-6)
        assert not got[2].any()


def test_tp_ops_refuse_indivisible_heads(engine_setup):
    """tp must divide the heads and the kv heads: the engine, which splits
    them, refuses it with the message of JAX's engine and tp ops; the tp ops
    take one block a device."""
    config, jp = engine_setup
    t = config.text
    kw = dict(max_slots=2, max_len=32, prefill_buckets=(16,))
    with pytest.raises(ValueError, match="divide heads") as e:
        t_engine.DecodeEngine(_port(config), params_from_numpy(_np_tree(jp), "cpu"),
                              mesh=[CPU] * 4, **kw)
    with pytest.raises(ValueError) as je:
        j_engine.DecodeEngine(config, jp, mesh=j_mesh.make_mesh(tp=4), **kw)
    with pytest.raises(ValueError) as jop:
        shape = (2, 256, t.num_key_value_heads, 128)
        j_da.paged_decode_attention_tp(jnp.zeros((2, t.num_attention_heads, 128)),
                                       jnp.zeros(shape), jnp.zeros(shape),
                                       jnp.ones(2, jnp.int32), mesh=j_mesh.make_mesh(tp=4))
    assert str(e.value) == str(je.value) == str(jop.value)
    q, k = torch.zeros((2, 2, 128)), torch.zeros((2, 256, 1, 128))
    with pytest.raises(ValueError, match=r"\[1, 1, 1\] shards for 2 devices"):
        t_da.paged_decode_attention_tp([q], [k], [k], torch.ones(2, dtype=torch.int32),
                                       devices=TP2)
    with pytest.raises(ValueError, match=r"\[2, 2, 2, 2, 1\] shards for 2 devices"):
        t_da.paged_decode_attention_tp([q] * 2, [k] * 2, [k] * 2,
                                       torch.ones(2, dtype=torch.int32), [k] * 2, [k],
                                       devices=TP2)
    with pytest.raises(ValueError, match=r"\[2, 1, 2\] shards for 2 devices"):
        t_fa.flash_attention_tp([torch.zeros((1, 8, 2, 64))] * 2, [torch.zeros((1, 8, 1, 64))],
                                [torch.zeros((1, 8, 1, 64))] * 2, devices=TP2)


def test_decode_wrapper_ignores_the_strides_of_size_one_dims():
    """A one-kv-head scale made contiguous from a transposed view keeps
    stride 1 on its size-1 head dim (torch calls it contiguous); the
    wrapper reads the contiguous value there, so the tp shard's int8 cache
    passes its row checks."""
    s = torch.zeros((3, 4, 256, 1)).transpose(-1, -2).contiguous()
    assert s.stride() == (1024, 256, 1, 1) and s.is_contiguous()
    assert t_da._strides(s) == (1024, 256, 256, 1)
    t_da._check_tensors("x", True, torch.zeros((4, 8, 128), dtype=torch.bfloat16),
                        (torch.zeros((3, 4, 256, 1, 128), dtype=torch.int8),) * 2, (s, s))


# ------------------------------------------------------------ mesh and specs

@pytest.mark.parametrize("knobs", [dict(tp=2), dict(dp=2, tp=2), dict(fsdp=2, sp=2),
                                   dict(pp=2, tp=2, dp=2)])
def test_make_mesh_matches_jax(knobs):
    """The same axis names and sizes, and the same device at every grid
    position (devices by index); too few devices refused alike."""
    jm = j_mesh.make_mesh(**knobs)
    devs = [torch.device("cpu", i) for i in range(8)]
    tm = t_mesh.make_mesh(**knobs, devices=devs)
    assert tm.shape == dict(jm.shape)
    ids = np.vectorize(lambda d: d.id)(np.array(jm.devices))
    np.testing.assert_array_equal(np.vectorize(lambda d: d.index)(tm.devices), ids)
    assert tm.axis_devices("tp") == [devs[i] for i in ids.reshape(-1, knobs.get("tp", 1))[0]]
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        t_mesh.make_mesh(dp=16, devices=devs)
    assert t_mesh.auto_mesh(tp=2, devices=devs).shape == dict(j_mesh.auto_mesh(8, tp=2).shape)


@functools.lru_cache(maxsize=None)
def _trees(case):
    """(JAX tree, port tree) of one layout: float with the ViT, int8 and int4
    quantized decode stacks, a tied head quantized, an MoE family."""
    if case == "moe":
        from socioreasoner_tpu.models import llm as j_llm
        config = j_llm.config_from_hf_dict({
            "model_type": "qwen2_moe", "vocab_size": 256, "hidden_size": 32,
            "intermediate_size": 64, "moe_intermediate_size": 16,
            "shared_expert_intermediate_size": 48, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 2, "num_experts": 4,
            "num_experts_per_tok": 2})
        jp = j_model.init_params(config, jax.random.key(3), dtype=jnp.float32, with_vision=False)
    else:
        config = Qwen25VLConfig.tiny()
        if case == "tied_int8":
            config = dataclasses.replace(config, text=dataclasses.replace(
                config.text, tie_word_embeddings=True))
        jp = j_model.init_params(config, jax.random.key(3), dtype=jnp.float32,
                                 with_vision=case == "float")
    if case in ("int8", "int4", "tied_int8"):
        jp = j_quant.quantize_decode_params(jp, mode="int4" if case == "int4" else "int8")
        if case == "int8":
            jp["vision"] = j_quant.quantize_vision_params(
                j_model.init_params(Qwen25VLConfig.tiny(), jax.random.key(4),
                                    dtype=jnp.float32)["vision"])
    return config, jp, params_from_numpy(_np_tree(jp), "cpu")


def _spec_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, prefix + (k,))
    else:
        yield prefix, tuple(tree)


LAYOUTS = ["float", "int8", "int4", "tied_int8", "moe"]


@pytest.mark.parametrize("case", LAYOUTS)
def test_param_specs_match_jax(case):
    """param_specs gives the JAX package's spec for every key of every
    layout (the MoE expert stacks over tp, the vocab-split embed and head,
    nibble-packed int4 and unknown keys replicated)."""
    _, jp, tp = _trees(case)
    want = dict(_spec_leaves(j_sharding.param_specs(jp)))
    got = dict(_spec_leaves(t_sharding.param_specs(tp)))
    assert got == want
    assert any("tp" in spec for spec in got.values())


@pytest.mark.parametrize("case", LAYOUTS)
def test_shards_concatenate_back(case):
    """shard_params cuts each tp leaf into contiguous blocks, one a device,
    and the blocks concatenate back bit for bit; a column-parallel int8
    weight's scale is cut with its output channels, a row-parallel one's is
    whole on each shard; a column-parallel int4 weight's codes and group
    scales are cut on the output channels, a row-parallel one (one scale
    group over the tiny config's contraction dim) and the int4 head whole."""
    _, _, tp = _trees(case)
    shards = t_sharding.shard_params(tp, TP2)
    specs = t_sharding.shard_specs(tp, len(TP2))
    leaves = [transfer.tree_leaves_with_path(t) for t in (tp, specs, *shards)]
    for (path, whole), (_, spec), *parts in zip(*leaves):
        parts = [p for _, p in parts]
        if "tp" in spec:
            assert torch.equal(torch.cat(parts, dim=list(spec).index("tp")), whole), path
        else:
            assert all(torch.equal(p, whole) for p in parts), path
    layers0, layers1 = shards[0]["layers"], shards[1]["layers"]
    full = tp["layers"]
    if case == "int8":
        q, qs = full["q_w"], full["q_w_scale"]
        assert torch.equal(layers1["q_w"], q[..., q.shape[-1] // 2:])
        assert torch.equal(layers1["q_w_scale"], qs[..., qs.shape[-1] // 2:])
        assert torch.equal(layers1["o_w_scale"], full["o_w_scale"])
        assert layers1["o_w"].shape[-2] == full["o_w"].shape[-2] // 2
        assert torch.equal(shards[1]["lm_head_scale"],
                           tp["lm_head_scale"][tp["lm_head_scale"].shape[-1] // 2:])
        blk = shards[1]["vision"]["blocks"]
        assert blk["qkv_w_scale"].shape[-1] == tp["vision"]["blocks"]["qkv_w_scale"].shape[-1] // 2
    if case == "int4":
        q, qs = full["q_w"], full["q_w_scale"]
        assert q.dtype == torch.uint8
        assert torch.equal(layers1["q_w"], q[..., q.shape[-1] // 2:])
        assert torch.equal(layers1["q_w_scale"], qs[..., qs.shape[-1] // 2:])
        assert full["o_w_scale"].shape[-2] == 1
        assert torch.equal(layers1["o_w"], full["o_w"])
        assert torch.equal(shards[1]["lm_head"], tp["lm_head"])
    if case == "tied_int8":
        assert shards[1]["lm_head_q"].shape[-1] == tp["lm_head_q"].shape[-1] // 2
        assert shards[1]["embed"].shape[0] == tp["embed"].shape[0] // 2
    if case == "moe":
        assert layers0["gate_w"].shape[1] == full["gate_w"].shape[1] // 2
        assert torch.equal(layers0["router_w"], full["router_w"])
    for s in (layers0, layers1):
        assert all(t.is_contiguous() for t in s.values())


# --------------------------------------------------------- the tp engine

@pytest.fixture(scope="module")
def engine_setup():
    config = Qwen25VLConfig.tiny()
    jp = j_model.init_params(config, jax.random.key(7), dtype=jnp.float32, with_vision=False)
    return config, jp


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX cache path as it runs on the TPU (use_flash): prefill attends
    over the raw k/v through the Pallas kernel (interpret mode) on each tp
    shard, as the port's kernels' route does."""
    from socioreasoner_tpu.ops import flags
    monkeypatch.setattr(j_fa, "flash_attention", functools.partial(j_fa.flash_attention,
                                                                   interpret=True))
    monkeypatch.setattr(flags, "use_flash_attention", lambda explicit=None: True)


TP_ENGINE_CASES = {"bf16": dict(), "int8_weights": dict(weight_quant="int8"),
                   "int8_kv": dict(kv_quant="int8")}


@pytest.mark.parametrize("case", sorted(TP_ENGINE_CASES))
def test_tp_engine_greedy_matches_jax(engine_setup, jax_flash, case):
    """The port's tp = 2 engine against JAX's tp = 2 engine on the same
    requests (a duplicate prompt forks its leader's rows): the same greedy
    tokens, finish reasons, steps and forks; and the same tokens as the
    port's unsharded engine. Weights bf16 for "bf16", else f32."""
    config, jp = engine_setup
    kw = dict(max_slots=3, max_len=64, decode_chunk=4, prefill_buckets=(16, 32),
              **TP_ENGINE_CASES[case])
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if case == "bf16" else (jnp.float32,
                                                                      torch.float32)
    jtree = jax.tree.map(lambda x: x.astype(jdt), jp)
    ttree = params_from_numpy(_np_tree(jax.tree.map(lambda x: x.astype(jnp.float32), jtree)),
                              "cpu")
    ttree = jax.tree.map(lambda x: x.to(tdt), ttree)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 200, size=n).tolist() for n in (5, 9, 14)]
    specs = [(0, prompts[0], 7), (1, prompts[1], 3), (2, prompts[2], 9), (3, prompts[0], 6)]
    je = j_engine.DecodeEngine(config, jtree, mesh=j_mesh.make_mesh(tp=2), sampler_exact=True,
                               cache_dtype=jdt, **kw)
    te = t_engine.DecodeEngine(_port(config), ttree, mesh=TP2, cache_dtype=tdt, **kw)
    ue = t_engine.DecodeEngine(_port(config), ttree, cache_dtype=tdt, **kw)
    assert je.tp is not None and te.tp == TP2
    assert te.caches[0]["k"].shape[3] == config.text.num_key_value_heads // 2
    jo = je.generate([j_engine.Request(request_id=i, prompt_ids=p,
                                       sampling=JSampling(temperature=0.0, do_sample=False,
                                                          max_new_tokens=m))
                      for i, p, m in specs])
    outs = [e.generate([t_engine.Request(request_id=i, prompt_ids=p, sampling=SamplingParams(
        temperature=0.0, do_sample=False, max_new_tokens=m)) for i, p, m in specs])
        for e in (te, ue)]
    assert [o.output_ids for o in outs[0]] == [o.output_ids for o in jo]
    assert [o.output_ids for o in outs[1]] == [o.output_ids for o in jo]
    assert [o.finish_reason for o in outs[0]] == [o.finish_reason for o in jo]
    assert te.steps_executed == je.steps_executed
    assert (te.prefill_rows, te.forked_requests) == (je.prefill_rows, je.forked_requests) \
        == (3, 1)


def _wide_config():
    """The tiny config at widths whose int4 row-parallel leaves split: o_proj's
    256 and down_proj's 512 contraction rows are 2 and 4 scale groups of 128."""
    config = Qwen25VLConfig.tiny()
    return dataclasses.replace(config, text=dataclasses.replace(
        config.text, hidden_size=256, intermediate_size=512, head_dim=64,
        mrope_section=(8, 12, 12)))


@pytest.mark.parametrize("case", ["whole", "split"])
def test_tp_engine_int4_matches_jax(jax_flash, case):
    """int4 weights under tp = 2: the port's engine on a `cpu` device list
    against JAX's GSPMD engine over 2 virtual devices (weight_quant="int4",
    its uint8 leaves replicated), the same greedy tokens, and against the
    port's unsharded int4 engine, the same tokens and, teacher-forced along
    them, logits within 1e-4 (f32 partial sums). "whole": the tiny config,
    whose row-parallel leaves are one scale group (each shard holds them
    whole and multiplies its rows); "split": _wide_config, whose shards hold
    their own packed rows and groups."""
    import chip_smoke
    config = Qwen25VLConfig.tiny() if case == "whole" else _wide_config()
    jp = j_model.init_params(config, jax.random.key(11), dtype=jnp.float32, with_vision=False)
    tree = params_from_numpy(_np_tree(jp), "cpu")
    kw = dict(max_slots=3, max_len=64, decode_chunk=4, prefill_buckets=(16, 32),
              weight_quant="int4")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 200, size=n).tolist() for n in (6, 11, 15)]
    je = j_engine.DecodeEngine(config, jp, mesh=j_mesh.make_mesh(tp=2), sampler_exact=True,
                               cache_dtype=jnp.float32, **kw)
    want = je.generate([j_engine.Request(request_id=i, prompt_ids=p, sampling=JSampling(
        temperature=0.0, do_sample=False, max_new_tokens=7)) for i, p in enumerate(prompts)])
    engines = [t_engine.DecodeEngine(_port(config), tree, mesh=mesh, cache_dtype=torch.float32,
                                     **kw) for mesh in (TP2, None)]
    outs = [e.generate([t_engine.Request(i, p, SamplingParams(
        temperature=0.0, do_sample=False, max_new_tokens=7)) for i, p in enumerate(prompts)])
        for e in engines]
    tokens = [list(o.output_ids) for o in want]
    assert [list(o.output_ids) for o in outs[0]] == tokens
    assert [list(o.output_ids) for o in outs[1]] == tokens
    requests = [{"prompt_ids": p, "image_embeds": None, "position_ids": None} for p in prompts]
    tp_rows, ref_rows = (chip_smoke._forced_logits(e, requests, tokens) for e in engines)
    for a, b in zip(tp_rows, ref_rows):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    shard, whole = engines[0].params_q[1]["layers"], engines[1].params_q["layers"]
    for key in ("o_w", "down_w"):
        rows = whole[key].shape[-2] // (2 if case == "split" else 1)
        assert shard[key].dtype == torch.uint8 and shard[key].shape[-2] == rows, key
        assert shard[key + "_scale"].shape[-2] == whole[key + "_scale"].shape[-2] * rows \
            // whole[key].shape[-2], key
    assert shard["q_w"].shape[-1] == whole["q_w"].shape[-1] // 2


def test_tp_engine_refusals(engine_setup):
    """mesh and device are exclusive (JAX's message), tp must divide the
    heads; int4 weights are served under tp (their HYBRID copy sharded);
    set_params re-shards and takes per-shard trees; a one-device mesh is a
    plain engine."""
    config, jp = engine_setup
    tree = params_from_numpy(_np_tree(jp), "cpu")
    pc = _port(config)
    kw = dict(max_slots=2, max_len=32, prefill_buckets=(16,))
    with pytest.raises(ValueError) as e:
        t_engine.DecodeEngine(pc, tree, mesh=TP2, device=CPU, **kw)
    with pytest.raises(ValueError) as je:
        j_engine.DecodeEngine(config, jp, mesh=j_mesh.make_mesh(tp=2),
                              device=jax.devices()[0], **kw)
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="divide heads"):
        t_engine.DecodeEngine(pc, tree, mesh=[CPU] * 4, **kw)
    int4 = t_engine.DecodeEngine(pc, tree, mesh=TP2, weight_quant="int4", **kw)
    assert len(int4.params_q) == 2 and int4.params_q[1]["layers"]["q_w"].dtype == torch.uint8
    one = t_engine.DecodeEngine(pc, tree, mesh=t_mesh.make_mesh(tp=1, devices=[CPU]), **kw)
    assert one.tp is None and isinstance(one.caches, dict)
    eng = t_engine.DecodeEngine(pc, tree, mesh=t_mesh.make_mesh(tp=2, devices=TP2), **kw)
    new = jax.tree.map(lambda x: x * 2, tree)
    eng.set_params(new)
    assert torch.equal(eng.params[1]["layers"]["q_w"], new["layers"]["q_w"].chunk(2, -1)[1])
    shards = t_sharding.shard_params(tree, TP2)
    eng.set_params(shards)
    assert eng.params[0] is shards[0]
    with pytest.raises(ValueError, match="per-shard"):
        eng.set_params(shards[:1])


# ------------------------------------------------------------ the replicas

def _infer_cfg(out_dir, **strategy_config):
    from socioreasoner_tpu.configs.rlvr_config import SocioSegConfig as JConfig
    from socioreasoner_tpu_torch.configs.rlvr_config import SocioSegConfig
    out = []
    for cls in (JConfig, SocioSegConfig):
        cfg = cls(output_dir=out_dir, rollout_batch_size=2, prompt_length=640,
                  response_length=24, save_steps=-1, track_with="stdout")
        cfg.actor_infer.strategy_args.strategy_name = "jax_decode"
        cfg.actor_infer.strategy_args.strategy_config = dict(strategy_config)
        out.append(cfg)
    return out


@pytest.mark.parametrize("knobs,mapping,n,want", [
    (dict(dp_size=2, tensor_model_parallel_size=2), None, 4, [2, 2]),
    (dict(dp_size=2, tensor_model_parallel_size=2), [0, 1, 2], 8, None),
    (dict(tensor_model_parallel_size=2), None, 2, [2]),
    (dict(dp_size=3), None, 2, [1, 1, 1]),
    (dict(dp_size=2), [1, 0], 8, [1, 1]),
])
def test_builder_composes_tp_dp(engine_setup, tmp_path, knobs, mapping, n, want):
    """_build_decode_replicas lays dp tensor-parallel engines over disjoint
    tp device groups, or pins replica r to devices[r % n]; dp x tp beyond the
    (mapped) devices raises JAX's error."""
    from socioreasoner_tpu.pipeline.rlvr import socioseg_pipeline as j_sp
    from socioreasoner_tpu_torch.distributed.strategy import ParamStore
    from socioreasoner_tpu_torch.pipeline.rlvr import socioseg_pipeline as t_sp
    config, jp = engine_setup
    jcfg, tcfg = _infer_cfg(str(tmp_path), **knobs)
    for cfg in (jcfg, tcfg):
        cfg.actor_infer.device_mapping = mapping
    devices = [torch.device("cpu", i) for i in range(n)]
    store = ParamStore()
    store.put("rollout", params_from_numpy(_np_tree(jp), "cpu"))
    kw = dict(max_slots=2, max_len=32, prefill_buckets=(16,))
    if want is None:
        from socioreasoner_tpu.distributed.strategy import ParamStore as JStore
        jstore = JStore()
        jstore.put("rollout", jp)
        with pytest.raises(ValueError) as je:
            j_sp._build_decode_replicas(jcfg, config, jstore, kw)
        with pytest.raises(ValueError) as e:
            t_sp._build_decode_replicas(tcfg, _port(config), store, kw, devices)
        assert str(e.value) == str(je.value)
        return
    reps = t_sp._build_decode_replicas(tcfg, _port(config), store, kw, devices)
    assert [len(r.engine.tp or [r.engine.device]) for r in reps] == want
    if len(reps) > 1 and reps[0].engine.tp:
        assert not set(reps[0].engine.tp) & set(reps[1].engine.tp)
    if len(reps) > 1 and not reps[0].engine.tp:
        mapped = [devices[i] for i in mapping] if mapping else devices
        assert [r.engine.device for r in reps] == [mapped[i % len(mapped)]
                                                   for i in range(len(reps))]


class _Echo:
    """A decode worker answering each row with its index and rows of varied
    length, in both packages' batch API."""

    def __init__(self, tag):
        self.tag = tag
        self.seen = []

    def generate(self, batch, generating_args):
        ids = np.asarray(batch.batch["input_ids"])
        self.seen.append((len(ids), len(batch.meta.get("image_embeds_list") or [])))
        n = generating_args.num_return_sequences
        width = ids.shape[1] + 2 + self.tag
        out = np.zeros((len(ids) * n, width), np.int64)
        for i in range(len(ids) * n):
            out[i, :ids.shape[1]] = ids[i // n]
            out[i, ids.shape[1]:] = 100 + self.tag
        return out


def test_local_generate_group_splits_like_jax():
    """Five rows over two replicas: each replica's chunk and its image
    embeddings, the threads' outputs re-padded to the widest and
    concatenated in order, as the JAX package's group does."""
    from socioreasoner_tpu.protocol import BatchProto as JBatch
    ids = np.arange(5 * 4).reshape(5, 4)
    embeds = [f"img{i}" for i in range(5)]
    ga = SimpleNamespace(num_return_sequences=2)
    outs = []
    for group_cls, batch_cls in ((JGroup, JBatch), (LocalGenerateGroup, BatchProto)):
        workers = [_Echo(0), _Echo(3)]
        batch = batch_cls.from_dict(tensors={"input_ids": ids},
                                    meta={"image_embeds_list": embeds, "pad_token_id": 7})
        outs.append((group_cls(workers).generate(batch, ga), [w.seen for w in workers]))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    assert outs[1][1] == outs[0][1] == [[(3, 3)], [(2, 2)]]
    assert outs[1][0].shape == (10, 4 + 5) and (outs[1][0][:6, -3:] == 7).all()


@pytest.fixture(scope="module")
def dp_pipelines(tmp_path_factory):
    """(JAX, port) infer pipelines with actor_infer dp_size 2 at greedy on
    tests/test_torch_pipeline.py's tiny world: JAX's replicas on two of the
    virtual devices, the port's on [cpu, cpu]."""
    from socioreasoner_tpu.configs.rlvr_config import SocioSegConfig as JConfig
    from socioreasoner_tpu.datasets import socioseg as j_seg
    from socioreasoner_tpu.datasets.processor import (ImageProcessorConfig as JImageConfig,
                                                      SimpleTokenizer as JTokenizer,
                                                      SocioProcessor as JProcessor)
    from socioreasoner_tpu.models.sam2 import model as j_sam
    from socioreasoner_tpu.models.sam2.config import Sam2Config as JSam2Config
    from socioreasoner_tpu.pipeline.rlvr.socioseg_infer_pipeline import (
        SocioSegInferPipeline as JPipeline)
    from socioreasoner_tpu_torch.configs.rlvr_config import SocioSegConfig
    from socioreasoner_tpu_torch.datasets import processor as t_processor
    from socioreasoner_tpu_torch.datasets import socioseg as t_seg
    from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
    from socioreasoner_tpu_torch.pipeline.rlvr.socioseg_infer_pipeline import (
        SocioSegInferPipeline)
    from tests import test_torch_pipeline as tpl

    def cfg(cls, side):
        c = tpl._config(cls, str(tmp_path_factory.mktemp(side)))
        c.actor_infer.strategy_args.strategy_name = "jax_decode"
        c.actor_infer.strategy_args.strategy_config = {"dp_size": 2}
        return c

    config = Qwen25VLConfig.tiny(tpl.VOCAB)
    jq = j_model.init_params(config, jax.random.key(0), dtype=jnp.float32)
    sam_np = _np_tree(jax.jit(functools.partial(j_sam.init_params, JSam2Config.tiny_test()))(
        jax.random.key(1)))
    jimg, timg = JImageConfig(**tpl.IMG), t_processor.ImageProcessorConfig(**tpl.IMG)
    jpipe = JPipeline(
        cfg(JConfig, "jax"), model_config=config, policy_params=jq,
        sam_config=JSam2Config.tiny_test(), sam_params=jax.tree.map(jnp.asarray, sam_np),
        processor=JProcessor(tpl._tokenizer(JTokenizer), jimg,
                             image_token_id=config.image_token_id),
        dataset=[j_seg.encode_sample(t, jimg) for t in tpl._tiles()],
        engine_kwargs={**tpl.ENGINE, "cache_dtype": jnp.float32, "sampler_exact": True})
    tpipe = SocioSegInferPipeline(
        cfg(SocioSegConfig, "port"), model_config=_port(config),
        policy_params=params_from_numpy(_np_tree(jq), "cpu"),
        sam_config=Sam2Config.tiny_test(), sam_params=params_from_numpy(sam_np, "cpu"),
        processor=t_processor.SocioProcessor(tpl._tokenizer(t_processor.SimpleTokenizer),
                                             timg, image_token_id=config.image_token_id),
        dataset=[t_seg.encode_sample(t, timg) for t in tpl._tiles()],
        engine_kwargs={**tpl.ENGINE, "cache_dtype": torch.float32}, devices=TP2)
    return jpipe, tpipe


def test_infer_pipeline_dp2_matches_jax(dp_pipelines):
    """dp_size 2 builds two replicas on both sides; the sequential pass (the
    group's split batch generate) and run() (least-loaded streaming over
    both replicas) give JAX's texts, masks, files and iou_acc.txt."""
    jpipe, tpipe = dp_pipelines
    assert len(tpipe.decode_replicas) == len(jpipe.decode_replicas) == 2
    assert len(tpipe.decode_group.workers) == 2
    rows = tpipe.dataset
    jo, to = jpipe._two_stage_sequential(jpipe.dataset), tpipe._two_stage_sequential(rows)
    for key in ("map_texts", "sat_texts", "bbox_texts"):
        assert to[key] == jo[key], key
    for a, b in zip(to["s2_masks"], jo["s2_masks"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tpipe.run() == jpipe.run()
    for sub in ("stage1", "stage2"):
        for name in sorted(os.listdir(os.path.join(jpipe.result_dir, sub))):
            with open(os.path.join(jpipe.result_dir, sub, name), "rb") as f:
                want = f.read()
            with open(os.path.join(tpipe.result_dir, sub, name), "rb") as f:
                assert f.read() == want, (sub, name)
    with open(os.path.join(jpipe.result_dir, "iou_acc.txt")) as f:
        want = f.read()
    with open(os.path.join(tpipe.result_dir, "iou_acc.txt")) as f:
        assert f.read() == want
    assert all(rep.engine.prefill_rows > 0 for rep in tpipe.decode_replicas)


def test_pipelines_refuse_replicas_beyond_the_devices(tmp_path):
    """validate_config counts the pipeline's device list: dp_size 2 over one
    device raises JAX's message, over two it builds (the train pipeline
    too, its replicas sharing the param store)."""
    from socioreasoner_tpu.configs.validation import validate_config as j_validate
    from socioreasoner_tpu_torch.configs.validation import validate_config
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
    from socioreasoner_tpu_torch.models.sam2 import model as t_sam
    from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
    from socioreasoner_tpu_torch.pipeline.rlvr.socioseg_pipeline import SocioSegPipeline
    from tests import test_torch_pipeline as tpl
    jcfg, tcfg = _infer_cfg(str(tmp_path), dp_size=2)
    with pytest.raises(ValueError) as je:
        j_validate(jcfg, n_devices=1)
    with pytest.raises(ValueError) as e:
        validate_config(tcfg, n_devices=1)
    assert str(e.value) == str(je.value)
    config = _port(Qwen25VLConfig.tiny(tpl.VOCAB))
    params = t_model.init_params(config, torch.Generator().manual_seed(0), device="cpu")
    from socioreasoner_tpu_torch.datasets import processor as t_processor
    from socioreasoner_tpu_torch.datasets import socioseg as t_seg
    img_cfg = t_processor.ImageProcessorConfig(**tpl.IMG)
    kw = dict(model_config=config, policy_params=params, reference_params=params,
              sam_config=Sam2Config.tiny_test(),
              sam_params=t_sam.init_params(Sam2Config.tiny_test(),
                                           torch.Generator().manual_seed(1), device="cpu"),
              processor=t_processor.SocioProcessor(tpl._tokenizer(t_processor.SimpleTokenizer),
                                                   img_cfg, image_token_id=config.image_token_id),
              dataset=[t_seg.encode_sample(t, img_cfg) for t in tpl._tiles()],
              engine_kwargs=dict(tpl.ENGINE))
    tcfg.num_return_sequences_in_group = 2
    tcfg.actor_infer.generating_args.num_return_sequences = 2
    with pytest.raises(ValueError, match="decode replicas exceed"):
        SocioSegPipeline(tcfg, **kw)
    pipe = SocioSegPipeline(tcfg, devices=TP2, **kw)
    assert len(pipe.decode_replicas) == 2 and pipe.devices == TP2
    assert pipe.decode_replicas[1].param_store is pipe.param_store


# ------------------------------------------------------------------ transfer

def test_leaf_buckets_match_jax():
    """The same leaves in the same order and the same bucket boundaries as
    the JAX package's (dict keys sorted, a leaf over the budget alone)."""
    rng = np.random.default_rng(0)
    tree = {"b": {"y": rng.standard_normal((100, 100)), "x": rng.standard_normal((10,))},
            "a": rng.standard_normal((200, 200)), "c": rng.standard_normal((3, 7))}
    tree = jax.tree.map(lambda x: x.astype(np.float32), tree)
    for budget in (100 * 1024, 40_000, 1 << 30):
        want = [[tuple(k.key for k in path) for path, _ in b]
                for b in j_transfer.leaf_buckets(jax.tree.map(jnp.asarray, tree), budget)]
        got = [[path for path, _ in b]
               for b in transfer.leaf_buckets(params_from_numpy(tree, "cpu"), budget)]
        assert got == want


def test_transfer_params_onto_a_tp_layout(engine_setup):
    """transfer_params onto a device equals the tree; onto a tp layout, the
    shards of shard_params; ModelUpdateGroup honours its frequency and hands
    a tp decode strategy its shards."""
    from socioreasoner_tpu_torch.distributed.strategy import ParamStore
    from socioreasoner_tpu_torch.distributed.torch_strategies import TorchDecodeStrategy
    config, jp = engine_setup
    tree = params_from_numpy(_np_tree(jp), "cpu")
    moved = transfer.transfer_params(tree, CPU, bucket_bytes=4096)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        transfer.tree_leaves_with_path(moved), transfer.tree_leaves_with_path(tree)))
    layout = t_mesh.make_mesh(tp=2, devices=TP2)
    for budget in (4096, None):
        shards = transfer.transfer_params(tree, layout, bucket_bytes=budget)
        want = t_sharding.shard_params(tree, TP2)
        for got_t, want_t in zip(shards, want):
            for (pa, a), (pb, b) in zip(transfer.tree_leaves_with_path(got_t),
                                        transfer.tree_leaves_with_path(want_t)):
                assert pa == pb and torch.equal(a, b)

    src = SimpleNamespace(params=jax.tree.map(lambda x: x + 1, tree), calls=0)
    src.model_update = lambda: setattr(src, "calls", src.calls + 1)
    tgt = TorchDecodeStrategy(param_store=ParamStore())
    tgt.initialize(_port(config), tree, engine_kwargs=dict(max_slots=2, max_len=32,
                                                            prefill_buckets=(16,)),
                   mesh=layout)
    group = transfer.ModelUpdateGroup(src, tgt, frequency=2, target_layout=layout)
    group.make_collective_group()
    for step in range(3):
        group.model_update(step)
    assert torch.equal(tgt.engine.params[1]["layers"]["v_w"],
                       src.params["layers"]["v_w"].chunk(2, -1)[1])
    plain = transfer.ModelUpdateGroup(src, SimpleNamespace(model_update=lambda: None),
                                      frequency=3)
    for step in range(4):
        plain.model_update(step)
    assert src.calls == 2


# --------------------------------------------------------- chip_smoke rehearsal

def _smoke_model():
    """The tiny config, weights and image processing of the parallel phase's
    CPU rehearsal."""
    from socioreasoner_tpu_torch.datasets import processor as t_processor
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import (
        Qwen25VLConfig as TConfig, TextConfig, VisionConfig)
    config = TConfig(
        vision=VisionConfig(depth=2, hidden_size=64, intermediate_size=128,
                            num_heads=4, out_hidden_size=64, window_size=28,
                            fullatt_block_indexes=(1,)),
        text=TextConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                        mrope_section=(2, 3, 3)))
    params = t_model.init_params(config, torch.Generator().manual_seed(0), device="cpu")
    img_cfg = t_processor.ImageProcessorConfig(min_pixels=56 * 56, max_pixels=56 * 56 * 4,
                                               defer_patchify=True)
    return config, params, img_cfg


def test_chip_smoke_parallel_phase_on_cpu():
    """chip_smoke's parallel phase at a tiny config on CPU tensors: the tp =
    2 engine against the unsharded one (bf16, then int8 weights and KV, then
    int4 weights), two
    tiles' requests, with the prefill and decode profiles; then the infer
    pipeline at dp_size 1 and 2 over two tiles, their files equal."""
    import chip_smoke
    from socioreasoner_tpu_torch.models.sam2 import model as t_sam
    from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
    config, params, img_cfg = _smoke_model()
    out = chip_smoke.run_tp_engines(config, params, CPU, TP2, img_cfg=img_cfg, tile_px=96,
                                    buckets=(512, 1024), max_new=5, decode_chunk=4,
                                    n_tiles=2, profile_len=40)
    for name in ("bf16", "int8", "int4"):
        fig = out[name]
        assert fig["equal_requests"] == 2 and not fig["tie_flips"]
        assert fig["tp_shard_cache"][3] == 1 and fig["compared_tokens"] == 10
        assert fig["max_logit_delta"] < fig["delta_limit"] == chip_smoke.TP_DELTA_LIMIT
        if name != "int4":          # the int4 engines are not profiled
            assert fig["profile"]["tp"]["decode"]["steps"] == 4
            assert fig["profile"]["tp"]["prefill"]["slots"] == 2
    sam_config = Sam2Config.tiny_test()
    sam_params = t_sam.init_params(sam_config, torch.Generator().manual_seed(1),
                                   dtype=torch.bfloat16, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        dp = chip_smoke.run_dp_pipelines(config, params, sam_config, sam_params, d, CPU, TP2,
                                         n_tiles=2, tile_px=96, img_cfg=img_cfg,
                                         prompt_length=1024, response_length=8,
                                         rollout_batch_size=2)
    assert dp["files_equal"] == 2 * 6 + 1
    # run()'s two prompts of each stage, over one replica or two
    assert dp["dp1"]["replica_prefill_rows"] == [4]
    assert dp["dp2"]["replica_prefill_rows"] == [2, 2]
    assert dp["dp1"]["giou_acc"] == dp["dp2"]["giou_acc"]


def test_tp_tie_check_rule(monkeypatch):
    """chip_smoke's tie rule for the tp engine: both engines teacher-forced
    along the unsharded tokens, every step compared. A tp argmax that differs
    where both tokens lie within max(GAP_TOL, 2 x the step's logit delta)
    of the unsharded top is a tie flip; a delta above the fixed limit fails
    though the tokens agree; the tp engine's own first divergence is held
    to the same rule."""
    import chip_smoke
    base = np.zeros(8, np.float32)
    base[[1, 2, 3]] = [5.0, 4.97, 4.5]
    moves = [[], [(1, 2, 0.04)], [(0, 3, 0.6)], []]
    rows = {"ref": [np.stack([base] * 2) for _ in moves], "tp": []}
    for m in moves:
        tp = np.stack([base] * 2)
        for step, tok, d in m:
            tp[step, tok] += d
        rows["tp"].append(tp)
    monkeypatch.setattr(chip_smoke, "_forced_logits",
                        lambda engine, requests, tokens: rows[engine])
    out = lambda ids: SimpleNamespace(output_ids=ids)   # noqa: E731
    x = [out([1, 1])] * 4
    y = [out([1, 1]), out([1, 2]), out([1, 1]), out([1, 3])]
    equal, flips, failures, compared, worst = chip_smoke.tp_tie_check(
        "ref", "tp", [{}] * 4, x, y)
    assert equal == 2 and compared == 8 and worst == pytest.approx(0.6)
    assert [(f["request"], f["step"]) for f in flips] == [(1, 1)]
    assert flips[0]["bound"] == pytest.approx(0.08)
    assert flips[0]["gaps"] == {1: 0.0, 2: pytest.approx(0.03, abs=1e-6)}
    # request 2: a delta of 0.6 > TP_DELTA_LIMIT; request 3: the tp engine's
    # own token 3 lies 0.5 below the top where the sharding moved nothing
    assert [(f["request"], f["step"]) for f in failures] == [(2, 0), (3, 1)]
    assert chip_smoke.TP_DELTA_LIMIT == 0.5


def test_tp_tie_check_fails_a_mis_sharded_tree(monkeypatch):
    """At the parallel phase's tiny CPU config, the sound tp = 2 engine
    passes tp_tie_check on every token; with its shards' blocks of o_proj,
    down_proj or the vocab-split embedding (the tied head) swapped, a
    sharding fault, every request fails the delta limit. The limit is
    TP_DELTA_LIMIT taken to this width's logits: a tied head's logits have
    an RMS of sqrt(hidden) x the embedding's std, 0.16 here, 0.9 at the
    3B's 2048."""
    import chip_smoke
    config, params, img_cfg = _smoke_model()
    limit = chip_smoke.TP_DELTA_LIMIT * (config.text.hidden_size / 2048) ** 0.5
    monkeypatch.setattr(chip_smoke, "TP_DELTA_LIMIT", limit)
    kw = dict(img_cfg=img_cfg, tile_px=96, n_tiles=2, buckets=(512, 1024), max_new=5,
              decode_chunk=4)
    keep = {}
    ref_outs, ref_engine, _ = chip_smoke.run_main_path(config, params, CPU, keep=keep, **kw)
    tp_outs, tp_engine, _ = chip_smoke.run_main_path(config, params, CPU, mesh=TP2, **kw)
    check = lambda: chip_smoke.tp_tie_check(   # noqa: E731
        ref_engine, tp_engine, keep["requests"], ref_outs, tp_outs)
    equal, flips, failures, compared, worst = check()
    assert equal == 2 and not flips and not failures and compared == 10
    assert worst < 1e-3 * limit
    a, b = tp_engine.params
    for tree_a, tree_b, key in ((a["layers"], b["layers"], "o_w"),
                                (a["layers"], b["layers"], "down_w"), (a, b, "embed")):
        tree_a[key], tree_b[key] = tree_b[key], tree_a[key]
        _, _, failures, _, worst = check()
        tree_a[key], tree_b[key] = tree_b[key], tree_a[key]
        assert worst > 2 * limit, key
        assert {f["request"] for f in failures if f["delta"] > limit} == {0, 1}, key


def test_tp_engine_moe_matches_jax(jax_flash):
    """A qwen2_moe family (experts split over the shards, the shared expert
    column/row-parallel) through the port's tp = 2 engine: JAX's tp = 2
    engine's greedy tokens, and the unsharded engine's."""
    config, jp, tree = _trees("moe")
    kw = dict(max_slots=2, max_len=48, decode_chunk=4, prefill_buckets=(16,))
    prompts = [[5, 9, 33, 2, 7], [11, 3, 8, 60, 21, 4, 9]]
    je = j_engine.DecodeEngine(config, jp, mesh=j_mesh.make_mesh(tp=2), sampler_exact=True,
                               cache_dtype=jnp.float32, **kw)
    want = je.generate([j_engine.Request(request_id=i, prompt_ids=p, sampling=JSampling(
        temperature=0.0, do_sample=False, max_new_tokens=6)) for i, p in enumerate(prompts)])
    for mesh in (TP2, None):
        eng = t_engine.DecodeEngine(_port(config), tree, mesh=mesh, cache_dtype=torch.float32,
                                    **kw)
        got = eng.generate([t_engine.Request(i, p, SamplingParams(
            temperature=0.0, do_sample=False, max_new_tokens=6)) for i, p in enumerate(prompts)])
        assert [o.output_ids for o in got] == [o.output_ids for o in want]
    assert eng.tp is None and t_engine.DecodeEngine(
        _port(config), tree, mesh=TP2, **kw).params[1]["layers"]["gate_w"].shape[1] == 2
