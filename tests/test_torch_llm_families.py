"""The port's text-only LLM families (socioreasoner_tpu_torch.models.llm over
the shared decoder, MoE layers included) against the JAX package's, on tiny
random HF models of every family models/llm.py maps: llama, mistral, qwen2,
qwen3, qwen3_moe, qwen2_moe (shared expert) and mixtral.

For each family, in float64 (the JAX side with x64 on): config_from_hf_dict
field by field; the logits of the port's forward on JAX's tree
(load_from_torch_state_dict, bridged by params_from_numpy) against JAX's
forward, 1e-6; a cached prefill plus three cached decode steps (the
kernels' plain versions on the CPU) against the port's uncached logits,
1e-6; the MoE families' moe_aux against JAX's, 1e-6 (the router computes
in float32 whatever the tree's dtype, as in JAX); load_text_model of the
HF model's save_pretrained directory against JAX's load_text_model, bit for
bit. One GRPO train step of qwen3_moe in float32 against JAX's
make_train_step (metrics rtol 1e-5, params 1e-5 of a leaf's scale), and the
list-valued eos and decoder_sparse_step cases of config_from_hf_dict.
"""

import copy
import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.distributed import trainer as JT
from socioreasoner_tpu.models import llm as j_llm
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl.loader import load_from_torch_state_dict
from socioreasoner_tpu.pipeline import losses as JL
from socioreasoner_tpu_torch.distributed import trainer as TT
from socioreasoner_tpu_torch.models import llm as t_llm
from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.pipeline import losses as TL

SMALL = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, rms_norm_eps=1e-6, tie_word_embeddings=False,
             rope_theta=10000.0)
MOE = dict(moe_intermediate_size=32, num_experts=4, num_experts_per_tok=2,
           norm_topk_prob=False, decoder_sparse_step=1, mlp_only_layers=[])
# family: (transformers config class, model class, extra config kwargs, seed)
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(intermediate_size=128), 0),
    "mistral": ("MistralConfig", "MistralForCausalLM", dict(intermediate_size=128), 6),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", dict(intermediate_size=128), 2),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(intermediate_size=128, head_dim=16), 1),
    "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM",
                  dict(intermediate_size=128, head_dim=16, **MOE), 3),
    "qwen2_moe": ("Qwen2MoeConfig", "Qwen2MoeForCausalLM",
                  dict(intermediate_size=128, shared_expert_intermediate_size=48, **MOE), 5),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(intermediate_size=32, num_local_experts=4, num_experts_per_tok=2), 4),
}


@pytest.fixture(scope="module", autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _port(obj):
    """The port's own copy of a JAX-package config dataclass, field for field."""
    mod = importlib.import_module(type(obj).__module__.replace(
        "socioreasoner_tpu.", "socioreasoner_tpu_torch.", 1))
    cls = getattr(mod, type(obj).__name__)
    return cls(**{f.name: _port(getattr(obj, f.name))
                  if dataclasses.is_dataclass(getattr(obj, f.name)) else getattr(obj, f.name)
                  for f in dataclasses.fields(obj) if f.init})


@functools.lru_cache(maxsize=None)
def _family(name):
    """(HF float64 model, its config dict, JAX config, JAX float64 tree)."""
    import transformers
    cfg_cls, model_cls, extra, seed = FAMILIES[name]
    torch.manual_seed(seed)
    cfg = getattr(transformers, cfg_cls)(**SMALL, **extra)
    model = getattr(transformers, model_cls)(cfg).double().eval()
    cfg_dict = cfg.to_dict()
    config = j_llm.config_from_hf_dict(cfg_dict)
    jp = load_from_torch_state_dict(config, model.state_dict(), jnp.float64, with_vision=False)
    return model, cfg_dict, config, jp


def _ids(seed, B=2, L=10):
    ids = np.random.default_rng(seed).integers(2, 200, size=(B, L))
    return ids, np.ones_like(ids)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_matches_jax(name, tmp_path):
    model, cfg_dict, config, jp = _family(name)
    tconfig = t_llm.config_from_hf_dict(cfg_dict)
    assert tconfig == _port(config)
    assert bool(tconfig.text.n_experts) == name.endswith(("moe", "mixtral"))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.float64)

    ids, attn = _ids(FAMILIES[name][3])
    pos = j_llm.text_position_ids(ids, attn)
    assert np.array_equal(t_llm.text_position_ids(ids, attn), pos)
    want, j_aux = j_model.forward(config, jp, jnp.asarray(ids), jnp.asarray(pos),
                                  jnp.asarray(attn))
    got, t_aux = t_model.forward(tconfig, tp, torch.as_tensor(ids), torch.as_tensor(pos),
                                 torch.as_tensor(attn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    if tconfig.text.n_experts:
        assert t_aux.keys() == j_aux.keys() == {"moe_aux"}
        np.testing.assert_allclose(t_aux["moe_aux"].item(), float(j_aux["moe_aux"]),
                                   rtol=1e-6)
    else:
        assert t_aux is None and j_aux is None

    # a cached prefill of 7 tokens, then 3 one-token steps, against the
    # uncached logits of the whole sequence
    t = tconfig.text
    B, P, Lmax = ids.shape[0], 7, 64
    shape = (t.num_hidden_layers, B, Lmax, t.num_key_value_heads, t.head_dim)
    cache = {"k": torch.zeros(shape, dtype=torch.float64),
             "v": torch.zeros(shape, dtype=torch.float64)}
    ar = torch.arange(Lmax)
    full = got
    for start, stop in ((0, P), (P, P + 1), (P + 1, P + 2), (P + 2, P + 3)):
        cache["kv_valid"] = (ar[None] < stop).int().expand(B, Lmax)
        step, cache = t_model.forward(
            tconfig, tp, torch.as_tensor(ids[:, start:stop]),
            torch.as_tensor(pos[:, :, start:stop]), cache=cache,
            cache_positions=torch.arange(start, stop)[None].expand(B, -1))
        np.testing.assert_allclose(step.numpy(), full[:, start:stop].numpy(), atol=1e-6,
                                   rtol=1e-6)

    # an HF checkpoint directory, read by both packages' load_text_model
    copy.deepcopy(model).float().save_pretrained(str(tmp_path), safe_serialization=True)
    jc, jtree = j_llm.load_text_model(str(tmp_path), dtype=jnp.float32)
    tc, ttree = t_llm.load_text_model(str(tmp_path), dtype=torch.float32, device="cpu")
    assert tc == _port(jc) == tconfig
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(flat_j) == len(jax.tree.leaves(ttree))
    for path, leaf in flat_j:
        node = ttree
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), np.asarray(leaf)), path


def test_config_from_hf_dict_eos_lists_and_refusals():
    base = {"model_type": "llama", "vocab_size": 300, "hidden_size": 64,
            "num_attention_heads": 4, "num_hidden_layers": 2, "intermediate_size": 128}
    for extra in ({"eos_token_id": [128001, 128008, 128009]}, {"eos_token_id": 7},
                  {"eos_token_id": None, "bos_token_id": None, "pad_token_id": None},
                  {"eos_token_id": [5], "pad_token_id": 0}):
        got = t_llm.config_from_hf_dict({**base, **extra})
        assert got == _port(j_llm.config_from_hf_dict({**base, **extra}))
    got = t_llm.config_from_hf_dict({**base, "eos_token_id": [128001, 128008, 128009]})
    assert (got.eos_token_id, got.stop_token_ids) == (128001, (128008, 128009))
    assert got.stop_set == {128001, 128008, 128009}
    moe = {**base, "model_type": "qwen3_moe", "num_experts": 4, "moe_intermediate_size": 32}
    for bad in ({"decoder_sparse_step": 2}, {"mlp_only_layers": [1]}):
        for pkg in (t_llm, j_llm):
            with pytest.raises(NotImplementedError, match="decoder_sparse_step"):
                pkg.config_from_hf_dict({**moe, **bad})
    # a dense family ignores the MoE knobs, as in JAX
    assert not t_llm.config_from_hf_dict({**base, "decoder_sparse_step": 2}).text.n_experts


LR = 1e-3


def _text_batch(pad_id, seed=8, B=3, L=16):
    """A right-padded GRPO batch of text tokens (no images), numpy."""
    rng = np.random.default_rng(seed)
    lens = np.array([L, L - 4, L - 7])[:B]
    ids = rng.integers(2, 200, size=(B, L))
    cols = np.arange(L)[None]
    attn = (cols < lens[:, None]).astype(np.int64)
    ids[attn == 0] = pad_id
    return {"input_ids": ids, "attention_mask": attn,
            "position_ids": t_llm.text_position_ids(ids, attn),
            "response_mask": ((cols >= 6) & (attn == 1)).astype(np.int64),
            "advantages": rng.normal(size=(B, L - 1)).astype(np.float32),
            "old_log_probs": (-np.abs(rng.normal(size=(B, L - 1))) - 5).astype(np.float32),
            "ref_log_probs": (-np.abs(rng.normal(size=(B, L - 1))) - 5).astype(np.float32)}


def test_qwen3_moe_train_step_matches_jax():
    """One GRPO step (remat, the flash path's plain versions on the CPU) from
    the same float32 tree: loss, grad norm and every PPO metric, then every
    parameter; the router and expert stacks move."""
    _, cfg_dict, _, jp64 = _family("qwen3_moe")
    config = j_llm.config_from_hf_dict(cfg_dict)
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), jp64)
    batch = _text_batch(config.pad_token_id)
    jopt = JT.make_optimizer(lr=LR, weight_decay=0.01, eps=1e-4)
    jstate, jm = jax.jit(JT.make_train_step(config, JL.PPOLossConfig(), jopt))(
        JT.TrainState.create(jax.tree.map(jnp.asarray, np_params), jopt),
        {k: jnp.asarray(v) for k, v in batch.items()})
    topt = TT.make_optimizer(lr=LR, weight_decay=0.01, eps=1e-4)
    tparams = params_from_numpy(np_params, device="cpu")
    tstate, tm = TT.make_train_step(_port(config), TL.PPOLossConfig(), topt)(
        TT.TrainState.create(tparams, topt), {k: torch.as_tensor(v) for k, v in batch.items()})
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    jnew = jax.tree.map(np.asarray, jstate.params)
    layers = tstate.params["layers"]
    for key, leaf in layers.items():
        want = jnew["layers"][key]
        scale = max(np.abs(want).max(), LR)
        assert np.abs(leaf.numpy() - want).max() <= 1e-5 * scale, key
    for key in ("router_w", "gate_w", "up_w", "down_w", "q_norm", "k_norm"):
        assert layers[key].dim() == np_params["layers"][key].ndim
        assert not np.array_equal(layers[key].numpy(), np_params["layers"][key]), key
    for key in ("embed", "final_ln", "lm_head"):
        want = jnew[key]
        assert np.abs(tstate.params[key].numpy() - want).max() <= 1e-5 * max(
            np.abs(want).max(), LR), key


TINY_QWEN3_MOE = {"model_type": "qwen3_moe", "vocab_size": 512, "hidden_size": 64,
                  "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
                  "num_key_value_heads": 2, "head_dim": 16, "rms_norm_eps": 1e-6,
                  "rope_theta": 1e6, "num_experts": 4, "num_experts_per_tok": 2,
                  "moe_intermediate_size": 32, "norm_topk_prob": True,
                  "decoder_sparse_step": 1, "mlp_only_layers": [], "eos_token_id": 500,
                  "bos_token_id": 0}


def test_chip_smoke_families_phase_on_cpu(tmp_path):
    """chip_smoke's families phase rehearsed at tiny widths on CPU tensors
    (the kernels' plain versions): a qwen3_moe and a qwen2_moe serve
    against the teacher-forced forward, the MoE train step with the flash
    path against dense, the text checkpoint round trip, and Qwen2-VL from a
    written HF checkpoint through run_main_path; a token that is not the
    forward's argmax (nor a tie) fails the check."""
    import chip_smoke
    from socioreasoner_tpu_torch.datasets.processor import ImageProcessorConfig
    from socioreasoner_tpu_torch.generation.engine import EngineOutput
    cpu = torch.device("cpu")
    for hf in (TINY_QWEN3_MOE, dict(TINY_QWEN3_MOE, model_type="qwen2_moe", norm_topk_prob=False,
                                    shared_expert_intermediate_size=48, head_dim=None)):
        config = t_llm.config_from_hf_dict(hf)
        params = t_model.init_params(config, torch.Generator().manual_seed(1), device="cpu",
                                     with_vision=False)
        stats = chip_smoke.serve_family(config, params, cpu, prompt_lens=(40, 33, 27, 20),
                                        bucket=64, max_new=6, decode_chunk=4)
        assert stats["prefill_buckets"] == [(4, 64, 0)] and stats["checked_tokens"] >= 4
        assert stats["decode_profile"]["steps"] > 0
        assert stats["cache"] == [2, 4, 256, 2, 16] and not stats["failures"]
    # a wrong token is a failure, with each layer's router gap beside it
    prompt = list(range(5, 25))
    ids = torch.as_tensor([prompt])
    pos = torch.as_tensor(t_llm.text_position_ids(ids.numpy(), np.ones_like(ids.numpy())))
    with torch.no_grad():
        logits = t_model.forward(config, params, ids, pos)[0][0, -1]
    wrong = int(torch.argsort(logits)[0])
    flips, routing, failures, checked = chip_smoke.greedy_against_forward(
        config, params, cpu, [prompt], [EngineOutput(0, prompt, [wrong], "length")])
    assert checked == 1 and not flips and len(failures) + len(routing) == 1
    record = (failures + routing)[0]
    assert record["argmax"] == int(logits.argmax()) and len(record["router_gap_ulps"]) == 2

    config = t_llm.config_from_hf_dict(TINY_QWEN3_MOE)
    params = t_model.init_params(config, torch.Generator().manual_seed(2), device="cpu",
                                 with_vision=False)
    train = chip_smoke.train_family(config, params, cpu, lens=(96, 70), steps=2)
    assert len(train["kernels"]["finite_nonzero_grads"]) == 6
    at_init = train["logprobs_at_init"]
    assert at_init["response_tokens"] == 95 + 69 and np.isfinite(list(at_init.values())).all()
    write_s, read_s, gb = chip_smoke.text_model_round_trip(config, params, TINY_QWEN3_MOE,
                                                           str(tmp_path / "moe"), cpu)
    assert gb > 0

    tiny_vl = dict(chip_smoke.QWEN2_VL_2B, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
                   vision_config=dict(chip_smoke.QWEN2_VL_2B["vision_config"], depth=2,
                                      embed_dim=64, mlp_ratio=2, num_heads=4, hidden_size=64))
    gb = chip_smoke.write_qwen2_vl_checkpoint(tiny_vl, str(tmp_path / "vl"), cpu)
    img_cfg = ImageProcessorConfig(min_pixels=56 * 56, max_pixels=56 * 56 * 4,
                                   defer_patchify=True)
    config, outs, engine, stats = chip_smoke.run_qwen2_vl(
        str(tmp_path / "vl"), cpu, img_cfg=img_cfg, n_tiles=2,
        tile_px=96, buckets=(512, 1024), max_new=5, decode_chunk=4)
    assert config.vision.variant == "qwen2" and config.text.tie_word_embeddings
    assert [len(o.output_ids) for o in outs] == [5, 5] and stats["image_rows"] == [18, 18]
    vit = stats["vit_kernel_vs_dense"]
    assert vit["full_layers"] == 2 and vit["kernel_vs_f32_max_abs"] <= 2 * vit[
        "dense_vs_f32_max_abs"] + 1e-6


class _Greedy:
    temperature, top_p, top_k, max_new_tokens = 0.0, 1.0, 0, 4
    do_sample, num_return_sequences = False, 1


def test_moe_tree_through_the_strategies():
    """An MoE tree through TorchTrainStrategy (log-probs, a train step that
    moves the 4-D expert stacks in place), model_update(snapshot=True) to a
    TorchDecodeStrategy (copy_shared gives the engine its own expert stacks)
    and a greedy rollout; weight quantization of an MoE tree raises in the
    port's engine as in JAX's."""
    from types import SimpleNamespace
    from socioreasoner_tpu.generation import engine as j_engine
    from socioreasoner_tpu_torch.distributed import torch_strategies as TS
    from socioreasoner_tpu_torch.generation.engine import DecodeEngine
    from socioreasoner_tpu_torch.ops.quant import quantize_decode_params
    from socioreasoner_tpu_torch.protocol import BatchProto

    config = t_llm.config_from_hf_dict(TINY_QWEN3_MOE)
    params = t_model.init_params(config, torch.Generator().manual_seed(5), device="cpu",
                                 with_vision=False)
    store = TS.ParamStore()
    train, decode = TS.TorchTrainStrategy(), TS.TorchDecodeStrategy()
    train.initialize(config, params, TL.PPOLossConfig(), param_store=store,
                     training_args=SimpleNamespace(learning_rate=LR))
    train.model_update()
    decode.initialize(config, param_store=store, engine_kwargs=dict(
        max_slots=2, max_len=64, decode_chunk=4, prefill_buckets=(16,),
        cache_dtype=torch.float32))
    batch = BatchProto.from_dict(tensors=_text_batch(config.pad_token_id))
    before = train.compute_log_probs(batch)["log_probs"]
    gate = params["layers"]["gate_w"].clone()
    metrics = train.train_step(batch)
    assert np.isfinite(list(metrics.values())).all()
    assert train.params["layers"]["gate_w"] is params["layers"]["gate_w"]    # in place
    assert not torch.equal(params["layers"]["gate_w"], gate)
    assert not np.array_equal(train.compute_log_probs(batch)["log_probs"], before)
    train.model_update()
    decode.model_update(snapshot=True)
    served = decode.engine.params["layers"]
    assert served["gate_w"].dim() == 4 and torch.equal(served["gate_w"], train.params[
        "layers"]["gate_w"]) and served["gate_w"] is not train.params["layers"]["gate_w"]
    prompts = np.array([[0, 0, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14]])
    out = decode.generate(BatchProto.from_dict(tensors={
        "input_ids": prompts, "attention_mask": (prompts != 0).astype(np.int64)}), _Greedy())
    assert out.shape == (2, 10)
    train.train_step(batch)
    assert not torch.equal(served["gate_w"], train.params["layers"]["gate_w"])

    with pytest.raises(NotImplementedError, match="MoE") as terr:
        DecodeEngine(config, params, max_slots=2, max_len=64, weight_quant="int8")
    _, _, jconfig, jp = _family("qwen3_moe")
    with pytest.raises(NotImplementedError, match="MoE") as jerr:
        j_engine.DecodeEngine(jconfig, jp, max_slots=2, max_len=64, weight_quant="int8")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError, match="pre-quantized params with MoE"):
        DecodeEngine(config, quantize_decode_params(params), max_slots=2, max_len=64)
