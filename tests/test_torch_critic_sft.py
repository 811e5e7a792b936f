"""The port's reward model, critic, SFT and DPO steps and sequence packing
against the JAX package's.

At the tiny f32 configs of the JAX tests (tests/test_reward_workers.py,
tests/test_agentic_and_critic.py, tests/test_sft_dpo.py), from one seed
through the weight bridge: the reward model's values within 1e-5 and its
rewards at the eos index (a row without pad wraps to its last position);
two steps of the critic, of SFT on packed rows and of DPO (sigmoid with
and without label smoothing, IPO, ORPO): metrics within float32 rounding
and the weights within 5e-5 of each leaf's scale, with Adam's eps at 1e-4
on both sides (as tests/test_torch_train.py holds the GRPO step); packing
bit for bit.

5e-5, not the GRPO step's 1e-5: Adam moves an element by ~lr * g /
(|g| + eps), so an element whose gradient is small against eps carries
the rounding of g into the weights amplified. The attention's value bias
gets a gradient that is a sum of terms of ~1e-2 cancelling to ~3e-5; the
two packages' gradients agree to 8e-7 of the leaf's largest, and the
weights after two steps to 2.0e-5-2.6e-5 of their scale.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.configs.worker_config import WorkerConfig as JWorkerConfig
from socioreasoner_tpu.distributed import jax_strategies as JS
from socioreasoner_tpu.distributed import sft as j_sft
from socioreasoner_tpu.distributed import trainer as JT
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl import rope as j_rope
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.pipeline import base_worker as j_worker
from socioreasoner_tpu.protocol import BatchProto as JBatchProto
from socioreasoner_tpu_torch.configs.worker_config import WorkerConfig
from socioreasoner_tpu_torch.distributed import sft as t_sft
from socioreasoner_tpu_torch.distributed import torch_strategies as TS
from socioreasoner_tpu_torch.distributed import trainer as TT
from socioreasoner_tpu_torch.pipeline import base_worker as t_worker
from socioreasoner_tpu_torch.protocol import BatchProto
from tests.test_torch_engine import _port
from tests.test_torch_train import LR, _assert_params_close, _np, params_from_numpy

VOCAB = 512


@functools.lru_cache(maxsize=4)
def _tree(vocab: int, value_head: bool, with_vision: bool = False):
    """(config, numpy params) of Qwen25VLConfig.tiny(vocab) from seed 0,
    with the JAX value head from seed 1."""
    config = Qwen25VLConfig.tiny(vocab)
    params = j_model.init_params(config, jax.random.key(0), jnp.float32,
                                 with_vision=with_vision)
    if value_head:
        params = JT.add_value_head(params, jax.random.key(1), config.text.hidden_size)
    return config, jax.tree.map(np.asarray, params)


def _optimizers():
    """Both packages' optimizers, Adam's eps at 1e-4 (see the module doc)."""
    return (JT.make_optimizer(lr=LR, weight_decay=0.01, eps=1e-4),
            TT.make_optimizer(lr=LR, weight_decay=0.01, eps=1e-4))


def _run_steps(make_jstep, make_tstep, np_params, batch, n=2):
    """n steps of each package from the same weights on the same batch,
    the steps built by make_*step(optimizer): [(jax params, jax metrics,
    port params, port metrics)] a step."""
    jopt, topt = _optimizers()
    jstate = JT.TrainState.create(jax.tree.map(jnp.asarray, np_params), jopt)
    tstate = TT.TrainState.create(params_from_numpy(np_params), topt)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    jstep, tstep = jax.jit(make_jstep(jopt)), make_tstep(topt)
    out = []
    for _ in range(n):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        out.append((jax.tree.map(np.asarray, jstate.params), jm,
                    jax.tree.map(lambda t: t.clone(), tstate.params), tm))
    return out


def _assert_steps_match(out, atol=1e-6):
    for jparams, jm, tparams, tm in out:
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-5, atol=atol,
                                       err_msg=k)
        _assert_params_close(tparams, jparams, tol=5e-5)


# ------------------------------------------------------------ reward model

def _rm_batch(config, B=3, L=16, seed=0):
    """Right-padded rows: row 0 padded from 10, row 1 full (no pad), row 2
    padded from 12."""
    rng = np.random.default_rng(seed)
    pad = config.pad_token_id
    ids = rng.integers(2, config.text.vocab_size - 10, size=(B, L))
    ids[0, 10:] = pad
    ids[2, 12:] = pad
    attn = (ids != pad).astype(np.int64)
    pos, _ = j_rope.get_rope_index(config, ids, None, attn)
    return {"input_ids": ids, "attention_mask": attn, "position_ids": np.asarray(pos)}


def test_reward_model_matches_jax_and_scores_at_eos():
    """TorchRewardStrategy + RewardWorker against JaxRewardStrategy +
    RewardWorker, in micro-batches of 2 rows: the values within 1e-5, the
    response-level reward the value at the last non-pad position of the
    shifted frame (8, the wrap to L-2 for the full row, 10)."""
    config, params = _tree(VOCAB, True, with_vision=True)
    batch = _rm_batch(config)
    meta = {"pad_token_id": config.pad_token_id}
    jstrat = JS.JaxRewardStrategy(worker_config=JWorkerConfig(infer_batch_size=2))
    jstrat.initialize(config, jax.tree.map(jnp.asarray, params))
    jw = j_worker.RewardWorker(worker_config=JWorkerConfig())
    jw.initialize(strategy=jstrat)
    want = jw.compute_rewards(JBatchProto.from_dict(tensors=batch, meta=meta))
    tstrat = TS.TorchRewardStrategy(worker_config=WorkerConfig(infer_batch_size=2))
    tstrat.initialize(_port(config), params_from_numpy(params))
    tw = t_worker.RewardWorker(worker_config=WorkerConfig())
    tw.initialize(strategy=tstrat)
    got = tw.compute_rewards(BatchProto.from_dict(tensors=batch, meta=meta))
    token, resp = got.batch["token_level_rewards"], got.batch["response_level_rewards"]
    assert token.shape == (3, 15) and token.dtype == np.float32
    np.testing.assert_allclose(token, want.batch["token_level_rewards"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(resp, want.batch["response_level_rewards"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(resp, token[np.arange(3), [8, 14, 10]])
    np.testing.assert_array_equal(tstrat.forward_step(BatchProto.from_dict(
        tensors=batch, meta=meta))["values"], token)


def test_reward_strategy_needs_a_value_head():
    config, params = _tree(VOCAB, False)
    with pytest.raises(ValueError, match="value head"):
        TS.TorchRewardStrategy().initialize(_port(config), params_from_numpy(params))


def test_value_head_promotes_as_jax():
    """A bf16 backbone and an f32 head give f32 values (JAX promotes
    bf16 @ f32 to f32); add_value_head draws N(0, 0.02) on the generator's
    device and shares the other leaves."""
    params = {"embed": torch.zeros(4, 8)}
    out = TT.add_value_head(params, torch.Generator().manual_seed(3), 8)
    assert out["embed"] is params["embed"] and "value_head_w" not in params
    assert out["value_head_w"].shape == (8, 1) and out["value_head_b"].shape == (1,)
    assert out["value_head_w"].dtype == torch.float32
    again = TT.add_value_head(params, torch.Generator().manual_seed(3), 8)
    assert torch.equal(out["value_head_w"], again["value_head_w"])
    hidden = torch.randn(2, 5, 8).to(torch.bfloat16)
    values = TT.value_head(out, hidden)
    assert values.dtype == torch.float32 and values.shape == (2, 5)
    want = jnp.asarray(hidden.float().numpy(), jnp.bfloat16) @ jnp.asarray(
        out["value_head_w"].numpy()) + jnp.asarray(out["value_head_b"].numpy())
    np.testing.assert_allclose(values.numpy(), np.asarray(want[..., 0]), rtol=1e-6, atol=1e-6)


def test_compute_image_embeds_matches_jax():
    config, params = _tree(VOCAB, False, with_vision=True)
    grid = np.array([[1, 4, 4], [1, 2, 4]])
    rng = np.random.default_rng(5)
    pixels = rng.normal(size=(int(grid.prod(-1).sum()), config.vision.patch_input_dim))
    pixels = pixels.astype(np.float32)
    want = JS.compute_image_embeds(config, jax.tree.map(jnp.asarray, params), pixels, grid)
    got = TS.compute_image_embeds(_port(config), params_from_numpy(params), pixels, grid)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ critic

def test_critic_value_steps_match_jax():
    """Two make_value_step steps (the JAX critic test's batch): metrics,
    weights, and value_forward before and after."""
    config, params = _tree(512, True)
    rng = np.random.default_rng(0)
    B, L = 2, 12
    ids = rng.integers(2, 200, size=(B, L))
    attn = np.ones((B, L), np.int64)
    pos, _ = j_rope.get_rope_index(config, ids, None, attn)
    resp = np.zeros((B, L), np.int32)
    resp[:, 6:] = 1
    batch = {"input_ids": ids, "attention_mask": attn, "position_ids": np.asarray(pos),
             "response_mask": resp,
             "old_values": rng.normal(scale=0.1, size=(B, L - 1)).astype(np.float32),
             "returns": rng.normal(size=(B, L - 1)).astype(np.float32)}
    out = _run_steps(lambda o: JT.make_value_step(config, o)[0],
                     lambda o: TT.make_value_step(_port(config), o)[0], params, batch)
    _assert_steps_match(out)
    _, jforward = JT.make_value_step(config, _optimizers()[0])
    _, tforward = TT.make_value_step(_port(config), _optimizers()[1])
    losses = [float(o[3]["critic_train/value_loss"]) for o in out]
    assert losses[1] < losses[0]
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        _np(tforward(out[-1][2], tbatch)),
        np.asarray(jforward(jax.tree.map(jnp.asarray, out[-1][0]),
                            {k: jnp.asarray(v) for k, v in batch.items()})),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- packing

def _samples(seed, lengths, max_id=200):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lengths):
        s = {"input_ids": rng.integers(2, max_id, size=n)}
        if i % 2:
            s["loss_mask"] = (np.arange(n) >= n // 3).astype(np.int32)
        out.append(s)
    return out


@pytest.mark.parametrize("seed,lengths,max_len", [
    (0, (30, 20, 25, 10, 64, 5), 64),
    (1, (70, 3, 64, 33, 31, 1, 40), 64),
    (2, (200, 1800, 950, 1024, 300, 1500, 700, 1100), 2048),
])
def test_pack_sequences_matches_jax_bit_for_bit(seed, lengths, max_len):
    samples = _samples(seed, lengths)
    got = t_sft.pack_sequences(samples, max_len, pad_id=0)
    want = j_sft.pack_sequences(samples, max_len, pad_id=0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    kept = sum(int((r["input_ids"] != 0).sum()) for r in got)
    assert kept == sum(min(n, max_len) for n in lengths)


# --------------------------------------------------------------------- SFT

def test_sft_steps_on_packed_rows_match_jax():
    config, params = _tree(512, False)
    rows = t_sft.pack_sequences(_samples(3, (9, 5, 14, 7, 3, 11)), 16, pad_id=0)
    batch = {k: np.stack([r[k] for r in rows]) for k in ("input_ids", "attention_mask",
                                                         "position_ids", "loss_mask")}
    out = _run_steps(lambda o: JT.make_sft_step(config, o),
                     lambda o: TT.make_sft_step(_port(config), o), params, batch)
    _assert_steps_match(out)
    assert float(out[1][3]["sft/loss"]) < float(out[0][3]["sft/loss"])


# --------------------------------------------------------------------- DPO

def _dpo_batch(B=2, L=10):
    batch = {}
    for prefix, seed in (("chosen", 2), ("rejected", 3)):
        r = np.random.default_rng(seed)
        loss_mask = np.zeros((B, L), np.int32)
        loss_mask[:, 4:] = 1
        batch.update({
            f"{prefix}_input_ids": r.integers(2, 200, size=(B, L)),
            f"{prefix}_attention_mask": np.ones((B, L), np.int64),
            f"{prefix}_position_ids": np.broadcast_to(np.arange(L)[None, None],
                                                      (B, 3, L)).copy(),
            f"{prefix}_loss_mask": loss_mask})
    batch["ref_chosen_logps"] = np.array([-40.0, -41.5], np.float32)
    batch["ref_rejected_logps"] = np.array([-40.5, -39.0], np.float32)
    return batch


@pytest.mark.parametrize("loss_type,label_smoothing", [
    ("sigmoid", 0.0), ("sigmoid", 0.1), ("ipo", 0.0), ("orpo", 0.0)])
def test_dpo_steps_match_jax(loss_type, label_smoothing):
    """Two make_dpo_step steps: the loss, every metric and the grad norm
    within float32 rounding (atol 1e-4: the margins are differences of
    summed log-probs of ~40, whose rounding is ~1e-5), the weights within
    5e-5 of each leaf's scale, and the loss falling (but for IPO)."""
    config, params = _tree(256, False)
    kw = dict(beta=0.5, loss_type=loss_type, label_smoothing=label_smoothing)
    out = _run_steps(lambda o: j_sft.make_dpo_step(config, o, **kw),
                     lambda o: t_sft.make_dpo_step(_port(config), o, **kw), params, _dpo_batch())
    _assert_steps_match(out, atol=1e-4)
    losses = [float(o[3]["dpo/loss"]) for o in out]
    assert float(out[0][3]["dpo/grad_norm"]) > 0
    # IPO pulls the margin (1.32 here) to 1 / (2 beta) = 1 and overshoots at
    # this learning rate
    assert losses[1] < losses[0] or loss_type == "ipo"
