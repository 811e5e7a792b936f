"""The port's GRPO train path against the JAX package's: the RL functionals,
the PPO and value losses, the optimizer against optax, the train and logprob
steps, the chunked head, and the strategies through model_update to a greedy
rollout.

Inputs come from np.random.default_rng and run in float32 at
Qwen25VLConfig.tiny(). Bounds: 1e-6 for the functionals and losses (float32
rounding of a few hundred terms), 1e-5 relative for the model steps (float32
rounding through two decoder layers and the head).
"""

import dataclasses
import functools
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from socioreasoner_tpu.distributed import jax_strategies as JS
from socioreasoner_tpu.distributed import trainer as JT
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.pipeline import losses as JL
from socioreasoner_tpu.protocol import BatchProto
from socioreasoner_tpu.utils import functionals as JF
from socioreasoner_tpu_torch.distributed import torch_strategies as TS
from socioreasoner_tpu_torch.distributed import trainer as TT
from socioreasoner_tpu_torch.models.qwen2_5_vl import convert
from socioreasoner_tpu_torch.protocol import BatchProto as TBatchProto

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
from socioreasoner_tpu_torch.pipeline import losses as TL
from socioreasoner_tpu_torch.utils import functionals as TF

TOL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _both(*arrays):
    """The same numpy arrays as jnp (for JAX) and torch (for the port)."""
    return ([None if a is None else jnp.asarray(a) for a in arrays],
            [None if a is None else torch.as_tensor(a) for a in arrays])


def _rl_inputs(seed=0, B=6, T=9):
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, T)) < 0.7).astype(np.float32)
    mask[0] = 0.0                                     # a row with no tokens
    return rng, mask, rng.normal(size=(B, T)).astype(np.float32)


# ------------------------------------------------------------- functionals

FUNCTIONAL_CASES = [
    "masked_mean", "masked_mean_axis", "masked_var", "masked_var_biased",
    "masked_whiten", "masked_whiten_keep_mean", "log_probs_from_logits",
    "entropy_from_logits", "kl_kl", "kl_abs", "kl_mse", "kl_k3", "kl_full",
    "agg_token-mean", "agg_seq-mean-token-sum", "agg_seq-mean-token-mean",
    "agg_seq-mean-token-sum-norm", "agg_weighted", "discounted_returns",
    "reinforce_return", "gae", "expand_2d", "expand_mrope", "batch_norm",
    "batch_norm_no_std", "group_norm", "group_norm_global", "group_norm_no_std",
    "difficulty_mask",
]


@pytest.mark.parametrize("case", FUNCTIONAL_CASES)
def test_functionals_match_jax(case):
    rng, mask, x = _rl_inputs()
    B, T = x.shape
    logits = rng.normal(size=(B, T, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(B, T))
    lp_a = -np.abs(rng.normal(size=(B, T))).astype(np.float32)
    lp_b = -np.abs(rng.normal(size=(B, T))).astype(np.float32)
    attn = np.ones((B, T + 1), np.int64)
    attn[1, 6:] = 0
    attn[3, 3:] = 0
    pos2 = np.clip(np.cumsum(attn, -1) - 1, 0, None)
    rewards = rng.normal(size=(12,)).astype(np.float32)
    name, _, mode = case.partition("_")
    if case in ("masked_mean", "masked_mean_axis"):
        call = lambda F, a, m: F.masked_mean(a, m, axis=-1 if "axis" in case else None)
        args = (x, mask)
    elif case.startswith("masked_var"):
        call = lambda F, a, m: F.masked_var(a, m, unbiased="biased" not in case)
        args = (x, mask)
    elif case.startswith("masked_whiten"):
        call = lambda F, a, m: F.masked_whiten(a, m, shift_mean="keep" not in case)
        args = (x, mask)
    elif case == "log_probs_from_logits":
        call, args = lambda F, z, y: F.log_probs_from_logits(z, y), (logits, labels)
    elif case == "entropy_from_logits":
        call, args = lambda F, z: F.entropy_from_logits(z), (logits,)
    elif name == "kl":
        if mode == "full":
            la = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
            lb = la[::-1].copy()
            call, args = lambda F, a, b: F.compute_approx_kl(a, b, None, "full"), (la, lb)
        else:
            call = lambda F, a, b, m: F.compute_approx_kl(a, b, m, mode)
            args = (lp_a, lp_b, mask)
    elif name == "agg":
        weights = rng.random(B).astype(np.float32)
        agg_mode = "seq-mean-token-sum" if mode == "weighted" else mode
        call = lambda F, a, m, w: F.agg_loss(a, m, agg_mode, w)
        args = (x, mask, weights if mode == "weighted" else None)
    elif case == "discounted_returns":
        call, args = lambda F, r: F.discounted_returns(r, 0.9), (x,)
    elif case == "reinforce_return":
        call, args = lambda F, r: F.compute_reinforce_return(r, 0.95), (x,)
    elif case == "gae":
        call = lambda F, r, v: F.compute_gae_advantage_return(r, v, 0.99, 0.95)
        args = (x, lp_a)
    elif name == "expand":
        pos = pos2 if mode == "2d" else np.stack([pos2, pos2 * 2, pos2 + 1], 1)
        call = lambda F, r, a, p: F.expand_to_token_level(r, a, p)
        args = (x[:, 0], attn, pos)
    elif name == "batch":
        call = lambda F, r: F.batch_reward_norm(r, div_std="no_std" not in case)
        args = (rewards,)
    elif name == "group":
        call = lambda F, r: F.group_reward_norm(r, 4, div_std="no_std" not in case,
                                                div_std_global="global" in case)
        args = (rewards,)
    else:
        call = lambda F, s: F.difficulty_mask(s, 4, 0.1, 0.95)
        args = ((np.clip(rewards, 0, 1) * (np.arange(12) % 4 > 0)).astype(np.float32),)
    jargs, targs = _both(*args)
    want, got = call(JF, *jargs), call(TF, *targs)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


@pytest.mark.parametrize("kw", [
    dict(adv_estimator="grpo"),
    dict(adv_estimator="reinforce", gamma=0.9, whiten_advantages=True),
    dict(adv_estimator="gae", gamma=0.99, lambd=0.95, whiten_rewards=True,
         advantage_clip=0.5),
])
def test_compute_advantage_matches_jax(kw):
    rng, mask, x = _rl_inputs(1)
    values = rng.normal(size=x.shape).astype(np.float32)
    (jx, jm, jv), (tx, tm, tv) = _both(x, mask, values)
    extra_j = {"values": jv} if kw["adv_estimator"] == "gae" else {}
    extra_t = {"values": tv} if kw["adv_estimator"] == "gae" else {}
    want = JF.compute_advantage(jx, jm, **kw, **extra_j)
    got = TF.compute_advantage(tx, tm, **kw, **extra_t)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("kl_penalty,with_ref", [("kl", True), ("k3", True), ("kl", False)])
def test_apply_kl_penalty_matches_jax(kl_penalty, with_ref):
    rng, mask, x = _rl_inputs(2)
    B, T = x.shape
    attn = np.ones((B, T + 1), np.int64)
    attn[2, 5:] = 0
    pos = np.broadcast_to(np.clip(np.cumsum(attn, -1) - 1, 0, None)[:, None], (B, 3, T + 1))
    old = -np.abs(rng.normal(size=(B, T))).astype(np.float32)
    ref = -np.abs(rng.normal(size=(B, T))).astype(np.float32) if with_ref else None
    jargs, targs = _both(x[:, 0], attn, pos.copy(), mask, old, ref)
    want = JF.apply_kl_penalty(*jargs, 0.05, kl_penalty)
    got = TF.apply_kl_penalty(*targs, 0.05, kl_penalty)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("mrope,fill_eos", [(False, False), (True, False), (True, True)])
def test_host_helpers_match_jax(mrope, fill_eos):
    rng = np.random.default_rng(3)
    bs, P, n, R = 2, 6, 3, 5
    ids = rng.integers(2, 50, size=(bs, P))
    attn = np.ones((bs, P), np.int64)
    attn[0, :2] = 0
    ids[attn == 0] = 0
    pos = np.clip(np.cumsum(attn, -1) - 1, 0, None)
    if mrope:
        pos = np.stack([pos, pos, pos * 2], 1)
    resp = rng.integers(2, 50, size=(bs * n, R))
    resp[1, 3:] = 0
    resp[4, 1:] = 0
    output = TF.concatenate_input_and_output(ids, resp, n)
    np.testing.assert_array_equal(output, JF.concatenate_input_and_output(ids, resp, n))
    for length in (4, 9):
        np.testing.assert_array_equal(TF.pad_to_length(output, length, 0),
                                      JF.pad_to_length(output, length, 0))
    kw = dict(input_ids=ids, attention_mask=attn, position_ids=pos, output=output,
              num_return_sequences=n, sequence_length=14, eos_token_id=1,
              pad_token_id=0, fill_eos_token=fill_eos, prompt_id=np.arange(bs))
    want, got = JF.postprocess_generate(**kw), TF.postprocess_generate(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("cfg_kw,with_ref,weighted", [
    (dict(), True, False),
    (dict(dual_clip_loss=True, entropy_loss_coef=0.01), True, False),
    (dict(loss_type="topr", topr_clip_min=0.1, use_kl_loss=False), False, False),
    (dict(loss_agg_mode="token-mean"), True, True),
    (dict(loss_agg_mode="seq-mean-token-mean", pg_clip=0.1), True, False),
    (dict(loss_agg_mode="seq-mean-token-sum-norm", kl_loss_coef=0.1), True, True),
])
def test_ppo_policy_loss_matches_jax(cfg_kw, with_ref, weighted):
    """Loss, every metric, and the gradient with respect to the log-probs
    (which also checks TopR's stop-gradient)."""
    rng, mask, adv = _rl_inputs(4)
    B, T = adv.shape
    lp = -np.abs(rng.normal(size=(B, T))).astype(np.float32)
    old = (lp + rng.normal(size=(B, T)) * 0.4).astype(np.float32)
    ref = (lp - np.abs(rng.normal(size=(B, T))) * 0.2).astype(np.float32) if with_ref else None
    ent = np.abs(rng.normal(size=(B, T))).astype(np.float32)
    w = rng.random(B).astype(np.float32) if weighted else None
    (jlp, jent, jold, jref, jadv, jm, jw), (tlp, tent, told, tref, tadv, tm, tw) = \
        _both(lp, ent, old, ref, adv, mask, w)

    def jloss(x):
        return JL.ppo_policy_loss(x, jent, jold, jref, jadv, jm,
                                  JL.PPOLossConfig(**cfg_kw), jw)

    (want, wm), jgrad = jax.value_and_grad(jloss, has_aux=True)(jlp)
    tlp.requires_grad_(True)
    got, gm = TL.ppo_policy_loss(tlp, tent, told, tref, tadv, tm, TL.PPOLossConfig(**cfg_kw), tw)
    got.backward()
    _close(got, want)
    assert sorted(gm) == sorted(wm)
    for k in wm:
        _close(gm[k], wm[k])
    _close(tlp.grad, jgrad)


@pytest.mark.parametrize("value_clip", [0.2, None])
def test_value_loss_matches_jax(value_clip):
    rng, mask, v = _rl_inputs(5)
    ov = (v + rng.normal(size=v.shape) * 0.5).astype(np.float32)
    ret = rng.normal(size=v.shape).astype(np.float32)
    jargs, targs = _both(v, ov, ret, mask)
    want, wm = JL.value_loss(*jargs, value_clip)
    got, gm = TL.value_loss(*targs, value_clip)
    _close(got, want)
    for k in wm:
        _close(gm[k], wm[k])


# --------------------------------------------------------------- optimizer

@pytest.mark.parametrize("kw", [
    dict(),
    dict(weight_decay=0.01, max_grad_norm=0.1),                       # clipped
    dict(warmup_steps=2, weight_decay=0.01),                          # linear warmup
    dict(schedule="cosine", warmup_steps=1, total_steps=5, max_grad_norm=0.1),
    dict(schedule="cosine", total_steps=4, weight_decay=0.01),
    dict(gradient_accumulation_steps=2, weight_decay=0.01, max_grad_norm=0.5),
    dict(gradient_accumulation_steps=2, warmup_steps=1),
])
def test_optimizer_matches_optax(kw):
    """Three updates of make_optimizer against the optax chain. The "frozen"
    leaf gets no gradient (None in the port, zeros in JAX) and still decays."""
    rng = np.random.default_rng(6)
    tree = {"a": rng.normal(size=(3, 4)), "b": {"c": rng.normal(size=(5,))},
            "frozen": rng.normal(size=(2, 3))}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    jopt = JT.make_optimizer(lr=0.05, **kw)
    topt = TT.make_optimizer(lr=0.05, **kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    tparams = params_from_numpy(tree)
    tstate = topt.init(tparams)
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.3, tree)
        grads["frozen"] = np.zeros_like(tree["frozen"])
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = [torch.as_tensor(grads["a"]), torch.as_tensor(grads["b"]["c"]), None]
        topt.update(tgrads, tstate, tparams)
        for g, w in zip(TT.tree_leaves(tparams), [jparams["a"], jparams["b"]["c"],
                                                 jparams["frozen"]]):
            _close(g, w)


# ------------------------------------------------------- train / logprob steps

LR = 1e-3


def _grpo_batch(config, seed=0, B=4, L=20, n_img=3):
    """A right-padded GRPO batch: ragged valid lengths, image tokens whose
    rows come from image_embeds, responses after position 9."""
    rng = np.random.default_rng(seed)
    lens = np.array([L, L - 3, L - 6, L - 1])[:B]
    ids = rng.integers(2, config.text.vocab_size - 8, size=(B, L))
    ids[:, 1:1 + n_img] = config.image_token_id
    cols = np.arange(L)[None]
    attn = (cols < lens[:, None]).astype(np.int64)
    ids[attn == 0] = config.pad_token_id
    pos = np.broadcast_to(np.clip(np.cumsum(attn, -1) - 1, 0, None)[:, None],
                          (B, 3, L)).copy()
    resp = ((cols >= 9) & (attn == 1)).astype(np.int64)
    return {
        "input_ids": ids, "attention_mask": attn, "position_ids": pos,
        "response_mask": resp,
        "advantages": rng.normal(size=(B, L - 1)).astype(np.float32),
        "old_log_probs": (-np.abs(rng.normal(size=(B, L - 1))) - 5).astype(np.float32),
        "ref_log_probs": (-np.abs(rng.normal(size=(B, L - 1))) - 5).astype(np.float32),
    }, rng.normal(size=(B * n_img, config.text.hidden_size)).astype(np.float32)


def _tree_pairs(tp, jp, prefix=""):
    """(name, port tensor, jax numpy array) for every leaf."""
    for k, v in tp.items():
        if isinstance(v, dict):
            yield from _tree_pairs(v, jp[k], f"{prefix}{k}/")
        else:
            yield prefix + k, v, np.asarray(jp[k])


def _assert_params_close(tp, jp, tol=1e-5):
    """Per leaf, max-abs difference ≤ tol × the leaf's scale: its max-abs, or
    the learning rate for a leaf that starts at zero (the biases), since one
    update moves a parameter by at most ~lr."""
    for name, t, j in _tree_pairs(tp, jp):
        scale = max(np.abs(j).max(), LR)
        err = np.abs(_np(t) - j).max()
        assert err <= tol * scale, (name, err, scale)


@pytest.fixture(scope="module")
def steps():
    """Two train steps of the JAX step and of the port from the same weights
    (vision leaves included: they get no gradient and still decay)."""
    config = Qwen25VLConfig.tiny()
    jp = j_model.init_params(config, jax.random.key(11), dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, jp)
    batch, img = _grpo_batch(config)
    # eps 1e-4: Adam moves an element by ~lr * g / (|g| + eps), so with eps
    # 1e-8 an element whose gradient is near zero gets an lr-sized update
    # that float32 rounding of g decides; a larger eps keeps such elements in
    # the linear regime, and the comparison tests the math, not the rounding
    jopt = JT.make_optimizer(lr=LR, weight_decay=0.01, eps=1e-4)
    jstate = JT.TrainState.create(jp, jopt)
    jstep = jax.jit(JT.make_train_step(config, JL.PPOLossConfig(), jopt))
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items()}, "image_embeds": jnp.asarray(img)}
    topt = TT.make_optimizer(lr=LR, weight_decay=0.01, eps=1e-4)
    tstate = TT.TrainState.create(params_from_numpy(np_params), topt)
    tstep = TT.make_train_step(_port(config), TL.PPOLossConfig(), topt)
    tbatch = {**{k: torch.as_tensor(v) for k, v in batch.items()}, "image_embeds": torch.as_tensor(img)}
    out = []
    for _ in range(2):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        out.append((jax.tree.map(np.asarray, jstate.params), jm,
                    jax.tree.map(lambda t: t.clone(), tstate.params), tm))
    return config, np_params, batch, img, out


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_metrics_match_jax(steps, step):
    *_, out = steps
    _, jm, _, tm = out[step]
    assert sorted(tm) == sorted(jm)
    # atol 1e-6: a PPO loss near 0 is a cancellation of O(1) terms, so it is
    # held to float32 rounding of those terms, not to its own size
    for k in jm:
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_params_match_jax(steps, step):
    *_, out = steps
    jparams, _, tparams, _ = out[step]
    _assert_params_close(tparams, jparams)


def test_logprob_step_matches_jax(steps):
    config, np_params, batch, img, _ = steps
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items()}, "image_embeds": jnp.asarray(img)}
    want = jax.jit(JT.make_logprob_step(config))(jax.tree.map(jnp.asarray, np_params), jbatch)
    tbatch = {**{k: torch.as_tensor(v) for k, v in batch.items()}, "image_embeds": torch.as_tensor(img)}
    got = TT.make_logprob_step(_port(config))(params_from_numpy(np_params), tbatch)
    for k in ("log_probs", "entropy"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-5, atol=1e-5)


def test_chunked_logp_entropy_matches_jax():
    """Values and grads (hidden and the tied head) with L % chunk != 0."""
    config = Qwen25VLConfig.tiny(96)
    rng = np.random.default_rng(7)
    embed = (rng.normal(size=(96, 64)) * 0.5).astype(np.float32)
    hidden = rng.normal(size=(2, 37, 64)).astype(np.float32)
    labels = rng.integers(0, 96, size=(2, 37))
    coef = rng.normal(size=(2, 2, 37)).astype(np.float32)

    def jf(e, h):
        lp, ent = JT.chunked_logp_entropy({"embed": e}, h, jnp.asarray(labels), chunk_size=8)
        return jnp.sum(lp * coef[0] + ent * coef[1]), (lp, ent)

    (_, (jlp, jent)), jgrads = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(embed), jnp.asarray(hidden))
    te = torch.tensor(embed, requires_grad=True)
    th = torch.tensor(hidden, requires_grad=True)
    lp, ent = TT.chunked_logp_entropy({"embed": te}, th, torch.as_tensor(labels), chunk_size=8)
    (lp * torch.as_tensor(coef[0]) + ent * torch.as_tensor(coef[1])).sum().backward()
    assert config.text.vocab_size == 96
    for g, w in ((lp, jlp), (ent, jent), (te.grad, jgrads[0]), (th.grad, jgrads[1])):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_strategy_token_ops_match_jax():
    """The strategy bases' op_compute_log_probs / op_compute_entropy."""
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(3, 7, 13)).astype(np.float32)
    ids = rng.integers(0, 13, size=(3, 7))
    attn = (rng.random((3, 7)) < 0.8).astype(np.int64)
    (jl, ji, ja), (tl, ti, ta) = _both(logits, ids, attn)
    jstrat, tstrat = JS.JaxTrainStrategy(), TS.TorchTrainStrategy()
    _close(tstrat.op_compute_log_probs(tl, ti, ta), jstrat.op_compute_log_probs(jl, ji, ja))
    _close(tstrat.op_compute_entropy(tl, ta), jstrat.op_compute_entropy(jl, ja))


def test_unported_train_options_raise():
    """Context and pipeline parallelism and vocab-parallel log-probs run
    over a train mesh (tests/test_torch_context_parallel.py,
    tests/test_torch_pipeline_parallel.py, tests/test_torch_train_mesh.py):
    given a plain tree they refuse, and the strategies refuse their knobs
    without a mesh, as the JAX strategies do."""
    config = _port(Qwen25VLConfig.tiny())
    for kwargs in ({"cp": object()}, {"pp": object()}, {"vp_mesh": object()}):
        with pytest.raises(ValueError, match="train mesh"):
            TT._model_log_probs(config, {}, {"input_ids": None}, remat=False, **kwargs)
    from socioreasoner_tpu_torch.configs.worker_config import StrategyArguments, WorkerConfig
    for knob in ("context_parallel_size", "pipeline_model_parallel_size"):
        strat = TS.TorchTrainStrategy(worker_config=WorkerConfig(
            strategy_args=StrategyArguments(strategy_name="jax_train",
                                            strategy_config={knob: 2})))
        with pytest.raises(ValueError, match="requires an explicit mesh"):
            strat.initialize(config, {})


# ---------------------------------------------------------------- strategies

class _GreedyArgs:
    temperature, top_p, top_k, max_new_tokens = 0.0, 1.0, 0, 6
    do_sample, num_return_sequences = False, 1


def test_strategies_through_model_update_match_jax():
    """Train strategy (one step) + reference strategy log-probs + model_update
    to a decode strategy, on both sides: the log-probs, the trained weights
    (vision leaves decayed without a gradient) and the greedy rollout after
    the update agree."""
    config = Qwen25VLConfig.tiny()
    jp = j_model.init_params(config, jax.random.key(12), dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, jp)
    batch_np, img = _grpo_batch(config, seed=1)
    targs = SimpleNamespace(learning_rate=LR, weight_decay=0.01)
    prompts = np.array([[0, 0, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14]])
    gen_tensors = {"input_ids": prompts, "attention_mask": (prompts != 0).astype(np.int64)}
    engine_kw = dict(max_slots=2, max_len=64, decode_chunk=4, prefill_buckets=(16,))

    def run(side):
        if side == "jax":
            params, ref_params = jp, jp
            store = JS.ParamStore()
            train, infer, decode = JS.JaxTrainStrategy(), JS.JaxInferStrategy(), JS.JaxDecodeStrategy()
            kw = dict(engine_kw, cache_dtype=jnp.float32, sampler_exact=True)
            cfg, Proto = config, BatchProto
        else:
            params, ref_params = params_from_numpy(np_params), params_from_numpy(np_params)
            store = TS.ParamStore()
            train, infer, decode = TS.TorchTrainStrategy(), TS.TorchInferStrategy(), TS.TorchDecodeStrategy()
            kw = dict(engine_kw, cache_dtype=torch.float32)
            cfg, Proto = _port(config), TBatchProto
        # the rollout engine starts from its own copy of the initial weights
        decode_init = jax.tree.map(jnp.array, np_params) if side == "jax" else \
            params_from_numpy(np_params)
        decode.initialize(cfg, decode_init, param_store=store, engine_kwargs=kw)
        train.initialize(cfg, params, JL.PPOLossConfig() if side == "jax" else TL.PPOLossConfig(),
                         training_args=targs, param_store=store)
        infer.initialize(cfg, ref_params, param_store=store)
        batch = Proto.from_dict(tensors={k: v.copy() for k, v in batch_np.items()},
                                meta={"image_embeds": img})
        gen_batch = Proto.from_dict(tensors=gen_tensors)
        ref_lp = infer.compute_log_probs(batch)["log_probs"]
        old_lp = train.compute_log_probs(batch)["log_probs"]
        metrics = train.train_step(batch)
        new_lp = train.compute_log_probs(batch)["log_probs"]
        train.model_update()
        decode.model_update()
        return (ref_lp, old_lp, new_lp, metrics, train.params,
                decode.generate(gen_batch, _GreedyArgs()), decode, train)

    j = run("jax")
    t = run("torch")
    for g, w in zip(t[:3], j[:3]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert not np.array_equal(t[2], t[1])                 # the actor moved
    for k in j[3]:
        np.testing.assert_allclose(t[3][k], j[3][k], rtol=1e-5, atol=1e-6, err_msg=k)
    vision = list(_tree_pairs(t[4]["vision"], j[4]["vision"]))
    for name, got, want in vision:                        # decayed: p (1 - lr wd)
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-9, err_msg=name)
    assert not np.array_equal(_np(t[4]["vision"]["patch_embed_w"]),
                              np_params["vision"]["patch_embed_w"])
    np.testing.assert_array_equal(t[5], j[5])             # greedy rollout after the update
    assert t[6].engine.params["embed"] is t[7].params["embed"]


def test_chip_smoke_train_path_on_cpu():
    """chip_smoke's train path (rollout through the server → postprocess →
    reference and old log-probs → GRPO advantages → three train steps →
    model_update → greedy request), rehearsed at a tiny config on CPU
    tensors (the kernels' plain versions)."""
    import chip_smoke
    from socioreasoner_tpu_torch.datasets.processor import ImageProcessorConfig
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import (
        Qwen25VLConfig, TextConfig, VisionConfig)
    config = Qwen25VLConfig(
        vision=VisionConfig(depth=2, hidden_size=64, intermediate_size=128,
                            num_heads=4, out_hidden_size=64, window_size=28,
                            fullatt_block_indexes=(1,)),
        text=TextConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                        mrope_section=(2, 3, 3)))
    params = t_model.init_params(config, torch.Generator().manual_seed(0), device="cpu")
    img_cfg = ImageProcessorConfig(min_pixels=56 * 56, max_pixels=56 * 56 * 4,
                                   defer_patchify=True)
    stats = chip_smoke.run_train_path(
        config, params, torch.device("cpu"), tile_px=96, img_cfg=img_cfg, max_new=5,
        prompt_length=256, sequence_length=300, decode_chunk=4)
    assert stats["train_batch"] == [4, 300]
    assert len(stats["train_step_ms"]) == 3 and stats["logprob_max_abs_move"] > 0
    assert stats["response_lens"] == [5] * 4 and stats["handoff_tokens"] == 5
    # CPU tensors take the plain versions: no kernel launches
    assert stats["launches"] == {"flash_attention_fwd_lse": 0, "flash_attention_bwd_dq": 0,
                                 "flash_attention_bwd_dkv": 0}
