"""The port's context parallelism against the JAX package's.

The JAX side runs on the test run's 8 virtual CPU devices (shard_map over a
jax Mesh's "sp" axis); the port on device lists of `cpu` entries, as one
controller over the sp shards. Both in float32 on the same numpy inputs:

  * zigzag_indices / inverse_zigzag_indices and CPConfig's permutations;
  * the contiguous ring (ring_attention_sharded) and the position-aware
    zigzag ring (ring_attention_zigzag: a left-padded row, GQA, causal both
    ways, K/V in sub-chunks), values and gradients;
  * Ulysses (ulysses_attention_sharded) at Hkv 1 and 2 with a padding
    mask, its gradients, the indivisible-heads refusal;
  * the cp = 2 train and log-prob steps over fsdp 2 x tp 2 x sp 2 against
    JAX's cp steps (tests/test_parallel.py's test_cp_train_and_logprob_
    match_dense is the model), ring and Ulysses;
  * the strategies' context_parallel_size / context_parallel_impl knobs
    (train, infer, reward) and the refusals JAX makes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.configs.worker_config import (StrategyArguments as JStrategyArgs,
                                                     WorkerConfig as JWorkerConfig)
from socioreasoner_tpu.distributed import jax_strategies as j_strat
from socioreasoner_tpu.distributed import trainer as JT
from socioreasoner_tpu.distributed.strategy import ParamStore as JStore
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.parallel import context_parallel as j_cp
from socioreasoner_tpu.parallel import mesh as j_mesh
from socioreasoner_tpu.parallel import ring_attention as j_ring
from socioreasoner_tpu.parallel import sharding as j_sharding
from socioreasoner_tpu.parallel import ulysses as j_uly
from socioreasoner_tpu.pipeline import losses as JL
from socioreasoner_tpu.protocol import BatchProto as JBatch
from socioreasoner_tpu_torch.configs.worker_config import StrategyArguments, WorkerConfig
from socioreasoner_tpu_torch.distributed import torch_strategies as t_strat
from socioreasoner_tpu_torch.distributed import trainer as TT
from socioreasoner_tpu_torch.distributed.strategy import ParamStore
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.parallel import context_parallel as t_cp
from socioreasoner_tpu_torch.parallel import mesh as t_mesh
from socioreasoner_tpu_torch.parallel import ring_attention as t_ring
from socioreasoner_tpu_torch.parallel import ulysses as t_uly
from socioreasoner_tpu_torch.parallel.sharding import ShardedTree
from socioreasoner_tpu_torch.pipeline import losses as TL
from socioreasoner_tpu_torch.protocol import BatchProto
from tests.test_torch_engine import _port
from tests.test_torch_train import _tree_pairs

CPU = torch.device("cpu")
LR = 1e-3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _assert_params_within(tree, jtree, tol):
    """Every leaf within `tol` max-abs of JAX's (tests/test_parallel.py's
    bound on the params after a cp step)."""
    for name, t, j in _tree_pairs(tree, jax.tree.map(np.asarray, jtree)):
        err = np.abs(_np(t) - j).max()
        assert err < tol, (name, err)


# ------------------------------------------------------------------ zigzag

@pytest.mark.parametrize("L,cp", [(48, 2), (48, 3), (48, 4), (4160, 2)])
def test_zigzag_indices_match_jax(L, cp):
    perm, inv = t_cp.zigzag_indices(L, cp), t_cp.inverse_zigzag_indices(L, cp)
    np.testing.assert_array_equal(perm, j_cp.zigzag_indices(L, cp))
    np.testing.assert_array_equal(inv, j_cp.inverse_zigzag_indices(L, cp))
    np.testing.assert_array_equal(perm[inv], np.arange(L))


def test_cp_config_and_refusals():
    """CPConfig checks the mesh's sp axis and the impl; Ulysses keeps the
    natural order; an indivisible length refuses, as JAX's."""
    mesh = t_mesh.make_mesh(sp=2, tp=2, devices=[CPU] * 4)
    ring = t_cp.make_cp_config(mesh, 2)
    uly = t_cp.make_cp_config(mesh, 2, impl="ulysses")
    np.testing.assert_array_equal(ring.perm(16), j_cp.zigzag_indices(16, 2))
    np.testing.assert_array_equal(uly.perm(16), np.arange(16))
    np.testing.assert_array_equal(uly.inv_perm(16), np.arange(16))
    assert t_cp.make_cp_config(mesh, 1) is None
    with pytest.raises(ValueError, match="explicit mesh"):
        t_cp.make_cp_config(None, 2)
    with pytest.raises(ValueError, match="has size 2"):
        t_cp.CPConfig(mesh=mesh, size=4)
    with pytest.raises(ValueError, match="'ring' or 'ulysses'"):
        t_cp.CPConfig(mesh=mesh, size=2, impl="ribbon")
    with pytest.raises(ValueError, match="not divisible by 2\\*cp=4"):
        ring.perm(18)


# ------------------------------------------------------------------ ring

def _qkv(B, L, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, L, h, D)).astype(np.float32) for h in (H, Hkv, Hkv)]


def _jax_vjp(fn, w, *args, mesh):
    """(fn(*args), the gradients of sum(fn(*args) * w)) on the JAX side,
    traced once under `mesh`."""
    def run(w, *args):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(w)
    with jax.sharding.set_mesh(mesh):
        out, grads = jax.jit(run)(jnp.asarray(w), *map(jnp.asarray, args))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_vjp(fn, w, *args):
    leaves = [_t(x, True) for x in args]
    out = fn(*leaves)
    return _np(out), [_np(g) for g in torch.autograd.grad((out * _t(w)).sum(), leaves)]


@pytest.mark.parametrize("causal", [True, False])
def test_contiguous_ring_matches_jax(causal):
    """ring_attention_sharded over sp 4 against JAX's over the same axis,
    values and the gradients of a weighted sum, 1e-5."""
    q, k, v = _qkv(2, 16, 4, 4, 8, 0)
    w = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    jmesh = j_mesh.make_mesh(sp=4)
    want, jgrads = _jax_vjp(lambda q, k, v: j_ring.ring_attention_sharded(
        q, k, v, jmesh, causal=causal), w, q, k, v, mesh=jmesh)
    got, tgrads = _port_vjp(lambda q, k, v: t_ring.ring_attention_sharded(
        q, k, v, [CPU] * 4, causal=causal), w, q, k, v)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_zigzag_ring_matches_jax(causal):
    """ring_attention_zigzag in zigzag layout over sp 2 (K/V in 4-key
    sub-chunks, GQA 4/2, row 0 left-padded) against JAX's: values at the
    valid queries and the gradients, 1e-5."""
    B, L, H, Hkv, D = 2, 16, 4, 2, 8
    q, k, v = _qkv(B, L, H, Hkv, D, 2)
    mask = np.ones((B, L), np.int32)
    mask[0, :3] = 0
    perm = j_cp.zigzag_indices(L, 2)
    pos = np.broadcast_to(perm[None], (B, L)).astype(np.int32)
    qp, kp, vp, mp = q[:, perm], k[:, perm], v[:, perm], mask[:, perm]
    w = np.random.default_rng(3).normal(size=qp.shape).astype(np.float32)
    w *= mp[..., None, None]          # pad-query outputs are unread
    jmesh = j_mesh.make_mesh(sp=2)
    want, jgrads = _jax_vjp(lambda q, k, v: j_ring.ring_attention_zigzag(
        q, k, v, jnp.asarray(pos), jnp.asarray(mp), mesh=jmesh, causal=causal, k_chunk=4),
        w, qp, kp, vp, mesh=jmesh)
    got, tgrads = _port_vjp(lambda q, k, v: t_ring.ring_attention_zigzag(
        q, k, v, _t(pos), _t(mp), [CPU] * 2, causal=causal, k_chunk=4), w, qp, kp, vp)
    valid = mp == 1
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5, atol=1e-5)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_pick_chunk_matches_jax():
    for Lk, kc in ((2080, 512), (16, 4), (7, 512), (1040, 512)):
        assert t_ring._pick_chunk(Lk, kc) == j_ring._pick_chunk(Lk, kc)


# ------------------------------------------------------------------ Ulysses

@pytest.mark.parametrize("Hkv", [1, 2])
def test_ulysses_matches_jax(Hkv):
    """ulysses_attention_sharded over sp 2 with a padding mask against
    JAX's (Hkv 1: K/V repeated to H first; Hkv 2: split), values and
    gradients, 1e-5."""
    B, L, H, D = 2, 32, 4, 8
    q, k, v = _qkv(B, L, H, Hkv, D, 4)
    mask = np.ones((B, L), np.int32)
    mask[0, 25:] = 0
    w = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    jmesh = j_mesh.make_mesh(sp=2)
    want, jgrads = _jax_vjp(lambda q, k, v: j_uly.ulysses_attention_sharded(
        q, k, v, jmesh, attention_mask=jnp.asarray(mask), causal=True), w, q, k, v, mesh=jmesh)
    got, tgrads = _port_vjp(lambda q, k, v: t_uly.ulysses_attention_sharded(
        q, k, v, [CPU] * 2, attention_mask=_t(mask), causal=True), w, q, k, v)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_ulysses_flash_route_and_refusal():
    """use_flash runs the trainable attention (its plain version on the
    CPU) over the gathered mask's lengths: equal to the dense route on a
    right-padded mask. Heads that do not split over sp refuse, with JAX's
    reason."""
    B, L, H, Hkv, D = 2, 16, 4, 2, 8
    q, k, v = (_t(x) for x in _qkv(B, L, H, Hkv, D, 6))
    mask = torch.ones((B, L), dtype=torch.int32)
    mask[1, 11:] = 0
    dense = t_uly.ulysses_attention_sharded(q, k, v, [CPU] * 2, attention_mask=mask)
    flash = t_uly.ulysses_attention_sharded(q, k, v, [CPU] * 2, attention_mask=mask,
                                            use_flash=True)
    np.testing.assert_allclose(_np(flash), _np(dense), rtol=1e-5, atol=1e-5)
    q3 = _t(_qkv(B, L, 3, 3, D, 7)[0])
    with pytest.raises(ValueError, match="3 heads not divisible by sp=2"):
        t_uly.ulysses_attention_sharded(q3, q3, q3, [CPU] * 2)
    assert t_uly.ulysses_heads(8, 1, 2) == (4, 4) and t_uly.ulysses_heads(16, 2, 2) == (8, 1)


# ------------------------------------------------------------------ the steps

@pytest.fixture(scope="module")
def tiny():
    config = Qwen25VLConfig.tiny()
    return config, jax.tree.map(np.asarray, j_model.init_params(
        config, jax.random.key(0), jnp.float32, with_vision=False))


def _batch(config, B=4, L=16, seed=0):
    """Right-padded rows (the train batch's layout), responses in the
    second half."""
    from socioreasoner_tpu.models.qwen2_5_vl import rope as qrope
    rng = np.random.default_rng(seed)
    lens = np.array([L, L - 3, L - 5, L - 1])[:B]
    cols = np.arange(L)[None]
    attn = (cols < lens[:, None]).astype(np.int64)
    ids = np.where(attn == 1, rng.integers(2, 200, size=(B, L)), 0)
    pos, _ = qrope.get_rope_index(config, ids, None, attn)
    resp = ((cols >= L // 2) & (attn == 1)).astype(np.int64)
    return {
        "input_ids": ids, "attention_mask": attn, "position_ids": np.asarray(pos),
        "response_mask": resp,
        "advantages": rng.normal(size=(B, L - 1)).astype(np.float32),
        "old_log_probs": (-np.abs(rng.normal(size=(B, L - 1)))).astype(np.float32),
        "ref_log_probs": (-np.abs(rng.normal(size=(B, L - 1)))).astype(np.float32),
    }


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_cp_train_and_logprob_steps_match_jax(tiny, impl):
    """make_train_step / make_logprob_step with cp = 2 over fsdp 2 x tp 2 x
    sp 2 against JAX's cp steps over the same mesh: the loss within 1e-5 /
    1e-6, every param after the step within 5e-5, the log-probs and
    entropy within 1e-5 (before the step)."""
    config, np_params = tiny
    batch = _batch(config)
    shape = dict(fsdp=2, tp=2, sp=2)
    jmesh = j_mesh.make_mesh(**shape)
    jcp = j_cp.CPConfig(mesh=jmesh, size=2, impl=impl)
    jparams = jax.device_put(jax.tree.map(jnp.asarray, np_params),
                             j_sharding.param_shardings(np_params, jmesh))
    jopt = JT.make_optimizer(lr=LR)
    bs = j_sharding.batch_shardings(jmesh, batch)
    jb = {k: jax.device_put(np.asarray(v), bs[k]) for k, v in batch.items()}
    with jax.sharding.set_mesh(jmesh):
        jlp = jax.jit(JT.make_logprob_step(config, cp=jcp))(jparams, jb)
        jstate, jm = jax.jit(JT.make_train_step(config, JL.PPOLossConfig(), jopt, cp=jcp))(
            JT.TrainState.create(jparams, jopt), jb)

    tmesh = t_mesh.make_mesh(**shape, devices=[CPU] * 8)
    tcp = t_cp.CPConfig(mesh=tmesh, size=2, impl=impl)
    tconfig = _port(config)
    topt = TT.make_optimizer(lr=LR)
    state = TT.TrainState.create(ShardedTree(params_from_numpy(np_params, CPU), tmesh), topt)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tlp = TT.make_logprob_step(tconfig, cp=tcp)(state.params, tb)
    state, tm = TT.make_train_step(tconfig, TL.PPOLossConfig(), topt, cp=tcp)(state, tb)
    for k in ("log_probs", "entropy"):
        np.testing.assert_allclose(_np(tlp[k]), np.asarray(jlp[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(tm["actor_train/total_loss"]),
                               float(jm["actor_train/total_loss"]), rtol=1e-5, atol=1e-6)
    _assert_params_within(state.params.gather(CPU), jstate.params, 5e-5)


def _strategy(side, cls, sc, config, np_params, mesh, **kw):
    if side == "jax":
        wc = JWorkerConfig(strategy_args=JStrategyArgs(strategy_name="jax_train",
                                                       strategy_config=dict(sc)))
        s = getattr(j_strat, cls)(worker_config=wc, param_store=JStore())
        s.initialize(config, jax.tree.map(jnp.asarray, np_params), mesh=mesh, **kw)
    else:
        wc = WorkerConfig(strategy_args=StrategyArguments(strategy_name="jax_train",
                                                          strategy_config=dict(sc)))
        s = getattr(t_strat, cls.replace("Jax", "Torch"))(worker_config=wc,
                                                          param_store=ParamStore())
        s.initialize(_port(config), params_from_numpy(np_params, CPU), mesh=mesh, **kw)
    return s


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_strategy_context_parallel_knobs_match_jax(tiny, impl):
    """strategy_config's context_parallel_size 2 and context_parallel_impl
    through TorchTrainStrategy and TorchInferStrategy over dp 2 x sp 2 x tp
    2 against the JAX strategies: the train step's metrics within rtol
    1e-5, the reference log-probs and entropy within 1e-5."""
    config, np_params = tiny
    sc = {"context_parallel_size": 2, "context_parallel_impl": impl}
    batch = _batch(config, seed=1)
    shape = dict(dp=2, sp=2, tp=2)
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            mesh, proto = j_mesh.make_mesh(**shape), JBatch.from_dict(tensors=dict(batch))
        else:
            mesh = t_mesh.make_mesh(**shape, devices=[CPU] * 8)
            proto = BatchProto.from_dict(tensors=dict(batch))
        infer = _strategy(side, "JaxInferStrategy", sc, config, np_params, mesh)
        train = _strategy(side, "JaxTrainStrategy", sc, config, np_params, mesh)
        if side == "jax":
            with jax.sharding.set_mesh(mesh):
                out[side] = (infer.compute_log_probs(proto), train.train_step(proto))
        else:
            assert isinstance(train.params, ShardedTree)
            out[side] = (infer.compute_log_probs(proto), train.train_step(proto))
    (jlp, jm), (tlp, tm) = out["jax"], out["port"]
    for k in ("log_probs", "entropy"):
        np.testing.assert_allclose(tlp[k], jlp[k], rtol=1e-5, atol=1e-5, err_msg=k)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_reward_strategy_context_parallel(tiny):
    """TorchRewardStrategy with context_parallel_size 2 (ring and Ulysses)
    gives the values of the unsharded reward strategy, in the original
    order, within 1e-5."""
    config, np_params = tiny
    tree = TT.add_value_head(params_from_numpy(np_params, CPU), torch.Generator().manual_seed(0),
                             config.text.hidden_size)
    proto = BatchProto.from_dict(tensors=_batch(config, seed=2))
    values = {}
    for name, sc, mesh in (
            ("one", {}, None),
            ("ring", {"context_parallel_size": 2},
             t_mesh.make_mesh(sp=2, tp=2, devices=[CPU] * 4)),
            ("ulysses", {"context_parallel_size": 2, "context_parallel_impl": "ulysses"},
             t_mesh.make_mesh(fsdp=2, sp=2, devices=[CPU] * 4))):
        wc = WorkerConfig(strategy_args=StrategyArguments(strategy_name="jax_infer",
                                                          strategy_config=sc))
        s = t_strat.TorchRewardStrategy(worker_config=wc, param_store=ParamStore())
        s.initialize(_port(config), tree, mesh=mesh)
        values[name] = s.compute_values(proto)
    for name in ("ring", "ulysses"):
        np.testing.assert_allclose(values[name], values["one"], rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_context_parallel_refusals(tiny):
    """JAX's refusals, each with its reason: cp without a mesh, cp against a
    mesh whose sp axis differs, a length that does not split into 2 cp
    chunks, Ulysses heads that do not split over sp; cp with pp."""
    config, np_params = tiny
    tconfig = _port(config)
    with pytest.raises(ValueError, match="explicit mesh"):
        _strategy("port", "JaxTrainStrategy", {"context_parallel_size": 2}, config,
                  np_params, None)
    with pytest.raises(ValueError, match="has size 1"):
        _strategy("port", "JaxTrainStrategy", {"context_parallel_size": 2}, config,
                  np_params, t_mesh.make_mesh(fsdp=2, devices=[CPU] * 2))
    mesh = t_mesh.make_mesh(sp=2, devices=[CPU] * 2)
    s = _strategy("port", "JaxInferStrategy", {"context_parallel_size": 2}, config,
                  np_params, mesh)
    with pytest.raises(ValueError, match="not divisible by 2\\*cp=4"):
        s.compute_log_probs(BatchProto.from_dict(tensors=_batch(config, L=18)))
    wide = dataclasses.replace(tconfig, text=dataclasses.replace(
        tconfig.text, num_attention_heads=3, num_key_value_heads=1, head_dim=16))
    mesh = t_mesh.make_mesh(sp=2, devices=[CPU] * 2)
    cp = t_cp.CPConfig(mesh=mesh, size=2, impl="ulysses")
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
    params = t_model.init_params(wide, torch.Generator().manual_seed(0), device="cpu",
                                 with_vision=False)
    b = {k: torch.as_tensor(v) for k, v in _batch(config).items()}
    with pytest.raises(ValueError, match="3 heads not divisible by sp=2"):
        TT.make_logprob_step(wide, cp=cp)(ShardedTree(params, mesh), b)
    from socioreasoner_tpu_torch.parallel.pipeline_parallel import PPConfig
    both = t_mesh.make_mesh(pp=2, sp=2, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="PP and CP cannot combine"):
        TT.make_logprob_step(tconfig, cp=t_cp.CPConfig(mesh=both, size=2),
                             pp=PPConfig(mesh=both, size=2))(
            ShardedTree(params_from_numpy(np_params, CPU), both), b)
    with pytest.raises(ValueError, match="over a train mesh"):
        TT.make_logprob_step(tconfig, cp=t_cp.CPConfig(mesh=mesh, size=2))(
            params_from_numpy(np_params, CPU), b)
