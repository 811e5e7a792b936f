"""The port's pipeline parallelism against the JAX package's.

The JAX side runs on the test run's 8 virtual CPU devices (shard_map over a
jax Mesh's "pp" axis, or "sp" playing it as in tests/test_pipeline_
parallel.py); the port on device lists of `cpu` entries, one controller
walking the schedule's ticks. Both in float32 on the same numpy inputs:

  * pipeline_forward (GPipe) and pipeline_forward_interleaved on a small
    layer function, values and gradients;
  * _interleaved_schedule's tables, equal to JAX's;
  * the pp = 2 and pp = 2 x vpp = 2 (4 layers) train and log-prob steps
    through the strategies against JAX's, the layers stored a stage;
  * the refusals JAX makes (pp with cp, pp with MoE, a batch that does not
    split into micro-batches) and build_train_mesh with the cp and pp knobs;
  * chip_smoke's seq_pipe phase rehearsed at a tiny config.
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
from socioreasoner_tpu.distributed.strategy import ParamStore as JStore
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.parallel import mesh as j_mesh
from socioreasoner_tpu.parallel import pipeline_parallel as j_pp
from socioreasoner_tpu.protocol import BatchProto as JBatch
from socioreasoner_tpu_torch.configs.worker_config import StrategyArguments, WorkerConfig
from socioreasoner_tpu_torch.distributed import torch_strategies as t_strat
from socioreasoner_tpu_torch.distributed import trainer as TT
from socioreasoner_tpu_torch.distributed.strategy import ParamStore
from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.parallel import mesh as t_mesh
from socioreasoner_tpu_torch.parallel import pipeline_parallel as t_pp
from socioreasoner_tpu_torch.parallel.sharding import ShardedTree
from socioreasoner_tpu_torch.protocol import BatchProto
from tests.test_torch_context_parallel import _assert_params_within, _batch, _np, _t
from tests.test_torch_engine import _port

CPU = torch.device("cpu")


def j_layer(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def t_layer(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _stack(L, H, seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(L, H, H)) * 0.3).astype(np.float32),
            "b": (rng.normal(size=(L, H)) * 0.1).astype(np.float32)}


def _both(jfn, tfn, params, x, w, mesh):
    """(JAX's out and gradients of sum(out * w) wrt params and x, the
    port's), on the same numpy inputs."""
    def run(w, params, x):
        out, vjp = jax.vjp(jfn, params, x)
        return out, vjp(w)
    with jax.sharding.set_mesh(mesh):
        jout, (jgp, jgx) = jax.jit(run)(jnp.asarray(w), jax.tree.map(jnp.asarray, params),
                                        jnp.asarray(x))
    tparams = {k: _t(v, True) for k, v in params.items()}
    tx = _t(x, True)
    tout = tfn(tparams, tx)
    grads = torch.autograd.grad((tout * _t(w)).sum(), [tparams["w"], tparams["b"], tx])
    return (np.asarray(jout), [np.asarray(jgp["w"]), np.asarray(jgp["b"]), np.asarray(jgx)],
            _np(tout), [_np(g) for g in grads])


@pytest.mark.parametrize("S,L,n_micro", [(4, 8, 6), (2, 4, 2)])
def test_gpipe_matches_jax(S, L, n_micro):
    """pipeline_forward over S stages (cpu entries) against JAX's over an
    "sp" axis of S devices: values and the gradients wrt the stacked
    params and the input, 1e-5."""
    H, mb = 16, 4
    params = _stack(L, H, S)
    rng = np.random.default_rng(10 + S)
    x = rng.normal(size=(n_micro, mb, H)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jmesh = j_mesh.make_mesh(sp=S)
    jout, jg, tout, tg = _both(
        lambda p, x: j_pp.pipeline_forward(j_layer, p, x, jmesh, axis="sp"),
        lambda p, x: t_pp.pipeline_forward(t_layer, p, x, [CPU] * S), params, x, w, jmesh)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("vpp,n_micro", [(2, 4), (3, 6)])
def test_interleaved_matches_jax(vpp, n_micro):
    """pipeline_forward_interleaved over 2 stages of vpp chunks against
    JAX's: values and gradients, 1e-5."""
    S, H, mb = 2, 16, 3
    L = S * vpp * 2
    params = _stack(L, H, vpp)
    rng = np.random.default_rng(20 + vpp)
    x = rng.normal(size=(n_micro, mb, H)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jmesh = j_mesh.make_mesh(sp=S)
    jout, jg, tout, tg = _both(
        lambda p, x: j_pp.pipeline_forward_interleaved(j_layer, p, x, jmesh, vpp=vpp, axis="sp"),
        lambda p, x: t_pp.pipeline_forward_interleaved(t_layer, p, x, [CPU] * S, vpp=vpp),
        params, x, w, jmesh)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,vpp,n_micro", [(2, 2, 4), (4, 2, 8), (2, 3, 6), (3, 2, 3),
                                           (2, 1, 2), (4, 4, 4)])
def test_interleaved_schedule_equals_jax(S, vpp, n_micro):
    for a, b in zip(t_pp._interleaved_schedule(S, vpp, n_micro),
                    j_pp._interleaved_schedule(S, vpp, n_micro)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="n_micro % pp == 0"):
        t_pp._interleaved_schedule(2, 2, 3)


def test_pp_config_and_stage_layers():
    """PPConfig's checks and micro-batch count as JAX's; stage_layers gives
    each stage its contiguous chunk, or under vpp its virtual stages'
    chunks k*S+s."""
    mesh = t_mesh.make_mesh(pp=2, devices=[CPU] * 2)
    pp = t_pp.make_pp_config(mesh, 2)
    assert pp.micro == 2 and t_pp.make_pp_config(mesh, 2, n_micro=4).micro == 4
    assert pp.stage_layers(4) == [[0, 1], [2, 3]]
    assert t_pp.make_pp_config(mesh, 2, vpp=2).stage_layers(8) == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert t_pp.make_pp_config(mesh, 1) is None
    with pytest.raises(ValueError, match="explicit mesh"):
        t_pp.make_pp_config(None, 2)
    with pytest.raises(ValueError, match="has size 2"):
        t_pp.PPConfig(mesh=mesh, size=4)
    with pytest.raises(ValueError, match="vpp must be >= 1"):
        t_pp.PPConfig(mesh=mesh, size=2, vpp=0)
    with pytest.raises(ValueError, match="not divisible by pp×vpp=4"):
        t_pp.make_pp_config(mesh, 2, vpp=2).stage_layers(6)


# ------------------------------------------------------------------ the steps

@pytest.fixture(scope="module")
def tiny4():
    """Qwen25VLConfig.tiny() at 4 layers (pp 2 x vpp 2 splits them)."""
    config = Qwen25VLConfig.tiny()
    config = dataclasses.replace(config, text=dataclasses.replace(config.text,
                                                                  num_hidden_layers=4))
    return config, jax.tree.map(np.asarray, j_model.init_params(
        config, jax.random.key(1), jnp.float32, with_vision=False))


def _strategies(side, sc, config, np_params, shape):
    if side == "jax":
        mesh = j_mesh.make_mesh(**shape)
        wc = lambda: JWorkerConfig(strategy_args=JStrategyArgs(   # noqa: E731
            strategy_name="jax_train", strategy_config=dict(sc)))
        train = j_strat.JaxTrainStrategy(worker_config=wc(), param_store=JStore())
        infer = j_strat.JaxInferStrategy(worker_config=wc(), param_store=JStore())
        for s in (train, infer):
            s.initialize(config, jax.tree.map(jnp.asarray, np_params), mesh=mesh)
        return mesh, train, infer
    mesh = t_mesh.make_mesh(**shape, devices=[CPU] * int(np.prod(list(shape.values()))))
    wc = lambda: WorkerConfig(strategy_args=StrategyArguments(   # noqa: E731
        strategy_name="jax_train", strategy_config=dict(sc)))
    train = t_strat.TorchTrainStrategy(worker_config=wc(), param_store=ParamStore())
    infer = t_strat.TorchInferStrategy(worker_config=wc(), param_store=ParamStore())
    for s in (train, infer):
        s.initialize(_port(config), params_from_numpy(np_params, CPU), mesh=mesh)
    return mesh, train, infer


@pytest.mark.parametrize("sc,shape", [
    ({"pipeline_model_parallel_size": 2}, dict(fsdp=2, pp=2, tp=2)),
    ({"pipeline_model_parallel_size": 2, "virtual_pipeline_model_parallel_size": 2},
     dict(pp=2)),
], ids=["gpipe_fsdp2_pp2_tp2", "interleaved_pp2_vpp2"])
def test_pp_strategy_steps_match_jax(tiny4, sc, shape):
    """pipeline_model_parallel_size 2 (and virtual_pipeline_model_parallel_
    size 2) through TorchTrainStrategy and TorchInferStrategy against the
    JAX strategies over the same mesh: the log-probs and entropy within
    1e-5, the train step's metrics within rtol 1e-5, the params after it
    within 5e-5; the layer leaves stored a stage on the stages' devices."""
    config, np_params = tiny4
    batch = _batch(config, seed=3)
    out = {}
    for side in ("jax", "port"):
        mesh, train, infer = _strategies(side, sc, config, np_params, shape)
        if side == "jax":
            proto = JBatch.from_dict(tensors=dict(batch))
            with jax.sharding.set_mesh(mesh):
                out[side] = (infer.compute_log_probs(proto), train.train_step(proto),
                             train.state.params)
        else:
            proto = BatchProto.from_dict(tensors=dict(batch))
            out[side] = (infer.compute_log_probs(proto), train.train_step(proto),
                         train.state.params.gather(CPU))
            leaf = train.params["layers"]["q_w"]
            want = t_pp.make_pp_config(mesh, 2, vpp=sc.get(
                "virtual_pipeline_model_parallel_size", 1)).stage_layers(4)
            assert leaf.stages == want and len(leaf.pieces) == 2
            assert train.params["embed"].stages is None
    (jlp, jm, jparams), (tlp, tm, tparams) = out["jax"], out["port"]
    for k in ("log_probs", "entropy"):
        np.testing.assert_allclose(tlp[k], jlp[k], rtol=1e-5, atol=1e-5, err_msg=k)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_params_within(tparams, jparams, 5e-5)


def test_pp_sharded_tree_round_trip(tiny4):
    """A tree stored a stage (interleaved chunks) gathers, splits and
    assigns back to itself bit for bit, and its blocks are those of the
    stage chunks."""
    config, np_params = tiny4
    mesh = t_mesh.make_mesh(fsdp=2, pp=2, tp=2, devices=[CPU] * 8)
    stages = t_pp.make_pp_config(mesh, 2, vpp=2).stage_layers(4)
    tree = params_from_numpy(np_params, CPU)
    sharded = ShardedTree(tree, mesh, layer_stages=stages)
    gathered = sharded.gather(CPU)
    for a, b in zip(TT.tree_leaves(gathered), TT.tree_leaves(tree)):
        assert torch.equal(a, b)
    q = sharded["layers"]["q_w"]
    assert len(q.tensors()) == 2 * 2 * 2 and q.pieces[1][0][0].shape == (2, 32, 32)
    assert stages == [[0, 2], [1, 3]]
    assert torch.equal(q.pieces[1][0][0], tree["layers"]["q_w"][[1, 3], :32, :32])
    wholes = [torch.randn(leaf.shape) for leaf in sharded.leaves]
    parts = sharded.split_leaves(wholes)
    for a, b in zip(sharded.whole_leaves(parts, CPU), wholes):
        assert torch.equal(a, b)
    sharded.assign(gathered)
    rank = sharded.rank(0, 0)
    whole = rank.stage_layer(3, CPU)
    for k, v in whole.items():
        assert torch.equal(v, tree["layers"][k][3]), k


def test_pp_refusals(tiny4):
    """JAX's refusals with its reasons: pp with cp, pp with MoE layer
    stacks, a batch that does not split into the micro-batches, vpp with
    micro-batches that do not fill the stages' groups."""
    config, np_params = tiny4
    tconfig = _port(config)
    mesh = t_mesh.make_mesh(pp=2, devices=[CPU] * 2)
    pp = t_pp.PPConfig(mesh=mesh, size=2)
    params = ShardedTree(params_from_numpy(np_params, CPU), mesh)
    b = {k: torch.as_tensor(v) for k, v in _batch(config).items()}
    with pytest.raises(ValueError, match="batch 3 not divisible by 2 microbatches"):
        TT.make_logprob_step(tconfig, pp=pp)(params, {k: v[:3] for k, v in b.items()})
    with pytest.raises(ValueError, match="n_micro % pp == 0"):
        TT.make_logprob_step(tconfig, pp=t_pp.PPConfig(mesh=mesh, size=2, n_micro=1, vpp=2))(
            params, {k: v[:2] for k, v in b.items()})
    moe = dataclasses.replace(tconfig, text=dataclasses.replace(
        tconfig.text, n_experts=4, n_experts_per_tok=2))
    moe_params = t_model.init_params(moe, torch.Generator().manual_seed(0), device="cpu",
                                     with_vision=False)
    with pytest.raises(NotImplementedError, match="PP \\+ MoE"):
        TT.make_logprob_step(moe, pp=pp)(ShardedTree(moe_params, mesh), b)
    with pytest.raises(ValueError, match="over a train mesh"):
        TT.make_logprob_step(tconfig, pp=pp)(params_from_numpy(np_params, CPU), b)


def test_build_train_mesh_with_cp_and_pp_knobs(tmp_path):
    """build_train_mesh lays the train yaml's context_parallel_size and
    pipeline_model_parallel_size on the sp and pp axes (fsdp taking the
    rest), as JAX's ResourceManager does; vpp without pp refuses."""
    from socioreasoner_tpu.configs.rlvr_config import SocioSegConfig as JConfig
    from socioreasoner_tpu.runtime.resource_manager import ResourceManager as JRM
    from socioreasoner_tpu_torch.configs.rlvr_config import SocioSegConfig
    from socioreasoner_tpu_torch.pipeline.rlvr.build import build_train_mesh
    for knobs, want in (
            ({"context_parallel_size": 2}, {"dp": 1, "fsdp": 4, "pp": 1, "sp": 2, "tp": 1}),
            ({"pipeline_model_parallel_size": 2, "tensor_model_parallel_size": 2,
              "virtual_pipeline_model_parallel_size": 2},
             {"dp": 1, "fsdp": 2, "pp": 2, "sp": 1, "tp": 2}),
            ({"context_parallel_size": 2, "dp_size": 2, "fsdp_size": 2},
             {"dp": 2, "fsdp": 2, "pp": 1, "sp": 2, "tp": 1})):
        cfg = SocioSegConfig(output_dir=str(tmp_path))
        cfg.actor_train.strategy_args.strategy_config = dict(knobs)
        mesh = build_train_mesh(cfg, [CPU] * 8)
        jcfg = JConfig(output_dir=str(tmp_path))
        jcfg.actor_train.strategy_args.strategy_config = dict(knobs)
        jmesh = JRM().allocate_mesh("actor_train", jcfg.actor_train)
        assert mesh.shape == want == dict(zip(jmesh.axis_names, jmesh.devices.shape))
    cfg = SocioSegConfig(output_dir=str(tmp_path))
    cfg.actor_train.strategy_args.strategy_config = {"virtual_pipeline_model_parallel_size": 2}
    with pytest.raises(ValueError, match="requires pipeline_model_parallel_size > 1"):
        build_train_mesh(cfg, [CPU] * 8)
