"""The port's train plane over a device mesh against the JAX package's.

The JAX side runs on the test run's 8 virtual CPU devices (its strategies
jit over a jax Mesh); the port side on device lists of `cpu` entries, as
one controller over its data ranks (parallel/sharding.ShardedTree, the
kernels' plain versions). Both in float32 on the same numpy weights:

  * meshed log-probs (dp 2 x fsdp 2 x tp 2, the odd batch of 3 included)
    against the port's unsharded strategy and JAX's meshed one;
  * two meshed GRPO train steps against JaxTrainStrategy over the same
    mesh: metrics (ratio_mean with its pad row) and the trained params;
  * the MoE model's sharded forward and gradient, and the experts over tp;
  * vocab-parallel log-probs, entropy and gradients against the dense head;
  * one SocioSegPipeline step over a fsdp 4 x tp 2 mesh from
    ResourceManager against JAX's pipeline over the same mesh;
  * checkpoints across mesh shapes, the global norm, the reward strategy.
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
from socioreasoner_tpu.models.qwen2_5_vl.config import (Qwen25VLConfig, TextConfig,
                                                        VisionConfig)
from socioreasoner_tpu.ops import moe as j_moe
from socioreasoner_tpu.parallel import mesh as j_mesh
from socioreasoner_tpu.parallel import sharding as j_sharding
from socioreasoner_tpu.pipeline import losses as JL
from socioreasoner_tpu.protocol import BatchProto as JBatch
from socioreasoner_tpu_torch.configs.worker_config import StrategyArguments, WorkerConfig
from socioreasoner_tpu_torch.distributed import torch_strategies as t_strat
from socioreasoner_tpu_torch.distributed import trainer as TT
from socioreasoner_tpu_torch.distributed.strategy import ParamStore
from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
from socioreasoner_tpu_torch.models.qwen2_5_vl import text as t_text
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.parallel import mesh as t_mesh
from socioreasoner_tpu_torch.parallel.sharding import ShardedTree
from socioreasoner_tpu_torch.pipeline import losses as TL
from socioreasoner_tpu_torch.protocol import BatchProto
from tests.test_torch_engine import _port
from tests.test_torch_train import LR, _assert_params_close, _grpo_batch

CPU = torch.device("cpu")
MESHES = {"dp2_fsdp2_tp2": dict(dp=2, fsdp=2, tp=2), "fsdp4_tp2": dict(fsdp=4, tp=2),
          "fsdp8": dict(fsdp=8)}


def _meshes(shape):
    """(the JAX mesh on the virtual devices, the port's over 8 cpu entries)."""
    return j_mesh.make_mesh(**shape), t_mesh.make_mesh(**shape, devices=[CPU] * 8)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """Qwen25VLConfig.tiny(): the JAX init as numpy, without the ViT."""
    config = Qwen25VLConfig.tiny()
    return config, _np_tree(j_model.init_params(config, jax.random.key(3), jnp.float32,
                                                with_vision=False))


def _batches(batch, img=None, rows=None):
    """The same batch for both packages (image embeddings in meta)."""
    meta = {} if img is None else {"image_embeds": img}
    if rows is not None:
        meta["image_embeds_rows"] = rows
    return (JBatch.from_dict(tensors=dict(batch), meta=dict(meta)),
            BatchProto.from_dict(tensors=dict(batch), meta=dict(meta)))


def _logprob_batch(config, B=4, L=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, config.text.vocab_size - 10, size=(B, L))
    attn = np.ones((B, L), np.int64)
    attn[1, L - 5:] = 0
    resp = np.zeros((B, L), np.int64)
    resp[:, L // 2:] = 1
    resp *= attn
    pos = np.broadcast_to(np.clip(np.cumsum(attn, -1) - 1, 0, None)[:, None],
                          (B, 3, L)).copy()
    return {"input_ids": ids, "attention_mask": attn, "position_ids": pos,
            "response_mask": resp}


# ------------------------------------------------------------------ log-probs

@pytest.mark.parametrize("B", [4, 3])
def test_mesh_log_probs_match_jax_and_unsharded(tiny, B):
    """test_mesh_wiring.py::test_mesh_vs_single_device_parity: dp 2 x fsdp 2
    x tp 2 log-probs and entropy against the port's unsharded strategy and
    JAX's meshed strategy, rtol/atol 1e-4; the batch of 3 takes the
    pad-to-divisor route."""
    config, np_params = tiny
    jbatch, tbatch = _batches(_logprob_batch(config, B=B))
    jmesh, tmesh = _meshes(MESHES["dp2_fsdp2_tp2"])
    jsharded = j_strat.JaxInferStrategy(param_store=JStore())
    jsharded.initialize(config, jax.tree.map(jnp.asarray, np_params), mesh=jmesh)
    want = jsharded.compute_log_probs(jbatch)
    plain = t_strat.TorchInferStrategy(param_store=ParamStore())
    plain.initialize(_port(config), params_from_numpy(np_params, CPU))
    sharded = t_strat.TorchInferStrategy(param_store=ParamStore())
    sharded.initialize(_port(config), params_from_numpy(np_params, CPU), mesh=tmesh)
    assert isinstance(sharded.params, ShardedTree)
    got, ref = sharded.compute_log_probs(tbatch), plain.compute_log_probs(tbatch)
    for k in ("log_probs", "entropy"):
        assert got[k].shape == (B, 23)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


# ------------------------------------------------------------------ train steps

def _train_pair(config, np_params, shape, batch, img, rows=None, steps=2):
    """Two train steps of JaxTrainStrategy and TorchTrainStrategy over the
    same mesh shape (Adam's eps 1e-4 on both sides, as
    tests/test_torch_train.py holds the steps)."""
    jmesh, tmesh = _meshes(shape)
    loss_cfg = dict(use_kl_loss=True, kl_loss_coef=5e-3, entropy_loss_coef=0.01)
    jbatch, tbatch = _batches(batch, img, rows)
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            s = j_strat.JaxTrainStrategy(worker_config=JWorkerConfig(), param_store=JStore())
            s.initialize(config, jax.tree.map(jnp.asarray, np_params),
                         JL.PPOLossConfig(**loss_cfg), mesh=jmesh)
            s.optimizer = JT.make_optimizer(lr=LR, weight_decay=0.01, eps=1e-4)
            with jax.sharding.set_mesh(jmesh):
                s.state = JT.TrainState.create(s.state.params, s.optimizer)
            s._train_step = jax.jit(JT.make_train_step(config, s.loss_cfg, s.optimizer,
                                                       allow_flash=False))
            b = jbatch
        else:
            s = t_strat.TorchTrainStrategy(worker_config=WorkerConfig(), param_store=ParamStore())
            s.initialize(_port(config), params_from_numpy(np_params, CPU),
                         TL.PPOLossConfig(**loss_cfg), mesh=tmesh)
            s.optimizer = TT.make_optimizer(lr=LR, weight_decay=0.01, eps=1e-4)
            s.state = TT.TrainState.create(s.state.params, s.optimizer)
            s._train_step = TT.make_train_step(s.model_config, s.loss_cfg, s.optimizer)
            b = tbatch
        out[side] = (s, [s.train_step(b) for _ in range(steps)])
    return out


@pytest.mark.parametrize("shape", ["dp2_fsdp2_tp2", "fsdp4_tp2"])
def test_mesh_train_steps_match_jax(tiny, shape):
    """Two GRPO steps over the mesh against JaxTrainStrategy over the same
    mesh: every metric within rtol 1e-5 (ratio_mean read with the pad row
    of the batch of 3 counted as 0, as JAX pads), and the params after two
    steps within 1e-5 of each leaf's scale; the image embeddings of each
    rank's samples. The batch is tests/test_torch_train.py's (its first 3
    rows): the unsharded steps are held to JAX on it at the same bound."""
    config, np_params = tiny
    batch, img = _grpo_batch(config)
    batch = {k: v[:3] for k, v in batch.items()}
    out = _train_pair(config, np_params, MESHES[shape], batch, img[:9])
    (js, jm), (ts, tm) = out["jax"], out["port"]
    for want, got in zip(jm, tm):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # 3 real rows of 4: the pad row's masked ratio mean is 0
    real = t_strat.TorchTrainStrategy(param_store=ParamStore())
    real.initialize(_port(config), params_from_numpy(np_params, CPU),
                    TL.PPOLossConfig(use_kl_loss=True, kl_loss_coef=5e-3, entropy_loss_coef=0.01))
    unsharded = real.train_step(_batches(batch, img[:9])[1])
    np.testing.assert_allclose(tm[0]["actor_train/ratio_mean"],
                               unsharded["actor_train/ratio_mean"] * 3 / 4, rtol=1e-5)
    _assert_params_close(ts.state.params.gather(CPU), _np_tree(js.state.params))


def test_mesh_train_step_with_ragged_image_rows(tiny):
    """meta["image_embeds_rows"] (agentic batches' ragged counts): each rank
    takes its own samples' rows; the step equals the unsharded step on the
    same batch."""
    config, np_params = tiny
    batch, img = _grpo_batch(config, seed=5, n_img=3)
    rows = np.array([3, 3, 3, 3])
    loss_cfg = TL.PPOLossConfig()
    got = []
    for mesh in (None, t_mesh.make_mesh(fsdp=2, tp=2, devices=[CPU] * 4)):
        s = t_strat.TorchTrainStrategy(param_store=ParamStore())
        s.initialize(_port(config), params_from_numpy(np_params, CPU), loss_cfg, mesh=mesh)
        got.append(s.train_step(_batches(batch, img, rows)[1]))
    for k in got[0]:
        np.testing.assert_allclose(got[1][k], got[0][k], rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------------------------ MoE

def _moe_config():
    return Qwen25VLConfig(
        vision=VisionConfig(depth=1, hidden_size=16, intermediate_size=32,
                            num_heads=2, out_hidden_size=32),
        text=TextConfig(vocab_size=128, hidden_size=32, intermediate_size=16,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=8,
                        mrope_section=(2, 1, 1), tie_word_embeddings=False,
                        use_qk_norm=True, n_experts=4, n_experts_per_tok=2),
        bos_token_id=0, eos_token_id=1, pad_token_id=0)


def test_moe_model_sharded_train_step_matches_jax():
    """test_parallel.py::test_moe_model_sharded_train_step: the qwen3-MoE
    model with its params over dp 2 x fsdp 2 x tp 2 (experts over tp, their
    hidden dim over fsdp), the next-token loss plus 0.01 x the load-balance
    loss of the whole batch, and every leaf's gradient, against JAX's
    sharded value_and_grad."""
    config = _moe_config()
    np_params = _np_tree(j_model.init_params(config, jax.random.key(0), with_vision=False))
    ids = np.random.default_rng(0).integers(2, 100, (4, 8))
    pos = np.broadcast_to(np.arange(8)[None, None], (4, 3, 8)).astype(np.int64)
    jmesh, tmesh = _meshes(MESHES["dp2_fsdp2_tp2"])

    def jloss(p):
        logits, aux = j_model.forward(config, p, jnp.asarray(ids), jnp.asarray(pos), None)
        lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(lp, jnp.asarray(ids)[:, 1:, None], axis=-1).mean()
        return nll + 0.01 * aux["moe_aux"]

    with jax.sharding.set_mesh(jmesh):
        jl, jg = jax.jit(jax.value_and_grad(jloss))(
            j_sharding.shard_params(jax.tree.map(jnp.asarray, np_params), jmesh))
    sharded = ShardedTree(params_from_numpy(np_params, CPU), tmesh)
    assert sharded["layers"]["gate_w"].blocks[0][0].shape == (2, 2, 16, 16)
    blocks = sharded.blocks()
    for b in blocks:
        b.requires_grad_(True)
    ids_t, pos_t = torch.as_tensor(ids), torch.as_tensor(pos)
    logits, aux = t_model.forward_mesh(_port(config), *sharded.data_ranks(4), ids_t, pos_t)
    lp = torch.log_softmax(torch.cat(logits)[:, :-1].float(), dim=-1)
    nll = -torch.gather(lp, -1, ids_t[:, 1:, None])[..., 0].mean()
    loss = nll + 0.01 * aux["moe_aux"]
    grads = torch.autograd.grad(loss, blocks, allow_unused=True)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    whole = sharded.whole_leaves([torch.zeros_like(b) if g is None else g
                                  for b, g in zip(blocks, grads)])
    for (name, _), g in zip(_named(np_params), whole):
        want = np.asarray(_get(jg, name))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-3), err_msg=name)


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _get(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def test_moe_sharded_over_tp_matches_jax():
    """test_parallel.py::test_moe_sharded_over_tp: the expert stacks split
    by moe_param_specs over a fsdp 4 x tp 2 mesh, one tp block a shard
    gathered over fsdp; the router and the shards' expert sums against
    JAX's moe_mlp on its sharded params."""
    jp = j_moe.init_moe_params(jax.random.key(0), 32, 64, n_experts=4)
    x = jax.random.normal(jax.random.key(1), (16, 32))
    jmesh, tmesh = _meshes(MESHES["fsdp4_tp2"])
    specs = j_moe.moe_param_specs()
    from jax.sharding import NamedSharding
    jsharded = {k: jax.device_put(v, NamedSharding(jmesh, specs[k])) for k, v in jp.items()}
    want, want_aux = jax.jit(lambda x, p: j_moe.moe_mlp(x, p, top_k=2))(x, jsharded)
    tp = params_from_numpy(_np_tree(jp), CPU)
    # the layer-stacked layout of the decoder tree: one layer
    sharded = ShardedTree({"layers": {k: v[None] for k, v in tp.items()}}, tmesh,
                          specs={"layers": {k: (None,) + tuple(s) for k, s in
                                            t_sharding_moe_specs().items()}})
    assert sharded["layers"]["gate_w"].blocks[1][1].shape == (1, 2, 8, 64)
    ps = sharded.rank(0, 0).layer(0)
    xt = torch.as_tensor(np.asarray(x))[None]
    cfg = _port(_moe_config()).text
    cfg = dataclasses.replace(cfg, n_experts=4, n_experts_per_tok=2, norm_topk_prob=True)
    out, stats = t_text._moe(cfg, ps, xt, [xt, xt], CPU, with_stats=True)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(t_text.moe_aux_from_stats(stats, 16)), float(want_aux),
                               rtol=1e-5)


def t_sharding_moe_specs():
    """The port's spec table for the expert stacks, without the layer dim."""
    from socioreasoner_tpu_torch.parallel.sharding import MOE_SPECS
    return {k: tuple(MOE_SPECS[k])[1:] for k in ("router_w", "gate_w", "up_w", "down_w")}


# ------------------------------------------------------------------ vocab parallel

def test_strategy_vocab_parallel_logprobs(tiny):
    """test_parallel.py::test_strategy_vocab_parallel_logprobs: the
    vocab_parallel_logprobs knob routes the head through
    ops/vocab_parallel.py; log-probs and entropy within 1e-5 of the dense
    head's and of JAX's, and their gradients within 1e-5 of the dense
    head's."""
    config, np_params = tiny
    jmesh, tmesh = _meshes(MESHES["dp2_fsdp2_tp2"])
    jbatch, tbatch = _batches(_logprob_batch(config, B=4, L=12, seed=1))

    def run(strategy_config, side):
        if side == "jax":
            wc = JWorkerConfig(strategy_args=JStrategyArgs(
                strategy_name="jax_infer", strategy_config=strategy_config))
            s = j_strat.JaxInferStrategy(worker_config=wc)
            s.initialize(config, jax.tree.map(jnp.asarray, np_params), mesh=jmesh)
            with jax.sharding.set_mesh(jmesh):
                return s.compute_log_probs(jbatch)
        wc = WorkerConfig(strategy_args=StrategyArguments(
            strategy_name="jax_infer", strategy_config=strategy_config))
        s = t_strat.TorchInferStrategy(worker_config=wc, param_store=ParamStore())
        s.initialize(_port(config), params_from_numpy(np_params, CPU), mesh=tmesh)
        return s.compute_log_probs(tbatch)

    dense, vp = run({}, "port"), run({"vocab_parallel_logprobs": True}, "port")
    jvp = run({"vocab_parallel_logprobs": True}, "jax")
    for k in ("log_probs", "entropy"):
        np.testing.assert_allclose(vp[k], dense[k], rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(vp[k], jvp[k], rtol=1e-5, atol=1e-5, err_msg=k)

    sharded = ShardedTree(params_from_numpy(np_params, CPU), tmesh)
    blocks = sharded.blocks()
    batch = {k: torch.as_tensor(v) for k, v in tbatch.batch.items()}
    grads = []
    for vp_mesh in (None, tmesh):
        for b in blocks:
            b.requires_grad_(True)
        lp, ent = TT._model_log_probs(_port(config), sharded, batch, remat=False,
                                      vp_mesh=vp_mesh)
        grads.append(torch.autograd.grad((lp * 0.7 + ent * 0.3).sum(), blocks,
                                         allow_unused=True))
    for b in blocks:
        b.requires_grad_(False)
    for gd, gv in zip(*grads):
        if gd is None:
            assert gv is None
            continue
        torch.testing.assert_close(gv, gd, rtol=1e-5, atol=1e-5 * float(gd.abs().max()) + 1e-7)


def test_vocab_parallel_ops_match_jax():
    """The reductions alone on uneven blocks: three blocks of a vocabulary
    of 50, labels in every block, against JAX's shard-free log-softmax."""
    from socioreasoner_tpu_torch.ops.vocab_parallel import (vocab_parallel_entropy,
                                                            vocab_parallel_log_probs)
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(2, 7))
    blocks = [torch.as_tensor(b) for b in np.split(logits, [17, 34], axis=-1)]
    lp = vocab_parallel_log_probs(blocks, torch.as_tensor(labels))
    ent = vocab_parallel_entropy(blocks, CPU)
    jl = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    want = np.take_along_axis(np.asarray(jl), labels[..., None], axis=-1)[..., 0]
    np.testing.assert_allclose(lp.numpy(), want, rtol=1e-5, atol=1e-5)
    want_ent = -(np.exp(np.asarray(jl)) * np.asarray(jl)).sum(-1)
    np.testing.assert_allclose(ent.numpy(), want_ent, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ norm, checkpoints

def test_global_norm_counts_a_replicated_leaf_once(tiny):
    """Over tp 2 x fsdp 2 the norms (input_ln, final_ln: spec P()) are one
    block each, the projections four: the global norm of a gradient of ones
    on every block equals that of the whole tree's leaves."""
    config, np_params = tiny
    sharded = ShardedTree(params_from_numpy(np_params, CPU),
                          t_mesh.make_mesh(fsdp=2, tp=2, devices=[CPU] * 4))
    assert len(sharded["layers"]["input_ln"].tensors()) == 1
    assert len(sharded["layers"]["q_w"].tensors()) == 4
    assert len(sharded["embed"].tensors()) == 4
    ones = [torch.ones_like(b) for b in sharded.blocks()]
    whole = TT.tree_leaves(params_from_numpy(np_params, CPU))
    want = float(np.sqrt(sum(x.numel() for x in whole)))
    np.testing.assert_allclose(float(TT.global_norm(ones)), want, rtol=1e-6)


@pytest.mark.parametrize("direction", ["mesh_to_plain", "plain_to_mesh"])
def test_checkpoint_moves_across_mesh_shapes(tiny, tmp_path, direction):
    """A checkpoint saved from a meshed strategy (fsdp 2 x tp 2) loads into
    an unsharded one bit for bit, and the reverse: params, moments, the
    update count and the step; the next step then matches too."""
    config, np_params = tiny
    batch, img = _grpo_batch(config, seed=6)
    tbatch = _batches(batch, img)[1]
    meshes = {"mesh": t_mesh.make_mesh(fsdp=2, tp=2, devices=[CPU] * 4), "plain": None}
    src, dst = direction.split("_to_")

    def strategy(mesh, ckpt):
        s = t_strat.TorchTrainStrategy(worker_config=WorkerConfig(), param_store=ParamStore())
        s.initialize(_port(config), params_from_numpy(np_params, CPU), TL.PPOLossConfig(),
                     checkpoint_dir=str(ckpt), mesh=mesh)
        return s

    a = strategy(meshes[src], tmp_path / "a")
    a.train_step(tbatch)
    a.save_checkpoint(1, meta={"k": 1}, wait=True)
    b = strategy(meshes[dst], tmp_path / "a")
    assert b.load_checkpoint() == {"k": 1}
    ta, tb = a._checkpoint_tree(), b._checkpoint_tree()
    from socioreasoner_tpu_torch.utils.checkpoint import flatten
    fa, fb = flatten(ta), flatten(tb)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k
    ma, mb = a.train_step(tbatch), b.train_step(tbatch)
    for k in ma:
        np.testing.assert_allclose(mb[k], ma[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_reward_strategy_over_a_mesh(tiny):
    """TorchRewardStrategy with the body over dp 2 x tp 2 and the value head
    whole: the values of an odd batch equal the unsharded strategy's."""
    config, np_params = tiny
    params = TT.add_value_head(params_from_numpy(np_params, CPU),
                               torch.Generator().manual_seed(0), config.text.hidden_size)
    _, tbatch = _batches(_logprob_batch(config, B=3))
    got = []
    for mesh in (None, t_mesh.make_mesh(dp=2, tp=2, devices=[CPU] * 4)):
        s = t_strat.TorchRewardStrategy(worker_config=WorkerConfig(), param_store=ParamStore())
        s.initialize(_port(config), dict(params), mesh=mesh)
        got.append(s.compute_values(tbatch))
    assert got[1].shape == (3, 23)
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5, atol=1e-6)


def test_tp_must_divide_the_heads(tiny):
    config, np_params = tiny
    s = t_strat.TorchTrainStrategy(worker_config=WorkerConfig(), param_store=ParamStore())
    with pytest.raises(ValueError, match="H=4, Hkv=2"):
        s.initialize(_port(config), params_from_numpy(np_params, CPU),
                     mesh=t_mesh.make_mesh(tp=4, devices=[CPU] * 4))
    wc = WorkerConfig(strategy_args=StrategyArguments(
        strategy_name="jax_train", strategy_config={"context_parallel_size": 2}))
    with pytest.raises(ValueError, match="requires an explicit mesh"):
        t_strat.TorchTrainStrategy(worker_config=wc).initialize(
            _port(config), params_from_numpy(np_params, CPU))


# ------------------------------------------------------------------ the pipeline

def test_train_pipeline_over_tp2_mesh(tmp_path):
    """test_mesh_wiring.py::test_train_pipeline_over_tp2_mesh: one
    SocioSegPipeline step with actor_train and the reference over the fsdp 4
    x tp 2 mesh ResourceManager lays from tensor_model_parallel_size 2 over
    eight devices, through the scripted decode worker of
    tests/test_torch_grpo_pipeline.py, against JAX's pipeline over the same
    mesh: each stage's losses, KL, grad norm and ratio_mean within rtol
    1e-5, and the rollout tree after model_update equal to the gathered
    shards."""
    from socioreasoner_tpu.runtime.resource_manager import ResourceManager as JRM
    from socioreasoner_tpu_torch.runtime.resource_manager import ResourceManager
    from tests import test_torch_grpo_pipeline as g

    def build(side):
        cfg = g._config(side, str(tmp_path / side), strategy_config={"prefix_fork": True},
                        max_steps=1)
        cfg.actor_train.strategy_args.strategy_config = {"tensor_model_parallel_size": 2}
        rm = JRM() if side == "jax" else ResourceManager([CPU] * 8)
        mesh = rm.allocate_mesh("actor_train", cfg.actor_train)
        assert mesh.shape["fsdp"] == 4 and mesh.shape["tp"] == 2
        orig = g._config
        g._config = lambda *a, **kw: cfg
        try:
            pipe = _build_meshed(g, side, mesh)
        finally:
            g._config = orig
        return pipe

    out = {}
    for side in ("jax", "port"):
        pipe = build(side)
        out[side] = (pipe, pipe.run())
    (jpipe, jm), (tpipe, tm) = out["jax"], out["port"]
    assert isinstance(tpipe.actor_train.params, ShardedTree)
    for stage in ("map", "sat"):
        for k in g.STAGE_METRICS + ("actor_train/ratio_mean",):
            key = f"{stage}/{k}"
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, atol=1e-6, err_msg=key)
    tpipe.actor_train.model_update()
    rollout = tpipe.param_store.get("rollout")
    for a, b in zip(TT.tree_leaves(rollout),
                    TT.tree_leaves(tpipe.actor_train.params.gather(CPU))):
        assert torch.equal(a, b)


def _build_meshed(g, side, mesh):
    """tests/test_torch_grpo_pipeline.py's _build with the train mesh."""
    import functools as ft
    if side == "jax":
        orig = g.JPipeline
        g.JPipeline = ft.partial(orig, mesh=mesh)
    else:
        orig = g.SocioSegPipeline
        g.SocioSegPipeline = ft.partial(orig, mesh=mesh)
    try:
        return g._build(side, "unused")
    finally:
        if side == "jax":
            g.JPipeline = orig
        else:
            g.SocioSegPipeline = orig


# ------------------------------------------------------------------ chip_smoke

def test_chip_smoke_train_mesh_phase_on_cpu(tmp_path):
    """chip_smoke's train_mesh phase rehearsed at a tiny config in float32
    on cpu entries: (a)-(b) the strategies unsharded, over fsdp 2 and fsdp 2
    x tp 2 within the phase's limits, kernels 4-6 (their plain versions)
    counted by shard at the local heads; (c) the pipeline step over
    build_train_mesh's fsdp 2 against one device, the rollout tree the int8
    copy of the gathered shards; (d) two gloo processes of
    chip_smoke.train_mesh_worker."""
    import chip_smoke
    from socioreasoner_tpu_torch.datasets import processor as t_processor
    from socioreasoner_tpu_torch.models.sam2 import model as t_sam
    from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
    from tests.test_torch_pipeline import _tokenizer
    config = chip_smoke.train_mesh_config(2, _port(Qwen25VLConfig.tiny(512)))
    assert config.text.num_hidden_layers == 2
    params = chip_smoke.train_mesh_params(config, CPU, torch.float32)
    batch = chip_smoke.train_mesh_batch(config, params, CPU, lens=(40, 33, 37), L=48)
    meshes = {name: {"axes": axes, "devices": [CPU] * int(np.prod(list(axes.values())))}
              for name, axes in chip_smoke.TRAIN_MESH_MESHES.items()}
    res = chip_smoke.run_mesh_strategies(config, params, CPU, meshes, batch, lr=1e-3)
    assert chip_smoke.check_mesh_strategies(res) == []
    tp = res["fsdp2_tp2"]["train_launches"]
    # 2 steps x 2 layers x 2 ranks x 2 shards x (2 forwards under remat, dq, dk/dv)
    assert tp["missing_or_off"] == [] and tp["launches"] == 2 * 2 * 2 * 2 * 4
    assert res["fsdp2"]["diffs"]["param_max_over_limit"] < 1e-2

    img_cfg = t_processor.ImageProcessorConfig(defer_patchify=True, min_pixels=56 * 56,
                                               max_pixels=56 * 56 * 4)
    processor = t_processor.SocioProcessor(_tokenizer(t_processor.SimpleTokenizer), img_cfg,
                                           image_token_id=config.image_token_id)
    sam_config = Sam2Config.tiny_test()
    sam_params = t_sam.init_params(sam_config, torch.Generator().manual_seed(1), device="cpu")
    full = t_model.init_params(config, torch.Generator().manual_seed(3), device="cpu")
    pipes = {name: chip_smoke.run_mesh_pipeline(
        config, chip_smoke._clone(full), sam_config, sam_params, str(tmp_path / name), CPU,
        devices, tile_px=96, img_cfg=img_cfg, processor=processor, prompt_length=640,
        response_length=8) for name, devices in (("unsharded", [CPU]), ("fsdp2", [CPU] * 2))}
    assert pipes["unsharded"]["mesh"] is None and pipes["fsdp2"]["mesh"]["fsdp"] == 2
    assert all(p["rollout_equal_quantized_gather"] for p in pipes.values())
    assert {s[0] for s in pipes["fsdp2"]["kernel_shapes"]} == {1, 4}
    for k, v in pipes["unsharded"]["metrics"].items():
        np.testing.assert_allclose(pipes["fsdp2"]["metrics"][k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)

    workers, one = chip_smoke.run_mesh_processes(config, CPU, batch, str(tmp_path),
                                                 seed=chip_smoke.TRAIN_MESH_SEED,
                                                 dtype="float32", lr=1e-3, timeout=240)
    assert chip_smoke.check_mesh_processes(workers, one) == []
    np.testing.assert_allclose(workers[0]["loss"], one["loss"], rtol=1e-5)
