"""The port's SocioSegPipeline (GRPO over both SocioSeg stages) against the
JAX package's.

Tiny Qwen2.5-VL and tiny SAM2 (the configs of
tests/test_train_pipeline_e2e.py) in float32, JAX and port weights from one
seed through the weight bridges; a decode worker that answers each sample
with its own crafted stage-1 and stage-2 text, so that SAM2 masks flow and
the rewards differ within a group; two steps on both sides, overlapped
(with a validation after the second step) and sequential (the yaml's int8
single-copy rollout weights, updated every second step): the texts, masks
and reward arrays equal, the metrics within float32 rounding, the trained
weights within 1e-5 of each leaf's scale, and the engine's weights those of
the JAX pipeline's last update. Then the other repairs of the weight flow:
the step argument and the reference's own weights. The real tiny engines, the
checkpoint resume, the reward worker_cls and chip_smoke's grpo phase are in
tests/test_torch_grpo_engine.py.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.configs import worker_config as j_wc
from socioreasoner_tpu.configs.rlvr_config import SocioSegConfig as JConfig
from socioreasoner_tpu.datasets import socioseg as j_seg
from socioreasoner_tpu.datasets.processor import (ImageProcessorConfig as JImageConfig,
                                                  SocioProcessor as JProcessor)
from socioreasoner_tpu.distributed import trainer as JT
from socioreasoner_tpu.models.qwen2_5_vl import model as j_qwen
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.models.sam2 import model as j_sam
from socioreasoner_tpu.models.sam2.config import Sam2Config as JSam2Config
from socioreasoner_tpu.pipeline.rlvr.socioseg_pipeline import SocioSegPipeline as JPipeline
from socioreasoner_tpu.runtime.generate_scheduler import LocalGenerateGroup as JGroup
from socioreasoner_tpu_torch.configs import worker_config as t_wc
from socioreasoner_tpu_torch.configs.rlvr_config import SocioSegConfig
from socioreasoner_tpu_torch.datasets import processor as t_processor
from socioreasoner_tpu_torch.datasets import socioseg as t_seg
from socioreasoner_tpu_torch.distributed import trainer as TT
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
from socioreasoner_tpu_torch.pipeline.rlvr.socioseg_pipeline import SocioSegPipeline
from socioreasoner_tpu_torch.runtime.generate_scheduler import LocalGenerateGroup
from tests.test_infer_pipeline_e2e import TinyTokenizer, make_tiles
from tests.test_torch_engine import _port
from tests.test_torch_pipeline import _tokenizer
from tests.test_torch_train import _assert_params_close

VOCAB = 512
IMG = dict(min_pixels=56 * 56, max_pixels=56 * 56 * 4)
ENGINE = {"max_slots": 4, "max_len": 700, "decode_chunk": 4, "prefill_buckets": (640,),
          "image_buckets": (0, 16, 32)}
N_SAMPLES = 2
YAML_WORKER = "socioreasoner_tpu.pipeline.base_worker.SocioSegRuleRewardWorker"

# crafted answers, one a sample (tile i, sample j → k = i * n + j), in the
# 756 × 756 space of the resized tile; the gt box of make_tiles' mask is
# (20, 20, 49, 49). Stage 2 echoes stage 1's boxes with points, or not.
S1_ANSWERS = [
    '<think>a</think><answer>[{"bbox_2d": [20, 20, 50, 50]}, '
    '{"bbox_2d": [300, 320, 700, 740]}]</answer>',
    '<think>b</think><answer>[{"bbox_2d": [100, 120, 480, 460]}]</answer>',
    '<answer>[{"bbox_2d": [22, 19, 49, 51]}]</answer>',
    '<think>d</think><answer>[{"bbox_2d": [1, 2</answer>',
]
S2_ANSWERS = [
    '<think>a</think><answer>[{"bbox_2d": [20, 20, 50, 50], "points": [[30, 30], [40, 41]]}, '
    '{"bbox_2d": [300, 320, 700, 740], "points": [[500, 600]]}]</answer>',
    '<think>b</think><answer>[{"bbox_2d": [100, 120, 480, 460], '
    '"points": [[100, 300], [200, 200], [300, 400], [400, 150]]}]</answer>',
    '<think>c</think><answer>[{"bbox_2d": [22, 19, 49, 51], "points": [[35, 35]]}]</answer>',
    'no answer tags at all',
]


class ScriptedWorker:
    """A decode worker that answers sample k of stage 1 with the tokens of
    S1_ANSWERS[k] and of stage 2 with S2_ANSWERS[k] (validation's samples
    too), in server and in batch mode, whichever package's request enum
    it is handed."""

    def __init__(self, tokenizer, pad_id: int, n: int = N_SAMPLES):
        self.s1 = [list(tokenizer.encode(a)) for a in S1_ANSWERS]
        self.s2 = [list(tokenizer.encode(a)) for a in S2_ANSWERS]
        self.pad_id, self.n = pad_id, n
        self.requests = []

    def start_server(self, data=None):
        pass

    def stop_server(self):
        pass

    def add_request(self, command, data):
        if command.name != "ADD":
            return {"alive": True} if command.name == "ALIVE_CHECK" else None
        rid = data["request_id"]
        self.requests.append(rid)
        if rid[0] in ("s1", "s2"):
            ids = (self.s1 if rid[0] == "s1" else self.s2)[rid[1]]
        else:                           # GenerateScheduler: (prompt, sample, worker)
            ids = self.s1[rid[0] * self.n + rid[1]]
        data["callback"](SimpleNamespace(request_id=rid, output_ids=list(ids),
                                         finish_reason="stop"))

    def generate(self, batch, generating_args):
        """Batch mode: stage 2 of the sequential rollout, one row a sample."""
        ids = np.asarray(batch.batch["input_ids"])
        rows = [self.s2[k] for k in range(len(ids))]
        width = max(len(r) for r in rows)
        out = np.full((len(ids), ids.shape[1] + width), self.pad_id, np.int64)
        out[:, :ids.shape[1]] = ids
        for k, r in enumerate(rows):
            out[k, ids.shape[1]:ids.shape[1] + len(r)] = r
        return out


@functools.lru_cache(maxsize=1)
def _weights():
    """(config, policy numpy tree, SAM2 numpy tree): the SAM2 mask
    projections scaled ×1000 so that the mask logits (~0.1, not ~1e-4)
    agree in sign between the two packages."""
    config = Qwen25VLConfig.tiny(VOCAB)
    qwen = jax.tree.map(np.asarray, j_qwen.init_params(config, jax.random.key(0),
                                                       dtype=jnp.float32))
    sam = jax.tree.map(np.asarray, jax.jit(functools.partial(
        j_sam.init_params, JSam2Config.tiny_test()))(jax.random.key(1)))
    for m in sam["decoder"]["hyper_mlps"]:
        m["fc_out_w"] = m["fc_out_w"] * 1000.0
    return config, qwen, sam


def _config(side, out_dir, *, strategy_config, max_steps=2, overlap=True, opt_level=1,
            frequency=1, eval_steps=0, save_steps=-1, resume=False,
            worker_cls=None, greedy=False, response_length=192):
    cls, wc = (JConfig, j_wc) if side == "jax" else (SocioSegConfig, t_wc)
    rewards = {} if worker_cls is None else {
        "socioseg_rule": wc.WorkerConfig(worker_cls=worker_cls, world_size=16,
                                         infer_batch_size=4)}
    cfg = cls(output_dir=out_dir, rollout_batch_size=2, prompt_length=640,
              response_length=response_length, save_steps=save_steps,
              track_with="stdout", max_steps=max_steps, eval_steps=eval_steps,
              resume_from_checkpoint=resume,
              num_return_sequences_in_group=N_SAMPLES, adv_estimator="grpo",
              use_kl_loss=True, kl_loss_coef=5e-3, reward_clip=10.0, advantage_clip=10.0,
              entropy_loss_coef=0.01, generate_opt_level=opt_level, overlap_restage=overlap,
              rewards=rewards)
    ga = cfg.actor_infer.generating_args
    ga.max_new_tokens, ga.num_return_sequences = 6, N_SAMPLES
    if greedy:
        ga.temperature = 0.0
    cfg.actor_infer.model_update_frequency = frequency
    cfg.actor_infer.strategy_args.strategy_name = "jax_decode"
    cfg.actor_infer.strategy_args.strategy_config = strategy_config
    ta = cfg.actor_train.training_args
    ta.learning_rate, ta.weight_decay, ta.gradient_accumulation_steps = 1e-4, 1e-2, 2
    cfg.actor_train.backward_batch_size = 4
    return cfg


def _adam_eps(side, pipe, cfg, eps=1e-4):
    """The actor's optimizer with Adam's eps at 1e-4 on both sides, as the
    train-step tests hold it (tests/test_torch_train.py): with 1e-8, an
    element whose gradient is float32 noise (the k bias, which the softmax
    cannot see) moves by a learning rate whose sign the noise decides, and
    the comparison would test the rounding, not the math."""
    ta, actor = cfg.actor_train.training_args, pipe.actor_train
    mod = JT if side == "jax" else TT
    actor.optimizer = mod.make_optimizer(
        lr=ta.learning_rate, weight_decay=ta.weight_decay, eps=eps,
        gradient_accumulation_steps=ta.gradient_accumulation_steps)
    actor.state = mod.TrainState.create(actor.state.params, actor.optimizer)
    step = mod.make_train_step(actor.model_config, actor.loss_cfg, actor.optimizer)
    actor._train_step = jax.jit(step) if side == "jax" else step


def _build(side, out_dir, *, scripted=True, val=False, quant=False, same_reference=False,
           **cfg_kw):
    """One package's pipeline on the shared weights and the two tiles; with
    `scripted`, decode goes through ScriptedWorker; with `quant`, the yaml's
    int8 single-copy decode weights; with `same_reference` (the port only),
    one tree is passed as the policy and as the reference."""
    config, qwen, sam = _weights()
    knobs = {"weight_quant": "int8", "single_copy_quant": True} if quant else {}
    cfg = _config(side, out_dir, strategy_config=dict(knobs, prefix_fork=True), **cfg_kw)
    engine_kwargs = {**ENGINE, **knobs}
    if side == "jax":
        img_cfg = JImageConfig(**IMG)
        dataset = [j_seg.encode_sample(t, img_cfg) for t in make_tiles(2)]
        tree = lambda t: jax.tree.map(jnp.asarray, t)   # noqa: E731
        pipe = JPipeline(
            cfg, model_config=config, policy_params=tree(qwen), reference_params=tree(qwen),
            sam_config=JSam2Config.tiny_test(), sam_params=tree(sam),
            processor=JProcessor(TinyTokenizer(), img_cfg,
                                 image_token_id=config.image_token_id),
            dataset=dataset, val_dataset=dataset if val else None,
            engine_kwargs={**engine_kwargs, "sampler_exact": True, "cache_dtype": jnp.float32})
        group = JGroup
    else:
        img_cfg = t_processor.ImageProcessorConfig(**IMG)
        dataset = [t_seg.encode_sample(t, img_cfg) for t in make_tiles(2)]
        policy = params_from_numpy(qwen, "cpu")
        pipe = SocioSegPipeline(
            cfg, model_config=_port(config), policy_params=policy,
            reference_params=policy if same_reference else params_from_numpy(qwen, "cpu"),
            sam_config=Sam2Config.tiny_test(), sam_params=params_from_numpy(sam, "cpu"),
            processor=t_processor.SocioProcessor(_tokenizer(t_processor.SimpleTokenizer),
                                                 img_cfg,
                                                 image_token_id=config.image_token_id),
            dataset=dataset, val_dataset=dataset if val else None,
            engine_kwargs={**engine_kwargs, "cache_dtype": torch.float32})
        group = LocalGenerateGroup
    _adam_eps(side, pipe, cfg)
    if scripted:
        worker = ScriptedWorker(pipe.processor.tokenizer, config.pad_token_id)
        pipe.decode_replicas = [worker]
        pipe.decode_group = group([worker])
        pipe.generate_scheduler.cluster = pipe.decode_group
    return pipe


def _capture(pipe):
    """Wrap the pipeline's _rollout and _compute_rewards to record each
    step's rollout outputs and rewards."""
    seen = {"rollouts": [], "rewards": []}
    rollout, rewards = pipe._rollout, pipe._compute_rewards

    def _rollout(*a, **kw):
        seen["rollouts"].append(rollout(*a, **kw))
        return seen["rollouts"][-1]

    def _compute_rewards(*a, **kw):
        seen["rewards"].append(rewards(*a, **kw))
        return seen["rewards"][-1]
    pipe._rollout, pipe._compute_rewards = _rollout, _compute_rewards
    return seen


def _run_pair(tmp_path, **kw):
    out = {}
    for side in ("jax", "port"):
        pipe = _build(side, str(tmp_path / side), **kw)
        seen = _capture(pipe)
        metrics = pipe.run()
        out[side] = (pipe, seen, metrics)
    return out


STAGE_METRICS = ("critic/kl", "critic/reward_mean", "actor_train/total_loss",
                 "actor_train/pg_loss", "actor_train/kl_loss", "actor_train/grad_norm")


def _assert_rollouts_equal(got, want):
    for key in ("map_texts", "sat_texts", "bbox_texts"):
        assert got[key] == want[key], key
    for key in ("map_masks", "sat_masks"):
        for a, b in zip(got[key], want[key]):
            assert a.shape == (768, 768) and a.dtype == np.uint8
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=key)
    for key in ("seqs1", "seqs2", "s2_input_ids", "s2_attention_mask", "s2_position_ids"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


# The two scripted runs, each also a case of the weight-flow repair: the
# overlapped one validates after its second step's training (the rollout
# weights must be those of that step's update); the sequential one runs the
# yaml's int8 single-copy rollout weights and updates them every second step
# (the second step rolls out on the first step's weights, its float leaves
# included).
SCRIPTED = {"overlapped": dict(overlap=True, val=True, eval_steps=2),
            "sequential": dict(overlap=False, quant=True, frequency=2)}


@pytest.fixture(scope="module", params=sorted(SCRIPTED))
def scripted(request, tmp_path_factory):
    return request.param, _run_pair(tmp_path_factory.mktemp("scripted"),
                                     **SCRIPTED[request.param])


def test_scripted_rollouts_and_rewards_match_jax(scripted):
    """Two steps: the same texts, masks and sequences each step, and every
    reward array equal; SAM2 masks flow and the rewards differ within a
    group."""
    _, out = scripted
    (_, jseen, _), (_, tseen, _) = out["jax"], out["port"]
    assert len(tseen["rollouts"]) == len(jseen["rollouts"]) == 2
    for got, want in zip(tseen["rollouts"], jseen["rollouts"]):
        _assert_rollouts_equal(got, want)
    for got, want in zip(tseen["rewards"], jseen["rewards"]):
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "metrics":
                assert got[k] == want[k]
            else:
                np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    ro, rw = tseen["rollouts"][0], tseen["rewards"][0]
    assert ro["map_texts"] == S1_ANSWERS and ro["sat_texts"] == S2_ANSWERS
    assert all(0 < m.sum() < 768 * 768 for m in ro["map_masks"][:3] + ro["sat_masks"][:3])
    assert not ro["map_masks"][3].any() and not ro["sat_masks"][3].any()
    for key in ("map_response_level_rewards", "sat_response_level_rewards"):
        r = rw[key].reshape(2, N_SAMPLES)
        assert (r[:, 0] != r[:, 1]).all(), (key, r)


def test_scripted_metrics_and_params_match_jax(scripted):
    """Each stage's KL, reward mean and train-step losses and grad norm
    within float32 rounding (rtol 1e-5, atol 1e-6, as the train steps are
    held), the same metric keys, and the trained weights after two steps
    within 1e-5 of each leaf's scale."""
    _, out = scripted
    (jpipe, _, jm), (tpipe, _, tm) = out["jax"], out["port"]
    assert tpipe.state.step == jpipe.state.step == 2
    assert set(tm) == set(jm)
    for stage in ("map", "sat"):
        for k in STAGE_METRICS:
            key = f"{stage}/{k}"
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, atol=1e-6, err_msg=key)
        assert tm[f"{stage}/actor_train/grad_norm"] > 0
    for step in range(2):
        got, want = tpipe.state.log_history[step], jpipe.state.log_history[step]
        for k in want:
            if k.startswith(("critic/", "map/critic", "sat/critic")):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_params_close(tpipe.actor_train.params, jax.tree.map(np.asarray,
                                                                jpipe.actor_train.params))


# -------------------------------------------------------- weight-flow repairs

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_rollout_weights_are_those_of_the_last_update(scripted):
    """After the scripted runs -- validation after the second step's
    training, and int8 single-copy weights updated every second step -- the
    decode engine's weights, every float leaf it shares with the trainer
    included, equal the JAX pipeline's rollout tree of the last update, not
    the trainer's weights after the steps since; the int8 codes equal the
    JAX codes."""
    name, out = scripted
    (jpipe, _, jm), (tpipe, _, tm) = out["jax"], out["port"]
    engine = tpipe.actor_infer.engine.params
    want = dict(_leaves(jax.tree.map(np.asarray, jpipe.param_store.get("rollout"))))
    assert sorted(n for n, _ in _leaves(engine)) == sorted(want)
    floats = {n: t for n, t in _leaves(engine) if t.is_floating_point()}
    codes = {n: t for n, t in _leaves(engine) if not t.is_floating_point()}
    _assert_params_close(floats, {n: want[n] for n in floats})
    for leaf, t in codes.items():
        np.testing.assert_array_equal(t.numpy(), want[leaf], err_msg=leaf)
    assert bool(codes) == SCRIPTED[name].get("quant", False)
    trainer = dict(_leaves(tpipe.actor_train.params))
    moved = [n for n, t in floats.items() if n in trainer and not torch.equal(t, trainer[n])]
    assert "embed" in moved and len(moved) > len(floats) // 2
    ptrs = {t.untyped_storage().data_ptr() for t in trainer.values()}
    assert not any(t.untyped_storage().data_ptr() in ptrs for t in floats.values())
    if SCRIPTED[name].get("val"):
        assert "val_iou/mean" in tm and tm["val_iou/mean"] == jm["val_iou/mean"]


def test_pipeline_hands_the_engine_a_tree_not_the_step(tmp_path):
    """BasePipeline.model_update passes the step to both ends; the decode
    strategy ignores it, as the JAX strategies do, and refuses weights that
    are not a mapping."""
    pipe = _build("port", str(tmp_path), max_steps=1)
    pipe.run()
    tree = pipe.param_store.get("rollout")
    assert isinstance(tree, dict) and tree["embed"] is pipe.actor_infer.engine.params["embed"]
    pipe.actor_infer.model_update(7)
    assert pipe.param_store.get("rollout") is tree
    with pytest.raises(TypeError, match="mapping"):
        pipe.actor_infer.model_update(params=3)
    assert isinstance(pipe.param_store.get("rollout"), dict)


def test_reference_keeps_its_own_weights(tmp_path):
    """One tree passed as the policy and the reference: the pipeline gives
    the reference its own copy, so after two train steps its log-probs are
    unchanged while the actor's have moved."""
    from tests.test_torch_train import _grpo_batch
    from socioreasoner_tpu_torch.protocol import BatchProto
    pipe = _build("port", str(tmp_path), same_reference=True)
    config = pipe.model_config
    batch_np, img = _grpo_batch(config, seed=3)
    batch = BatchProto.from_dict(tensors={k: batch_np[k] for k in (
        "input_ids", "attention_mask", "position_ids", "response_mask")},
        meta={"image_embeds": torch.as_tensor(img)})
    ref_before = pipe.reference.compute_log_probs(batch)["log_probs"]
    actor_before = pipe.actor_train.compute_log_probs(batch)["log_probs"]
    np.testing.assert_array_equal(ref_before, actor_before)
    pipe.run()
    assert pipe.state.step == 2
    np.testing.assert_array_equal(pipe.reference.compute_log_probs(batch)["log_probs"],
                                  ref_before)
    assert not np.array_equal(pipe.actor_train.compute_log_probs(batch)["log_probs"],
                              actor_before)
    trainer = {t.untyped_storage().data_ptr() for _, t in _leaves(pipe.actor_train.params)}
    assert not any(t.untyped_storage().data_ptr() in trainer
                   for _, t in _leaves(pipe.reference.params))

