"""The port's RLVRPipeline and MathVLMPipeline against the JAX package's.

The tiny f32 configs of tests/test_rlvr_generic.py and
tests/test_math_vlm_pipeline.py (Qwen25VLConfig.tiny(512), a byte
tokenizer), JAX and port weights from one seed through the weight bridge,
and a decode worker that answers each sample with its own crafted text
(right or wrong, with or without the think/answer format, some ending in
EOS), in batch and in server mode. On both sides: RLVRPipeline for two
steps on the plain route (GRPO with the max-len and difficulty masks) and
on the dynamic-sampling route (a query filter that rejects the first
group, the running reward norm over both steps), and MathVLMPipeline for
one step. The texts, the rewards and the train batches equal, the metrics
within float32 rounding (rtol 1e-5, atol 1e-6), the advantages and
log-probs within 1e-5, the trained weights within 1e-5 of each leaf's
scale (Adam's eps at 1e-4 on both sides, as the train steps are held in
tests/test_torch_train.py). Then one port-only run of each pipeline on the
real tiny engine, and chip_smoke's rlvr phase rehearsed on the CPU.
"""

import functools
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from socioreasoner_tpu.configs.rlvr_config import RLVRConfig as JConfig
from socioreasoner_tpu.datasets.processor import (ImageProcessorConfig as JImageConfig,
                                                  SocioProcessor as JProcessor)
from socioreasoner_tpu.distributed import trainer as JT
from socioreasoner_tpu.models.qwen2_5_vl import model as j_qwen
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.pipeline.rlvr import math_vlm_pipeline as j_vlm
from socioreasoner_tpu.pipeline.rlvr import rlvr_pipeline as j_rlvr
from socioreasoner_tpu.pipeline.rlvr.rewards import math_rule as j_math
from socioreasoner_tpu.runtime.generate_scheduler import LocalGenerateGroup as JGroup
from socioreasoner_tpu_torch.configs.rlvr_config import RLVRConfig
from socioreasoner_tpu_torch.datasets import processor as t_processor
from socioreasoner_tpu_torch.distributed import trainer as TT
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.pipeline.rlvr import math_vlm_pipeline as t_vlm
from socioreasoner_tpu_torch.pipeline.rlvr import rlvr_pipeline as t_rlvr
from socioreasoner_tpu_torch.pipeline.rlvr.rewards import math_rule as t_math
from socioreasoner_tpu_torch.runtime.generate_scheduler import LocalGenerateGroup
from tests.test_infer_pipeline_e2e import TinyTokenizer
from tests.test_torch_engine import _port
from tests.test_torch_pipeline import _tokenizer
from tests.test_torch_train import _assert_params_close

VOCAB = 512
N = 2
IMG = dict(min_pixels=56 * 56, max_pixels=56 * 56 * 4)
TEXT_ENGINE = {"max_slots": 4, "max_len": 96, "decode_chunk": 4, "prefill_buckets": (64,)}
VLM_ENGINE = {"max_slots": 4, "max_len": 340, "decode_chunk": 4, "prefill_buckets": (320,),
              "image_buckets": (0, 16)}
QUESTION_RE = re.compile(r"(\d+)\+(\d+)=\?")


def crafted_answer(prompt: str, j: int):
    """(text, ends in EOS) of sample j for a prompt asking "a+b=?" (the
    VLM prompts ask for 3): right for even j, wrong for odd; in the
    think/answer format for j % 3 != 2; EOS for j % 2 == 0."""
    m = QUESTION_RE.search(prompt)
    gt = int(m.group(1)) + int(m.group(2)) if m else 3
    ans = gt if j % 2 == 0 else gt + 1 + j
    text = (f"<think>s{j}</think><answer>{ans}</answer>" if j % 3 != 2
            else f"it is {ans}")
    return text, j % 2 == 0


class ScriptedWorker:
    """A decode worker that answers sample j of each prompt with
    crafted_answer(prompt, j) at once: in batch mode (generate) and in
    server mode (add_request, the scheduler's (group, sample, worker)
    ids), whichever package's request enum it is handed."""

    def __init__(self, tokenizer, eos_id: int, pad_id: int):
        self.tok, self.eos, self.pad = tokenizer, eos_id, pad_id
        self.requests = []

    def _ids(self, prompt_ids, j):
        text, eos = crafted_answer(self.tok.decode(list(map(int, prompt_ids))), j)
        return list(self.tok.encode(text)) + ([self.eos] if eos else [])

    def start_server(self, data=None):
        pass

    def stop_server(self):
        pass

    def add_request(self, command, data):
        if command.name != "ADD":
            return {"alive": True}
        rid = data["request_id"]
        self.requests.append(rid)
        data["callback"](SimpleNamespace(request_id=rid, finish_reason="stop",
                                         output_ids=self._ids(data["prompt_ids"], rid[1])))

    def generate(self, batch, generating_args):
        ids = np.asarray(batch.batch["input_ids"])
        attn = np.asarray(batch.batch["attention_mask"])
        n = generating_args.num_return_sequences
        rows = [self._ids(ids[i][attn[i] == 1], j) for i in range(len(ids)) for j in range(n)]
        out = np.full((len(rows), ids.shape[1] + max(map(len, rows))), self.pad, np.int64)
        for k, r in enumerate(rows):
            out[k, :ids.shape[1]] = ids[k // n]
            out[k, ids.shape[1]:ids.shape[1] + len(r)] = r
        return out


class ImagePadWorker(ScriptedWorker):
    """ScriptedWorker whose sample 0 of each prompt holds a sampled
    <|image_pad|> after its second token."""

    def _ids(self, prompt_ids, j):
        ids = super()._ids(prompt_ids, j)
        if j == 0:
            ids[2:2] = [self.tok.special["<|image_pad|>"]]
        return ids


@functools.lru_cache(maxsize=2)
def _weights(with_vision: bool):
    config = Qwen25VLConfig.tiny(VOCAB)
    return config, jax.tree.map(np.asarray, j_qwen.init_params(
        config, jax.random.key(0), jnp.float32, with_vision=with_vision))


def _rows(n=6):
    return [{"prompt": f"{i}+{i + 2}=?", "ground_truth": str(2 * i + 2), "tag": "math"}
            for i in range(n)]


def _vlm_rows(n=2):
    rng = np.random.default_rng(0)
    return [{"question": "How many buildings? Count.",
             "images": [Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))],
             "ground_truth": "3"} for _ in range(n)]


def _config(side, out_dir, *, prompt_length, max_steps, **kw):
    cls = JConfig if side == "jax" else RLVRConfig
    cfg = cls(output_dir=out_dir, rollout_batch_size=2, prompt_length=prompt_length,
              response_length=48, max_steps=max_steps, num_return_sequences_in_group=N,
              save_steps=-1, track_with="stdout", use_kl_loss=True, kl_loss_coef=1e-3,
              entropy_loss_coef=0.01, reward_clip=10.0, **kw)
    ga = cfg.actor_infer.generating_args
    ga.max_new_tokens, ga.num_return_sequences = 6, N
    ta = cfg.actor_train.training_args
    ta.learning_rate, ta.weight_decay = 1e-4, 1e-2
    return cfg


def _adam_eps(side, pipe, eps=1e-4):
    """Adam's eps at 1e-4 on both sides (see tests/test_torch_train.py)."""
    ta, actor = pipe.pipeline_config.actor_train.training_args, pipe.actor_train
    mod = JT if side == "jax" else TT
    actor.optimizer = mod.make_optimizer(lr=ta.learning_rate, weight_decay=ta.weight_decay,
                                         eps=eps)
    actor.state = mod.TrainState.create(actor.state.params, actor.optimizer)
    step = mod.make_train_step(actor.model_config, actor.loss_cfg, actor.optimizer)
    actor._train_step = jax.jit(step) if side == "jax" else step


def _recording(compute, seen):
    def reward(texts, gts):
        out = compute(list(texts), list(gts))
        seen.append((list(texts), list(gts), out))
        return out
    return reward


def _build(side, out_dir, kind, *, scripted=True, decode_worker=ScriptedWorker, **cfg_kw):
    """One package's pipeline on the shared weights: kind "plain" / "dynamic"
    (RLVRPipeline) or "vlm" (MathVLMPipeline); decode through `decode_worker`
    unless `scripted` is off. Returns (pipe, seen): seen records each reward
    call and each train batch."""
    config, weights = _weights(kind == "vlm")
    seen = {"rewards": [], "train": []}
    jax_side = side == "jax"
    if kind == "vlm":
        img = (JImageConfig if jax_side else t_processor.ImageProcessorConfig)(**IMG)
        cfg = _config(side, out_dir, prompt_length=320, max_steps=1, **cfg_kw)
        engine = dict(VLM_ENGINE)
    else:
        img = None
        dyn = kind == "dynamic"
        cfg = _config(side, out_dir, prompt_length=64, max_steps=2,
                      is_use_additional_prompts=dyn, max_running_requests=8,
                      max_additional_running_prompts=2,
                      **({"adv_estimator": "reinforce", "reward_norm": "running"} if dyn else
                         {"max_len_mask": True, "difficulty_mask": True,
                          "difficulty_low_threshold": 0.1, "difficulty_high_threshold": 0.9}),
                      **cfg_kw)
        engine = dict(TEXT_ENGINE)
    if jax_side:
        processor = JProcessor(TinyTokenizer(), img, image_token_id=config.image_token_id)
        tree = jax.tree.map(jnp.asarray, weights)
        policy, reference = tree, tree
        engine.update(cache_dtype=jnp.float32, sampler_exact=True)
        cfg_model, math, mod = config, j_math, (j_vlm if kind == "vlm" else j_rlvr)
    else:
        processor = t_processor.SocioProcessor(_tokenizer(t_processor.SimpleTokenizer), img,
                                               image_token_id=config.image_token_id)
        policy, reference = params_from_numpy(weights, "cpu"), params_from_numpy(weights, "cpu")
        engine.update(cache_dtype=torch.float32)
        cfg_model, math, mod = _port(config), t_math, (t_vlm if kind == "vlm" else t_rlvr)
    reward = None if not scripted else _recording(math.compute_math_rewards, seen["rewards"])
    common = dict(model_config=cfg_model, policy_params=policy, reference_params=reference,
                  processor=processor, engine_kwargs=engine)
    if kind == "vlm":
        pipe = mod.MathVLMPipeline(cfg, dataset=_vlm_rows(), reward_fn=reward, **common)
    else:
        rejected = []

        def query_filter(row, outs):
            """Reject the first group (a replacement is pulled)."""
            rejected.append(row["prompt"])
            return len(rejected) > 1
        pipe = mod.RLVRPipeline(cfg, dataset=_rows(), query_filter=query_filter,
                                reward_fns=None if reward is None else {"math": reward},
                                **common)
        seen["rejected"] = rejected
    _adam_eps(side, pipe)
    if scripted:
        worker = decode_worker(pipe.processor.tokenizer, config.eos_token_id,
                               config.pad_token_id)
        pipe.actor_infer.generate = worker.generate
        if getattr(pipe, "sampler", None) is not None:
            pipe.sampler.cluster = (JGroup if jax_side else LocalGenerateGroup)([worker])
        seen["worker"] = worker
    train_step = pipe.actor_train.train_step

    def recording_train_step(batch, *a):
        seen["train"].append({k: np.asarray(v) for k, v in batch.batch.items()})
        return train_step(batch, *a)
    pipe.actor_train.train_step = recording_train_step
    return pipe, seen


def _run_pair(tmp_path, kind):
    out = {}
    for side in ("jax", "port"):
        pipe, seen = _build(side, str(tmp_path / side), kind)
        metrics = pipe.run()
        out[side] = (pipe, seen, metrics)
    return out


@pytest.fixture(scope="module", params=["plain", "dynamic", "vlm"])
def scripted(request, tmp_path_factory):
    return request.param, _run_pair(tmp_path_factory.mktemp(request.param), request.param)


def test_scripted_texts_rewards_and_batches_match_jax(scripted):
    """Each step: the reward functions saw the same texts and ground truths
    and returned the same arrays; the train batches hold the same tokens,
    masks and scores, the advantages and log-probs within 1e-5. The rewards
    differ within a group, and the dynamic route rejected its first group
    and pulled a replacement."""
    kind, out = scripted
    (jpipe, jseen, _), (tpipe, tseen, _) = out["jax"], out["port"]
    steps = 1 if kind == "vlm" else 2
    assert len(tseen["train"]) == len(jseen["train"]) == steps
    assert len(tseen["rewards"]) == len(jseen["rewards"]) > 0
    for (t_texts, t_gts, got), (j_texts, j_gts, want) in zip(tseen["rewards"],
                                                             jseen["rewards"]):
        assert (t_texts, t_gts) == (j_texts, j_gts)
        for k in ("scores", "response_level_rewards"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["metrics"] == want["metrics"]
        assert len(set(got["response_level_rewards"].tolist())) > 1
    for got, want in zip(tseen["train"], jseen["train"]):
        assert sorted(got) == sorted(want)
        for k in want:
            if k in ("advantages", "old_log_probs", "ref_log_probs", "response_mask"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.abs(got["advantages"]).max() > 0
    if kind == "dynamic":
        assert tseen["rejected"] == jseen["rejected"] and len(tseen["rejected"]) >= 3
        assert tseen["worker"].requests == jseen["worker"].requests


def test_scripted_metrics_and_params_match_jax(scripted):
    """The same metric keys; each step's loss, KL, reward and scheduler
    figures within float32 rounding; the trained weights within 1e-5 of
    each leaf's scale."""
    kind, out = scripted
    (jpipe, _, jm), (tpipe, _, tm) = out["jax"], out["port"]
    assert tpipe.state.step == jpipe.state.step == (1 if kind == "vlm" else 2)
    assert set(tm) == set(jm)
    for step in range(tpipe.state.step):
        got, want = tpipe.state.log_history[step], jpipe.state.log_history[step]
        assert set(got) == set(want)
        for k in want:
            if k.startswith(("actor_train/", "critic/", "scheduler/", "math/")):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert tm["actor_train/grad_norm"] > 0
    if kind == "dynamic":       # the first step rejected its first group
        first = tpipe.state.log_history[0]
        assert first["scheduler/query_filter_count"] == 1
        assert first["scheduler/prompt_use_count"] >= 3
    _assert_params_close(tpipe.actor_train.params,
                         jax.tree.map(np.asarray, jpipe.actor_train.params))


def test_sampled_image_pad_in_math_vlm_responses_runs_as_in_jax(tmp_path):
    """A sampled <|image_pad|> in sample 0's response of each prompt through
    MathVLMPipeline's step: neither package raises, and the train batch,
    log-probs, advantages, metrics and trained weights agree as without it.
    Neither repairs the batch: those rows hold one image token more than
    their image has rows, and the log-prob and train steps'
    scatter_image_embeds gives each extra token the next image row in batch
    order (the later rows' image tokens shift by one, the last ones clamped
    onto the last row); a reference behaviour the port keeps."""
    out = {}
    for side in ("jax", "port"):
        pipe, seen = _build(side, str(tmp_path / side), "vlm", decode_worker=ImagePadWorker)
        out[side] = (pipe, seen, pipe.run())
    (jpipe, jseen, jm), (tpipe, tseen, tm) = out["jax"], out["port"]
    got, want = tseen["train"][0], jseen["train"][0]
    assert sorted(got) == sorted(want)
    for k in want:
        if k in ("advantages", "old_log_probs", "ref_log_probs", "response_mask"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pad = tpipe.processor.tokenizer.special["<|image_pad|>"]
    image, resp = got["input_ids"] == pad, got["response_mask"] == 1
    assert (image & resp).sum(1).tolist() == [1, 0] * N
    assert len(set((image & ~resp).sum(1).tolist())) == 1
    assert set(tm) == set(jm)
    for k in jm:
        if k.startswith(("actor_train/", "critic/")):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_params_close(tpipe.actor_train.params,
                         jax.tree.map(np.asarray, jpipe.actor_train.params))


# ------------------------------------------------------------- port only

def test_rlvr_pipeline_on_the_tiny_engine(tmp_path):
    """The dynamic route with the built-in math rule through the port's own
    tiny engine: two steps, a rejected group replaced, finite metrics, the
    weights moved, the reference's not, and the engine idle after each
    rollout (the final ABORTs drained)."""
    pipe, _ = _build("port", str(tmp_path), "dynamic", scripted=False)
    ref_before = {k: v.clone() for k, v in pipe.reference.params.items()
                  if isinstance(v, torch.Tensor)}
    embed_before = pipe.actor_train.params["embed"].clone()
    rollout = pipe._rollout

    def checked_rollout(*a):
        got = rollout(*a)
        assert not pipe.actor_infer.engine.has_work()
        return got
    pipe._rollout = checked_rollout
    metrics = pipe.run()
    assert pipe.state.step == 2
    assert np.isfinite(metrics["actor_train/total_loss"])
    first = pipe.state.log_history[0]
    assert first["scheduler/query_filter_count"] == 1
    assert first["scheduler/prompt_use_count"] >= 3
    assert "critic/score_mean" in metrics and "scheduler/math/score/mean" in metrics
    assert not torch.equal(pipe.actor_train.params["embed"], embed_before)
    for k, v in ref_before.items():
        assert torch.equal(pipe.reference.params[k], v), k


def test_math_vlm_pipeline_on_the_tiny_engine(tmp_path):
    """One MathVLM step through the port's own tiny engine with the default
    math reward: finite loss, the math metrics, the weights moved."""
    pipe, _ = _build("port", str(tmp_path), "vlm", scripted=False)
    before = pipe.actor_train.params["embed"].clone()
    metrics = pipe.run()
    assert pipe.state.step == 1 and np.isfinite(metrics["actor_train/total_loss"])
    assert "critic/math/accuracy" in metrics
    assert not torch.equal(pipe.actor_train.params["embed"], before)


def test_rlvr_reward_workers_raise(tmp_path):
    """The config's `rewards:` block resolves to clusters of the port's
    workers (the JAX package's dotted path, 2 workers), whose reward
    function scores as compute_math_rewards does; a worker_cls of a module
    that does not exist raises ImportError, as in the JAX package."""
    from socioreasoner_tpu_torch.configs.worker_config import WorkerConfig
    from socioreasoner_tpu_torch.pipeline.base_worker import MathRuleRewardWorker
    config, weights = _weights(False)

    def build(worker_cls):
        cfg = _config("port", str(tmp_path), prompt_length=64, max_steps=1, rewards={
            "math": WorkerConfig(worker_cls=worker_cls, world_size=2)})
        return t_rlvr.RLVRPipeline(cfg, model_config=_port(config),
                                   policy_params=params_from_numpy(weights, "cpu"),
                                   reference_params=params_from_numpy(weights, "cpu"),
                                   processor=None, dataset=_rows())
    pipe = build("socioreasoner_tpu.pipeline.base_worker.MathRuleRewardWorker")
    cluster = pipe.reward_clusters["math"]
    assert cluster.world_size == 2
    assert all(type(w) is MathRuleRewardWorker for w in cluster.workers)
    texts = ["<think>a</think><answer>4</answer>", "<answer>5</answer>", "4", "no"]
    gts = ["4", "4", "4", "1"]
    got, want = pipe.reward_fns["math"](texts, gts), t_math.compute_math_rewards(texts, gts)
    for k in ("scores", "response_level_rewards"):
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ImportError):
        build("some.RewardWorker")


def test_chip_smoke_rlvr_phase_on_cpu(tmp_path):
    """chip_smoke's rlvr phase at the tiny config: run_rlvr_path (pass 1 on
    the real engine, pass 2 through crafted answers whose rewards must equal
    their recomputation) and run_math_vlm_path, at responses long enough for
    the crafted answers and 2 prompts x 4 samples."""
    import chip_smoke
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_qwen
    config = _port(Qwen25VLConfig.tiny(VOCAB))
    params = t_qwen.init_params(config, torch.Generator().manual_seed(0), device="cpu")
    img = t_processor.ImageProcessorConfig(**IMG, defer_patchify=True)
    processor = t_processor.SocioProcessor(_tokenizer(t_processor.SimpleTokenizer), img,
                                           image_token_id=config.image_token_id)
    cpu = torch.device("cpu")
    rlvr = chip_smoke.run_rlvr_path(config, params, str(tmp_path), cpu, processor=processor,
                                    response_length=48, rollout_batch_size=2,
                                    num_return_sequences_in_group=4, max_running_requests=8)
    p1, p2 = rlvr["pass1"], rlvr["pass2"]
    assert p1["steps"] == chip_smoke.RLVR_CUTS["max_steps"]
    assert p1["scheduler"][0]["scheduler/query_filter_count"] == 1
    assert p1["cache_slots"] == chip_smoke.RLVR_SLOTS
    assert {tuple(b) for b in p1["prefill_buckets"]} <= set(chip_smoke.RLVR_PREFILL)
    assert p1["train_shapes"] == [(8, 304)] and p1["logprob_shapes"] == [(8, 304)]
    assert p2["recomputed_equal"] and p2["metrics"]["critic/score_mean"] == 0.5
    vlm = chip_smoke.run_math_vlm_path(config, params, str(tmp_path / "vlm"), cpu,
                                       tile_px=96, img_cfg=img, processor=processor,
                                       prompt_length=320, response_length=8)
    assert vlm["steps"] == 1 and vlm["train_shapes"] == [(8, 328)]
    assert vlm["prefill_buckets"] and {b[1] for b in vlm["prefill_buckets"]} == {320}
