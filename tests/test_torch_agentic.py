"""The port's agentic slice against the JAX package's.

Both environments step for step (observations, rewards, info and frames
bit-equal), the text rollout loop under a scripted policy, EnvManager's
multi-turn episodes through a stub scheduler and a stub ViT (token ids,
masks, grids, M-RoPE ids, image rows, score and penalty equal, the
prompt-length stop included), RequestScheduler's sticky routing, abort and
timeout, the score normalisations and grouped rewards (1e-6), both
pipelines' `_episodes_to_batch` exactly, their advantage chains on the same
batch and log-probs (1e-6), a train step on each pipeline's batch against
JAX's `make_train_step` (metrics rtol 1e-5 / atol 1e-6, params 1e-5 of a
leaf's scale with Adam's eps 1e-4 on both sides, as tests/test_torch_train.py
holds them), and one greedy step of each pipeline through both packages'
tiny engines at the JAX tests' sizes (the same episodes, metrics at rtol
1e-5 / atol 1e-6, params as above). Port only: the embedder in a fresh
thread with parameters that require grad, the engine's prefix fork never
taken by a growing prompt, and chip_smoke's agentic phase rehearsed on the
CPU. Tiny f32 configs (Qwen25VLConfig.tiny(512), byte tokenizers of the same
ids).
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.configs import agentic_config as j_acfg
from socioreasoner_tpu.configs.rlvr_config import RLVRConfig as JRLVRConfig
from socioreasoner_tpu.configs.worker_config import WorkerConfig as JWorkerConfig
from socioreasoner_tpu.datasets.processor import (ImageProcessorConfig as JImageConfig,
                                                  SocioProcessor as JProcessor)
from socioreasoner_tpu.distributed import trainer as JT
from socioreasoner_tpu.generation.sampling import SamplingParams as JSampling
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.pipeline import losses as JL
from socioreasoner_tpu.pipeline.agentic import agentic_pipeline as j_text
from socioreasoner_tpu.pipeline.agentic import agentic_vlm_pipeline as j_vlm
from socioreasoner_tpu.pipeline.agentic import environment_worker as j_env
from socioreasoner_tpu.protocol import BatchProto as JBatch
from socioreasoner_tpu.runtime import generate_scheduler as j_sched
from socioreasoner_tpu.utils import functionals as JF
from socioreasoner_tpu.utils.kl_controller import get_kl_controller as j_kl
from socioreasoner_tpu.utils.metrics import MetricsManager as JMetrics
from socioreasoner_tpu_torch.configs import agentic_config as t_acfg
from socioreasoner_tpu_torch.configs.loader import load_config
from socioreasoner_tpu_torch.configs.rlvr_config import RLVRConfig
from socioreasoner_tpu_torch.configs.worker_config import WorkerConfig
from socioreasoner_tpu_torch.datasets import processor as t_processor
from socioreasoner_tpu_torch.distributed import trainer as TT
from socioreasoner_tpu_torch.generation.sampling import SamplingParams
from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.pipeline import losses as TL
from socioreasoner_tpu_torch.pipeline.agentic import agentic_pipeline as t_text
from socioreasoner_tpu_torch.pipeline.agentic import agentic_vlm_pipeline as t_vlm
from socioreasoner_tpu_torch.pipeline.agentic import environment_worker as t_env
from socioreasoner_tpu_torch.protocol import BatchProto
from socioreasoner_tpu_torch.runtime import generate_scheduler as t_sched
from socioreasoner_tpu_torch.utils.kl_controller import get_kl_controller
from socioreasoner_tpu_torch.utils.metrics import MetricsManager
from tests.test_infer_pipeline_e2e import TinyTokenizer
from tests.test_torch_engine import _port
from tests.test_torch_pipeline import _tokenizer
from tests.test_torch_rlvr_pipeline import _adam_eps
from tests.test_torch_train import _assert_params_close

CONFIG = Qwen25VLConfig.tiny(512)
HIDDEN = CONFIG.text.hidden_size
ACTIONS = {"guess_number": ["5", "x", "3", "-1", "7", "12", "0", "9", "4", "8"],
           "grid_goal": ["up", "Left", "nothing", "right", "down", "DOWN now", "up", "left"]}
MOVES = ["up", "left", "stay", "right", "down"]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b, err=""):
    """Exact equality of two nests (numpy and jax arrays, tensors, lists)."""
    if isinstance(a, dict):
        assert set(a) == set(b), err
        for k in a:
            _same(a[k], b[k], f"{err}/{k}")
    elif isinstance(a, (list, tuple)) and not (a and isinstance(a[0], (int, float, str))):
        assert len(a) == len(b), err
        for x, y in zip(a, b):
            _same(x, y, err)
    elif isinstance(a, (np.ndarray, torch.Tensor)) or hasattr(a, "__array__"):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=err)
        assert _np(a).dtype == _np(b).dtype, err
    else:
        assert a == b, (err, a, b)


def _processor(side, image=False):
    img = (JImageConfig if side == "jax" else t_processor.ImageProcessorConfig)(
        min_pixels=28 * 28, max_pixels=112 * 112 * 4, defer_patchify=True) if image else None
    if side == "jax":
        proc = JProcessor(TinyTokenizer(), img, image_token_id=CONFIG.image_token_id)
        proc.model_config = CONFIG
    else:
        proc = t_processor.SocioProcessor(_tokenizer(t_processor.SimpleTokenizer), img,
                                          image_token_id=CONFIG.image_token_id)
        proc.model_config = _port(CONFIG)
    return proc


# ------------------------------------------------------------- environments

@pytest.mark.parametrize("name,kwargs", [
    ("guess_number", {"low": 0, "high": 9, "max_turns": 6}),
    ("guess_number", {"low": -5, "high": 300, "max_turns": 10}),
    ("grid_goal", {"max_turns": 6}),
    ("grid_goal", {"size": 3, "cell_px": 14, "max_turns": 4})])
def test_envs_match_jax(name, kwargs):
    """Observations, rewards, done flags, info and frames bit-equal for five
    seeds under scripted actions; grid_goal never puts "format" in info
    (its -0.1 is folded into the reward)."""
    for seed in range(5):
        je, te = j_env.make_env(name, **kwargs), t_env.make_env(name, **kwargs)
        _same(je.reset(seed=seed), te.reset(seed=seed))
        for action in ACTIONS[name]:
            jo, jr, jd, ji = je.step(action)
            to, tr, td, ti = te.step(action)
            _same(jo, to)
            assert (jr, jd, ji) == (tr, td, ti) and type(tr) is type(jr)
            assert "format" not in ti
            if jd:
                break
    with pytest.raises(KeyError, match="unknown env 'nope'"):
        t_env.make_env("nope")
    assert sorted(t_env.ENV_REGISTRY) == sorted(j_env.ENV_REGISTRY)


def test_rollout_loop_matches_jax():
    """EnvironmentWorker.run_rollout_loop under one scripted policy: the
    same prompts, actions, rewards, done flags and info."""
    out = []
    for mod, wc in ((j_env, JWorkerConfig), (t_env, WorkerConfig)):
        count = {"n": 0}

        def policy(prompt):
            count["n"] += 1
            return ACTIONS["guess_number"][(count["n"] + len(prompt)) % 10]
        w = mod.EnvironmentWorker(worker_config=wc())
        w.initialize(env_name="guess_number", env_kwargs={"low": 0, "high": 9},
                     generate_fn=policy, max_turns=5)
        out.append([dict(vars(t)) for t in w.run_rollout_loop(4, seed=3)])
    assert out[0] == out[1] and len(out[1]) == 4
    assert any(t["done"] for t in out[1]) and any(len(t["actions"]) == 5 for t in out[1])


# ------------------------------------------------------------- EnvManager

class StubScheduler:
    """A RequestScheduler stand-in: answers env e's turn t with MOVES[(e + t)
    % 5] and EOS at once, and records each request's ids, M-RoPE ids and
    image rows."""

    def __init__(self, tokenizer):
        self.tok = tokenizer
        self.seen = []
        self.turn = {}

    def generate_one_request(self, req):
        env = req.meta["src_rank"]
        t = self.turn[env] = self.turn.get(env, -1) + 1
        emb = req.meta["image_embeds"]
        self.seen.append((req.meta["request_id"], env, _np(req.batch["input_ids"]),
                          _np(req.batch["position_ids"]), None if emb is None else _np(emb)))
        ids = list(self.tok.encode(MOVES[(env + t) % 5])) + [CONFIG.eos_token_id]
        return SimpleNamespace(meta={"output_token_ids": [ids]})


class VisionIdScheduler(StubScheduler):
    """StubScheduler whose answer to every turn t of env e with e + t even
    holds sampled vision ids in the middle of the move: <|image_pad|>,
    <|vision_start|>, <|video_pad|> and <|vision_end|>."""

    def generate_one_request(self, req):
        out = super().generate_one_request(req)
        env = req.meta["src_rank"]
        if (env + self.turn[env]) % 2 == 0:
            ids = out.meta["output_token_ids"][0]
            mid = len(ids) // 2
            ids[mid:mid] = vision_ids(self.tok)
        return out


def vision_ids(tokenizer):
    return [CONFIG.image_token_id, CONFIG.vision_start_token_id, CONFIG.video_token_id,
            tokenizer.special["<|vision_end|>"]]


def _stub_embed(side, calls):
    """16 rows of HIDDEN values a 112² image, from its pixels."""
    def embed(images, grids):
        calls.append(len(images))
        rows = np.concatenate([np.resize(np.asarray(u8)[::7, ::7].astype(np.float32) / 255,
                                         (16, HIDDEN)) for u8 in images])
        return jnp.asarray(rows) if side == "jax" else torch.as_tensor(rows)
    return embed


def _episodes(side, n=4, prompt_length=768, max_turns=3, seed=11, scheduler=StubScheduler):
    """n grid_goal episodes (two a group, one seed a group) through
    EnvManager, `scheduler` (a StubScheduler) and the stub ViT. Returns
    (episodes, the scheduler, the embed calls)."""
    mod = j_env if side == "jax" else t_env
    proc = _processor(side, image=True)
    sched, calls = scheduler(proc.tokenizer), []
    eps = [mod.EnvManager(env=mod.make_env("grid_goal"), processor=proc, scheduler=sched,
                          embed_fn=_stub_embed(side, calls), max_turns=max_turns,
                          prompt_length=prompt_length, group_id=e // 2, env_id=e,
                          tag="grid_goal", format_penalty=-0.5).run_episode(seed=seed + e // 2)
           for e in range(n)]
    return eps, sched, calls


@pytest.mark.parametrize("prompt_length", [768, 200], ids=["full", "prompt_length_stop"])
def test_env_manager_episodes_match_jax(prompt_length):
    """Every request (ids, M-RoPE ids, image rows) and every episode field
    equal; each image embedded once; the response mask covers exactly the
    sampled ids; the prompt-length stop drops the unsent frame and its grid;
    the format penalty never applies (grid_goal's info has no "format")."""
    (jeps, jsched, jcalls), (teps, tsched, tcalls) = (
        _episodes(side, prompt_length=prompt_length) for side in ("jax", "port"))
    assert len(tsched.seen) == len(jsched.seen) > 0 and jcalls == tcalls == [1] * len(tcalls)
    for (jr, je, jids, jpos, jemb), (tr, te, tids, tpos, temb) in zip(jsched.seen, tsched.seen):
        assert (jr, je) == (tr, te)
        _same(jids, tids)
        _same(jpos, tpos)
        assert (jemb is None) == (temb is None)
        if temb is not None:
            _same(jemb, temb)
            assert temb.shape[0] == 16 * int((tids == CONFIG.image_token_id).sum()) // 16
    for je, te in zip(jeps, teps):
        for f in ("input_ids", "response_mask", "image_grid_thw", "frames", "score", "penalty",
                  "group_id", "env_id", "tag", "llm_raw_texts", "turns", "solved"):
            _same(getattr(je, f), getattr(te, f), f)
        _same(np.asarray(je.image_embeds), _np(te.image_embeds))
        assert te.penalty == 0.0 and len(te.frames) == len(te.image_grid_thw)
        sent = sum(len(MOVES[(te.env_id + t) % 5]) + 1 for t in range(te.turns))
        assert int(te.response_mask.sum()) == sent
    if prompt_length == 200:
        assert all(e.turns == 1 and len(e.image_grid_thw) == 1 for e in teps)
    else:
        assert max(e.turns for e in teps) == 3


def test_env_manager_drops_sampled_vision_ids():
    """Actions holding sampled vision ids: the port's episodes run every
    turn, their ids hold no vision id outside the image blocks, and each
    equals the episode answered without them (ids, response mask covering
    exactly the ids kept, texts, score, turns, every request), with the
    dropped ids counted; the JAX EnvManager raises IndexError on the turn
    after such an action (its M-RoPE ids count one image too many)."""
    teps, tsched, _ = _episodes("port", scheduler=VisionIdScheduler)
    plain, psched, _ = _episodes("port")
    jeps = _episodes("jax")[0]
    vision = set(vision_ids(tsched.tok))
    assert t_env.vision_token_ids(_processor("port", image=True)) == vision
    assert max(e.turns for e in teps) == 3
    for te, pe, je in zip(teps, plain, jeps):
        for f in ("input_ids", "response_mask", "image_grid_thw", "frames", "score",
                  "penalty", "llm_raw_texts", "turns", "solved"):
            _same(getattr(pe, f), getattr(te, f), f)
            _same(getattr(je, f), getattr(te, f), f)
        acted = te.input_ids[te.response_mask == 1]
        assert not set(acted.tolist()) & vision
        sent = sum(len(MOVES[(te.env_id + t) % 5]) + 1 for t in range(te.turns))
        assert int(te.response_mask.sum()) == sent
        hit = sum((te.env_id + t) % 2 == 0 for t in range(te.turns))
        assert te.vision_ids_dropped == len(vision) * hit and pe.vision_ids_dropped == 0
        n_image = int((te.input_ids == CONFIG.image_token_id).sum())
        assert n_image == 16 * len(te.image_grid_thw)
    assert sum(e.vision_ids_dropped for e in teps) > 0
    assert len(tsched.seen) == len(psched.seen)
    for got, want in zip(tsched.seen, psched.seen):
        _same(want[2], got[2])
        _same(want[3], got[3])
    with pytest.raises(IndexError):
        _episodes("jax", scheduler=VisionIdScheduler)


def test_vision_token_ids_of_a_hf_tokenizer():
    """Qwen's own ids from its model config and an HF tokenizer's added
    vocabulary (<|vision_pad|> included); none from the config's defaults
    a tokenizer does not define."""
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig as TConfig
    added = {"<|im_start|>": 151644, "<|vision_start|>": 151652, "<|vision_end|>": 151653,
             "<|vision_pad|>": 151654, "<|image_pad|>": 151655, "<|video_pad|>": 151656}
    hf = SimpleNamespace(tokenizer=SimpleNamespace(get_added_vocab=lambda: dict(added)),
                         model_config=TConfig())
    assert t_env.vision_token_ids(hf) == frozenset(range(151652, 151657))
    byte = SimpleNamespace(tokenizer=t_processor.SimpleTokenizer(), model_config=TConfig())
    assert t_env.vision_token_ids(byte) == frozenset({151652, 151653, 151655, 151656})


def test_vision_token_ids_refuse_a_processor_without_config():
    """Without its model config a processor cannot name its image id, so
    neither the ids to drop nor an EnvManager is made from it."""
    proc = _processor("port", image=True)
    del proc.model_config
    with pytest.raises(ValueError, match="model_config"):
        t_env.vision_token_ids(proc)
    with pytest.raises(ValueError, match="model_config"):
        t_env.EnvManager(env=t_env.make_env("grid_goal"), processor=proc,
                         scheduler=None)


def test_batch_of_repaired_episodes_takes_one_row_an_image_token():
    """The VLM pipeline's batch of episodes whose actions held vision ids:
    its M-RoPE ids equal those of the episodes answered without them, and
    scatter_image_embeds gives each image token its own row, in order."""
    from socioreasoner_tpu_torch.models.qwen2_5_vl.model import scatter_image_embeds
    fake = SimpleNamespace(pipeline_config=t_acfg.AgenticConfig(prompt_length=768,
                                                                response_length=16),
                           model_config=_port(CONFIG))
    got = t_vlm.AgenticVLMPipeline._episodes_to_batch(
        fake, _episodes("port", scheduler=VisionIdScheduler)[0])
    want = t_vlm.AgenticVLMPipeline._episodes_to_batch(fake, _episodes("port")[0])
    _same(dict(want.batch), dict(got.batch))
    ids = torch.as_tensor(got.batch["input_ids"])
    rows = got.meta["image_embeds"]
    is_image = ids == CONFIG.image_token_id
    assert int(is_image.sum()) == rows.shape[0] == got.meta["image_embeds_rows"].sum()
    tokens = torch.randn(*ids.shape, HIDDEN, generator=torch.Generator().manual_seed(0))
    out = scatter_image_embeds(ids, tokens, rows, CONFIG.image_token_id)
    assert torch.equal(out[is_image], rows) and torch.equal(out[~is_image], tokens[~is_image])


# ------------------------------------------------------------- RequestScheduler

class FakeWorker:
    def __init__(self):
        self.added, self.aborted = [], []

    def add_request(self, command, data):
        if command.name == "ABORT":
            self.aborted.append(data["request_id"])
        else:
            self.added.append(data)


def _scheduler_run(side):
    """Four requests from two sources over two workers, on threads: two
    completed through the callback, two aborted. Returns (results by id,
    the workers)."""
    mod, batch_cls, sp = ((j_sched, JBatch, JSampling) if side == "jax"
                          else (t_sched, BatchProto, SamplingParams))
    cluster = SimpleNamespace(workers=[FakeWorker(), FakeWorker()])
    sched = mod.RequestScheduler(cluster)
    results = {}

    def call(rid, src):
        ids = np.arange(4)[None] + rid
        results[rid] = sched.generate_one_request(batch_cls.from_dict(
            tensors={"input_ids": ids, "attention_mask": np.ones_like(ids)},
            meta={"request_id": rid, "src_rank": src, "sampling": sp(max_new_tokens=2)}))
    threads = [threading.Thread(target=call, args=(i, i % 2)) for i in range(4)]
    for t in threads:
        t.start()
    deadline = time.time() + 5
    while sum(len(w.added) for w in cluster.workers) < 4 and time.time() < deadline:
        time.sleep(0.01)
    for w in cluster.workers:
        first = w.added[0]
        first["callback"](SimpleNamespace(request_id=first["request_id"], output_ids=[5, 6],
                                          finish_reason="stop"))
        sched.abort_request(w.added[1]["request_id"])
    for t in threads:
        t.join(5)
    return results, cluster.workers


def test_request_scheduler_sticky_and_abort_match_jax():
    """Source 0's requests reach one worker, source 1's the other; the two
    completed requests give JAX's single-row batches, the two aborted ones
    None, each abort routed to its owner."""
    (jres, jw), (tres, tw) = _scheduler_run("jax"), _scheduler_run("port")
    for w in tw:
        assert len(w.added) == 2 and len({d["prompt_ids"][0] % 2 for d in w.added}) == 1
        assert len(w.aborted) == 1
    assert sorted(k for k, v in tres.items() if v is None) == \
        sorted(k for k, v in jres.items() if v is None) and len(tres) == 4
    for rid, out in tres.items():
        if out is None:
            continue
        want = jres[rid]
        for k in ("input_ids", "attention_mask", "response_mask"):
            _same(np.asarray(want.batch[k]), out.batch[k], k)
        assert out.batch["response_mask"][0].tolist() == [0, 0, 0, 0, 1, 1]
        assert out.meta["output_token_ids"] == want.meta["output_token_ids"] == [[5, 6]]
        assert out.meta["finish_reason"] == "stop"


def test_request_scheduler_times_out_and_aborts():
    """Past rpc_timeout the request is aborted at its worker and the caller
    gets TimeoutError, as in the JAX package; nothing stays pending."""
    for mod, batch_cls, sp in ((j_sched, JBatch, JSampling),
                               (t_sched, BatchProto, SamplingParams)):
        cluster = SimpleNamespace(workers=[FakeWorker()])
        sched = mod.RequestScheduler(cluster, SimpleNamespace(rpc_timeout=0.05))
        ids = np.arange(3)[None]
        with pytest.raises(TimeoutError, match="timed out after 0.05s"):
            sched.generate_one_request(batch_cls.from_dict(
                tensors={"input_ids": ids}, meta={"request_id": "r", "sampling": sp()}))
        assert cluster.workers[0].aborted == ["r"]
        assert not sched._pending and not sched._rid2dp


# ------------------------------------------------------------- scores

@pytest.mark.parametrize("method", ["mean_std", "mean", "asym_clip", "identity"])
def test_score_normalize_fn_matches_jax(method):
    rng = np.random.default_rng(0)
    for x in (np.array([1.0, 2.0, 3.0, 6.0], np.float32), np.full(3, 2.5, np.float32),
              rng.normal(size=7).astype(np.float32) * 10, np.array([-10, 0, 0.1, 50], np.float32)):
        want = j_vlm.get_score_normalize_fn(SimpleNamespace(method=method))(x)
        got = t_vlm.get_score_normalize_fn(SimpleNamespace(method=method))(x)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for mod in (j_vlm, t_vlm):
        with pytest.raises(ValueError, match="Invalid normalization method"):
            mod.get_score_normalize_fn(SimpleNamespace(method="max"))


@pytest.mark.parametrize("grouping", ["state", "inductive", "tags", "batch"])
@pytest.mark.parametrize("reward_clip", [None, 0.5])
def test_normalized_rewards_match_jax(grouping, reward_clip):
    """_normalized_rewards over 8 episodes in groups and tags, every method,
    with and without reward_clip (and its clip fraction): 1e-6."""
    rng = np.random.default_rng(1)
    meta = {"scores": rng.normal(size=8).astype(np.float32),
            "penalty": -0.1 * rng.integers(0, 2, 8).astype(np.float32),
            "group_ids": np.repeat(np.arange(4), 2), "tags": np.array(list("aabbabab"), object)}
    for method in ("mean_std", "mean", "asym_clip", "identity"):
        out = []
        for acfg, mod, mm in ((j_acfg, j_vlm, JMetrics()), (t_acfg, t_vlm, MetricsManager())):
            cfg = acfg.AgenticConfig(reward_clip=reward_clip, reward_normalization=(
                acfg.RewardNormalizationConfig(grouping=grouping, method=method)))
            fake = SimpleNamespace(pipeline_config=cfg, metrics=mm)
            out.append((mod.AgenticVLMPipeline._normalized_rewards(
                fake, SimpleNamespace(meta=meta)), mm.reduce()))
        (want, wm), (got, gm) = out
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=method)
        assert gm.keys() == wm.keys() == ({"critic/reward_clip_frac"} if reward_clip else set())
        for k in gm:
            assert gm[k] == pytest.approx(wm[k], abs=1e-6)


# ------------------------------------------------------------- batches

def _trajectories(side):
    mod = j_env if side == "jax" else t_env
    return [mod.Trajectory(observations=["Guess.", "Guess.\n5\nTry higher."], actions=["5", "8"],
                           rewards=[-0.05, 1.0], done=True, info={"solved": True}),
            mod.Trajectory(),
            mod.Trajectory(observations=["x" * 90], actions=["a long action " * 3],
                           rewards=[-0.1])]


def _text_batch(side):
    cfg = (JRLVRConfig if side == "jax" else RLVRConfig)(prompt_length=64, response_length=8)
    fake = SimpleNamespace(pipeline_config=cfg, processor=_processor(side),
                           model_config=CONFIG if side == "jax" else _port(CONFIG))
    mod = j_text if side == "jax" else t_text
    returns = np.array([0.95, 0.0, -0.1], np.float32)
    return mod.AgenticPipeline._episodes_to_batch(fake, _trajectories(side), returns)


def _vlm_batch(side):
    acfg = j_acfg if side == "jax" else t_acfg
    fake = SimpleNamespace(pipeline_config=acfg.AgenticConfig(prompt_length=768,
                                                              response_length=16),
                           model_config=CONFIG if side == "jax" else _port(CONFIG))
    mod = j_vlm if side == "jax" else t_vlm
    return mod.AgenticVLMPipeline._episodes_to_batch(fake, _episodes(side)[0])


@pytest.mark.parametrize("kind", ["text", "vlm"])
def test_episodes_to_batch_matches_jax(kind):
    """Tokens, masks, M-RoPE ids, scores, groups, tags, image rows and their
    per-episode counts exactly (the text batch re-encodes the last action's
    text and skips an episode without one)."""
    make = _text_batch if kind == "text" else _vlm_batch
    want, got = make("jax"), make("port")
    _same({k: np.asarray(v) for k, v in want.batch.items()}, dict(got.batch))
    assert set(got.meta) == set(want.meta)
    for k in got.meta:
        if k == "image_embeds":
            assert isinstance(got.meta[k], torch.Tensor)
            _same(np.asarray(want.meta[k]), got.meta[k])
        else:
            _same(np.asarray(want.meta[k]), np.asarray(got.meta[k]), k)
    if kind == "text":
        assert len(got) == 2 and got.batch["response_mask"].sum() == 1 + 8
    else:
        assert got.meta["image_embeds"].shape[0] == got.meta["image_embeds_rows"].sum() == \
            int((got.batch["input_ids"] == CONFIG.image_token_id).sum())


def _log_probs(batch, seed):
    rng = np.random.default_rng(seed)
    resp = np.asarray(batch.batch["response_mask"])[:, 1:]
    return [(rng.normal(size=resp.shape).astype(np.float32) - 2) * resp for _ in range(2)]


@pytest.mark.parametrize("kind", ["text", "vlm"])
def test_advantage_chain_matches_jax(kind):
    """Each pipeline's chain from rewards to advantages on the same batch and
    log-probs: the text pipeline's batch-normalised returns, KL penalty at
    the (never updated) controller's value and REINFORCE; the VLM
    pipeline's grouped rewards, KL penalty, controller update and its
    advantage estimator (GRPO, whitened, clipped): 1e-6."""
    jb, tb = (_text_batch if kind == "text" else _vlm_batch)("jax"), \
        (_text_batch if kind == "text" else _vlm_batch)("port")
    old, ref = _log_probs(tb, 5)
    resp1 = jnp.asarray(np.asarray(jb.batch["response_mask"])[:, 1:])
    attn, pos = jnp.asarray(jb.batch["attention_mask"]), jnp.asarray(jb.batch["position_ids"])
    if kind == "text":
        cfg = (JRLVRConfig(init_kl_coef=0.2, gamma=0.9), RLVRConfig(init_kl_coef=0.2, gamma=0.9))
        jkl, tkl = j_kl(0.2), get_kl_controller(0.2)
        r = JF.batch_reward_norm(jnp.asarray(np.asarray(jb.meta["returns"], np.float32)))
        tok, jkl_now = JF.apply_kl_penalty(r, attn, pos, resp1, jnp.asarray(old),
                                           jnp.asarray(ref), jkl.value, cfg[0].kl_penalty)
        want = JF.compute_advantage(tok, resp1, adv_estimator="reinforce", gamma=cfg[0].gamma)
        fake = SimpleNamespace(pipeline_config=cfg[1], kl_ctrl=tkl)
        got, tkl_now = t_text.AgenticPipeline.advantages(fake, tb, old, ref)
    else:
        kw = dict(init_kl_coef=0.2, target_kl=0.01, adv_estimator="grpo",
                  whiten_advantages=True, advantage_clip=0.8, reward_clip=1.5)
        rn = {"grouping": "state", "method": "mean_std"}
        jcfg = j_acfg.AgenticConfig(
            reward_normalization=j_acfg.RewardNormalizationConfig(**rn), **kw)
        tcfg = t_acfg.AgenticConfig(
            reward_normalization=t_acfg.RewardNormalizationConfig(**rn), **kw)
        jkl, tkl = j_kl(0.2, 0.01), get_kl_controller(0.2, 0.01)
        rewards = j_vlm.AgenticVLMPipeline._normalized_rewards(
            SimpleNamespace(pipeline_config=jcfg, metrics=JMetrics()), jb)
        tok, jkl_now = JF.apply_kl_penalty(jnp.asarray(rewards), attn, pos, resp1,
                                           jnp.asarray(old), jnp.asarray(ref), jkl.value,
                                           jcfg.kl_penalty)
        jkl.update(float(jkl_now), len(jb))
        want = JF.compute_advantage(tok, resp1, adv_estimator="grpo", gamma=jcfg.gamma,
                                    lambd=jcfg.lambd, advantage_clip=jcfg.advantage_clip,
                                    whiten_advantages=True)
        fake = SimpleNamespace(pipeline_config=tcfg, kl_ctrl=tkl, metrics=MetricsManager())
        trewards = t_vlm.AgenticVLMPipeline._normalized_rewards(fake, tb)
        np.testing.assert_allclose(trewards, rewards, rtol=1e-6, atol=1e-6)
        got, tkl_now = t_vlm.AgenticVLMPipeline.advantages(fake, tb, trewards, old, ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(want["advantages"]), rtol=1e-6, atol=1e-6)
    assert float(tkl_now) == pytest.approx(float(jkl_now), rel=1e-6, abs=1e-7)
    assert tkl.value == pytest.approx(jkl.value, rel=1e-6)
    assert np.abs(got.numpy()).max() > 0
    if kind == "vlm":
        assert tkl.value != 0.2           # the VLM pipeline updates its controller


@pytest.mark.parametrize("kind", ["text", "vlm"])
def test_train_step_on_agentic_batch_matches_jax(kind):
    """One PPO step of JAX's make_train_step and of the port's on each
    pipeline's batch (the VLM batch with its image rows on the device):
    metrics at rtol 1e-5 / atol 1e-6 and params at 1e-5 of each leaf's
    scale, Adam's eps 1e-4 on both sides (tests/test_torch_train.py)."""
    jb, tb = (_text_batch if kind == "text" else _vlm_batch)("jax"), \
        (_text_batch if kind == "text" else _vlm_batch)("port")
    old, ref = _log_probs(tb, 7)
    adv = np.random.default_rng(8).normal(size=old.shape).astype(np.float32) * (old != 0)
    np_params = jax.tree.map(np.asarray, j_model.init_params(CONFIG, jax.random.key(2),
                                                             jnp.float32, with_vision=False))
    keys = ("input_ids", "attention_mask", "position_ids", "response_mask")
    batch = {**{k: np.asarray(jb.batch[k]) for k in keys}, "advantages": adv,
             "old_log_probs": old, "ref_log_probs": ref}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    if kind == "vlm":
        jbatch["image_embeds"] = jb.meta["image_embeds"]
        tbatch["image_embeds"] = tb.meta["image_embeds"]
    jopt = JT.make_optimizer(lr=1e-3, weight_decay=0.01, eps=1e-4)
    jstate, jm = jax.jit(JT.make_train_step(CONFIG, JL.PPOLossConfig(entropy_loss_coef=0.01),
                                            jopt))(JT.TrainState.create(
                                                jax.tree.map(jnp.asarray, np_params), jopt),
                                                jbatch)
    topt = TT.make_optimizer(lr=1e-3, weight_decay=0.01, eps=1e-4)
    tstate, tm = TT.make_train_step(_port(CONFIG), TL.PPOLossConfig(entropy_loss_coef=0.01),
                                    topt)(TT.TrainState.create(params_from_numpy(np_params, "cpu"),
                                                               topt), tbatch)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(tm["actor_train/grad_norm"]) > 0
    _assert_params_close(tstate.params, jax.tree.map(np.asarray, jstate.params))


# ------------------------------------------------------------- pipelines

def _greedy(ga, n):
    ga.max_new_tokens, ga.temperature, ga.do_sample = n, 0.0, False


def _build(side, kind, out_dir):
    """One package's pipeline at the JAX tests' tiny sizes, greedy, Adam's
    eps 1e-4. Returns (pipe, recorded episodes)."""
    jax_side = side == "jax"
    np_params = _weights(kind == "vlm")
    if jax_side:
        policy = ref = jax.tree.map(jnp.asarray, np_params)
        cache = {"cache_dtype": jnp.float32}
    else:
        policy, ref = params_from_numpy(np_params, "cpu"), params_from_numpy(np_params, "cpu")
        cache = {"cache_dtype": torch.float32}
    model_config = CONFIG if jax_side else _port(CONFIG)
    seen = []
    if kind == "text":
        cfg = (JRLVRConfig if jax_side else RLVRConfig)(
            output_dir=out_dir, rollout_batch_size=2, prompt_length=64, response_length=8,
            max_steps=1, save_steps=-1, entropy_loss_coef=0.01, init_kl_coef=0.1)
        _greedy(cfg.actor_infer.generating_args, 4)
        mod = j_text if jax_side else t_text
        pipe = mod.AgenticPipeline(cfg, model_config=model_config, policy_params=policy,
                                   reference_params=ref, processor=_processor(side),
                                   env_name="guess_number",
                                   env_kwargs={"low": 0, "high": 9, "max_turns": 3},
                                   engine_kwargs={"max_slots": 2, "max_len": 96,
                                                  "decode_chunk": 4, "prefill_buckets": (64,),
                                                  **cache})
        loop = pipe.env_worker.run_rollout_loop
        pipe.env_worker.run_rollout_loop = lambda *a, **k: seen.append(loop(*a, **k)) or seen[-1]
    else:
        acfg = j_acfg if jax_side else t_acfg
        cfg = acfg.AgenticConfig(
            output_dir=out_dir, rollout_batch_size=4, prompt_length=768, response_length=16,
            max_steps=1, save_steps=-1, eval_steps=1, val_batch_size=2, max_steps_per_traj=2,
            adv_estimator="grpo", entropy_loss_coef=0.01, init_kl_coef=0.1, target_kl=0.05,
            reward_normalization=acfg.RewardNormalizationConfig(grouping="state",
                                                                method="mean_std"),
            train_env_manager=acfg.EnvManagerConfig(env_groups=2, group_size=2,
                                                    tags=["grid_goal"]),
            val_env_manager=acfg.EnvManagerConfig(env_groups=1, tags=["grid_goal"]))
        _greedy(cfg.actor_infer.generating_args, 6)
        mod = j_vlm if jax_side else t_vlm
        pipe = mod.AgenticVLMPipeline(cfg, model_config=model_config, policy_params=policy,
                                      reference_params=ref,
                                      processor=_processor(side, image=True),
                                      engine_kwargs={"max_slots": 2, "max_len": 1024,
                                                     "decode_chunk": 4,
                                                     "prefill_buckets": (768,),
                                                     "image_buckets": (64,), **cache})
        get = pipe.train_rollout.get_batch
        pipe.train_rollout.get_batch = lambda *a, **k: seen.append(get(*a, **k)) or seen[-1]
    _adam_eps(side, pipe)
    return pipe, seen


_WEIGHTS = {}


def _weights(with_vision):
    if with_vision not in _WEIGHTS:
        _WEIGHTS[with_vision] = jax.tree.map(np.asarray, j_model.init_params(
            CONFIG, jax.random.key(0), jnp.float32, with_vision=with_vision))
    return _WEIGHTS[with_vision]


@pytest.fixture(scope="module", params=["text", "vlm"])
def greedy_runs(request, tmp_path_factory):
    out = {}
    for side in ("jax", "port"):
        pipe, seen = _build(side, request.param, str(tmp_path_factory.mktemp(side)))
        out[side] = (pipe, seen, pipe.run())
    return request.param, out


def test_greedy_step_episodes_match_jax(greedy_runs):
    kind, out = greedy_runs
    (_, jseen, _), (_, tseen, _) = out["jax"], out["port"]
    assert len(tseen) == len(jseen) == 1
    if kind == "text":
        assert [vars(t) for t in tseen[0]] == [vars(t) for t in jseen[0]]
        assert all(t.actions for t in tseen[0])
        # the loop's turns come from extra_fields["max_turns"] (default 6),
        # apart from the env's own max_turns
        tworker, jworker = out["port"][0].env_worker, out["jax"][0].env_worker
        assert tworker.max_turns == jworker.max_turns == 6
        assert tworker.env.max_turns == jworker.env.max_turns == 3
    else:
        for je, te in zip(jseen[0], tseen[0]):
            for f in ("input_ids", "response_mask", "image_grid_thw", "score", "penalty",
                      "llm_raw_texts", "turns", "solved"):
                _same(getattr(je, f), getattr(te, f), f)
            np.testing.assert_allclose(_np(te.image_embeds), np.asarray(je.image_embeds),
                                       rtol=1e-5, atol=1e-5)
        assert max(e.turns for e in tseen[0]) == 2


def test_greedy_step_metrics_and_params_match_jax(greedy_runs):
    """The same metric keys (the VLM pipeline's validation keys too); the
    PPO, KL, score and token figures at rtol 1e-5 / atol 1e-6 (time/ keys
    are wall times); the trained weights at 1e-5 of each leaf's scale; the
    VLM pipeline's KL controller updated, the text pipeline's not."""
    kind, out = greedy_runs
    (jpipe, _, jm), (tpipe, _, tm) = out["jax"], out["port"]
    assert set(tm) == set(jm)
    for k in jm:
        if not k.startswith("time/"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert np.isfinite(list(tm.values())).all() and tm["actor_train/grad_norm"] > 0
    _assert_params_close(tpipe.actor_train.params, jax.tree.map(np.asarray,
                                                                jpipe.actor_train.params))
    assert tpipe.kl_ctrl.value == pytest.approx(jpipe.kl_ctrl.value, rel=1e-5)
    assert (tpipe.kl_ctrl.value != 0.1) == (kind == "vlm")


# ------------------------------------------------------------- port only

def test_embedder_in_a_fresh_thread_with_grad_params():
    """The env threads' embedder runs the tower under no_grad in a fresh
    thread (grad mode is thread-local): with parameters that require grad
    its rows carry no autograd graph and equal the main thread's."""
    tcfg = _port(CONFIG)
    params = t_model.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    def leaves(tree):
        return [x for v in tree.values() for x in (leaves(v) if isinstance(v, dict) else [v])]
    for leaf in leaves(params["vision"]):
        leaf.requires_grad_(True)
    store = SimpleNamespace(get=lambda name: params)
    embed = t_vlm._Embedder(tcfg, store, _processor("port", image=True).image_config)
    frame = t_env.make_env("grid_goal").reset(seed=1)["image"]
    got = []
    threads = [threading.Thread(target=lambda: got.append(embed([frame], np.array([[1, 8, 8]]))))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with torch.no_grad():
        want = embed([frame], np.array([[1, 8, 8]]))
    assert len(got) == 3 and want.shape == (16, HIDDEN)
    for g in got:
        assert not g.requires_grad and g.grad_fn is None
        assert torch.equal(g, want)


def test_growing_prompts_never_fork_a_stale_prefix(tmp_path):
    """The engine keys a prefix fork on the prompt and the image rows'
    object: a turn's prompt holds the last one whole plus the action and the
    next frame, and each turn concatenates its rows anew, so no request of
    an episode forks, and the episodes equal those of an engine without the
    fork (greedy, the same seed in each group of two)."""
    runs = []
    for fork in (True, False):
        cfg = t_acfg.AgenticConfig(
            output_dir=str(tmp_path), rollout_batch_size=4, prompt_length=768,
            response_length=16, max_steps=1, save_steps=-1, max_steps_per_traj=3,
            train_env_manager=t_acfg.EnvManagerConfig(env_groups=2, group_size=2,
                                                      tags=["grid_goal"]))
        _greedy(cfg.actor_infer.generating_args, 6)
        pipe = t_vlm.AgenticRolloutPipeline(
            cfg, model_config=_port(CONFIG), policy_params=params_from_numpy(_weights(True),
                                                                             "cpu"),
            processor=_processor("port", image=True),
            engine_kwargs={"max_slots": 4, "max_len": 1024, "decode_chunk": 4,
                           "prefill_buckets": (768,), "image_buckets": (256,),
                           "cache_dtype": torch.float32, "prefix_fork": fork})
        eps = pipe.rollout.get_batch(seed=3)
        runs.append((eps, pipe.actor_infer.engine))
    (eps, engine), (plain_eps, _) = runs
    assert engine.forked_requests == 0 and engine.prefill_rows == sum(e.turns for e in eps)
    assert max(e.turns for e in eps) == 3
    for a, b in zip(eps, plain_eps):
        _same(a.input_ids, b.input_ids)
        _same(a.response_mask, b.response_mask)


def test_agentic_config_loads_from_yaml(tmp_path):
    """load_config reads AgenticConfig with its nested env managers and
    reward normalisation, as the JAX package's loader does."""
    from socioreasoner_tpu.configs.loader import load_config as j_load
    path = tmp_path / "agentic.yaml"
    path.write_text("max_steps_per_traj: 5\nval_batch_size: 2\n"
                    "reward_normalization: {grouping: tags, method: asym_clip}\n"
                    "train_env_manager: {env_groups: 3, group_size: 2, tags: [grid_goal],"
                    " format_penalty: -0.2}\n"
                    "custom_envs: {grid_goal: {size: 5}}\nprompt_length: 512\n")
    got, want = load_config(t_acfg.AgenticConfig, str(path)), \
        j_load(j_acfg.AgenticConfig, str(path))
    assert isinstance(got.train_env_manager, t_acfg.EnvManagerConfig)
    assert got.train_env_manager.total_envs == 6 == got.train_env_manager.max_env_num_per_worker
    assert got.reward_normalization.grouping == "tags"
    assert _port(want) == got


def test_chip_smoke_agentic_phase_on_cpu(tmp_path):
    """chip_smoke's agentic phase at the tiny config on the CPU: the VLM
    pipeline's two steps (each episode's response mask holding exactly the
    sampled ids, 16 image rows a frame), its rollout-only step and the text
    pipeline's step, with finite metrics, a reference left unmoved and the
    shapes the phase records."""
    import chip_smoke
    tcfg = _port(CONFIG)
    params = t_model.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    cpu = torch.device("cpu")
    vlm = chip_smoke.run_agentic_vlm(tcfg, params, str(tmp_path), cpu,
                                     processor=_processor("port", image=True),
                                     buckets=(256, 512), prompt_length=512, response_length=8,
                                     temperature=0.0)
    assert vlm["steps"] == 2 and vlm["launches"] == {} and vlm["val_episodes"] == 4
    assert {tuple(b) for b in vlm["prefill_buckets"]} <= set(chip_smoke.AGENTIC_PREFILL)
    assert vlm["cache"] == [2, 4, 768, 2, 16]
    assert all(e["embed_rows"] == 16 * e["frames"] and e["turns"] == 3 for e in vlm["episodes"])
    assert len(vlm["train_shapes"]) == 2 and vlm["rollout_pipeline"]["episodes"] == 4
    assert vlm["kl_coef"][0] != vlm["kl_coef"][1]
    assert vlm["decode_profile"]["steps"] > 0
    text = chip_smoke.run_agentic_text(tcfg, params, cpu, processor=_processor("port"),
                                       buckets=(128,), prompt_length=128, response_length=8,
                                       max_steps=1, episodes=2, max_turns=2)
    assert text["steps"] == 1 and text["prefill_buckets"] == [(1, 128)]
    assert text["train_shapes"][0][:2] == (2, 136) and text["cache"] == [2, 4, 256, 2, 16]
