"""AgenticVLMPipeline (multi-turn VLM env RL) and AgenticRolloutPipeline
(rollout only).

The port's counterpart of socioreasoner_tpu/pipeline/agentic/
agentic_vlm_pipeline.py on one GPU. Episodes come from EnvManagers running
in threads, each sending one request at a time through a RequestScheduler
to the decode engine, which batches the env threads' requests continuously.
Observations are images carried into every later turn's prompt; their ViT
rows are computed once, from the current rollout tree, and stay tensors on
the device through the log-prob and train steps; the sampled action ids
enter the training sequence verbatim. GRPO over episode groups: score
normalisation (mean_std / mean / asym_clip / identity) within the
configured grouping, reward clip, KL penalty, advantage, PPO train step.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ...configs.agentic_config import AgenticConfig
from ...distributed.strategy import ParamStore
from ...distributed.torch_strategies import (TorchDecodeStrategy, TorchInferStrategy,
                                             TorchTrainStrategy, copy_shared)
from ...generation.sampling import SamplingParams
from ...models.qwen2_5_vl.config import Qwen25VLConfig
from ...models.qwen2_5_vl.rope import get_rope_index
from ...models.qwen2_5_vl.vision import run_vision_u8
from ...pipeline.losses import PPOLossConfig
from ...protocol import BatchProto
from ...runtime.generate_scheduler import (GlobalCounter, LocalGenerateGroup,
                                           RequestScheduler)
from ...utils import functionals as fn
from ...utils.kl_controller import get_kl_controller
from ..base_pipeline import BasePipeline
from .environment_worker import EnvManager, Episode, make_env


def get_score_normalize_fn(rn_cfg) -> Callable[[np.ndarray], np.ndarray]:
    """The score normalisation of `rn_cfg.method`, over one group's scores
    (numpy)."""
    method = rn_cfg.method

    def _std_norm(x):
        std = x.std()
        if abs(std) <= 1e-6:
            return np.zeros_like(x)
        return (x - x.mean()) / (std + 1e-6)

    if method == "mean_std":
        return _std_norm
    if method == "mean":
        return lambda x: x - x.mean()
    if method == "asym_clip":
        return lambda x: np.clip(_std_norm(x), -1.0, 3.0)
    if method == "identity":
        return lambda x: x
    raise ValueError(f"Invalid normalization method: {method}")


def dump_rollout_render(save_dir: str, step: int, episodes: List[Episode]):
    """Each episode's frames as PNGs under save_dir/step_{step}."""
    from PIL import Image
    out = os.path.join(save_dir, f"step_{step}")
    os.makedirs(out, exist_ok=True)
    for ep in episodes:
        for t, frame in enumerate(ep.frames):
            Image.fromarray(frame).save(
                os.path.join(out, f"env{ep.env_id}_turn{t}_score{ep.score:.2f}.png"))


class _VLMRolloutGroup:
    """A fleet of EnvManagers, one env a thread, grouped so that GRPO
    normalises within groups of one seed, pulling episodes through a
    RequestScheduler."""

    def __init__(self, *, config: AgenticConfig, env_manager_config,
                 cluster: LocalGenerateGroup, processor, model_config,
                 embed_fn=None, mode: str = "train"):
        self.config = config
        self.emc = env_manager_config
        self.cluster = cluster
        self.scheduler = RequestScheduler(cluster, config)
        self.processor = processor
        self.model_config = model_config
        self.embed_fn = embed_fn
        self.mode = mode
        self.counter = GlobalCounter()

    def get_batch(self, seed: int = 0, n_episodes: Optional[int] = None) -> List[Episode]:
        emc = self.emc
        total = n_episodes or emc.total_envs
        group_size = max(1, emc.group_size)
        sp = SamplingParams.from_generating_args(self.config.actor_infer.generating_args)
        managers = []
        tags = emc.tags or ["grid_goal"]
        for env_id in range(total):
            group_id = env_id // group_size
            tag = tags[group_id % len(tags)]
            env_kwargs = dict(self.config.custom_envs.get(tag, {}))
            env_kwargs.pop("env_type", None)
            managers.append(EnvManager(
                env=make_env(env_kwargs.pop("env_name", tag), **env_kwargs),
                processor=self.processor, scheduler=self.scheduler,
                embed_fn=self.embed_fn, sampling=sp,
                max_turns=self.config.max_steps_per_traj,
                prompt_length=self.config.prompt_length,
                group_id=group_id, env_id=env_id, tag=tag,
                format_penalty=emc.format_penalty))
        self.cluster.start_server()
        try:
            with ThreadPoolExecutor(max_workers=min(total, 64)) as ex:
                episodes = list(ex.map(
                    # the same seed within a group
                    lambda m: m.run_episode(seed=seed + m.group_id,
                                            request_counter=self.counter),
                    managers))
        finally:
            self.cluster.stop_server()
        return episodes


class _Embedder:
    """ViT rows of one episode's images from the param store's current
    rollout tree (kernel 1 on the GPU), for the env threads. Grad mode is
    thread-local and a fresh thread has it on, so the tower runs under
    no_grad (kernel 1 refuses a q that requires grad); one lock serialises
    the threads' calls (the plans are built a call and the launch counters
    are plain integers)."""

    def __init__(self, model_config: Qwen25VLConfig, param_store: ParamStore, image_config):
        self.model_config = model_config
        self.param_store = param_store
        self.image_config = image_config
        self._lock = threading.Lock()

    def __call__(self, images_u8: List[np.ndarray], grid_thw: np.ndarray) -> torch.Tensor:
        with self._lock, torch.no_grad():
            params = self.param_store.get("rollout")
            return run_vision_u8(self.model_config.vision, params["vision"], images_u8,
                                 grid_thw, self.image_config)


class AgenticVLMPipeline(BasePipeline):
    """Multi-turn VLM GRPO over env groups."""

    def __init__(self, pipeline_config: AgenticConfig, *,
                 model_config: Qwen25VLConfig, policy_params, reference_params,
                 processor, engine_kwargs: Optional[Dict] = None):
        """policy_params: the tree the trainer updates in place and the
        engine serves; reference_params: the frozen reference (given its own
        copy of whatever it shares with the policy)."""
        super().__init__(pipeline_config)
        cfg = pipeline_config
        self.model_config = model_config
        self.processor = processor
        # EnvManager derives the M-RoPE ids through the processor
        processor.model_config = model_config

        self.param_store = ParamStore()
        self.actor_train = TorchTrainStrategy(worker_config=cfg.actor_train,
                                              param_store=self.param_store)
        self.actor_train.initialize(
            model_config, policy_params,
            PPOLossConfig(pg_clip=cfg.pg_clip, use_kl_loss=cfg.use_kl_loss,
                          kl_loss_coef=cfg.kl_loss_coef,
                          entropy_loss_coef=cfg.entropy_loss_coef,
                          loss_agg_mode=cfg.loss_agg_mode),
            cfg.actor_train.training_args)
        self.reference = TorchInferStrategy(worker_config=cfg.reference,
                                            param_store=self.param_store)
        self.reference.initialize(model_config, copy_shared(reference_params, policy_params))
        self.actor_train.model_update()
        self.actor_infer = TorchDecodeStrategy(worker_config=cfg.actor_infer,
                                               param_store=self.param_store)
        self.actor_infer.initialize(model_config, engine_kwargs=engine_kwargs)
        self.set_model_update_pair(
            self.actor_train, self.actor_infer,
            frequency=max(1, cfg.actor_infer.model_update_frequency))
        self.kl_ctrl = get_kl_controller(cfg.init_kl_coef, cfg.target_kl, cfg.kl_horizon)
        self._embed = _Embedder(model_config, self.param_store, processor.image_config)
        cluster = LocalGenerateGroup([self.actor_infer])
        self.train_rollout = _VLMRolloutGroup(
            config=cfg, env_manager_config=cfg.train_env_manager,
            cluster=cluster, processor=processor, model_config=model_config,
            embed_fn=self._embed, mode="train")
        self.val_rollout = _VLMRolloutGroup(
            config=cfg, env_manager_config=cfg.val_env_manager,
            cluster=cluster, processor=processor, model_config=model_config,
            embed_fn=self._embed, mode="val")

    # ------------------------------------------------------------- train batch
    def _episodes_to_batch(self, episodes: List[Episode]) -> BatchProto:
        """The episodes' sequences right-padded to the longest (at most
        prompt_length + response_length), their response, prompt and
        non-prompt masks, M-RoPE ids over every image, and in meta the
        scores, penalties, group ids and tags, the image rows concatenated on
        the device (`image_embeds`) with each episode's row count
        (`image_embeds_rows`)."""
        cfg = self.pipeline_config
        pad = self.model_config.pad_token_id
        L = min(max(len(e.input_ids) for e in episodes),
                cfg.prompt_length + cfg.response_length)
        B = len(episodes)
        ids = np.full((B, L), pad, np.int64)
        attn = np.zeros((B, L), np.int64)
        resp = np.zeros((B, L), np.int64)
        for i, e in enumerate(episodes):
            n = min(len(e.input_ids), L)
            ids[i, :n] = e.input_ids[:n]
            attn[i, :n] = 1
            resp[i, :n] = e.response_mask[:n]
        grids = [e.image_grid_thw for e in episodes if e.image_grid_thw is not None]
        grid_all = np.concatenate(grids, axis=0) if grids else None
        pos, _ = get_rope_index(self.model_config, ids, grid_all, attn)
        embeds = [e.image_embeds for e in episodes if e.image_embeds is not None]
        rows = np.array([0 if e.image_embeds is None else int(e.image_embeds.shape[0])
                         for e in episodes], np.int64)
        meta: Dict = {
            "scores": np.array([e.score for e in episodes], np.float32),
            "penalty": np.array([e.penalty for e in episodes], np.float32),
            "group_ids": np.array([e.group_id for e in episodes], np.int64),
            "tags": np.array([e.tag for e in episodes], object),
        }
        if embeds:
            meta["image_embeds"] = torch.cat(embeds, dim=0)
            meta["image_embeds_rows"] = rows
        return BatchProto.from_dict(
            tensors={"input_ids": ids, "attention_mask": attn, "position_ids": pos,
                     "response_mask": resp, "prompt_mask": attn * (1 - resp),
                     "non_prompt_mask": resp},
            meta=meta)

    # ------------------------------------------------------------------ scores
    def _normalized_rewards(self, batch: BatchProto) -> np.ndarray:
        """Score + penalty, normalised within the configured grouping, then
        clipped to reward_clip (recording critic/reward_clip_frac)."""
        cfg = self.pipeline_config
        mm = self.metrics
        scores = batch.meta["scores"] + batch.meta["penalty"]
        norm_fn = get_score_normalize_fn(cfg.reward_normalization)
        grouping = cfg.reward_normalization.grouping
        if grouping in ("state", "inductive"):
            keys = batch.meta["group_ids"]
        elif grouping == "tags":
            keys = batch.meta["tags"]
        else:                                    # "batch"
            keys = np.zeros(len(scores), np.int64)
        rewards = np.empty_like(scores)
        for k in np.unique(keys):
            m = keys == k
            rewards[m] = norm_fn(scores[m])
        if cfg.reward_clip:
            clip_frac = float(np.mean(np.abs(rewards) > cfg.reward_clip))
            mm.add_metric("critic/reward_clip_frac", clip_frac)
            rewards = np.clip(rewards, -cfg.reward_clip, cfg.reward_clip)
        return rewards

    def advantages(self, batch: BatchProto, rewards: np.ndarray, old_lp, ref_lp):
        """The step's advantage chain: the KL penalty at the controller's
        value, the controller's update with the batch's KL, the configured
        advantage estimator. Returns (advantages (B, L-1) f32 tensor, the
        current KL)."""
        cfg = self.pipeline_config
        resp1 = torch.as_tensor(batch.batch["response_mask"][:, 1:])
        tok, cur_kl = fn.apply_kl_penalty(
            torch.as_tensor(rewards), torch.as_tensor(batch.batch["attention_mask"]),
            torch.as_tensor(batch.batch["position_ids"]), resp1,
            torch.as_tensor(old_lp), torch.as_tensor(ref_lp),
            self.kl_ctrl.value, cfg.kl_penalty)
        self.kl_ctrl.update(float(cur_kl), len(batch))
        adv = fn.compute_advantage(
            tok, resp1, adv_estimator=cfg.adv_estimator, gamma=cfg.gamma,
            lambd=cfg.lambd, advantage_clip=cfg.advantage_clip,
            whiten_advantages=cfg.whiten_advantages)
        return adv["advantages"], cur_kl

    # --------------------------------------------------------------------- run
    def run(self) -> Dict[str, float]:
        cfg = self.pipeline_config
        mm = self.metrics
        step = self.state.step
        last: Dict[str, float] = {}
        while step < max(cfg.max_steps, 1):
            t0 = time.perf_counter()
            self.model_update(step)
            if cfg.eval_steps and step % cfg.eval_steps == 0:
                val_eps = self.val_rollout.get_batch(seed=cfg.seed + 10_000 + step,
                                                     n_episodes=cfg.val_batch_size)
                val_scores = np.array([e.score for e in val_eps], np.float32)
                mm.add_metric("val/score/mean", float(val_scores.mean()))
                mm.add_metric("val/score/max", float(val_scores.max()))
                mm.add_metric("val/score/min", float(val_scores.min()))
                if cfg.render_save_dir:
                    dump_rollout_render(cfg.render_save_dir, step, val_eps)
            with mm.timer("rollout"):
                episodes = self.train_rollout.get_batch(seed=cfg.seed + step)
            batch = self._episodes_to_batch(episodes)
            with mm.timer("ref_log_probs"):
                ref_lp = self.reference.compute_log_probs(batch)["log_probs"]
            with mm.timer("old_log_probs_values"):
                old = self.actor_train.compute_log_probs(batch)
                old_lp = old["log_probs"]
            resp1 = torch.as_tensor(batch.batch["response_mask"][:, 1:])
            mm.add_metric("critic/ref_log_prob/mean",
                          float(fn.masked_mean(torch.as_tensor(ref_lp), resp1)))
            mm.add_metric("critic/old_log_prob/mean",
                          float(fn.masked_mean(torch.as_tensor(old_lp), resp1)))
            if "entropy" in old:
                mm.add_metric("critic/entropy/mean", float(
                    fn.agg_loss(torch.as_tensor(old["entropy"]), resp1, "token-mean")))
            rewards = self._normalized_rewards(batch)
            with mm.timer("adv"):
                adv, cur_kl = self.advantages(batch, rewards, old_lp, ref_lp)
            batch.batch["advantages"] = adv.numpy()
            batch.batch["old_log_probs"] = np.asarray(old_lp)
            batch.batch["ref_log_probs"] = np.asarray(ref_lp)
            with mm.timer("train"):
                train_metrics = self.actor_train.train_step(batch)
            mm.add_metric("critic/kl", float(cur_kl))
            mm.add_metric("critic/score/mean", float(batch.meta["scores"].mean()))
            mm.add_metric("critic/score/max", float(batch.meta["scores"].max()))
            mm.add_metric("critic/score/min", float(batch.meta["scores"].min()))
            mm.add_metric("critic/penalty/mean", float(batch.meta["penalty"].mean()))
            mm.add_metric("agentic/solved_rate",
                          float(np.mean([e.solved for e in episodes])))
            mm.add_metric("tokens/response_length/mean",
                          float(batch.batch["response_mask"].sum(-1).mean()))
            mm.add_metric("tokens/prompt_length/mean",
                          float(batch.batch["prompt_mask"].sum(-1).mean()))
            mm.add_metric("system/samples", float((step + 1) * len(batch)))
            mm.add_time("step", time.perf_counter() - t0)
            last = {**mm.reduce(), **train_metrics}
            self.log_metrics(last, step)
            step += 1
            self.state.step = step
            self.do_checkpoint(step)
        return last


class AgenticRolloutPipeline(BasePipeline):
    """Rollout-only agentic pipeline: episodes and their score metrics, no
    training roles."""

    def __init__(self, pipeline_config: AgenticConfig, *,
                 model_config: Qwen25VLConfig, policy_params, processor,
                 engine_kwargs: Optional[Dict] = None):
        super().__init__(pipeline_config)
        cfg = pipeline_config
        self.model_config = model_config
        self.processor = processor
        processor.model_config = model_config
        self.param_store = ParamStore()
        self.param_store.put("rollout", policy_params)
        self.actor_infer = TorchDecodeStrategy(worker_config=cfg.actor_infer,
                                               param_store=self.param_store)
        self.actor_infer.initialize(model_config, engine_kwargs=engine_kwargs)
        self._embed = _Embedder(model_config, self.param_store, processor.image_config)
        self.rollout = _VLMRolloutGroup(
            config=cfg, env_manager_config=cfg.train_env_manager,
            cluster=LocalGenerateGroup([self.actor_infer]),
            processor=processor, model_config=model_config, embed_fn=self._embed)

    def run(self) -> Dict[str, float]:
        cfg = self.pipeline_config
        mm = self.metrics
        last: Dict[str, float] = {}
        for step in range(max(cfg.max_steps, 1)):
            with mm.timer("rollout"):
                episodes = self.rollout.get_batch(seed=cfg.seed + step)
            scores = np.array([e.score for e in episodes], np.float32)
            mm.add_metric("rollout/score/mean", float(scores.mean()))
            mm.add_metric("rollout/score/max", float(scores.max()))
            mm.add_metric("rollout/score/min", float(scores.min()))
            mm.add_metric("system/samples", float((step + 1) * len(episodes)))
            if cfg.render_save_dir:
                dump_rollout_render(cfg.render_save_dir, step, episodes)
            last = mm.reduce()
            self.log_metrics(last, step)
        return last
