"""RLVRPipeline: multi-domain verifiable-reward GRPO over text prompts.

The port's counterpart of socioreasoner_tpu/pipeline/rlvr/rlvr_pipeline.py
on one GPU: domain-tagged prompts route to per-domain reward functions
(`tag`); rollouts come from the decode engine, either as one collated batch
or streamed through DynamicSamplingScheduler (with query and response
filters, flow control and per-group rewards while decoding goes on); the
sample-level masks (max-len, difficulty) apply, rewards are normalised
(group, batch or running) and clipped, the KL penalty and the advantage
follow, and the policy trains with PPO-clip and the k3 KL loss.

Train, reference and decode share the GPU as in SocioSegPipeline: the
trainer updates the policy in place, the reference holds its own copy of
the weights, and model_update hands the trainer's tensors to the engine.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ...configs.rlvr_config import RLVRConfig
from ...distributed.strategy import ParamStore
from ...distributed.torch_strategies import (TorchDecodeStrategy, TorchInferStrategy,
                                             TorchTrainStrategy, copy_shared)
from ...models.qwen2_5_vl.config import Qwen25VLConfig
from ...models.qwen2_5_vl.rope import get_rope_index
from ...pipeline.losses import PPOLossConfig
from ...protocol import BatchProto
from ...runtime.cluster import Cluster
from ...runtime.generate_scheduler import DynamicSamplingScheduler, LocalGenerateGroup
from ...utils import functionals as fn
from ...utils.functionals import RunningMoments
from ...utils.kl_controller import get_kl_controller
from ..base_pipeline import BasePipeline
from .rewards.math_rule import compute_math_rewards

RewardFn = Callable[[List[str], List], Dict]


def _reward_with_rows(fn_: RewardFn) -> Callable:
    """A (texts, ground truths) reward as the scheduler calls it, with the
    group's dataset rows."""
    return lambda texts, rows: fn_(texts, [r.get("ground_truth", "") for r in rows])


class RLVRPipeline(BasePipeline):
    def __init__(self, pipeline_config: RLVRConfig, *,
                 model_config: Qwen25VLConfig, policy_params, reference_params,
                 processor, dataset: List[Dict],
                 reward_fns: Optional[Dict[str, RewardFn]] = None,
                 engine_kwargs: Optional[Dict] = None,
                 query_filter=None, response_filter=None):
        """policy_params / reference_params: the port's trees on the device
        the models run on; the trainer updates policy_params in place and the
        reference keeps its own copy of what it shares with them. Rewards:
        `reward_fns` ({domain: (texts, ground_truths) -> {"response_level_
        rewards", "scores", "metrics"}}), else a Cluster of each worker_cls
        the config's `rewards:` names, else the math rule."""
        super().__init__(pipeline_config)
        cfg = pipeline_config
        self.model_config = model_config
        self.processor = processor
        self.dataset = dataset
        # rewards: the callables given, else the config's reward worker
        # clusters (rewards: {domain: worker_cls, world_size}), else the
        # math rule
        self.reward_clusters = {}
        if reward_fns is None and cfg.rewards:
            reward_fns = {}
            for domain, wc in cfg.rewards.items():
                if not wc.worker_cls:
                    continue
                cluster = Cluster(domain, wc.worker_cls, wc)
                cluster.initialize(pipeline_config=cfg, tokenizer=processor)
                self.reward_clusters[domain] = cluster
                reward_fns[domain] = self._cluster_reward_fn(cluster)
        self.reward_fns = reward_fns or {
            "math": lambda resp, gts: compute_math_rewards(resp, gts)}

        self.param_store = ParamStore()
        self.actor_train = TorchTrainStrategy(worker_config=cfg.actor_train,
                                              param_store=self.param_store)
        self.actor_train.initialize(
            model_config, policy_params,
            PPOLossConfig(pg_clip=cfg.pg_clip, dual_clip_loss=cfg.dual_clip_loss,
                          use_kl_loss=cfg.use_kl_loss, kl_loss_coef=cfg.kl_loss_coef,
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
        self.running = {"default": RunningMoments()}
        cfg.set_max_steps(len(dataset))

        # dynamic sampling: prompt groups streamed through the server with
        # filters and flow control, rewarded as each group completes
        self.sampler = None
        if cfg.is_use_additional_prompts or cfg.generate_opt_level >= 1:
            self.sampler = DynamicSamplingScheduler(
                LocalGenerateGroup([self.actor_infer]), self._collate,
                reward_fns={d: _reward_with_rows(f) for d, f in self.reward_fns.items()},
                detokenize=lambda ids: self.processor.decode(np.asarray(ids)),
                query_filter=query_filter, response_filter=response_filter,
                is_use_additional_prompts=cfg.is_use_additional_prompts,
                max_running_requests=cfg.max_running_requests,
                max_additional_running_prompts=cfg.max_additional_running_prompts,
                alive_check_interval=cfg.alive_check_interval)
            self._data_iter = itertools.cycle(dataset) if dataset else iter(())

    @staticmethod
    def _cluster_reward_fn(cluster: Cluster) -> RewardFn:
        """A reward worker cluster as a (texts, ground truths) -> dict reward
        function; the cluster chunks the batch over its workers."""
        def fn(texts, gts):
            data = BatchProto.from_dict(non_tensors={
                "response_text": [str(t) for t in texts], "ground_truth": list(gts)})
            out = cluster.compute_rewards(data)
            result = {k: np.asarray(v) for k, v in out.batch.items()}
            for k, v in out.meta.items():
                result.setdefault(k, v)
            return result
        return fn

    # ---------------------------------------------------------------- collate
    def _collate(self, rows: List[Dict]) -> BatchProto:
        """Chat-templated prompts, left-padded to prompt_length."""
        pad = self.model_config.pad_token_id
        P = self.pipeline_config.prompt_length
        ids = np.full((len(rows), P), pad, np.int64)
        attn = np.zeros((len(rows), P), np.int64)
        for i, row in enumerate(rows):
            text = self.processor.apply_chat_template(row["prompt"], 0)
            toks = self.processor.tokenizer.encode(text)[-P:]
            ids[i, P - len(toks):] = toks
            attn[i, P - len(toks):] = 1
        pos, _ = get_rope_index(self.model_config, ids, None, attn)
        return BatchProto.from_dict(
            tensors={"input_ids": ids, "attention_mask": attn, "position_ids": pos},
            non_tensors={"ground_truth": [r.get("ground_truth", "") for r in rows],
                         "tag": [r.get("tag", "math") for r in rows]},
            meta={"pad_token_id": pad})

    # -------------------------------------------------------------------- run
    def _rollout(self, step: int, mm):
        """(the prompt batch, the generated sequences, (rewards, scores) when
        the scheduler computed them), or None when the data ran out."""
        cfg = self.pipeline_config
        bs = cfg.rollout_batch_size
        if self.sampler is not None:
            with mm.timer("generate"):
                batch = self.sampler.get_batch(self._data_iter, bs,
                                               cfg.actor_infer.generating_args)
            if not len(batch):
                return None
            seqs = batch.meta.pop("output")
            mm.add_metrics(batch.meta.pop("metrics", {}))
            sched = None
            if "response_level_rewards" in batch.meta:
                sched = (batch.meta.pop("response_level_rewards"), batch.meta.pop("scores"))
            return batch, seqs, sched
        rows = self.dataset[(step * bs) % max(len(self.dataset), 1):][:bs]
        if not rows:
            return None
        batch = self._collate(rows)
        with mm.timer("generate"):
            seqs = self.actor_infer.generate(batch, cfg.actor_infer.generating_args)
        return batch, seqs, None

    def _rewards(self, expanded: BatchProto, texts: List[str], mm):
        """Per-domain rewards of the expanded batch (a tag without a reward
        function goes to "math")."""
        rewards = np.zeros(len(expanded), np.float32)
        scores = np.zeros(len(expanded), np.float32)
        tags = [str(t) for t in expanded.non_tensor["tag"]]
        for domain, fn_ in self.reward_fns.items():
            idx = [i for i, t in enumerate(tags)
                   if t == domain or (domain == "math" and t not in self.reward_fns)]
            if not idx:
                continue
            out = fn_([texts[i] for i in idx],
                      [expanded.non_tensor["ground_truth"][i] for i in idx])
            rewards[idx] = out["response_level_rewards"]
            scores[idx] = out.get("scores", out["response_level_rewards"])
            mm.add_domain_metrics(domain, out.get("metrics", {}))
        return rewards, scores

    def _sample_mask(self, resp_mask: np.ndarray, scores: np.ndarray, n: int) -> np.ndarray:
        """The response mask times the sample-level masks (max-len,
        difficulty); the response mask alone if they mask everything."""
        cfg = self.pipeline_config
        sample_mask = np.ones(len(scores), np.float32)
        if cfg.max_len_mask:
            sample_mask *= (resp_mask.sum(-1) != cfg.response_length).astype(np.float32)
        if cfg.difficulty_mask and n > 1:
            sample_mask *= fn.difficulty_mask(
                torch.as_tensor(scores), n, cfg.difficulty_low_threshold,
                cfg.difficulty_high_threshold).numpy()
        final_mask = resp_mask * sample_mask[:, None]
        return resp_mask if final_mask.sum() == 0 else final_mask

    def _normalize_rewards(self, rewards: np.ndarray, n: int) -> torch.Tensor:
        cfg = self.pipeline_config
        r = torch.as_tensor(rewards)
        if cfg.adv_estimator == "grpo" or cfg.reward_norm == "group":
            if n > 1:
                r = fn.group_reward_norm(r, n, div_std=not cfg.reward_shift)
        elif cfg.reward_norm == "batch":
            r = fn.batch_reward_norm(r, div_std=not cfg.reward_shift)
        elif cfg.reward_norm == "running":
            run = self.running["default"]
            run.update(rewards)
            r = (r - run.mean) / (run.std + 1e-6)
        if cfg.reward_clip:
            r = r.clamp(-cfg.reward_clip, cfg.reward_clip)
        return r

    def run(self) -> Dict[str, float]:
        cfg = self.pipeline_config
        n = cfg.num_return_sequences
        mm = self.metrics
        step = self.state.step
        last: Dict[str, float] = {}

        while step < cfg.max_steps:
            t0 = time.perf_counter()
            self.model_update(step)   # every model_update_frequency steps

            t_gen = time.perf_counter()
            rolled = self._rollout(step, mm)
            if rolled is None:
                break
            batch, seqs, sched_rewards = rolled
            gen_time = time.perf_counter() - t_gen
            post = fn.postprocess_generate(
                input_ids=np.asarray(batch.batch["input_ids"]),
                attention_mask=np.asarray(batch.batch["attention_mask"]),
                position_ids=np.asarray(batch.batch["position_ids"]),
                output=seqs, num_return_sequences=n,
                sequence_length=cfg.sequence_length,
                eos_token_id=self.model_config.eos_token_id,
                pad_token_id=self.model_config.pad_token_id)
            mm.add_token_throughput("actor_infer/", int(np.asarray(post["response_mask"]).sum()),
                                    gen_time)
            texts = self._decode(post)
            expanded = batch.repeat(n)

            # the scheduler rewarded each group while decoding went on
            if sched_rewards is not None:
                rewards, scores = (np.asarray(sched_rewards[0], np.float32),
                                   np.asarray(sched_rewards[1], np.float32))
            else:
                rewards, scores = self._rewards(expanded, texts, mm)

            train_batch = BatchProto.from_dict(tensors={
                "input_ids": post["input_ids"],
                "attention_mask": post["attention_mask"],
                "position_ids": post["position_ids"],
                "response_mask": post["response_mask"],
                "scores": scores,
            })

            with mm.timer("logprobs"):
                old_lp = self.actor_train.compute_log_probs(train_batch)["log_probs"]
                ref_lp = self.reference.compute_log_probs(train_batch)["log_probs"]

            final_mask = self._sample_mask(
                train_batch.batch["response_mask"][:, 1:].astype(np.float32), scores, n)
            r = self._normalize_rewards(rewards, n)
            tok_rewards, cur_kl = fn.apply_kl_penalty(
                r, torch.as_tensor(train_batch.batch["attention_mask"]),
                torch.as_tensor(train_batch.batch["position_ids"]),
                torch.as_tensor(final_mask), torch.as_tensor(old_lp),
                torch.as_tensor(ref_lp), self.kl_ctrl.value, cfg.kl_penalty)
            self.kl_ctrl.update(float(cur_kl), len(expanded))
            adv = fn.compute_advantage(
                tok_rewards, torch.as_tensor(final_mask),
                adv_estimator=cfg.adv_estimator, gamma=cfg.gamma, lambd=cfg.lambd,
                advantage_clip=cfg.advantage_clip,
                whiten_advantages=cfg.whiten_advantages)
            train_batch.batch["advantages"] = adv["advantages"].numpy()
            train_batch.batch["old_log_probs"] = old_lp
            train_batch.batch["ref_log_probs"] = ref_lp
            train_batch.batch["response_mask"] = np.concatenate(
                [train_batch.batch["response_mask"][:, :1].astype(np.float32), final_mask],
                axis=1)

            total_tokens = int(np.asarray(train_batch.batch["attention_mask"]).sum())
            t_train = time.perf_counter()
            with mm.timer("train"):
                metrics = self.actor_train.train_step(train_batch)
            mm.add_token_throughput("actor_train/", total_tokens, time.perf_counter() - t_train)
            metrics["critic/kl"] = float(cur_kl)
            metrics["critic/reward_mean"] = float(rewards.mean())
            metrics["critic/score_mean"] = float(scores.mean())
            mm.add_token_throughput("", total_tokens, time.perf_counter() - t0)
            mm.add_time("step", time.perf_counter() - t0)
            last = {**mm.reduce(), **metrics}
            self.log_metrics(last, step)
            self.do_checkpoint(step)
            step += 1
            self.state.step = step
        return last

    def _decode(self, post) -> List[str]:
        pad = self.model_config.pad_token_id
        return [self.processor.decode(row[row != pad]) for row in post["responses"]]
