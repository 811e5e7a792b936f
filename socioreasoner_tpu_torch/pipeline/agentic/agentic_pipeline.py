"""AgenticPipeline: multi-turn, env-in-the-loop RL on a text model.

The port's counterpart of socioreasoner_tpu/pipeline/agentic/
agentic_pipeline.py on one GPU: episodes from an EnvironmentWorker whose
policy is the decode engine, each episode's return normalised over the
step's episodes, the last turn's (prompt, action) of each episode trained
with the PPO loss (REINFORCE advantages). Model-agnostic: any text family
of models/llm.py serves and trains through it.

Kept from the reference: the rollout loop's turns come from
extra_fields["max_turns"] (default 6), apart from the env's own max_turns;
the KL controller is read, never updated; the batch re-encodes the last
action's decoded text (not the sampled ids).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ...configs.rlvr_config import RLVRConfig
from ...distributed.strategy import ParamStore
from ...distributed.torch_strategies import (TorchDecodeStrategy, TorchInferStrategy,
                                             TorchTrainStrategy, copy_shared)
from ...generation.engine import Request
from ...generation.sampling import SamplingParams
from ...models.qwen2_5_vl.config import Qwen25VLConfig
from ...models.qwen2_5_vl.rope import get_rope_index
from ...pipeline.losses import PPOLossConfig
from ...protocol import BatchProto
from ...utils import functionals as fn
from ...utils.kl_controller import get_kl_controller
from ..base_pipeline import BasePipeline
from .environment_worker import EnvironmentWorker


class AgenticPipeline(BasePipeline):
    def __init__(self, pipeline_config: RLVRConfig, *,
                 model_config: Qwen25VLConfig, policy_params, reference_params,
                 processor, env_name: str = "guess_number",
                 env_kwargs: Optional[Dict] = None,
                 engine_kwargs: Optional[Dict] = None):
        """policy_params: the tree the trainer updates in place and the
        engine serves; reference_params: the frozen reference (given its own
        copy of whatever it shares with the policy)."""
        super().__init__(pipeline_config)
        cfg = pipeline_config
        self.model_config = model_config
        self.processor = processor

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

        self.env_worker = EnvironmentWorker(worker_config=cfg.actor_infer)
        self.env_worker.initialize(cfg, env_name=env_name, env_kwargs=env_kwargs,
                                   generate_fn=self._act,
                                   max_turns=cfg.extra_fields.get("max_turns", 6))
        self.kl_ctrl = get_kl_controller(cfg.init_kl_coef, cfg.target_kl, cfg.kl_horizon)

    def _act(self, prompt: str) -> str:
        """One action: the templated prompt's last prompt_length tokens through
        the engine, decoded without special tokens."""
        text = self.processor.apply_chat_template(prompt, 0)
        ids = self.processor.tokenizer.encode(text)[-self.pipeline_config.prompt_length:]
        sp = SamplingParams.from_generating_args(
            self.pipeline_config.actor_infer.generating_args)
        outs = self.actor_infer.engine.generate(
            [Request(request_id=0, prompt_ids=ids, sampling=sp)])
        return self.processor.decode(outs[0].output_ids, skip_special_tokens=True)

    def advantages(self, batch: BatchProto, old_lp, ref_lp):
        """The step's advantage chain on a batch of `_episodes_to_batch`:
        returns normalised over the batch, the KL penalty at the (never
        updated) controller's value, REINFORCE advantages. Returns
        (advantages (B, L-1) f32 tensor, the current KL)."""
        cfg = self.pipeline_config
        resp = torch.as_tensor(batch.batch["response_mask"][:, 1:])
        r = fn.batch_reward_norm(torch.as_tensor(np.asarray(batch.meta["returns"],
                                                            np.float32)))
        tok, cur_kl = fn.apply_kl_penalty(
            r, torch.as_tensor(batch.batch["attention_mask"]),
            torch.as_tensor(batch.batch["position_ids"]), resp,
            torch.as_tensor(old_lp), torch.as_tensor(ref_lp),
            self.kl_ctrl.value, cfg.kl_penalty)
        adv = fn.compute_advantage(tok, resp, adv_estimator="reinforce", gamma=cfg.gamma)
        return adv["advantages"], cur_kl

    def run(self, episodes_per_step: Optional[int] = None) -> Dict[str, float]:
        cfg = self.pipeline_config
        mm = self.metrics
        n_eps = episodes_per_step or cfg.rollout_batch_size
        step = self.state.step
        last: Dict[str, float] = {}
        while step < max(cfg.max_steps, 1):
            t0 = time.perf_counter()
            self.model_update(step)   # every model_update_frequency steps
            with mm.timer("rollout"):
                trajs = self.env_worker.run_rollout_loop(n_eps, seed=cfg.seed + step)
            returns = np.array([t.total_reward for t in trajs], np.float32)
            mm.add_metric("agentic/return_mean", float(returns.mean()))
            mm.add_metric("agentic/solved_rate",
                          float(np.mean([t.info.get("solved", False) for t in trajs])))
            # a train batch of each episode's last (prompt, action)
            batch = self._episodes_to_batch(trajs, returns)
            if batch is not None:
                with mm.timer("train"):
                    old_lp = self.actor_train.compute_log_probs(batch)["log_probs"]
                    ref_lp = self.reference.compute_log_probs(batch)["log_probs"]
                    adv, cur_kl = self.advantages(batch, old_lp, ref_lp)
                    batch.batch["advantages"] = adv.numpy()
                    batch.batch["old_log_probs"] = old_lp
                    batch.batch["ref_log_probs"] = ref_lp
                    metrics = self.actor_train.train_step(batch)
                    metrics["critic/kl"] = float(cur_kl)
            else:
                metrics = {}
            mm.add_time("step", time.perf_counter() - t0)
            last = {**mm.reduce(), **metrics}
            self.log_metrics(last, step)
            step += 1
            self.state.step = step
        return last

    def _episodes_to_batch(self, trajs, returns) -> Optional[BatchProto]:
        """Rows of [the last turn's templated prompt (its last prompt_length
        tokens) | the last action re-encoded (its first response_length
        tokens)], right-padded to prompt_length + response_length, the action
        marked in response_mask; meta["returns"] the episodes' returns. None
        when no episode acted."""
        cfg = self.pipeline_config
        pad = self.model_config.pad_token_id
        L = cfg.prompt_length + cfg.response_length
        rows, resp_masks, rets = [], [], []
        for t, ret in zip(trajs, returns):
            if not t.actions:
                continue
            prompt_text = self.processor.apply_chat_template(t.observations[-1], 0)
            p_ids = self.processor.tokenizer.encode(prompt_text)[-cfg.prompt_length:]
            a_ids = self.processor.tokenizer.encode(t.actions[-1])[:cfg.response_length]
            seq = (p_ids + a_ids)[:L]
            row = np.full(L, pad, np.int64)
            row[:len(seq)] = seq
            m = np.zeros(L, np.int64)
            m[len(p_ids):len(seq)] = 1
            rows.append(row)
            resp_masks.append(m)
            rets.append(ret)
        if not rows:
            return None
        ids = np.stack(rows)
        attn = (ids != pad).astype(np.int64)
        pos, _ = get_rope_index(self.model_config, ids, None, attn)
        return BatchProto.from_dict(
            tensors={"input_ids": ids, "attention_mask": attn,
                     "position_ids": pos, "response_mask": np.stack(resp_masks)},
            meta={"returns": rets})
