"""MathVLMPipeline: single-stage VLM RLVR, the SocioSeg loop's simpler
ancestor.

The port's counterpart of socioreasoner_tpu/pipeline/rlvr/math_vlm_pipeline.py
on one GPU: image and question -> one generate (n samples a prompt) -> rule
reward (the math rule by default) -> GRPO -> train. It reuses the SocioSeg
collator with one image a prompt and no segmentation stage; the image
embeddings come from the rollout weights' ViT (the segmented kernel on the
GPU) and stay tensors on the device through the log-prob and train steps.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ...configs.rlvr_config import RLVRConfig
from ...datasets.collator import SocioSegCollator
from ...datasets.processor import SocioProcessor, build_chat_text
from ...distributed.strategy import ParamStore
from ...distributed.torch_strategies import (TorchDecodeStrategy, TorchInferStrategy,
                                             TorchTrainStrategy, batch_image_embeds,
                                             copy_shared)
from ...models.qwen2_5_vl.config import Qwen25VLConfig
from ...pipeline.losses import PPOLossConfig
from ...protocol import BatchProto
from ...utils import functionals as fn
from ...utils.kl_controller import get_kl_controller
from ..base_pipeline import BasePipeline
from .parsing import strip_special_tokens
from .rewards.math_rule import compute_math_rewards


def format_vlm_prompt(question: str, n_images: int = 1) -> str:
    text = (f"{question}\nOutput the thinking process in <think> </think> and "
            "final answer in <answer> </answer> tags.")
    return build_chat_text(text, n_images)


class MathVLMPipeline(BasePipeline):
    def __init__(self, pipeline_config: RLVRConfig, *,
                 model_config: Qwen25VLConfig, policy_params, reference_params,
                 processor: SocioProcessor, dataset: List[Dict],
                 reward_fn: Optional[Callable] = None,
                 engine_kwargs: Optional[Dict] = None):
        """dataset rows: {"question", "images" (one PIL image), "ground_truth"}.
        policy_params / reference_params as in RLVRPipeline."""
        super().__init__(pipeline_config)
        cfg = pipeline_config
        self.model_config = model_config
        self.processor = processor
        self.dataset = dataset
        self.reward_fn = reward_fn or compute_math_rewards

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
        self.collator = SocioSegCollator(processor, model_config,
                                         prompt_length=cfg.prompt_length,
                                         prompt_key="prompt", image_key="images",
                                         out_prefix="")
        self.kl_ctrl = get_kl_controller(cfg.init_kl_coef, cfg.target_kl, cfg.kl_horizon)
        cfg.set_max_steps(len(dataset))

    def run(self) -> Dict[str, float]:
        cfg = self.pipeline_config
        n = cfg.num_return_sequences
        mm = self.metrics
        step = self.state.step
        bs = cfg.rollout_batch_size
        last: Dict[str, float] = {}
        while step < cfg.max_steps:
            rows = self.dataset[(step * bs) % max(len(self.dataset), 1):][:bs]
            if not rows:
                break
            t0 = time.perf_counter()
            self.model_update(step)   # every model_update_frequency steps
            feats = [{"prompt": format_vlm_prompt(r["question"], len(r.get("images", []))),
                      "images": r.get("images", []),
                      "ground_truth": r.get("ground_truth", "")} for r in rows]
            batch = self.collator(feats)
            embeds = batch_image_embeds(self.model_config, self.param_store.get("rollout"),
                                        batch, image_config=self.processor.image_config)

            with mm.timer("generate"):
                gen_batch = BatchProto.from_dict(tensors={
                    "input_ids": batch.batch["input_ids"],
                    "attention_mask": batch.batch["attention_mask"],
                    "position_ids": batch.batch["position_ids"],
                }, meta={"image_embeds_list": embeds})
                seqs = self.actor_infer.generate(gen_batch, cfg.actor_infer.generating_args)
            post = fn.postprocess_generate(
                input_ids=np.asarray(batch.batch["input_ids"]),
                attention_mask=np.asarray(batch.batch["attention_mask"]),
                position_ids=np.asarray(batch.batch["position_ids"]),
                output=seqs, num_return_sequences=n,
                sequence_length=cfg.sequence_length,
                eos_token_id=self.model_config.eos_token_id,
                pad_token_id=self.model_config.pad_token_id)
            pad = self.model_config.pad_token_id
            texts = [strip_special_tokens(self.processor.decode(row[row != pad]))
                     for row in post["responses"]]
            gts = [f["ground_truth"] for f in feats for _ in range(n)]
            rewards_out = self.reward_fn(texts, gts)
            mm.add_metrics({f"critic/{k}": v
                            for k, v in rewards_out.get("metrics", {}).items()})

            train_batch = BatchProto.from_dict(tensors={
                "input_ids": post["input_ids"],
                "attention_mask": post["attention_mask"],
                "position_ids": post["position_ids"],
                "response_mask": post["response_mask"],
            })
            if embeds and embeds[0] is not None:
                # each sample's embeddings, on the device, repeated for its n
                train_batch.meta["image_embeds"] = torch.cat(
                    [e for e in embeds for _ in range(n)], dim=0)

            with mm.timer("logprobs"):
                old_lp = self.actor_train.compute_log_probs(train_batch)["log_probs"]
                ref_lp = self.reference.compute_log_probs(train_batch)["log_probs"]

            r = torch.as_tensor(rewards_out["response_level_rewards"].astype(np.float32))
            if cfg.adv_estimator == "grpo" and n > 1:
                r = fn.group_reward_norm(r, n, div_std=not cfg.reward_shift)
            if cfg.reward_clip:
                r = r.clamp(-cfg.reward_clip, cfg.reward_clip)
            response_mask = torch.as_tensor(train_batch.batch["response_mask"][:, 1:])
            tok, cur_kl = fn.apply_kl_penalty(
                r, torch.as_tensor(train_batch.batch["attention_mask"]),
                torch.as_tensor(train_batch.batch["position_ids"]), response_mask,
                torch.as_tensor(old_lp), torch.as_tensor(ref_lp),
                self.kl_ctrl.value, cfg.kl_penalty)
            self.kl_ctrl.update(float(cur_kl), len(texts))
            adv = fn.compute_advantage(
                tok, response_mask, adv_estimator=cfg.adv_estimator, gamma=cfg.gamma,
                lambd=cfg.lambd, advantage_clip=cfg.advantage_clip,
                whiten_advantages=cfg.whiten_advantages)
            train_batch.batch["advantages"] = adv["advantages"].numpy()
            train_batch.batch["old_log_probs"] = old_lp
            train_batch.batch["ref_log_probs"] = ref_lp
            with mm.timer("train"):
                metrics = self.actor_train.train_step(train_batch)
            metrics["critic/kl"] = float(cur_kl)
            mm.add_time("step", time.perf_counter() - t0)
            last = {**mm.reduce(), **metrics}
            self.log_metrics(last, step)
            self.do_checkpoint(step)
            step += 1
            self.state.step = step
        return last
