"""SocioSegPipeline: GRPO training over the two-stage recognize→segment loop.

The port's counterpart of socioreasoner_tpu/pipeline/rlvr/socioseg_pipeline.py
on one GPU, step for step:

  2  model_update → rollout weights     8  reference log-probs (map + sat)
  3  stage-1 generate (n per prompt)    9  rule rewards (format/length/acc/IoU)
  4  SAM2 stage-1 masks                10  old log-probs (map + sat)
  5  host restage (render + retokenize) 11  reward clip → GRPO group norm →
  6  stage-2 generate (one a sample)        token rewards → advantage
  7  SAM2 stage-2 masks                12  train steps (map), train steps (sat)
                                       13  metrics / validation / checkpoint

Train, reference and decode share the GPU: TorchTrainStrategy updates the
policy in place, the reference policy (TorchInferStrategy) holds its own
copy of the weights, and model_update hands the trainer's tensors to the
decode engine through the ParamStore (a copy of them where a rollout must
see the weights of an update after later train steps). Image embeddings
stay tensors on the device from the ViT to the train steps.
"""

from __future__ import annotations

import copy
import json
import queue
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from PIL import Image

from ...configs.rlvr_config import SocioSegConfig
from ...configs.validation import validate_config
from ...datasets.collator import SocioSegCollator, collate_restage
from ...datasets.processor import SocioProcessor
from ...datasets.socioseg import format_stage2_prompt, render_visual_prompt
from ...distributed.seg_strategy import SegStrategy
from ...distributed.strategy import ParamStore
from ...distributed.torch_strategies import (TorchDecodeStrategy, TorchInferStrategy,
                                             TorchTrainStrategy, batch_image_embeds,
                                             copy_shared)
from ...generation.sampling import SamplingParams
from ...generation.server import GenerateRequestType as GRT
from ...models.qwen2_5_vl.config import Qwen25VLConfig
from ...models.sam2.config import Sam2Config
from ...pipeline.losses import PPOLossConfig
from ...protocol import BatchProto
from ...runtime.generate_scheduler import GenerateScheduler, LocalGenerateGroup
from ...utils import functionals as fn
from ...utils.kl_controller import get_kl_controller
from ..base_pipeline import BasePipeline
from ..base_worker import SocioSegRuleRewardWorker
from .evaluation import compute_giou, grouped_giou
from .parsing import (parse_bboxes, parse_visual_prompts_s1, parse_visual_prompts_s2,
                      strip_special_tokens)
from .rewards.socioseg import compute_socioseg_rewards


def _build_decode_replicas(cfg, model_config: Qwen25VLConfig, param_store: ParamStore,
                           engine_kwargs: Optional[Dict]) -> List[TorchDecodeStrategy]:
    """The actor_infer decode replica: one TorchDecodeStrategy serving the
    param store's "rollout" weights on their device. Data- and
    tensor-parallel decode (actor_infer dp_size / tensor_model_parallel_size
    > 1) wait for the multi-GPU slice."""
    sc = cfg.actor_infer.strategy_args.config
    dp = int(sc.get("dp_size", 1) or 1)
    tp = int(sc.get("tensor_model_parallel_size", 1) or 1)
    if dp > 1 or tp > 1:
        raise NotImplementedError(
            f"actor_infer dp_size={dp}, tensor_model_parallel_size={tp}: decode "
            "replicas over several GPUs are not ported yet (ROADMAP: multi-GPU)")
    s = TorchDecodeStrategy(worker_config=cfg.actor_infer, param_store=param_store)
    s.initialize(model_config, engine_kwargs=dict(engine_kwargs or {}))
    return [s]


def _restage(map_text: str, question, images, mask):
    """One sample's stage-2 inputs from its stage-1 answer: (the bbox text,
    the rendered map+sat pair, the stage-2 prompt)."""
    btxt = json.dumps([{"bbox_2d": b} for b in parse_bboxes(map_text)])
    return (btxt, render_visual_prompt(btxt, list(images), mask),
            format_stage2_prompt(str(question), btxt))


class SocioSegPipeline(BasePipeline):
    def __init__(self, pipeline_config: SocioSegConfig, *,
                 model_config: Qwen25VLConfig, policy_params, reference_params,
                 sam_config: Sam2Config, sam_params,
                 processor: SocioProcessor, dataset: List[Dict],
                 val_dataset: Optional[List[Dict]] = None,
                 engine_kwargs: Optional[Dict] = None):
        """policy_params / reference_params / sam_params: the port's trees on
        the device each model runs on. The trainer updates policy_params in
        place; the reference keeps its own copy of whatever it shares with
        them."""
        super().__init__(pipeline_config)
        cfg = pipeline_config
        validate_config(cfg, n_devices=1)
        self.model_config = model_config
        self.processor = processor
        self.dataset = dataset

        self.param_store = ParamStore()
        self.actor_train = TorchTrainStrategy(worker_config=cfg.actor_train,
                                              param_store=self.param_store)
        loss_cfg = PPOLossConfig(
            pg_clip=cfg.pg_clip, dual_clip_loss=cfg.dual_clip_loss,
            use_kl_loss=cfg.use_kl_loss, kl_loss_coef=cfg.kl_loss_coef,
            entropy_loss_coef=cfg.entropy_loss_coef,
            loss_agg_mode=cfg.loss_agg_mode)
        self.actor_train.initialize(model_config, policy_params, loss_cfg,
                                    cfg.actor_train.training_args)
        self.reference = TorchInferStrategy(worker_config=cfg.reference,
                                            param_store=self.param_store)
        self.reference.initialize(model_config, copy_shared(reference_params, policy_params))
        self.actor_train.model_update()
        self.decode_replicas = _build_decode_replicas(
            cfg, model_config, self.param_store, engine_kwargs)
        self.actor_infer = self.decode_replicas[0]
        # off-frequency steps skip the weight flow and the engine's
        # re-quantization
        for rep in self.decode_replicas:
            self.set_model_update_pair(
                self.actor_train, rep,
                frequency=max(1, cfg.actor_infer.model_update_frequency))
        self.seg_infer = SegStrategy(worker_config=cfg.seg_infer)
        self.seg_infer.initialize(sam_config, sam_params)
        # a reward worker the config names (by either package's dotted path)
        # scores in process over the whole batch; without one the rule
        # reward runs inline
        self.reward_worker = None
        for wc in (cfg.rewards or {}).values():
            if wc.worker_cls:
                if wc.worker_cls.rsplit(".", 1)[-1] != SocioSegRuleRewardWorker.__name__:
                    raise NotImplementedError(
                        f"reward worker_cls {wc.worker_cls!r} is not ported yet (ROADMAP "
                        "queue 1, item 4); the port has SocioSegRuleRewardWorker")
                self.reward_worker = SocioSegRuleRewardWorker()
                break

        self.collator = SocioSegCollator(processor, model_config,
                                         prompt_length=cfg.prompt_length)
        self.decode_group = LocalGenerateGroup(self.decode_replicas)
        self.generate_scheduler = GenerateScheduler(self.decode_group, cfg)
        self.kl_ctrl = get_kl_controller(cfg.init_kl_coef, cfg.target_kl, cfg.kl_horizon)
        self.val_dataset = val_dataset or []
        cfg.set_max_steps(len(dataset))

    # -------------------------------------------------------------------- run
    def _validates(self, step: int) -> bool:
        cfg = self.pipeline_config
        return bool(self.val_dataset) and cfg.eval_steps > 0 \
            and (step + 1) % cfg.eval_steps == 0

    def run(self) -> Dict[str, float]:
        cfg = self.pipeline_config
        n = cfg.num_return_sequences
        mm = self.metrics
        last_metrics: Dict[str, float] = {}
        step = self.state.step
        bs = cfg.rollout_batch_size

        while step < cfg.max_steps:
            start = (step * bs) % max(len(self.dataset), 1)
            rows = self.dataset[start:start + bs]
            if not rows:
                break
            t_step = time.perf_counter()

            # 2 ---- weight flow to the decode engine (every
            # model_update_frequency steps); validation after this step's
            # training reads the rollout weights too, so it takes a copy
            with mm.timer("model_update"):
                self.model_update(step, snapshot=self._validates(step))

            batch = self.collator(rows)
            rollout_params = self.param_store.get("rollout")

            # 3-7 ---- two-stage rollout: generate → SAM2 → restage →
            # generate → SAM2, overlapped with the host restage unless
            # overlap_restage is off
            t_ro = time.perf_counter()
            ro = self._rollout(rows, batch, rollout_params, mm)
            rollout_time = time.perf_counter() - t_ro
            map_post = fn.postprocess_generate(
                input_ids=np.asarray(batch.batch["map_input_ids"]),
                attention_mask=np.asarray(batch.batch["map_attention_mask"]),
                position_ids=np.asarray(batch.batch["map_position_ids"]),
                output=ro["seqs1"], num_return_sequences=n,
                sequence_length=cfg.sequence_length,
                eos_token_id=self.model_config.eos_token_id,
                pad_token_id=self.model_config.pad_token_id)
            expanded = batch.repeat(n)          # rows expanded to match samples
            sat_post = fn.postprocess_generate(
                input_ids=ro["s2_input_ids"],
                attention_mask=ro["s2_attention_mask"],
                position_ids=ro["s2_position_ids"],
                output=ro["seqs2"], num_return_sequences=1,
                sequence_length=cfg.sequence_length,
                eos_token_id=self.model_config.eos_token_id,
                pad_token_id=self.model_config.pad_token_id)
            # generated tokens over the whole two-stage rollout
            gen_tokens = int(np.asarray(map_post["response_mask"]).sum()
                             + np.asarray(sat_post["response_mask"]).sum())
            mm.add_token_throughput("actor_infer/", gen_tokens, rollout_time,
                                    dp_size=len(self.decode_replicas))

            map_train = self._train_batch(map_post, ro["embeds"], repeat=n)
            sat_train = self._train_batch(sat_post, ro["embeds2"], repeat=1)

            # 8/10 ---- reference and old log-probs
            with mm.timer("logprobs"):
                map_ref = self.reference.compute_log_probs(map_train)["log_probs"]
                sat_ref = self.reference.compute_log_probs(sat_train)["log_probs"]
                map_old = self.actor_train.compute_log_probs(map_train)["log_probs"]
                sat_old = self.actor_train.compute_log_probs(sat_train)["log_probs"]

            # 9 ---- rewards
            with mm.timer("rewards"):
                rewards = self._compute_rewards(expanded, ro["map_texts"], ro["sat_texts"],
                                                ro["map_masks"], ro["sat_masks"],
                                                ro["bbox_texts"])
            mm.add_metrics({f"critic/{k}": v for k, v in rewards["metrics"].items()})
            mm.add_metric("critic/seg_iou", float(rewards["seg_iou_rewards"].mean()))

            # 11/12 ---- advantages and train steps, stage by stage
            metrics_all: Dict[str, float] = {}
            total_tokens = int(np.asarray(map_train.batch["attention_mask"]).sum()
                               + np.asarray(sat_train.batch["attention_mask"]).sum())
            t_train = time.perf_counter()
            for name, train_batch, rw, old_lp, ref_lp in (
                    ("map", map_train, rewards["map_response_level_rewards"],
                     map_old, map_ref),
                    ("sat", sat_train, rewards["sat_response_level_rewards"],
                     sat_old, sat_ref)):
                m = self._train_stage(train_batch, rw, old_lp, ref_lp, n)
                metrics_all.update({f"{name}/{k}": v for k, v in m.items()})
            mm.add_token_throughput("actor_train/", total_tokens,
                                    time.perf_counter() - t_train)

            # 13 ---- metrics, validation, checkpoint
            step_time = time.perf_counter() - t_step
            mm.add_token_throughput("", total_tokens, step_time)
            mm.add_time("step", step_time)
            if self._validates(step):
                with mm.timer("validation"):
                    metrics_all.update(self._validate())
            last_metrics = {**mm.reduce(), **metrics_all}
            self.log_metrics(last_metrics, step)
            self.do_checkpoint(step)
            step += 1
            self.state.step = step
        return last_metrics

    # --------------------------------------------------------------- rollout
    def _rollout(self, rows, batch: BatchProto, rollout_params, mm) -> Dict:
        """Two-stage rollout producing everything downstream of step 7:
        full-sequence matrices (seqs1/seqs2, [left-padded prompt |
        right-padded response]), response texts, SAM2 masks, the stage-2
        prompt tensors and the per-sample image embeddings."""
        cfg = self.pipeline_config
        if (getattr(cfg, "overlap_restage", True)
                and len(rows) * cfg.num_return_sequences > 1):
            with mm.timer("rollout"):
                return self._rollout_overlapped(rows, batch, rollout_params)
        return self._rollout_sequential(rows, batch, rollout_params, mm)

    def _embeds(self, rollout_params, batch: BatchProto, prefix: str):
        return batch_image_embeds(self.model_config, rollout_params, batch, prefix=prefix,
                                  image_config=self.processor.image_config)

    def _rollout_sequential(self, rows, batch, rollout_params, mm) -> Dict:
        """The reference step order: each stage generated, then segmented."""
        cfg = self.pipeline_config
        n = cfg.num_return_sequences
        with mm.timer("generate_s1"):
            embeds = self._embeds(rollout_params, batch, "map_")
            gen_batch = BatchProto.from_dict(tensors={
                "input_ids": batch.batch["map_input_ids"],
                "attention_mask": batch.batch["map_attention_mask"],
                "position_ids": batch.batch["map_position_ids"],
            }, meta={"image_embeds_list": embeds,
                     "pad_token_id": self.model_config.pad_token_id})
            ga = cfg.actor_infer.generating_args
            if cfg.generate_opt_level >= 1:
                # request-level streaming, abort-on-complete per prompt
                out = self.generate_scheduler.generate_requests(gen_batch, ga)
                seqs1 = np.asarray(out.batch["output"])
            else:
                seqs1 = self.decode_group.generate(gen_batch, ga)
        ids1 = np.asarray(batch.batch["map_input_ids"])
        map_texts = self._texts_from_seqs(seqs1, np.repeat(ids1, n, axis=0))
        expanded = batch.repeat(n)

        with mm.timer("segment_s1"):
            map_masks = self._segment(expanded, map_texts, stage=1)

        with mm.timer("restage"):
            s2_prompts, s2_images, bbox_texts = [], [], []
            for i in range(len(expanded)):
                btxt, rendered, prompt = _restage(
                    map_texts[i], expanded.non_tensor["question"][i],
                    (expanded.non_tensor["image_map"][i],
                     expanded.non_tensor["image_sat"][i]), map_masks[i])
                bbox_texts.append(btxt)
                s2_images.append(rendered)
                s2_prompts.append(prompt)
            s2_batch = collate_restage(self.processor, self.model_config,
                                       s2_prompts, s2_images, cfg.prompt_length)

        with mm.timer("generate_s2"):
            embeds2 = self._embeds(rollout_params, s2_batch, "")
            gen2 = BatchProto.from_dict(tensors={
                "input_ids": s2_batch.batch["input_ids"],
                "attention_mask": s2_batch.batch["attention_mask"],
                "position_ids": s2_batch.batch["position_ids"],
            }, meta={"image_embeds_list": embeds2})
            ga_one = copy.copy(cfg.actor_infer.generating_args)
            ga_one.num_return_sequences = 1
            seqs2 = self.decode_group.generate(gen2, ga_one)
        s2_ids = np.asarray(s2_batch.batch["input_ids"])
        sat_texts = self._texts_from_seqs(seqs2, s2_ids)

        with mm.timer("segment_s2"):
            sat_masks = self._segment(expanded, sat_texts, stage=2)

        return dict(seqs1=seqs1, seqs2=seqs2, embeds=embeds, embeds2=embeds2,
                    map_texts=map_texts, sat_texts=sat_texts,
                    map_masks=map_masks, sat_masks=sat_masks,
                    bbox_texts=bbox_texts, s2_input_ids=s2_ids,
                    s2_attention_mask=np.asarray(s2_batch.batch["attention_mask"]),
                    s2_position_ids=np.asarray(s2_batch.batch["position_ids"]))

    def _rollout_overlapped(self, rows, batch, rollout_params,
                            group_size: int = None, n: int = None,
                            ga=None) -> Dict:
        """Request-streaming rollout: the host restage of finished samples
        (decode text → SAM2 stage 1 → render → re-tokenize → ViT) runs on
        this thread while the server's thread decodes the others, and the
        stage-2 requests join the server's queue as each group is ready."""
        cfg = self.pipeline_config
        if n is None:
            n = cfg.num_return_sequences
        B = len(rows)
        N = B * n
        if group_size is None:
            group_size = (getattr(cfg, "restage_group_size", 0)
                          or max(2, min(8, N // 2)))
        if ga is None:
            ga = cfg.actor_infer.generating_args
        sp = SamplingParams.from_generating_args(ga)
        pad = self.model_config.pad_token_id

        ids1 = np.asarray(batch.batch["map_input_ids"])
        attn1 = np.asarray(batch.batch["map_attention_mask"])
        pos1 = np.asarray(batch.batch["map_position_ids"])
        P1 = ids1.shape[1]
        P2 = cfg.prompt_length

        map_texts = [None] * N
        sat_texts = [None] * N
        map_masks = [None] * N
        sat_masks = [None] * N
        bbox_texts = [None] * N
        out1 = [[] for _ in range(N)]
        out2 = [[] for _ in range(N)]
        s2_ids = np.full((N, P2), pad, ids1.dtype)
        s2_attn = np.zeros((N, P2), attn1.dtype)
        s2_pos = np.zeros((N, 3, P2), pos1.dtype)
        embeds2 = [None] * N

        workers = self.decode_replicas
        loads = [0] * len(workers)
        s1_q: "queue.Queue" = queue.Queue()
        s2_q: "queue.Queue" = queue.Queue()
        state = dict(sp=sp, loads=loads, s2_q=s2_q, n=n,
                     map_texts=map_texts, map_masks=map_masks,
                     bbox_texts=bbox_texts, s2_ids=s2_ids, s2_attn=s2_attn,
                     s2_pos=s2_pos, embeds2=embeds2, out1=out1)

        for w in workers:
            w.start_server()
        try:
            embeds = self._embeds(rollout_params, batch, "map_")
            for i in range(B):
                valid = attn1[i] == 1
                # all n siblings of a prompt to one worker: its prefix fork
                # prefills the shared prompt once
                w = int(np.argmin(loads))
                loads[w] += n
                for j in range(n):
                    k = i * n + j
                    workers[w].add_request(GRT.ADD, {
                        "request_id": ("s1", k, w),
                        "prompt_ids": ids1[i][valid].tolist(),
                        "sampling": sp,
                        "position_ids": pos1[i][:, valid],
                        "image_embeds": embeds[i],
                        "callback": s1_q.put})

            done, buf = 0, []
            while done < N:
                o = s1_q.get()
                done += 1
                loads[o.request_id[2]] -= 1
                buf.append(o)
                if len(buf) >= group_size or done == N:
                    group, buf = buf, []
                    self._train_restage_group(group, batch, rollout_params,
                                              workers, state)

            done, buf = 0, []
            while done < N:
                o = s2_q.get()
                done += 1
                loads[o.request_id[2]] -= 1
                buf.append(o)
                if len(buf) >= group_size or done == N:
                    group, buf = buf, []
                    idxs = [o.request_id[1] for o in group]
                    for o in group:
                        k = o.request_id[1]
                        out2[k] = list(o.output_ids)
                        resp = np.asarray(o.output_ids, np.int64)
                        sat_texts[k] = strip_special_tokens(
                            self.processor.decode(resp[resp != pad]))
                    masks = self._segment_group(batch, idxs,
                                                [sat_texts[k] for k in idxs],
                                                n, stage=2)
                    for k, m in zip(idxs, masks):
                        sat_masks[k] = m
        finally:
            for w in workers:
                w.stop_server()

        # [left-padded prompt | right-padded response] full-sequence matrices
        # (the decode strategies' layout contract with postprocess_generate)
        W1 = P1 + max([len(o) for o in out1] + [1])
        seqs1 = np.full((N, W1), pad, np.int64)
        W2 = P2 + max([len(o) for o in out2] + [1])
        seqs2 = np.full((N, W2), pad, np.int64)
        for k in range(N):
            seqs1[k, :P1] = ids1[k // n]
            seqs1[k, P1:P1 + len(out1[k])] = out1[k]
            seqs2[k, :P2] = s2_ids[k]
            seqs2[k, P2:P2 + len(out2[k])] = out2[k]
        return dict(seqs1=seqs1, seqs2=seqs2, embeds=embeds, embeds2=embeds2,
                    map_texts=map_texts, sat_texts=sat_texts,
                    map_masks=map_masks, sat_masks=sat_masks,
                    bbox_texts=bbox_texts, s2_input_ids=s2_ids,
                    s2_attention_mask=s2_attn, s2_position_ids=s2_pos)

    def _train_restage_group(self, group, batch, rollout_params, workers, st: Dict):
        """One group's host restage: decode text → SAM2 stage 1 → render →
        stage-2 prompts → re-tokenize → ViT embeddings → submit the stage-2
        requests."""
        cfg = self.pipeline_config
        n = st["n"]
        pad = self.model_config.pad_token_id
        idxs = [o.request_id[1] for o in group]
        for o in group:
            k = o.request_id[1]
            st["out1"][k] = list(o.output_ids)
            resp = np.asarray(o.output_ids, np.int64)
            st["map_texts"][k] = strip_special_tokens(
                self.processor.decode(resp[resp != pad]))
        masks = self._segment_group(batch, idxs, [st["map_texts"][k] for k in idxs],
                                    n, stage=1)
        s2_prompts, imgs = [], []
        for k, m in zip(idxs, masks):
            st["map_masks"][k] = m
            i = k // n
            btxt, rendered, prompt = _restage(
                st["map_texts"][k], batch.non_tensor["question"][i],
                (batch.non_tensor["image_map"][i], batch.non_tensor["image_sat"][i]), m)
            st["bbox_texts"][k] = btxt
            s2_prompts.append(prompt)
            imgs.append(rendered)
        s2_batch = collate_restage(self.processor, self.model_config,
                                   s2_prompts, imgs, cfg.prompt_length)
        em2 = self._embeds(rollout_params, s2_batch, "")
        gids = np.asarray(s2_batch.batch["input_ids"])
        gattn = np.asarray(s2_batch.batch["attention_mask"])
        gpos = np.asarray(s2_batch.batch["position_ids"])
        loads = st["loads"]
        for j, k in enumerate(idxs):
            st["s2_ids"][k] = gids[j]
            st["s2_attn"][k] = gattn[j]
            st["s2_pos"][k] = gpos[j]
            st["embeds2"][k] = em2[j]
            valid = gattn[j] == 1
            w = int(np.argmin(loads))
            loads[w] += 1
            workers[w].add_request(GRT.ADD, {
                "request_id": ("s2", k, w),
                "prompt_ids": gids[j][valid].tolist(),
                "sampling": st["sp"],
                "position_ids": gpos[j][:, valid],
                "image_embeds": em2[j],
                "callback": st["s2_q"].put})

    def _segment_group(self, batch: BatchProto, idxs: List[int], texts: List[str],
                       n: int, stage: int) -> List[np.ndarray]:
        """_segment over a subset of expanded sample indices (k // n is the
        tile's row)."""
        parser = parse_visual_prompts_s1 if stage == 1 else parse_visual_prompts_s2
        prompts = np.empty(len(idxs), object)
        prompts[:] = [parser(t) for t in texts]
        images = np.empty(len(idxs), object)
        for j, k in enumerate(idxs):
            images[j] = batch.non_tensor["seg_image"][k // n]
        seg_batch = BatchProto.from_dict(non_tensors={
            "seg_image": images, "visual_prompt": prompts})
        return [r["mask"] for r in self.seg_infer.segment(seg_batch)]

    def _texts_from_seqs(self, seqs: np.ndarray, prompt_ids: np.ndarray) -> List[str]:
        """[left-padded prompt | response] rows → response texts."""
        pad = self.model_config.pad_token_id
        prompt_lens = (np.asarray(prompt_ids) != pad).sum(-1)
        texts = []
        for i in range(len(seqs)):
            valid = seqs[i][seqs[i] != pad]
            texts.append(strip_special_tokens(
                self.processor.decode(valid[int(prompt_lens[i]):])))
        return texts

    # ------------------------------------------------------------- validation
    def _validate(self, max_tiles: Optional[int] = None) -> Dict[str, float]:
        """Greedy two-stage evaluation of the validation split, one sample a
        tile: val_iou/* overall and per tile tag."""
        cfg = self.pipeline_config
        rows_all = self.val_dataset[:max_tiles] if max_tiles else self.val_dataset
        ga = copy.copy(cfg.actor_infer.generating_args)
        ga.num_return_sequences = 1
        ga.do_sample = False
        ga.temperature = 0.0
        gious, tags = [], []
        bs = cfg.rollout_batch_size
        for start in range(0, len(rows_all), bs):
            rows = rows_all[start:start + bs]
            batch = self.collator(rows)
            rollout = self.param_store.get("rollout")
            ro = self._rollout_overlapped(rows, batch, rollout, n=1, ga=ga)
            for i, row in enumerate(rows):
                gt = np.asarray(row["gt_mask"].convert("L")
                                if hasattr(row["gt_mask"], "convert") else row["gt_mask"])
                gt = np.asarray(Image.fromarray(gt).resize(
                    (768, 768), Image.Resampling.NEAREST))
                gious.append(compute_giou(ro["sat_masks"][i], gt))
                tags.append(str(row.get("tag", "")))
        return grouped_giou(gious, tags)

    # ---------------------------------------------------------------- rewards
    def _compute_rewards(self, expanded: BatchProto, map_texts, sat_texts,
                         map_masks, sat_masks, bbox_texts) -> Dict:
        """Rule rewards: through the config's reward worker when it names one
        (over the whole batch, the means recomputed from its component
        arrays), inline otherwise."""
        if self.reward_worker is None:
            gt_masks = [np.asarray(m.convert("L")) if hasattr(m, "convert")
                        else np.asarray(m) for m in expanded.non_tensor["gt_mask"]]
            return compute_socioseg_rewards(
                map_responses=map_texts, sat_responses=sat_texts,
                map_masks=map_masks, sat_masks=sat_masks, gt_masks=gt_masks,
                gt_bbox_texts=[str(t) for t in expanded.non_tensor["gt_bbox"]],
                stage1_bbox_texts=bbox_texts)
        data = BatchProto.from_dict(non_tensors={
            "map_response_text": list(map_texts),
            "sat_response_text": list(sat_texts),
            "map_mask": list(map_masks), "sat_mask": list(sat_masks),
            "gt_mask": list(expanded.non_tensor["gt_mask"]),
            "gt_bbox": [str(t) for t in expanded.non_tensor["gt_bbox"]],
            "bboxs_text": list(bbox_texts)})
        out = self.reward_worker.compute_rewards_split(data)
        rewards = {k: np.asarray(v) for k, v in out.batch.items()
                   if not k.startswith("components/")}
        rewards["metrics"] = {
            f"{k.split('/', 1)[1]}_reward_mean": float(np.mean(v))
            for k, v in out.batch.items() if k.startswith("components/")}
        return rewards

    # ----------------------------------------------------------------- stages
    def _train_stage(self, train_batch: BatchProto, response_rewards: np.ndarray,
                     old_log_probs: np.ndarray, ref_log_probs: np.ndarray,
                     n_sample: int) -> Dict[str, float]:
        cfg = self.pipeline_config
        rewards = torch.as_tensor(response_rewards.astype(np.float32))
        if cfg.adv_estimator == "grpo" and n_sample > 1:
            rewards = fn.group_reward_norm(rewards, n_sample, div_std=not cfg.reward_shift)
        if cfg.reward_clip:
            rewards = rewards.clamp(-cfg.reward_clip, cfg.reward_clip)
        response_mask = torch.as_tensor(train_batch.batch["response_mask"][:, 1:])
        token_rewards, current_kl = fn.apply_kl_penalty(
            rewards, torch.as_tensor(train_batch.batch["attention_mask"]),
            torch.as_tensor(train_batch.batch["position_ids"]), response_mask,
            torch.as_tensor(old_log_probs), torch.as_tensor(ref_log_probs),
            self.kl_ctrl.value, cfg.kl_penalty)
        self.kl_ctrl.update(float(current_kl), len(train_batch))
        adv = fn.compute_advantage(
            token_rewards, response_mask,
            adv_estimator=cfg.adv_estimator, gamma=cfg.gamma, lambd=cfg.lambd,
            advantage_clip=cfg.advantage_clip,
            whiten_advantages=cfg.whiten_advantages,
            whiten_rewards=cfg.whiten_rewards)
        train_batch.batch["advantages"] = adv["advantages"].numpy()
        train_batch.batch["old_log_probs"] = np.asarray(old_log_probs)
        train_batch.batch["ref_log_probs"] = np.asarray(ref_log_probs)
        metrics = self._train_minibatched(train_batch)
        metrics["critic/kl"] = float(current_kl)
        metrics["critic/reward_mean"] = float(np.mean(response_rewards))
        return metrics

    def _train_minibatched(self, train_batch: BatchProto) -> Dict[str, float]:
        """backward_batch_size sequences per optimizer apply, each split into
        gradient_accumulation_steps micro-batches (the strategy's optimizer
        applies the averaged gradient every K calls), ppo_epochs passes over
        the rollout batch."""
        cfg = self.pipeline_config
        n = len(train_batch)
        bbs = cfg.actor_train.backward_batch_size
        if bbs is None or bbs <= 0:
            bbs = n
        ga = getattr(self.actor_train, "grad_accum_steps", 1)
        micro = max(1, bbs // ga)
        img = train_batch.meta.get("image_embeds")
        per = None if img is None else img.shape[0] // max(n, 1)
        agg: Dict[str, List[float]] = {}
        for _ in range(max(1, cfg.ppo_epochs)):
            for start in range(0, n, micro):
                mini = train_batch.slice(start, start + micro)
                mini.meta = dict(mini.meta)
                if img is not None:
                    mini.meta["image_embeds"] = img[start * per:(start + len(mini)) * per]
                m = self.actor_train.train_step(mini)
                for k, v in m.items():
                    agg.setdefault(k, []).append(v)
        return {k: float(np.mean(v)) for k, v in agg.items()}

    def _train_batch(self, post: Dict[str, np.ndarray], embeds_list: List,
                     repeat: int) -> BatchProto:
        """Postprocessed sequences and the packed image embeddings (on their
        device, each sample's repeated `repeat` times) → a train batch."""
        batch = BatchProto.from_dict(tensors={
            "input_ids": post["input_ids"],
            "attention_mask": post["attention_mask"],
            "position_ids": post["position_ids"],
            "response_mask": post["response_mask"],
        })
        if embeds_list and embeds_list[0] is not None:
            batch.meta["image_embeds"] = torch.cat(
                [e for e in embeds_list for _ in range(repeat)], dim=0)
        return batch

    def _segment(self, expanded: BatchProto, texts: List[str], stage: int
                 ) -> List[np.ndarray]:
        """Visual prompts parsed from the responses → masks through the
        batched SegStrategy path (one encoder call over the tiles that miss
        its cache, one decoder call a sub-batch of tiles × objects)."""
        return self._segment_group(expanded, list(range(len(expanded))), texts, 1, stage)
