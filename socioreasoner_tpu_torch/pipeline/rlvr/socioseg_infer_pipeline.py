"""SocioSegInferPipeline — the two-stage recognize→reason→segment evaluation loop.

The counterpart of socioreasoner_tpu/pipeline/rlvr/socioseg_infer_pipeline.py
(the north-star API) on one GPU:

  per batch: stage-1 generate (map+sat tile pair → bboxes) → SAM2 stage-1
  masks → render bboxes+mask onto both images → stage-2 generate (point
  prompts) → SAM2 stage-2 masks → per-tile giou (both-empty → 1.0) → dump
  masks/renders/responses under output_dir/infer/result/{stage1,stage2,
  render1,render2} → mean giou_acc → iou_acc.txt.

One resident Qwen2.5-VL serves both stages (TorchDecodeStrategy, its engine
on the policy tree's device) and SegStrategy runs SAM2 on the SAM2 tree's
device; image embeddings are computed once per stage per sample. The default
path overlaps the host restage with device decode by streaming requests
through the decode server.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from ...configs.rlvr_config import SocioSegConfig
from ...configs.validation import validate_config
from ...datasets.collator import SocioSegCollator, collate_restage
from ...datasets.processor import SocioProcessor
from ...distributed.seg_strategy import SegStrategy
from ...distributed.strategy import ParamStore
from ...distributed.torch_strategies import batch_image_embeds
from ...generation.sampling import SamplingParams
from ...generation.server import GenerateRequestType as GRT
from ...models.qwen2_5_vl.config import Qwen25VLConfig
from ...models.sam2.config import Sam2Config
from ...protocol import BatchProto
from ...runtime.generate_scheduler import LocalGenerateGroup
from ..base_pipeline import BasePipeline
from .evaluation import compute_giou
from .parsing import parse_visual_prompts_s1, parse_visual_prompts_s2, strip_special_tokens
from .rewards.socioseg import mask_iou
from .socioseg_pipeline import _build_decode_replicas, _restage


def _gt_768(gt_mask) -> np.ndarray:
    gt = np.asarray(gt_mask.convert("L") if hasattr(gt_mask, "convert") else gt_mask)
    return np.asarray(Image.fromarray(gt).resize((768, 768), Image.Resampling.NEAREST))


class SocioSegInferPipeline(BasePipeline):
    def __init__(self, pipeline_config: SocioSegConfig, *,
                 model_config: Qwen25VLConfig, policy_params,
                 sam_config: Sam2Config, sam_params,
                 processor: SocioProcessor, dataset: List[Dict],
                 engine_kwargs: Optional[Dict] = None):
        """policy_params / sam_params: the port's trees, on the device each
        model is to run on (init_params and the weight bridges put them on
        the GPU unless a device is named)."""
        super().__init__(pipeline_config)
        validate_config(pipeline_config, n_devices=1)
        self.model_config = model_config
        self.processor = processor
        self.dataset = dataset

        self.param_store = ParamStore()
        self.param_store.put("rollout", policy_params)
        self.decode_replicas = _build_decode_replicas(
            pipeline_config, model_config, self.param_store, engine_kwargs)
        self.actor_infer = self.decode_replicas[0]
        self.decode_group = LocalGenerateGroup(self.decode_replicas)
        self.seg_infer = SegStrategy(worker_config=pipeline_config.seg_infer)
        self.seg_infer.initialize(sam_config, sam_params)

        self.collator = SocioSegCollator(processor, model_config,
                                         prompt_length=pipeline_config.prompt_length)
        self.result_dir = os.path.join(pipeline_config.output_dir, "infer", "result")

    # ---------------------------------------------------------------- eval API
    def evaluate_batch(self, rows) -> list:
        """Two-stage decode+segment over `rows`, returning per-tile giou
        (the validation entry; no artifact dumps)."""
        out = self._two_stage(rows)
        return [compute_giou(out["s2_masks"][i], _gt_768(row["gt_mask"]))
                for i, row in enumerate(rows)]

    def _two_stage(self, rows):
        """Two-stage decode+segment: overlapped with the host restage unless
        overlap_restage is off (or a single tile), else sequential."""
        if getattr(self.pipeline_config, "overlap_restage", True) and len(rows) > 1:
            return self._two_stage_overlapped(rows)
        return self._two_stage_sequential(rows)

    def _embeds(self, batch: BatchProto, prefix: str):
        return batch_image_embeds(self.model_config, self.param_store.get("rollout"),
                                  batch, prefix=prefix,
                                  image_config=self.processor.image_config)

    def _two_stage_sequential(self, rows):
        """Stage-1 generate → SAM → render restage → stage-2 generate → SAM."""
        cfg = self.pipeline_config
        batch = self.collator(rows)
        gen_batch = BatchProto.from_dict(tensors={
            "input_ids": batch.batch["map_input_ids"],
            "attention_mask": batch.batch["map_attention_mask"],
            "position_ids": batch.batch["map_position_ids"],
        }, meta={"image_embeds_list": self._embeds(batch, "map_")})
        seqs = self.decode_group.generate(gen_batch, cfg.actor_infer.generating_args)
        map_texts = self._decode_responses(seqs, batch.batch["map_input_ids"])
        s1_masks = self._segment(batch, map_texts, stage=1)
        s2_prompts, s2_images, bbox_texts = [], [], []
        for i, row in enumerate(rows):
            btxt, rendered, prompt = _restage(map_texts[i], row["question"],
                                              (row["image_map"], row["image_sat"]), s1_masks[i])
            bbox_texts.append(btxt)
            s2_images.append(rendered)
            s2_prompts.append(prompt)
        s2_batch = collate_restage(self.processor, self.model_config,
                                   s2_prompts, s2_images, cfg.prompt_length)
        gen2 = BatchProto.from_dict(tensors={
            "input_ids": s2_batch.batch["input_ids"],
            "attention_mask": s2_batch.batch["attention_mask"],
            "position_ids": s2_batch.batch["position_ids"],
        }, meta={"image_embeds_list": self._embeds(s2_batch, "")})
        seqs2 = self.decode_group.generate(gen2, cfg.actor_infer.generating_args)
        sat_texts = self._decode_responses(seqs2, s2_batch.batch["input_ids"])
        s2_masks = self._segment(batch, sat_texts, stage=2)
        return {"map_texts": map_texts, "sat_texts": sat_texts,
                "s1_masks": s1_masks, "s2_masks": s2_masks,
                "s2_images": s2_images, "bbox_texts": bbox_texts}

    # ------------------------------------------- overlapped two-stage pipeline
    def _two_stage_overlapped(self, rows, group_size: int = None):
        """Request-streaming two-stage loop.

        All stage-1 requests enter the decode server up front; as they
        finish, their host restage (parse → SAM s1 → render → re-tokenize →
        ViT embeds) runs in groups on this thread while the server's thread
        keeps decoding the remaining stage-1 slots, and each group's stage-2
        requests go straight into the waiting queue. Stage-2 SAM likewise
        consumes completions in groups while later tiles still decode."""
        cfg = self.pipeline_config
        n = len(rows)
        if group_size is None:
            # smaller groups start the host restage sooner, larger ones
            # batch SAM/ViT better
            group_size = (getattr(cfg, "restage_group_size", 0)
                          or max(2, min(8, n // 2)))
        batch = self.collator(rows)
        sp = SamplingParams.from_generating_args(cfg.actor_infer.generating_args)
        pad = self.model_config.pad_token_id

        map_texts: List = [None] * n
        sat_texts: List = [None] * n
        s1_masks: List = [None] * n
        s2_masks: List = [None] * n
        s2_images: List = [None] * n
        bbox_texts: List = [None] * n

        workers = self.decode_replicas
        loads = [0] * len(workers)
        s1_q: "queue.Queue" = queue.Queue()
        s2_q: "queue.Queue" = queue.Queue()

        for w in workers:
            w.start_server()
        try:
            # ---- submit every stage-1 request; the engine starts prefilling
            ids_all = np.asarray(batch.batch["map_input_ids"])
            attn_all = np.asarray(batch.batch["map_attention_mask"])
            pos_all = np.asarray(batch.batch["map_position_ids"])
            embeds = self._embeds(batch, "map_")
            for i in range(n):
                valid = attn_all[i] == 1
                w = int(np.argmin(loads))
                loads[w] += 1
                workers[w].add_request(GRT.ADD, {
                    "request_id": ("s1", i, w),
                    "prompt_ids": ids_all[i][valid].tolist(),
                    "sampling": sp,
                    "position_ids": pos_all[i][:, valid],
                    "image_embeds": embeds[i],
                    "callback": s1_q.put})

            # ---- phase A: restage stage-1 completions in groups while the
            # engine decodes the rest
            done = 0
            buf = []
            while done < n:
                out = s1_q.get()
                done += 1
                loads[out.request_id[2]] -= 1
                buf.append(out)
                if len(buf) >= group_size or done == n:
                    group, buf = buf, []
                    self._restage_group(group, rows, batch, sp, workers, loads, s2_q,
                                        map_texts, s1_masks, s2_images, bbox_texts)

            # ---- phase B: stage-2 SAM in groups while later tiles decode
            done = 0
            buf = []
            while done < n:
                out = s2_q.get()
                done += 1
                loads[out.request_id[2]] -= 1
                buf.append(out)
                if len(buf) >= group_size or done == n:
                    group, buf = buf, []
                    idxs = [o.request_id[1] for o in group]
                    for o in group:
                        resp = np.asarray(o.output_ids, np.int64)
                        sat_texts[o.request_id[1]] = strip_special_tokens(
                            self.processor.decode(resp[resp != pad]))
                    masks = self._segment_idxs(batch, idxs,
                                               [sat_texts[i] for i in idxs], stage=2)
                    for i, m in zip(idxs, masks):
                        s2_masks[i] = m
        finally:
            for w in workers:
                w.stop_server()

        return {"map_texts": map_texts, "sat_texts": sat_texts,
                "s1_masks": s1_masks, "s2_masks": s2_masks,
                "s2_images": s2_images, "bbox_texts": bbox_texts}

    def _restage_group(self, group, rows, batch, sp, workers, loads, s2_q,
                       map_texts, s1_masks, s2_images, bbox_texts):
        """One group's host restage: decode text → SAM s1 → render → stage-2
        prompts → re-tokenize → ViT embeds → submit stage-2 requests."""
        cfg = self.pipeline_config
        pad = self.model_config.pad_token_id
        idxs = [o.request_id[1] for o in group]
        for o in group:
            resp = np.asarray(o.output_ids, np.int64)
            map_texts[o.request_id[1]] = strip_special_tokens(
                self.processor.decode(resp[resp != pad]))
        masks = self._segment_idxs(batch, idxs, [map_texts[i] for i in idxs], stage=1)
        s2_prompts, imgs = [], []
        for i, m in zip(idxs, masks):
            s1_masks[i] = m
            bbox_texts[i], s2_images[i], prompt = _restage(
                map_texts[i], rows[i]["question"], (rows[i]["image_map"], rows[i]["image_sat"]),
                m)
            s2_prompts.append(prompt)
            imgs.append(s2_images[i])
        s2_batch = collate_restage(self.processor, self.model_config,
                                   s2_prompts, imgs, cfg.prompt_length)
        embeds2 = self._embeds(s2_batch, "")
        ids2 = np.asarray(s2_batch.batch["input_ids"])
        attn2 = np.asarray(s2_batch.batch["attention_mask"])
        pos2 = np.asarray(s2_batch.batch["position_ids"])
        for j, i in enumerate(idxs):
            valid = attn2[j] == 1
            w = int(np.argmin(loads))
            loads[w] += 1
            workers[w].add_request(GRT.ADD, {
                "request_id": ("s2", i, w),
                "prompt_ids": ids2[j][valid].tolist(),
                "sampling": sp,
                "position_ids": pos2[j][:, valid],
                "image_embeds": embeds2[j],
                "callback": s2_q.put})

    def _segment_idxs(self, batch: BatchProto, idxs: List[int],
                      texts: List[str], stage: int) -> List[np.ndarray]:
        """_segment over a subset of tiles (the overlapped path's group)."""
        parser = parse_visual_prompts_s1 if stage == 1 else parse_visual_prompts_s2
        prompts = np.empty(len(idxs), object)
        prompts[:] = [parser(t) for t in texts]
        images = np.empty(len(idxs), object)
        for j, i in enumerate(idxs):
            images[j] = batch.non_tensor["seg_image"][i]
        seg_batch = BatchProto.from_dict(non_tensors={
            "seg_image": images, "visual_prompt": prompts})
        return [r["mask"] for r in self.seg_infer.segment(seg_batch)]

    # ------------------------------------------------------------------- run
    def run(self) -> float:
        """Two-stage pass over the dataset in chunks of rollout_batch_size;
        4 PNGs and 2 texts a tile written by a writer thread, then
        iou_acc.txt. Returns the mean giou."""
        cfg = self.pipeline_config
        for sub in ("stage1", "stage2", "render1", "render2"):
            os.makedirs(os.path.join(self.result_dir, sub), exist_ok=True)
        gious: List[float] = []
        mm = self.metrics

        # result dumps run on a writer thread so the device starts the next
        # chunk's two-stage immediately; giou is computed inline to keep
        # `gious` ordered
        dump_q: "queue.Queue" = queue.Queue()
        dump_err: List[BaseException] = []

        def _writer():
            while True:
                job = dump_q.get()
                if job is None:
                    return
                try:
                    job()
                except Exception as e:  # noqa: BLE001 — raised after the join
                    dump_err.append(e)

        writer = threading.Thread(target=_writer, daemon=True)
        writer.start()

        def _dump_tile(tile, s1m, s2m, renders, mtxt, stxt):
            def job():
                Image.fromarray(s1m * 255).save(
                    os.path.join(self.result_dir, "stage1", f"{tile}.png"))
                Image.fromarray(s2m * 255).save(
                    os.path.join(self.result_dir, "stage2", f"{tile}.png"))
                renders[0].save(os.path.join(self.result_dir, "render1", f"{tile}.png"))
                renders[1].save(os.path.join(self.result_dir, "render2", f"{tile}.png"))
                with open(os.path.join(self.result_dir, "stage1", f"{tile}.txt"), "w") as f:
                    f.write(mtxt)
                with open(os.path.join(self.result_dir, "stage2", f"{tile}.txt"), "w") as f:
                    f.write(stxt)
            dump_q.put(job)

        bs = cfg.rollout_batch_size
        try:
            for start in range(0, len(self.dataset), bs):
                rows = self.dataset[start:start + bs]
                with mm.timer("two_stage"):
                    out = self._two_stage(rows)
                for i, row in enumerate(rows):
                    gious.append(mask_iou(out["s2_masks"][i], _gt_768(row["gt_mask"]) > 0,
                                          empty_value=1.0))
                    _dump_tile(str(row.get("id", start + i)), out["s1_masks"][i],
                               out["s2_masks"][i], out["s2_images"][i],
                               out["map_texts"][i], out["sat_texts"][i])
                self.log_metrics(mm.reduce(), start // bs)
        finally:
            dump_q.put(None)
            writer.join()
        if dump_err:
            raise dump_err[0]

        giou_acc = float(np.mean(gious)) if gious else 0.0
        with open(os.path.join(self.result_dir, "iou_acc.txt"), "w") as f:
            f.write(f"{giou_acc}\n")
        print(f"giou_acc: {giou_acc}")
        return giou_acc

    # ---------------------------------------------------------------- helpers
    def _decode_responses(self, seqs: np.ndarray, prompt_ids: np.ndarray) -> List[str]:
        """Full sequences → response text (strip prompt + pads)."""
        pad = self.model_config.pad_token_id
        texts = []
        prompt_lens = (np.asarray(prompt_ids) != pad).sum(-1)
        for i in range(len(seqs)):
            seq = seqs[i]
            valid = seq[seq != pad]
            resp = valid[int(prompt_lens[i]):]
            texts.append(strip_special_tokens(self.processor.decode(resp)))
        return texts

    def _segment(self, batch: BatchProto, texts: List[str], stage: int
                 ) -> List[np.ndarray]:
        """SegStrategy over every tile of `batch`: one encoder call over the
        tiles with prompts that miss the cache, one decoder call per
        sub-batch of tiles × objects."""
        return self._segment_idxs(batch, list(range(len(batch))), texts, stage)
