"""SAM2 mask-decode strategy (the reference's seg_infer role).

The counterpart of socioreasoner_tpu/distributed/seg_strategy.py: per sample
the image is resized to 756×756 and encoded once, every parsed visual prompt
decoded, the best-scoring masks OR-ed into one 768×768 uint8 mask. All
prompts of a sub-batch decode in one decoder call
(Sam2Predictor.predict_objects_mask_batch), and the encoder outputs are
cached per source image: the two-stage pipeline segments the SAME tile in
stage 1 (bbox prompts) and stage 2 (bbox + point prompts), so stage 2 skips
the encoder.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from ..models.sam2.config import Sam2Config
from ..models.sam2.model import Sam2Predictor
from ..protocol import BatchProto
from .strategy import InferenceStrategy

SEG_INPUT_SIZE = (756, 756)    # ref seg_strategy.py:38
SEG_OUTPUT_SIZE = (768, 768)   # ref seg_strategy.py:43,65


class SegStrategy(InferenceStrategy):
    strategy_name = "seg_infer"

    def initialize(self, sam_config: Sam2Config, params):
        """Serve the SAM2 tree `params` on the device it lives on."""
        self.sam_config = sam_config
        self.predictor = Sam2Predictor(sam_config, params)
        # id(source image) → (weakref(source image), per-sample embeddings).
        # The weakref guards against id() reuse after the source is GC'd.
        self._embed_cache: "OrderedDict[int, Tuple]" = OrderedDict()

    def segment(self, batch: BatchProto) -> List[Dict[str, np.ndarray]]:
        """batch columns: seg_image (PIL), visual_prompt (list of per-object
        dicts with box/points/labels). Returns [{"mask": (768,768) uint8}].

        The image encoder runs once over every tile with prompts that misses
        the cache, the mask decoder once per sub-batch of tiles × objects."""
        n = len(batch)
        results: List[Optional[Dict[str, np.ndarray]]] = [None] * n
        to_run, sources, images, prompt_lists = [], [], [], []
        for i in range(n):
            prompts = batch.non_tensor["visual_prompt"][i]
            if prompts is None or len(prompts) == 0:
                results[i] = {"mask": np.zeros(SEG_OUTPUT_SIZE, np.uint8)}
                continue
            image = batch.non_tensor["seg_image"][i]
            if not isinstance(image, Image.Image):
                image = Image.fromarray(np.asarray(image))
            to_run.append(i)
            sources.append(image)
            images.append(image.resize(SEG_INPUT_SIZE))
            prompt_lists.append(list(prompts))
        if not to_run:
            return results

        embeds = self._resolve_embeddings(sources, images)
        mb = self._encode_batch()
        self.predictor._orig_size = (SEG_INPUT_SIZE[1], SEG_INPUT_SIZE[0])
        for start in range(0, len(to_run), mb):
            idx = to_run[start:start + mb]
            group = embeds[start:start + mb]
            emb = tuple(torch.cat([e[lvl] for e in group], dim=0)
                        for lvl in range(len(group[0])))
            masks = self.predictor.predict_objects_mask_batch(
                prompt_lists[start:start + mb], SEG_OUTPUT_SIZE, embeddings=emb)
            for i, m in zip(idx, masks):
                results[i] = {"mask": m}
        return results

    # -------------------------------------------------- encoder-output cache
    def _resolve_embeddings(self, sources: List, images: List) -> List[Tuple]:
        """Per-sample (s0, s1, low) embedding tuples, encoding cache misses in
        sub-batches of strategy_config.seg_encode_batch (default
        min(infer_batch_size, 8)): Hiera-large activations at 1024² scale
        with the batch, beside the resident decode weights."""
        cap = self._cache_capacity()
        out: List[Optional[Tuple]] = [None] * len(sources)
        miss = []
        for j, src in enumerate(sources):
            ent = self._embed_cache.get(id(src)) if cap else None
            if ent is not None and ent[0]() is src:
                self._embed_cache.move_to_end(id(src))
                out[j] = ent[1]
            else:
                miss.append(j)
        mb = self._encode_batch()
        for start in range(0, len(miss), mb):
            grp = miss[start:start + mb]
            self.predictor.set_images([images[j] for j in grp])
            batched = self.predictor._embeddings
            for k, j in enumerate(grp):
                emb = tuple(lvl[k:k + 1] for lvl in batched)
                out[j] = emb
                if cap:
                    key = id(sources[j])
                    self._embed_cache[key] = (weakref.ref(sources[j]), emb)
                    self._embed_cache.move_to_end(key)
        while len(self._embed_cache) > cap:
            self._embed_cache.popitem(last=False)
        return out

    def clear_embed_cache(self):
        self._embed_cache.clear()

    def _cache_capacity(self) -> int:
        v = self._strategy_config().get("seg_embed_cache")
        return 32 if v is None else int(v)   # 0 disables

    def _strategy_config(self) -> dict:
        wc = self.worker_config
        return (wc.strategy_args.config if wc is not None else {}) or {}

    def _encode_batch(self) -> int:
        sc = self._strategy_config()
        if sc.get("seg_encode_batch"):
            return int(sc["seg_encode_batch"])
        ibs = getattr(self.worker_config, "infer_batch_size", 0) or 8
        return min(int(ibs), 8)
