"""Reward workers the port runs in process.

The port's counterpart of SocioSegRuleRewardWorker from
socioreasoner_tpu/pipeline/base_worker.py without the cluster runtime: a
plain class whose `compute_rewards_split` scores a batch of two-stage
rollouts with the SocioSeg rule reward. SocioSegPipeline resolves a reward
`worker_cls` to it by class name and calls it over the whole batch.
"""

from __future__ import annotations

import numpy as np

from ..protocol import BatchProto
from .rlvr.rewards.socioseg import compute_socioseg_rewards


class SocioSegRuleRewardWorker:
    """CPU rule-reward worker."""

    def compute_rewards_split(self, data: BatchProto) -> BatchProto:
        """Per-sample reward arrays of `data` (non-tensors map_response_text,
        sat_response_text, map_mask, sat_mask, gt_mask, gt_bbox, bboxs_text):
        the response-level rewards, seg_iou and each component under
        components/, with their means in meta["metrics"]."""
        gt_masks = [np.asarray(m.convert("L")) if hasattr(m, "convert") else np.asarray(m)
                    for m in data.non_tensor["gt_mask"]]
        out = compute_socioseg_rewards(
            map_responses=[str(t) for t in data.non_tensor["map_response_text"]],
            sat_responses=[str(t) for t in data.non_tensor["sat_response_text"]],
            map_masks=list(data.non_tensor["map_mask"]),
            sat_masks=list(data.non_tensor["sat_mask"]),
            gt_masks=gt_masks,
            gt_bbox_texts=[str(t) for t in data.non_tensor["gt_bbox"]],
            stage1_bbox_texts=[str(t) for t in data.non_tensor["bboxs_text"]],
        )
        # the component arrays ride along so that a caller can compute the
        # means over a batch scored in pieces
        tensors = {k: v for k, v in out.items() if isinstance(v, np.ndarray)}
        return BatchProto.from_dict(tensors=tensors, meta={"metrics": out["metrics"]})
