"""Evaluation: the eval giou and its grouping by tile tag, validation
through a pipeline, and batch statistics.

The port's own copy of socioreasoner_tpu/pipeline/rlvr/evaluation.py (the
validation mIoU, the zero-shot city-split grouping, run_validation and
compute_data_metrics).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .rewards.socioseg import mask_iou


def compute_giou(pred_mask: np.ndarray, gt_mask: np.ndarray) -> float:
    """Eval-convention IoU: both-empty → 1.0."""
    return mask_iou(np.asarray(pred_mask), np.asarray(gt_mask) > 0,
                    empty_value=1.0)


def grouped_giou(gious: Sequence[float], tags: Sequence[str],
                 prefix: str = "val_iou") -> Dict[str, float]:
    """Mean giou overall + per tag (city / hierarchy level)."""
    out = {f"{prefix}/mean": float(np.mean(gious)) if len(gious) else 0.0}
    by_tag: Dict[str, List[float]] = defaultdict(list)
    for g, t in zip(gious, tags):
        if t:
            by_tag[str(t)].append(g)
    for tag, vals in sorted(by_tag.items()):
        out[f"{prefix}/{tag}"] = float(np.mean(vals))
        out[f"{prefix}/{tag}/count"] = float(len(vals))
    return out


def run_validation(pipeline, rows: List[Dict], max_tiles: Optional[int] = None
                   ) -> Dict[str, float]:
    """Two-stage eval of `rows` through a pipeline that scores a batch of
    rows with `evaluate_batch(rows) -> gious`, rollout_batch_size rows at a
    time; returns val_iou metrics (overall and per tag)."""
    rows = rows[:max_tiles] if max_tiles else rows
    gious, tags = [], []
    batch_size = pipeline.pipeline_config.rollout_batch_size
    for start in range(0, len(rows), batch_size):
        chunk = rows[start:start + batch_size]
        gious.extend(pipeline.evaluate_batch(chunk))
        tags.extend(str(r.get("tag", "")) for r in chunk)
    return grouped_giou(gious, tags)


def compute_data_metrics(post: Dict[str, np.ndarray], rewards: np.ndarray,
                         advantages: Optional[np.ndarray] = None,
                         prefix: str = "") -> Dict[str, float]:
    """Batch statistics of postprocessed sequences: response and prompt
    lengths, token count, reward and (over the response tokens) advantage
    mean/max/min."""
    resp_mask = np.asarray(post["response_mask"])
    attn = np.asarray(post["attention_mask"])
    resp_len = resp_mask.sum(-1).astype(np.float64)
    prompt_len = (attn - resp_mask).sum(-1).astype(np.float64)
    out = {
        f"{prefix}tokens/response_length/mean": float(resp_len.mean()),
        f"{prefix}tokens/response_length/max": float(resp_len.max()),
        f"{prefix}tokens/response_length/min": float(resp_len.min()),
        f"{prefix}tokens/prompt_length/mean": float(prompt_len.mean()),
        f"{prefix}tokens/total": float(attn.sum()),
        f"{prefix}critic/score/mean": float(np.mean(rewards)),
        f"{prefix}critic/score/max": float(np.max(rewards)),
        f"{prefix}critic/score/min": float(np.min(rewards)),
    }
    if advantages is not None:
        adv = np.asarray(advantages)
        m = resp_mask[:, 1:] > 0
        vals = adv[m] if m.any() else np.zeros(1)
        out[f"{prefix}critic/advantages/mean"] = float(vals.mean())
        out[f"{prefix}critic/advantages/max"] = float(vals.max())
        out[f"{prefix}critic/advantages/min"] = float(vals.min())
    return out
