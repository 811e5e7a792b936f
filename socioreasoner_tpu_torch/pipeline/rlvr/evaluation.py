"""Evaluation scoring: the eval giou and its grouping by tile tag.

The port's own copy of `compute_giou` and `grouped_giou` from
socioreasoner_tpu/pipeline/rlvr/evaluation.py (the validation mIoU and the
zero-shot city-split grouping).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

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
