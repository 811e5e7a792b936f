"""SocioSeg rule rewards, for the port: numpy and scipy on the host.

The port's own copy of socioreasoner_tpu/pipeline/rlvr/rewards/socioseg.py,
formula for formula:

  stage 1 (map): format + count length + Hungarian box accuracy
  stage 2 (sat): format (boxes echo stage 1, points inside their box) +
                 points-per-box Gaussian length + mask-IoU accuracy

The Hungarian matching is scipy.optimize.linear_sum_assignment (the JAX
package's native host library computes the same assignment; the reward
reads only its total cost, which every optimal assignment shares), and
`mask_iou` is the numpy path of the JAX package's mask_iou_native.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..parsing import ANSWER_RE, THINK_ANSWER_RE, strip_special_tokens

MAX_OBJECTS = 120


# ------------------------------------------------------------------ geometry

def batch_iou(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise IoU with +1 pixel-inclusive convention (ref _batch_iou :16)."""
    ax1, ay1, ax2, ay2 = (boxes_a[:, i:i + 1] for i in range(4))
    bx1, by1, bx2, by2 = (boxes_b[:, i] for i in range(4))
    ix1 = np.maximum(ax1, bx1)
    iy1 = np.maximum(ay1, by1)
    ix2 = np.minimum(ax2, bx2)
    iy2 = np.minimum(ay2, by2)
    inter = np.maximum(0, ix2 - ix1 + 1) * np.maximum(0, iy2 - iy1 + 1)
    area_a = (ax2 - ax1 + 1) * (ay2 - ay1 + 1)
    area_b = (bx2 - bx1 + 1) * (by2 - by1 + 1)
    return inter / np.maximum(area_a + area_b - inter, 1e-6)


def batch_l1(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    return np.mean(np.abs(boxes_a[:, None, :] - boxes_b[None, :, :]), axis=2)


def mask_iou(mask: np.ndarray, gt_mask: np.ndarray, empty_value: float = 0.0) -> float:
    """Pixel IoU of mask > 0 and gt_mask > 0; both empty → `empty_value`
    (0.0 for rewards, 1.0 for the eval giou); 0.0 for a non-array or a
    shape mismatch."""
    if not isinstance(mask, np.ndarray) or not isinstance(gt_mask, np.ndarray):
        return 0.0
    if mask.shape != gt_mask.shape:
        return 0.0
    a, b = mask > 0, gt_mask > 0
    uni = np.logical_or(a, b).sum()
    return empty_value if uni == 0 else float(np.logical_and(a, b).sum() / uni)


# ------------------------------------------------------------ answer parsing

def _answer_json(text: str) -> Optional[list]:
    m = ANSWER_RE.search(text)
    if not m:
        return None
    try:
        data = json.loads(m.group(1).strip())
    except Exception:
        return None
    return data


def _gt_bboxes(ground_truth: str) -> Optional[np.ndarray]:
    try:
        data = json.loads(ground_truth.replace("'", '"'))
        return np.array([item["bbox_2d"] for item in data])
    except Exception:
        return None


# --------------------------------------------------------------- stage 1 (map)

def s1_format_reward(predict: str) -> float:
    """think/answer structure (1.0) + fraction of items that are exactly
    {'bbox_2d': [4 floats]} (ref :40-72)."""
    think = 1.0 if THINK_ANSWER_RE.fullmatch(predict) else 0.0
    data = _answer_json(predict)
    if not data:
        return think
    try:
        good = 0.0
        for item in data:
            if isinstance(item, dict) and set(item.keys()) == {"bbox_2d"}:
                bb = item["bbox_2d"]
                if isinstance(bb, list) and len(bb) == 4:
                    good += 1.0
        return think + good / len(data)
    except Exception:
        return think


def s1_length_reward(predict: str, ground_truth: str) -> float:
    """exp(-2|K-J|/J) count match (ref :209-234)."""
    gt = _gt_bboxes(ground_truth)
    if gt is None:
        return 0.0
    data = _answer_json(predict)
    if data is None:
        return 0.0
    try:
        pred_n = len([item["bbox_2d"] for item in data])
    except Exception:
        return 0.0
    J, K = len(gt), pred_n
    if J == 0:
        return 1.0 if K == 0 else 0.0
    return float(np.exp(-2 * abs(K - J) / J))


def s1_accuracy_reward(predict: str, ground_truth: str) -> float:
    """Hungarian over cost 2 − 1[IoU>0.5] − 1[L1<10], normalized by max count
    (ref :127-179)."""
    gt = _gt_bboxes(ground_truth)
    if gt is None:
        return 0.0
    data = _answer_json(predict)
    if not data:
        return 0.0
    try:
        pred = np.array([item["bbox_2d"] for item in data])
    except Exception:
        return 0.0
    pred, gt = pred[:MAX_OBJECTS], gt[:MAX_OBJECTS]
    if len(pred) == 0 or len(gt) == 0 or pred.ndim != 2 or pred.shape[1] != 4:
        return 0.0
    iou_hit = (batch_iou(pred, gt) > 0.5).astype(float)
    l1_hit = (batch_l1(pred, gt) < 10).astype(float)
    cost = 2.0 - iou_hit - l1_hit
    rows, cols = linear_sum_assignment(cost)
    total = len(rows) - cost[rows, cols].sum()
    return float(total / max(len(pred), len(gt)))


# --------------------------------------------------------------- stage 2 (sat)

def s2_format_reward(predict: str, stage1_bbox_text: str) -> float:
    """think/answer + per-item: bbox echoes stage-1 bbox, each point strictly
    inside its bbox, counts match stage-1 (ref :74-125)."""
    think = 1.0 if THINK_ANSWER_RE.fullmatch(predict) else 0.0
    data = _answer_json(predict)
    if not data:
        return think
    try:
        stage1 = json.loads(stage1_bbox_text.replace("'", '"'))
        if len(stage1) != len(data):
            return think
        good = 0.0
        for item, s1_item in zip(data, stage1):
            s1_box = s1_item["bbox_2d"]
            if not (isinstance(item, dict) and "bbox_2d" in item and "points" in item):
                continue
            box, pts = item["bbox_2d"], item["points"]
            if not (isinstance(box, list) and len(box) == 4 and isinstance(pts, list)):
                continue
            ok = box == s1_box
            for p in pts:
                if not (isinstance(p, list) and len(p) == 2):
                    ok = False
                    break
                if p[0] <= box[0] or p[0] >= box[2] or p[1] <= box[1] or p[1] >= box[3]:
                    ok = False
                    break
            if ok:
                good += 1.0
        return think + good / len(data)
    except Exception:
        return think


def s2_length_reward(predict: str) -> float:
    """Gaussian around 2 points per bbox, σ=2 (ref :236-256)."""
    data = _answer_json(predict)
    if not data:
        return 0.0
    try:
        total = 0.0
        for group in data:
            if not isinstance(group, dict) or "points" not in group:
                continue
            n = len(group["points"])
            total += math.exp(-((n - 2) ** 2) / 8.0)
        return total / len(data)
    except Exception:
        return 0.0


def s2_accuracy_reward(pred_mask: np.ndarray, gt_mask: np.ndarray) -> float:
    return mask_iou(pred_mask, gt_mask, empty_value=0.0)


# ------------------------------------------------------------------ batch API

def compute_socioseg_rewards(
    map_responses: Sequence[str],
    sat_responses: Sequence[str],
    map_masks: Sequence[np.ndarray],
    sat_masks: Sequence[np.ndarray],
    gt_masks: Sequence[np.ndarray],
    gt_bbox_texts: Sequence[str],
    stage1_bbox_texts: Sequence[str],
) -> Dict[str, np.ndarray]:
    """Full reward computation for one batch (ref compute_rewards_split :273-367).

    Returns per-sample arrays: map/sat component rewards, summed response-level
    rewards, and seg_iou (= sat accuracy) — plus mean metrics.
    """
    n = len(map_responses)
    out = {k: np.zeros(n, np.float32) for k in
           ("map_format", "map_length", "map_accuracy", "map_seg_iou",
            "sat_format", "sat_length", "sat_accuracy")}
    for i in range(n):
        mresp = strip_special_tokens(map_responses[i])
        sresp = strip_special_tokens(sat_responses[i])
        out["map_format"][i] = s1_format_reward(mresp)
        out["map_length"][i] = s1_length_reward(mresp, gt_bbox_texts[i])
        out["map_accuracy"][i] = s1_accuracy_reward(mresp, gt_bbox_texts[i])
        out["map_seg_iou"][i] = s2_accuracy_reward(map_masks[i], gt_masks[i])
        out["sat_format"][i] = s2_format_reward(sresp, stage1_bbox_texts[i])
        out["sat_length"][i] = s2_length_reward(sresp)
        out["sat_accuracy"][i] = s2_accuracy_reward(sat_masks[i], gt_masks[i])

    result = {
        "seg_iou_rewards": out["sat_accuracy"],
        "sat_response_level_rewards": out["sat_format"] + out["sat_length"] + out["sat_accuracy"],
        "map_response_level_rewards": out["map_format"] + out["map_length"] + out["map_accuracy"],
    }
    metrics = {f"{k}_reward_mean": float(v.mean()) for k, v in out.items()}
    return {**result, "metrics": metrics, **{f"components/{k}": v for k, v in out.items()}}
