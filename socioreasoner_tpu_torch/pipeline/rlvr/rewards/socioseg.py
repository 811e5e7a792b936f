"""SocioSeg mask IoU, for the port.

The port's own copy of `mask_iou` from
socioreasoner_tpu/pipeline/rlvr/rewards/socioseg.py, with the numpy path of
socioreasoner_tpu/utils/native.mask_iou_native (the JAX package's native
host library computes the same counts). The rule rewards and the Hungarian
matching join it with the train pipeline's slice.
"""

from __future__ import annotations

import numpy as np


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
