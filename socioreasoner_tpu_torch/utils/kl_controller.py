"""KL coefficient controllers for the KL reward penalty.

The port's own copy of socioreasoner_tpu/utils/kl_controller.py, kept as it
is there: an adaptive controller (Ziegler et al. 2019) when a target KL is
set, a fixed coefficient otherwise.
"""

from __future__ import annotations

import numpy as np


class AdaptiveKLController:
    """Adaptive KL controller from Ziegler et al. 2019."""

    def __init__(self, init_kl_coef: float, target: float, horizon: float):
        self.value = init_kl_coef
        self.target = target
        self.horizon = horizon

    def update(self, current: float, n_steps: int):
        proportional_error = np.clip(current / self.target - 1, -0.2, 0.2)
        mult = 1 + proportional_error * n_steps / self.horizon
        self.value *= mult


class FixedKLController:
    """Constant KL coefficient."""

    def __init__(self, kl_coef: float):
        self.value = kl_coef

    def update(self, current: float, n_steps: int):
        pass


def get_kl_controller(init_kl_coef: float, target_kl: float | None = None,
                      kl_horizon: float = 10000):
    if target_kl is not None and target_kl > 0:
        return AdaptiveKLController(init_kl_coef, target_kl, kl_horizon)
    return FixedKLController(init_kl_coef)
