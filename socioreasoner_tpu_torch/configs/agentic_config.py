"""Agentic RL configs.

The port's own copy of socioreasoner_tpu/configs/agentic_config.py, kept as
it is there. `EnvManagerConfig` groups environments: every env of a group
shares its config and seed (so GRPO can normalise returns within the
group); `AgenticConfig` adds the env managers and the reward normalisation
to the RL hyperparameters RLVRConfig already carries. configs/loader.py's
load_config reads it from a yaml, nested dataclasses included.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .rlvr_config import RLVRConfig
from .worker_config import WorkerConfig


@dataclass
class RewardNormalizationConfig:
    grouping: str = "state"        # state / batch / inductive / tags
    method: str = "identity"       # mean_std / mean / asym_clip / identity


@dataclass
class EnvManagerConfig(WorkerConfig):
    """The environment fleet: env_groups groups x group_size envs; envs of one
    group share their env config and their seed."""
    env_groups: int = 8
    group_size: int = 1
    tags: List[str] = field(default_factory=lambda: ["grid_goal"])
    n_groups: Optional[List[int]] = None
    max_traj_per_env: int = -1
    format_penalty: float = 0.0
    max_env_num_per_worker: int = 0

    def __post_init__(self):
        if self.max_env_num_per_worker <= 0:
            self.max_env_num_per_worker = self.env_groups * self.group_size

    @property
    def total_envs(self) -> int:
        return self.env_groups * self.group_size


@dataclass
class AgenticConfig(RLVRConfig):
    """The env managers and the agentic knobs; the RL hyperparameters
    (pg_clip, kl, the advantage estimator, reward_clip, gamma/lambd ...) come
    from RLVRConfig."""
    custom_envs: Dict[str, Any] = field(default_factory=dict)
    train_env_manager: EnvManagerConfig = field(default_factory=EnvManagerConfig)
    val_env_manager: EnvManagerConfig = field(
        default_factory=lambda: EnvManagerConfig(env_groups=2))
    enable_response_mask: bool = True
    render_save_dir: Optional[str] = None
    action_sep: str = "||"
    use_turn_scores: bool = False
    enable_think: bool = True
    reward_normalization: RewardNormalizationConfig = field(
        default_factory=RewardNormalizationConfig)
    max_steps_per_traj: int = 10
    val_batch_size: int = 4
