"""Pipeline configs: BaseConfig / RLVRConfig / SocioSegConfig.

The port's own copy of socioreasoner_tpu/configs/rlvr_config.py, kept as it
is there: field parity with the reference so its yamls port; `${var}`
strings the yaml loader keeps are resolved against the top-level values in
__post_init__.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

from .worker_config import WorkerConfig


def _resolve_interp(obj: Any, root: Dict[str, Any]):
    """Resolve '${key}' strings against top-level config values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            val = getattr(obj, f.name)
            setattr(obj, f.name, _resolve_interp(val, root))
        return obj
    if isinstance(obj, dict):
        return {k: _resolve_interp(v, root) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve_interp(v, root) for v in obj]
    if isinstance(obj, str) and obj.startswith("${") and obj.endswith("}"):
        key = obj[2:-1]
        return root.get(key, obj)
    return obj


@dataclass
class CheckpointConfig:
    type: str = "file_system"
    output_dir: Optional[str] = None
    keep_last_n: int = 3
    async_upload: bool = True
    extra_fields: Dict[str, Any] = field(default_factory=dict)


@dataclass
class BaseConfig:
    exp_name: str = "exp"
    seed: int = 42
    output_dir: str = "./output"
    logging_dir: str = "./output/logs"
    track_with: str = "stdout"              # tensorboard | stdout | file
    tracker_kwargs: Dict[str, Any] = field(default_factory=dict)
    pretrain: Optional[str] = None

    max_steps: int = -1
    save_steps: int = 100
    logging_steps: int = 1
    eval_steps: int = 100
    resume_from_checkpoint: Union[bool, str] = False

    rollout_batch_size: int = 8
    prompt_length: int = 4096
    sequence_length: int = 6144
    response_length: Optional[int] = None   # derived: sequence_length - prompt_length
    generate_opt_level: int = 0
    is_num_return_sequences_expand: bool = False
    num_return_sequences_in_group: int = 1

    rpc_timeout: float = 3600.0
    profiler_timeline: bool = False
    profiler_memory: bool = False
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    extra_fields: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.response_length is None:
            self.response_length = self.sequence_length - self.prompt_length
        else:
            self.sequence_length = self.prompt_length + int(self.response_length)


@dataclass
class RLVRConfig(BaseConfig):
    # GRPO/PPO hyperparameters (ref rlvr_config.py:80-240)
    ppo_epochs: int = 1
    gamma: float = 1.0
    lambd: float = 1.0
    pg_clip: float = 0.2
    value_clip: Optional[float] = None
    reward_clip: Optional[float] = None
    advantage_clip: Optional[float] = None
    dual_clip_loss: bool = False
    init_kl_coef: float = 0.0
    target_kl: Optional[float] = None
    kl_horizon: float = 10000
    kl_penalty: str = "kl"
    use_kl_loss: bool = True
    kl_loss_coef: float = 0.0
    entropy_loss_coef: float = 0.0
    loss_agg_mode: str = "seq-mean-token-sum"
    adv_estimator: str = "grpo"
    reward_norm: Optional[str] = None        # group | batch | running
    reward_shift: bool = False
    reward_scale: bool = False
    whiten_advantages: bool = False
    whiten_rewards: bool = False
    add_token_level_kl: bool = False
    max_len_mask: bool = False
    difficulty_mask: bool = False
    difficulty_low_threshold: float = 0.0
    difficulty_high_threshold: float = 1.0
    error_max_len_clip: bool = False
    error_max_len_threshold: int = 9999999

    # dynamic-sampling flow control (ref rlvr_config.py:104-114,
    # generate_scheduler.py:360-365)
    max_running_requests: int = 128
    is_use_additional_prompts: bool = False
    max_additional_running_prompts: int = 16
    alive_check_interval: float = 10.0

    # roles
    actor_train: WorkerConfig = field(default_factory=WorkerConfig)
    actor_infer: WorkerConfig = field(default_factory=WorkerConfig)
    reference: WorkerConfig = field(default_factory=WorkerConfig)
    critic: Optional[WorkerConfig] = None
    rewards: Dict[str, WorkerConfig] = field(default_factory=dict)
    validation: Optional[WorkerConfig] = None

    def __post_init__(self):
        super().__post_init__()
        root = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), (int, float, str, bool))}
        for role in (self.actor_train, self.actor_infer, self.reference,
                     self.critic, self.validation, *self.rewards.values()):
            if role is not None:
                _resolve_interp(role, root)

    @property
    def num_return_sequences(self) -> int:
        return max(self.num_return_sequences_in_group,
                   self.actor_infer.generating_args.num_return_sequences)

    def set_max_steps(self, dataset_len: int):
        """Derive per-worker optimizer steps (ref rlvr_config.py:284-309)."""
        if self.max_steps <= 0:
            epochs = self.actor_train.training_args.num_train_epochs
            steps_per_epoch = max(dataset_len // self.rollout_batch_size, 1)
            self.max_steps = int(epochs * steps_per_epoch)
        self.actor_train.training_args.max_steps = self.max_steps * self.ppo_epochs


@dataclass
class SocioSegConfig(RLVRConfig):
    """Adds the SAM2 seg-infer role (ref rlvr_config.py:315-326)."""
    seg_infer: WorkerConfig = field(default_factory=WorkerConfig)
    # Overlap the host restage (SAM → render → re-tokenize → ViT) with device
    # decode by streaming requests through the engine's waiting queue.
    # False = strictly sequential stages (parity/debug).
    overlap_restage: bool = True
    # Restage/segment group granularity for the overlapped path; 0 = derive
    # from batch size (max(2, min(8, n//2))). Smaller starts host work
    # sooner; larger batches SAM/ViT better.
    restage_group_size: int = 0
