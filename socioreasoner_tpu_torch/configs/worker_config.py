"""Per-role worker configuration (field parity with the reference's
`roll/configs/worker_config.py:13-29` so its yamls port directly).

The port's own copy of socioreasoner_tpu/configs/worker_config.py, kept as
it is there (host-only code: the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union


@dataclass
class ModelArguments:
    model_name_or_path: Optional[str] = None
    model_type: Optional[str] = None
    dtype: str = "bf16"
    disable_gradient_checkpointing: bool = False
    attn_implementation: Optional[str] = None
    max_pixels: Union[int, str, None] = None     # may be an arithmetic string in yaml
    min_pixels: Union[int, str, None] = None
    freeze_vision_tower: bool = False
    extra_fields: Dict[str, Any] = field(default_factory=dict)

    def pixels(self, name: str) -> Optional[int]:
        val = getattr(self, name)
        if val is None:
            return None
        if isinstance(val, int):
            return val
        # yaml carries strings like "1344 * 1344" — evaluate the product safely
        parts = [p.strip() for p in str(val).split("*")]
        out = 1
        for p in parts:
            out *= int(p)
        return out


@dataclass
class TrainingArguments:
    learning_rate: float = 1e-6
    weight_decay: float = 0.0
    per_device_train_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    warmup_steps: int = 0
    num_train_epochs: int = 1
    max_grad_norm: float = 1.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    lr_scheduler_type: str = "constant"
    max_steps: int = -1
    extra_fields: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DataArguments:
    template: Optional[str] = None
    file_name: Optional[str] = None
    dataset_dir: Optional[str] = None
    response: Optional[str] = None
    prompt: Optional[str] = None
    preprocessing_num_workers: int = 8
    extra_fields: Dict[str, Any] = field(default_factory=dict)


@dataclass
class GeneratingArguments:
    max_new_tokens: int = 512
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    num_beams: int = 1
    num_return_sequences: int = 1
    do_sample: bool = True
    repetition_penalty: float = 1.0
    stop: Optional[List[str]] = None
    extra_fields: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "max_new_tokens": self.max_new_tokens, "temperature": self.temperature,
            "top_p": self.top_p, "top_k": self.top_k,
            "num_return_sequences": self.num_return_sequences,
            "do_sample": self.do_sample,
        }


@dataclass
class StrategyArguments:
    strategy_name: str = "jax_infer"
    strategy_config: Optional[Dict[str, Any]] = None

    @property
    def config(self) -> Dict[str, Any]:
        return self.strategy_config or {}


@dataclass
class WorkerConfig:
    name: Optional[str] = None
    model_args: ModelArguments = field(default_factory=ModelArguments)
    training_args: TrainingArguments = field(default_factory=TrainingArguments)
    data_args: DataArguments = field(default_factory=DataArguments)
    generating_args: GeneratingArguments = field(default_factory=GeneratingArguments)
    strategy_args: StrategyArguments = field(default_factory=StrategyArguments)
    world_size: int = 1
    device_mapping: Union[str, List[int], None] = None
    num_gpus_per_worker: int = 1
    infer_batch_size: int = 8
    model_update_frequency: int = 1
    backward_batch_size: int = -1
    system_envs: Dict[str, str] = field(default_factory=dict)
    checkpoint_config: Optional[Dict[str, Any]] = None
    worker_cls: Optional[str] = None
    format_pattern: Optional[str] = None
    # remote code-sandbox service URL for CodeSandboxRewardWorker (ref
    # `code_sandbox_reward_worker.py:505` self.worker_config.code_url);
    # None -> local subprocess execution
    code_url: Optional[str] = None
    extra_fields: Dict[str, Any] = field(default_factory=dict)

    def resolved_device_mapping(self) -> Optional[List[int]]:
        """The reference evals strings like "list(range(0,4))" (worker_config.py:29).
        Parse that shape without eval."""
        dm = self.device_mapping
        if dm is None or isinstance(dm, list):
            return dm
        import re
        m = re.fullmatch(r"list\(range\((\d+)\s*,\s*(\d+)\)\)", str(dm).strip())
        if m:
            return list(range(int(m.group(1)), int(m.group(2))))
        m = re.fullmatch(r"\[([\d,\s]*)\]", str(dm).strip())
        if m:
            return [int(x) for x in m.group(1).split(",") if x.strip()]
        raise ValueError(f"cannot parse device_mapping: {dm!r}")
