"""Concrete strategies of the port: torch_train / torch_infer / torch_decode.

The counterpart of socioreasoner_tpu/distributed/jax_strategies.py without a
mesh: `batch_image_embeds` runs the ViT once per sample; `TorchTrainStrategy`
(the JaxTrainStrategy role) runs the GRPO train and logprob steps;
`TorchInferStrategy` (JaxInferStrategy) is the frozen reference policy;
`TorchDecodeStrategy` (JaxDecodeStrategy) serves generation in batch mode
(`generate`) or through the request server. All share one ParamStore:
`model_update` hands the trainer's weights to the decode engine under
"rollout". With `single_copy_quant` / `vit_quant` the decode strategy keeps a
quantized copy of the rollout tree in the store instead (and quantizes again
on every model_update); the trainer's float tree is never modified.

The trainer updates its weights in place (trainer.py). A decode engine that
holds the same tensors -- the usual case, since model_update hands them over
without a copy -- therefore sees every update, and model_update is a swap of
the same tensors; rollouts must not run during train_step, and a rollout
that must see the weights of an earlier update after later train steps
needs `model_update(snapshot=True)`, which gives the engine its own copy of
what it shares (`copy_shared`). The reference policy must be given its own
copy of the weights.

TorchTrainStrategy checkpoints its params, optimizer state (moments, the
update count, the gradient-accumulation buffer and counters) and step
through utils/checkpoint.py when initialized with a checkpoint_dir.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..generation.engine import DecodeEngine, Request
from ..generation.sampling import SamplingParams
from ..generation.server import GenerateServer
from ..models.qwen2_5_vl.config import Qwen25VLConfig
from ..models.qwen2_5_vl.vision import run_vision, run_vision_u8
from ..ops.quant import (params_prequantized, quantize_decode_params,
                         quantize_vision_params, vision_prequantized)
from ..pipeline.losses import PPOLossConfig
from ..protocol import BatchProto
from ..utils.checkpoint import CheckpointManager
from .strategy import InferenceStrategy, ParamStore, TrainStrategy
from .trainer import TrainState, make_logprob_step, make_optimizer, make_train_step

@torch.no_grad()
def batch_image_embeds(config: Qwen25VLConfig, params, batch: BatchProto,
                       prefix: str = "", image_config=None
                       ) -> List[Optional[torch.Tensor]]:
    """Per-sample merged ViT embeddings (one tower call per sample) for every
    sample in `batch`, as tensors on the parameters' device."""
    out: List[Optional[torch.Tensor]] = [None] * len(batch)
    pv_col = batch.non_tensor.get(f"{prefix}pixel_values")
    u8_col = batch.non_tensor.get(f"{prefix}pixel_u8")
    grid_col = batch.non_tensor.get(f"{prefix}grid_thw")
    for i in range(len(batch)):
        u8 = u8_col[i] if u8_col is not None else None
        pv = pv_col[i] if pv_col is not None else None
        if u8 is not None:
            if image_config is None:
                raise ValueError("pixel_u8 requires image_config")
            out[i] = run_vision_u8(config.vision, params["vision"], u8,
                                   grid_col[i], image_config)
        elif pv is not None:
            out[i] = run_vision(config.vision, params["vision"], pv, grid_col[i])
    return out


def _storages(tree, out: set) -> set:
    if isinstance(tree, Mapping):
        for v in tree.values():
            _storages(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _storages(v, out)
    elif isinstance(tree, torch.Tensor):
        out.add(tree.untyped_storage().data_ptr())
    return out


@torch.no_grad()
def copy_shared(tree, other):
    """`tree` with a clone of every tensor that shares storage with a tensor
    of `other`, and the same tensor object elsewhere (lists and dicts
    rebuilt)."""
    shared = _storages(other, set())

    def walk(t):
        if isinstance(t, Mapping):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() in shared:
            return t.clone()
        return t
    return walk(tree)


def _to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _micro_batched_log_probs(logprob_step: Callable, params, batch: BatchProto,
                             worker_config, device) -> Dict[str, np.ndarray]:
    """Forward in micro-batches of worker_config.infer_batch_size rows (all
    rows when unset), slicing the packed image embeddings by each sample's
    row count (meta["image_embeds_rows"], else equal rows per sample)."""
    n = len(batch)
    mb = getattr(worker_config, "infer_batch_size", 0) or n
    img = batch.meta.get("image_embeds")
    rows = batch.meta.get("image_embeds_rows")
    if img is not None and rows is None:
        rows = np.full(n, img.shape[0] // max(n, 1), np.int64)
    offs = None if rows is None else np.concatenate(
        [[0], np.cumsum(np.asarray(rows, np.int64))])
    outs: Dict[str, list] = {}
    for start in range(0, n, mb):
        chunk = batch.slice(start, start + mb)
        k0 = len(chunk)
        device_batch = _to_device(chunk.batch, device)
        if img is not None and offs[start + k0] > offs[start]:
            device_batch["image_embeds"] = torch.as_tensor(
                img[offs[start]:offs[start + k0]], device=device)
        out = logprob_step(params, device_batch)
        for k, v in out.items():
            outs.setdefault(k, []).append(v.float().cpu().numpy()[:k0])
    return {k: np.concatenate(v, axis=0) for k, v in outs.items()}


class TorchTrainStrategy(TrainStrategy):
    """The actor-train backend (the JaxTrainStrategy role) on one GPU."""

    strategy_name = "torch_train"
    ckpt: Optional[CheckpointManager] = None

    def initialize(self, model_config: Qwen25VLConfig, params,
                   loss_cfg: Optional[PPOLossConfig] = None,
                   training_args=None, param_store: Optional[ParamStore] = None,
                   checkpoint_dir: Optional[str] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("a train mesh is not ported yet (ROADMAP: multi-GPU)")
        self.model_config = model_config
        if param_store is not None:
            self.param_store = param_store
        ta = training_args
        self.grad_accum_steps = max(
            1, int(getattr(ta, "gradient_accumulation_steps", 1) or 1))
        self.optimizer = make_optimizer(
            lr=getattr(ta, "learning_rate", 1e-6),
            weight_decay=getattr(ta, "weight_decay", 0.0),
            b1=getattr(ta, "adam_beta1", 0.9), b2=getattr(ta, "adam_beta2", 0.999),
            max_grad_norm=getattr(ta, "max_grad_norm", 1.0),
            warmup_steps=getattr(ta, "warmup_steps", 0),
            total_steps=getattr(ta, "max_steps", None) or None,
            schedule=getattr(ta, "lr_scheduler_type", "constant"),
            gradient_accumulation_steps=self.grad_accum_steps)
        self.state = TrainState.create(params, self.optimizer)
        self.loss_cfg = loss_cfg or PPOLossConfig()
        self.device = params["embed"].device
        self._train_step = make_train_step(model_config, self.loss_cfg, self.optimizer)
        self._logprob_step = make_logprob_step(model_config)
        self.param_store.put("actor", self.state.params)
        self.ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None

    @property
    def params(self):
        return self.state.params

    def train_step(self, batch: BatchProto, loss_func: Callable = None) -> Dict[str, float]:
        device_batch = _to_device(batch.batch, self.device)
        if "image_embeds" in batch.meta:
            device_batch["image_embeds"] = torch.as_tensor(batch.meta["image_embeds"],
                                                           device=self.device)
        self.state, metrics = self._train_step(self.state, device_batch)
        self.param_store.put("actor", self.state.params)
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
        return dict(zip(metrics, values))

    def forward_step(self, batch: BatchProto, forward_func: Callable = None):
        return self.compute_log_probs(batch)

    def compute_log_probs(self, batch: BatchProto) -> Dict[str, np.ndarray]:
        return _micro_batched_log_probs(self._logprob_step, self.state.params, batch,
                                        self.worker_config, self.device)

    def model_update(self, *args, **kwargs):
        """Expose the current weights to the rollout engine."""
        self.param_store.put("rollout", self.state.params)

    def _checkpoint_tree(self) -> Dict:
        return {"params": self.state.params, "opt_state": self.state.opt_state,
                "step": self.state.step}

    def save_checkpoint(self, step: int, meta: Optional[Dict] = None, wait: bool = False):
        """Checkpoint the params and optimizer state at `step` (nothing
        without a checkpoint_dir, as in the JAX strategy)."""
        if self.ckpt:
            self.ckpt.save(step, self._checkpoint_tree(), meta=meta, wait=wait)

    def load_checkpoint(self, step: Optional[int] = None) -> Optional[Dict]:
        """Restore the params and optimizer state of `step` (the latest when
        None) onto the current tensors' devices and dtypes, and publish the
        params as "actor"; returns the checkpoint's meta."""
        if not self.ckpt:
            return None
        restored, meta = self.ckpt.restore(step, like=self._checkpoint_tree())
        if restored is not None:
            self.state = TrainState(params=restored["params"],
                                    opt_state=restored["opt_state"], step=restored["step"])
            self.param_store.put("actor", self.state.params)
        return meta


class TorchInferStrategy(InferenceStrategy):
    """Frozen-policy forward backend (the JaxInferStrategy role): the
    reference log-probs. Give it its own copy of the weights."""

    strategy_name = "torch_infer"

    def initialize(self, model_config: Qwen25VLConfig, params,
                   param_store: Optional[ParamStore] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("an infer mesh is not ported yet (ROADMAP: multi-GPU)")
        self.model_config = model_config
        if param_store is not None:
            self.param_store = param_store
        self._params = params
        self.device = params["embed"].device
        self._logprob_step = make_logprob_step(model_config)

    @property
    def params(self):
        return self._params

    def compute_log_probs(self, batch: BatchProto) -> Dict[str, np.ndarray]:
        return _micro_batched_log_probs(self._logprob_step, self._params, batch,
                                        self.worker_config, self.device)

    def forward_step(self, batch: BatchProto, forward_func: Callable = None):
        return self.compute_log_probs(batch)


class TorchDecodeStrategy(InferenceStrategy):
    """Rollout backend: continuous-batching engine + request-level server."""

    strategy_name = "torch_decode"

    def initialize(self, model_config: Qwen25VLConfig, params=None,
                   engine_kwargs: Optional[Dict] = None,
                   param_store: Optional[ParamStore] = None):
        """Serve `params`, or the param store's "rollout" weights when None.

        engine_kwargs may carry two strategy knobs besides the engine's:
        `single_copy_quant` (needs `weight_quant`) stores a quantized copy of
        the rollout tree, which the engine then serves for prefill and decode
        alike; `vit_quant` ("int8") stores an int8 copy of its vision
        subtree, from which the pipelines compute image embeddings."""
        self.model_config = model_config
        if param_store is not None:
            self.param_store = param_store
        if params is not None:
            self.param_store.put("rollout", params)
        self.engine_kwargs = dict(engine_kwargs or {})
        self._single_copy = self.engine_kwargs.pop("single_copy_quant", False)
        self._vit_quant = self.engine_kwargs.pop("vit_quant", None)
        if self._single_copy and not self.engine_kwargs.get("weight_quant"):
            raise ValueError("single_copy_quant requires weight_quant")
        if self._single_copy or self._vit_quant:
            self._quantize_store()
        self.engine = DecodeEngine(model_config, self.param_store.get("rollout"),
                                   **self.engine_kwargs)
        self.server: Optional[GenerateServer] = None

    @torch.no_grad()
    def _quantize_store(self):
        """Replace the store's rollout tree by its quantized copy. The copy
        shares the float leaves that stay float; the tree it was made from
        (the trainer's, after a model_update) is left as it was."""
        tree = self.param_store.get("rollout")
        if self._single_copy and not params_prequantized(tree):
            tree = quantize_decode_params(tree, mode=self.engine_kwargs["weight_quant"])
        if (self._vit_quant and "vision" in tree
                and not vision_prequantized(tree["vision"])):
            tree = dict(tree, vision=quantize_vision_params(tree["vision"]))
        self.param_store.put("rollout", tree)

    def model_update(self, *args, params=None, snapshot: bool = False):
        """Swap in new weights -- `params`, or the param store's "rollout"
        weights when None -- only while the engine is idle (in-flight slots
        hold KV computed with the old weights). Positional arguments (the
        pipeline's step) are ignored, as the JAX strategies ignore them.

        With `snapshot`, the engine serves its own copy of every tensor it
        would share with the published tree: the trainer updates its weights
        in place, and a rollout after later train steps must see the weights
        of this update. Of a quantized tree only the float leaves it shares
        are copied; the codes are new tensors already."""
        if params is not None and not isinstance(params, Mapping):
            raise TypeError(f"params must be a mapping of weights, got {type(params).__name__}")
        if self.engine.has_work():
            raise RuntimeError(
                "model_update while the decode engine has in-flight or waiting "
                f"requests ({self.engine.num_running()} running, "
                f"{self.engine.num_waiting()} waiting); drain/stop generation "
                "before swapping weights")
        if params is not None:
            self.param_store.put("rollout", params)
        published = self.param_store.get("rollout")
        if self._single_copy or self._vit_quant:
            self._quantize_store()
        if snapshot:
            self.param_store.put("rollout", copy_shared(self.param_store.get("rollout"),
                                                        published))
        self.engine.set_params(self.param_store.get("rollout"))

    # ------------------------------------------------------------- batch mode
    def generate(self, batch: BatchProto, generating_args) -> np.ndarray:
        """Batch generate: returns (len(batch) * n, P + max_out) rows of
        [left-padded prompt as passed in | right-padded response]."""
        sp = SamplingParams.from_generating_args(generating_args)
        n = generating_args.num_return_sequences
        pad_id = self.model_config.pad_token_id
        requests = []
        embeds = batch.meta.get("image_embeds_list")
        for i in range(len(batch)):
            ids = batch.batch["input_ids"][i]
            valid = np.asarray(batch.batch["attention_mask"][i]) == 1
            prompt_ids = np.asarray(ids)[valid].tolist()
            pos = None
            if "position_ids" in batch.batch:
                pos = np.asarray(batch.batch["position_ids"][i])[:, valid]
            for j in range(n):
                requests.append(Request(
                    request_id=(i, j), prompt_ids=prompt_ids, sampling=sp,
                    image_embeds=None if embeds is None else embeds[i],
                    position_ids=pos))
        outs = self.engine.generate(requests)
        P = np.asarray(batch.batch["input_ids"]).shape[1]
        max_out = max(len(o.output_ids) for o in outs) if outs else 0
        result = np.full((len(batch) * n, P + max_out), pad_id, np.int64)
        order = {(i, j): i * n + j for i in range(len(batch)) for j in range(n)}
        for o in outs:
            row = order[o.request_id]
            result[row, :P] = np.asarray(batch.batch["input_ids"][row // n])
            result[row, P:P + len(o.output_ids)] = o.output_ids
        return result

    # ------------------------------------------------------------ server mode
    def start_server(self, data: Optional[BatchProto] = None):
        if self.server is None:
            self.server = GenerateServer(self.engine)
        self.server.start()

    def add_request(self, command, data):
        if self.server is None:
            raise RuntimeError("start_server first")
        return self.server.add_request(command, data)

    def stop_server(self):
        if self.server is not None:
            self.server.stop()
