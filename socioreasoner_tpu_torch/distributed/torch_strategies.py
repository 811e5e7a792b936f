"""Concrete strategies of the port: torch_train / torch_infer / torch_reward /
torch_decode.

The counterpart of socioreasoner_tpu/distributed/jax_strategies.py:
`batch_image_embeds` runs the ViT once per sample; `TorchTrainStrategy`
(the JaxTrainStrategy role) runs the GRPO train and logprob steps;
`TorchInferStrategy` (JaxInferStrategy) is the frozen reference policy;
`TorchRewardStrategy` (JaxRewardStrategy) scores with a value head;
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

With a `mesh` (parallel/mesh.py, from ResourceManager.allocate_mesh) the
train, infer and reward strategies shard their trees over its fsdp and tp
axes (parallel/sharding.ShardedTree: copies, the caller's tree is left as
it was) and run their steps over its data ranks (trainer.py). As in the
JAX strategies, a train batch is padded to a multiple of dp x fsdp with
copies of row 0 whose response mask and sample weight are 0, and every
log-prob micro-batch with copies of its last row, sliced off again; each
rank takes the image embeddings of its own samples. model_update hands the
decode engine the gathered whole tree (a new tree each update, on the
mesh's first device), and a checkpoint holds the gathered tree and
moments, so it loads into any mesh or none. strategy_config's
context_parallel_size / context_parallel_impl and
pipeline_model_parallel_size / pp_micro_batches /
virtual_pipeline_model_parallel_size give the steps a CPConfig over the
mesh's sp axis or a PPConfig over its pp axis (_parallel_plan), as in the
JAX strategies; under pp the layers are stored a stage on the stage's
devices.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..generation.engine import DecodeEngine, Request
from ..generation.sampling import SamplingParams
from ..generation.server import GenerateServer
from ..models.qwen2_5_vl import model as qmodel
from ..models.qwen2_5_vl.config import Qwen25VLConfig
from ..models.qwen2_5_vl.vision import run_vision, run_vision_u8
from ..ops.quant import (params_prequantized, quantize_decode_params,
                         quantize_vision_params, vision_prequantized)
from ..parallel.context_parallel import make_cp_config
from ..parallel.mesh import batch_divisor
from ..parallel.pipeline_parallel import make_pp_config
from ..parallel.sharding import ShardedTree
from ..pipeline.losses import PPOLossConfig
from ..protocol import BatchProto
from ..utils.checkpoint import CheckpointManager
from ..utils import profiling
from .strategy import InferenceStrategy, ParamStore, TrainStrategy
from .trainer import (TrainState, make_logprob_step, make_optimizer, make_train_step,
                      value_head)


@torch.no_grad()
def compute_image_embeds(config: Qwen25VLConfig, params, pixel_values: np.ndarray,
                         grid_thw: np.ndarray) -> torch.Tensor:
    """One sample's packed images → its merged ViT embeddings (S_merged,
    hidden), on the parameters' device."""
    return run_vision(config.vision, params["vision"], pixel_values, grid_thw)


@torch.no_grad()
def batch_image_embeds(config: Qwen25VLConfig, params, batch: BatchProto,
                       prefix: str = "", image_config=None
                       ) -> List[Optional[torch.Tensor]]:
    """Per-sample merged ViT embeddings (one tower call per sample) for every
    sample in `batch`, as tensors on the parameters' device; one
    vision.embeds span while spans are recorded."""
    out: List[Optional[torch.Tensor]] = [None] * len(batch)
    pv_col = batch.non_tensor.get(f"{prefix}pixel_values")
    u8_col = batch.non_tensor.get(f"{prefix}pixel_u8")
    grid_col = batch.non_tensor.get(f"{prefix}grid_thw")
    with profiling.span("vision.embeds", images=len(batch)):
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


def _image_rows(batch: BatchProto, n: int):
    """(the packed image embeddings, each sample's row count) of a batch:
    meta["image_embeds_rows"], else equal rows per sample; (None, None)
    without images."""
    img = batch.meta.get("image_embeds")
    if img is None:
        return None, None
    rows = batch.meta.get("image_embeds_rows")
    if rows is None:
        rows = np.full(n, img.shape[0] // max(n, 1), np.int64)
    return img, np.asarray(rows, np.int64)


def _pad_rows(arrays: Dict, pad: int, src: int) -> Dict:
    """Each array with `pad` copies of its row `src` appended."""
    return {k: np.concatenate([np.asarray(v), np.repeat(np.asarray(v)[src:src + 1], pad,
                                                        axis=0)], axis=0)
            for k, v in arrays.items()}


def _padded_images(img, rows, offs, start: int, stop: int, pad: int, src: int, device):
    """The image embeddings of samples start..stop-1 plus `pad` copies of
    sample src's, with their row counts, on `device`."""
    img = torch.as_tensor(img, device=device)
    parts = [img[offs[start]:offs[stop]]] + [img[offs[src]:offs[src + 1]]] * pad
    counts = np.concatenate([rows[start:stop], np.repeat(rows[src:src + 1], pad)])
    return torch.cat(parts), torch.as_tensor(counts, device=device)


def _micro_batched_log_probs(logprob_step: Callable, params, batch: BatchProto,
                             worker_config, device, mesh=None) -> Dict[str, np.ndarray]:
    """Forward in micro-batches of worker_config.infer_batch_size rows (all
    rows when unset), slicing the packed image embeddings by each sample's
    row count (meta["image_embeds_rows"], else equal rows per sample). With
    a mesh, each micro-batch is a multiple of dp x fsdp rows, padded with
    copies of its last row and sliced back, as in the JAX strategies."""
    n = len(batch)
    mb = getattr(worker_config, "infer_batch_size", 0) or n
    div = batch_divisor(mesh)
    mb = max(div, (mb // div) * div)
    img, rows = _image_rows(batch, n)
    offs = None if rows is None else np.concatenate([[0], np.cumsum(rows)])
    outs: Dict[str, list] = {}
    for start in range(0, n, mb):
        chunk = batch.slice(start, start + mb)
        k0 = len(chunk)
        pad = (-k0) % div
        arrays = _pad_rows(chunk.batch, pad, k0 - 1) if pad else chunk.batch
        device_batch = _to_device(arrays, device)
        if img is not None and offs[start + k0] > offs[start]:
            if mesh is None:
                device_batch["image_embeds"] = torch.as_tensor(
                    img[offs[start]:offs[start + k0]], device=device)
            else:
                device_batch["image_embeds"], device_batch["image_embeds_rows"] = \
                    _padded_images(img, rows, offs, start, start + k0, pad,
                                   start + k0 - 1, device)
        out = logprob_step(params, device_batch)
        for k, v in out.items():
            outs.setdefault(k, []).append(v.float().cpu().numpy()[:k0])
    return {k: np.concatenate(v, axis=0) for k, v in outs.items()}


def _parallel_plan(strategy, model_config: Qwen25VLConfig, mesh):
    """(cp, pp, vp_mesh) from strategy_config, as JaxTrainStrategy._parallel_plan:
    context_parallel_size / context_parallel_impl → a CPConfig over the
    mesh's sp axis (zigzag ring or Ulysses), pipeline_model_parallel_size /
    pp_micro_batches / virtual_pipeline_model_parallel_size → a PPConfig
    over its pp axis (GPipe, or interleaved under vpp), and the mesh as the
    vocab-parallel route when vocab_parallel_logprobs is set without cp and
    pp. Either knob above 1 needs a mesh. With a mesh, tp must divide the
    text heads: a head is never split."""
    wc = strategy.worker_config
    cfg = wc.strategy_args.config if wc is not None else {}
    cp = make_cp_config(mesh, int(cfg.get("context_parallel_size", 1) or 1),
                        impl=str(cfg.get("context_parallel_impl", "ring")))
    pp = make_pp_config(mesh, int(cfg.get("pipeline_model_parallel_size", 1) or 1),
                        n_micro=int(cfg.get("pp_micro_batches", 0) or 0),
                        vpp=int(cfg.get("virtual_pipeline_model_parallel_size", 1) or 1))
    if mesh is None:
        return None, None, None
    t, T = model_config.text, mesh.shape.get("tp", 1)
    if t.num_attention_heads % T or t.num_key_value_heads % T:
        raise ValueError(f"tp={T} must divide the heads: H={t.num_attention_heads}, "
                         f"Hkv={t.num_key_value_heads} (a head is never split)")
    vp_mesh = mesh if (cfg.get("vocab_parallel_logprobs") and cp is None
                       and pp is None) else None
    return cp, pp, vp_mesh


def _shard(params, mesh, pp, model_config: Qwen25VLConfig):
    """The tree over the mesh, its layers stored a pp stage under pp."""
    stages = None if pp is None else pp.stage_layers(model_config.text.num_hidden_layers)
    return ShardedTree(params, mesh, layer_stages=stages)


def _mesh_device(mesh, params):
    return mesh.devices.flat[0] if mesh is not None else params["embed"].device


class TorchTrainStrategy(TrainStrategy):
    """The actor-train backend (the JaxTrainStrategy role), on one device or
    over a train mesh."""

    strategy_name = "torch_train"
    ckpt: Optional[CheckpointManager] = None
    mesh = None

    def initialize(self, model_config: Qwen25VLConfig, params,
                   loss_cfg: Optional[PPOLossConfig] = None,
                   training_args=None, param_store: Optional[ParamStore] = None,
                   checkpoint_dir: Optional[str] = None, mesh=None):
        cp, pp, vp_mesh = _parallel_plan(self, model_config, mesh)
        self.mesh = mesh
        self.device = _mesh_device(mesh, params)
        if mesh is not None:
            params = _shard(params, mesh, pp, model_config)
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
        self._train_step = make_train_step(model_config, self.loss_cfg, self.optimizer,
                                           cp=cp, pp=pp, vp_mesh=vp_mesh)
        self._logprob_step = make_logprob_step(model_config, cp=cp, pp=pp, vp_mesh=vp_mesh)
        self.param_store.put("actor", self.state.params)
        self.ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None

    @property
    def params(self):
        return self.state.params

    def train_step(self, batch: BatchProto, loss_func: Callable = None) -> Dict[str, float]:
        n = len(batch)
        pad = (-n) % batch_divisor(self.mesh)
        arrays = dict(batch.batch)
        if pad:
            # pad rows repeat row 0 with response_mask and sample_weights 0:
            # agg_loss drops them from numerator and denominator in every
            # loss_agg_mode (JaxTrainStrategy.train_step)
            arrays = _pad_rows(arrays, pad, 0)
            for k in ("response_mask", "sample_weights"):
                if k in arrays:
                    arrays[k][n:] = 0
            if "sample_weights" not in arrays:
                w = np.ones((n + pad,), np.float32)
                w[n:] = 0.0
                arrays["sample_weights"] = w
        device_batch = _to_device(arrays, self.device)
        img, rows = _image_rows(batch, n)
        if img is not None:
            if self.mesh is None:
                device_batch["image_embeds"] = torch.as_tensor(img, device=self.device)
            else:
                offs = np.concatenate([[0], np.cumsum(rows)])
                device_batch["image_embeds"], device_batch["image_embeds_rows"] = \
                    _padded_images(img, rows, offs, 0, n, pad, 0, self.device)
        self.state, metrics = self._train_step(self.state, device_batch)
        self.param_store.put("actor", self.state.params)
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
        return dict(zip(metrics, values))

    def forward_step(self, batch: BatchProto, forward_func: Callable = None):
        return self.compute_log_probs(batch)

    def compute_log_probs(self, batch: BatchProto) -> Dict[str, np.ndarray]:
        return _micro_batched_log_probs(self._logprob_step, self.state.params, batch,
                                        self.worker_config, self.device, self.mesh)

    def model_update(self, *args, **kwargs):
        """Expose the current weights to the rollout engine: the trainer's
        tree, or over a mesh its shards gathered into a new whole tree on
        the mesh's first device."""
        params = self.state.params
        self.param_store.put("rollout", params.gather() if self.mesh is not None else params)

    _LEAF_LISTS = ("mu", "nu", "acc")

    def _checkpoint_tree(self) -> Dict:
        """Over a mesh, the gathered tree and the moments gathered a leaf
        (the unsharded strategy's layout)."""
        params, opt = self.state.params, self.state.opt_state
        if self.mesh is not None:
            opt = {k: params.whole_leaves(v, self.device) if k in self._LEAF_LISTS else v
                   for k, v in opt.items()}
            params = params.gather(self.device)
        return {"params": params, "opt_state": opt, "step": self.state.step}

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
            params, opt = restored["params"], restored["opt_state"]
            if self.mesh is not None:
                sharded = self.state.params
                sharded.assign(params)
                opt = {k: sharded.split_leaves(v) if k in self._LEAF_LISTS else v
                       for k, v in opt.items()}
                params = sharded
            self.state = TrainState(params=params, opt_state=opt, step=restored["step"])
            self.param_store.put("actor", self.state.params)
        return meta


class TorchInferStrategy(InferenceStrategy):
    """Frozen-policy forward backend (the JaxInferStrategy role): the
    reference log-probs. Give it its own copy of the weights."""

    strategy_name = "torch_infer"

    mesh = None

    def initialize(self, model_config: Qwen25VLConfig, params,
                   param_store: Optional[ParamStore] = None, mesh=None):
        cp, pp, vp_mesh = _parallel_plan(self, model_config, mesh)
        self.mesh = mesh
        self.model_config = model_config
        if param_store is not None:
            self.param_store = param_store
        self.device = _mesh_device(mesh, params)
        self._params = params if mesh is None else _shard(params, mesh, pp, model_config)
        self._logprob_step = make_logprob_step(model_config, cp=cp, pp=pp, vp_mesh=vp_mesh)

    @property
    def params(self):
        return self._params

    def compute_log_probs(self, batch: BatchProto) -> Dict[str, np.ndarray]:
        return _micro_batched_log_probs(self._logprob_step, self._params, batch,
                                        self.worker_config, self.device, self.mesh)

    def forward_step(self, batch: BatchProto, forward_func: Callable = None):
        return self.compute_log_probs(batch)


class TorchRewardStrategy(InferenceStrategy):
    """The reward-model backend (the JaxRewardStrategy role): a scalar value
    head on the backbone (trainer.add_value_head), read in the shifted frame
    by RewardWorker. Dense attention, as in the JAX package's strategy."""

    strategy_name = "torch_reward"
    mesh = None

    def initialize(self, model_config: Qwen25VLConfig, params,
                   param_store: Optional[ParamStore] = None, mesh=None):
        """With a mesh the body is sharded over it and the value head kept
        whole (stored once, copied onto each rank's first device)."""
        cp, pp, _ = _parallel_plan(self, model_config, mesh)
        if "value_head_w" not in params:
            raise ValueError("torch_reward strategy needs a value head "
                             "(trainer.add_value_head) on the params tree")
        self.model_config = model_config
        if param_store is not None:
            self.param_store = param_store
        self.mesh = mesh
        self.device = _mesh_device(mesh, params)
        self._params = params if mesh is None else _shard(params, mesh, pp, model_config)

        @torch.no_grad()
        def value_step(params, batch: Dict) -> Dict[str, torch.Tensor]:
            if isinstance(params, ShardedTree):
                return {"values": _mesh_values(model_config, params, batch, cp, pp)}
            hidden, _ = qmodel.forward(
                model_config, params, batch["input_ids"], batch["position_ids"],
                batch.get("attention_mask"), image_embeds=batch.get("image_embeds"),
                logits=False)
            # the value at position i scores the prefix up to i
            return {"values": value_head(params, hidden)[:, 1:]}

        self._value_step = value_step

    @property
    def params(self):
        return self._params

    def compute_values(self, batch: BatchProto) -> np.ndarray:
        """(B, L-1) f32 values in micro-batches of infer_batch_size rows."""
        return _micro_batched_log_probs(self._value_step, self._params, batch,
                                        self.worker_config, self.device, self.mesh)["values"]

    def forward_step(self, batch: BatchProto, forward_func: Callable = None):
        return {"values": self.compute_values(batch)}


def _mesh_values(config: Qwen25VLConfig, params: ShardedTree, batch: Dict,
                 cp=None, pp=None) -> torch.Tensor:
    """The reward model's (B, L-1) values over a mesh: each data rank's
    hidden states (under cp put back into the original order) through the
    whole value head on its first device, put together on the mesh's first
    device (this process's ranks: the reward strategy runs in one
    process)."""
    ranks, rows = params.data_ranks(batch["input_ids"].shape[0])
    hiddens, _ = qmodel.forward_mesh(
        config, ranks, rows, batch["input_ids"],
        batch["position_ids"], batch.get("attention_mask"),
        image_embeds=batch.get("image_embeds"), image_rows=batch.get("image_embeds_rows"),
        logits=False, cp=cp, pp=pp)
    if cp is not None:
        L = batch["input_ids"].shape[1]
        hiddens = [h[:, torch.as_tensor(cp.inv_perm(L), device=h.device)] for h in hiddens]
    main = ranks[0].home
    return torch.cat([
        value_head({k: rank.top(k)[0] for k in ("value_head_w", "value_head_b")},
                   hidden)[:, 1:].to(main)
        for rank, hidden in zip(ranks, hiddens)])


class TorchDecodeStrategy(InferenceStrategy):
    """Rollout backend: continuous-batching engine + request-level server."""

    strategy_name = "torch_decode"

    def initialize(self, model_config: Qwen25VLConfig, params=None,
                   engine_kwargs: Optional[Dict] = None,
                   param_store: Optional[ParamStore] = None, mesh=None):
        """Serve `params`, or the param store's "rollout" weights when None;
        with `mesh` (a parallel.mesh.Mesh or a device list) the engine is
        tensor-parallel over its "tp" devices.

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
        if mesh is not None:
            self.engine_kwargs.setdefault("mesh", mesh)
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
        are copied; the codes are new tensors already. A tensor-parallel
        engine also takes the list of per-shard trees of
        distributed/transfer.py's transfer_params."""
        shards = (isinstance(params, list) and self.engine.tp is not None
                  and all(isinstance(p, Mapping) for p in params))
        if params is not None and not (isinstance(params, Mapping) or shards):
            raise TypeError(f"params must be a mapping of weights (or, for a tensor-parallel "
                            f"engine, a list of per-shard mappings), got "
                            f"{type(params).__name__}")
        if self.engine.has_work():
            raise RuntimeError(
                "model_update while the decode engine has in-flight or waiting "
                f"requests ({self.engine.num_running()} running, "
                f"{self.engine.num_waiting()} waiting); drain/stop generation "
                "before swapping weights")
        if shards:                  # already laid out: the engine's own, not the store's
            self.engine.set_params(params)
            return
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
