"""GRPO/PPO train and logprob steps, on one device or over a train mesh.

The counterpart of socioreasoner_tpu/distributed/trainer.py:

  make_optimizer        — clip_by_global_norm → AdamW (decoupled, eps outside
                          the sqrt, bias-corrected, moments in the param
                          dtype) with the constant / linear-warmup /
                          warmup-cosine schedules, and optax.MultiSteps
                          semantics for gradient_accumulation_steps > 1
  chunked_logp_entropy  — token log-probs and entropy from the hidden states
                          per 256-row chunk under torch.utils.checkpoint: the
                          (B, L, V) logits never exist
  make_train_step       — forward (remat per decoder layer, the trainable
                          flash kernels) → PPO loss → grads → optimizer
  make_logprob_step     — the forward alone under no_grad (only the forward
                          kernel runs)
  add_value_head,       — the critic: a scalar head on the backbone's hidden
  make_value_step         states, trained with the clipped value loss
  make_sft_step         — next-token cross-entropy over a loss mask

The critic and SFT steps (and sft.make_dpo_step) attend densely, as the JAX
package's do: only the GRPO train and logprob steps take the flash kernels.

Over a train mesh the params are a parallel/sharding.ShardedTree, and the
same steps run as one controller over its data ranks: rank (d, f) takes
its rows of the batch (padded to the mesh's divisor by the strategy), runs
the model over its tp devices (models/qwen2_5_vl/model.forward_mesh, the
kernels on each shard's local heads) and the chunked head over its tp
blocks (`vp`: the vocab-parallel reductions of ops/vocab_parallel.py, the
JAX package's vp_mesh route). The ranks' (B_r, L-1) log-probs are put
together on the mesh's first device, so the loss and its metrics are those
of the global batch, as in JAX's one global program; the gradient of each
block is summed over the ranks by autograd (and across processes by
utils/collective.py), the global norm counts each block once (a replicated
leaf once), and the optimizer updates the blocks in place. `cp` (a
parallel/context_parallel.CPConfig) splits each rank's sequence over its sp
devices, ring or Ulysses attention; `pp` (a
parallel/pipeline_parallel.PPConfig) runs each rank's layers through the
GPipe or interleaved schedule over its pp stages. Both need the mesh, and
the trainable kernels still run where the attention is full-sequence (each
Ulysses head slice, each pipeline stage's layers), where the JAX package
attends densely under cp and pp.

JAX's train state is immutable; here `train_step` updates the parameters and
the optimizer state IN PLACE and returns the same TrainState, so the trainer
holds one copy of the weights. Whoever shares those tensors (the decode
engine after model_update) sees every update: rollouts must not run during a
train step.

Attention follows the tensors' device like every kernel wrapper of the port:
the CUDA kernels for CUDA tensors, their plain versions for CPU tensors.
allow_flash=False selects dense attention, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.qwen2_5_vl import model as qmodel
from ..models.qwen2_5_vl.config import Qwen25VLConfig
from ..ops.flags import use_flash_attention
from ..ops.vocab_parallel import vocab_parallel_entropy, vocab_parallel_log_probs
from ..parallel.sharding import ShardedTree
from ..pipeline.losses import PPOLossConfig, ppo_policy_loss
from ..utils.collective import allreduce_across_processes, gather_rows

HEAD_CHUNK = 256


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested parameter dict, in insertion order; of a
    ShardedTree, its blocks (each stored block once)."""
    if isinstance(tree, ShardedTree):
        return tree.blocks()
    out = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (None counts as zeros),
    accumulated in f32, on the first tensor's device."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors if t is not None]
    if not norms:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack([n.to(norms[0].device) for n in norms]))


# ------------------------------------------------------------------ optimizer

def linear_schedule(init_value: float, end_value: float, transition_steps: int
                    ) -> Callable[[int], float]:
    """optax.linear_schedule: constant init_value when transition_steps <= 0."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear warmup, then cosine decay
    over decay_steps - warmup_steps updates."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError(f"cosine decay needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")
    warmup = linear_schedule(init_value, peak_value, warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return warmup(count)
        c = min(count - warmup_steps, cosine_steps)
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / cosine_steps)) + alpha
        return peak_value * decayed
    return schedule


@dataclass
class Optimizer:
    """The optax chain of make_optimizer, applied in place:
    clip_by_global_norm(max_grad_norm) → adamw(schedule, b1, b2, eps,
    weight_decay), wrapped in MultiSteps(accumulation_steps) when > 1."""

    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    accumulation_steps: int = 1

    def init(self, params: Dict) -> Dict:
        leaves = tree_leaves(params)
        state = {"count": 0,
                 "mu": [torch.zeros_like(p) for p in leaves],
                 "nu": [torch.zeros_like(p) for p in leaves]}
        if self.accumulation_steps > 1:
            state.update(mini_step=0, gradient_step=0,
                         acc=[torch.zeros_like(p) for p in leaves])
        return state

    @torch.no_grad()
    def update(self, grads: List[Optional[torch.Tensor]], state: Dict, params: Dict) -> None:
        """Apply one call's grads (aligned with tree_leaves(params); None for a
        leaf the loss does not reach, which counts as a zero gradient) to the
        params and the state in place."""
        leaves = tree_leaves(params)
        if self.accumulation_steps > 1:
            # MultiSteps: running mean of the micro-batch grads, applied on
            # the K-th call, then reset
            n = state["mini_step"]
            for acc, g in zip(state["acc"], grads):
                acc.add_(((0 if g is None else g) - acc) / (n + 1))
            state["mini_step"] = (n + 1) % self.accumulation_steps
            if n != self.accumulation_steps - 1:
                return
            grads = state["acc"]
            state["gradient_step"] += 1
        norm = global_norm(grads)
        if not bool(norm < self.max_grad_norm):        # clip_by_global_norm
            for g in grads:        # in place: the caller's grads are spent here
                if g is not None:
                    g.div_(norm.to(g.device, g.dtype)).mul_(self.max_grad_norm)
        lr = self.schedule(state["count"])
        state["count"] += 1
        bc1 = 1 - self.b1 ** state["count"]
        bc2 = 1 - self.b2 ** state["count"]
        for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
            mu.mul_(self.b1)
            nu.mul_(self.b2)
            if g is not None:
                mu.add_(g, alpha=1 - self.b1)
                nu.addcmul_(g, g, value=1 - self.b2)
            update = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            if self.weight_decay:
                update.add_(p, alpha=self.weight_decay)
            p.add_(update, alpha=-lr)
        if self.accumulation_steps > 1:
            for acc in state["acc"]:
                acc.zero_()


def make_optimizer(lr: float = 1e-6, weight_decay: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8, max_grad_norm: float = 1.0,
                   warmup_steps: int = 0, total_steps: Optional[int] = None,
                   schedule: str = "constant",
                   gradient_accumulation_steps: int = 1) -> Optimizer:
    """Optimizer factory with the JAX package's arguments and semantics: the
    schedule is evaluated at the update count starting from 0 (so with warmup
    the first update has lr 0)."""
    if schedule == "cosine" and total_steps:
        sched = warmup_cosine_decay_schedule(0.0, lr, warmup_steps, total_steps)
    elif warmup_steps > 0:
        sched = linear_schedule(0.0, lr, warmup_steps)
    else:
        sched = lambda count: lr   # noqa: E731
    return Optimizer(sched, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                     max_grad_norm=max_grad_norm,
                     accumulation_steps=max(1, int(gradient_accumulation_steps or 1)))


@dataclass
class TrainState:
    params: Dict
    opt_state: Dict
    step: int = 0

    @classmethod
    def create(cls, params: Dict, optimizer: Optimizer) -> "TrainState":
        return cls(params=params, opt_state=optimizer.init(params))


# ------------------------------------------------------------------ log-probs

def _logp_entropy(logits: torch.Tensor, labels: torch.Tensor, with_entropy: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    lp = torch.gather(logits, -1, labels[..., None].long())[..., 0] - logz
    if with_entropy:
        ent = logz - torch.sum(torch.softmax(logits, dim=-1) * logits, dim=-1)
    else:
        ent = torch.zeros_like(lp)
    return lp, ent


def _head_logp_entropy(params: Dict, hidden: torch.Tensor, labels: torch.Tensor,
                       with_entropy: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return _logp_entropy(qmodel.head_logits(params, hidden), labels, with_entropy)


def _head_logp_entropy_tp(heads: List[Dict], hidden: torch.Tensor, labels: torch.Tensor,
                          with_entropy: bool, vp: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """_head_logp_entropy over tp head blocks (model.rank_heads): each
    block's logits on its device, then either gathered along the vocabulary
    (the same softmax as one device) or, with vp, reduced across the blocks
    (ops/vocab_parallel.py)."""
    home = hidden.device
    blocks = [qmodel.head_logits(p, hidden.to(p["embed"].device)) for p in heads]
    if vp:
        lp = vocab_parallel_log_probs(blocks, labels)
        ent = vocab_parallel_entropy(blocks, home) if with_entropy else torch.zeros_like(lp)
        return lp, ent
    return _logp_entropy(torch.cat([b.to(home) for b in blocks], dim=-1), labels,
                         with_entropy)


def chunked_logp_entropy(params, hidden: torch.Tensor, labels: torch.Tensor,
                         chunk_size: int = HEAD_CHUNK, with_entropy: bool = True,
                         vp: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L, H) hidden + (B, L) labels → f32 (logp, entropy), each (B, L),
    without the (B, L, V) logits: the head matmul (in the weights' dtype,
    then f32) and the softmax statistics run per chunk of `chunk_size`
    positions, each under torch.utils.checkpoint, so the backward recomputes
    one chunk's logits at a time and the head weight's gradient accumulates
    across chunks. `params` is the tree, or a train-plane rank's list of tp
    head blocks (model.rank_heads; `vp` reduces them vocab-parallel)."""
    L = hidden.shape[1]
    C = min(chunk_size, L)
    lps, ents = [], []
    for s in range(0, L, C):
        if isinstance(params, list):
            fn, args = _head_logp_entropy_tp, (params, hidden[:, s:s + C],
                                               labels[:, s:s + C], with_entropy, vp)
        else:
            fn, args = _head_logp_entropy, (params, hidden[:, s:s + C],
                                            labels[:, s:s + C], with_entropy)
        if torch.is_grad_enabled():
            lp, ent = checkpoint(fn, *args, use_reentrant=False)
        else:
            lp, ent = fn(*args)
        lps.append(lp)
        ents.append(ent)
    return torch.cat(lps, dim=1), torch.cat(ents, dim=1)


def _mesh_log_probs(config: Qwen25VLConfig, params: ShardedTree, batch: Dict,
                    remat: bool, with_entropy: bool, use_flash: bool, vp: bool,
                    chunk_size: int, cp=None, pp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """_model_log_probs over a train mesh: the global batch's (B, L-1) logp
    and entropy on the mesh's first device, this process's rows computed by
    its data ranks (the others' gathered from their processes, without
    gradient).

    With cp the ranks' hidden states come in cp's layout: the next-token
    labels are built in the ORIGINAL order (the last column a dummy, masked
    by every caller), permuted to match, and the per-token logp and entropy
    inverse-permuted back, so only (B, L) arrays cross the permutation."""
    ids = batch["input_ids"]
    ranks, rows = params.data_ranks(ids.shape[0])
    hiddens, _ = qmodel.forward_mesh(
        config, ranks, rows, ids, batch["position_ids"], batch.get("attention_mask"),
        image_embeds=batch.get("image_embeds"), image_rows=batch.get("image_embeds_rows"),
        remat=remat, logits=False, use_flash=use_flash, cp=cp, pp=pp)
    main = ranks[0].home
    if cp is not None:
        L = ids.shape[1]
        perm = torch.as_tensor(cp.perm(L), device=ids.device)
        inv = torch.as_tensor(cp.inv_perm(L), device=main)
        labels = torch.cat([ids[:, 1:], ids[:, -1:]], dim=1)[:, perm]
    else:
        labels = ids[:, 1:]
    lps, ents = [], []
    for rank, sl, hidden in zip(ranks, rows, hiddens):
        lp, ent = chunked_logp_entropy(qmodel.rank_heads(rank),
                                       hidden if cp is not None else hidden[:, :-1],
                                       labels[sl].to(rank.home), chunk_size, with_entropy, vp)
        lps.append(lp.to(main))
        ents.append(ent.to(main))
    lp, ent = torch.cat(lps), torch.cat(ents)
    if cp is not None:
        lp, ent = lp[:, inv][:, :-1], ent[:, inv][:, :-1]
    if params.mesh.process_count > 1:
        lp, ent = gather_rows(lp, params.mesh), gather_rows(ent, params.mesh)
    return lp, ent


def _model_log_probs(config: Qwen25VLConfig, params, batch: Dict,
                     remat: bool, with_entropy: bool = True, use_flash: bool = False,
                     cp=None, pp=None, vp_mesh=None, chunk_size: int = HEAD_CHUNK):
    """Forward → (logp of the next-token labels, entropy), both (B, L-1).
    A ShardedTree runs over its mesh (vocab-parallel with vp_mesh; context
    parallel with cp, pipeline parallel with pp, which need one)."""
    if isinstance(params, ShardedTree):
        return _mesh_log_probs(config, params, batch, remat, with_entropy, use_flash,
                               vp_mesh is not None, chunk_size, cp, pp)
    if vp_mesh is not None or cp is not None or pp is not None:
        raise ValueError("vocab-parallel, context-parallel and pipeline-parallel log-probs "
                         "run over a train mesh: shard the params "
                         "(parallel.sharding.ShardedTree)")
    ids = batch["input_ids"]
    hidden, _ = qmodel.forward(
        config, params, ids, batch["position_ids"], batch.get("attention_mask"),
        image_embeds=batch.get("image_embeds"), vision_inputs=batch.get("vision_inputs"),
        remat=remat, use_flash=use_flash, logits=False)
    return chunked_logp_entropy(params, hidden[:, :-1], ids[:, 1:],
                                chunk_size=chunk_size, with_entropy=with_entropy)


# ------------------------------------------------------------------ steps

def _grad_step(optimizer: Optimizer, state: TrainState,
               loss_fn: Callable[[Dict], Tuple[torch.Tensor, Dict]],
               grad_norm_key: str) -> Tuple[torch.Tensor, Dict]:
    """One optimizer update of `state` in place from loss_fn(params) ->
    (loss, metrics): the gradient of every leaf (leaves the loss does not
    reach count as zeros), the metrics detached, metrics[grad_norm_key] =
    the global norm of the gradient before clipping. Returns (the loss, the
    metrics)."""
    leaves = tree_leaves(state.params)
    flags = [p.requires_grad for p in leaves]
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = loss_fn(state.params)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p, flag in zip(leaves, flags):
            p.requires_grad_(flag)
    mesh = getattr(state.params, "mesh", None)
    if mesh is not None and mesh.process_count > 1:
        # the dp axis spans processes: each computed its own ranks' share
        grads = allreduce_across_processes(list(grads))
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
    metrics[grad_norm_key] = global_norm(grads)
    optimizer.update(list(grads), state.opt_state, state.params)
    state.step += 1
    return loss, metrics


def make_train_step(config: Qwen25VLConfig, loss_cfg: PPOLossConfig,
                    optimizer: Optimizer, remat: bool = True, cp=None, pp=None,
                    vp_mesh=None, allow_flash: bool = True,
                    chunk_size: int = HEAD_CHUNK
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """The GRPO train step.

    batch keys: input_ids (B, L), attention_mask, position_ids (B, 3, L),
    response_mask (B, L), advantages / old_log_probs / ref_log_probs
    (B, L-1), optional image_embeds / vision_inputs / sample_weights.
    Metrics: the PPO loss's, plus actor_train/grad_norm (the global norm of
    this call's grads before clipping) and actor_train/loss, as 0-dim
    tensors. The trainable flash kernels unless allow_flash is off or
    SOCIO_DISABLE_FLASH=1 (ops/flags.py, which refuses the knob for a
    batch on the card), as in the JAX package."""

    def loss_fn(params: Dict, batch: Dict):
        flash = allow_flash and use_flash_attention(device=batch["input_ids"].device)
        lp, ent = _model_log_probs(config, params, batch, remat, with_entropy=True,
                                   use_flash=flash, cp=cp, pp=pp, vp_mesh=vp_mesh,
                                   chunk_size=chunk_size)
        batch = {k: v.to(lp.device) for k, v in batch.items()
                 if isinstance(v, torch.Tensor)}
        return ppo_policy_loss(
            lp, ent, batch["old_log_probs"], batch.get("ref_log_probs"),
            batch["advantages"], batch["response_mask"][:, 1:], loss_cfg,
            batch.get("sample_weights"))

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        loss, metrics = _grad_step(optimizer, state, lambda p: loss_fn(p, batch),
                                   "actor_train/grad_norm")
        metrics["actor_train/loss"] = loss.detach()
        return state, metrics

    return train_step


def make_logprob_step(config: Qwen25VLConfig, remat: bool = False, cp=None, pp=None,
                      vp_mesh=None, allow_flash: bool = True,
                      chunk_size: int = HEAD_CHUNK) -> Callable[[Dict, Dict], Dict]:
    """Forward only: {"log_probs", "entropy"}, each (B, L-1) and zero outside
    the response; flash attention as make_train_step chooses it."""

    @torch.no_grad()
    def logprob_step(params: Dict, batch: Dict) -> Dict:
        flash = allow_flash and use_flash_attention(device=batch["input_ids"].device)
        lp, ent = _model_log_probs(config, params, batch, remat, use_flash=flash,
                                   cp=cp, pp=pp, vp_mesh=vp_mesh, chunk_size=chunk_size)
        resp = batch["response_mask"][:, 1:].to(lp.device, lp.dtype)
        return {"log_probs": lp * resp, "entropy": ent * resp}

    return logprob_step


# ------------------------------------------------------------------ critic and SFT

def value_head(params: Dict, hidden: torch.Tensor) -> torch.Tensor:
    """(B, L, H) hidden → (B, L) values of the scalar head, computed in the
    promoted dtype of the hidden states and the head (f32 for bf16 hidden
    states and an f32 head), as JAX promotes `hidden @ value_head_w`."""
    w, b = params["value_head_w"], params["value_head_b"]
    dtype = torch.promote_types(hidden.dtype, w.dtype)
    return (hidden.to(dtype) @ w.to(dtype) + b.to(dtype))[..., 0]


def add_value_head(params: Dict, generator: torch.Generator, hidden_size: int,
                   dtype: torch.dtype = torch.float32) -> Dict:
    """`params` (a new top-level dict sharing its leaves) with a scalar value
    head: value_head_w (hidden_size, 1) ~ N(0, 0.02) drawn from `generator`
    on the generator's device, value_head_b zeros."""
    device = generator.device
    out = dict(params)
    out["value_head_w"] = (torch.randn((hidden_size, 1), generator=generator, device=device)
                           * 0.02).to(dtype)
    out["value_head_b"] = torch.zeros((1,), dtype=dtype, device=device)
    return out


def make_value_step(config: Qwen25VLConfig, optimizer: Optimizer, value_clip: float = 0.2,
                    loss_agg_mode: str = "seq-mean-token-sum", remat: bool = True):
    """The critic: (value_step, value_forward). value_forward(params, batch)
    gives the value head over the backbone's hidden states in the shifted
    frame (B, L-1), aligned with response_mask[:, 1:]; value_step trains
    the clipped value loss against batch["returns"] around
    batch["old_values"] and adds critic_train/grad_norm. Dense attention,
    as in the JAX package's step."""
    from ..pipeline.losses import value_loss as value_loss_fn

    def value_forward(params: Dict, batch: Dict) -> torch.Tensor:
        hidden, _ = qmodel.forward(
            config, params, batch["input_ids"], batch["position_ids"],
            batch.get("attention_mask"), image_embeds=batch.get("image_embeds"),
            remat=remat, logits=False)
        return value_head(params, hidden)[:, 1:]

    def value_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        def loss_fn(params):
            return value_loss_fn(value_forward(params, batch), batch["old_values"],
                                 batch["returns"], batch["response_mask"][:, 1:],
                                 value_clip, loss_agg_mode)
        _, metrics = _grad_step(optimizer, state, loss_fn, "critic_train/grad_norm")
        return state, metrics

    return value_step, value_forward


def make_sft_step(config: Qwen25VLConfig, optimizer: Optimizer, remat: bool = True):
    """Supervised next-token cross-entropy over batch["loss_mask"][:, 1:]:
    sft/loss and sft/grad_norm. Dense attention, as in the JAX package's
    step."""

    def sft_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        def loss_fn(params):
            lp, _ = _model_log_probs(config, params, batch, remat, with_entropy=False)
            mask = batch["loss_mask"][:, 1:].float()
            loss = -(lp * mask).sum() / (mask.sum() + 1e-8)
            return loss, {"sft/loss": loss}
        _, metrics = _grad_step(optimizer, state, loss_fn, "sft/grad_norm")
        return state, metrics

    return sft_step
