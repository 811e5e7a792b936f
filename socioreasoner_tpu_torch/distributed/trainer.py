"""GRPO/PPO train and logprob steps on one GPU.

The counterpart of socioreasoner_tpu/distributed/trainer.py for the path
without context, pipeline or vocab parallelism:

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
from ..pipeline.losses import PPOLossConfig, ppo_policy_loss

HEAD_CHUNK = 256


def tree_leaves(tree: Dict) -> List[torch.Tensor]:
    """The tensors of a nested parameter dict, in insertion order."""
    out = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (None counts as zeros),
    accumulated in f32."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors if t is not None]
    if not norms:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(norms))


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
                    g.div_(norm.to(g.dtype)).mul_(self.max_grad_norm)
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

def _head_logp_entropy(params: Dict, hidden: torch.Tensor, labels: torch.Tensor,
                       with_entropy: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = qmodel.head_logits(params, hidden).float()
    logz = torch.logsumexp(logits, dim=-1)
    lp = torch.gather(logits, -1, labels[..., None].long())[..., 0] - logz
    if with_entropy:
        ent = logz - torch.sum(torch.softmax(logits, dim=-1) * logits, dim=-1)
    else:
        ent = torch.zeros_like(lp)
    return lp, ent


def chunked_logp_entropy(params: Dict, hidden: torch.Tensor, labels: torch.Tensor,
                         chunk_size: int = HEAD_CHUNK, with_entropy: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L, H) hidden + (B, L) labels → f32 (logp, entropy), each (B, L),
    without the (B, L, V) logits: the head matmul (in the weights' dtype,
    then f32) and the softmax statistics run per chunk of `chunk_size`
    positions, each under torch.utils.checkpoint, so the backward recomputes
    one chunk's logits at a time and the head weight's gradient accumulates
    across chunks."""
    L = hidden.shape[1]
    C = min(chunk_size, L)
    lps, ents = [], []
    for s in range(0, L, C):
        args = (params, hidden[:, s:s + C], labels[:, s:s + C], with_entropy)
        if torch.is_grad_enabled():
            lp, ent = checkpoint(_head_logp_entropy, *args, use_reentrant=False)
        else:
            lp, ent = _head_logp_entropy(*args)
        lps.append(lp)
        ents.append(ent)
    return torch.cat(lps, dim=1), torch.cat(ents, dim=1)


def _model_log_probs(config: Qwen25VLConfig, params: Dict, batch: Dict,
                     remat: bool, with_entropy: bool = True, use_flash: bool = False,
                     cp=None, pp=None, vp_mesh=None, chunk_size: int = HEAD_CHUNK):
    """Forward → (logp of the next-token labels, entropy), both (B, L-1)."""
    if cp is not None or pp is not None or vp_mesh is not None:
        raise NotImplementedError(
            "context / pipeline / vocab-parallel log-probs are not ported yet "
            "(ROADMAP: multi-GPU)")
    ids = batch["input_ids"]
    hidden, _ = qmodel.forward(
        config, params, ids, batch["position_ids"], batch.get("attention_mask"),
        image_embeds=batch.get("image_embeds"), vision_inputs=batch.get("vision_inputs"),
        remat=remat, use_flash=use_flash, logits=False)
    return chunked_logp_entropy(params, hidden[:, :-1], ids[:, 1:],
                                chunk_size=chunk_size, with_entropy=with_entropy)


# ------------------------------------------------------------------ steps

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
    tensors."""

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        leaves = tree_leaves(state.params)
        flags = [p.requires_grad for p in leaves]
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                lp, ent = _model_log_probs(config, state.params, batch, remat,
                                           with_entropy=True, use_flash=allow_flash,
                                           cp=cp, pp=pp, vp_mesh=vp_mesh,
                                           chunk_size=chunk_size)
                loss, metrics = ppo_policy_loss(
                    lp, ent, batch["old_log_probs"], batch.get("ref_log_probs"),
                    batch["advantages"], batch["response_mask"][:, 1:], loss_cfg,
                    batch.get("sample_weights"))
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p, flag in zip(leaves, flags):
                p.requires_grad_(flag)
        metrics["actor_train/grad_norm"] = global_norm(grads)
        metrics["actor_train/loss"] = loss.detach()
        optimizer.update(list(grads), state.opt_state, state.params)
        state.step += 1
        return state, metrics

    return train_step


def make_logprob_step(config: Qwen25VLConfig, remat: bool = False, cp=None, pp=None,
                      vp_mesh=None, allow_flash: bool = True,
                      chunk_size: int = HEAD_CHUNK) -> Callable[[Dict, Dict], Dict]:
    """Forward only: {"log_probs", "entropy"}, each (B, L-1) and zero outside
    the response."""

    @torch.no_grad()
    def logprob_step(params: Dict, batch: Dict) -> Dict:
        lp, ent = _model_log_probs(config, params, batch, remat, use_flash=allow_flash,
                                   cp=cp, pp=pp, vp_mesh=vp_mesh, chunk_size=chunk_size)
        resp = batch["response_mask"][:, 1:].to(lp.dtype)
        return {"log_probs": lp * resp, "entropy": ent * resp}

    return logprob_step
