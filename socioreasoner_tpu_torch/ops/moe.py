"""Mixture-of-Experts layer (router, SwiGLU experts, load-balance loss) in
PyTorch, the counterpart of socioreasoner_tpu/ops/moe.py.

The same formulation as the JAX package: every expert computes every token
and the router's top-k weights select among the results, so shapes never
depend on the routing. The products are batched matmuls over the expert
axis (torch.bmm with the tokens broadcast, no copy of a weight stack);
they are plain large GEMMs, outside any TPU kernel.

Under tensor parallelism the expert stacks split over the shards
(parallel/sharding.py), each shard computing its experts' share with
moe_experts.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def moe_router(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
               norm_topk_prob: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, H) → (weights (T, E), probs (T, E), aux_loss scalar).

    HF semantics: softmax over all experts in float32 of the logits taken in
    x's dtype, top-k, then renormalised iff norm_topk_prob. Equal
    probabilities rank the lower expert index first, as lax.top_k does
    (torch.topk promises no order among ties: a stable descending sort
    does)."""
    logits = (x @ router_w).float()                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = ranked.values[:, :top_k], ranked.indices[:, :top_k]
    if norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    E = probs.shape[-1]
    weights = torch.zeros_like(probs).scatter(1, topi, topv)
    # Switch-style load-balance loss: E * sum(frac_tokens * frac_probs)
    frac_tokens = (weights > 0).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux_loss = E * torch.sum(frac_tokens * frac_probs)
    return weights, probs, aux_loss


def moe_mlp(x: torch.Tensor, params: Dict, top_k: int = 2,
            norm_topk_prob: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """SwiGLU expert MLPs. params: router_w (H, E), gate_w/up_w (E, H, I),
    down_w (E, I, H). Returns (out (T, H), aux_loss)."""
    weights, _, aux_loss = moe_router(x, params["router_w"], top_k, norm_topk_prob)
    return moe_experts(x, weights, params), aux_loss


def moe_experts(x: torch.Tensor, weights: torch.Tensor, params: Dict) -> torch.Tensor:
    """sum_e weights[:, e] * expert_e(x) over the experts of the stacks in
    `params` (all of them, or a tensor-parallel shard's block with its
    columns of `weights`)."""
    E = weights.shape[-1]
    xe = x.unsqueeze(0).expand(E, *x.shape)              # (E, T, H), a view
    h = F.silu(torch.bmm(xe, params["gate_w"])) * torch.bmm(xe, params["up_w"])
    expert_out = torch.bmm(h, params["down_w"])          # (E, T, H)
    # out[t] = sum_e weights[t, e] * expert_out[e, t]: per token a (1, E) @ (E, H)
    return torch.bmm(weights.to(expert_out.dtype).unsqueeze(1),
                     expert_out.transpose(0, 1)).squeeze(1)


def init_moe_params(generator: torch.Generator, hidden: int, intermediate: int,
                    n_experts: int, dtype=torch.float32, device=None) -> Dict:
    """N(0, 0.02) router and expert weights at the JAX shapes, drawn from
    `generator` on `device` (the generator's device when None)."""
    device = generator.device if device is None else device

    def dense(shape):
        return torch.randn(shape, generator=generator, device=device).mul_(0.02).to(dtype)

    return {
        "router_w": dense((hidden, n_experts)),
        "gate_w": dense((n_experts, hidden, intermediate)),
        "up_w": dense((n_experts, hidden, intermediate)),
        "down_w": dense((n_experts, intermediate, hidden)),
    }
