"""PPO/GRPO policy loss and the critic's value loss in PyTorch.

The counterpart of socioreasoner_tpu/pipeline/losses.py, formula for formula:
ratio = exp(logp - old_logp); surr1/surr2 with pg_clip; optional dual-clip;
TopR; the k3 KL loss against the reference policy; the entropy bonus; every
term aggregated with agg_loss(loss_agg_mode); metrics as 0-dim tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..utils.functionals import agg_loss, compute_approx_kl, masked_mean


@dataclass(frozen=True)
class PPOLossConfig:
    pg_clip: float = 0.2
    dual_clip_loss: bool = False
    use_kl_loss: bool = True
    kl_loss_coef: float = 5e-3
    entropy_loss_coef: float = 0.0
    loss_agg_mode: str = "seq-mean-token-sum"
    loss_type: str = "ppo"            # ppo | topr
    topr_clip_min: float = 0.0        # TopR: clip(ratio, min, 1) * advantage


def ppo_policy_loss(
    log_probs: torch.Tensor,         # (B, T) current policy logp of response tokens
    entropy: torch.Tensor,           # (B, T)
    old_log_probs: torch.Tensor,     # (B, T) behavior policy
    ref_log_probs: Optional[torch.Tensor],  # (B, T) frozen reference
    advantages: torch.Tensor,        # (B, T)
    response_mask: torch.Tensor,     # (B, T) 1 on response tokens
    cfg: PPOLossConfig,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    response_mask = response_mask.float()
    ratio = torch.exp(log_probs - old_log_probs)
    surr1 = ratio * advantages
    surr2 = torch.clamp(ratio, 1 - cfg.pg_clip, 1 + cfg.pg_clip) * advantages
    if cfg.loss_type == "topr":
        # positive advantages: REINFORCE weighted by the clipped, detached
        # ratio; negative ones keep the importance-weighted term
        w = torch.clamp(ratio.detach(), cfg.topr_clip_min, 1.0)
        pg_loss_mat = -torch.where(advantages >= 0, w * log_probs * advantages,
                                   ratio * advantages)
    else:
        pg_loss_mat = -torch.minimum(surr1, surr2)
        if cfg.dual_clip_loss:
            dual = -torch.maximum(-pg_loss_mat, (1 + cfg.pg_clip * 2) * advantages)
            pg_loss_mat = torch.where(advantages < 0, dual, pg_loss_mat)
    pg_loss = agg_loss(pg_loss_mat, response_mask, cfg.loss_agg_mode, weights)

    if ref_log_probs is not None:
        kl_mat = compute_approx_kl(log_probs, ref_log_probs, response_mask, "k3")
    else:
        kl_mat = torch.zeros_like(log_probs)
    kl_loss = agg_loss(kl_mat, response_mask, cfg.loss_agg_mode, weights)

    approxkl = compute_approx_kl(log_probs, old_log_probs, response_mask, "mse")
    policykl = compute_approx_kl(log_probs, old_log_probs, response_mask, "kl")

    entropy_loss = agg_loss(entropy, response_mask, cfg.loss_agg_mode, weights)

    total = pg_loss
    if cfg.use_kl_loss:
        total = total + kl_loss * cfg.kl_loss_coef
    if cfg.entropy_loss_coef > 0:
        total = total - entropy_loss * cfg.entropy_loss_coef

    # clip statistics over response tokens only: ratios on padding are garbage
    with torch.no_grad():
        clipped_low = (ratio < 1 - cfg.pg_clip).float()
        clipped_high = (ratio > 1 + cfg.pg_clip).float()
        metrics = {
            "actor_train/ppo_ratio_high_clipfrac": masked_mean(clipped_high, response_mask),
            "actor_train/ppo_ratio_low_clipfrac": masked_mean(clipped_low, response_mask),
            "actor_train/ppo_ratio_clipfrac": masked_mean(clipped_low + clipped_high,
                                                          response_mask),
            "actor_train/ratio_mean": masked_mean(ratio, response_mask, axis=-1).mean(),
            "actor_train/ratio_max": torch.max(ratio * response_mask),
            "actor_train/ratio_min": torch.min(ratio * response_mask
                                               + (1 - response_mask) * 1e10),
            "actor_train/clipfrac": agg_loss((surr2 < surr1).float(), response_mask,
                                             cfg.loss_agg_mode),
            "actor_train/pg_loss": pg_loss.detach(),
            "actor_train/kl_loss": kl_loss.detach(),
            "actor_train/total_loss": total.detach(),
            "actor_train/entropy": entropy_loss.detach(),
            "actor_train/approxkl": agg_loss(approxkl, response_mask, cfg.loss_agg_mode),
            "actor_train/policykl": agg_loss(policykl, response_mask, cfg.loss_agg_mode),
        }
    return total, metrics


def value_loss(values: torch.Tensor, old_values: torch.Tensor, returns: torch.Tensor,
               response_mask: torch.Tensor, value_clip: Optional[float] = 0.2,
               loss_agg_mode: str = "seq-mean-token-sum"
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Critic clipped value loss."""
    response_mask = response_mask.float()
    if value_clip is not None:
        clipped = old_values + torch.clamp(values - old_values, -value_clip, value_clip)
        surr1 = torch.square(values - returns)
        surr2 = torch.square(clipped - returns)
        loss_mat = 0.5 * torch.maximum(surr1, surr2)
        clipfrac = masked_mean((surr2 > surr1).float(), response_mask)
    else:
        loss_mat = 0.5 * torch.square(values - returns)
        clipfrac = torch.zeros((), device=values.device)
    loss = agg_loss(loss_mat, response_mask, loss_agg_mode)
    return loss, {"critic_train/value_loss": loss, "critic_train/value_clipfrac": clipfrac}
