"""RL math and batch plumbing in PyTorch.

The counterpart of socioreasoner_tpu/utils/functionals.py (which imports
jax): the same functions, names and semantics, over torch tensors, plus
numpy copies of the host helpers pad_to_length, concatenate_input_and_output
and postprocess_generate. Reference file:line citations are in the JAX
module.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

EPS = 1e-8


# --------------------------------------------------------------------- masking

def masked_mean(tensor: torch.Tensor, mask: torch.Tensor,
                axis: Optional[int] = None) -> torch.Tensor:
    mask = mask.to(tensor.dtype)
    if axis is not None:
        mask_sum = mask.sum(dim=axis)
        val = (tensor * mask).sum(dim=axis) / (mask_sum + EPS)
        return torch.where(mask_sum > 0, val, torch.zeros_like(val))
    s = mask.sum()
    return torch.where(s > 0, (tensor * mask).sum() / (s + EPS), torch.zeros_like(s))


def masked_var(values: torch.Tensor, mask: torch.Tensor, unbiased: bool = True) -> torch.Tensor:
    mean = masked_mean(values, mask)
    variance = masked_mean((values - mean) ** 2, mask)
    if unbiased:
        n = mask.to(values.dtype).sum()
        variance = variance * n / torch.clamp(n - 1, min=1)
    return variance


def masked_whiten(values: torch.Tensor, mask: torch.Tensor,
                  shift_mean: bool = True) -> torch.Tensor:
    mean, var = masked_mean(values, mask), masked_var(values, mask)
    whitened = (values - mean) * torch.rsqrt(var + EPS)
    if not shift_mean:
        whitened = whitened + mean
    return whitened


# ------------------------------------------------------------- token-level ops

def log_probs_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log softmax gathered at labels, float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return picked - logz


def entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """H = logsumexp(z) - sum softmax(z) * z, float32."""
    logits = logits.float()
    pd = torch.softmax(logits, dim=-1)
    return torch.logsumexp(logits, dim=-1) - torch.sum(pd * logits, dim=-1)


def compute_approx_kl(log_probs: torch.Tensor, log_probs_base: torch.Tensor,
                      action_mask: Optional[torch.Tensor] = None,
                      kl_penalty: str = "kl") -> torch.Tensor:
    """Schulman approximate KLs. k3 = exp(q-p) - (q-p) - 1, clamped to ±10."""
    if kl_penalty == "kl":
        log_ratio = log_probs - log_probs_base
    elif kl_penalty == "abs":
        log_ratio = torch.abs(log_probs - log_probs_base)
    elif kl_penalty == "mse":
        log_ratio = 0.5 * torch.square(log_probs - log_probs_base)
    elif kl_penalty == "k3":
        kl = log_probs_base - log_probs
        log_ratio = torch.clamp(torch.exp(kl) - kl - 1.0, -10.0, 10.0)
    elif kl_penalty == "full":
        # inputs are full log-distributions over the vocabulary
        log_ratio = torch.sum(torch.exp(log_probs_base) * (log_probs_base - log_probs), dim=-1)
    else:
        raise NotImplementedError(kl_penalty)
    if action_mask is not None:
        log_ratio = log_ratio * action_mask
    return log_ratio


def agg_loss(loss_mat: torch.Tensor, loss_mask: torch.Tensor, loss_agg_mode: str,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Aggregate a (bs, T) loss matrix to a scalar (verl semantics)."""
    loss_mask = loss_mask.to(loss_mat.dtype)
    if weights is None:
        weights = torch.ones((loss_mask.shape[0],), dtype=loss_mat.dtype,
                             device=loss_mat.device)
    if loss_agg_mode == "token-mean":
        return masked_mean(loss_mat * weights[:, None], loss_mask)
    seq_losses = masked_mean(loss_mat, loss_mask, axis=-1)  # per-seq masked mean
    valid = (loss_mask > 0).any(dim=-1).to(loss_mat.dtype)
    if loss_agg_mode == "seq-mean-token-sum":
        return (seq_losses * weights * valid).sum() / (valid.sum() + EPS)
    if loss_agg_mode == "seq-mean-token-mean":
        seq_losses = seq_losses / (loss_mask.sum(dim=-1) + EPS)
        return (seq_losses * weights * valid).sum() / (valid.sum() + EPS)
    if loss_agg_mode == "seq-mean-token-sum-norm":
        return (seq_losses * weights * valid).sum() / loss_mask.shape[-1]
    raise ValueError(f"Invalid loss_agg_mode: {loss_agg_mode}")


# ------------------------------------------------------------------ advantages

def _reverse_scan(x: torch.Tensor, decay: float) -> torch.Tensor:
    """out[:, t] = x[:, t] + decay * out[:, t + 1] along the last axis (the
    JAX package's reversed lax.scan)."""
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[:, 0])
    for t in range(x.shape[-1] - 1, -1, -1):
        carry = x[:, t] + decay * carry
        out[:, t] = carry
    return out


def discounted_returns(token_level_rewards: torch.Tensor, gamma: float) -> torch.Tensor:
    """Reverse cumulative discounted sum along the last axis."""
    return _reverse_scan(token_level_rewards, gamma)


def compute_reinforce_return(token_level_rewards: torch.Tensor, gamma: float,
                             lambd: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    adv = discounted_returns(token_level_rewards, gamma)
    return adv, adv


def compute_gae_advantage_return(token_level_rewards: torch.Tensor, values: torch.Tensor,
                                 gamma: float, lambd: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    next_values = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], dim=-1)
    delta = token_level_rewards + gamma * next_values - values
    advantages = _reverse_scan(delta, gamma * lambd)
    return advantages, advantages + values


def expand_to_token_level(response_level_rewards: torch.Tensor, attention_mask: torch.Tensor,
                          position_ids: torch.Tensor) -> torch.Tensor:
    """Place the scalar reward at the eos index (argmax of position * mask over
    a right-padded row; the first M-RoPE axis for 3-D ids); token rewards for
    tokens 1: ."""
    if position_ids.dim() == 3:
        position_ids = position_ids[:, 0]
    eos_idx = torch.argmax(position_ids * attention_mask, dim=-1)
    token_rewards = torch.zeros(attention_mask.shape, dtype=response_level_rewards.dtype,
                                device=response_level_rewards.device)
    rows = torch.arange(attention_mask.shape[0], device=eos_idx.device)
    token_rewards[rows, eos_idx] = response_level_rewards
    return token_rewards[:, 1:]


def batch_reward_norm(rewards: torch.Tensor, div_std: bool = True) -> torch.Tensor:
    out = rewards - rewards.mean()
    if div_std:
        out = out / (rewards.std(correction=1) + 1e-6)
    return out


def group_reward_norm(rewards: torch.Tensor, n_sample: int, div_std: bool = True,
                      div_std_global: bool = False) -> torch.Tensor:
    """GRPO group normalization: groups are contiguous blocks of n_sample."""
    assert n_sample > 1, "n_sample must > 1"
    shaped = rewards.reshape(*rewards.shape[:-1], -1, n_sample)
    shaped = shaped - shaped.mean(dim=-1, keepdim=True)
    if div_std:
        if div_std_global:
            shaped = shaped / (shaped.std(correction=1) + 1e-6)
        else:
            shaped = shaped / (shaped.std(dim=-1, keepdim=True, correction=1) + 1e-6)
    return shaped.reshape(rewards.shape)


def difficulty_mask(scores: torch.Tensor, n_sample: int, low_threshold: float = 0.1,
                    high_threshold: float = 0.95) -> torch.Tensor:
    """Keep samples whose group-mean score is strictly inside (low, high)."""
    if n_sample <= 1:
        return torch.ones_like(scores)
    shaped = scores.reshape(*scores.shape[:-1], -1, n_sample)
    group_mean = shaped.mean(dim=-1, keepdim=True)
    mask = (group_mean > low_threshold) & (group_mean < high_threshold)
    return mask.expand(shaped.shape).reshape(scores.shape).to(scores.dtype)


def compute_advantage(
    token_level_rewards: torch.Tensor,
    response_mask: torch.Tensor,
    *,
    adv_estimator: str = "grpo",
    gamma: float = 1.0,
    lambd: float = 1.0,
    values: Optional[torch.Tensor] = None,
    advantage_clip: Optional[float] = None,
    whiten_advantages: bool = False,
    whiten_rewards: bool = False,
) -> Dict[str, torch.Tensor]:
    """Returns token_level_rewards / advantages / returns / raw_advantages,
    plus advantage_clip_frac with advantage_clip."""
    token_level_rewards = token_level_rewards.float()
    response_mask = response_mask.float()
    if whiten_rewards:
        token_level_rewards = masked_whiten(token_level_rewards, response_mask)
    token_level_rewards = token_level_rewards * response_mask

    if adv_estimator == "gae":
        assert values is not None
        values = values.float() * response_mask
        advantages, returns = compute_gae_advantage_return(token_level_rewards, values,
                                                           gamma, lambd)
    elif adv_estimator in ("reinforce", "grpo"):
        advantages, returns = compute_reinforce_return(token_level_rewards, gamma, lambd)
    else:
        raise NotImplementedError(adv_estimator)

    raw_advantages = advantages
    if whiten_advantages:
        advantages = masked_whiten(advantages, response_mask)
    advantages = advantages * response_mask

    out = {"token_level_rewards": token_level_rewards, "raw_advantages": raw_advantages,
           "returns": returns}
    if advantage_clip is not None:
        out["advantage_clip_frac"] = ((advantages > advantage_clip)
                                      | (advantages < -advantage_clip)).float().mean()
        advantages = torch.clamp(advantages, -advantage_clip, advantage_clip)
    out["advantages"] = advantages
    return out


def apply_kl_penalty(
    response_level_rewards: torch.Tensor,
    attention_mask: torch.Tensor,
    position_ids: torch.Tensor,
    response_mask_shifted: torch.Tensor,
    old_log_probs: torch.Tensor,
    ref_log_probs: Optional[torch.Tensor],
    kl_coef: float,
    kl_penalty: str = "kl",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token rewards = reward at eos − β·KL. Returns (token_level_rewards
    (bs, T-1), current_kl scalar)."""
    token_level = expand_to_token_level(response_level_rewards, attention_mask, position_ids)
    if ref_log_probs is not None:
        kld = compute_approx_kl(old_log_probs, ref_log_probs, response_mask_shifted, kl_penalty)
        beta = kl_coef
    else:
        kld = torch.zeros(response_mask_shifted.shape, dtype=torch.float32,
                          device=response_mask_shifted.device)
        beta = 0.0
    token_level = token_level - beta * kld
    current_kl = masked_mean(kld, response_mask_shifted, axis=-1).mean()
    return token_level, current_kl


# -------------------------------------------------------------- host-side ops

def pad_to_length(arr: np.ndarray, length: int, pad_value, axis: int = -1) -> np.ndarray:
    """Right-pad (or truncate) along axis."""
    size = arr.shape[axis]
    if size >= length:
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, length)
        return arr[tuple(sl)]
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis if axis >= 0 else arr.ndim + axis] = (0, length - size)
    return np.pad(arr, pad_width, constant_values=pad_value)


def concatenate_input_and_output(input_ids: np.ndarray, output_ids: np.ndarray,
                                 num_return_sequences: int) -> np.ndarray:
    """(bs, P) + (bs*n, R) → (bs*n, P+R) with inputs repeated."""
    rep = np.repeat(input_ids, num_return_sequences, axis=0)
    return np.concatenate([rep, output_ids], axis=1)


def postprocess_generate(
    *,
    input_ids: np.ndarray,          # (bs, P) left-padded prompts
    attention_mask: np.ndarray,     # (bs, P) left-pad mask
    position_ids: np.ndarray,       # (bs, P) or (bs, 3, P) M-RoPE
    output: np.ndarray,             # (bs*n, L>=P) full sequences: prompt + response
    num_return_sequences: int,
    sequence_length: int,
    eos_token_id: int,
    pad_token_id: int,
    fill_eos_token: bool = False,
    prompt_id: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Left-padded prompt + right-padded response → one right-padded layout
    with masks and extended position ids: each row is rolled left by its
    prompt's left-pad amount, and 3-D M-RoPE ids are extended by arange past
    their last prompt value."""
    output = np.array(output)
    if fill_eos_token:
        last = output.shape[1] - 1
        need = output[:, last] != pad_token_id
        output[need, last] = eos_token_id

    bs, P = input_ids.shape
    assert output.shape[0] == bs * num_return_sequences
    output = pad_to_length(output, sequence_length, pad_token_id)
    L = sequence_length

    prompt = output[:, :P].copy()
    response = output[:, P:].copy()

    attn = np.repeat(attention_mask, num_return_sequences, axis=0)  # (out_bs, P)
    response_mask_r = (response != pad_token_id).astype(attn.dtype)
    full_attn = np.concatenate([attn, response_mask_r], axis=-1)    # (out_bs, L)
    assert full_attn.any(axis=1).all(), "all-zero attention row"

    mrope = position_ids.ndim == 3
    if mrope:
        pos = np.repeat(position_ids, num_return_sequences, axis=0)  # (out_bs, 3, P)
        delta = np.arange(1, L - P + 1).reshape(1, 1, -1)
        full_pos = np.concatenate([pos, pos[..., -1:] + delta], axis=-1)

    shift = full_attn.argmax(axis=1)                                 # left-pad amount
    valid_len = full_attn.sum(axis=1).astype(np.int64)
    resp_len = response_mask_r.sum(axis=1).astype(np.int64)

    # roll rows left by `shift` via gather; positions past the end read the
    # last column and are overwritten by the re-pad below
    gather = np.minimum(np.arange(L)[None, :] + shift[:, None], L - 1)
    output = np.take_along_axis(output, gather, axis=1)
    cols = np.arange(L)[None, :]
    new_attn = (cols < valid_len[:, None]).astype(full_attn.dtype)
    new_resp_mask = ((cols >= (valid_len - resp_len)[:, None]) & (cols < valid_len[:, None])
                     ).astype(full_attn.dtype)
    output = np.where(new_attn.astype(bool), output, pad_token_id)

    if mrope:
        new_pos = np.take_along_axis(
            full_pos, np.broadcast_to(gather[:, None, :], full_pos.shape), axis=2)
    else:
        new_pos = np.clip(np.cumsum(new_attn, axis=-1) - 1, 0, None).astype(np.int64)

    result = {
        "prompts": prompt,
        "responses": response,
        "input_ids": output,
        "attention_mask": new_attn,
        "position_ids": new_pos,
        "prompt_mask": ((new_attn == 1) & (new_resp_mask == 0)).astype(new_attn.dtype),
        "response_mask": new_resp_mask,
    }
    if prompt_id is not None:
        result["prompt_id"] = np.repeat(np.asarray(prompt_id).reshape(-1), num_return_sequences)
    return result
