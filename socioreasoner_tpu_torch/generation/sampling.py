"""Token sampling — per-slot temperature / top-k / top-p in PyTorch.

The counterpart of socioreasoner_tpu/generation/sampling.py. Per-slot
parameters are tensors, so one call serves a batch that mixes greedy and
stochastic requests. Candidates are the exact torch.topk over
MAX_CANDIDATES tokens (the JAX package's exact mode), so greedy decoding
agrees with the JAX package token for token; random draws come from an
explicit torch.Generator and agree with JAX only in distribution.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0               # 0 = disabled
    max_new_tokens: int = 512
    do_sample: bool = True
    # per-request stop tokens, unioned with the model config's stop set
    stop_token_ids: tuple = ()

    @classmethod
    def from_generating_args(cls, args) -> "SamplingParams":
        do_sample = bool(getattr(args, "do_sample", True)) and args.temperature > 0
        return cls(temperature=max(args.temperature, 1e-5), top_p=args.top_p,
                   top_k=args.top_k, max_new_tokens=args.max_new_tokens,
                   do_sample=do_sample,
                   stop_token_ids=tuple(getattr(args, "stop_token_ids", ()) or ()))


MAX_CANDIDATES = 256   # sampling candidate pool


def sample_tokens(
    logits: torch.Tensor,         # (B, V) float
    generator: torch.Generator,   # on logits.device
    temperature: torch.Tensor,    # (B,) — 0/negative → greedy
    top_p: torch.Tensor,          # (B,)
    top_k: torch.Tensor,          # (B,) int — 0 → disabled
) -> torch.Tensor:
    """Returns (B,) sampled token ids (int64). Greedy where temperature <= 0.

    Sampling happens within the MAX_CANDIDATES most likely tokens: exact for
    top_k <= 256; the nucleus mass is measured against the FULL softmax
    (logsumexp over V), so it matches HF whenever the nucleus fits the pool."""
    B, V = logits.shape
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)

    scaled = logits / temperature.float().clamp(min=1e-5)[:, None]
    K = min(MAX_CANDIDATES, V)
    vals, idx = torch.topk(scaled, K, dim=-1)                   # (B, K) descending

    # top-k mask within candidates: position j kept iff j < k (k==0 → keep all)
    pos = torch.arange(K, device=logits.device)[None, :]
    top_k = top_k.to(logits.device)
    topk_mask = torch.where(top_k[:, None] > 0,
                            pos < top_k.clamp(max=K)[:, None],
                            torch.ones_like(pos, dtype=torch.bool))

    # top-p (nucleus): keep the smallest prefix whose cumulative FULL-softmax
    # mass before it is < p, always keeping the top token
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    probs = torch.exp(vals - lse)
    cum = torch.cumsum(probs, dim=-1)
    topp_mask = (cum - probs) < top_p.float()[:, None]

    masked = torch.where(topk_mask & topp_mask, vals,
                         torch.full_like(vals, float("-inf")))
    # categorical draw by the Gumbel-max trick on the generator's uniforms
    u = torch.rand(masked.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    choice = torch.argmax(masked + gumbel, dim=-1)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    return torch.where(temperature.to(logits.device) <= 0, greedy, sampled)
