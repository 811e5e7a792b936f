"""Vocab-parallel log-probs and entropy over the tp shards of the head, the
counterpart of socioreasoner_tpu/ops/vocab_parallel.py.

Each tp shard holds the logits of its vocabulary block, (..., V_t) on its
own device, in vocabulary order. The statistics are reduced across the
shards with (...)-shaped tensors only, so the whole (..., V) logits never
exist on one device:

  logsumexp: local max → max over shards → local sum(exp) → sum over shards
  label pick: each shard's own block of the vocabulary → sum over shards

The JAX package reduces with psum/pmax inside a shard_map over the "tp" axis;
here the shards' partial results are moved to the labels' device and added
there, in shard order. Differentiable: the max is a constant of the
backward (the log-sum-exp does not depend on it).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _logz(logits: Sequence[torch.Tensor], home: torch.device
          ) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """(the global max, each shard's exp(logits - max), the summed exp)."""
    with torch.no_grad():
        m = logits[0].float().amax(dim=-1).to(home)
        for part in logits[1:]:
            m = torch.maximum(m, part.float().amax(dim=-1).to(home))
    exps = [torch.exp(part.float() - m.to(part.device)[..., None]) for part in logits]
    sumexp = sum(e.sum(dim=-1).to(home) for e in exps)
    return m, exps, sumexp


def vocab_parallel_log_probs(logits: Sequence[torch.Tensor], labels: torch.Tensor
                             ) -> torch.Tensor:
    """logits: the shards' (..., V_t) blocks; labels: (...) global token ids
    → f32 (...) log-probs, on the labels' device."""
    home = labels.device
    m, _, sumexp = _logz(logits, home)
    logz = m + torch.log(sumexp)
    picked, lo = 0, 0
    for part in logits:
        n = part.shape[-1]
        local = labels.to(part.device) - lo
        inside = (local >= 0) & (local < n)
        got = torch.gather(part.float(), -1, local.clamp(0, n - 1)[..., None].long())[..., 0]
        picked = picked + torch.where(inside, got, torch.zeros_like(got)).to(home)
        lo += n
    return picked - logz


def vocab_parallel_entropy(logits: Sequence[torch.Tensor], home: torch.device
                           ) -> torch.Tensor:
    """logits: the shards' (..., V_t) blocks → f32 (...) entropy on `home`:
    logz − E[z], E[z] = Σ exp(z − max)·z / Σ exp(z − max)."""
    m, exps, sumexp = _logz(logits, home)
    logz = m + torch.log(sumexp)
    pz = sum((e * part.float()).sum(dim=-1).to(home) for e, part in zip(exps, logits))
    return logz - pz / sumexp
