"""Sequence packing and the DPO step: the port's counterpart of
socioreasoner_tpu/distributed/sft.py.

  pack_sequences — greedy first-fit of {input_ids, loss_mask} samples into
                   rows of max_len, positions restarting at each sample;
                   attention stays causal over the whole row, so a packed
                   sample sees the samples before it in its row, as in the
                   JAX package
  make_dpo_step  — the DPO ("sigmoid", with label smoothing), IPO and ORPO
                   losses over summed sequence log-probs, dense attention as
                   in the JAX package's step; the optimizer updates the
                   params in place (trainer.py)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.qwen2_5_vl.config import Qwen25VLConfig
from .trainer import Optimizer, TrainState, _grad_step, _model_log_probs


# ------------------------------------------------------------------- packing

def pack_sequences(samples: List[Dict[str, np.ndarray]], max_len: int,
                   pad_id: int) -> List[Dict[str, np.ndarray]]:
    """Pack samples, longest first, each into the first row with room (a
    sample longer than max_len is cut to it). Each row: input_ids and
    loss_mask (0 on padding), position_ids (3, max_len) counting from 0
    within each sample (1 on padding), attention_mask (ids != pad_id) and
    segment_ids (the sample's number in the row from 1, 0 on padding)."""
    bins: List[List[Dict]] = []
    for s in sorted(samples, key=lambda s: -len(s["input_ids"])):
        n = len(s["input_ids"])
        if n > max_len:
            s = {k: v[:max_len] for k, v in s.items()}
            n = max_len
        for b in bins:
            if sum(len(x["input_ids"]) for x in b) + n <= max_len:
                b.append(s)
                break
        else:
            bins.append([s])

    rows = []
    for b in bins:
        ids = np.full(max_len, pad_id, np.int64)
        loss = np.zeros(max_len, np.int32)
        pos = np.ones((3, max_len), np.int64)
        seg = np.zeros(max_len, np.int32)
        off = 0
        for si, s in enumerate(b):
            n = len(s["input_ids"])
            ids[off:off + n] = s["input_ids"]
            loss[off:off + n] = s.get("loss_mask", np.ones(n, np.int32))
            pos[:, off:off + n] = np.arange(n)
            seg[off:off + n] = si + 1
            off += n
        rows.append({"input_ids": ids, "loss_mask": loss, "position_ids": pos,
                     "attention_mask": (ids != pad_id).astype(np.int64),
                     "segment_ids": seg})
    return rows


# ----------------------------------------------------------------------- DPO

def make_dpo_step(config: Qwen25VLConfig, optimizer: Optimizer, beta: float = 0.1,
                  label_smoothing: float = 0.0, loss_type: str = "sigmoid",
                  remat: bool = True):
    """The preference step. Batch: chosen_* and rejected_* {input_ids,
    attention_mask, position_ids, loss_mask}, and the frozen reference's
    summed log-probs ref_chosen_logps / ref_rejected_logps (B,), which ORPO
    does not read. loss_type: "sigmoid" (DPO) | "ipo" | "orpo". Metrics
    dpo/{loss, chosen_logps, rejected_logps, accuracy, margin, grad_norm}."""

    def seq_logp(params: Dict, prefix: str, batch: Dict) -> torch.Tensor:
        sub = {"input_ids": batch[f"{prefix}_input_ids"],
               "attention_mask": batch[f"{prefix}_attention_mask"],
               "position_ids": batch[f"{prefix}_position_ids"]}
        lp, _ = _model_log_probs(config, params, sub, remat, with_entropy=False)
        mask = batch[f"{prefix}_loss_mask"][:, 1:].float()
        return (lp * mask).sum(dim=-1)

    def loss_fn(params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        pol_c = seq_logp(params, "chosen", batch)
        pol_r = seq_logp(params, "rejected", batch)
        if loss_type == "orpo":
            # the odds-ratio loss, without a reference policy
            margin = pol_c - pol_r
            loss = -F.logsigmoid(beta * margin).mean()
        else:
            margin = ((pol_c - batch["ref_chosen_logps"])
                      - (pol_r - batch["ref_rejected_logps"]))
            if loss_type == "ipo":
                loss = torch.mean((margin - 1 / (2 * beta)) ** 2)
            else:
                loss = -((1 - label_smoothing) * F.logsigmoid(beta * margin)
                         + label_smoothing * F.logsigmoid(-beta * margin)).mean()
        metrics = {"dpo/loss": loss, "dpo/chosen_logps": pol_c.mean(),
                   "dpo/rejected_logps": pol_r.mean(),
                   "dpo/accuracy": (margin > 0).float().mean(), "dpo/margin": margin.mean()}
        return loss, metrics

    def dpo_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        _, metrics = _grad_step(optimizer, state, lambda p: loss_fn(p, batch), "dpo/grad_norm")
        return state, metrics

    return dpo_step
