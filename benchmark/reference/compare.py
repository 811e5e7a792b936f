"""The comparisons that decide `correct`, and the lower-precision controls.

A served model is judged by its greedy tokens: at each served position,
the gap by which the served token's logit lies below the reference's best
(0 where they agree; a near tie that rounding flipped gives a small gap, a
wrong token a large one). The widest gap over the sample is the number
compared.

A control is the reference put in the program's place in the nearest
precision below the configuration's: int8 weights for a bf16 model, int4
for an int8 one, products in bf16. It need not decode: at each position of
the same prompts and tokens it reads the gap of the token that it puts
first.

Plain PyTorch; imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from .decoder import logits_blocks

INT8_MAX = 127.0


def int8_channel(name: str, w: torch.Tensor) -> torch.Tensor:
    """Matrices (in, out) through symmetric int8 codes, one scale an output
    column (amax over the input axis / 127); vectors unchanged."""
    if w.dim() < 2 or name.endswith("_ln") or name.endswith("_b"):
        return w
    wf = w.float()
    scale = (wf.abs().amax(dim=-2, keepdim=True) / INT8_MAX).clamp(min=1e-12)
    return (torch.round(wf / scale).clamp(-INT8_MAX, INT8_MAX) * scale)


def int4_groups(group: int = 128) -> Callable:
    """Matrices (in, out) through symmetric int4 codes (-7..7), one scale a
    group of `group` input rows and output column."""
    def fn(name: str, w: torch.Tensor) -> torch.Tensor:
        if w.dim() < 2 or name.endswith("_ln") or name.endswith("_b"):
            return w
        wf = w.float()
        n_in, n_out = wf.shape[-2], wf.shape[-1]
        g = group if n_in % group == 0 else n_in
        x = wf.reshape(*wf.shape[:-2], n_in // g, g, n_out)
        scale = (x.abs().amax(dim=-2, keepdim=True) / 7.0).clamp(min=1e-12)
        return (torch.round(x / scale).clamp(-7, 7) * scale).reshape(wf.shape)
    return fn


def served_gaps(hidden: torch.Tensor, head: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: the reference's best logit minus its logit of the
    served token (float32, >= 0)."""
    out = torch.empty(hidden.shape[0], dtype=torch.float32, device=hidden.device)
    for a, lg in logits_blocks(hidden, head):
        tok = tokens[a:a + lg.shape[0]]
        out[a:a + lg.shape[0]] = lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]
    return out


def control_gaps(ref_hidden: torch.Tensor, ref_head: torch.Tensor,
                 ctl_hidden: torch.Tensor, ctl_head: torch.Tensor) -> torch.Tensor:
    """Per position: the reference's best logit minus its logit of the
    token that the control puts first."""
    firsts = torch.cat([lg.argmax(dim=-1) for _, lg in logits_blocks(ctl_hidden, ctl_head)])
    return served_gaps(ref_hidden, ref_head, firsts)


def check(name: str, value: float, limit: float) -> Dict:
    return {name: {"value": float(value), "limit": float(limit),
                   "ok": bool(value <= limit)}}
