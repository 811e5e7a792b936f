"""Normalization / activation primitives (float32 statistics), the
counterpart of socioreasoner_tpu/ops/norms.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype)


def swiglu(x: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor,
           down_w: torch.Tensor, gate_b=None, up_b=None, down_b=None) -> torch.Tensor:
    g = x @ gate_w
    u = x @ up_w
    if gate_b is not None:
        g = g + gate_b
    if up_b is not None:
        u = u + up_b
    h = F.silu(g) * u
    out = h @ down_w
    if down_b is not None:
        out = out + down_b
    return out


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — the qwen2_vl ViT activation."""
    return x * torch.sigmoid(1.702 * x)
