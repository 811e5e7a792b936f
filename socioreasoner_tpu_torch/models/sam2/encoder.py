"""SAM2 image encoder: Hiera backbone + FPN neck in PyTorch.

The counterpart of socioreasoner_tpu/models/sam2/encoder.py. Activations are
NHWC and the parameters keep the JAX package's layouts (linear weights
(in, out), conv kernels HWIO), so the weight bridge copies the JAX tree leaf
for leaf; `conv2d` hands cuDNN/ATen an NCHW view of the NHWC tensor (the
channels-last memory format) and an OIHW view of the kernel. Matmuls promote
mixed operands to the wider dtype, as jnp does, and the attention keeps the
JAX dtype flow: f32 logits, softmax, probabilities cast back to the input
dtype before P·V. There is no hand kernel here: the JAX package runs plain
XLA at this attention too.

The windowed absolute position embedding is computed on the host (numpy,
the torch-style bicubic interpolation of the JAX package's copy).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import HieraConfig, Sam2Config


# ----------------------------------------------------- host: torch-style bicubic

def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    w = np.where(at <= 1, (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1,
                 np.where(at < 2, a * at ** 3 - 5 * a * at ** 2 + 8 * a * at - 4 * a, 0.0))
    return w


def bicubic_resize_hw(arr: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Separable bicubic (torch F.interpolate mode='bicubic', align_corners=False,
    a=-0.75, border-replicate). arr: (H, W, C)."""

    def resize_axis(x: np.ndarray, out_len: int) -> np.ndarray:
        # resize axis 0
        in_len = x.shape[0]
        if in_len == out_len:
            return x
        scale = in_len / out_len
        coord = (np.arange(out_len) + 0.5) * scale - 0.5
        base = np.floor(coord).astype(int)
        frac = coord - base
        taps = np.stack([base - 1, base, base + 1, base + 2], axis=1)  # (out, 4)
        weights = _cubic_kernel(frac[:, None] - np.array([-1, 0, 1, 2])[None, :])
        taps = np.clip(taps, 0, in_len - 1)
        gathered = x[taps.reshape(-1)].reshape(out_len, 4, *x.shape[1:])
        w = weights.reshape(out_len, 4, *([1] * (x.ndim - 1)))
        return (gathered * w).sum(axis=1)

    out = resize_axis(arr, out_h)
    out = np.moveaxis(resize_axis(np.moveaxis(out, 1, 0), out_w), 0, 1)
    return out


def host_f64(t) -> np.ndarray:
    """A parameter (tensor or array) as a float64 numpy array on the host."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64).numpy()
    return np.asarray(t, np.float64)


def hiera_pos_embed(params: Dict, cfg: HieraConfig, h: int, w: int) -> np.ndarray:
    """(1, h, w, C) absolute pos embed in float64: bicubic-resized background
    + tiled window embed (ref Sam2HieraDetModel._get_pos_embed). The caller
    casts it to the parameters' dtype."""
    bg = host_f64(params["pos_embed"])            # (1, C, bgH, bgW) torch layout
    win = host_f64(params["pos_embed_window"])    # (1, C, ws, ws)
    resized = bicubic_resize_hw(np.transpose(bg[0], (1, 2, 0)), h, w)
    win_hwc = np.transpose(win[0], (1, 2, 0))
    ws_h, ws_w = win_hwc.shape[:2]
    tiled = np.tile(win_hwc, (h // ws_h, w // ws_w, 1))
    return (resized + tiled)[None]


# --------------------------------------------------------------- device: layers

def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with mixed float operands promoted to the wider dtype (jnp's
    rule; torch.matmul refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return matmul(x, w) + b


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-6):
    """Last-axis layer norm computed in at least f32, cast back to x's dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * w + b).to(x.dtype)


def conv2d(x: torch.Tensor, kernel: torch.Tensor, bias=None, stride=(1, 1),
           padding=(0, 0)) -> torch.Tensor:
    """NHWC conv; kernel HWIO (symmetric `padding` per spatial axis)."""
    dt = torch.promote_types(x.dtype, kernel.dtype)
    out = F.conv2d(x.to(dt).permute(0, 3, 1, 2), kernel.to(dt).permute(3, 2, 0, 1),
                   stride=tuple(stride), padding=tuple(padding))
    out = out.permute(0, 2, 3, 1)
    return out if bias is None else out + bias


def mlp2(x, p, act=F.gelu):
    """Sam2FeedForward with num_layers=2: proj_in → act (exact GELU) → proj_out."""
    return linear(act(linear(x, p["fc1_w"], p["fc1_b"])), p["fc2_w"], p["fc2_b"])


def _window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) → (B*nW, ws, ws, C) with bottom/right zero pad."""
    B, H, W, C = x.shape
    pad_h = (-H) % ws
    pad_w = (-W) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)
    return x, (Hp, Wp)


def _window_unpartition(x: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                        hw: Tuple[int, int]) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    B = x.shape[0] // (Hp * Wp // ws // ws)
    x = x.reshape(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def _max_pool2(x: torch.Tensor, stride: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) max-pool kernel==stride, VALID (Hiera q-pool)."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=tuple(stride),
                       stride=tuple(stride))
    return out.permute(0, 2, 3, 1)


def attention(q, k, v, n_heads: int, scale: float):
    """(B, Lq, C) x (B, Lk, C) multi-head attention: f32 logits and
    softmax, probabilities in q's dtype for P·V."""
    B, Lq, C = q.shape
    Lk = k.shape[1]
    D = C // n_heads
    qh = q.reshape(B, Lq, n_heads, D).transpose(1, 2)
    kh = k.reshape(B, Lk, n_heads, D).transpose(1, 2)
    vh = v.reshape(B, Lk, n_heads, D).transpose(1, 2)
    acc = torch.promote_types(torch.promote_types(q.dtype, k.dtype), torch.float32)
    logits = torch.matmul(qh.to(acc), kh.to(acc).transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = matmul(probs, vh)                                   # (B, h, Lq, D)
    return out.transpose(1, 2).reshape(B, Lq, C)


def multiscale_block(cfg: HieraConfig, p: Dict, x: torch.Tensor, *,
                     dim: int, dim_out: int, n_heads: int, window_size: int,
                     query_stride) -> torch.Tensor:
    """One Hiera block (ref Sam2MultiScaleBlock). x: (B, H, W, dim)."""
    residual = x
    h = layer_norm(x, p["ln1_w"], p["ln1_b"], cfg.layer_norm_eps)
    if dim != dim_out:
        proj = linear(h, p["proj_w"], p["proj_b"])
        residual = _max_pool2(proj, query_stride) if query_stride else proj

    B, H, W, _ = h.shape
    ws = window_size
    if ws > 0:
        h, pad_hw = _window_partition(h, ws)

    # attention with optional q-pool (ref Sam2MultiScaleAttention)
    bsz, hh, ww, _ = h.shape
    qkv = linear(h, p["qkv_w"], p["qkv_b"]).reshape(bsz, hh * ww, 3, dim_out)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if query_stride:
        q = _max_pool2(q.reshape(bsz, hh, ww, dim_out), query_stride)
        hh, ww = q.shape[1:3]
        q = q.reshape(bsz, hh * ww, dim_out)
    scale = (dim_out // n_heads) ** -0.5
    attn = attention(q, k, v, n_heads, scale)
    h = linear(attn.reshape(bsz, hh, ww, dim_out), p["o_w"], p["o_b"])

    if query_stride:
        ws_eff = ws // query_stride[0] if ws > 0 else 0
        Hn, Wn = residual.shape[1:3]
        if ws > 0:
            pad_hw = (Hn + (-Hn) % ws_eff, Wn + (-Wn) % ws_eff)
            h = _window_unpartition(h, ws_eff, pad_hw, (Hn, Wn))
    elif ws > 0:
        h = _window_unpartition(h, ws, pad_hw, (H, W))

    x = residual + h
    h2 = layer_norm(x, p["ln2_w"], p["ln2_b"], cfg.layer_norm_eps)
    return x + mlp2(h2, p["mlp"])


def hiera_forward(cfg: HieraConfig, params: Dict, pixel_values: torch.Tensor,
                  pos_embed: torch.Tensor) -> List[torch.Tensor]:
    """pixel_values: (B, H, W, 3) → list of per-stage features (B, h, w, c)."""
    x = conv2d(pixel_values, params["patch_w"], params["patch_b"],
               stride=cfg.patch_stride, padding=cfg.patch_padding)
    x = x + pos_embed.to(x.dtype)

    outputs = []
    block_idx = 0
    for stage_idx, n_blocks in enumerate(cfg.blocks_per_stage):
        for bi in range(n_blocks):
            first = stage_idx > 0 and bi == 0
            dim = cfg.embed_dim_per_stage[stage_idx - 1] if first else cfg.embed_dim_per_stage[stage_idx]
            dim_out = cfg.embed_dim_per_stage[stage_idx]
            ws = cfg.window_size_per_stage[stage_idx - 1] if first else cfg.window_size_per_stage[stage_idx]
            if block_idx in cfg.global_attention_blocks:
                ws = 0
            qs = cfg.query_stride if (0 < stage_idx <= cfg.num_query_pool_stages and bi == 0) else None
            x = multiscale_block(cfg, params["blocks"][block_idx], x,
                                 dim=dim, dim_out=dim_out,
                                 n_heads=cfg.num_heads_per_stage[stage_idx],
                                 window_size=ws, query_stride=qs)
            block_idx += 1
        outputs.append(x)
    return outputs


# --------------------------------------------------------------------- FPN neck

def sine_position_encoding(h: int, w: int, num_pos_feats: int,
                           temperature: float = 10000.0) -> np.ndarray:
    """(1, h, w, 2*num_pos_feats) normalized sine PE (ref Sam2SinePositionEmbedding,
    normalize=True, scale=2π). Host-precomputable (no mask). The image path
    does not use it (the neck's outputs carry no position encoding there)."""
    scale = 2 * math.pi
    y = np.arange(1, h + 1, dtype=np.float64)[:, None] * np.ones((1, w))
    x = np.ones((h, 1)) * np.arange(1, w + 1, dtype=np.float64)[None, :]
    eps = 1e-6
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3
                     ).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3
                     ).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1)[None]


def neck_forward(config: Sam2Config, params: Dict, stage_outputs: List[torch.Tensor]
                 ) -> List[torch.Tensor]:
    """FPN (ref Sam2VisionNeck): lateral 1x1 convs (index n-i for stage i),
    top-down nearest×2 additions for levels in fpn_top_down_levels. Returns
    the maps lowest resolution first."""
    n = len(params["convs"]) - 1
    outs = []
    prev = None
    for i in range(n, -1, -1):
        lateral = conv2d(stage_outputs[i], params["convs"][n - i]["w"],
                         params["convs"][n - i]["b"])
        if i not in config.fpn_top_down_levels or i == n:
            prev = lateral
        else:
            up = prev.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            prev = lateral + up
        outs.append(prev)
    return outs


def image_encoder_forward(config: Sam2Config, params: Dict,
                          pixel_values: torch.Tensor, pos_embed: torch.Tensor
                          ) -> List[torch.Tensor]:
    """Full encoder: returns `num_feature_levels` FPN maps ordered
    HIGH→LOW resolution (HF Sam2VisionModel ordering)."""
    stages = hiera_forward(config.hiera, params["hiera"], pixel_values, pos_embed)
    fpn = neck_forward(config, params["neck"], stages)
    return fpn[-config.num_feature_levels:][::-1]
