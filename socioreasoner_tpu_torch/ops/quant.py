"""Weight-only int8 / int4 and w8a8 quantization for serving, in plain PyTorch.

The counterpart of socioreasoner_tpu/ops/quant.py, with the same layouts so
a quantized JAX tree bridged by ``params_from_numpy`` serves unchanged:

  * int8 (w8a16): symmetric per-output-channel codes, ``w ≈ q * scale``,
    scale over the contraction dim (axis -2 of the (in, out) weights);
  * int4 (w4a16): symmetric group-wise codes, one f32 scale per
    ``INT4_GROUP`` contraction elements per output channel, nibble-packed
    into uint8 with the contraction dim halved (element 2i in the low
    nibble, 2i+1 in the high);
  * w8a8: per-row dynamic int8 activations times the int8 weights, an exact
    int32 accumulate through ``torch._int_mm``, then ``acc·a_scale·w_scale``
    in f32.

Like the JAX package, none of this is a Pallas kernel there (XLA fuses the
dequantisation into the dot), so it stays plain torch here. Eager torch
does not fuse: a w8a16 or w4a16 product materialises the dequantised
weight in the activation dtype for each call.

The scales multiply amax by the float32 reciprocal of 127 (or 7) rather
than divide by the constant: XLA folds the division by a constant into that
multiplication inside every jitted JAX function (the engine, the jitted
quantisers), so the codes and scales here equal the JAX package's bit for
bit. Rounding is half to even on both sides.

Applies to the stacked decoder matmul weights, the LM head and, for the ViT,
the block and merger matmuls. Embeddings, norms, biases and the ViT's patch
embed stay in their float dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# stacked decoder matmul weights eligible for quantization: (L, in, out) or
# (L, E, in, out) for MoE expert stacks; the contraction dim is always -2
QUANT_KEYS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w",
              "s_gate_w", "s_up_w", "s_down_w")

# int4 group size along the contraction dim (GPTQ/AWQ convention)
INT4_GROUP = 128

# vision-tower matmul weights eligible for int8: stacked (depth, in, out)
# block weights and the unstacked merger MLP; patch_embed stays float
VISION_QUANT_KEYS = ("qkv_w", "proj_w", "fc1_w", "fc2_w",
                     "gate_w", "up_w", "down_w")
VISION_MERGER_KEYS = ("merger_fc1_w", "merger_fc2_w")

# the float32 reciprocals XLA folds the constant divisions into (exact as
# Python floats, and an f32 tensor times a Python float multiplies in f32)
_INV127 = float(torch.tensor(1.0) / 127.0)
_INV7 = float(torch.tensor(1.0) / 7.0)

# torch._int_mm on CUDA takes more than 16 rows and K, N multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def _scale(amax: torch.Tensor, inv: float) -> torch.Tensor:
    return amax.clamp_min(1e-8) * inv


def quantize_weight(w: torch.Tensor, axis: int = -2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: w ≈ q * scale, the scale broadcast
    over `axis` (the contraction dim). Returns (int8 q, f32 scale with `axis`
    removed)."""
    wf = w.float()
    scale = _scale(wf.abs().amax(dim=axis, keepdim=True), _INV127)
    q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def quantize_weight_int4(w: torch.Tensor, axis: int = -2,
                         group: int = INT4_GROUP) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric group-wise int4: one f32 scale per `group` contraction
    elements per output channel. Returns (uint8 nibble-packed q with the
    contraction dim halved, f32 scale with the contraction dim reduced to
    the number of groups)."""
    if axis != -2:
        raise ValueError("int4 quantization expects contraction axis -2")
    K, N = w.shape[-2], w.shape[-1]
    group = min(group, K)                        # tiny test models: K < 128
    if K % group:
        raise ValueError(f"contraction dim {K} not divisible by group {group}")
    if K % 2:
        raise ValueError(f"contraction dim {K} must be even for int4 packing")
    wg = w.float().reshape(*w.shape[:-2], K // group, group, N)
    scale = _scale(wg.abs().amax(dim=-2, keepdim=True), _INV7)
    q = torch.round(wg / scale).clamp_(-8, 7).to(torch.int32)
    return pack_int4(q.reshape(w.shape)), scale.squeeze(-2)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., K, N) int values in [-8, 7] → (..., K//2, N) uint8, element 2i
    in the low nibble and 2i+1 in the high (unpack_int4's inverse)."""
    K, N = q.shape[-2], q.shape[-1]
    qq = q.to(torch.int32).reshape(*q.shape[:-2], K // 2, 2, N) & 0xF
    return (qq[..., 0, :] | (qq[..., 1, :] << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """(..., K//2, N) uint8 nibble-packed → (..., K, N) int8 in [-8, 7]."""
    lo = (p & 0x0F).to(torch.int8)
    hi = (p >> 4).to(torch.int8)
    lo = (lo ^ 8) - 8                            # sign-extend the nibble
    hi = (hi ^ 8) - 8
    w = torch.stack([lo, hi], dim=-2)            # (..., K//2, 2, N)
    return w.reshape(*p.shape[:-2], 2 * p.shape[-2], p.shape[-1])


def _matmul_int4(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """h @ dequant(unpack(q), scale) with group-wise scales (the group is
    inferred from the scale shape)."""
    K, N = 2 * q.shape[-2], q.shape[-1]
    G = scale.shape[-2]
    wdq = (unpack_int4(q).float().reshape(*q.shape[:-2], G, K // G, N)
           * scale[..., :, None, :]).reshape(*q.shape[:-2], K, N).to(h.dtype)
    return h @ wdq


def quantize_act(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8: h ≈ q * scale, one f32 scale per row
    over the last (contraction) dim."""
    hf = h.float()
    scale = _scale(hf.abs().amax(dim=-1, keepdim=True), _INV127)
    q = torch.round(hf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if x.shape[dim] == size:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, size - x.shape[dim]]
    return torch.nn.functional.pad(x, pad)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) × int8 (K, N) → int32 (M, N) through torch._int_mm.
    The operands are zero-padded at call time to the CUDA shape rules (more
    than 16 rows, K and N multiples of 8): zero rows and zero contraction
    terms add nothing, and the padded rows and columns are sliced off.
    b is laid out column-major at call time, as (N, K) rows: with a
    row-major b, CUDA takes a slow path (on an H100, ~5x the time of the
    column-major product, the copy included)."""
    M, K = a.shape
    N = b.shape[1]
    Mp = max(M, _INT_MM_MIN_ROWS)
    Kp = -(-K // _INT_MM_ALIGN) * _INT_MM_ALIGN
    Np = -(-N // _INT_MM_ALIGN) * _INT_MM_ALIGN
    a = _pad_to(_pad_to(a, 0, Mp), 1, Kp).contiguous()
    b = _pad_to(_pad_to(b, 0, Kp), 1, Np).t().contiguous().t()
    return torch._int_mm(a, b)[:M, :N]


def matmul_w8a8(h: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """h (…, K) × w_q (K, N) int8 → (…, N) in h's dtype: per-row int8
    activations, an exact int32 accumulate, then act-row × weight-channel
    scales in f32."""
    ha, a_scale = quantize_act(h)
    acc = int_matmul(ha.reshape(-1, ha.shape[-1]), w_q)
    acc = acc.reshape(*ha.shape[:-1], w_q.shape[-1])
    return (acc.float() * a_scale * w_scale).to(h.dtype)


def matmul_q(h: torch.Tensor, p: Dict, name: str, a8: bool = False) -> torch.Tensor:
    """h @ p[name], dequantising int8 (per-output-channel scale) or int4
    (group-wise scale) weights through p[f"{name}_scale"]. a8 (int8 weights
    only) runs the product as w8a8; use it for multi-token passes."""
    w = p[name]
    if w.dtype == torch.int8:
        if a8:
            return matmul_w8a8(h, w, p[name + "_scale"])
        y = h @ w.to(h.dtype)
        return (y * p[name + "_scale"]).to(h.dtype)
    if w.dtype == torch.uint8:                   # nibble-packed int4
        return _matmul_int4(h, w, p[name + "_scale"])
    return h @ w


def _per_slice(quant, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """quant over a stacked (L, ..., in, out) leaf one layer at a time: the
    codes are per output channel, so the result equals one call over the
    stack, with one layer's f32 temporaries instead of the whole stack's."""
    if w.dim() <= 2:
        return quant(w, axis=-2)
    parts = [quant(w[i], axis=-2) for i in range(w.shape[0])]
    q = torch.stack([a for a, _ in parts])
    s = torch.stack([b for _, b in parts])
    return q, s


def quantize_decode_params(params: Dict, mode: str = "int8",
                           inplace: bool = False) -> Dict:
    """A params tree with the decoder matmul stacks and the LM head quantized
    (`mode`: "int8" per output channel, "int4" group-wise).

    An untied `lm_head` (H, V) is quantized in place of itself; a tied model
    gets a derived `lm_head_q` (H, V) / `lm_head_scale` from the embedding
    rows (embed stays float so the token gather is exact).

    inplace=True replaces each float stack in the caller's dicts the moment
    its quantized copy exists, so a caller holding the only reference frees
    it leaf by leaf (single-copy serving). inplace=False leaves the caller's
    tree as it was and shares its unquantized leaves."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"quantize_decode_params: unknown mode {mode!r}")
    quant = quantize_weight if mode == "int8" else quantize_weight_int4
    out = params if inplace else dict(params)
    layers = params["layers"] if inplace else dict(params["layers"])
    for name in QUANT_KEYS:
        if name in layers:
            q, s = _per_slice(quant, layers[name])
            layers[name] = q
            layers[name + "_scale"] = s
    out["layers"] = layers
    if "lm_head" in params:                      # (H, V): out channel = vocab
        q, s = quant(params["lm_head"], axis=-2)
        out["lm_head"] = q
        out["lm_head_scale"] = s
    elif mode == "int8":                         # tied: head = embed.T
        q, s = quantize_weight(params["embed"], axis=-1)   # per vocab row
        out["lm_head_q"] = q.T.contiguous()      # stored (H, V), as in JAX
        out["lm_head_scale"] = s                 # (V,)
    else:                                        # tied int4: groups along H
        q, s = quantize_weight_int4(params["embed"].T)     # (H, V), (G, V)
        out["lm_head_q"] = q
        out["lm_head_scale"] = s
    return out


def quantize_vision_params(vision: Dict, inplace: bool = False) -> Dict:
    """int8 per-output-channel codes for the ViT's matmul weights (the tower
    then runs w8a8). Norms, biases and patch_embed stay float. Same inplace
    semantics as quantize_decode_params."""
    out = vision if inplace else dict(vision)
    blocks = vision["blocks"] if inplace else dict(vision["blocks"])
    for name in VISION_QUANT_KEYS:
        if name in blocks and blocks[name].dtype != torch.int8:
            q, s = _per_slice(quantize_weight, blocks[name])
            blocks[name] = q
            blocks[name + "_scale"] = s
    out["blocks"] = blocks
    for name in VISION_MERGER_KEYS:
        if name in vision and vision[name].dtype != torch.int8:
            q, s = quantize_weight(vision[name], axis=-2)
            out[name] = q
            out[name + "_scale"] = s
    return out


def vision_prequantized(vision: Dict) -> bool:
    blocks = vision.get("blocks", {})
    return any(name + "_scale" in blocks for name in VISION_QUANT_KEYS)


def params_prequantized(params: Dict) -> bool:
    """True if `params` already carries quantized decoder stacks: the
    single-copy serving path, where prefill and decode share one tree."""
    layers = params.get("layers", {})
    return any(name + "_scale" in layers for name in QUANT_KEYS)


def head_logits(params: Dict, hidden: torch.Tensor) -> torch.Tensor:
    """LM head projection for every layout: untied float / int8 / int4,
    tied float (embed.T) and tied quantized (lm_head_q)."""
    head = params.get("lm_head")
    if head is not None:
        if head.dtype == torch.int8:
            return (hidden @ head.to(hidden.dtype)) * params["lm_head_scale"]
        if head.dtype == torch.uint8:            # nibble-packed int4
            return _matmul_int4(hidden, head, params["lm_head_scale"])
        return hidden @ head
    head_q = params.get("lm_head_q")
    if head_q is not None:                       # tied + quantized, (H, V)
        if head_q.dtype == torch.uint8:
            return _matmul_int4(hidden, head_q, params["lm_head_scale"])
        return (hidden @ head_q.to(hidden.dtype)) * params["lm_head_scale"]
    return hidden @ params["embed"].T
