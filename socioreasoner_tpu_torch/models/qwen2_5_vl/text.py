"""Qwen2.5-VL text decoder (Qwen2 architecture + M-RoPE) in PyTorch.

The counterpart of socioreasoner_tpu/models/qwen2_5_vl/text.py:
  * without a cache, causal attention over the input runs through
    dense_attention, or with use_flash through flash_attention_trainable
    (the trainable kernels: forward with lse, dq, dk/dv) over the valid
    prefix lengths attention_mask.sum(-1); remat recomputes each decoder
    layer in the backward (torch.utils.checkpoint, as jax.checkpoint);
  * with a cache (the decode engine), each layer writes its new K/V rows into
    the stacked (layers, B, Lmax, Hkv, D) buffers IN PLACE — the JAX package
    donates those buffers and XLA updates them in place — then a multi-token
    pass (prefill) runs the flash prefill kernel over the local sequence and a
    one-token pass (decode) runs the paged decode kernel on the stacked cache
    at the layer index. The cache path also serves quantized trees
    (ops/quant.py): every projection goes through matmul_q, w8a8 on
    multi-token passes with act_quant; an int8 cache (with "k_scale" /
    "v_scale") is written with quantize_kv and read by the int8 decode
    kernel, while prefill attends over the raw k/v of the local sequence.

MoE families (qwen2_moe, qwen3_moe, mixtral) replace the MLP by the routed
experts of ops/moe.py on both paths, plus qwen2_moe's sigmoid-gated shared
expert; the uncached decoder returns {"moe_aux": the load-balance loss
summed over layers} in place of the cache for them, as the JAX package does.
Context/pipeline/tensor parallelism and quantized weights on the uncached
path (the JAX package multiplies their codes unscaled there) are not ported
and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ...ops.attention import dense_attention
from ...ops.decode_attention import paged_decode_attention, quantize_kv
from ...ops.flash_attention import flash_attention
from ...ops.flash_attention_bwd import dkv_plan, flash_attention_trainable
from ...ops.moe import moe_mlp
from ...ops.norms import rms_norm, swiglu
from ...ops.quant import matmul_q, params_prequantized
from .config import TextConfig
from .rope import apply_rotary


MOE_KEYS = ("router_w", "gate_w", "up_w", "down_w")


def moe_block(cfg: TextConfig, p: Dict, h2: torch.Tensor):
    """The MoE families' MLP on the post-attention norm h2 (B, L, hidden).
    Returns (the routed experts' output, plus qwen2_moe's shared expert
    behind its sigmoid gate; the layer's load-balance loss)."""
    B, L, Hd = h2.shape
    out, aux = moe_mlp(h2.reshape(B * L, Hd), {k: p[k] for k in MOE_KEYS},
                       cfg.n_experts_per_tok, cfg.norm_topk_prob)
    out = out.reshape(B, L, Hd).to(h2.dtype)
    if cfg.shared_expert_intermediate:
        shared = swiglu(h2, p["s_gate_w"], p["s_up_w"], p["s_down_w"])
        out = out + torch.sigmoid(h2 @ p["sgate_w"]) * shared
    return out, aux


def _qkv(cfg: TextConfig, p: Dict, h: torch.Tensor):
    B, L, _ = h.shape
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q = (h @ p["q_w"] + p["q_b"]).reshape(B, L, H, D)
    k = (h @ p["k_w"] + p["k_b"]).reshape(B, L, Hkv, D)
    v = (h @ p["v_w"] + p["v_b"]).reshape(B, L, Hkv, D)
    if cfg.use_qk_norm:    # qwen3: per-head RMS norm before rotary
        q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps)
    return q, k, v


def decoder_layer(cfg: TextConfig, p: Dict, x, cos, sin, attention_mask,
                  q_positions, use_flash: bool = False, plan=None, lens=None):
    """One uncached layer: causal attention over the input (the trainable
    flash kernels with use_flash over `lens`, the valid prefix of each
    right-padded row -- the postprocessed train batch's layout -- or all
    keys when None, else dense; `plan` is the dk/dv kernel's dkv_plan for
    `lens`). Returns (x, the MoE load-balance loss, or None for a dense
    MLP)."""
    B, L, _ = x.shape
    q, k, v = _qkv(cfg, p, rms_norm(x, p["input_ln"], cfg.rms_norm_eps))
    q, k = apply_rotary(q, k, cos, sin)
    if use_flash:
        out = flash_attention_trainable(q, k, v, lens, True, plan)
    else:
        out = dense_attention(q, k, v, causal=True, attention_mask=attention_mask,
                              q_positions=q_positions)
    x = x + out.reshape(B, L, -1) @ p["o_w"]
    h2 = rms_norm(x, p["post_ln"], cfg.rms_norm_eps)
    if cfg.n_experts:
        out, aux = moe_block(cfg, p, h2)
        return x + out, aux
    return x + swiglu(h2, p["gate_w"], p["up_w"], p["down_w"]), None


def _decoder_cached_unrolled(cfg: TextConfig, params: Dict, x, cos, sin,
                             cache: Dict, cache_positions, act_quant: bool = False):
    """Cache-mode decoder. Writes each layer's K/V rows (and, for an int8
    cache, their scales) into the cache's stacked buffers in place and
    returns (x, cache) with the same buffers."""
    B, L, _ = x.shape
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    k_all, v_all = cache["k"], cache["v"]
    ks_all, vs_all = cache.get("k_scale"), cache.get("v_scale")
    quant = ks_all is not None
    kv_valid = cache["kv_valid"]
    lengths = kv_valid.sum(dim=-1, dtype=torch.int32)
    bidx = torch.arange(B, device=x.device)[:, None]
    pos = cache_positions.long()
    # w8a8 only on the multi-token pass (prefill); decode stays w8a16
    a8 = bool(act_quant) and L > 1
    for i in range(cfg.num_hidden_layers):
        p = {key: arr[i] for key, arr in params["layers"].items()}
        h = rms_norm(x, p["input_ln"], cfg.rms_norm_eps)
        q = (matmul_q(h, p, "q_w", a8) + p["q_b"]).reshape(B, L, H, D)
        k = (matmul_q(h, p, "k_w", a8) + p["k_b"]).reshape(B, L, Hkv, D)
        v = (matmul_q(h, p, "v_w", a8) + p["v_b"]).reshape(B, L, Hkv, D)
        if cfg.use_qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps)
        q, k = apply_rotary(q, k, cos, sin)
        if quant:
            kq, ksc = quantize_kv(k)
            vq, vsc = quantize_kv(v)
            k_all[i, bidx, pos] = kq
            v_all[i, bidx, pos] = vq
            # scales stored (B, Hkv, Lmax): the advanced indices around the
            # slice put the (B, L) dims first, so the value is (B, L, Hkv)
            ks_all[i, bidx, :, pos] = ksc
            vs_all[i, bidx, :, pos] = vsc
        else:
            k_all[i, bidx, pos] = k.to(k_all.dtype)
            v_all[i, bidx, pos] = v.to(v_all.dtype)
        if L > 1:
            # prefill into a fresh cache: attention over the local sequence's
            # raw k/v only
            out = flash_attention(q, k, v, kv_valid[:, :L], causal=True)
        else:
            # decode: the kernel reads only each slot's valid cache prefix
            out = paged_decode_attention(q[:, 0], k_all, v_all, lengths, ks_all,
                                         vs_all, layer=i)[:, None]
        x = x + matmul_q(out.reshape(B, L, H * D), p, "o_w", a8)
        h2 = rms_norm(x, p["post_ln"], cfg.rms_norm_eps)
        if cfg.n_experts:
            x = x + moe_block(cfg, p, h2)[0]
        elif p["gate_w"].dtype in (torch.int8, torch.uint8):     # quantized MLP
            act = (torch.nn.functional.silu(matmul_q(h2, p, "gate_w", a8).float())
                   * matmul_q(h2, p, "up_w", a8).float())
            x = x + matmul_q(act.to(h2.dtype), p, "down_w", a8)
        else:
            x = x + swiglu(h2, p["gate_w"], p["up_w"], p["down_w"])
    return x, cache


def text_decoder(
    cfg: TextConfig,
    params: Dict,                      # {"layers": stacked dict, "final_ln": ...}
    inputs_embeds: torch.Tensor,       # (B, L, hidden)
    cos: torch.Tensor,                 # (B, L, head_dim)
    sin: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,  # (B, L)
    q_positions: Optional[torch.Tensor] = None,     # (B, L) absolute (for causal)
    cache: Optional[Dict] = None,      # {"k","v": (layers,B,Lmax,Hkv,D), "kv_valid": (B,Lmax)}
    cache_positions: Optional[torch.Tensor] = None,
    remat: bool = False,
    use_flash: bool = False,
    cp=None,
    pp=None,
    tp=None,
    act_quant: bool = False,           # w8a8 on the cached multi-token pass (prefill)
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (B, L, hidden) final hidden states (post final norm) and the
    cache (updated in place); without a cache, {"moe_aux": the load-balance
    loss summed over layers} for MoE configs and None for dense ones."""
    if cp is not None or pp is not None or tp is not None:
        raise NotImplementedError(
            "context / pipeline / tensor parallelism is not ported yet "
            "(ROADMAP: multi-GPU)")
    if cache is None:
        if params_prequantized(params):
            raise NotImplementedError(
                "quantized weights serve through the cache path only")
        # unbind, not arr[i]: the backward of one unbind stacks the layers'
        # grads into the stacked leaf once, where each arr[i] would add a
        # zero-filled full-stack tensor per layer
        layers = {key: arr.unbind(0) for key, arr in params["layers"].items()}
        # the flash kernels' kv lengths, and the dk/dv kernel's work list
        # built from the same lengths: one host read for all layers' backward
        # passes
        lens = plan = None
        if use_flash:
            lens = None if attention_mask is None else attention_mask.sum(-1)
            if torch.is_grad_enabled():
                B, L = inputs_embeds.shape[:2]
                plan = dkv_plan(lens, B, L, L, cfg.num_attention_heads,
                                cfg.num_key_value_heads, True, inputs_embeds.device)

        def layer(i, x):
            p = {key: arrs[i] for key, arrs in layers.items()}
            return decoder_layer(cfg, p, x, cos, sin, attention_mask, q_positions,
                                 use_flash, plan, lens)

        x, auxes = inputs_embeds, []
        for i in range(cfg.num_hidden_layers):
            if remat and torch.is_grad_enabled():
                x, aux = checkpoint(layer, i, x, use_reentrant=False)
            else:
                x, aux = layer(i, x)
            auxes.append(aux)
        new_cache = {"moe_aux": torch.stack(auxes).sum()} if cfg.n_experts else None
    else:
        x, new_cache = _decoder_cached_unrolled(
            cfg, params, inputs_embeds, cos, sin, cache, cache_positions, act_quant)
    return rms_norm(x, params["final_ln"], cfg.rms_norm_eps), new_cache
