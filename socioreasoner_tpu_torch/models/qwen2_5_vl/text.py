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
    at the layer index -- where head_dim is a multiple of 128, as in the JAX
    package; other head dims (64: Qwen2.5-0.5B/1.5B, Llama-3.2) attend
    densely over the layer's cache, an int8 cache dequantized first, the
    route JAX takes there. The cache path also serves quantized trees
    (ops/quant.py): every projection goes through matmul_q, w8a8 on
    multi-token passes with act_quant; an int8 cache (with "k_scale" /
    "v_scale") is written with quantize_kv and read by the int8 decode
    kernel, while prefill attends over the raw k/v of the local sequence.

MoE families (qwen2_moe, qwen3_moe, mixtral) replace the MLP by the routed
experts of ops/moe.py on both paths, plus qwen2_moe's sigmoid-gated shared
expert; the uncached decoder returns {"moe_aux": the load-balance loss
summed over layers} in place of the cache for them, as the JAX package does.
Tensor parallelism (`tp`, the decode engine's devices) runs the cached
decoder over per-shard trees and caches (parallel/sharding.py): the norms
and residual stream on the first shard's device, each shard's q/k/v and
gate/up products on its own heads and columns, kernels 2 and 3/3q on its
local heads (flash_attention_tp, paged_decode_attention_tp), and the
row-parallel o_proj/down_proj partial products summed onto the first
shard's device, as the JAX package's GSPMD psum does (int8 weights: the
partial products before the per-channel scale; w8a8: the int32 partials of
one global activation scale, so those sums are exact; int4 weights: each
shard's dequantized rows, or its rows of a leaf kept whole). MoE layers split the
experts over the shards. `use_flash=False` on the cached path attends
densely over the cache (the SOCIO_DISABLE_FLASH route).

The train plane runs the uncached decoder the same way over one data
rank's tp devices (parallel/sharding.RankParams): each layer gathered over
fsdp just before it runs (inside its checkpoint under remat), column-parallel
q/k/v and gate/up, the trainable kernels 4-6 on each shard's local heads
with a kernel-6 plan a shard, row-parallel o_proj/down_proj partial sums
added on the rank's first device; differentiable throughout. Under context
parallelism the rank's sequence is split over its sp rows and attention
runs as ring attention (plain PyTorch, as in the JAX package) or as
Ulysses' all-to-all (kernels 4-6 on each head slice under use_flash);
under pipeline parallelism its layers run whole on its stage devices
through the GPipe or interleaved schedule (parallel/pipeline_parallel.py,
kernels 4-6 a micro-batch). PP with CP raises, as JAX's assert does.
Quantized weights on the uncached path (the JAX package multiplies their
codes unscaled there) are not ported and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ...ops.attention import dense_attention
from ...ops.decode_attention import (dequantize_kv, paged_decode_attention,
                                     paged_decode_attention_tp, quantize_kv)
from ...ops.flash_attention import flash_attention, flash_attention_tp
from ...ops.flash_attention_bwd import dkv_plan, flash_attention_trainable
from ...ops.moe import moe_experts, moe_mlp, moe_router
from ...ops.norms import rms_norm, swiglu
from ...ops.quant import (_INV127, _scale, int_matmul, matmul_int4_rows, matmul_q,
                          params_prequantized)
from ...parallel.pipeline_parallel import pipeline_decoder
from ...parallel.ring_attention import ring_attention_pos_local
from ...parallel.ulysses import ulysses_attention_local, ulysses_heads
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


def _qkv(cfg: TextConfig, p: Dict, h: torch.Tensor, T: int = 1):
    """q, k, v of the heads in `p`: all of them, or a tp shard's 1/T."""
    B, L, _ = h.shape
    H, Hkv, D = cfg.num_attention_heads // T, cfg.num_key_value_heads // T, cfg.head_dim
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


def _sum_to(parts, home: torch.device) -> torch.Tensor:
    """Left-to-right sum of the shards' partial tensors on `home`."""
    total = parts[0].to(home)
    for part in parts[1:]:
        total = total + part.to(home)
    return total


def row_parallel(hs, ps, name: str, a8: bool, home: torch.device) -> torch.Tensor:
    """sum_t hs[t] @ ps[t][name] for a row-parallel weight (input dim split),
    on `home`. int8 weights scale the summed
    product by the per-channel scale, which every shard holds whole; with
    a8 the activations share one per-row scale from the global row amax and
    the int32 partials sum exactly, so the result equals the unsharded w8a8
    product. Nibble-packed int4 weights hold their packed rows and scale
    groups a shard, or the whole leaf where a shard boundary would cut a
    group (parallel/sharding.py), whose rows of this shard's inputs it then
    multiplies."""
    w0 = ps[0][name]
    dtype = hs[0].dtype
    if w0.dtype == torch.int8:
        scale = ps[0][name + "_scale"].to(home)
        if a8:
            amaxes = [h.float().abs().amax(dim=-1, keepdim=True).to(home) for h in hs]
            amax = amaxes[0]
            for a in amaxes[1:]:
                amax = torch.maximum(amax, a)
            a_scale = _scale(amax, _INV127)
            accs = []
            for h, p in zip(hs, ps):
                q = torch.round(h.float() / a_scale.to(h.device)).clamp_(-127, 127)
                acc = int_matmul(q.to(torch.int8).reshape(-1, q.shape[-1]), p[name])
                accs.append(acc.reshape(*q.shape[:-1], acc.shape[-1]))
            return (_sum_to(accs, home).float() * a_scale * scale).to(dtype)
        y = _sum_to([h @ p[name].to(dtype) for h, p in zip(hs, ps)], home)
        return (y * scale).to(dtype)
    if w0.dtype == torch.uint8:
        parts = []
        for t, (h, p) in enumerate(zip(hs, ps)):
            k = h.shape[-1]
            if 2 * p[name].shape[-2] == k:        # this shard's rows and groups
                parts.append(matmul_q(h, p, name))
            else:                                 # the whole leaf: its rows t k ..
                parts.append(matmul_int4_rows(h, p[name], p[name + "_scale"], t * k))
        return _sum_to(parts, home)
    return _sum_to([h @ p[name] for h, p in zip(hs, ps)], home)


def _decoder_cached_unrolled(cfg: TextConfig, params: Dict, x, cos, sin,
                             cache: Dict, cache_positions, act_quant: bool = False,
                             use_flash: bool = True):
    """Cache-mode decoder. Writes each layer's K/V rows (and, for an int8
    cache, their scales) into the cache's stacked buffers in place and
    returns (x, cache) with the same buffers. use_flash=False attends
    densely over the cache."""
    B, L, _ = x.shape
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    k_all, v_all = cache["k"], cache["v"]
    ks_all, vs_all = cache.get("k_scale"), cache.get("v_scale")
    quant = ks_all is not None
    kv_valid = cache["kv_valid"]
    lengths = kv_valid.sum(dim=-1, dtype=torch.int32)
    bidx = torch.arange(B, device=x.device)[:, None]
    pos = cache_positions.long()
    # the decode kernel (kernels 3/3q) where head_dim is a multiple of 128,
    # as the JAX package routes it; dense attention over the cache otherwise
    paged = D % 128 == 0 and use_flash
    if not (use_flash and (L > 1 or paged)):
        Lmax = k_all.shape[2]
        kv_pos = torch.arange(Lmax, device=x.device)[None].expand(B, Lmax)
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
        if L > 1 and use_flash:
            # prefill into a fresh cache: attention over the local sequence's
            # raw k/v only
            out = flash_attention(q, k, v, kv_valid[:, :L], causal=True)
        elif L == 1 and paged:
            # decode: the kernel reads only each slot's valid cache prefix
            out = paged_decode_attention(q[:, 0], k_all, v_all, lengths, ks_all,
                                         vs_all, layer=i)[:, None]
        else:
            if quant:
                kd = dequantize_kv(k_all[i], ks_all[i], q.dtype)
                vd = dequantize_kv(v_all[i], vs_all[i], q.dtype)
            else:
                kd, vd = k_all[i].to(q.dtype), v_all[i].to(q.dtype)
            out = dense_attention(q, kd, vd, causal=True, attention_mask=kv_valid,
                                  q_positions=pos, kv_positions=kv_pos)
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


def _decoder_cached_tp(cfg: TextConfig, shards, x, cos, sin, caches, cache_positions,
                       devices, act_quant: bool = False, use_flash: bool = True):
    """_decoder_cached_unrolled under tensor parallelism: `shards` and
    `caches` hold one params tree and one cache dict a device of `devices`,
    each shard its heads, columns and experts and its own contiguous cache
    of its kv heads. x (the residual stream) and the replicated norms live
    on devices[0]. Returns (x, caches)."""
    B, L, _ = x.shape
    T = len(devices)
    home = x.device
    H, Hkv, D = (cfg.num_attention_heads // T, cfg.num_key_value_heads // T,
                 cfg.head_dim)
    kv_valid = caches[0]["kv_valid"].to(home)
    quant = "k_scale" in caches[0]
    # the decode kernel (kernels 3/3q) where head_dim is a multiple of 128,
    # as the JAX package routes it; dense attention over the cache otherwise
    paged = D % 128 == 0 and use_flash
    lengths = kv_valid.sum(dim=-1, dtype=torch.int32)
    pos = cache_positions.long()
    at = [dict(kv_valid=kv_valid.to(dev), pos=pos.to(dev), cos=cos.to(dev),
               sin=sin.to(dev), bidx=torch.arange(B, device=dev)[:, None])
          for dev in devices]
    if not (use_flash and (L > 1 or paged)):
        Lmax = caches[0]["k"].shape[2]
        for a, dev in zip(at, devices):
            a["kv_pos"] = torch.arange(Lmax, device=dev)[None].expand(B, Lmax)
    # w8a8 only on the multi-token pass (prefill); decode stays w8a16
    a8 = bool(act_quant) and L > 1
    for i in range(cfg.num_hidden_layers):
        ps = [{key: arr[i] for key, arr in s["layers"].items()} for s in shards]
        h = rms_norm(x, ps[0]["input_ln"], cfg.rms_norm_eps)
        hs = [h.to(dev) for dev in devices]
        qs, ks, vs = [], [], []
        for p, a, c, ht in zip(ps, at, caches, hs):
            q = (matmul_q(ht, p, "q_w", a8) + p["q_b"]).reshape(B, L, H, D)
            k = (matmul_q(ht, p, "k_w", a8) + p["k_b"]).reshape(B, L, Hkv, D)
            v = (matmul_q(ht, p, "v_w", a8) + p["v_b"]).reshape(B, L, Hkv, D)
            if cfg.use_qk_norm:
                q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps)
                k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps)
            q, k = apply_rotary(q, k, a["cos"], a["sin"])
            if quant:
                kq, ksc = quantize_kv(k)
                vq, vsc = quantize_kv(v)
                c["k"][i, a["bidx"], a["pos"]] = kq
                c["v"][i, a["bidx"], a["pos"]] = vq
                # scales stored (B, Hkv, Lmax): the advanced indices around
                # the slice put the (B, L) dims first, so the value is (B, L, Hkv)
                c["k_scale"][i, a["bidx"], :, a["pos"]] = ksc
                c["v_scale"][i, a["bidx"], :, a["pos"]] = vsc
            else:
                c["k"][i, a["bidx"], a["pos"]] = k.to(c["k"].dtype)
                c["v"][i, a["bidx"], a["pos"]] = v.to(c["v"].dtype)
            qs.append(q)
            ks.append(k)
            vs.append(v)
        if L > 1 and use_flash:
            # prefill into a fresh cache: attention over the local sequence's
            # raw k/v only, each shard on its heads
            outs = flash_attention_tp(qs, ks, vs, kv_valid[:, :L], devices=devices,
                                      causal=True)
        elif L == 1 and paged:
            # decode: the kernel reads only each slot's valid cache prefix
            scales = (([c["k_scale"] for c in caches], [c["v_scale"] for c in caches])
                      if quant else (None, None))
            outs = paged_decode_attention_tp(
                [q[:, 0] for q in qs], [c["k"] for c in caches],
                [c["v"] for c in caches], lengths, *scales, devices=devices, layer=i)
            outs = [o[:, None] for o in outs]
        else:
            outs = []
            for q, a, c in zip(qs, at, caches):
                if quant:
                    kd = dequantize_kv(c["k"][i], c["k_scale"][i], q.dtype)
                    vd = dequantize_kv(c["v"][i], c["v_scale"][i], q.dtype)
                else:
                    kd, vd = c["k"][i].to(q.dtype), c["v"][i].to(q.dtype)
                outs.append(dense_attention(q, kd, vd, causal=True,
                                            attention_mask=a["kv_valid"],
                                            q_positions=a["pos"], kv_positions=a["kv_pos"]))
        x = x + row_parallel([o.reshape(B, L, H * D) for o in outs], ps, "o_w", a8, home)
        h2 = rms_norm(x, ps[0]["post_ln"], cfg.rms_norm_eps)
        h2s = [h2.to(dev) for dev in devices]
        if cfg.n_experts:
            x = x + _moe(cfg, ps, h2, h2s, home)
            continue
        acts = []
        for h2t, p in zip(h2s, ps):
            if p["gate_w"].dtype in (torch.int8, torch.uint8):      # quantized MLP
                act = (torch.nn.functional.silu(matmul_q(h2t, p, "gate_w", a8).float())
                       * matmul_q(h2t, p, "up_w", a8).float()).to(h2t.dtype)
            else:
                act = torch.nn.functional.silu(h2t @ p["gate_w"]) * (h2t @ p["up_w"])
            acts.append(act)
        x = x + row_parallel(acts, ps, "down_w", a8, home)
    return x, caches


def _moe(cfg: TextConfig, ps, h2, h2s, home, with_stats: bool = False):
    """The MoE MLP over the shards' expert blocks: the router on the first
    shard's device, each shard's experts weighted by their columns of the
    routing weights, the shards' sums added on `home`; qwen2_moe's shared
    expert column/row-parallel behind its replicated gate. with_stats also
    returns the router's sums over these tokens (moe_stats)."""
    B, L, Hd = h2.shape
    weights, probs, _ = moe_router(h2.reshape(B * L, Hd), ps[0]["router_w"],
                                   cfg.n_experts_per_tok, cfg.norm_topk_prob)
    offsets = [0]
    for p in ps:
        offsets.append(offsets[-1] + p["gate_w"].shape[0])
    parts = [moe_experts(h2t.reshape(B * L, Hd),
                         weights[:, offsets[t]:offsets[t + 1]].to(h2t.device),
                         {k: p[k] for k in ("gate_w", "up_w", "down_w")})
             for t, (h2t, p) in enumerate(zip(h2s, ps))]
    out = _sum_to(parts, home).reshape(B, L, Hd).to(h2.dtype)
    if cfg.shared_expert_intermediate:
        acts = [torch.nn.functional.silu(h2t @ p["s_gate_w"]) * (h2t @ p["s_up_w"])
                for h2t, p in zip(h2s, ps)]
        shared = row_parallel(acts, ps, "s_down_w", False, home)
        out = out + torch.sigmoid(h2 @ ps[0]["sgate_w"]) * shared
    if with_stats:
        return out, moe_stats(weights, probs)
    return out


def moe_stats(weights: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """(2, E): the router's per-expert counts of chosen tokens and sums of
    probabilities over these tokens. Summed over data ranks, they give the
    load-balance loss of the global batch (moe_aux_from_stats)."""
    return torch.stack([(weights > 0).float().sum(dim=0), probs.sum(dim=0)])


def moe_aux_from_stats(stats: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """moe_router's Switch loss, E * sum(frac_tokens * frac_probs), from
    moe_stats summed over every token of a batch."""
    return stats.shape[-1] * torch.sum((stats[0] / n_tokens) * (stats[1] / n_tokens))


def _decoder_uncached_tp(cfg: TextConfig, rank, x, cos, sin, attention_mask,
                         use_flash: bool, remat: bool, cp=None, q_positions=None):
    """The uncached decoder of one data rank of the train plane over its tp
    devices (rank: parallel/sharding.RankParams; x on rank.home). Each
    layer's leaves are gathered over fsdp inside the layer (so inside its
    checkpoint under remat); the trainable kernels (use_flash) run on each
    shard's local heads over the valid prefix lengths, with one kernel-6
    plan a shard, never shared.

    With cp (parallel/context_parallel.CPConfig) the sequence, already in
    cp's layout, is split over the rank's sp rows (rank.sp_devices): each
    row runs its tokens' projections and MLP on its tp devices, and
    attention couples the rows on each tp index's local heads: ring
    attention over the global `q_positions` and the padding mask (impl
    "ring"), or Ulysses' all-to-all with dense attention, or the trainable
    kernels under use_flash, over every head slice (impl "ulysses").
    Returns (x on rank.home, a list of the layers' moe_stats for MoE
    configs, else None)."""
    devices = rank.devices
    T = len(devices)
    if cfg.num_attention_heads % T or cfg.num_key_value_heads % T:
        raise ValueError(f"tp={T} must divide the heads: H={cfg.num_attention_heads}, "
                         f"Hkv={cfg.num_key_value_heads} (a head is never split)")
    B, L, _ = x.shape
    H, Hkv = cfg.num_attention_heads // T, cfg.num_key_value_heads // T
    rows = [devices] if cp is None else rank.sp_devices     # [sp row][tp index]
    n = len(rows)
    if L % n:
        raise ValueError(f"sequence length {L} does not split over sp={n}")
    Ls = L // n
    homes = [row[0] for row in rows]

    def chunk(a, s, dev):
        return a[:, s * Ls:(s + 1) * Ls].to(dev)
    at = [[dict(cos=chunk(cos, s, dev), sin=chunk(sin, s, dev)) for dev in row]
          for s, row in enumerate(rows)]
    plans = None
    impl = None if cp is None else cp.impl
    if impl == "ring":
        mask = (torch.ones((B, L), dtype=torch.int32, device=x.device)
                if attention_mask is None else attention_mask)
        pos = torch.broadcast_to(q_positions, (B, L))
        for s, row in enumerate(rows):
            for a, dev in zip(at[s], row):
                a["pos"], a["kv_mask"] = chunk(pos, s, dev), chunk(mask, s, dev)
    elif impl == "ulysses":
        for s, row in enumerate(rows):
            for a, dev in zip(at[s], row):
                a["mask"] = None if attention_mask is None else chunk(attention_mask, s, dev)
        Hu, Hkvu = ulysses_heads(H, Hkv, n)
        if use_flash and torch.is_grad_enabled():
            # kernel 6's work list a device of each tp index's all-to-all,
            # from the rank's lengths at the head slice
            lens = None if attention_mask is None else attention_mask.sum(-1)
            plans = [[dkv_plan(lens, B, L, L, Hu, Hkvu, True, rows[j][t]) for j in range(n)]
                     for t in range(T)]
    elif use_flash:
        lens = None if attention_mask is None else attention_mask.sum(-1)
        for a, dev in zip(at[0], devices):
            a["lens"] = None if lens is None else lens.to(dev)
            # kernel 6's work list from this rank's lengths at the shard's
            # local heads: one host read a shard, and a plan of its own
            a["plan"] = (dkv_plan(lens, B, L, L, H, Hkv, True, dev)
                         if torch.is_grad_enabled() else None)
    else:
        for a, dev in zip(at[0], devices):
            a["mask"] = None if attention_mask is None else attention_mask.to(dev)

    def attend(qkv):
        """qkv[s][t] = (q, k, v) → out[s][t] (B, Ls, H, D)."""
        if impl is None:
            out = []
            for (q, k, v), a in zip(qkv[0], at[0]):
                out.append(flash_attention_trainable(q, k, v, a["lens"], True, a["plan"])
                           if use_flash else
                           dense_attention(q, k, v, causal=True, attention_mask=a["mask"]))
            return [out]
        outs = [[None] * T for _ in range(n)]
        for t in range(T):
            qs, ks, vs = (list(z) for z in zip(*(qkv[s][t] for s in range(n))))
            cells = [at[s][t] for s in range(n)]
            if impl == "ring":
                if Hkv != H:                      # GQA: repeat KV heads
                    ks = [k.repeat_interleave(H // Hkv, dim=2) for k in ks]
                    vs = [v.repeat_interleave(H // Hkv, dim=2) for v in vs]
                pos = [c["pos"] for c in cells]
                res = ring_attention_pos_local(qs, ks, vs, pos, pos,
                                               [c["kv_mask"] for c in cells], causal=True)
            else:
                masks = None if attention_mask is None else [c["mask"] for c in cells]
                res = ulysses_attention_local(qs, ks, vs, masks, causal=True,
                                              use_flash=use_flash,
                                              plans=None if plans is None else plans[t])
            for s in range(n):
                outs[s][t] = res[s]
        return outs

    def layer(i, *xs):
        ps = [rank.layer(i, row) for row in rows]
        qkv = []
        for s, row in enumerate(rows):
            h = rms_norm(xs[s], ps[s][0]["input_ln"], cfg.rms_norm_eps)
            cells = []
            for p, a, dev in zip(ps[s], at[s], row):
                q, k, v = _qkv(cfg, p, h.to(dev), T)
                q, k = apply_rotary(q, k, a["cos"], a["sin"])
                cells.append((q, k, v))
            qkv.append(cells)
        outs = attend(qkv)
        new, stats = [], None
        for s, row in enumerate(rows):
            xr = xs[s] + row_parallel([o.reshape(B, Ls, -1) for o in outs[s]], ps[s], "o_w",
                                      False, homes[s])
            h2 = rms_norm(xr, ps[s][0]["post_ln"], cfg.rms_norm_eps)
            h2s = [h2.to(dev) for dev in row]
            if cfg.n_experts:
                out, st = _moe(cfg, ps[s], h2, h2s, homes[s], with_stats=True)
                stats = st.to(homes[0]) if stats is None else stats + st.to(homes[0])
                new.append(xr + out)
                continue
            acts = [torch.nn.functional.silu(h2t @ p["gate_w"]) * (h2t @ p["up_w"])
                    for h2t, p in zip(h2s, ps[s])]
            new.append(xr + row_parallel(acts, ps[s], "down_w", False, homes[s]))
        return (*new, stats)

    xs = [chunk(x, s, home) for s, home in enumerate(homes)]
    stats = []
    for i in range(cfg.num_hidden_layers):
        if remat and torch.is_grad_enabled():
            *xs, st = checkpoint(layer, i, *xs, use_reentrant=False)
        else:
            *xs, st = layer(i, *xs)
        stats.append(st)
    x = xs[0] if n == 1 else torch.cat([xr.to(x.device) for xr in xs], dim=1)
    return x, (stats if cfg.n_experts else None)


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
    use_flash: Optional[bool] = None,
    cp=None,
    pp=None,
    tp=None,
    act_quant: bool = False,           # w8a8 on the cached multi-token pass (prefill)
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (B, L, hidden) final hidden states (post final norm) and the
    cache (updated in place); without a cache, {"moe_aux": the load-balance
    loss summed over layers} for MoE configs and None for dense ones.

    use_flash None takes each path's default: the kernels on the cached
    path, dense attention on the uncached one.

    With `tp` (the tensor-parallel devices) and a cache, `params` and
    `cache` are lists of per-shard trees and caches, and the result is on
    tp[0]; the final norm uses the first shard's copy. With `tp` and no
    cache, `params` is a train-plane rank (parallel/sharding.RankParams) and
    the second value {"moe_stats": [per layer]} for MoE configs; `cp` (a
    CPConfig: the input already in its layout, causality by the global
    `q_positions`) or `pp` (a PPConfig) then shard the sequence over the
    rank's sp rows or its layers over its pp stages."""
    if (cp is not None or pp is not None) and cache is None:
        if pp is not None and cp is not None:
            raise ValueError("PP and CP cannot combine (pick one seq plan)")
        if tp is None:
            raise ValueError("context and pipeline parallelism run over a train mesh: "
                             "shard the params (parallel.sharding.ShardedTree)")
    if tp is not None:
        if cache is None:
            if pp is not None:
                x = pipeline_decoder(cfg, params, inputs_embeds, cos, sin, attention_mask,
                                     q_positions, pp, remat, bool(use_flash))
                return rms_norm(x, params.top("final_ln")[0], cfg.rms_norm_eps), None
            x, stats = _decoder_uncached_tp(cfg, params, inputs_embeds, cos, sin,
                                            attention_mask, bool(use_flash), remat,
                                            cp, q_positions)
            return (rms_norm(x, params.top("final_ln")[0], cfg.rms_norm_eps),
                    None if stats is None else {"moe_stats": stats})
        x, new_cache = _decoder_cached_tp(cfg, params, inputs_embeds, cos, sin, cache,
                                          cache_positions, list(tp), act_quant,
                                          use_flash is not False)
        return rms_norm(x, params[0]["final_ln"], cfg.rms_norm_eps), new_cache
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
            cfg, params, inputs_embeds, cos, sin, cache, cache_positions, act_quant,
            use_flash is not False)
    return rms_norm(x, params["final_ln"], cfg.rms_norm_eps), new_cache
