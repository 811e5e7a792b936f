"""Qwen2.5-VL vision tower (ViT with window attention) in PyTorch.

The counterpart of socioreasoner_tpu/models/qwen2_5_vl/vision.py, both
variants: qwen2.5 (RMSNorm, SwiGLU MLP, window attention with full-attention
layers) and qwen2 (Qwen2-VL: LayerNorm with bias, fc1 → quick-GELU → fc2,
full attention in every block, a LayerNorm merger), with bf16/f32 or int8
tower weights:
  * the Conv3d patch embed is one matmul (its kernel equals its stride);
  * window attention is segment-masked attention over the packed sequence:
    patches are permuted into window-contiguous order on the host, and every
    block attends under a per-patch segment-id equality mask — window ids in
    window layers, per-image ids in the full-attention layers. With
    use_flash (the serving paths, run_vision / run_vision_u8, unless
    SOCIO_DISABLE_FLASH=1 on CPU tensors, ops/flags.py) it goes
    through the segmented flash kernel (ops/flash_attention.py), which has
    no backward; without it (the default, and the model call's
    vision_inputs route that trains the ViT) through dense attention in f32
    softmax, differentiable, as the JAX tower's non-flash branch;
  * blocks run in a Python loop over the stacked (depth, ...) parameters;
  * a tower quantized by ops/quant.quantize_vision_params (int8 block and
    merger matmuls, float patch embed) runs every block and merger matmul
    w8a8, biases added after the product, as the JAX tower does.

Host bookkeeping (permutation, rope tables, segment ids) lives in rope.py.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.attention import dense_attention
from ...ops.flags import use_flash_attention
from ...ops.flash_attention import (SegPlan, flash_attention_segmented, seg_block_sizes,
                                    seg_max_span_blocks, seg_plan)
from ...ops.norms import layer_norm, quick_gelu, rms_norm, swiglu
from ...ops.quant import matmul_q
from . import rope as rope_mod
from .config import VisionConfig


def _norm(cfg: VisionConfig, x, p, key):
    if cfg.variant == "qwen2":     # LayerNorm with bias
        return layer_norm(x, p[key], p[key + "_b"], cfg.rms_norm_eps)
    return rms_norm(x, p[key], cfg.rms_norm_eps)


def vision_block(cfg: VisionConfig, p: Dict, x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, seg: torch.Tensor, use_flash: bool = False,
                 max_span_blocks: int = None, plan: SegPlan = None) -> torch.Tensor:
    """One ViT block. x: (S, hidden); seg: (S,) attention segment ids; plan:
    the attention kernel's plan for seg (seg_plan), built once per tower.
    use_flash under autograd raises on every device: the kernel it takes on
    the GPU has no backward."""
    S = x.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    a8 = p["qkv_w"].dtype == torch.int8         # an int8 tower runs w8a8
    h = _norm(cfg, x, p, "norm1")
    qkv = matmul_q(h, p, "qkv_w", a8) + p["qkv_b"]          # (S, 3*hidden)
    q, k, v = qkv.reshape(S, 3, H, D).unbind(1)            # (S, H, D) views
    # rotary (cos/sin are (S, D)); float32 rotation like HF
    q32, k32 = q.float(), k.float()
    c, s = cos[:, None, :], sin[:, None, :]
    q = (q32 * c + rope_mod.rotate_half(q32) * s).to(x.dtype)
    k = (k32 * c + rope_mod.rotate_half(k32) * s).to(x.dtype)
    if not use_flash:
        s_ids = seg.to(x.device)[None]
        attn = dense_attention(q[None], k[None], v[None], segment_ids_q=s_ids,
                               segment_ids_kv=s_ids)[0]
    elif torch.is_grad_enabled() and q.requires_grad:
        raise RuntimeError("vision_block: use_flash=True under autograd; the segmented "
                           "kernel has no backward, train the ViT with use_flash=False")
    else:
        bq, bk = seg_block_sizes(S)
        attn = flash_attention_segmented(q, k, v, seg, block_q=bq, block_k=bk,
                                         max_span_blocks=max_span_blocks, plan=plan)
    x = x + (matmul_q(attn.reshape(S, H * D), p, "proj_w", a8) + p["proj_b"])
    h2 = _norm(cfg, x, p, "norm2")
    if cfg.variant == "qwen2":     # fc1 → quick-GELU → fc2
        return x + (matmul_q(quick_gelu(matmul_q(h2, p, "fc1_w", a8) + p["fc1_b"]),
                             p, "fc2_w", a8) + p["fc2_b"])
    if a8:
        act = (F.silu((matmul_q(h2, p, "gate_w", True) + p["gate_b"]).float())
               * (matmul_q(h2, p, "up_w", True) + p["up_b"]).float())
        return x + (matmul_q(act.to(h2.dtype), p, "down_w", True) + p["down_b"])
    return x + swiglu(h2, p["gate_w"], p["up_w"], p["down_w"],
                      p["gate_b"], p["up_b"], p["down_b"])


def vision_tower(
    cfg: VisionConfig,
    params: Dict,
    patches: torch.Tensor,     # (S, patch_input_dim) — already window-permuted
    cos: torch.Tensor,         # (S, head_dim) — window-permuted rope table
    sin: torch.Tensor,
    window_seg: torch.Tensor,  # (S,) window segment ids
    full_seg: torch.Tensor,    # (S,) per-image segment ids
    is_full_layer,             # (depth,) bools — use full_seg in this layer
    use_flash: bool = False,   # the segmented kernel (no backward) on the GPU
    max_span_blocks: int = None,   # max k-block span over BOTH seg arrays
) -> torch.Tensor:
    """Returns (S // spatial_merge_unit, out_hidden) merged embeddings, still in
    window order (the caller applies the inverse permutation)."""
    x = (patches @ params["patch_embed_w"]).to(patches.dtype)
    blocks = params["blocks"]
    plans, is_full_layer = {}, np.asarray(is_full_layer).tolist()
    if use_flash and x.is_cuda:   # the kernel's plans, one per id array the layers use
        bq, bk = seg_block_sizes(x.shape[0])
        plans = {full: seg_plan(seg, cfg.num_heads, x.device, block_q=bq, block_k=bk,
                                max_span_blocks=max_span_blocks)
                 for full, seg in ((False, window_seg), (True, full_seg))
                 if full in is_full_layer}
    for i, is_full in enumerate(is_full_layer):
        p = {key: arr[i] for key, arr in blocks.items()}
        seg = full_seg if is_full else window_seg
        x = vision_block(cfg, p, x, cos, sin, seg, use_flash=use_flash,
                         max_span_blocks=max_span_blocks, plan=plans.get(is_full))

    # merger: norm then merge spatial_merge_unit patches → MLP
    h = _norm(cfg, x, params, "merger_ln_q")
    a8 = params["merger_fc1_w"].dtype == torch.int8
    h = h.reshape(-1, cfg.spatial_merge_unit * cfg.hidden_size)
    h = matmul_q(h, params, "merger_fc1_w", a8) + params["merger_fc1_b"]
    h = F.gelu(h, approximate="none")
    return matmul_q(h, params, "merger_fc2_w", a8) + params["merger_fc2_b"]


def _window_layout(cfg: VisionConfig, grid_thw: np.ndarray):
    """(patch_perm, host tables): the window permutation of the patches, and
    the window-permuted rope tables, segment ids, full-layer flags and the
    inverse permutation of the merged rows."""
    unit = cfg.spatial_merge_unit
    window_index, window_seg, full_seg = rope_mod.vision_window_index(grid_thw, cfg)
    cos, sin = rope_mod.vision_rope_cos_sin(grid_thw, cfg)
    patch_perm = (window_index[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
    return patch_perm, {
        "cos": cos[patch_perm],
        "sin": sin[patch_perm],
        "window_seg": window_seg,
        "full_seg": full_seg,
        "is_full_layer": np.array([i in cfg.fullatt_block_indexes for i in range(cfg.depth)]),
        "inv_perm": np.argsort(window_index),
    }


def vision_host_inputs(cfg: VisionConfig, pixel_patches: np.ndarray, grid_thw: np.ndarray):
    """Host precompute: permute patches window-wise, build rope tables + segments.

    Returns a dict of host arrays + inv_perm to restore merged order."""
    patch_perm, tables = _window_layout(cfg, grid_thw)
    return {"patches": pixel_patches[patch_perm], **tables}


def patchify_device(img_u8: torch.Tensor,        # (H, W, 3) uint8, resized
                    mean: torch.Tensor, std: torch.Tensor,
                    ps: int, ms: int, tps: int) -> torch.Tensor:
    """On-device CLIP-normalize + Qwen merge-block patchify (the exact math
    of datasets/processor.py patchify_image): the host uploads 1 byte per
    pixel instead of float patches with the temporal repeat applied."""
    x = img_u8.float() / 255.0
    x = ((x - mean) / std).permute(2, 0, 1)            # (C, H, W)
    C, H, W = x.shape
    gh, gw = H // ps, W // ps
    frames = x[None].expand(tps, C, H, W)               # temporal repeat
    p = frames.reshape(1, tps, C, gh // ms, ms, ps, gw // ms, ms, ps)
    p = p.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return p.reshape(gh * gw, C * tps * ps * ps)


def _run_tower(cfg: VisionConfig, params: Dict, patches: torch.Tensor,
               tables: Dict, dtype) -> torch.Tensor:
    """Window-permuted device patches + host tables → merged embeddings in
    model order."""
    dev = patches.device
    wseg, fseg = tables["window_seg"], tables["full_seg"]
    bq, bk = seg_block_sizes(len(wseg))
    span = max(seg_max_span_blocks(wseg, bq, bk), seg_max_span_blocks(fseg, bq, bk))
    out = vision_tower(
        cfg, params, patches,
        torch.as_tensor(tables["cos"], device=dev),
        torch.as_tensor(tables["sin"], device=dev),
        # the ids stay on the host: the kernel's plans are built from them
        torch.as_tensor(wseg), torch.as_tensor(fseg),
        tables["is_full_layer"], use_flash=use_flash_attention(device=dev),
        max_span_blocks=span)
    out = out[torch.as_tensor(tables["inv_perm"], device=dev)]
    return out.to(dtype) if dtype is not None else out


def run_vision_u8(cfg: VisionConfig, params: Dict, images_u8,
                  grid_thw: np.ndarray, image_config, dtype=None) -> torch.Tensor:
    """Per-image resized uint8 arrays (the defer_patchify carrier) → merged
    embeddings in model order, on the parameters' device: uint8 upload, then
    normalize + patchify + window permutation + tower on the device."""
    ic = image_config
    w = params["patch_embed_w"]
    dev = w.device
    patch_perm, tables = _window_layout(cfg, grid_thw)
    mean = torch.as_tensor(np.asarray(ic.image_mean, np.float32), device=dev)
    std = torch.as_tensor(np.asarray(ic.image_std, np.float32), device=dev)
    parts = [patchify_device(torch.tensor(np.asarray(a, np.uint8), device=dev),
                             mean, std, ic.patch_size, ic.merge_size,
                             ic.temporal_patch_size).to(w.dtype)
             for a in images_u8]
    patches = torch.cat(parts, dim=0)[torch.as_tensor(patch_perm, device=dev)]
    return _run_tower(cfg, params, patches, tables, dtype)


def run_vision(cfg: VisionConfig, params: Dict, pixel_patches: np.ndarray,
               grid_thw: np.ndarray, dtype=None) -> torch.Tensor:
    """Host patches (already patchified) → merged embeddings in model order."""
    w = params["patch_embed_w"]
    patch_perm, tables = _window_layout(cfg, grid_thw)
    patches = torch.as_tensor(pixel_patches[patch_perm], device=w.device).to(w.dtype)
    return _run_tower(cfg, params, patches, tables, dtype)
