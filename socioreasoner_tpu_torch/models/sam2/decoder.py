"""SAM2 prompt encoder + two-way-attention mask decoder in PyTorch.

The counterpart of socioreasoner_tpu/models/sam2/decoder.py: HF
`Sam2PromptEncoder` / `Sam2TwoWayTransformer` / `Sam2MaskDecoder` semantics
with SocioSeg-shaped batching (all K objects of a tile decode as one
point-batch). NHWC activations and the JAX package's parameter layouts; the
ConvTranspose kernels are stored (kh, kw, out, in) as there and handed to
F.conv_transpose2d as (in, out, kh, kw). Mixed-dtype operands promote as in
jnp (torch.cat and torch.where promote; matmuls go through encoder.matmul):
point embeddings come out f32 from f32 coordinates, so in a bf16 model
the tokens and, after the first block, the image keys run in f32, exactly as
in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import MaskDecoderConfig, PromptEncoderConfig
from .encoder import conv2d, host_f64, layer_norm, linear, matmul


# ------------------------------------------------------------- prompt encoder

def fourier_point_embed(coords: torch.Tensor, pe_matrix: torch.Tensor) -> torch.Tensor:
    """coords in [0,1], shape (..., 2) → (..., hidden) (ref Sam2PositionalEmbedding)."""
    c = 2.0 * coords - 1.0
    proj = (2.0 * math.pi) * matmul(c, pe_matrix)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def embed_points(cfg: PromptEncoderConfig, p: Dict, points: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """points: (B, K, N, 2) pixel coords; labels: (B, K, N) in {-10,-1,0,1,2,3}.
    Returns (B, K, N, hidden): label -1 gives not_a_point, -10 (padding) a
    zero embedding. Caller appends the pad point when no boxes."""
    pts = (points + 0.5) / cfg.image_size
    emb = fourier_point_embed(pts, p["pe_matrix"])
    lab = labels[..., None]
    emb = torch.where(lab == -1, p["not_a_point"], emb)
    emb = torch.where(lab == -10, torch.zeros_like(emb), emb)
    point_w = p["point_embed"][labels.clamp(min=0)]
    return emb + point_w * (lab >= 0)


def embed_boxes(cfg: PromptEncoderConfig, p: Dict, boxes: torch.Tensor) -> torch.Tensor:
    """boxes: (B, K, 4) → (B, K, 3, hidden): two corner embeds + pad point."""
    corners = (boxes + 0.5).reshape(*boxes.shape[:2], 2, 2) / cfg.image_size
    emb = fourier_point_embed(corners, p["pe_matrix"])       # (B, K, 2, H)
    emb = emb + torch.stack([p["point_embed"][2], p["point_embed"][3]])
    pad = p["not_a_point"].expand(*emb.shape[:2], 1, emb.shape[-1])
    return torch.cat([emb, pad], dim=2)


def embed_masks(cfg: PromptEncoderConfig, p: Dict, masks: torch.Tensor) -> torch.Tensor:
    """Mask prompt → dense embedding (ref Sam2MaskEmbedding): masks
    (B, Hm, Wm, 1) at mask_input_size (4× the embedding grid) through
    conv2×2/s2 → LN(channels) → GELU → conv2×2/s2 → LN → GELU → conv1×1."""
    x = conv2d(masks, p["mask_conv1_w"], p["mask_conv1_b"], stride=(2, 2))
    x = F.gelu(layer_norm(x, p["mask_ln1_w"], p["mask_ln1_b"], cfg.layer_norm_eps))
    x = conv2d(x, p["mask_conv2_w"], p["mask_conv2_b"], stride=(2, 2))
    x = F.gelu(layer_norm(x, p["mask_ln2_w"], p["mask_ln2_b"], cfg.layer_norm_eps))
    return conv2d(x, p["mask_conv3_w"], p["mask_conv3_b"])


def encode_prompts(cfg: PromptEncoderConfig, p: Dict,
                   points: Optional[torch.Tensor], labels: Optional[torch.Tensor],
                   boxes: Optional[torch.Tensor], batch_size: int,
                   image_embedding_size: Tuple[int, int],
                   input_masks: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns sparse (B, K, T, hidden) and dense (B, h, w, hidden) embeddings.

    Ref Sam2PromptEncoder.forward: points padded with one (0,0)/-1 point when no
    boxes; boxes appended after points; dense = mask embedding when a mask
    prompt (B, Hm, Wm, 1) is given, else the learned no-mask embedding.
    """
    sparse = None
    if points is not None:
        if boxes is None:   # pad point
            zeros = points.new_zeros((*points.shape[:2], 1, 2))
            points = torch.cat([points, zeros], dim=2)
            labels = torch.cat([labels, -labels.new_ones((*labels.shape[:2], 1))], dim=2)
        sparse = embed_points(cfg, p, points, labels)
    if boxes is not None:
        box_emb = embed_boxes(cfg, p, boxes)
        sparse = box_emb if sparse is None else torch.cat([sparse, box_emb], dim=2)
    h, w = image_embedding_size
    if input_masks is not None:
        dense = embed_masks(cfg, p, input_masks)
    else:
        dense = p["no_mask"].expand(batch_size, h, w, p["no_mask"].shape[0])
    return sparse, dense


def image_wide_positional_embedding(cfg: PromptEncoderConfig, p: Dict) -> np.ndarray:
    """(1, h, w, hidden) dense PE over the low-res grid in float64 (ref
    Sam2Model.get_image_wide_positional_embeddings); the caller casts it to
    the parameters' dtype."""
    h, w = cfg.image_embedding_size
    ys = (np.arange(1, h + 1) - 0.5) / h
    xs = (np.arange(1, w + 1) - 0.5) / w
    grid = np.stack(np.meshgrid(xs, ys, indexing="xy"), axis=-1)  # (h, w, 2) x,y
    c = 2.0 * grid - 1.0
    proj = (2.0 * math.pi) * (c @ host_f64(p["pe_matrix"]))
    return np.concatenate([np.sin(proj), np.cos(proj)], axis=-1)[None]


# -------------------------------------------------------- two-way transformer

def _proj_attention(p: Dict, q, k, v, n_heads: int):
    """Sam2Attention: project q/k/v to internal dim, attend (f32 logits,
    probabilities in q's dtype), project out. Shapes (B, K, L, hidden) with
    the point-batch folded into batch."""
    B, K, Lq, _ = q.shape
    Lk = k.shape[2]
    qf = linear(q, p["q_w"], p["q_b"]).reshape(B * K, Lq, -1)
    kf = linear(k, p["k_w"], p["k_b"]).reshape(B * K, Lk, -1)
    vf = linear(v, p["v_w"], p["v_b"]).reshape(B * K, Lk, -1)
    internal = qf.shape[-1]
    D = internal // n_heads
    qh = qf.reshape(B * K, Lq, n_heads, D).transpose(1, 2)
    kh = kf.reshape(B * K, Lk, n_heads, D).transpose(1, 2)
    vh = vf.reshape(B * K, Lk, n_heads, D).transpose(1, 2)
    acc = torch.promote_types(torch.promote_types(qh.dtype, kh.dtype), torch.float32)
    logits = torch.matmul(qh.to(acc), kh.to(acc).transpose(-1, -2)) * (D ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = matmul(probs, vh).transpose(1, 2).reshape(B * K, Lq, internal)
    return linear(out, p["o_w"], p["o_b"]).reshape(B, K, Lq, -1)


def _ffn(p: Dict, x, act=F.relu):
    """Sam2FeedForward num_layers=2, relu (decoder MLPs use relu)."""
    return linear(act(linear(x, p["fc1_w"], p["fc1_b"])), p["fc2_w"], p["fc2_b"])


def _ln(x, p):
    return layer_norm(x, p["w"], p["b"], 1e-5)   # torch nn.LayerNorm default eps


def two_way_block(cfg: MaskDecoderConfig, p: Dict, queries, keys, query_pe, key_pe,
                  skip_first_layer_pe: bool):
    H = cfg.num_attention_heads
    if skip_first_layer_pe:
        # first layer: attention output REPLACES the queries (ref TwoWayAttentionBlock)
        queries = _proj_attention(p["self_attn"], queries, queries, queries, H)
    else:
        q = queries + query_pe
        queries = queries + _proj_attention(p["self_attn"], q, q, queries, H)
    queries = _ln(queries, p["ln1"])

    q = queries + query_pe
    k = keys + key_pe
    queries = queries + _proj_attention(p["cross_t2i"], q, k, keys, H)
    queries = _ln(queries, p["ln2"])

    queries = queries + _ffn(p["mlp"], queries)
    queries = _ln(queries, p["ln3"])

    q = queries + query_pe
    k = keys + key_pe
    keys = keys + _proj_attention(p["cross_i2t"], k, q, queries, H)
    keys = _ln(keys, p["ln4"])
    return queries, keys


def two_way_transformer(cfg: MaskDecoderConfig, p: Dict, point_embeddings,
                        image_embeddings, image_pe):
    """point_embeddings: (B, K, T, H); image_embeddings/pe: (B, K, HW, H)."""
    queries, keys = point_embeddings, image_embeddings
    for i, layer in enumerate(p["layers"]):
        queries, keys = two_way_block(cfg, layer, queries, keys,
                                      point_embeddings, image_pe,
                                      skip_first_layer_pe=(i == 0))
    q = queries + point_embeddings
    k = keys + image_pe
    queries = queries + _proj_attention(p["final_attn"], q, k, keys,
                                        cfg.num_attention_heads)
    queries = _ln(queries, p["ln_final"])
    return queries, keys


# --------------------------------------------------------------- mask decoder

def _ffn_n(p: Dict, x, act=F.relu, sigmoid_output=False):
    """Sam2FeedForward with arbitrary depth: proj_in, hidden layers, proj_out."""
    h = act(linear(x, p["fc_in_w"], p["fc_in_b"]))
    for layer in p.get("hidden", []):
        h = act(linear(h, layer["w"], layer["b"]))
    out = linear(h, p["fc_out_w"], p["fc_out_b"])
    return torch.sigmoid(out) if sigmoid_output else out


def conv_transpose2x(x: torch.Tensor, kernel: torch.Tensor, bias) -> torch.Tensor:
    """2x2 stride-2 transposed conv, NHWC, x cast to the kernel's dtype.
    Kernel stored (kh, kw, out, in) as in the JAX package; torch's
    ConvTranspose2d weight is (in, out, kh, kw)."""
    out = F.conv_transpose2d(x.to(kernel.dtype).permute(0, 3, 1, 2),
                             kernel.permute(3, 2, 0, 1), stride=2)
    return out.permute(0, 2, 3, 1) + bias


def mask_decoder_forward(
    cfg: MaskDecoderConfig, p: Dict,
    image_embeddings: torch.Tensor,        # (B, h, w, C) lowest-res FPN + dense prompt
    image_pe: torch.Tensor,                # (1, h, w, C)
    sparse_prompts: torch.Tensor,          # (B, K, T, C)
    high_res_feats: List[torch.Tensor],    # [(B, 4h, 4w, C/8), (B, 2h, 2w, C/4)] (s0, s1)
    multimask_output: bool,
    training: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (masks (B, K, M, 4h, 4w), iou_pred (B, K, M), object_logits (B, K, 1))."""
    B, h, w, C = image_embeddings.shape
    K = sparse_prompts.shape[1]

    output_tokens = torch.cat([p["obj_score_token"], p["iou_token"],
                               p["mask_tokens"]], dim=0)            # (2+M, C)
    output_tokens = output_tokens.expand(B, K, output_tokens.shape[0], C)
    tokens = torch.cat([output_tokens, sparse_prompts], dim=2)

    img = image_embeddings.reshape(B, 1, h * w, C).expand(B, K, h * w, C)
    pe = image_pe.reshape(1, 1, h * w, C).expand(B, K, h * w, C)

    queries, keys = two_way_transformer(cfg, p["transformer"], tokens, img, pe)
    iou_token_out = queries[:, :, 1]
    mask_tokens_out = queries[:, :, 2:2 + cfg.num_mask_tokens]

    # upscale (per B*K image state)
    img_out = keys.reshape(B * K, h, w, C)
    s0, s1 = high_res_feats
    s0 = s0.repeat_interleave(K, dim=0)
    s1 = s1.repeat_interleave(K, dim=0)
    up = conv_transpose2x(img_out, p["upscale1_w"], p["upscale1_b"]) + s1
    up = F.gelu(layer_norm(up, p["upscale_ln_w"], p["upscale_ln_b"], 1e-6))
    up = F.gelu(conv_transpose2x(up, p["upscale2_w"], p["upscale2_b"]) + s0)
    H4, W4 = up.shape[1:3]
    up_flat = up.reshape(B, K, H4 * W4, -1)

    hyper = torch.stack([_ffn_n(p["hyper_mlps"][i], mask_tokens_out[:, :, i])
                         for i in range(cfg.num_mask_tokens)], dim=2)  # (B,K,M,C/8)
    masks = matmul(hyper, up_flat.transpose(-1, -2)).reshape(
        B, K, cfg.num_mask_tokens, H4, W4)

    iou_pred = _ffn_n(p["iou_head"], iou_token_out, sigmoid_output=True)  # (B,K,M)
    object_logits = _ffn_n(p["obj_head"], queries[:, :, 0])               # (B,K,1)

    if multimask_output:
        masks = masks[:, :, 1:]
        iou_pred = iou_pred[:, :, 1:]
    elif cfg.dynamic_multimask_via_stability and not training:
        masks, iou_pred = _dynamic_multimask(cfg, masks, iou_pred)
    else:
        masks = masks[:, :, :1]
        iou_pred = iou_pred[:, :, :1]
    return masks, iou_pred, object_logits


def _stability_scores(cfg: MaskDecoderConfig, mask_logits: torch.Tensor) -> torch.Tensor:
    flat = mask_logits.reshape(*mask_logits.shape[:-2], -1)
    d = cfg.dynamic_multimask_stability_delta
    area_i = (flat > d).sum(dim=-1).float()
    area_u = (flat > -d).sum(dim=-1).float()
    return torch.where(area_u > 0, area_i / area_u.clamp(min=1), torch.ones_like(area_u))


def _dynamic_multimask(cfg: MaskDecoderConfig, masks, iou_pred):
    """Single-mask output falls back to the best multimask when unstable
    (ref Sam2MaskDecoder._dynamic_multimask_via_stability)."""
    multi = masks[:, :, 1:]
    multi_iou = iou_pred[:, :, 1:]
    best = torch.argmax(multi_iou, dim=-1)                              # (B, K)
    idx = best[:, :, None, None, None].expand(-1, -1, 1, *multi.shape[3:])
    best_mask = torch.gather(multi, 2, idx)
    best_iou = torch.gather(multi_iou, 2, best[:, :, None])
    single = masks[:, :, :1]
    single_iou = iou_pred[:, :, :1]
    stable = _stability_scores(cfg, single) >= cfg.dynamic_multimask_stability_thresh
    out_mask = torch.where(stable[..., None, None], single, best_mask)
    out_iou = torch.where(stable, single_iou, best_iou)
    return out_mask, out_iou
