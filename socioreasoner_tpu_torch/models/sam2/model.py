"""SAM2 full model + predictor surface in PyTorch.

The counterpart of socioreasoner_tpu/models/sam2/model.py: `set_image` /
`predict` as the reference's SAM2ImagePredictor is driven, with one encoder
call per image batch and one decoder call covering all K object prompts of
all tiles, the best-mask selection, OR-reduction and resize on the device.
Prompt shapes are bucketed as in the JAX package (K objects and N points
padded to powers of two, padding points labelled -10): a padding point has a
zero embedding but still takes part in attention, so the buckets change the
masks, not only the compile count.

The predictor runs on the device of its parameters; `init_params` places
them on the GPU unless a device is named.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..qwen2_5_vl.convert import param_device
from .config import Sam2Config
from .decoder import (encode_prompts, image_wide_positional_embedding,
                      mask_decoder_forward)
from .encoder import conv2d, hiera_pos_embed, image_encoder_forward

# ImageNet normalization used by the SAM2 processor
IMAGE_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGE_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., h, w) → (..., *size), jax.image.resize "linear" (antialiased
    when downsampling)."""
    lead = x.shape[:-2]
    x = x.reshape(1, -1, *x.shape[-2:]).float()
    down = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    out = F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                        antialias=down)
    return out.reshape(*lead, *size)


def preprocess_image_device(image: np.ndarray, image_size: int,
                            dtype=torch.float32, device=None) -> torch.Tensor:
    """uint8 HWC (any size) → normalized (1, S, S, 3) tensor on `device` (the
    GPU unless one is named): the raw uint8 is uploaded and converted,
    resized as jax.image.resize "linear" does (bilinear with half-pixel
    centres, antialiased when downsampling) and normalized there."""
    device = param_device(device)
    x = torch.as_tensor(np.array(image, np.uint8), device=device)
    x = _resize_linear(x.permute(2, 0, 1).float() / 255.0, (image_size, image_size))[None]
    mean = torch.as_tensor(IMAGE_MEAN, device=device)[:, None, None]
    std = torch.as_tensor(IMAGE_STD, device=device)[:, None, None]
    x = (x - mean) / std
    return x.permute(0, 2, 3, 1).to(dtype)


def encode_image(config: Sam2Config, params: Dict, pixel_values: torch.Tensor,
                 pos_embed: torch.Tensor) -> List[torch.Tensor]:
    """Returns [feat_s0 (proj), feat_s1 (proj), low_res + no_mem] high→low res,
    matching HF Sam2Model.get_image_embeddings (conv_s0/s1 pre-applied)."""
    feats = image_encoder_forward(config, params["encoder"], pixel_values, pos_embed)
    s0 = conv2d(feats[0], params["conv_s0_w"], params["conv_s0_b"])
    s1 = conv2d(feats[1], params["conv_s1_w"], params["conv_s1_b"])
    low = feats[2] + params["no_memory_embedding"][None, None]
    return [s0, s1, low]


def predict_masks(
    config: Sam2Config, params: Dict,
    image_embeddings: List[torch.Tensor],
    image_pe: torch.Tensor,
    points: Optional[torch.Tensor],        # (B, K, N, 2) in model-input pixel coords
    labels: Optional[torch.Tensor],        # (B, K, N)
    boxes: Optional[torch.Tensor],         # (B, K, 4)
    multimask_output: bool = True,
    input_masks: Optional[torch.Tensor] = None,   # (B, Hm, Wm, 1) mask prompt
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (low-res mask logits (B, K, M, h4, w4), iou scores (B, K, M))."""
    s0, s1, low = image_embeddings
    B = low.shape[0]
    sparse, dense = encode_prompts(
        config.prompt, params["prompt"], points, labels, boxes, B,
        (low.shape[1], low.shape[2]), input_masks=input_masks)
    img = low + dense
    masks, iou, _ = mask_decoder_forward(
        config.decoder, params["decoder"], img, image_pe, sparse,
        [s0, s1], multimask_output)
    return masks, iou


class Sam2Predictor:
    """The `set_image` / `predict` surface (ref SAM2ImagePredictor usage)."""

    def __init__(self, config: Sam2Config, params: Dict):
        self.config = config
        self.params = params
        self.device = params["conv_s0_w"].device
        self.dtype = params["conv_s0_w"].dtype
        self.pos_embed = None
        self._embeddings = None
        self._orig_size: Tuple[int, int] = (0, 0)
        self.image_pe = torch.as_tensor(
            image_wide_positional_embedding(config.prompt, params["prompt"]),
            device=self.device).to(params["prompt"]["pe_matrix"].dtype)

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------------- image
    def _pos_embed(self) -> torch.Tensor:
        if self.pos_embed is None:
            S = self.config.image_size
            grid = (S // self.config.hiera.patch_stride[0],) * 2
            pe = hiera_pos_embed(self.params["encoder"]["hiera"], self.config.hiera, *grid)
            self.pos_embed = self._tensor(pe).to(self.params["encoder"]["hiera"]["pos_embed"].dtype)
        return self.pos_embed

    @torch.no_grad()
    def set_image(self, image) -> None:
        """image: PIL.Image or uint8 HWC array."""
        self.set_images([image])

    @torch.no_grad()
    def set_images(self, images: List) -> None:
        """Encode a batch of images in one encoder call (the seg strategy's
        per-batch path; the reference encodes per sample)."""
        arrs = [np.asarray(im) for im in images]
        self._orig_size = arrs[0].shape[:2]
        pixels = torch.cat([preprocess_image_device(a, self.config.image_size,
                                                    self.dtype, self.device)
                            for a in arrs], dim=0)
        self._embeddings = encode_image(self.config, self.params, pixels, self._pos_embed())

    # ----------------------------------------------------------------- predict
    @torch.no_grad()
    def predict(self, point_coords=None, point_labels=None, box=None,
                multimask_output: bool = True, mask_input=None):
        """Single-object predict (reference-compatible): coords in ORIGINAL image
        pixels; mask_input an (Hm, Wm) / (1, Hm, Wm) low-res logit mask at
        mask_input_size (a prior predict's low-res output). Returns
        (masks (M, H, W) bool at original size, scores (M,), low-res)."""
        if self._embeddings is None:
            raise RuntimeError("call set_image first")
        S = self.config.image_size
        oh, ow = self._orig_size
        sx, sy = S / ow, S / oh
        pts = lbls = boxes = in_masks = None
        if mask_input is not None:
            hm, wm = self.config.prompt.mask_input_size
            in_masks = self._tensor(np.asarray(mask_input, np.float32).reshape(1, hm, wm, 1))
        if point_coords is not None:
            p = np.asarray(point_coords, np.float32).reshape(1, 1, -1, 2).copy()
            p[..., 0] *= sx
            p[..., 1] *= sy
            pts = self._tensor(p)
            lbls = self._tensor(np.asarray(point_labels, np.int64).reshape(1, 1, -1))
        if box is not None:
            b = np.asarray(box, np.float32).reshape(1, 1, 4).copy()
            b[..., 0::2] *= sx
            b[..., 1::2] *= sy
            boxes = self._tensor(b)
        masks, iou = predict_masks(self.config, self.params, self._embeddings,
                                   self.image_pe, pts, lbls, boxes,
                                   multimask_output=multimask_output,
                                   input_masks=in_masks)
        logits = masks[0, 0]                              # (M, h4, w4)
        up = _resize_linear(logits, (oh, ow))
        return ((up > 0).cpu().numpy(), iou[0, 0].float().cpu().numpy(),
                logits.float().cpu().numpy())

    # ----------------------------------------------- batched multi-tile decode
    def prompt_tensors(self, prompts_list: List[List[Dict]], max_objects: int = 16):
        """Per-tile object prompts (box and/or points, ORIGINAL pixels) →
        (points (B, K, N, 2) or None, labels (B, K, N) or None, boxes
        (B, K, 4) or None, valid (B, K)) on the device, K and N padded to
        powers of two, padding points labelled -10."""
        B = len(prompts_list)
        K = self._bucket(max([min(len(p), max_objects) for p in prompts_list] + [1]))
        S = self.config.image_size
        oh, ow = self._orig_size
        sx, sy = S / ow, S / oh
        max_pts = self._bucket(max([len(o.get("points", [])) for ps in prompts_list
                                    for o in ps] + [1]))
        boxes = np.zeros((B, K, 4), np.float32)
        pts = np.zeros((B, K, max_pts, 2), np.float32)
        lbl = np.full((B, K, max_pts), -10, np.int64)
        valid = np.zeros((B, K), bool)
        has_boxes = has_points = False
        for b, prompts in enumerate(prompts_list):
            for i, p in enumerate(prompts[:max_objects]):
                valid[b, i] = True
                if p.get("box") is not None:
                    has_boxes = True
                    bb = np.asarray(p["box"], np.float32)
                    boxes[b, i] = [bb[0] * sx, bb[1] * sy, bb[2] * sx, bb[3] * sy]
                if p.get("points"):
                    has_points = True
                    n = len(p["points"])
                    arr = np.asarray(p["points"], np.float32)
                    pts[b, i, :n, 0] = arr[:, 0] * sx
                    pts[b, i, :n, 1] = arr[:, 1] * sy
                    lbl[b, i, :n] = p.get("labels", [1] * n)
        return (self._tensor(pts) if has_points else None,
                self._tensor(lbl) if has_points else None,
                self._tensor(boxes) if has_boxes else None,
                self._tensor(valid))

    @torch.no_grad()
    def predict_objects_mask_batch(self, prompts_list: List[List[Dict]],
                                   out_size: Tuple[int, int],
                                   max_objects: int = 16,
                                   embeddings=None) -> List[np.ndarray]:
        """All tiles × all objects in one decoder call. prompts_list[b] holds
        tile b's object prompts (box and/or points); empty lists allowed.
        embeddings: optional (s0, s1, low) batch to decode from (a cached
        encode) instead of the last set_images state."""
        if embeddings is None:
            embeddings = self._embeddings
        pts, lbl, boxes, valid = self.prompt_tensors(prompts_list, max_objects)
        masks, iou = predict_masks(self.config, self.params, embeddings, self.image_pe,
                                   pts, lbl, boxes, multimask_output=True)
        out = self._union_masks(masks, iou, valid, out_size)
        return [out[b] for b in range(len(prompts_list))]

    @staticmethod
    def _union_masks(masks, iou, valid, out_size) -> np.ndarray:
        """Best mask per object (argmax iou), OR over the valid objects,
        half-pixel nearest resize to out_size → (B, *out_size) uint8."""
        best = torch.argmax(iou, dim=-1)                                # (B, K)
        idx = best[:, :, None, None, None].expand(-1, -1, 1, *masks.shape[3:])
        best_masks = torch.gather(masks, 2, idx)[:, :, 0]              # (B, K, h, w)
        union = ((best_masks > 0) & valid[:, :, None, None]).any(dim=1)
        up = F.interpolate(union.float()[:, None], size=tuple(out_size),
                           mode="nearest-exact")[:, 0]
        return (up > 0.5).to(torch.uint8).cpu().numpy()

    # ------------------------------------------------- SocioSeg batched decode
    @torch.no_grad()
    def predict_objects_mask(self, prompts: List[Dict], out_size: Tuple[int, int],
                             max_objects: int = 16) -> np.ndarray:
        """All K object prompts of the current tile in ONE decoder call; best mask
        per object (argmax iou), OR-reduce, resize to out_size nearest.

        prompts: [{"box": [x1,y1,x2,y2] (orig px), "points": [[x,y]...],
                   "labels": [...]}]  (box and/or points per object).
        Unlike the batched path, K and the point count are not bucketed.
        """
        if len(prompts) == 0:
            return np.zeros(out_size, np.uint8)
        K = min(len(prompts), max_objects)
        prompts = prompts[:K]
        S = self.config.image_size
        oh, ow = self._orig_size
        sx, sy = S / ow, S / oh
        max_pts = max([len(p.get("points", [])) for p in prompts] + [1])

        has_boxes = any("box" in p for p in prompts)
        boxes = np.zeros((1, K, 4), np.float32)
        pts = np.zeros((1, K, max_pts, 2), np.float32)
        lbl = np.full((1, K, max_pts), -10, np.int64)     # -10 = padding point
        has_points = False
        for i, p in enumerate(prompts):
            if "box" in p and p["box"] is not None:
                b = np.asarray(p["box"], np.float32)
                boxes[0, i] = [b[0] * sx, b[1] * sy, b[2] * sx, b[3] * sy]
            if p.get("points"):
                has_points = True
                n = len(p["points"])
                arr = np.asarray(p["points"], np.float32)
                pts[0, i, :n, 0] = arr[:, 0] * sx
                pts[0, i, :n, 1] = arr[:, 1] * sy
                lbl[0, i, :n] = p.get("labels", [1] * n)
        masks, iou = predict_masks(
            self.config, self.params, self._embeddings, self.image_pe,
            self._tensor(pts) if has_points else None,
            self._tensor(lbl) if has_points else None,
            self._tensor(boxes) if has_boxes else None,
            multimask_output=True)
        valid = torch.ones((1, K), dtype=torch.bool, device=self.device)
        return self._union_masks(masks, iou, valid, out_size)[0]


def init_params(config: Sam2Config, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Dict:
    """Random init at the JAX init_params shapes (N(0, 0.02) weights, a unit
    normal pe_matrix, unit norms, zero biases) on `device` (the GPU unless
    one is named), drawn from `generator`, which must live on that device."""
    device = param_device(device)
    hc, pc, dc = config.hiera, config.prompt, config.decoder

    def dense(shape, scale=0.02):
        w = torch.randn(shape, generator=generator, device=device)
        return w.mul_(scale).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def ffn2(d_in, d_hidden, d_out):
        return {"fc1_w": dense((d_in, d_hidden)), "fc1_b": zeros((d_hidden,)),
                "fc2_w": dense((d_hidden, d_out)), "fc2_b": zeros((d_out,))}

    def ffn_n(d_in, d_hidden, d_out, depth):
        return {"fc_in_w": dense((d_in, d_hidden)), "fc_in_b": zeros((d_hidden,)),
                "hidden": [{"w": dense((d_hidden, d_hidden)), "b": zeros((d_hidden,))}
                           for _ in range(depth - 2)],
                "fc_out_w": dense((d_hidden, d_out)), "fc_out_b": zeros((d_out,))}

    def attn(hidden, internal):
        return {"q_w": dense((hidden, internal)), "q_b": zeros((internal,)),
                "k_w": dense((hidden, internal)), "k_b": zeros((internal,)),
                "v_w": dense((hidden, internal)), "v_b": zeros((internal,)),
                "o_w": dense((internal, hidden)), "o_b": zeros((hidden,))}

    blocks = []
    for stage_idx, n_blocks in enumerate(hc.blocks_per_stage):
        for bi in range(n_blocks):
            first = stage_idx > 0 and bi == 0
            dim = hc.embed_dim_per_stage[stage_idx - 1] if first else hc.embed_dim_per_stage[stage_idx]
            dim_out = hc.embed_dim_per_stage[stage_idx]
            b = {"ln1_w": ones((dim,)), "ln1_b": zeros((dim,)),
                 "ln2_w": ones((dim_out,)), "ln2_b": zeros((dim_out,)),
                 "qkv_w": dense((dim, 3 * dim_out)), "qkv_b": zeros((3 * dim_out,)),
                 "o_w": dense((dim_out, dim_out)), "o_b": zeros((dim_out,)),
                 "mlp": ffn2(dim_out, int(dim_out * hc.mlp_ratio), dim_out)}
            if dim != dim_out:
                b["proj_w"] = dense((dim, dim_out))
                b["proj_b"] = zeros((dim_out,))
            blocks.append(b)

    encoder = {
        "hiera": {
            "patch_w": dense((*hc.patch_kernel, hc.num_channels, hc.hidden_size)),
            "patch_b": zeros((hc.hidden_size,)),
            "pos_embed": zeros((1, hc.hidden_size, *hc.window_pos_bg_size)),
            "pos_embed_window": zeros((1, hc.hidden_size,
                                       hc.window_size_per_stage[0],
                                       hc.window_size_per_stage[0])),
            "blocks": blocks,
        },
        "neck": {"convs": [{"w": dense((1, 1, c, config.fpn_hidden_size)),
                            "b": zeros((config.fpn_hidden_size,))}
                           for c in config.backbone_channel_list]},
    }
    C = dc.hidden_size
    decoder = {
        "obj_score_token": dense((1, C)), "iou_token": dense((1, C)),
        "mask_tokens": dense((dc.num_mask_tokens, C)),
        "transformer": {
            "layers": [{
                "self_attn": attn(C, C),
                "cross_t2i": attn(C, C // dc.attention_downsample_rate),
                "cross_i2t": attn(C, C // dc.attention_downsample_rate),
                "mlp": ffn2(C, dc.mlp_dim, C),
                "ln1": {"w": ones((C,)), "b": zeros((C,))},
                "ln2": {"w": ones((C,)), "b": zeros((C,))},
                "ln3": {"w": ones((C,)), "b": zeros((C,))},
                "ln4": {"w": ones((C,)), "b": zeros((C,))},
            } for _ in range(dc.num_hidden_layers)],
            "final_attn": attn(C, C // dc.attention_downsample_rate),
            "ln_final": {"w": ones((C,)), "b": zeros((C,))},
        },
        "upscale1_w": dense((2, 2, C // 4, C)), "upscale1_b": zeros((C // 4,)),
        "upscale2_w": dense((2, 2, C // 8, C // 4)), "upscale2_b": zeros((C // 8,)),
        "upscale_ln_w": ones((C // 4,)), "upscale_ln_b": zeros((C // 4,)),
        "hyper_mlps": [ffn_n(C, C, C // 8, 3) for _ in range(dc.num_mask_tokens)],
        "iou_head": ffn_n(C, dc.iou_head_hidden_dim, dc.num_mask_tokens,
                          dc.iou_head_depth),
        "obj_head": ffn_n(C, C, 1, 3),
    }
    mic = pc.mask_input_channels
    prompt = {
        "pe_matrix": dense((2, pc.hidden_size // 2), scale=1.0),
        "point_embed": dense((pc.num_point_embeddings, pc.hidden_size)),
        "not_a_point": dense((pc.hidden_size,)),
        "no_mask": dense((pc.hidden_size,)),
        # mask-prompt downscaler (ref Sam2MaskEmbedding)
        "mask_conv1_w": dense((2, 2, 1, mic // 4)), "mask_conv1_b": zeros((mic // 4,)),
        "mask_ln1_w": ones((mic // 4,)), "mask_ln1_b": zeros((mic // 4,)),
        "mask_conv2_w": dense((2, 2, mic // 4, mic)), "mask_conv2_b": zeros((mic,)),
        "mask_ln2_w": ones((mic,)), "mask_ln2_b": zeros((mic,)),
        "mask_conv3_w": dense((1, 1, mic, pc.hidden_size)),
        "mask_conv3_b": zeros((pc.hidden_size,)),
    }
    return {
        "encoder": encoder, "decoder": decoder, "prompt": prompt,
        "conv_s0_w": dense((1, 1, config.fpn_hidden_size, C // 8)),
        "conv_s0_b": zeros((C // 8,)),
        "conv_s1_w": dense((1, 1, config.fpn_hidden_size, C // 4)),
        "conv_s1_b": zeros((C // 4,)),
        "no_memory_embedding": zeros((1, config.fpn_hidden_size)),
    }
