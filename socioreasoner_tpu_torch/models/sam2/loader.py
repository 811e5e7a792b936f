"""SAM2 HF checkpoint tensors → the port's SAM2 parameter tree.

The counterpart of socioreasoner_tpu/models/sam2/loader.py: maps HF
`Sam2Model` tensor names into the tree of model.py, which keeps the JAX
package's layouts. Conv kernels go torch OIHW → HWIO; ConvTranspose2d
(in, out, kh, kw) → (kh, kw, out, in); linears transpose to (in, out).
`load_pretrained` reads a checkpoint directory through
utils/safetensors_io.py.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import torch

from ...utils.safetensors_io import iter_safetensors
from .config import Sam2Config
from .model import init_params
from ..qwen2_5_vl.convert import param_device


def _set(tree: Dict, path, value):
    node = tree
    for k in path[:-1]:
        node = node[k]
    if path[-1] not in node:
        raise KeyError(f"unknown param path {path}")
    expect = node[path[-1]]
    if tuple(expect.shape) != tuple(value.shape):
        raise ValueError(f"{path}: shape {value.shape} != expected {tuple(expect.shape)}")
    node[path[-1]] = torch.empty_like(expect).copy_(value)


def load_params(config: Sam2Config, tensors: Iterator[Tuple[str, torch.Tensor]],
                dtype=torch.float32, device=None) -> Dict:
    """(name, tensor) pairs of an HF Sam2Model → the port's tree of `dtype`
    tensors on `device` (the GPU unless one is named). Leaves the pairs do
    not name keep a seeded random init; memory_* and other video-only
    tensors are skipped."""
    device = param_device(device)
    params = init_params(config, torch.Generator(device=device).manual_seed(0),
                         dtype=dtype, device=device)

    def conv_hwio(a):       # (O, I, kh, kw) → (kh, kw, I, O)
        return a.permute(2, 3, 1, 0)

    def convT_hwio(a):      # (I, O, kh, kw) → (kh, kw, O, I) for transpose_kernel=True
        return a.permute(2, 3, 1, 0)

    def ffn2_path(base, rest, arr):
        name_map = {"proj_in.weight": ("fc1_w", True), "proj_in.bias": ("fc1_b", False),
                    "proj_out.weight": ("fc2_w", True), "proj_out.bias": ("fc2_b", False)}
        key, tr = name_map[rest]
        _set(params, base + [key], arr.T if tr else arr)

    def ffn_n_path(base, rest, arr):
        if rest.startswith("layers."):
            m = re.match(r"layers\.(\d+)\.(weight|bias)", rest)
            i, kind = int(m.group(1)), m.group(2)
            _set(params, base + ["hidden", i, "w" if kind == "weight" else "b"],
                 arr.T if kind == "weight" else arr)
        else:
            name_map = {"proj_in.weight": ("fc_in_w", True), "proj_in.bias": ("fc_in_b", False),
                        "proj_out.weight": ("fc_out_w", True), "proj_out.bias": ("fc_out_b", False)}
            key, tr = name_map[rest]
            _set(params, base + [key], arr.T if tr else arr)

    def attn_path(base, rest, arr):
        m = re.match(r"(q|k|v|o)_proj\.(weight|bias)", rest)
        which, kind = m.group(1), m.group(2)
        key = f"{which}_{'w' if kind == 'weight' else 'b'}"
        _set(params, base + [key], arr.T if kind == "weight" else arr)

    for name, arr in tensors:
        arr = torch.as_tensor(arr)
        # ---------------- hiera backbone
        if name.startswith("vision_encoder.backbone."):
            rest = name[len("vision_encoder.backbone."):]
            if rest == "patch_embed.projection.weight":
                _set(params, ["encoder", "hiera", "patch_w"], conv_hwio(arr))
            elif rest == "patch_embed.projection.bias":
                _set(params, ["encoder", "hiera", "patch_b"], arr)
            elif rest in ("pos_embed", "pos_embed_window"):
                _set(params, ["encoder", "hiera", rest], arr)
            elif rest.startswith("blocks."):
                m = re.match(r"blocks\.(\d+)\.(.+)", rest)
                i, brest = int(m.group(1)), m.group(2)
                base = ["encoder", "hiera", "blocks", i]
                if brest.startswith("mlp."):
                    ffn2_path(base + ["mlp"], brest[4:], arr)
                elif brest == "attn.qkv.weight":
                    _set(params, base + ["qkv_w"], arr.T)
                elif brest == "attn.qkv.bias":
                    _set(params, base + ["qkv_b"], arr)
                elif brest == "attn.proj.weight":
                    _set(params, base + ["o_w"], arr.T)
                elif brest == "attn.proj.bias":
                    _set(params, base + ["o_b"], arr)
                elif brest == "proj.weight":
                    _set(params, base + ["proj_w"], arr.T)
                elif brest == "proj.bias":
                    _set(params, base + ["proj_b"], arr)
                else:
                    ln = {"layer_norm1.weight": "ln1_w", "layer_norm1.bias": "ln1_b",
                          "layer_norm2.weight": "ln2_w", "layer_norm2.bias": "ln2_b"}
                    if brest in ln:
                        _set(params, base + [ln[brest]], arr)
        # ---------------- FPN neck
        elif name.startswith("vision_encoder.neck.convs."):
            m = re.match(r"vision_encoder\.neck\.convs\.(\d+)\.(?:conv\.)?(weight|bias)", name)
            j, kind = int(m.group(1)), m.group(2)
            if kind == "weight":
                _set(params, ["encoder", "neck", "convs", j, "w"], conv_hwio(arr))
            else:
                _set(params, ["encoder", "neck", "convs", j, "b"], arr)
        # ---------------- prompt encoder
        elif name == "prompt_encoder.shared_embedding.positional_embedding" or \
                name == "shared_image_embedding.positional_embedding":
            _set(params, ["prompt", "pe_matrix"], arr)
        elif name == "prompt_encoder.point_embed.weight":
            _set(params, ["prompt", "point_embed"], arr)
        elif name == "prompt_encoder.not_a_point_embed.weight":
            _set(params, ["prompt", "not_a_point"], arr[0])
        elif name == "prompt_encoder.no_mask_embed.weight":
            _set(params, ["prompt", "no_mask"], arr[0])
        elif name.startswith("prompt_encoder.mask_embed."):
            rest = name[len("prompt_encoder.mask_embed."):]
            mask_map = {
                "conv1.weight": ("mask_conv1_w", True), "conv1.bias": ("mask_conv1_b", False),
                "conv2.weight": ("mask_conv2_w", True), "conv2.bias": ("mask_conv2_b", False),
                "conv3.weight": ("mask_conv3_w", True), "conv3.bias": ("mask_conv3_b", False),
                "layer_norm1.weight": ("mask_ln1_w", False), "layer_norm1.bias": ("mask_ln1_b", False),
                "layer_norm2.weight": ("mask_ln2_w", False), "layer_norm2.bias": ("mask_ln2_b", False),
            }
            if rest in mask_map:
                key, is_conv = mask_map[rest]
                _set(params, ["prompt", key], conv_hwio(arr) if is_conv else arr)
        # ---------------- mask decoder
        elif name.startswith("mask_decoder."):
            rest = name[len("mask_decoder."):]
            if rest == "iou_token.weight":
                _set(params, ["decoder", "iou_token"], arr)
            elif rest == "mask_tokens.weight":
                _set(params, ["decoder", "mask_tokens"], arr)
            elif rest == "obj_score_token.weight":
                _set(params, ["decoder", "obj_score_token"], arr)
            elif rest == "upscale_conv1.weight":
                _set(params, ["decoder", "upscale1_w"], convT_hwio(arr))
            elif rest == "upscale_conv1.bias":
                _set(params, ["decoder", "upscale1_b"], arr)
            elif rest == "upscale_conv2.weight":
                _set(params, ["decoder", "upscale2_w"], convT_hwio(arr))
            elif rest == "upscale_conv2.bias":
                _set(params, ["decoder", "upscale2_b"], arr)
            elif rest == "upscale_layer_norm.weight":
                _set(params, ["decoder", "upscale_ln_w"], arr)
            elif rest == "upscale_layer_norm.bias":
                _set(params, ["decoder", "upscale_ln_b"], arr)
            elif rest.startswith("output_hypernetworks_mlps."):
                m = re.match(r"output_hypernetworks_mlps\.(\d+)\.(.+)", rest)
                ffn_n_path(["decoder", "hyper_mlps", int(m.group(1))], m.group(2), arr)
            elif rest.startswith("iou_prediction_head."):
                ffn_n_path(["decoder", "iou_head"], rest[len("iou_prediction_head."):], arr)
            elif rest.startswith("pred_obj_score_head."):
                ffn_n_path(["decoder", "obj_head"], rest[len("pred_obj_score_head."):], arr)
            elif rest == "conv_s0.weight":
                _set(params, ["conv_s0_w"], conv_hwio(arr))
            elif rest == "conv_s0.bias":
                _set(params, ["conv_s0_b"], arr)
            elif rest == "conv_s1.weight":
                _set(params, ["conv_s1_w"], conv_hwio(arr))
            elif rest == "conv_s1.bias":
                _set(params, ["conv_s1_b"], arr)
            elif rest.startswith("transformer."):
                trest = rest[len("transformer."):]
                if trest.startswith("layers."):
                    m = re.match(r"layers\.(\d+)\.(.+)", trest)
                    i, lrest = int(m.group(1)), m.group(2)
                    base = ["decoder", "transformer", "layers", i]
                    attn_names = {"self_attn": "self_attn",
                                  "cross_attn_token_to_image": "cross_t2i",
                                  "cross_attn_image_to_token": "cross_i2t"}
                    done = False
                    for hf_name, key in attn_names.items():
                        if lrest.startswith(hf_name + "."):
                            attn_path(base + [key], lrest[len(hf_name) + 1:], arr)
                            done = True
                            break
                    if not done:
                        if lrest.startswith("mlp."):
                            ffn2_path(base + ["mlp"], lrest[4:], arr)
                        else:
                            m2 = re.match(r"layer_norm(\d)\.(weight|bias)", lrest)
                            if m2:
                                _set(params, base + [f"ln{m2.group(1)}",
                                                     "w" if m2.group(2) == "weight" else "b"], arr)
                elif trest.startswith("final_attn_token_to_image."):
                    attn_path(["decoder", "transformer", "final_attn"],
                              trest[len("final_attn_token_to_image."):], arr)
                elif trest.startswith("layer_norm_final_attn."):
                    kind = trest.rsplit(".", 1)[1]
                    _set(params, ["decoder", "transformer", "ln_final",
                                  "w" if kind == "weight" else "b"], arr)
        elif name == "no_memory_embedding":
            _set(params, ["no_memory_embedding"], arr.reshape(1, -1))
        # memory_* / mask_downsample / video-only tensors are intentionally skipped
    return params


def load_from_torch_state_dict(config: Sam2Config, state_dict, dtype=torch.float32,
                               device=None) -> Dict:
    """An HF Sam2Model state dict → the port's tree (float64 on the host
    on the way, so no precision is lost before the cast to `dtype`)."""
    return load_params(config, ((k, v.detach().to("cpu", torch.float64))
                                for k, v in state_dict.items()), dtype, device)


def load_pretrained(path: str, config: Sam2Config = None, dtype=torch.bfloat16,
                    device=None):
    """(config, tree) of an HF Sam2Model checkpoint directory; the config
    is SAM2-hiera-large unless one is given, as in the JAX package."""
    config = config or Sam2Config.large()
    return config, load_params(config, iter_safetensors(path), dtype, device)
