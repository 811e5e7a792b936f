"""Qwen2.5-VL full model: embeddings + vision scatter + decoder + logits.

The counterpart of socioreasoner_tpu/models/qwen2_5_vl/model.py. Parameters
are a dict of tensors with the JAX package's layout and names, weights kept
(in, out) so `x @ W` is the same product on both sides:

  {"embed": (V, H), "layers": stacked dicts, "final_ln": (H,),
   "lm_head": (H, V) (absent if tied), "vision": {...}}
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ...ops.quant import head_logits
from .config import Qwen25VLConfig
from .convert import param_device
from .rope import make_inv_freq, mrope_channel_axis, mrope_cos_sin
from .text import text_decoder
from .vision import vision_tower


def scatter_image_embeds(input_ids: torch.Tensor, token_embeds: torch.Tensor,
                         image_embeds: torch.Tensor, image_token_id: int) -> torch.Tensor:
    """Replace embeddings at image-token positions with ViT outputs.

    image_embeds: (S_img, hidden) rows in batch-major image-token order: the
    i-th image token (flattened batch-major) takes row i."""
    B, L = input_ids.shape
    mask = input_ids.reshape(-1) == image_token_id
    row = (torch.cumsum(mask, dim=0) - 1).clamp(0, image_embeds.shape[0] - 1)
    gathered = image_embeds[row]
    flat = torch.where(mask[:, None], gathered, token_embeds.reshape(B * L, -1))
    return flat.reshape(B, L, -1)


def forward(
    config: Qwen25VLConfig,
    params: Dict,
    input_ids: torch.Tensor,            # (B, L)
    position_ids: torch.Tensor,         # (B, 3, L) M-RoPE ids
    attention_mask: Optional[torch.Tensor] = None,
    *,
    vision_inputs: Optional[Dict] = None,   # device tensors from vision_host_inputs
    image_embeds: Optional[torch.Tensor] = None,  # precomputed (S_img, hidden)
    cache: Optional[Dict] = None,
    cache_positions: Optional[torch.Tensor] = None,
    remat: bool = False,
    logits: bool = True,
    use_flash: bool = False,
    cp=None,
    pp=None,
    tp=None,
    act_quant: bool = False,            # w8a8 matmuls on the cached multi-token pass
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (logits or hidden, cache). A given cache is updated in place.
    remat and use_flash apply to the uncached decoder, act_quant to the
    cached one (see text_decoder)."""
    tcfg = config.text
    # F.embedding, not params["embed"][input_ids]: the indexing backward
    # accumulates the rows' gradients in a run-dependent order, the embedding
    # backward in a fixed one, so that a train step repeats bit for bit
    embeds = torch.nn.functional.embedding(input_ids, params["embed"])

    if image_embeds is None and vision_inputs is not None:
        vi = vision_inputs
        image_embeds = vision_tower(
            config.vision, params["vision"], vi["patches"], vi["cos"], vi["sin"],
            vi["window_seg"], vi["full_seg"], vi["is_full_layer"])[vi["inv_perm"]]
    if image_embeds is not None:
        embeds = scatter_image_embeds(input_ids, embeds, image_embeds.to(embeds.dtype),
                                      config.image_token_id)

    inv_freq = torch.as_tensor(make_inv_freq(tcfg.head_dim, tcfg.rope_theta),
                               device=embeds.device)
    chan_axis = mrope_channel_axis(tcfg.head_dim, tcfg.mrope_section)
    cos, sin = mrope_cos_sin(position_ids, inv_freq, chan_axis)

    # Causality follows SEQUENCE order, not M-RoPE values: image tokens share
    # equal t-positions, so masking by position value would be bidirectional.
    hidden, new_cache = text_decoder(
        tcfg, params, embeds, cos, sin, attention_mask, q_positions=None,
        cache=cache, cache_positions=cache_positions, remat=remat,
        use_flash=use_flash, cp=cp, pp=pp, tp=tp, act_quant=act_quant)
    if not logits:
        return hidden, new_cache
    return head_logits(params, hidden), new_cache


# ------------------------------------------------------------------ random init

def init_params(config: Qwen25VLConfig, generator: torch.Generator,
                dtype=torch.float32, device=None, with_vision: bool = True) -> Dict:
    """Random init at the JAX init_params shapes (N(0, 0.02) weights, unit
    norms, zero biases) on `device` (the GPU unless one is named), drawn
    from `generator`, which must live on that device."""
    if config.text.n_experts:
        raise NotImplementedError(
            "MoE parameters are not ported yet (ROADMAP: the rest of the surface)")
    device = param_device(device)
    t, v = config.text, config.vision

    def dense(shape, scale=0.02):
        w = torch.randn(shape, generator=generator, device=device)
        return w.mul_(scale).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    H, D, Hkv = t.num_attention_heads, t.head_dim, t.num_key_value_heads
    L = t.num_hidden_layers

    def stack(shape):
        return dense((L,) + shape)

    params = {
        "embed": dense((t.vocab_size, t.hidden_size)),
        "final_ln": ones((t.hidden_size,)),
        "layers": {
            "input_ln": ones((L, t.hidden_size)),
            "post_ln": ones((L, t.hidden_size)),
            "q_w": stack((t.hidden_size, H * D)), "q_b": zeros((L, H * D)),
            "k_w": stack((t.hidden_size, Hkv * D)), "k_b": zeros((L, Hkv * D)),
            "v_w": stack((t.hidden_size, Hkv * D)), "v_b": zeros((L, Hkv * D)),
            "o_w": stack((H * D, t.hidden_size)),
            "gate_w": stack((t.hidden_size, t.intermediate_size)),
            "up_w": stack((t.hidden_size, t.intermediate_size)),
            "down_w": stack((t.intermediate_size, t.hidden_size)),
        },
    }
    if t.use_qk_norm:
        params["layers"]["q_norm"] = ones((L, D))
        params["layers"]["k_norm"] = ones((L, D))
    if not t.tie_word_embeddings:
        params["lm_head"] = dense((t.hidden_size, t.vocab_size))
    if with_vision:
        vd = v.depth
        merged = v.spatial_merge_unit * v.hidden_size
        params["vision"] = {
            "patch_embed_w": dense((v.patch_input_dim, v.hidden_size)),
            "blocks": {
                "norm1": ones((vd, v.hidden_size)),
                "norm2": ones((vd, v.hidden_size)),
                "qkv_w": dense((vd, v.hidden_size, 3 * v.hidden_size)),
                "qkv_b": zeros((vd, 3 * v.hidden_size)),
                "proj_w": dense((vd, v.hidden_size, v.hidden_size)),
                "proj_b": zeros((vd, v.hidden_size)),
                "gate_w": dense((vd, v.hidden_size, v.intermediate_size)),
                "gate_b": zeros((vd, v.intermediate_size)),
                "up_w": dense((vd, v.hidden_size, v.intermediate_size)),
                "up_b": zeros((vd, v.intermediate_size)),
                "down_w": dense((vd, v.intermediate_size, v.hidden_size)),
                "down_b": zeros((vd, v.hidden_size)),
            },
            "merger_ln_q": ones((v.hidden_size,)),
            "merger_fc1_w": dense((merged, merged)),
            "merger_fc1_b": zeros((merged,)),
            "merger_fc2_w": dense((merged, v.out_hidden_size)),
            "merger_fc2_b": zeros((v.out_hidden_size,)),
        }
    return params
