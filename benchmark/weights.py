"""Seeded random weights, made on the device in the type they are served in.

One torch.Generator on the card draws every leaf, a stacked (layers, ...)
tensor at a time, so a 7B tree takes a dozen calls. The tree uses the
port's layout and names (weights kept (in, out), so x @ W), which the plain
reference reads too: both sides get these same tensors. N(0, 0.02) for
matrices and biases, 1 + N(0, 0.02) for norm scales (so that a scale left
out shows), zero biases where the architecture has none.
"""

from __future__ import annotations

from typing import Dict

import torch

STD = 0.02


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))


def text_weights(cfg: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The decoder's tree from a configuration file's sizes (HF key names)."""
    g = _gen(seed, device)
    L, H = cfg["num_hidden_layers"], cfg["hidden_size"]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg.get("head_dim") or H // Hq
    inter, V = cfg["intermediate_size"], cfg["vocab_size"]

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(STD)

    def scale(*shape):
        return normal(*shape).add_(1.0)

    bias = cfg.get("attention_bias", False)

    def qkv_bias(n):
        return normal(L, n) if bias else torch.zeros((L, n), device=device, dtype=dtype)

    tree = {
        "embed": normal(V, H),
        "final_ln": scale(H),
        "layers": {
            "input_ln": scale(L, H), "post_ln": scale(L, H),
            "q_w": normal(L, H, Hq * D), "q_b": qkv_bias(Hq * D),
            "k_w": normal(L, H, Hkv * D), "k_b": qkv_bias(Hkv * D),
            "v_w": normal(L, H, Hkv * D), "v_b": qkv_bias(Hkv * D),
            "o_w": normal(L, Hq * D, H),
            "gate_w": normal(L, H, inter), "up_w": normal(L, H, inter),
            "down_w": normal(L, inter, H),
        },
    }
    if not cfg.get("tie_word_embeddings", False):
        tree["lm_head"] = normal(H, V)
    return tree


def vision_weights(v: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The Qwen2.5-VL ViT's tree from the vision_config's sizes."""
    g = _gen(seed ^ 0x5EED, device)
    d, hid, inter = v["depth"], v["hidden_size"], v["intermediate_size"]
    patch_in = v["in_chans"] * v["temporal_patch_size"] * v["patch_size"] ** 2
    merged = v["spatial_merge_size"] ** 2 * hid
    out = v["out_hidden_size"]

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(STD)

    def scale(*shape):
        return normal(*shape).add_(1.0)

    return {
        "patch_embed_w": normal(patch_in, hid),
        "blocks": {
            "norm1": scale(d, hid), "norm2": scale(d, hid),
            "qkv_w": normal(d, hid, 3 * hid), "qkv_b": normal(d, 3 * hid),
            "proj_w": normal(d, hid, hid), "proj_b": normal(d, hid),
            "gate_w": normal(d, hid, inter), "gate_b": normal(d, inter),
            "up_w": normal(d, hid, inter), "up_b": normal(d, inter),
            "down_w": normal(d, inter, hid), "down_b": normal(d, hid),
        },
        "merger_ln_q": scale(hid),
        "merger_fc1_w": normal(merged, merged), "merger_fc1_b": normal(merged),
        "merger_fc2_w": normal(merged, out), "merger_fc2_b": normal(out),
    }
