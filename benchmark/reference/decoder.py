"""The plain reference of the decoders the benchmark serves: a pre-norm
transformer with grouped-query attention, rotary positions (1-D, or
Qwen2.5-VL's three-axis M-RoPE), RMSNorm and a SwiGLU MLP, as the published
Llama and Qwen2 descriptions give it (HF `LlamaForCausalLM`,
`Qwen2_5_VLForConditionalGeneration`'s text model).

Plain PyTorch, no kernels, no cache, no batching: one sequence at a time,
layer by layer, each layer's weights cast as it runs, so that a 7B model
fits beside its activations. By default in float32 with TF32 off. The
weights are the benchmark's own tree (weights.py): the same tensors the
program is given. `weight_fn(name, w)` may transform each weight before use
(the lower-precision controls quantize there), and `dtype` sets the
precision that activations and products take.

It imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch

LAYER_KEYS = ("input_ln", "post_ln", "q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "o_w",
              "gate_w", "up_w", "down_w")


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * w.float()
    return y.to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                section: Optional[Sequence[int]] = None):
    """cos, sin (T, head_dim) in float64 for positions (3, T) (t, h, w) or
    (T,). M-RoPE (HF Qwen2.5-VL): frequency i of the first half takes the
    axis whose section holds it, sections (t, h, w) laid out over the
    head_dim / 2 frequencies; without a section every frequency follows the
    first axis (1-D RoPE)."""
    if positions.dim() == 1:
        positions = positions[None].expand(3, -1)
    half = head_dim // 2
    inv = 1.0 / (float(theta) ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                                device=positions.device) / head_dim))
    freqs = positions.double()[..., None] * inv            # (3, T, half)
    axis = torch.zeros(half, dtype=torch.long, device=positions.device)
    if section is not None:
        start = 0
        for a, s in enumerate(section):
            axis[start:start + s] = a
            start += s
    sel = freqs.gather(0, axis[None, None, :].expand(1, freqs.shape[1], half))[0]
    emb = torch.cat([sel, sel], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (T, heads, D) with the rotate-half convention."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c, s = cos[:, None, :].to(x.dtype), sin[:, None, :].to(x.dtype)
    return x * c + rot * s


def causal_attention(q, k, v, block: int = 1024):
    """softmax(q k^T / sqrt(D) + causal mask) v for q (T, H, D), k/v (T,
    Hkv, D), H a multiple of Hkv; queries in blocks."""
    T, H, D = q.shape
    rep = H // k.shape[1]
    kh = k.repeat_interleave(rep, dim=1).transpose(0, 1)   # (H, T, D)
    vh = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    scale = D ** -0.5
    for a in range(0, T, block):
        b = min(T, a + block)
        qh = q[a:b].transpose(0, 1)                          # (H, n, D)
        s = (qh @ kh[:, :b].transpose(1, 2)).float() * scale
        mask = torch.arange(b, device=q.device)[None, :] > torch.arange(a, b, device=q.device)[:, None]
        s.masked_fill_(mask[None], float("-inf"))
        p = torch.softmax(s, dim=-1).to(q.dtype)
        out[a:b] = (p @ vh[:, :b]).transpose(0, 1)
    return out


def identity(name: str, w: torch.Tensor) -> torch.Tensor:
    return w


def decoder_hidden(cfg: Dict, tree: Dict, ids: torch.Tensor, positions: torch.Tensor,
                   *, image_embeds: Optional[torch.Tensor] = None,
                   image_token_id: Optional[int] = None,
                   weight_fn: Callable = identity, dtype=torch.float32,
                   mrope_section: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The final-norm hidden states (T, hidden) of one sequence `ids` (T,)
    at `positions` ((3, T) or (T,)). Image embeddings, where given, take the
    places of the image token's ids in order."""
    H = cfg["hidden_size"]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg.get("head_dim") or H // Hq
    eps = cfg.get("rms_norm_eps", 1e-6)
    T = ids.shape[0]
    with exact_f32():
        x = tree["embed"][ids].to(dtype)
        if image_embeds is not None:
            where = (ids == image_token_id).nonzero()[:, 0]
            x[where] = image_embeds.to(dtype)
        cos, sin = rope_tables(positions, D, cfg["rope_theta"], mrope_section)
        for i in range(cfg["num_hidden_layers"]):
            p = {k: weight_fn(k, tree["layers"][k][i]).to(dtype) for k in LAYER_KEYS}
            h = rms_norm(x, p["input_ln"], eps)
            q = (h @ p["q_w"] + p["q_b"]).view(T, Hq, D)
            k = (h @ p["k_w"] + p["k_b"]).view(T, Hkv, D)
            v = (h @ p["v_w"] + p["v_b"]).view(T, Hkv, D)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            x = x + causal_attention(q, k, v).reshape(T, Hq * D) @ p["o_w"]
            h2 = rms_norm(x, p["post_ln"], eps)
            x = x + (torch.nn.functional.silu(h2 @ p["gate_w"]) * (h2 @ p["up_w"])) @ p["down_w"]
            del p, h, q, k, v, h2
        return rms_norm(x, tree["final_ln"].to(dtype), eps)


def head_weight(tree: Dict, weight_fn: Callable = identity, dtype=torch.float32):
    """(hidden, vocab): the untied head, else the embedding's transpose."""
    if "lm_head" in tree:
        return weight_fn("lm_head", tree["lm_head"]).to(dtype)
    return weight_fn("lm_head", tree["embed"].t()).to(dtype)


def logits_blocks(hidden: torch.Tensor, head: torch.Tensor, block: int = 512):
    """(start, float32 logits of rows start..start+block) over `hidden`."""
    with exact_f32():
        for a in range(0, hidden.shape[0], block):
            yield a, (hidden[a:a + block].to(head.dtype) @ head).float()
