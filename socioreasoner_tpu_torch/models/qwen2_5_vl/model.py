"""Qwen2.5-VL full model: embeddings + vision scatter + decoder + logits.

The counterpart of socioreasoner_tpu/models/qwen2_5_vl/model.py. Parameters
are a dict of tensors with the JAX package's layout and names, weights kept
(in, out) so `x @ W` is the same product on both sides:

  {"embed": (V, H), "layers": stacked dicts, "final_ln": (H,),
   "lm_head": (H, V) (absent if tied), "vision": {...}}

Under tensor parallelism (`tp`, the decode engine's devices) the model call
takes the per-shard trees of parallel/sharding.py: the vocab-parallel
embedding lookup (each shard's rows of its vocabulary block, selected onto
the first shard's device), the decoder's shards, and the head's vocabulary
blocks gathered into whole logits before anything samples them.

Under the train plane (`forward_mesh`) every data rank of a mesh runs the
model on its rows over its tp devices from a parallel/sharding.RankParams:
the embedding and head blocks gathered over fsdp, the decoder one layer at
a time (text.py), and the image embeddings of the rank's own samples;
under context parallelism the sequence in cp's layout over the rank's sp
rows, under pipeline parallelism the layers over its pp stages.
"""

from __future__ import annotations

import functools
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


def vocab_parallel_embed(shards, input_ids: torch.Tensor, home: torch.device
                         ) -> torch.Tensor:
    """The embedding rows of input_ids from vocab-split tables: shard t holds
    the t-th block of rows and looks up the ids in its block; each id's row
    is taken, exactly, from the shard that holds it, on `home`."""
    out, lo = None, 0
    for p in shards:
        table = p["embed"]
        n = table.shape[0]
        local = input_ids.to(table.device) - lo
        inside = (local >= 0) & (local < n)
        rows = torch.nn.functional.embedding(local.clamp(0, n - 1), table).to(home)
        out = rows if out is None else torch.where(inside.to(home)[..., None], rows, out)
        lo += n
    return out


def head_logits_tp(shards, hidden: torch.Tensor) -> torch.Tensor:
    """Each shard's vocabulary block of the logits (untied, tied or
    quantized head), gathered along the vocabulary on hidden's device. A
    nibble-packed int4 head is whole on every shard: its first copy gives
    all the logits."""
    home = hidden.device
    head = shards[0].get("lm_head", shards[0].get("lm_head_q"))
    if head is not None and head.dtype == torch.uint8:
        return head_logits(shards[0], hidden)
    return torch.cat([head_logits(p, hidden.to(p["embed"].device)).to(home)
                      for p in shards], dim=-1)


@functools.lru_cache(maxsize=None)
def rope_tables(head_dim: int, theta: float, mrope_section: Tuple[int, ...],
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The text rotary's f32 inverse frequencies and its (head_dim,) channel
    → M-RoPE axis map on `device`, copied from the host once: a decode step
    that copies from host memory cannot be captured as a CUDA graph."""
    inv_freq = torch.as_tensor(make_inv_freq(head_dim, theta), device=device)
    axis = torch.as_tensor(mrope_channel_axis(head_dim, mrope_section), dtype=torch.long,
                           device=device)
    return inv_freq, axis


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
    use_flash: Optional[bool] = None,
    cp=None,
    pp=None,
    tp=None,
    act_quant: bool = False,            # w8a8 matmuls on the cached multi-token pass
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (logits or hidden, cache). A given cache is updated in place;
    without one, the second value is {"moe_aux": ...} for an MoE family and
    None for a dense one (text_decoder). remat and use_flash apply to the
    uncached decoder, act_quant to the cached one (see text_decoder).

    With `tp`, `params` and `cache` are the per-shard lists and the result
    lies on tp[0] (the image embeddings are moved there); with `tp` and no
    cache, `params` is a train-plane rank (RankParams, see forward_mesh).

    With cp (parallel/context_parallel.CPConfig) the embeddings and the
    image scatter are computed in the ORIGINAL order, then the embeddings,
    rotary tables and mask are permuted into cp's layout (zigzag for the
    ring; the identity for Ulysses) with q_positions = the permutation:
    the returned logits or hidden states are in the PERMUTED order (map
    them back with cp.inv_perm(L)). With pp (PPConfig) the decoder runs
    the pipeline schedule over the rank's stages."""
    tcfg = config.text
    if tp is not None:
        home = torch.device(tp[0])
        shards = (params if cache is not None
                  else [{"embed": table} for table in params.top("embed")])
        embeds = vocab_parallel_embed(shards, input_ids, home)
        input_ids = input_ids.to(home)
        position_ids = position_ids.to(home)
        if image_embeds is not None:
            image_embeds = image_embeds.to(home)
    else:
        # F.embedding, not params["embed"][input_ids]: the indexing backward
        # accumulates the rows' gradients in a run-dependent order, the
        # embedding backward in a fixed one, so that a train step repeats bit
        # for bit
        embeds = torch.nn.functional.embedding(input_ids, params["embed"])

    if image_embeds is None and vision_inputs is not None:
        vi = vision_inputs
        # dense, differentiable attention (use_flash=False), as in the JAX
        # model call: this route trains the ViT
        image_embeds = vision_tower(
            config.vision, params["vision"], vi["patches"], vi["cos"], vi["sin"],
            vi["window_seg"], vi["full_seg"], vi["is_full_layer"],
            use_flash=False)[vi["inv_perm"]]
    if image_embeds is not None:
        embeds = scatter_image_embeds(input_ids, embeds, image_embeds.to(embeds.dtype),
                                      config.image_token_id)

    inv_freq, chan_axis = rope_tables(tcfg.head_dim, tcfg.rope_theta,
                                      tuple(tcfg.mrope_section), embeds.device)
    cos, sin = mrope_cos_sin(position_ids, inv_freq, chan_axis)

    # Causality follows SEQUENCE order, not M-RoPE values: image tokens share
    # equal t-positions, so masking by position value would be bidirectional.
    q_positions = None
    if cp is not None and cache is None and tp is not None:
        # the image scatter ran in the original order; now everything goes
        # into cp's layout, each token keeping its global position (without
        # a train-plane rank text_decoder refuses cp)
        B, L = input_ids.shape
        perm = torch.as_tensor(cp.perm(L), device=embeds.device)
        q_positions = perm[None].expand(B, L)
        embeds = embeds[:, perm]
        cos, sin = cos[:, perm], sin[:, perm]
        if attention_mask is not None:
            attention_mask = attention_mask[:, perm.to(attention_mask.device)]
    hidden, new_cache = text_decoder(
        tcfg, params, embeds, cos, sin, attention_mask, q_positions=q_positions,
        cache=cache, cache_positions=cache_positions, remat=remat,
        use_flash=use_flash, cp=cp, pp=pp, tp=tp, act_quant=act_quant)
    if not logits:
        return hidden, new_cache
    if tp is not None:
        return head_logits_tp(params if cache is not None else rank_heads(params),
                              hidden), new_cache
    return head_logits(params, hidden), new_cache


def rank_heads(rank) -> list:
    """A train-plane rank's head, one {"lm_head"} (untied) or {"embed"}
    (tied) block a tp device, gathered over fsdp."""
    if "lm_head" in rank:
        return [{"lm_head": w, "embed": w} for w in rank.top("lm_head")]
    return [{"embed": table} for table in rank.top("embed")]


def image_row_offsets(image_embeds: torch.Tensor, n_samples: int, rows=None):
    """Offsets into the packed image embeddings a sample: from its row
    counts (meta["image_embeds_rows"], ragged in agentic batches), else
    equal rows a sample."""
    if rows is None:
        rows = [image_embeds.shape[0] // max(n_samples, 1)] * n_samples
    offs = [0]
    for r in (rows.tolist() if hasattr(rows, "tolist") else rows):
        offs.append(offs[-1] + int(r))
    return offs


def forward_mesh(config: Qwen25VLConfig, ranks, row_slices, input_ids, position_ids,
                 attention_mask=None, *, image_embeds=None, image_rows=None,
                 remat: bool = False, logits: bool = True, use_flash: Optional[bool] = None,
                 cp=None, pp=None):
    """The model over a train mesh: ranks[r] (RankParams) runs rows
    row_slices[r] of the batch (input_ids (B, L) etc., on any device) on its
    own devices, with the image embeddings of its own samples (their offsets
    from `image_rows` or equal rows a sample). Returns (a list of each
    rank's logits or hidden states on its first device, {"moe_aux": the
    load-balance loss of the whole batch, summed over layers, on the first
    rank's device} for MoE configs, else None). cp and pp as in forward:
    under cp each rank's outputs are in cp's layout."""
    n = input_ids.shape[0]
    offs = None if image_embeds is None else image_row_offsets(image_embeds, n, image_rows)
    outs, stats, n_tokens = [], None, 0
    for rank, rows in zip(ranks, row_slices):
        home = rank.home
        img = None
        if offs is not None and offs[rows.stop] > offs[rows.start]:
            img = image_embeds[offs[rows.start]:offs[rows.stop]].to(home)
        mask = None if attention_mask is None else attention_mask[rows].to(home)
        out, aux = forward(config, rank, input_ids[rows].to(home), position_ids[rows].to(home),
                           mask, image_embeds=img, remat=remat, logits=logits,
                           use_flash=use_flash, cp=cp, pp=pp, tp=rank.devices)
        outs.append(out)
        if aux is not None:
            first = ranks[0].home
            layer_stats = torch.stack([st.to(first) for st in aux["moe_stats"]])
            stats = layer_stats if stats is None else stats + layer_stats
            n_tokens += out.shape[0] * out.shape[1]
    if stats is None:
        return outs, None
    from .text import moe_aux_from_stats
    return outs, {"moe_aux": sum(moe_aux_from_stats(st, n_tokens) for st in stats)}


# ------------------------------------------------------------------ random init

def init_params(config: Qwen25VLConfig, generator: torch.Generator,
                dtype=torch.float32, device=None, with_vision: bool = True) -> Dict:
    """Random init at the JAX init_params shapes (N(0, 0.02) weights, unit
    norms, zero biases; an MoE family's router and expert stacks (L, E, in,
    out) in place of the dense MLP) on `device` (the GPU unless one is
    named), drawn from `generator`, which must live on that device. Each
    expert stack is drawn a layer at a time into its `dtype` stack: drawn
    whole in f32, a 30B model's (48, 128, 2048, 768) stack alone would take
    39 GB. No init for the qwen2 ViT, as in the JAX package."""
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

    def layerwise(shape):
        out = torch.empty((L,) + shape, dtype=dtype, device=device)
        for i in range(L):
            out[i] = dense(shape)
        return out

    # the embedding is drawn first: every leaf's values follow the draw order
    embed = dense((t.vocab_size, t.hidden_size))
    layers = {
        "input_ln": ones((L, t.hidden_size)),
        "post_ln": ones((L, t.hidden_size)),
        "q_w": stack((t.hidden_size, H * D)), "q_b": zeros((L, H * D)),
        "k_w": stack((t.hidden_size, Hkv * D)), "k_b": zeros((L, Hkv * D)),
        "v_w": stack((t.hidden_size, Hkv * D)), "v_b": zeros((L, Hkv * D)),
        "o_w": stack((H * D, t.hidden_size)),
    }
    if t.n_experts:     # MoE family: routed expert stacks (L, E, in, out)
        E, I = t.n_experts, t.intermediate_size
        layers.update({
            "router_w": stack((t.hidden_size, E)),
            "gate_w": layerwise((E, t.hidden_size, I)),
            "up_w": layerwise((E, t.hidden_size, I)),
            "down_w": layerwise((E, I, t.hidden_size)),
        })
        if t.shared_expert_intermediate:   # qwen2_moe shared MLP + sigmoid gate
            Is = t.shared_expert_intermediate
            layers.update({
                "s_gate_w": stack((t.hidden_size, Is)),
                "s_up_w": stack((t.hidden_size, Is)),
                "s_down_w": stack((Is, t.hidden_size)),
                "sgate_w": stack((t.hidden_size, 1)),
            })
    else:
        layers.update({
            "gate_w": stack((t.hidden_size, t.intermediate_size)),
            "up_w": stack((t.hidden_size, t.intermediate_size)),
            "down_w": stack((t.intermediate_size, t.hidden_size)),
        })
    params = {"embed": embed, "final_ln": ones((t.hidden_size,)), "layers": layers}
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
