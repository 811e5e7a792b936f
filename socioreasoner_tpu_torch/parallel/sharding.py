"""Sharding rules for the Qwen2.5-VL parameter tree, the counterpart of
socioreasoner_tpu/parallel/sharding.py.

The spec tables are the JAX package's, key for key: a `P` is a tuple of mesh
axis names (or None) per tensor dim, as a jax PartitionSpec is. The
Megatron layout over "tp":
  column-parallel (q/k/v, gate/up, the vocab of embed and lm_head) → the
  output dim split; row-parallel (o_proj, down_proj) → the input dim split;
  MoE expert stacks → the expert dim split (ep folded into tp).

Where GSPMD lays one global tree over a mesh, `shard_params` here cuts the
tree into one tree a shard, each on its device: a dim over "tp" becomes the
shard's contiguous block of that dim, every other leaf a copy ("fsdp" is not
cut: the serving plane shards over tp only). A quantized tree's per-output-
channel scales follow their weight's output dim: sliced with a column-
parallel weight, whole beside a row-parallel one (the JAX tables replicate
them and GSPMD slices them against the sharded product). Nibble-packed int4
weights and any key the tables do not know are copied whole.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch


class P(tuple):
    """A partition spec: one mesh axis name (or None) per tensor dim."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def text_layer_specs() -> Dict[str, P]:
    """Specs for the stacked text layers (leading axis = layer)."""
    return {
        "input_ln": P(), "post_ln": P(),
        "q_w": P(None, "fsdp", "tp"), "q_b": P(None, "tp"),
        "k_w": P(None, "fsdp", "tp"), "k_b": P(None, "tp"),
        "v_w": P(None, "fsdp", "tp"), "v_b": P(None, "tp"),
        "o_w": P(None, "tp", "fsdp"),
        "gate_w": P(None, "fsdp", "tp"),
        "up_w": P(None, "fsdp", "tp"),
        "down_w": P(None, "tp", "fsdp"),
    }


def vision_block_specs() -> Dict[str, P]:
    return {
        "norm1": P(), "norm2": P(),
        "qkv_w": P(None, "fsdp", "tp"), "qkv_b": P(None, "tp"),
        "proj_w": P(None, "tp", "fsdp"), "proj_b": P(),
        "gate_w": P(None, "fsdp", "tp"), "gate_b": P(None, "tp"),
        "up_w": P(None, "fsdp", "tp"), "up_b": P(None, "tp"),
        "down_w": P(None, "tp", "fsdp"), "down_b": P(),
    }


MOE_SPECS = {
    "router_w": P(),
    "gate_w": P(None, "tp", "fsdp", None),
    "up_w": P(None, "tp", "fsdp", None),
    "down_w": P(None, "tp", None, "fsdp"),
    # qwen2_moe shared expert: dense megatron column/row split
    "s_gate_w": P(None, "fsdp", "tp"),
    "s_up_w": P(None, "fsdp", "tp"),
    "s_down_w": P(None, "tp", "fsdp"),
    "sgate_w": P(),
}


def _is_uint8(x) -> bool:
    return getattr(x, "dtype", None) == torch.uint8


def param_specs(params: Dict) -> Dict:
    """A spec tree matching the params tree (the JAX package's tables)."""
    base = text_layer_specs()
    layer_specs = {}
    for key, v in params["layers"].items():
        if getattr(v, "ndim", 0) == 4 and key in MOE_SPECS:
            layer_specs[key] = MOE_SPECS[key]
        else:
            layer_specs[key] = base.get(key, MOE_SPECS.get(key, P()))
    specs: Dict[str, Any] = {
        "embed": P("tp", "fsdp"),       # vocab-parallel embedding
        "final_ln": P(),
        "layers": layer_specs,
    }
    if "lm_head" in params:             # nibble-packed int4: replicate
        specs["lm_head"] = P() if _is_uint8(params["lm_head"]) else P("fsdp", "tp")
    if "lm_head_q" in params:           # tied head, pre-quantized (H, V)
        specs["lm_head_q"] = (P("fsdp", "tp") if params["lm_head_q"].dtype == torch.int8
                              else P())
    if "vision" in params:
        vtop = {
            "patch_embed_w": P("fsdp", "tp"),
            "merger_ln_q": P(),
            "merger_fc1_w": P("fsdp", "tp"), "merger_fc1_b": P("tp"),
            "merger_fc2_w": P("tp", "fsdp"), "merger_fc2_b": P(),
        }
        vblock = vision_block_specs()
        specs["vision"] = {
            k: ({n: vblock.get(n, P()) for n in v} if k == "blocks" else vtop.get(k, P()))
            for k, v in params["vision"].items()
        }
    # scales, nibble-packed int4 and anything else the tables don't know
    specs.update({k: P() for k in params if k not in specs})
    return specs


def shard_specs(params: Dict) -> Dict:
    """The specs shard_params applies: param_specs, with nibble-packed int4
    leaves whole, and each `<w>_scale` of an int8 weight split over tp on
    its last dim where the weight's output (last) dim is; the tied head's
    lm_head_scale follows lm_head_q."""
    def fix(tree: Dict, spec_tree: Dict) -> Dict:
        out = {}
        for key, spec in spec_tree.items():
            if isinstance(spec, dict):
                out[key] = fix(tree[key], spec)
                continue
            out[key] = P() if _is_uint8(tree[key]) else spec
            if key.endswith("_scale"):
                w_key = key[:-len("_scale")]
                if key == "lm_head_scale":
                    w_key = "lm_head" if "lm_head" in tree else "lm_head_q"
                w, w_spec = tree.get(w_key), spec_tree.get(w_key)
                if (w is not None and w.dtype == torch.int8 and w_spec
                        and w_spec[-1] == "tp"):
                    out[key] = P(*([None] * (tree[key].dim() - 1)), "tp")
        return out
    return fix(params, param_specs(params))


def shard_leaf(x: torch.Tensor, spec: Sequence, devices: Sequence[torch.device],
               axis: str = "tp") -> List[torch.Tensor]:
    """One leaf → its T shards, each on its device: the contiguous block t
    of the dim over `axis`, or a copy of the whole leaf."""
    T = len(devices)
    dims = [d for d, a in enumerate(spec) if a == axis]
    if not dims or T == 1:
        return [x.to(dev) for dev in devices]
    d = dims[0]
    if x.shape[d] % T:
        raise ValueError(f"tp={T} must divide dim {d} of a {tuple(x.shape)} leaf")
    return [part.to(dev).contiguous() for part, dev in zip(x.chunk(T, dim=d), devices)]


def shard_params(params: Dict, devices: Sequence, axis: str = "tp") -> List[Dict]:
    """The tree as T trees, shard t on devices[t] (see the module doc)."""
    devices = [torch.device(d) for d in devices]
    specs = shard_specs(params)

    def walk(tree, spec_tree):
        out = [dict() for _ in devices]
        for key, v in tree.items():
            parts = (walk(v, spec_tree[key]) if isinstance(v, dict)
                     else shard_leaf(v, spec_tree[key], devices, axis))
            for o, part in zip(out, parts):
                o[key] = part
        return out

    return walk(params, specs)
