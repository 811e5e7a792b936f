"""HF Qwen2.5-VL checkpoint → the port's parameter tree.

The port's counterpart of socioreasoner_tpu/models/qwen2_5_vl/loader.py,
with the same name map (qwen2.5 and qwen2 ViTs, dense, MoE and
shared-expert decoders, both name layouts: legacy "model.layers.*" /
"visual.*" and transformers>=4.52 "model.language_model.*" /
"model.visual.*") and the same tree: linear weights transposed from HF's
(out, in) to (in, out), layer tensors stacked along a leading layer axis,
zero q/k/v biases filled for checkpoints that ship none. The model raises
for the variants it does not run (text.py, vision.py); the loader maps
them all.

Tensors stream from utils/safetensors_io.py. Each stacked leaf is
allocated on the device when its first layer arrives and every layer is
copied into it as it comes, so the host holds no stacked tree (the JAX
loader builds the whole tree in numpy first).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import torch

from ...utils.safetensors_io import iter_safetensors
from .config import Qwen25VLConfig
from .convert import param_device

TXT_LAYER_MAP = {
    "input_layernorm.weight": ("input_ln", False),
    "post_attention_layernorm.weight": ("post_ln", False),
    "self_attn.q_proj.weight": ("q_w", True), "self_attn.q_proj.bias": ("q_b", False),
    "self_attn.k_proj.weight": ("k_w", True), "self_attn.k_proj.bias": ("k_b", False),
    "self_attn.v_proj.weight": ("v_w", True), "self_attn.v_proj.bias": ("v_b", False),
    "self_attn.o_proj.weight": ("o_w", True),
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
    "mlp.gate_proj.weight": ("gate_w", True),
    "mlp.up_proj.weight": ("up_w", True),
    "mlp.down_proj.weight": ("down_w", True),
    # qwen2_moe shared expert (sigmoid-gated dense MLP beside the experts)
    "mlp.shared_expert.gate_proj.weight": ("s_gate_w", True),
    "mlp.shared_expert.up_proj.weight": ("s_up_w", True),
    "mlp.shared_expert.down_proj.weight": ("s_down_w", True),
    "mlp.shared_expert_gate.weight": ("sgate_w", True),
}
VIS_LAYER_MAP = {
    "norm1.weight": ("norm1", False), "norm2.weight": ("norm2", False),
    "attn.qkv.weight": ("qkv_w", True), "attn.qkv.bias": ("qkv_b", False),
    "attn.proj.weight": ("proj_w", True), "attn.proj.bias": ("proj_b", False),
    "mlp.gate_proj.weight": ("gate_w", True), "mlp.gate_proj.bias": ("gate_b", False),
    "mlp.up_proj.weight": ("up_w", True), "mlp.up_proj.bias": ("up_b", False),
    "mlp.down_proj.weight": ("down_w", True), "mlp.down_proj.bias": ("down_b", False),
    # qwen2_vl variant: LayerNorm biases + fc1/fc2 MLP
    "norm1.bias": ("norm1_b", False), "norm2.bias": ("norm2_b", False),
    "mlp.fc1.weight": ("fc1_w", True), "mlp.fc1.bias": ("fc1_b", False),
    "mlp.fc2.weight": ("fc2_w", True), "mlp.fc2.bias": ("fc2_b", False),
}
VIS_LEAF_MAP = {   # visual.<name> → (leaf, transpose)
    "merger.ln_q.weight": ("merger_ln_q", False),
    "merger.ln_q.bias": ("merger_ln_q_b", False),   # qwen2_vl LayerNorm merger
    "merger.mlp.0.weight": ("merger_fc1_w", True),
    "merger.mlp.0.bias": ("merger_fc1_b", False),
    "merger.mlp.2.weight": ("merger_fc2_w", True),
    "merger.mlp.2.bias": ("merger_fc2_b", False),
}
# MoE (qwen3_moe / mixtral): HF expert suffix → (leaf, mixtral w-name)
MOE_EXPERT_MAP = {"gate_proj": ("gate_w", "w1"), "up_proj": ("up_w", "w3"),
                  "down_proj": ("down_w", "w2")}
MIXTRAL_NAMES = {w: key for key, w in MOE_EXPERT_MAP.values()}


def _normalize(name: str) -> str:
    name = re.sub(r"^model\.language_model\.", "model.", name)
    name = re.sub(r"^model\.visual\.", "visual.", name)
    return name


class _Stacks:
    """Leaves stacked along leading axes of size `lead`, allocated on the
    device at the first entry and filled entry by entry."""

    def __init__(self, lead: Tuple[int, ...], dtype, device):
        self.lead, self.dtype, self.device = lead, dtype, device
        self.leaves: Dict[str, torch.Tensor] = {}
        self.filled: Dict[str, set] = {}

    def put(self, key: str, index: Tuple[int, ...], arr: torch.Tensor, transpose: bool):
        # the source goes to the device as it is in the file; the transpose
        # and the cast run there
        src = arr.to(self.device)
        src = src.T if transpose else src
        if key not in self.leaves:
            self.leaves[key] = torch.empty(self.lead + tuple(src.shape), dtype=self.dtype,
                                           device=self.device)
            self.filled[key] = set()
        self.leaves[key][index].copy_(src)
        self.filled[key].add(index)

    def done(self, what: str) -> Dict[str, torch.Tensor]:
        n = 1
        for d in self.lead:
            n *= d
        missing = sorted(k for k, f in self.filled.items() if len(f) != n)
        if missing:
            raise ValueError(f"missing {what} tensors for {missing}")
        return self.leaves


def load_params(config: Qwen25VLConfig, tensors: Iterator[Tuple[str, torch.Tensor]],
                dtype=torch.bfloat16, with_vision: bool = True, device=None) -> Dict:
    """The parameter tree, as `dtype` tensors on `device` (the GPU unless
    one is named), from an HF (name, tensor) stream."""
    device = param_device(device)
    t, v = config.text, config.vision
    L, E = t.num_hidden_layers, t.n_experts
    txt = _Stacks((L,), dtype, device)
    vis = _Stacks((v.depth,), dtype, device)
    moe = _Stacks((L, E), dtype, device)
    params: Dict = {"layers": {}}
    vision: Dict = {"blocks": {}}

    def leaf(arr: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        # a new tensor always: never a view of the file's map
        src = arr.to(device)
        src = src.T if transpose else src
        return torch.empty(src.shape, dtype=dtype, device=device).copy_(src)

    for name, arr in tensors:
        name = _normalize(name)
        arr = torch.as_tensor(arr)
        if name == "model.embed_tokens.weight":
            params["embed"] = leaf(arr)
        elif name == "model.norm.weight":
            params["final_ln"] = leaf(arr)
        elif name == "lm_head.weight":
            if not t.tie_word_embeddings:
                params["lm_head"] = leaf(arr, True)
        elif name.startswith("model.layers."):
            m = re.match(r"model\.layers\.(\d+)\.(.+)", name)
            i, rest = int(m.group(1)), m.group(2)
            if rest in TXT_LAYER_MAP:
                key, tr = TXT_LAYER_MAP[rest]
                txt.put(key, (i,), arr, tr)
            elif E and rest in ("mlp.gate.weight", "block_sparse_moe.gate.weight"):
                txt.put("router_w", (i,), arr, True)
            elif E and (m2 := re.match(
                    r"mlp\.experts\.(\d+)\.(gate_proj|up_proj|down_proj)\.weight", rest)):
                moe.put(MOE_EXPERT_MAP[m2.group(2)][0], (i, int(m2.group(1))), arr, True)
            elif E and (m2 := re.match(
                    r"block_sparse_moe\.experts\.(\d+)\.(w1|w2|w3)\.weight", rest)):
                moe.put(MIXTRAL_NAMES[m2.group(2)], (i, int(m2.group(1))), arr, True)
        elif with_vision and name.startswith("visual."):
            rest = name[len("visual."):]
            if rest == "patch_embed.proj.weight":
                vision["patch_embed_w"] = leaf(arr.reshape(arr.shape[0], -1), True)
            elif rest in VIS_LEAF_MAP:
                key, tr = VIS_LEAF_MAP[rest]
                vision[key] = leaf(arr, tr)
            elif rest.startswith("blocks."):
                m = re.match(r"blocks\.(\d+)\.(.+)", rest)
                if m.group(2) in VIS_LAYER_MAP:
                    key, tr = VIS_LAYER_MAP[m.group(2)]
                    vis.put(key, (int(m.group(1)),), arr, tr)

    layers = txt.done("text layer")
    # llama-family checkpoints ship no qkv biases: zeros, as in the JAX loader
    H, Hkv, D = t.num_attention_heads, t.num_key_value_heads, t.head_dim
    for key, width in (("q_b", H * D), ("k_b", Hkv * D), ("v_b", Hkv * D)):
        if key not in layers:
            layers[key] = torch.zeros((L, width), dtype=dtype, device=device)
    params["layers"] = {**layers, **moe.done("expert")}
    if with_vision:
        vision["blocks"] = vis.done("vision layer")
        params["vision"] = vision
    return params


def load_pretrained(path: str, dtype=torch.bfloat16, with_vision: bool = True,
                    device=None) -> Tuple[Qwen25VLConfig, Dict]:
    """(config, tree) of an HF checkpoint directory: config.json and its
    safetensors shards."""
    config = Qwen25VLConfig.from_pretrained(path)
    return config, load_params(config, iter_safetensors(path), dtype, with_vision, device)


def load_from_torch_state_dict(config: Qwen25VLConfig, state_dict, dtype=torch.float32,
                               with_vision: bool = True, device=None) -> Dict:
    """The tree of an in-memory HF model's state dict."""
    return load_params(config, ((k, v.detach().to("cpu")) for k, v in state_dict.items()),
                       dtype, with_vision, device)
