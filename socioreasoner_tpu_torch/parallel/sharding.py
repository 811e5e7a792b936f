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
weights split as their math does: the packing and the scale groups run
along the contraction dim, so a column-parallel leaf splits its codes and
group scales on the output dim, and a row-parallel one its packed rows and
scale rows, unless a shard boundary would cut a scale group (K / T not a
multiple of the group); such a leaf, the int4 LM head and any key the
tables do not know are copied whole, and a shard computes its slice of the
product from the whole leaf, as JAX's replicated leaf does.

The train plane (ShardedTree) cuts a float tree over a mesh's fsdp AND tp
axes by the same tables: leaf x becomes blocks[f][t], the block of fsdp
position f and tp position t of the dims the spec names (one block along
an axis it does not name), each stored once on the device of (dp 0, f, t).
A data rank gathers one layer's fsdp blocks onto its tp devices just before
that layer (RankParams), so autograd hands each block its gradient summed
over the ranks that read it: the reduce-scatter of JAX's GSPMD program.
The optimizer keeps its moments per block. A rank's devices are a (pp, sp,
tp) grid: context parallelism gathers each layer onto the tp devices of
every sp row, pipeline parallelism gathers it whole onto its stage's
device, and under pp the stacked layer leaves are stored a stage, on the
stage's devices (ShardedTree's layer_stages).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from .mesh import batch_divisor, data_ranks, rank_devices, split_rows


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


def _int4_split(w: torch.Tensor, w_spec, scale: torch.Tensor, tp: Optional[int]) -> bool:
    """Whether nibble-packed int4 leaf w (with its (..., groups, out) scale)
    splits over tp as its spec says: on the output dim always, on the
    contraction dim only where each of the tp shards holds whole scale
    groups (a tp of None is not known: kept whole)."""
    if not w_spec or "tp" not in w_spec:
        return False
    if list(w_spec).index("tp") == w.dim() - 1:
        return True
    return tp is not None and scale.shape[-2] % tp == 0


def shard_specs(params: Dict, tp: Optional[int] = None) -> Dict:
    """The specs shard_params applies over `tp` shards: param_specs, with
    each `<w>_scale` of an int8 weight split over tp on its last dim where
    the weight's output (last) dim is, nibble-packed int4 leaves and their
    group scales split on the dim their spec names where _int4_split allows
    (whole otherwise, and so is the int4 LM head); the tied head's
    lm_head_scale follows lm_head_q."""
    def fix(tree: Dict, spec_tree: Dict) -> Dict:
        out = {}
        for key, spec in spec_tree.items():
            if isinstance(spec, dict):
                out[key] = fix(tree[key], spec)
                continue
            out[key] = spec
            if _is_uint8(tree[key]) and not (
                    key + "_scale" in tree
                    and _int4_split(tree[key], spec, tree[key + "_scale"], tp)):
                out[key] = P()
            if key.endswith("_scale"):
                w_key = key[:-len("_scale")]
                if key == "lm_head_scale":
                    w_key = "lm_head" if "lm_head" in tree else "lm_head_q"
                w, w_spec = tree.get(w_key), spec_tree.get(w_key)
                nd = tree[key].dim()
                if (w is not None and w.dtype == torch.int8 and w_spec
                        and w_spec[-1] == "tp"):
                    out[key] = P(*([None] * (nd - 1)), "tp")
                elif w is not None and _is_uint8(w) and _int4_split(w, w_spec, tree[key], tp):
                    dim = list(w_spec).index("tp") - w.dim()     # -1 or -2, as the codes
                    out[key] = P(*(("tp" if d == nd + dim else None) for d in range(nd)))
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
    specs = shard_specs(params, len(devices))

    def walk(tree, spec_tree):
        out = [dict() for _ in devices]
        for key, v in tree.items():
            parts = (walk(v, spec_tree[key]) if isinstance(v, dict)
                     else shard_leaf(v, spec_tree[key], devices, axis))
            for o, part in zip(out, parts):
                o[key] = part
        return out

    return walk(params, specs)


# ------------------------------------------------------------ the train plane

def _dim(spec: Sequence, axis: str) -> Optional[int]:
    dims = [d for d, a in enumerate(spec) if a == axis]
    return dims[0] if dims else None


def _cat(parts: List[torch.Tensor], dim: Optional[int]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


class ShardedLeaf:
    """One leaf over a mesh's fsdp x tp positions and, for a stacked layer
    leaf under pipeline parallelism, over its pp stages: pieces[p][f][t] is
    stage p's layers (`stages[p]`, original layer indices in the stage's
    order; all of dim 0 without stages) cut into the contiguous block
    (torch.tensor_split) of the dim over "fsdp" (fdim) and of the dim over
    "tp" (tdim), stored on the device of (dp 0, f, p, sp 0, t); a leaf
    whose spec names neither axis keeps one block a stage. `blocks` is
    stage 0's [f][t] (every block without stages)."""

    def __init__(self, x: torch.Tensor, spec: Sequence, mesh, stages=None):
        self.shape, self.dtype = tuple(x.shape), x.dtype
        self.fdim, self.tdim = _dim(spec, "fsdp"), _dim(spec, "tp")
        shape = mesh.local_shape
        self.nf = shape.get("fsdp", 1) if self.fdim is not None else 1
        self.nt = shape.get("tp", 1) if self.tdim is not None else 1
        self.stages = None if stages is None else [list(idx) for idx in stages]
        self.pieces = [
            [[p.detach().to(device=mesh.devices[0, f, s, 0, t], copy=True,
                            memory_format=torch.contiguous_format)
              for t, p in enumerate(row)] for f, row in enumerate(self._cut(part))]
            for s, part in enumerate(self._stage_parts(x))]

    @property
    def blocks(self) -> List[List[torch.Tensor]]:
        return self.pieces[0]

    def _stage_parts(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.stages is None:
            return [x]
        return [x[torch.as_tensor(idx, device=x.device)] for idx in self.stages]

    def _cut(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        fparts = x.tensor_split(self.nf, dim=self.fdim) if self.nf > 1 else [x]
        return [part.tensor_split(self.nt, dim=self.tdim) if self.nt > 1 else [part]
                for part in fparts]

    def tensors(self) -> List[torch.Tensor]:
        return [b for piece in self.pieces for row in piece for b in row]

    def tp_block(self, t: int, parts=None, fdim=None) -> torch.Tensor:
        """The block of tp position t over the whole fsdp dim (the fsdp
        gather); `parts` replaces blocks by per-block views (one layer)."""
        parts = self.blocks if parts is None else parts
        tt = t if len(parts[0]) > 1 else 0
        return _cat([row[tt] for row in parts], self.fdim if fdim is None else fdim)

    def layer_parts(self) -> List[List[List[torch.Tensor]]]:
        """A stacked layer leaf's blocks as one [f][t] list of per-layer
        views a layer, in the original layer order (each piece unbound
        once)."""
        out = [None] * self.shape[0]
        for idx, piece in zip(self.stages or [range(self.shape[0])], self.pieces):
            views = [[b.unbind(0) for b in row] for row in piece]
            for j, i in enumerate(idx):
                out[i] = [[v[j] for v in row] for row in views]
        return out

    def whole(self, tensors: Optional[List[torch.Tensor]] = None, device=None) -> torch.Tensor:
        """The whole leaf from its blocks (or from `tensors`, aligned with
        tensors()), on `device` (the first block's when None)."""
        flat = self.tensors() if tensors is None else tensors
        device = flat[0].device if device is None else device
        per = self.nf * self.nt
        stages = []
        for s in range(len(self.pieces)):
            rows = [[flat[s * per + f * self.nt + t].to(device) for t in range(self.nt)]
                    for f in range(self.nf)]
            stages.append(_cat([_cat(row, self.tdim) for row in rows], self.fdim))
        if self.stages is None:
            return stages[0]
        order = torch.as_tensor([i for idx in self.stages for i in idx], device=device)
        return torch.cat(stages)[torch.argsort(order)]

    def split(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        """A whole tensor of this leaf's shape cut as the blocks are, flat
        over the stages (pieces[p][f][t] → [p * nf + f][t])."""
        return [row for part in self._stage_parts(x) for row in self._cut(part)]

    @torch.no_grad()
    def assign(self, x: torch.Tensor) -> None:
        """Copy the whole leaf `x` into the blocks in place."""
        rows = [row for piece in self.pieces for row in piece]
        for row, parts in zip(rows, self.split(x)):
            for block, p in zip(row, parts):
                block.copy_(p)


class ShardedTree:
    """A float parameter tree over a train mesh (see the module doc): the
    same nesting with a ShardedLeaf in place of every tensor. `leaves` are
    in trainer.tree_leaves order, and `blocks()` lists every stored block
    once (leaf by leaf, stage then f then t), which is what the optimizer
    and the global gradient norm walk. `layer_stages` (pipeline
    parallelism: PPConfig.stage_layers) lists the layers of each pp stage:
    the stacked layer leaves are then stored a stage on that stage's
    devices, and so are their optimizer moments."""

    def __init__(self, tree: Dict, mesh, specs: Optional[Dict] = None,
                 layer_stages: Optional[List[List[int]]] = None):
        self.mesh = mesh
        specs = shard_specs(tree) if specs is None else specs
        self.leaves: List[ShardedLeaf] = []

        def walk(node, spec, stages=None):
            out = {}
            for key, v in node.items():
                if isinstance(v, dict):
                    inner = layer_stages if node is tree and key == "layers" else None
                    out[key] = walk(v, spec[key], inner)
                else:
                    out[key] = ShardedLeaf(v, spec[key], mesh, stages)
                    self.leaves.append(out[key])
            return out
        self.tree = walk(tree, specs)

    def __getitem__(self, key):
        return self.tree[key]

    def __contains__(self, key) -> bool:
        return key in self.tree

    def blocks(self) -> List[torch.Tensor]:
        return [b for leaf in self.leaves for b in leaf.tensors()]

    def whole_leaves(self, tensors: List[torch.Tensor], device=None) -> List[torch.Tensor]:
        """Per-block tensors (aligned with blocks(), e.g. the optimizer's
        moments) → one whole tensor a leaf, on `device`."""
        out, i = [], 0
        for leaf in self.leaves:
            n = len(leaf.tensors())
            out.append(leaf.whole(tensors[i:i + n], device))
            i += n
        return out

    def split_leaves(self, wholes: List[torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors a leaf → per-block copies aligned with blocks(),
        each on its block's device in its block's dtype."""
        return [p.to(device=b.device, dtype=b.dtype, copy=True,
                     memory_format=torch.contiguous_format)
                for leaf, x in zip(self.leaves, wholes)
                for row, parts in zip([r for piece in leaf.pieces for r in piece],
                                      leaf.split(x))
                for b, p in zip(row, parts)]

    @torch.no_grad()
    def gather(self, device=None) -> Dict:
        """The whole tree (new tensors) on `device` (default: the mesh's
        first device): what model_update hands the decode engine and what a
        checkpoint saves."""
        device = self.mesh.devices.flat[0] if device is None else torch.device(device)

        def walk(node):
            return {k: walk(v) if isinstance(v, dict) else v.whole(device=device)
                    for k, v in node.items()}
        return walk(self.tree)

    @torch.no_grad()
    def assign(self, tree: Dict) -> None:
        """Copy a whole tree of the same structure into the blocks."""
        def walk(node, src):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, src[k])
                else:
                    v.assign(src[k])
        walk(self.tree, tree)

    def rank(self, d: int, f: int) -> "RankParams":
        return RankParams(self, rank_devices(self.mesh, d, f))

    def data_ranks(self, n_rows: int):
        """This process's data ranks in batch order: (their RankParams, their
        row slices of a batch of n_rows)."""
        slices = split_rows(n_rows, batch_divisor(self.mesh))
        local = data_ranks(self.mesh)
        return ([self.rank(d, f) for _, d, f in local], [slices[g] for g, _, _ in local])


class RankParams:
    """One data rank's view of a ShardedTree over its (pp, sp, tp) grid of
    devices (`grid`): `devices` are the tp devices of stage 0 and sp row 0,
    `home` the first of them. The top-level leaves are gathered over fsdp
    onto each tp device once a rank and step (`top`); one decoder layer is
    gathered at a time, called inside the layer's checkpoint so that the
    backward gathers again instead of keeping every layer's copy: over
    fsdp onto the tp devices of an sp row (`layer`, context parallelism
    runs every row), or over fsdp and tp onto one device (`stage_layer`,
    a pipeline stage runs its layers whole)."""

    def __init__(self, sharded: ShardedTree, grid):
        self.sharded = sharded
        self.grid = grid
        self.devices = [torch.device(d) for d in grid[0, 0]]
        self.home = self.devices[0]
        self._top: Dict[str, List[torch.Tensor]] = {}
        self._layers = None

    @property
    def sp_devices(self) -> List[List[torch.device]]:
        """The tp devices of each sp row of stage 0."""
        return [[torch.device(d) for d in row] for row in self.grid[0]]

    @property
    def stage_devices(self) -> List[torch.device]:
        """Each pp stage's first device (sp row 0, tp 0)."""
        return [torch.device(d) for d in self.grid[:, 0, 0]]

    def __contains__(self, key) -> bool:
        return key in self.sharded

    def top(self, key: str) -> List[torch.Tensor]:
        """A top-level leaf's tp blocks, fsdp gathered, one a tp device."""
        if key not in self._top:
            leaf = self.sharded[key]
            self._top[key] = [leaf.tp_block(t).to(dev) for t, dev in enumerate(self.devices)]
        return self._top[key]

    def _layer_parts(self):
        """Each stacked leaf's per-layer [f][t] views, made once a rank and
        step (the backward of one unbind stacks the layers' gradients
        once)."""
        if self._layers is None:
            self._layers = {k: leaf.layer_parts()
                            for k, leaf in self.sharded["layers"].items()}
        return self._layers

    def layer(self, i: int, devices=None) -> List[Dict[str, torch.Tensor]]:
        """Decoder layer i's leaves, one dict a tp device of `devices`
        (default: the rank's)."""
        devices = self.devices if devices is None else devices
        out = [dict() for _ in devices]
        for k, parts in self._layer_parts().items():
            leaf = self.sharded["layers"][k]
            fdim = None if leaf.fdim is None else leaf.fdim - 1
            for t, dev in enumerate(devices):
                out[t][k] = leaf.tp_block(t, parts[i], fdim).to(dev)
        return out

    def stage_layer(self, i: int, device) -> Dict[str, torch.Tensor]:
        """Decoder layer i whole (gathered over fsdp and tp) on `device`."""
        out = {}
        for k, parts in self._layer_parts().items():
            leaf = self.sharded["layers"][k]
            fdim = None if leaf.fdim is None else leaf.fdim - 1
            tdim = None if leaf.tdim is None else leaf.tdim - 1
            blocks = [leaf.tp_block(t, parts[i], fdim).to(device)
                      for t in range(len(parts[i][0]))]
            out[k] = _cat(blocks, tdim)
        return out
