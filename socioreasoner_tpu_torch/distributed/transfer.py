"""Train → infer weight transfer, the counterpart of
socioreasoner_tpu/distributed/transfer.py.

When the trainer and the decode engine share a device, the weight sync is
the ParamStore hand-over (distributed/strategy.py). This module covers the
separate layouts: a tree moved to another device, or cut into a
tensor-parallel engine's shards (parallel/sharding.py), in buckets of leaves
of at most `bucket_bytes`, each bucket finished before the next starts, so
that at most one bucket is in flight on the receiving devices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..parallel.mesh import Mesh, tp_devices
from ..parallel.sharding import shard_leaf, shard_specs


def tree_leaves_with_path(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in the JAX package's order (dict keys sorted, as
    jax.tree_util flattens a dict)."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(tree_leaves_with_path(tree[key], path + (key,)))
        return out
    return [(path, tree)]


def leaf_buckets(params: Any, bucket_bytes: int = 256 * 1024 * 1024
                 ) -> List[List[Tuple[Tuple, Any]]]:
    """Group the leaves into buckets of at most bucket_bytes (a leaf larger
    than that is a bucket of its own)."""
    buckets: List[List[Tuple[Tuple, Any]]] = [[]]
    used = 0
    for path, leaf in tree_leaves_with_path(params):
        nbytes = leaf.numel() * leaf.element_size()
        if used + nbytes > bucket_bytes and buckets[-1]:
            buckets.append([])
            used = 0
        buckets[-1].append((path, leaf))
        used += nbytes
    return buckets


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: Dict, path: Tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _sync(devices) -> None:
    for dev in {torch.device(d) for d in devices}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def transfer_params(params: Dict, target, bucket_bytes: Optional[int] = 256 * 1024 * 1024,
                    axis: str = "tp") -> Any:
    """Move a tree onto `target`: a device (the whole tree there), or a
    tensor-parallel layout, a parallel.mesh.Mesh or a list of devices (the
    list of per-shard trees shard_params gives, which a tensor-parallel
    engine's set_params takes as they are). With bucket_bytes, bucket by
    bucket."""
    if isinstance(target, (Mesh, list, tuple)):
        devices = tp_devices(target, axis)
        specs = shard_specs(params)
        out: List[Dict] = [{} for _ in devices]

        def move(path, leaf):
            for shard, part in zip(out, shard_leaf(leaf, _get(specs, path), devices, axis)):
                _put(shard, path, part)
    else:
        devices = [torch.device(target)]
        out = [{}]

        def move(path, leaf):
            _put(out[0], path, leaf.to(devices[0]))

    groups = (leaf_buckets(params, bucket_bytes) if bucket_bytes is not None
              else [tree_leaves_with_path(params)])
    for bucket in groups:
        for path, leaf in bucket:
            move(path, leaf)
        _sync(devices)              # bound the in-flight memory to one bucket
    return out if isinstance(target, (Mesh, list, tuple)) else out[0]


class ModelUpdateGroup:
    """A train → infer sync pair that honours its `frequency`: every
    frequency-th step the source's weights reach the target (moved onto
    `target_layout` first when one is given, a device or a tensor-parallel
    layout, and handed to the target's model_update)."""

    def __init__(self, src_strategy, tgt_strategy, frequency: int = 1,
                 target_layout: Any = None, bucket_bytes: int = 256 * 1024 * 1024):
        self.src = src_strategy
        self.tgt = tgt_strategy
        self.frequency = max(frequency, 1)
        self.target_layout = target_layout
        self.bucket_bytes = bucket_bytes

    def make_collective_group(self):
        """Nothing to set up: one controller moves the tensors itself."""

    def model_update(self, step: int = 0):
        if step % self.frequency != 0:
            return
        if self.target_layout is not None:
            params = transfer_params(self.src.params, self.target_layout, self.bucket_bytes)
            self.tgt.model_update(params=params)
        else:
            self.src.model_update()
            self.tgt.model_update()
