"""Context parallelism: the zigzag sequence layout and the CP plan, the
counterpart of socioreasoner_tpu/parallel/context_parallel.py.

The sequence axis of a data rank's rows is split over the mesh's "sp"
devices. Under impl "ring" the rows are first permuted into the zigzag
layout, in which contiguous shard r holds the original chunks r and
2*cp-1-r (Megatron's get_batch_on_this_cp_rank), so that every rank of a
causal ring sees the same unmasked area; attention then runs as ring
attention (parallel/ring_attention.py), K/V rotating from sp device to sp
device. Under impl "ulysses" the layout stays in natural order and
attention runs over the full sequence of a head slice a device
(parallel/ulysses.py).

Everything here is host-side index math.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def zigzag_indices(L: int, cp: int) -> np.ndarray:
    """The permutation `perm` such that x[..., perm] lays the sequence out
    in zigzag order: contiguous shard r (size L/cp) holds original chunks r
    and 2*cp-1-r, each ascending ([C*r, C*(r+1)) then [L-C*(r+1), L-C*r)
    with C = L // (2*cp))."""
    if L % (2 * cp):
        raise ValueError(f"sequence length {L} not divisible by 2*cp={2 * cp}")
    C = L // (2 * cp)
    parts = []
    for r in range(cp):
        parts.append(np.arange(C * r, C * (r + 1)))
        parts.append(np.arange(L - C * (r + 1), L - C * r))
    return np.concatenate(parts)


def inverse_zigzag_indices(L: int, cp: int) -> np.ndarray:
    perm = zigzag_indices(L, cp)
    inv = np.empty(L, np.int64)
    inv[perm] = np.arange(L)
    return inv


@dataclasses.dataclass(frozen=True)
class CPConfig:
    """The context-parallel plan threaded through the forward and the train
    and log-prob steps. `mesh` is a parallel.mesh.Mesh whose `axis` has
    `size` devices.

    impl "ring": zigzag layout and ring attention (K/V rotate over sp).
    impl "ulysses": head-axis all-to-all; every device attends the FULL
    sequence over a head slice, so the layout stays in natural order (perm
    is the identity)."""
    mesh: object
    size: int
    axis: str = "sp"
    impl: str = "ring"

    def __post_init__(self):
        ax = self.mesh.shape
        if ax.get(self.axis, 1) != self.size:
            raise ValueError(
                f"context_parallel_size={self.size} but mesh axis "
                f"{self.axis!r} has size {ax.get(self.axis, 1)}")
        if self.impl not in ("ring", "ulysses"):
            raise ValueError(f"context_parallel_impl must be 'ring' or "
                             f"'ulysses', got {self.impl!r}")

    def perm(self, L: int) -> np.ndarray:
        if self.impl == "ulysses":
            return np.arange(L)
        return zigzag_indices(L, self.size)

    def inv_perm(self, L: int) -> np.ndarray:
        if self.impl == "ulysses":
            return np.arange(L)
        return inverse_zigzag_indices(L, self.size)


def make_cp_config(mesh, context_parallel_size: int, axis: str = "sp",
                   impl: str = "ring") -> Optional[CPConfig]:
    if context_parallel_size <= 1:
        return None
    if mesh is None:
        raise ValueError("context_parallel_size > 1 requires an explicit mesh "
                         "with an 'sp' axis")
    return CPConfig(mesh=mesh, size=context_parallel_size, axis=axis, impl=impl)
