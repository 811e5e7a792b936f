"""Device meshes and the canonical axis names, the counterpart of
socioreasoner_tpu/parallel/mesh.py.

The JAX package lays a `jax.sharding.Mesh` over its devices and lets GSPMD
insert the collectives. The port runs the serving and train planes as one
controller over explicit device lists: a `Mesh` here is a named grid of
`torch.device`s, and the code that shards over an axis (the tensor-parallel
decode engine over "tp", the train step over dp, fsdp, pp, sp and tp) takes
that axis's devices and moves the tensors itself. A device may appear more than
once, so two shards can share one card.

Several processes (runtime/initialize.py) split a mesh along dp: each holds
the grid of its own dp rows (`process_count` > 1), `shape` gives the global
sizes, and utils/collective.py reduces across the processes.

Canonical axes:
  dp    — data parallel (batch dim)
  fsdp  — parameter/optimizer sharding (batch also sharded here)
  pp    — pipeline stages (layer chunks)
  tp    — tensor/model parallel (heads, mlp hidden, vocab)
  sp    — sequence/context parallel
  ep    — expert parallel (folded into tp)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXES = ("dp", "fsdp")
MODEL_AXIS = "tp"
SEQ_AXIS = "sp"
AXIS_NAMES = ("dp", "fsdp", "pp", "sp", "tp")


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1  # folded into tp at mesh level; kept for config parity

    @property
    def world_size(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp


class Mesh:
    """A grid of torch devices with named axes (dp, fsdp, pp, sp, tp)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = AXIS_NAMES,
                 process_index: int = 0, process_count: int = 1):
        """`devices`: this process's grid; with process_count > 1 it holds the
        dp rows process_index * dp_local .. of a mesh whose dp axis spans
        the processes."""
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_index = process_index
        self.process_count = process_count

    @property
    def local_shape(self) -> Dict[str, int]:
        """The axis sizes of this process's grid."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def shape(self) -> Dict[str, int]:
        """The global axis sizes (dp over every process)."""
        shape = self.local_shape
        shape["dp"] = shape.get("dp", 1) * self.process_count
        return shape

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along `axis` at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        index = tuple(slice(None) if j == i else 0 for j in range(self.devices.ndim))
        return list(self.devices[index])


def default_devices() -> List[torch.device]:
    """Every visible CUDA device. Without CUDA the caller names the devices
    (e.g. [torch.device("cpu")] * n)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible: pass the devices explicitly "
                           "(for example [torch.device('cpu')] * n)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1,
              devices: Optional[Sequence] = None, process_index: int = 0,
              process_count: int = 1) -> Mesh:
    """The first dp*fsdp*pp*sp*tp devices as a (dp, fsdp, pp, sp, tp) grid:
    pp sits outside sp and tp so that a stage's tensor-parallel group holds
    adjacent devices. With process_count > 1, `dp` is the global size and
    `devices` this process's: its grid holds dp / process_count rows."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices())]
    if dp % process_count:
        raise ValueError(f"dp={dp} does not split over {process_count} processes")
    dp //= process_count
    need = dp * fsdp * tp * sp * pp
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Mesh(arr.reshape(dp, fsdp, pp, sp, tp), process_index=process_index,
                process_count=process_count)


def auto_mesh(n_devices: Optional[int] = None, tp: int = 1, sp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Fill the remaining devices into fsdp."""
    devices = list(devices) if devices is not None else default_devices()
    n = n_devices if n_devices is not None else len(devices)
    assert n % (tp * sp) == 0, f"{n} devices not divisible by tp*sp={tp * sp}"
    return make_mesh(dp=1, fsdp=n // (tp * sp), tp=tp, sp=sp, devices=devices[:n])


def tp_devices(mesh, axis: str = MODEL_AXIS) -> List[torch.device]:
    """The tensor-parallel devices of a Mesh's `axis`, or of a plain device
    list."""
    if isinstance(mesh, Mesh):
        return mesh.axis_devices(axis)
    return [torch.device(d) for d in mesh]


def batch_divisor(mesh: Optional[Mesh]) -> int:
    """The global rows a batch must be a multiple of: dp x fsdp (1 without
    a mesh), as the JAX strategies' _batch_divisor."""
    if mesh is None:
        return 1
    return mesh.shape.get("dp", 1) * mesh.shape.get("fsdp", 1)


def data_ranks(mesh: Mesh) -> List[Tuple[int, int, int]]:
    """This process's data ranks in batch order, as (global rank, local dp
    index, fsdp index): the batch's leading dim splits over (dp, fsdp), rank
    d * fsdp + f taking block number d * fsdp + f, as a jax
    PartitionSpec(("dp", "fsdp")) lays it."""
    shape = mesh.local_shape
    dl, F = shape.get("dp", 1), shape.get("fsdp", 1)
    first = mesh.process_index * dl
    return [((first + d) * F + f, d, f) for d in range(dl) for f in range(F)]


def split_rows(n_rows: int, parts: int) -> List[slice]:
    """The row slices of `parts` equal blocks of n_rows."""
    if n_rows % parts:
        raise ValueError(f"{n_rows} rows do not split over {parts} data ranks: pad the "
                         "batch to the mesh's divisor (batch_divisor)")
    b = n_rows // parts
    return [slice(r * b, (r + 1) * b) for r in range(parts)]


def rank_devices(mesh: Mesh, d: int, f: int) -> np.ndarray:
    """The (pp, sp, tp) grid of devices of the local data rank (d, f): its
    pipeline stages, each stage's sp rows, each row's tp devices."""
    return mesh.devices[d, f]
