"""Device meshes and the canonical axis names, the counterpart of
socioreasoner_tpu/parallel/mesh.py.

The JAX package lays a `jax.sharding.Mesh` over its devices and lets GSPMD
insert the collectives. The port runs the serving plane as one controller
over explicit device lists: a `Mesh` here is a named grid of
`torch.device`s, and the code that shards over an axis (the tensor-parallel
decode engine over "tp") takes that axis's devices and moves the tensors
itself. A device may appear more than once, so two shards can share one
card.

Canonical axes:
  dp    — data parallel (batch dim)
  fsdp  — parameter/optimizer sharding (batch also sharded here)
  tp    — tensor/model parallel (heads, mlp hidden, vocab)
  sp    — sequence/context parallel
  ep    — expert parallel (folded into tp)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

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

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = AXIS_NAMES):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

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
              devices: Optional[Sequence] = None) -> Mesh:
    """The first dp*fsdp*pp*sp*tp devices as a (dp, fsdp, pp, sp, tp) grid:
    pp sits outside sp and tp so that a stage's tensor-parallel group holds
    adjacent devices."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices())]
    need = dp * fsdp * tp * sp * pp
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Mesh(arr.reshape(dp, fsdp, pp, sp, tp))


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
