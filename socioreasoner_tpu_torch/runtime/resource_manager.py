"""Device bookkeeping: a role's device_mapping → its device layout, the
counterpart of socioreasoner_tpu/runtime/resource_manager.py.

Roles get slices of the device list: overlapping device_mappings are the
co-located default (roles share the resident weights), disjoint ones give
separate train and infer devices (weights move through
distributed/transfer.py). The devices are the visible CUDA devices unless
the manager is given a list (which may name one device several times).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..configs.worker_config import WorkerConfig
from ..parallel.mesh import Mesh, default_devices, make_mesh


class ResourceManager:
    def __init__(self, devices: Optional[Sequence] = None):
        self.devices = [torch.device(d) for d in (devices if devices is not None
                                                  else default_devices())]
        self.role_meshes: Dict[str, Optional[Mesh]] = {}
        self.role_devices: Dict[str, list] = {}

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def allocate_mesh(self, role: str, worker_config: WorkerConfig,
                      tp: int = 1, sp: int = 1) -> Optional[Mesh]:
        """The role's mesh from its device_mapping (indices into the device
        list) and its strategy_config knobs (tensor_model_parallel_size,
        context_parallel_size, pipeline_model_parallel_size, dp_size,
        fsdp_size). None for one device with every knob at 1; raises on
        knobs the devices cannot satisfy."""
        mapping = worker_config.resolved_device_mapping()
        if mapping is None:
            devices = self.devices
        else:
            missing = [i for i in mapping if i >= len(self.devices)]
            if missing:
                raise ValueError(
                    f"role {role}: device_mapping {mapping} exceeds available "
                    f"{len(self.devices)} devices")
            devices = [self.devices[i] for i in mapping]
        strat_cfg = worker_config.strategy_args.config
        tp = int(strat_cfg.get("tensor_model_parallel_size", tp) or 1)
        cp = int(strat_cfg.get("context_parallel_size", sp) or 1)
        pp = int(strat_cfg.get("pipeline_model_parallel_size", 1) or 1)
        dp = int(strat_cfg.get("dp_size", 1) or 1)
        n = len(devices)
        self.role_devices[role] = devices
        mp = tp * cp * pp * dp
        if n == 1 and mp == 1:
            self.role_meshes[role] = None
            return None
        if n % mp != 0:
            raise ValueError(
                f"role {role}: {n} devices not divisible by "
                f"tp({tp})*cp({cp})*pp({pp})*dp({dp})={mp} — fix the yaml "
                "strategy_config or device_mapping")
        fsdp_req = int(strat_cfg.get("fsdp_size", -1) or -1)
        fsdp = n // mp
        if fsdp_req not in (-1, 0) and fsdp_req != fsdp:
            raise ValueError(
                f"role {role}: fsdp_size={fsdp_req} inconsistent with "
                f"{n} devices / (tp*cp*pp*dp={mp}) = {fsdp}")
        mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp, sp=cp, pp=pp, devices=devices)
        self.role_meshes[role] = mesh
        return mesh

    def colocated(self, role_a: str, role_b: str) -> bool:
        """True if two roles share a device."""
        def devs(role):
            mesh = self.role_meshes.get(role)
            if mesh is not None:
                return {str(d) for d in mesh.devices.reshape(-1)}
            return {str(d) for d in (self.role_devices.get(role) or self.devices[:1])}
        return bool(devs(role_a) & devs(role_b))
