"""Process bring-up over torch.distributed, the counterpart of
socioreasoner_tpu/runtime/initialize.py.

The launcher contract is the JAX package's (and the reference's
driver_utils): RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the
environment. `init` joins the process group from them; every process then
runs the same host driver on the same data and is the controller of its own
device grid (parallel/mesh.py, with the dp axis split over the processes),
and host-side driver work runs on process 0 only (`is_driver`).

The backend is gloo on the CPU and NCCL when each process has a card of
its own. NCCL refuses two ranks on one device, so processes that share a
card take gloo too, and utils/collective.py stages their CUDA tensors
through host memory.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch

logger = logging.getLogger(__name__)


def get_driver_rank() -> int:
    return int(os.environ.get("RANK", "0"))


def get_driver_world_size() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def get_master_addr_port() -> str:
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT", "8476")
    return f"{addr}:{port}"


def default_backend() -> str:
    """NCCL when every process of this host has a CUDA device of its own
    (LOCAL_WORLD_SIZE, else WORLD_SIZE, processes on the host), else gloo."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", get_driver_world_size()))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def init(timeout_s: int = 300, backend: str = None) -> None:
    """Join the process group (a no-op for a single process)."""
    world = get_driver_world_size()
    if world <= 1:
        logger.info("single process; skipping torch.distributed.init_process_group")
        return
    import torch.distributed as dist
    backend = backend or default_backend()
    dist.init_process_group(backend, init_method=f"tcp://{get_master_addr_port()}",
                            world_size=world, rank=get_driver_rank(),
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("joined the process group: process %d/%d over %s",
                get_driver_rank(), world, backend)


def is_driver() -> bool:
    return get_driver_rank() == 0
