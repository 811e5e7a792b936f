"""Kernel-selection flags, the counterpart of socioreasoner_tpu/ops/flags.py.

The JAX package takes its Pallas kernels on a TPU and dense XLA attention
elsewhere. The port's kernel wrappers choose for themselves by the tensor's
device: the hand-written kernel on a CUDA tensor, its plain PyTorch version
on a CPU tensor. So the kernels' route is the default wherever the tensors
are. `SOCIO_DISABLE_FLASH=1` (or an explicit False) sends the engine, the
trainer and the ViT to dense attention, as it does in the JAX package, on
CPU tensors only: given a CUDA device, the knob raises, since the port never
runs the card's attention through its plain version.
"""

from __future__ import annotations

import functools
import os


@functools.lru_cache(None)
def on_gpu() -> bool:
    """True when a CUDA device is visible (the port's accelerator)."""
    import torch
    try:
        return bool(torch.cuda.is_available())
    except Exception:
        return False


def flash_disabled() -> bool:
    return os.environ.get("SOCIO_DISABLE_FLASH", "0") == "1"


def use_flash_attention(explicit=None, device=None) -> bool:
    """An explicit choice wins; else SOCIO_DISABLE_FLASH=1 turns the kernels
    off, and raises when `device` (the caller's tensors') is a CUDA device;
    else the kernels' route (the wrappers take the plain version on a CPU
    tensor)."""
    if explicit is not None:
        return bool(explicit)
    if not flash_disabled():
        return True
    import torch
    if device is not None and torch.device(device).type == "cuda":
        raise RuntimeError(
            "SOCIO_DISABLE_FLASH=1 would run attention on the CUDA card through its "
            "plain version; the port runs its kernels there: unset it, or pass CPU "
            "tensors")
    return False
