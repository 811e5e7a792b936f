"""Weight bridge from the JAX package's parameter pytrees to the port's.

    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), device, dtype)

(device defaults to the GPU).

The JAX trees are nests of dicts (and, in SAM2's tree, lists: blocks, convs,
layers, hidden, hyper_mlps) whose leaves are arrays in the JAX layouts
((in, out) linears, HWIO conv kernels); the port keeps the same nesting,
names and layouts, so both sides compute the same function. The numpy
conversion is done by the caller (the port imports no jax); bfloat16 leaves
are widened to float32 on the host before they become tensors of `dtype`. A
quantized tree (ops/quant.py layouts) keeps its int8 and uint8 codes as
integer tensors and its `*_scale` leaves in float32, as the JAX package
keeps them.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def param_device(device=None) -> torch.device:
    """Where the entry points place parameters: `device` when one is named,
    else the GPU. Without a GPU the caller must name a device (the CPU, as
    the tests do): there is no silent fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: name one (device='cpu' runs on the CPU)")
    return torch.device("cuda")


def params_from_numpy(tree: Dict[str, Any], device=None,
                      dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Nest of dicts and lists of numpy arrays → the same nest of tensors on
    `device` (the GPU unless one is named): float leaves as `dtype`,
    `*_scale` leaves as float32, int8/uint8 codes unchanged."""
    return _convert("", tree, param_device(device), dtype)


def _convert(name: str, leaf, device: torch.device, dtype: torch.dtype):
    if isinstance(leaf, dict):
        return {k: _convert(k, v, device, dtype) for k, v in leaf.items()}
    if isinstance(leaf, (list, tuple)):
        return [_convert(name, v, device, dtype) for v in leaf]
    arr = np.asarray(leaf)
    if arr.dtype in (np.int8, np.uint8):
        return torch.as_tensor(np.array(arr), device=device)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    if np.issubdtype(arr.dtype, np.floating):
        want = torch.float32 if name.endswith("_scale") else dtype
        return torch.tensor(arr, device=device).to(want)
    raise NotImplementedError(f"{name}: {arr.dtype} leaves are not supported")
