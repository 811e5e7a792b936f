"""Weight bridge from the JAX package's parameter pytree to the port's.

    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), device, dtype)

(device defaults to the GPU).

The JAX tree is a nest of dicts whose leaves are arrays in (in, out) layout;
the port keeps the same nesting, names and layout, so both sides compute the
same function. The numpy conversion is done by the caller (the port imports
no jax); bfloat16 leaves are widened to float32 on the host before they become
tensors of `dtype`. A quantized tree (ops/quant.py layouts) keeps its int8
and uint8 codes as integer tensors and its `*_scale` leaves in float32, as
the JAX package keeps them.
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
    """Nested dict of numpy arrays → the same nest of tensors on `device`
    (the GPU unless one is named): float leaves as `dtype`, `*_scale` leaves
    as float32, int8/uint8 codes unchanged."""
    device = param_device(device)
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_from_numpy(leaf, device, dtype)
            continue
        arr = np.asarray(leaf)
        if arr.dtype in (np.int8, np.uint8):
            out[name] = torch.as_tensor(np.array(arr), device=device)
        elif np.issubdtype(arr.dtype, np.floating) or arr.dtype.name == "bfloat16":
            want = torch.float32 if name.endswith("_scale") else dtype
            out[name] = torch.as_tensor(arr.astype(np.float32), device=device).to(want)
        else:
            raise NotImplementedError(f"{name}: {arr.dtype} leaves are not supported")
    return out
