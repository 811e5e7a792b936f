"""Weight bridge from the JAX package's parameter pytree to the port's.

    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), device, dtype)

The JAX tree is a nest of dicts whose leaves are arrays in (in, out) layout;
the port keeps the same nesting, names and layout, so both sides compute the
same function. The numpy conversion is done by the caller (the port imports
no jax); bfloat16 leaves are widened to float32 on the host before they become
tensors of `dtype`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_numpy(tree: Dict[str, Any], device=None,
                      dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Nested dict of numpy arrays → the same nest of `dtype` tensors."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_from_numpy(leaf, device, dtype)
        else:
            arr = np.asarray(leaf)
            if not np.issubdtype(arr.dtype, np.floating) and arr.dtype.name != "bfloat16":
                raise NotImplementedError(
                    f"{name}: {arr.dtype} leaves (quantized weights) are not "
                    "ported yet (ROADMAP: quantized serving)")
            out[name] = torch.as_tensor(arr.astype(np.float32), device=device).to(dtype)
    return out
