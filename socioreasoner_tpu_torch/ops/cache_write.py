"""In-place K/V row write into the stacked decode cache: a hand-written kernel.

The counterpart of the Pallas row writer of scripts/profile_decode2.py
(`write_rows`): one call writes the new K and V rows of every slot at one
layer of the engine's stacked (layers, S, Lalloc, Hkv, D) bf16 caches, at
each slot's position (csrc/cache_write.cu). A slot whose position lies
outside [0, Lalloc) writes nothing, in the kernel and in the plain version.

The decode engine does not call it: like the JAX engine, the text decoder
writes cache rows with an indexed assignment. The diagnostic comparison of
the two (all layers, k and v) is the kernel's caller.

The wrapper takes its plain PyTorch version for tensors on the CPU and
launches the kernel for tensors on a GPU, or raises. ``write_rows.launches``
counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .flash_attention import check_shapes


def _check(k_all, v_all, knew, vnew, positions, layer) -> None:
    L, S = k_all.shape[:2]
    check_shapes("write_rows",
                 k_all.shape == v_all.shape and k_all.dim() == 5
                 and knew.shape == vnew.shape
                 and tuple(knew.shape) == (S, 1) + tuple(k_all.shape[3:])
                 and tuple(positions.shape) == (S,),
                 k_all=k_all, v_all=v_all, knew=knew, vnew=vnew, positions=positions)
    if not 0 <= layer < L:
        raise ValueError(f"write_rows: layer {layer} outside [0, {L})")


def write_rows_reference(k_all, v_all, knew, vnew, positions, layer: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of write_rows: an indexed assignment of each slot's row
    that rewrites the old value where the position is out of range."""
    _check(k_all, v_all, knew, vnew, positions, layer)
    S, Lalloc = k_all.shape[1], k_all.shape[2]
    positions = positions.to(k_all.device).long()
    valid = ((positions >= 0) & (positions < Lalloc))[:, None, None]
    slots = torch.arange(S, device=k_all.device)
    pos = positions.clamp(0, Lalloc - 1)
    for cache, new in ((k_all, knew), (v_all, vnew)):
        cache[layer, slots, pos] = torch.where(valid, new[:, 0].to(cache.dtype),
                                               cache[layer, slots, pos])
    return k_all, v_all


def write_rows(
    k_all: torch.Tensor,       # (layers, S, Lalloc, Hkv, D) bf16, written in place
    v_all: torch.Tensor,
    knew: torch.Tensor,        # (S, 1, Hkv, D)
    vnew: torch.Tensor,
    positions: torch.Tensor,   # (S,) int32 cache row of each slot
    layer: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write knew[s, 0] / vnew[s, 0] at row positions[s] of slot s at
    `layer`, in place; returns the same two tensors."""
    if k_all.device.type == "cpu":
        return write_rows_reference(k_all, v_all, knew, vnew, positions, layer)
    _check(k_all, v_all, knew, vnew, positions, layer)
    dev = k_all.get_device()
    _, S, Lalloc, Hkv, D = k_all.shape
    # one pass of the kernel's input rules, keeping each pointer and stride
    # it reads (the launch is a microsecond, so the wrapper's host time is
    # most of a call): bf16 on one device, rows (Hkv, D) contiguous, 16-byte
    # aligned rows and pointers
    ptrs, strides = [], []
    for t in (k_all, v_all, knew, vnew):
        st, ptr = t.stride(), t.data_ptr()
        if (t.dtype != torch.bfloat16 or t.get_device() != dev or st[-1] != 1
                or st[-2] != D or (st[0] | st[1] | st[-3]) % 8 or ptr % 16):
            raise ValueError(f"write_rows: the kernel takes bf16 tensors on one device "
                             f"with contiguous 16-byte-aligned (Hkv, D) rows, got "
                             f"{t.dtype} on {t.device} with strides {st}")
        ptrs.append(ptr)
        strides.append(st)
    if positions.dtype != torch.int32 or positions.get_device() != dev:
        positions = positions.to(device=k_all.device, dtype=torch.int32)
    positions = positions.contiguous()
    ks, vs, ns, vns = strides
    rc = _build.library().socio_write_rows_bf16(
        # the layer's views by pointer offset (2 bytes an element)
        ptrs[0] + 2 * layer * ks[0], ptrs[1] + 2 * layer * vs[0], ptrs[2], ptrs[3],
        positions.data_ptr(), S, Lalloc, Hkv * D, ks[1], ks[2], vs[1], vs[2], ns[0], vns[0],
        # the raw handle of the current stream (a capturing one included)
        # without building a torch.cuda.Stream object for every call
        torch._C._cuda_getCurrentRawStream(dev))
    _build.check(rc, "socio_write_rows_bf16")
    write_rows.launches += 1
    return k_all, v_all


write_rows.launches = 0
