"""Ulysses sequence parallelism: the head-axis all-to-all over the "sp"
devices, the counterpart of socioreasoner_tpu/parallel/ulysses.py.

Instead of rotating K/V around a ring, one all-to-all swaps the split
dimension from sequence to heads, every device attends the FULL sequence
over its slice of heads, and a second all-to-all swaps back. The JAX
package runs the all-to-alls inside a shard_map; the port runs them as one
controller over the devices' shards (slices moved with `.to()`, which
autograd carries back).

The full-sequence attention over a head slice is dense, or with use_flash
the trainable flash kernels (kernels 4-6 on a CUDA tensor, their plain
versions on a CPU one) over the valid prefix lengths of the gathered mask,
the train batch's right-padded layout, as the unsharded flash path runs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops.attention import dense_attention
from ..ops.flash_attention_bwd import flash_attention_trainable
from .mesh import tp_devices


def _heads_to_seq(xs: List[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """(B, L/n, h, D) a device → (B, L, h/n, D) a device: device j takes
    head group j of every device's sequence chunk, in chunk order."""
    n = len(xs)
    g = xs[0].shape[2] // n
    return [torch.cat([x[:, :, j * g:(j + 1) * g].to(dev) for x in xs], dim=1)
            for j, dev in enumerate(devices)]


def _seq_to_heads(xs: List[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """(B, L, h/n, D) a device → (B, L/n, h, D) a device: device r takes
    sequence chunk r of every device's head group, in group order."""
    n = len(xs)
    c = xs[0].shape[1] // n
    return [torch.cat([x[:, r * c:(r + 1) * c].to(dev) for x in xs], dim=2)
            for r, dev in enumerate(devices)]


def ulysses_heads(H: int, Hkv: int, n: int):
    """(q heads, kv heads) a device attends over after the all-to-all: K/V
    are repeated to H first when Hkv does not split over the n devices."""
    if H % n:
        raise ValueError(f"ulysses: {H} heads not divisible by sp={n}")
    return H // n, (Hkv if Hkv % n == 0 else H) // n


def ulysses_attention_local(qs: List[torch.Tensor], ks: List[torch.Tensor],
                            vs: List[torch.Tensor],
                            attention_masks: Optional[List[torch.Tensor]] = None,
                            causal: bool = True, use_flash: bool = False,
                            plans=None) -> List[torch.Tensor]:
    """Per-device shards (B, L/n, H, D), the sequence split over the
    devices in order; attention_masks the devices' (B, L/n) slices
    (gathered whole onto every device: masks are cheap). With use_flash,
    `plans` may give each device's kernel-6 plan (dkv_plan over the
    gathered mask's lengths at the device's heads)."""
    n = len(qs)
    devices = [q.device for q in qs]
    H, Hkv = qs[0].shape[2], ks[0].shape[2]
    ulysses_heads(H, Hkv, n)
    if Hkv % n:
        # GQA with fewer KV heads than devices: repeat K/V up to H first
        # (costs memory, keeps the all-to-all layout uniform)
        rep = H // Hkv
        ks = [k.repeat_interleave(rep, dim=2) for k in ks]
        vs = [v.repeat_interleave(rep, dim=2) for v in vs]
    qf, kf, vf = (_heads_to_seq(x, devices) for x in (qs, ks, vs))
    masks = [None] * n
    if attention_masks is not None:
        masks = [torch.cat([m.to(dev) for m in attention_masks], dim=1) for dev in devices]
    outs = []
    for j in range(n):
        if use_flash:
            lens = None if masks[j] is None else masks[j].sum(-1)
            outs.append(flash_attention_trainable(qf[j], kf[j], vf[j], lens, causal,
                                                  None if plans is None else plans[j]))
        else:
            outs.append(dense_attention(qf[j], kf[j], vf[j], causal=causal,
                                        attention_mask=masks[j]))
    return _seq_to_heads(outs, devices)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              mesh, seq_axis: str = "sp",
                              attention_mask: Optional[torch.Tensor] = None,
                              causal: bool = True, use_flash: bool = False) -> torch.Tensor:
    """Global (B, L, H, D) tensors with L split over the `seq_axis` devices
    of a Mesh (or a plain device list); the result on q's device."""
    devices = tp_devices(mesh, seq_axis)
    n = len(devices)
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} does not split over {n} devices")

    def split(x):
        return [part.to(dev) for part, dev in zip(x.chunk(n, dim=1), devices)]
    masks = None if attention_mask is None else split(attention_mask)
    outs = ulysses_attention_local(split(q), split(k), split(v), masks, causal, use_flash)
    return torch.cat([o.to(q.device) for o in outs], dim=1)
