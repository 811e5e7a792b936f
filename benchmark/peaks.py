"""The card's published peaks and the roofline arithmetic.

NVIDIA's data sheet for one H100 SXM (dense rates, at its 700 W limit):
989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s from HBM. A roofline's
least time is the larger of operations over the peak rate and bytes over
the peak bandwidth, each input byte read once and each output byte written
once; `bound`, `seg_pairs` and `causal_pairs` are copies of the sound
arithmetic in chip_smoke.py, kept here so that a change to the program
cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds the card could take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def bound(nbytes: float, flops: float):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def seg_pairs(seg) -> int:
    """(query, key) pairs a segment-id mask keeps: the sum of squared
    segment lengths."""
    _, counts = np.unique(np.asarray(seg), return_counts=True)
    return int((counts.astype(np.int64) ** 2).sum())


def causal_pairs(Lq: int, lens, causal: bool = True) -> int:
    """(query, key) pairs of a prefix mask of kv_len keys a batch row,
    under a causal mask: row t sees min(kv_len, t + 1) keys."""
    t = np.arange(Lq)
    return int(sum((np.minimum(int(n), t + 1) if causal else np.full(Lq, int(n))).sum()
                   for n in lens))


def prefix_causal_pairs(n: int) -> int:
    """The causal pairs of one row of n valid tokens: n (n + 1) / 2."""
    return n * (n + 1) // 2
