"""Kernel 2, the prefill attention (`csrc/flash_prefill.cu` through
`attention_sm90.cuh`'s `attention_sm90_kernel` with kSeg false, or its
sliced kernel above 256 columns): each prompt row attends causally over its
own tokens, one launch a layer of a batched prefill.

Records (one a batched prefill): {"lens": [the prompt length of each row
the prefill serves]}. A padded row or the padding of the length bucket is
work the rows do not need and is not counted. Bytes: each row's q, k and v
read once and its output written once (bf16); operations: q k^T and p v, 2 x
D each a (q head, causal pair).
"""

import re

from peaks import prefix_causal_pairs

RECORDS = "prefill"  # the slice's work records that work() reads
NAME = re.compile(r"attention_sm90(_sliced)?_kernel<(\d+, )?false")


def match(name: str) -> bool:
    return bool(NAME.search(name))


def work(records, shape):
    """(operations, bytes) of all records' launches over every layer."""
    H, Hkv, D, L = shape["heads"], shape["kv_heads"], shape["head_dim"], shape["layers"]
    flops = nbytes = 0.0
    for r in records:
        for n in r["lens"]:
            n = int(n)
            nbytes += n * (2 * H + 2 * Hkv) * D * 2
            flops += 4.0 * H * D * prefix_causal_pairs(n)
    return flops * L, nbytes * L
