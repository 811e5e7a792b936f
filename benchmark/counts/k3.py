"""Kernel 3, the paged decode attention (`csrc/paged_decode.cu`,
`paged_decode_kernel`): one query a slot against its slot's cached keys
and values, one launch a layer.

Records (one a decode chunk): {"kv0": [the cache length of each active
slot before the chunk's first step], "steps": steps run}. At step i a slot
of length L0 attends over L0 + i + 1 keys (its new row written first).
Bytes: each active slot's keys and values once, its query read and output
written; operations: q k^T and p v, 2 x D each a (head, key) pair.
"""

import re

RECORDS = "decode"  # the slice's work records that work() reads
NAME = re.compile(r"paged_decode_kernel")


def match(name: str) -> bool:
    return bool(NAME.search(name))


def work(records, shape):
    """(operations, bytes) of all records' launches over every layer."""
    H, Hkv, D = shape["heads"], shape["kv_heads"], shape["head_dim"]
    L, elem = shape["layers"], shape["cache_bytes"]
    flops = nbytes = 0.0
    for r in records:
        n_slots = len(r["kv0"])
        for i in range(int(r["steps"])):
            keys = sum(int(k) + i + 1 for k in r["kv0"])
            nbytes += keys * Hkv * D * elem * 2 + n_slots * H * D * 2 * 2
            flops += 4.0 * H * D * keys
    return flops * L, nbytes * L
