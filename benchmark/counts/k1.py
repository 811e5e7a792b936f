"""Kernel 1, the ViT's segmented attention (`csrc/flash_segmented.cu`
through `attention_sm90.cuh`'s `attention_sm90_kernel` with kSeg true):
each patch attends to the patches of its window (window blocks) or of its
image (full-attention blocks), one launch a block of one tower call.

Records (one a launch): {"tokens": the call's patches, "pairs": the
(query, key) pairs of that block's mask, "heads", "head_dim"}. A slice
that holds part of a tower call gives each of its launches the mean pairs
of the tower's blocks. Bytes: q, k, v read once and the output written once
(bf16); operations: 4 x D a (head, pair).
"""

import re

RECORDS = "vit"  # the slice's work records that work() reads
NAME = re.compile(r"attention_sm90(_sliced)?_kernel<(\d+, )?true")


def match(name: str) -> bool:
    return bool(NAME.search(name))


def work(records, shape):
    flops = nbytes = 0.0
    for r in records:
        H, D = r["heads"], r["head_dim"]
        nbytes += 4 * r["tokens"] * H * D * 2
        flops += 4.0 * H * D * r["pairs"]
    return flops, nbytes
