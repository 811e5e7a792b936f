"""The model FLOPs of a slice's completed work, from the shapes: 2 x the
parameters a token passes through (the matmuls; the embedding is a lookup)
for each forward token, plus the attention pairs (4 x D a head and pair).
A prefill forms logits for each row's last position only.

Records: {"prefill": [{"lens": [...]}], "decode": [{"kv0": [...], "steps": n}],
"vit": counts/k1.py's records, one a launch} (the tower's widths in
`shape["vision"]`).
"""

from peaks import prefix_causal_pairs


def matmul_params(shape):
    """(the decoder's per-token matmul parameters without the head, the
    head's)."""
    h, H, Hkv, D = shape["hidden"], shape["heads"], shape["kv_heads"], shape["head_dim"]
    layer = h * (H + 2 * Hkv) * D + H * D * h + 3 * h * shape["intermediate"]
    return shape["layers"] * layer, h * shape["vocab"]


def vit_flops(v, r):
    """One kernel-1 launch's share of a Qwen2.5-VL tower call: its block's
    matmuls over the call's patches and its attention pairs, and 1 / depth
    of the patch embedding and the merger."""
    hid, inter, tokens = v["hidden"], v["intermediate"], r["tokens"]
    block = 3 * hid * hid + hid * hid + 3 * hid * inter
    merged = v["merge"] * hid
    once = v["patch_in"] * hid * tokens + tokens / v["merge"] * (merged * merged + merged * v["out"])
    return 2.0 * (block * tokens + once / v["depth"]) + 4.0 * hid * r["pairs"]


def flops(records, shape):
    body, head = matmul_params(shape)
    L, H, D = shape["layers"], shape["heads"], shape["head_dim"]
    total = 0.0
    for r in records.get("prefill", []):
        for n in r["lens"]:
            n = int(n)
            total += 2.0 * body * n + 2.0 * head + 4.0 * H * D * prefix_causal_pairs(n) * L
    for r in records.get("decode", []):
        n_slots = len(r["kv0"])
        for i in range(int(r["steps"])):
            keys = sum(int(k) + i + 1 for k in r["kv0"])
            total += 2.0 * (body + head) * n_slots + 4.0 * H * D * keys * L
    for r in records.get("vit", []):
        total += vit_flops(shape["vision"], r)
    return total
