"""Kernel 3 at head dim 256 over long caches on an NVIDIA GPU (the `cuda`
marker; each test skips without one).

The bf16 256 instance's ring has three stages, which pass between its two
consumer groups; before each (stage, group) had its own full barrier, a
group could take a stage's earlier load for the one it waited for, and the
kernel trapped (CUDA error 719) at these shapes: many slots of many 64-key
blocks at one CTA a (slot, kv head). Every case runs 20 launches, each held
row by row against plain attention in float32 within ROW_TOL (chip_smoke.py's
0.02 of a row's largest value) and bit-equal to the first: bf16 at 256
(Falcon3-7B's 12 / 4 heads), the int8 branch at 256, the sliced kernel at
512 (the same projections as 6 / 2 heads) and the 128 instance (16 / 2
heads), at the same slots, cache lengths and lengths.

    python3 -m pytest tests/test_torch_paged_decode_256.py -q -m cuda
"""

import pytest
import torch

from socioreasoner_tpu_torch.ops import decode_attention as t_dec

ROW_TOL = 2e-2
REPEATS = 20

# (slots, Lalloc, length of every slot): the shapes that trapped, then
# neighbours that did not
SHAPES = [(128, 3328, 1500), (96, 3328, 1500), (64, 3328, 1500), (128, 2304, 1500),
          (32, 3328, 3000), (4, 768, 517), (72, 3328, 1500), (128, 2560, 1500)]

# name: (q heads, kv heads, head dim, int8 cache)
INSTANCES = {"bf16_256": (12, 4, 256, False), "int8_256": (12, 4, 256, True),
             "sliced_512": (6, 2, 512, False), "bf16_128": (16, 2, 128, False)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel 3 has no CPU mode")
    return torch.device("cuda")


def _case(dev, S, Lalloc, length, H, Hkv, D, quant, seed=0):
    """q, the caches (bf16, or int8 codes with their (S, Hkv, Lalloc) f32
    scales) and the lengths, the last slot's length varied so that the
    slots do not all end on one block."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(S, H, D, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(S, Lalloc, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    lens = torch.full((S,), length, dtype=torch.int32, device=dev)
    lens[-1] = max(1, length - 37)
    if not quant:
        return q, (k, v), (), lens
    (kq, ks), (vq, vs) = t_dec.quantize_kv(k), t_dec.quantize_kv(v)
    return q, (kq, vq), (ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()), lens


def _plain(q, caches, scales, lens):
    if scales:
        return t_dec.paged_decode_attention_int8_reference(q.float(), *caches, lens, *scales)
    return t_dec.paged_decode_attention_reference(q.float(), *(c.float() for c in caches), lens)


@pytest.mark.cuda
@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("S,Lalloc,length", SHAPES)
def test_cuda_paged_decode_long_caches_match_plain(cuda, instance, S, Lalloc, length):
    H, Hkv, D, quant = INSTANCES[instance]
    q, caches, scales, lens = _case(cuda, S, Lalloc, length, H, Hkv, D, quant)
    want = _plain(q, caches, scales, lens)
    first = None
    for _ in range(REPEATS):
        got = t_dec.paged_decode_attention(q, *caches, lens, *scales)
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        ratio = diff.amax(-1) / want.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
        assert ratio.max().item() <= ROW_TOL
        if first is None:
            first = got
        assert torch.equal(got, first)
