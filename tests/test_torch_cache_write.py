"""The port's K/V row writer (ops/cache_write.py, kernel 7) against numpy
index assignment: exact equality (it is a copy), out-of-range positions
write nothing, every other row stays as it was; plus the wrapper's checks
and, on a GPU, the CUDA kernel against the plain version."""

import numpy as np
import pytest
import torch

from socioreasoner_tpu_torch.ops import cache_write as cw


def _case(seed, L=3, S=5, Lalloc=16, Hkv=2, D=8):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(L, S, Lalloc, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(L, S, Lalloc, Hkv, D)).astype(np.float32)
    knew = rng.normal(size=(S, 1, Hkv, D)).astype(np.float32)
    vnew = rng.normal(size=(S, 1, Hkv, D)).astype(np.float32)
    return k, v, knew, vnew


@pytest.mark.parametrize("positions", [[0, 15, 7, 3, 9],           # both ends
                                       [-1, 16, 2, 100000, -7]])   # out of range
@pytest.mark.parametrize("layer", [0, 2])
def test_write_rows_reference_matches_numpy(positions, layer):
    k, v, knew, vnew = _case(0)
    want_k, want_v = k.copy(), v.copy()
    for s, p in enumerate(positions):
        if 0 <= p < k.shape[2]:
            want_k[layer, s, p] = knew[s, 0]
            want_v[layer, s, p] = vnew[s, 0]
    kt, vt = torch.as_tensor(k), torch.as_tensor(v)
    pos = torch.tensor(positions, dtype=torch.int32)
    n = cw.write_rows.launches
    got_k, got_v = cw.write_rows(kt, vt, torch.as_tensor(knew), torch.as_tensor(vnew),
                                 pos, layer)
    assert got_k is kt and got_v is vt                 # in place
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert cw.write_rows.launches == n                 # the CPU takes no kernel


@pytest.mark.parametrize("bad", ["layer", "rows", "positions", "caches"])
def test_write_rows_checks(bad):
    k, v, knew, vnew = map(torch.as_tensor, _case(1))
    pos = torch.zeros(5, dtype=torch.int32)
    args = {"layer": (k, v, knew, vnew, pos, 3),
            "rows": (k, v, knew[:, :, :1], vnew[:, :, :1], pos, 0),
            "positions": (k, v, knew, vnew, pos[:4], 0),
            "caches": (k, v[:, :4], knew, vnew, pos, 0)}[bad]
    with pytest.raises(ValueError):
        cw.write_rows(*args)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_write_rows_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)

    def bf16(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(torch.bfloat16)

    k, v = bf16(4, 6, 256, 2, 128), bf16(4, 6, 256, 2, 128)
    knew, vnew = bf16(6, 1, 2, 128), bf16(6, 1, 2, 128)
    pos = torch.tensor([0, 255, -1, 256, 17, 130], dtype=torch.int32, device=cuda)
    n = cw.write_rows.launches
    got = cw.write_rows(k.clone(), v.clone(), knew, vnew, pos, 2)
    want = cw.write_rows_reference(k.clone(), v.clone(), knew, vnew, pos, 2)
    assert cw.write_rows.launches == n + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))
