"""The port's K/V row writer (ops/cache_write.py, kernel 7) against numpy
index assignment and JAX's advanced-index scatter: exact equality (it is a
copy), out-of-range positions write nothing, every other row stays as it
was; the wrapper's checks; the C entries' arguments through a recording
stand-in library (the layer's pointers and strides, the stream; a bad
stride, dtype or pointer refused before any launch); and, on a GPU, the
CUDA kernel against the plain version."""

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


def test_write_rows_reference_matches_jax_scatter():
    """The plain version against the JAX package's way of writing the rows
    (scripts/profile_decode2.py's advanced-index scatter, `.at[...].set`)
    at positions inside the cache, both ends included, and past its end,
    which JAX's scatter drops and the port writes nothing for. (A negative
    position JAX would wrap to the end of the cache; the port writes
    nothing, as the Pallas kernel may not write there either.)"""
    import jax.numpy as jnp
    k, v, knew, vnew = _case(2, S=6)
    positions = np.array([0, 15, 7, 16, 3, 100000], np.int32)
    layer = 1
    bidx = np.arange(6)[:, None]
    want_k = jnp.asarray(k).at[layer, bidx, positions[:, None]].set(knew, mode="drop")
    want_v = jnp.asarray(v).at[layer, bidx, positions[:, None]].set(vnew, mode="drop")
    got_k, got_v = cw.write_rows_reference(torch.as_tensor(k), torch.as_tensor(v),
                                           torch.as_tensor(knew), torch.as_tensor(vnew),
                                           torch.as_tensor(positions), layer)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


class _Recorder:
    """A stand-in kernel library: records every entry point's arguments and
    returns success without launching anything."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


def _as_cuda(monkeypatch, library, device_of=lambda t: 0):
    """Make CPU tensors read as tensors on GPU `device_of(t)`, the kernel
    library `library` and the current stream the handle 7777."""
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda")))
    monkeypatch.setattr(torch.Tensor, "get_device", device_of)
    monkeypatch.setattr(cw._build, "library", lambda: library)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7777,
                        raising=False)


def _bf16_layer_views(L=3, S=5, Lalloc=16, Hkv=2, D=8):
    """Caches that are views of longer ones (every slot's rows strided past
    Lalloc, as a cache grown in place would be), and rows of their own."""
    k = torch.zeros(L, S, 2 * Lalloc, Hkv, D, dtype=torch.bfloat16)[:, :, :Lalloc]
    v = torch.zeros(L, S, Lalloc + 8, Hkv, D, dtype=torch.bfloat16)[:, :, 8:]
    knew = torch.ones(S, 1, Hkv, D, dtype=torch.bfloat16)
    vnew = torch.ones(S, 1, Hkv, D, dtype=torch.bfloat16)
    return k, v, knew, vnew, torch.zeros(S, dtype=torch.int32)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_write_rows_hands_the_layer_to_the_kernel(layer, monkeypatch):
    """One C call a write: the layer's k and v pointers (the stacked caches
    offset by layer x their first stride, 2 bytes an element), the rows'
    and positions' pointers, S, Lalloc, Hkv x D, the slot and token strides
    of both caches and the rows' slot strides in elements, and the current
    stream; one launch counted. The empty kernel gets its PDL flag and the
    stream."""
    rec = _Recorder()
    k, v, knew, vnew, pos = _bf16_layer_views()
    _as_cuda(monkeypatch, rec)
    n = cw.write_rows.launches
    assert cw.write_rows(k, v, knew, vnew, pos, layer) == (k, v)
    (name, args), = rec.calls
    assert name == "socio_write_rows_bf16" and cw.write_rows.launches == n + 1
    assert args == (k.data_ptr() + 2 * layer * k.stride(0),
                    v.data_ptr() + 2 * layer * v.stride(0),
                    knew.data_ptr(), vnew.data_ptr(), pos.data_ptr(), 5, 16, 16,
                    k.stride(1), k.stride(2), v.stride(1), v.stride(2), knew.stride(0),
                    vnew.stride(0), 7777)
    assert k.stride(1) == 2 * 16 * 16 and v.stride(1) == 24 * 16
    rec.calls.clear()
    for pdl in (True, False):
        cw.launch_noop(torch.device("cuda", 0), pdl)
    assert rec.calls == [("socio_noop", (1, 7777)), ("socio_noop", (0, 7777))]
    with pytest.raises(ValueError, match="runs on a GPU"):
        cw.launch_noop(torch.device("cpu"), True)


@pytest.mark.parametrize("bad", ["dtype", "stride", "pointer", "row", "device",
                                 "row_stride"])
def test_write_rows_refuses_before_any_launch(bad, monkeypatch):
    """A float32 cache, a slot stride that is no multiple of 8 elements (16
    bytes), a cache 2 bytes off 16-byte alignment, rows whose (Hkv, D) are
    not contiguous, rows on another GPU, or rows whose slot stride is no
    multiple of 8 elements: ValueError before the library is asked for
    anything."""
    k, v, knew, vnew, pos = _bf16_layer_views()
    device_of = lambda t: 0                                   # noqa: E731
    if bad == "dtype":
        k = k.float()
    elif bad == "stride":
        k = torch.zeros(3 * 5 * 260, dtype=torch.bfloat16).as_strided(
            (3, 5, 16, 2, 8), (5 * 260, 260, 16, 8, 1))
    elif bad == "pointer":
        k = torch.zeros(3 * 5 * 16 * 16 + 1, dtype=torch.bfloat16)[1:].reshape(3, 5, 16, 2, 8)
    elif bad == "row":
        knew = torch.ones(5, 1, 8, 2, dtype=torch.bfloat16).transpose(2, 3)
    elif bad == "device":
        device_of = lambda t: 1 if t is vnew else 0           # noqa: E731
    else:
        knew = torch.ones(5 * 20, dtype=torch.bfloat16).as_strided((5, 1, 2, 8),
                                                                    (20, 16, 8, 1))
    _as_cuda(monkeypatch, None, device_of)
    monkeypatch.setattr(cw._build, "library",
                        lambda: pytest.fail("the kernel library was reached"))
    n = cw.write_rows.launches
    with pytest.raises(ValueError):
        cw.write_rows(k, v, knew, vnew, pos, 0)
    assert cw.write_rows.launches == n


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
