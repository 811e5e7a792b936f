"""The JAX package's helpers that no module of it calls, ported for users of
the library: masked_normalize, get_pad_mask, get_eos_mask,
compute_clip_fraction, reduce_metrics and append_to_dict
(utils/functionals.py) and batch_value_metrics (utils/metrics.py), each
against the JAX function on the same seeded numpy inputs (float32: 1e-6
relative, the order of two implementations' sums; masks and counts
exactly)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from socioreasoner_tpu.utils import functionals as JF
from socioreasoner_tpu.utils import metrics as JM
from socioreasoner_tpu_torch.utils import functionals as TF
from socioreasoner_tpu_torch.utils import metrics as TM


def _mask(rng, shape, p=0.7):
    m = (rng.random(shape) < p).astype(np.float32)
    m[0] = 0.0                       # a row with nothing valid
    return m


@pytest.mark.parametrize("shape,axis", [((5, 9), 1), ((2, 3, 9), -1), ((5, 9), -1)])
def test_masked_normalize_matches_jax(shape, axis):
    """Over the last axis, the one the function's broadcast is written for."""
    rng = np.random.default_rng(len(shape) + axis + 3)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    m = _mask(rng, x.shape)
    want = np.asarray(JF.masked_normalize(jnp.asarray(x), jnp.asarray(m), axis=axis))
    got = TF.masked_normalize(torch.as_tensor(x), torch.as_tensor(m), axis=axis)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_pad_and_eos_masks_match_jax(dtype):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 6, (6, 12)).astype(np.int32)
    ids[1] = 5                        # every token eos
    ids[2] = 1                        # no eos
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for j_fn, t_fn, token in ((JF.get_pad_mask, TF.get_pad_mask, 0),
                              (JF.get_eos_mask, TF.get_eos_mask, 5)):
        want = np.asarray(j_fn(jnp.asarray(ids), token, dtype=jd))
        got = t_fn(torch.as_tensor(ids), token, dtype=td)
        assert got.dtype == td
        np.testing.assert_array_equal(got.numpy(), want)
    eos = TF.get_eos_mask(torch.as_tensor(ids), 5).numpy()
    assert eos[1].tolist() == [1] + [0] * 11 and eos[2].all()


@pytest.mark.parametrize("bounds", [(1.2, 0.8), (0.5, -0.5), (10.0, -10.0)])
def test_compute_clip_fraction_matches_jax(bounds):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 33)).astype(np.float32)
    want = float(JF.compute_clip_fraction(jnp.asarray(x), *bounds))
    got = TF.compute_clip_fraction(torch.as_tensor(x), *bounds)
    assert got.dtype == torch.float32 and got.item() == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("reduce", [None, np.max, np.sum])
def test_reduce_metrics_and_append_to_dict_match_jax(reduce):
    rng = np.random.default_rng(9)
    steps = [{"loss": float(rng.normal()), "kl": float(rng.random()), "n": int(k)}
             for k in range(4)]
    jd, td = {}, {}
    for m in steps:
        JF.append_to_dict(jd, m)
        assert TF.append_to_dict(td, m) is None
    assert td == jd and td["n"] == [0, 1, 2, 3]
    kw = {} if reduce is None else {"reduce_func": reduce}
    got, want = TF.reduce_metrics(td, **kw), JF.reduce_metrics(jd, **kw)
    assert got == want and all(type(v) is float for v in got.values())


@pytest.mark.parametrize("masked", ["none", "some", "empty"])
def test_batch_value_metrics_matches_jax(masked):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(3, 7)).astype(np.float32)
    mask = {"none": None, "some": _mask(rng, x.shape),
            "empty": np.zeros(x.shape, np.float32)}[masked]
    want = JM.batch_value_metrics("critic/values", x, mask)
    got = TM.batch_value_metrics("critic/values", x, mask)
    assert got == want and sorted(got) == ["critic/values/max", "critic/values/mean",
                                           "critic/values/min"]
    if masked == "empty":
        assert set(got.values()) == {0.0}
