"""Head dims on the port's attention routes.

The host's instance sets (KERNEL_HEAD_DIMS, SEG_HEAD_DIMS, TRAIN_HEAD_DIMS)
are pinned to the instances the CUDA sources dispatch, and the wrappers
refuse a head dim above 128 with an error naming H, Hkv and D (every head
dim up to 128 runs: tests/test_torch_head_dims_any.py). The cached
decoder routes as the JAX package does: the decode kernel (kernels 3/3q)
where head_dim is a multiple of 128, dense attention over the layer's cache
otherwise (an int8 cache dequantized first). At head_dim 64 (Qwen2.5-0.5B,
Llama-3.2) a cached prefill and three decode steps of the port equal the
JAX package's cached model (use_flash=True, f32 weights: rtol/atol 1e-5,
the float32 rounding of two implementations of the same sums) and never
reach paged_decode_attention (the JAX prefill kernel in interpret mode);
at head_dim 128 every decode layer calls it.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig, TextConfig
from socioreasoner_tpu.ops import decode_attention as j_dec
from socioreasoner_tpu.ops import flash_attention as j_fa
from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
from socioreasoner_tpu_torch.models.qwen2_5_vl import text as t_text
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.ops import flash_attention as fa
from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb
from tests.test_torch_engine import _port

CSRC = Path(__file__).resolve().parents[1] / "socioreasoner_tpu_torch" / "csrc"


def _body(source: str, entry: str) -> str:
    """The body of C function `entry` of `source`."""
    text = (CSRC / source).read_text()
    body = text[text.index(entry):]
    return body[:body.index("\n}\n")]


def _dispatched(source: str, entry: str):
    """The instances of the `switch (inst)` in the body of C function
    `entry` of `source`, and the instance list (sm90_common.cuh) whose
    head_dim_instance chose `inst` there; a function that hands its call to
    launch_gqa answers with launch_gqa's."""
    body = _body(source, entry)
    if "switch (inst)" not in body:
        assert "launch_gqa(" in body, (source, entry)
        return _dispatched("flash_prefill.cu", "int launch_gqa(")
    cases = {int(n) for n in re.findall(r"case (\d+):", body[body.index("switch (inst)"):])}
    (dims,) = re.findall(r"head_dim_instance\((k\w+Dims), D\)", body)
    listed = re.search(rf"constexpr int {dims}\[\d+\] = \{{([\d, ]+)\}};",
                       (CSRC / "sm90_common.cuh").read_text())
    return cases, tuple(int(n) for n in listed.group(1).split(","))


@pytest.mark.parametrize("source,entry,host", [
    ("flash_prefill.cu", "int launch_gqa(", fa.KERNEL_HEAD_DIMS),
    ("flash_segmented.cu", "socio_flash_segmented_bf16(", fa.SEG_HEAD_DIMS),
    ("flash_train_fwd.cu", "socio_flash_train_fwd_bf16(", fa.KERNEL_HEAD_DIMS),
    ("flash_train_dq_sm90.cu", "socio_flash_train_dq_bf16(", fb.TRAIN_HEAD_DIMS),
    ("flash_train_dkv_sm90.cu", "socio_flash_train_dkv_bf16(", fb.TRAIN_HEAD_DIMS),
])
def test_host_head_dims_are_the_dispatched_instances(source, entry, host):
    """Each entry point dispatches exactly the instances its list names, and
    the host's instance set is that list, in order (head_dim_plan takes the
    first instance that covers a width)."""
    cases, listed = _dispatched(source, entry)
    assert cases == set(listed), (source, cases, listed)
    assert listed == tuple(host), (source, listed, host)
    assert 64 in fb.TRAIN_HEAD_DIMS and 64 in fa.KERNEL_HEAD_DIMS


@pytest.mark.parametrize("D", [136, 256])
def test_wrappers_refuse_other_head_dims_naming_them(D, monkeypatch):
    """A head dim above 128 (no instance covers it) raises ValueError naming
    H, Hkv and D before any pointer is passed: the tensors are made to read
    as CUDA tensors that pass the device and type checks."""
    q = torch.zeros(1, 8, 4, D, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, D, dtype=torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "is_cpu", property(lambda self: False))
    monkeypatch.setattr(fa, "check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(fb, "check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(fa._build, "library", lambda: pytest.fail("a pointer was passed"))
    with pytest.raises(ValueError, match=rf"H=4 Hkv=2 D={D}"):
        fa.flash_attention(q, k, k)
    dev = torch.device("cuda")
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: dev))
    with pytest.raises(ValueError, match=rf"H=4 Hkv=2 D={D}"):
        fb.flash_attention_fwd_lse(q, k, k)


def _config(head_dim: int):
    """The tiny config's widths with `head_dim` (and an mrope split of its
    half)."""
    base = Qwen25VLConfig.tiny(512)
    half = head_dim // 2
    sec = (half // 4, 3 * half // 8, half - half // 4 - 3 * half // 8)
    text = TextConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      head_dim=head_dim, mrope_section=sec, tie_word_embeddings=False)
    return Qwen25VLConfig(vision=base.vision, text=text, image_token_id=509,
                          video_token_id=510, vision_start_token_id=508, bos_token_id=0,
                          eos_token_id=1, pad_token_id=0)


def _cached_steps(side, config, params, ids, kv_quant):
    """A cached prefill of 7 tokens then 3 one-token steps (B=2) through one
    package's model.forward; returns the logits of each pass."""
    t = config.text
    B, P, Lmax = ids.shape[0], 7, 64
    shape = (t.num_hidden_layers, B, Lmax, t.num_key_value_heads, t.head_dim)
    scale_shape = (t.num_hidden_layers, B, t.num_key_value_heads, Lmax)
    pos = np.broadcast_to(np.arange(ids.shape[1])[None, None], (B, 3, ids.shape[1]))
    if side == "jax":
        dt = jnp.int8 if kv_quant else jnp.float32
        cache = {"k": jnp.zeros(shape, dt), "v": jnp.zeros(shape, dt)}
        if kv_quant:
            cache.update(k_scale=jnp.zeros(scale_shape), v_scale=jnp.zeros(scale_shape))
    else:
        dt = torch.int8 if kv_quant else torch.float32
        cache = {"k": torch.zeros(shape, dtype=dt), "v": torch.zeros(shape, dtype=dt)}
        if kv_quant:
            cache.update(k_scale=torch.zeros(scale_shape), v_scale=torch.zeros(scale_shape))
    outs = []
    for start, stop in ((0, P), (P, P + 1), (P + 1, P + 2), (P + 2, P + 3)):
        valid = (np.arange(Lmax)[None] < stop).astype(np.int32).repeat(B, 0)
        cpos = np.broadcast_to(np.arange(start, stop)[None], (B, stop - start))
        if side == "jax":
            cache["kv_valid"] = jnp.asarray(valid)
            out, cache = j_model.forward(config, params, jnp.asarray(ids[:, start:stop]),
                                         jnp.asarray(pos[:, :, start:stop]), cache=cache,
                                         cache_positions=jnp.asarray(cpos), use_flash=True)
        else:
            cache["kv_valid"] = torch.as_tensor(valid)
            with torch.no_grad():
                out, cache = t_model.forward(config, params, torch.as_tensor(ids[:, start:stop]),
                                             torch.as_tensor(pos[:, :, start:stop].copy()),
                                             cache=cache,
                                             cache_positions=torch.as_tensor(cpos.copy()))
        outs.append(np.asarray(out))
    return outs


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float_cache", "int8_cache"])
def test_head_dim_64_decodes_densely_as_jax(kv_quant, monkeypatch):
    config = _config(64)
    jp = j_model.init_params(config, jax.random.key(3), jnp.float32, with_vision=False)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")

    def refuse(*a, **k):
        raise AssertionError("paged_decode_attention called at head_dim 64")
    monkeypatch.setattr(t_text, "paged_decode_attention", refuse)
    monkeypatch.setattr(j_dec, "paged_decode_attention", refuse)   # JAX routes densely too
    # the JAX prefill kernel as the JAX package's tests run it on the CPU
    monkeypatch.setattr(j_fa, "flash_attention",
                        functools.partial(j_fa.flash_attention, interpret=True))
    ids = np.random.default_rng(0).integers(2, 500, (2, 10))
    want = _cached_steps("jax", config, jp, ids, kv_quant)
    got = _cached_steps("port", _port(config), tp, ids, kv_quant)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_head_dim_128_decodes_through_the_kernel(monkeypatch):
    """Every decode layer reaches paged_decode_attention (its plain version
    on the CPU) at head_dim 128; the prefill does not."""
    config = _port(_config(128))
    tp = params_from_numpy(jax.tree.map(np.asarray, j_model.init_params(
        _config(128), jax.random.key(3), jnp.float32, with_vision=False)), device="cpu")
    calls = []
    plain = t_text.paged_decode_attention

    def spy(*a, **k):
        calls.append(k.get("layer"))
        return plain(*a, **k)
    monkeypatch.setattr(t_text, "paged_decode_attention", spy)
    ids = np.random.default_rng(0).integers(2, 500, (2, 10))
    outs = _cached_steps("port", config, tp, ids, False)
    assert calls == [0, 1] * 3
    assert all(np.isfinite(o).all() for o in outs)
