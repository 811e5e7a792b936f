"""Head dims on the port's attention routes.

The host's instance sets (KERNEL_HEAD_DIMS, SEG_HEAD_DIMS, TRAIN_HEAD_DIMS
and the decode kernel's KERNEL_HEAD_DIMS) are pinned to the instances the
CUDA sources dispatch; a head dim above 256 reaches the kernels' sliced
instances (the wrappers hand them the padded width, kernel 6's plan holds
every slice's workspace and counters), and the decode kernel refuses any
head dim that is no multiple of 128, naming H, Hkv and D (the numerics of
every width: tests/test_torch_head_dims_any.py). The cached decoder routes as the JAX package does: the decode
kernel (kernels 3/3q) where head_dim is a multiple of 128, dense attention
over the layer's cache otherwise (an int8 cache dequantized first). At head_dim 64 (Qwen2.5-0.5B,
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
from socioreasoner_tpu_torch.ops import decode_attention as da
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


def test_decode_head_dims_are_the_dispatched_instances():
    """The decode kernel takes every head dim that is a multiple of
    KERNEL_HEAD_DIM_UNIT (128), the rule bad_shape applies, on the instances
    socio_paged_decode launches for both the bf16 and the int8 cache:
    KERNEL_HEAD_DIMS, in order, and above 256 the sliced 256 one."""
    bad = _body("paged_decode.cu", "inline bool bad_shape(")
    assert f"sh.D % {da.KERNEL_HEAD_DIM_UNIT} != 0" in bad and "sh.D != " not in bad
    body = _body("paged_decode.cu", 'extern "C" int socio_paged_decode(int quant')
    launched = set(re.findall(r"launch<(int8_t|bf16), (\d+)(, true)?>", body))
    assert launched == {(t, str(d), "") for t in ("int8_t", "bf16") for d in da.KERNEL_HEAD_DIMS} \
        | {(t, "256", ", true") for t in ("int8_t", "bf16")}
    assert "if (sh.D > 256)" in body and da.KERNEL_HEAD_DIMS == (128, 256)
    assert [da.decode_slices(d) for d in (128, 256, 384, 512, 640)] == [1, 1, 2, 2, 3]


class _Recorder:
    """A stand-in kernel library: records every entry point's arguments and
    returns success without launching anything."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("D", [264, 384, 512])
def test_wrappers_hand_wide_head_dims_to_the_kernels(D, monkeypatch):
    """A head dim above 256 reaches the kernels, which run it on their 256
    instance in column slices (the calls recorded by a stand-in library;
    the tensors made to read as CUDA tensors that pass the device and type
    checks): kernel 2 gets the width D and returns D columns; kernels 4-6's
    operands keep the width D and kernel 6's plan holds the slices' longer
    workspace slots and counters, while a plan for the default width is
    refused; the decode kernels (3 and 3q) take D where it is a multiple of
    128, with n_split counted over the slices' CTAs."""
    rec = _Recorder()
    q = torch.zeros(1, 8, 4, D, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, D, dtype=torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "is_cpu", property(lambda self: False))
    monkeypatch.setattr(fa, "check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(fb, "check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(fa._build, "library", lambda: rec)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    out = fa.flash_attention(q, k, k)
    (name, args), = rec.calls
    assert name == "socio_flash_prefill_bf16" and args[5:11] == (1, 8, 8, 4, 2, D)
    assert out.shape == q.shape
    assert fa.head_dim_plan(D, fa.KERNEL_HEAD_DIMS) == (D, 256, 2)
    dev = torch.device("cuda")
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: dev))
    operands = fb._check("flash_attention_bwd_dq", q, k, k, None, (q, q.shape))
    assert [t.shape[-1] for t in operands] == [D] * 4
    plan = fb.dkv_plan(None, 1, 8, 8, 4, 2, True, "cpu", cap=1, head_dim=D)
    narrow = fb.dkv_plan(None, 1, 8, 8, 4, 2, True, "cpu", cap=1)
    assert plan.slices == 2 and narrow.slices == 1
    assert plan.workspace.shape[1] == fb.dkv_slot_floats(D) == 128 * 256 * 2 * 2
    assert plan.counters.numel() == 2 * narrow.counters.numel()
    stats = torch.zeros(1, 4, 8)
    monkeypatch.setattr(fb, "_lens", lambda kv_lens, *a: torch.full((1,), 8, dtype=torch.int32))
    with pytest.raises(ValueError, match=rf"head dim {D} needs {128 * 256 * 2 * 2} for 2"):
        fb.flash_attention_bwd_dkv(q, k, k, q, stats, stats, None, plan=narrow)
    lens = torch.ones(2, dtype=torch.int32)
    monkeypatch.setattr(da, "_sm_count", lambda index: 132)
    rec.calls.clear()
    if D % 128:
        return
    qd = torch.zeros(2, 4, D, dtype=torch.bfloat16)
    for quant in (False, True):
        cache = torch.zeros(1, 2, 64, 2, D, dtype=torch.int8 if quant else torch.bfloat16)
        scales = (torch.zeros(1, 2, 2, 64),) * 2 if quant else ()
        assert da.paged_decode_attention(qd, cache, cache, lens, *scales,
                                         layer=0).shape == (2, 4, D)
        plan = da.decode_plan(qd, cache, cache, lens, *scales, stacked=True)
        assert plan.shape.D == D and plan.n_split == da.split_count(2, 2, 64, 132, 2) == 1
    assert [n for n, _ in rec.calls] == ["socio_paged_decode_encode", "socio_paged_decode"] * 2


@pytest.mark.parametrize("D", [192, 200])
def test_decode_kernel_refuses_head_dims_off_its_unit(D, monkeypatch):
    """A head dim that is no multiple of 128 (192, 200: the models decode
    them densely, as the JAX package does) forced onto the decode kernels
    (3 and 3q) raises ValueError naming H, Hkv and D before any pointer is
    passed: the tensors are made to read as CUDA tensors."""
    monkeypatch.setattr(torch.Tensor, "is_cpu", property(lambda self: False))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda")))
    monkeypatch.setattr(da._build, "library", lambda: pytest.fail("a pointer was passed"))
    lens = torch.ones(2, dtype=torch.int32)
    qd = torch.zeros(2, 4, D, dtype=torch.bfloat16)
    for quant in (False, True):
        cache = torch.zeros(1, 2, 64, 2, D, dtype=torch.int8 if quant else torch.bfloat16)
        scales = (torch.zeros(1, 2, 2, 64),) * 2 if quant else ()
        with pytest.raises(ValueError, match=rf"H=4 Hkv=2 D={D}"):
            da.paged_decode_attention(qd, cache, cache, lens, *scales, layer=0)


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


def test_dkv_workspace_fits_the_instance(monkeypatch):
    """Kernel 6's workspace slots hold a piece's f32 dK and dV of 128 keys at
    its instance's width (`kSlotFloats = kBK * kD * 2` in the source): a
    plan named for head dim 256 (or 136, on the same instance) has slots
    twice the default's, which fits every head dim up to 128; the wrapper
    refuses a default plan at 256, naming the head dim, before any pointer
    is passed."""
    assert "kSlotFloats = kBK * kD * 2;" in (CSRC / "flash_train_dkv_sm90.cu").read_text()
    assert fb.dkv_slot_floats() == fb.DKV_SLOT_FLOATS == 128 * 128 * 2
    assert fb.dkv_slot_floats(64) == fb.dkv_slot_floats(120) == fb.DKV_SLOT_FLOATS
    assert fb.dkv_slot_floats(136) == fb.dkv_slot_floats(256) == 128 * 256 * 2
    lens = torch.tensor([8, 3])
    wide = fb.dkv_plan(lens, 2, 8, 8, 4, 2, True, "cpu", cap=1, head_dim=256)
    plain = fb.dkv_plan(lens, 2, 8, 8, 4, 2, True, "cpu", cap=1)
    assert wide.workspace.shape == (plain.workspace.shape[0], 128 * 256 * 2)
    assert torch.equal(wide.items, plain.items) and wide.counters.shape == plain.counters.shape
    q = torch.zeros(2, 8, 4, 256, dtype=torch.bfloat16)
    k = torch.zeros(2, 8, 2, 256, dtype=torch.bfloat16)
    stats = torch.zeros(2, 4, 8)
    monkeypatch.setattr(torch.Tensor, "is_cpu", property(lambda self: False))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda")))
    monkeypatch.setattr(fb, "check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(fb, "_lens", lambda kv_lens, *a: kv_lens.to(torch.int32))
    monkeypatch.setattr(fb._build, "library", lambda: pytest.fail("a pointer was passed"))
    with pytest.raises(ValueError, match="head dim 256 needs 65536"):
        fb.flash_attention_bwd_dkv(q, k, k, q, stats, stats, lens, plan=plain)
