"""The port's qwen2 ViT variant (Qwen2-VL: LayerNorm with bias, fc1 →
quick-GELU → fc2, full attention in every block, a LayerNorm merger)
against the JAX package's, on the tiny random HF Qwen2-VL of
tests/test_qwen2vl_parity.py.

Float64 (the JAX side with x64 on): the HF loader's tree against JAX's bit
for bit; run_vision against JAX's and against HF's own tower, and the full
image forward's logits against JAX's, 1e-6; run_vision_u8 against JAX's,
1e-6. The bf16 tower (both packages' trees cast to bfloat16) against JAX's
bf16 tower, 2e-2 of the output's largest value (bf16 rounding through four
blocks), and the int8 tower of JAX's quantize_vision_params against JAX's
in float32 with x64 off, to the same 2e-2 of its largest value: the tower
runs w8a8, and its LayerNorm and quick-GELU differ from XLA's by 1-4 ulp
on the CPU, enough to move an activation across a rounding step of its
int8 code (observed: 1.2e-3 of 0.1 at most, 9% of the elements past 1e-4).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.datasets.processor import ImageProcessorConfig, process_images
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl import rope as j_rope
from socioreasoner_tpu.models.qwen2_5_vl import vision as j_vision
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.models.qwen2_5_vl.loader import load_from_torch_state_dict
from socioreasoner_tpu.ops import quant as jq
from socioreasoner_tpu_torch.models.qwen2_5_vl import config as t_config
from socioreasoner_tpu_torch.models.qwen2_5_vl import loader as t_loader
from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
from socioreasoner_tpu_torch.models.qwen2_5_vl import rope as t_rope
from socioreasoner_tpu_torch.models.qwen2_5_vl import vision as t_vision
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy

VOCAB = 512


@pytest.fixture(scope="module", autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _port(obj):
    """The port's own copy of a JAX-package config dataclass, field for field."""
    mod = importlib.import_module(type(obj).__module__.replace(
        "socioreasoner_tpu.", "socioreasoner_tpu_torch.", 1))
    cls = getattr(mod, type(obj).__name__)
    return cls(**{f.name: _port(getattr(obj, f.name))
                  if dataclasses.is_dataclass(getattr(obj, f.name)) else getattr(obj, f.name)
                  for f in dataclasses.fields(obj) if f.init})


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """(HF float64 model, JAX config, JAX float64 tree, port config, the
    port loader's float64 tree)."""
    from transformers import Qwen2VLConfig
    from transformers.models.qwen2_vl.modeling_qwen2_vl import Qwen2VLForConditionalGeneration
    torch.manual_seed(0)
    hf_cfg = Qwen2VLConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=1024, rope_theta=1000000.0, rms_norm_eps=1e-6,
        rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        tie_word_embeddings=False,
        image_token_id=VOCAB - 3, video_token_id=VOCAB - 2,
        vision_start_token_id=VOCAB - 4, vision_end_token_id=VOCAB - 1,
        vision_config={"depth": 4, "embed_dim": 64, "mlp_ratio": 2, "num_heads": 4,
                       "patch_size": 14, "temporal_patch_size": 2,
                       "spatial_merge_size": 2, "hidden_size": 64, "in_channels": 3})
    model = Qwen2VLForConditionalGeneration(hf_cfg).double().eval()
    config = Qwen25VLConfig.from_hf_dict(hf_cfg.to_dict())
    tconfig = t_config.Qwen25VLConfig.from_hf_dict(hf_cfg.to_dict())
    assert tconfig == _port(config) and tconfig.vision.variant == "qwen2"
    jp = load_from_torch_state_dict(config, model.state_dict(), jnp.float64)
    tp = t_loader.load_from_torch_state_dict(tconfig, model.state_dict(), torch.float64,
                                             device="cpu")
    return model, config, jp, tconfig, tp


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.detach().float().numpy() if got.dtype == torch.bfloat16
                               else got.detach().numpy(), np.asarray(want, np.float64),
                               atol=tol, rtol=tol)


def _patches(cfg, seed, grid):
    S = int(grid.prod(-1).sum())
    return np.random.default_rng(seed).normal(size=(S, cfg.patch_input_dim))


def test_loader_tree_matches_jax(setup):
    _, _, jp, _, tp = setup
    want = dict(_leaves(_np_tree(jp)))
    got = dict(_leaves(tp))
    assert got.keys() == want.keys()
    assert {"vision/blocks/fc1_w", "vision/blocks/norm1_b", "vision/merger_ln_q_b"} <= got.keys()
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k


def test_qwen2_vision_tower_matches_jax_and_hf(setup):
    model, config, jp, tconfig, tp = setup
    grid = np.array([[1, 4, 4], [1, 6, 4]])
    patches = _patches(config.vision, 2, grid)
    want = j_vision.run_vision(config.vision, jp["vision"], patches, grid)
    got = t_vision.run_vision(tconfig.vision, tp["vision"], patches, grid)
    assert got.shape == want.shape and got.dtype == torch.float64
    _close(got, want)
    with torch.no_grad():
        hf = model.model.visual(torch.tensor(patches), torch.tensor(grid))
    _close(got, hf.numpy())
    # the dense, differentiable route (the model call's) computes the same
    prep = t_vision.vision_host_inputs(tconfig.vision, patches, grid)
    dense = t_vision.vision_tower(
        tconfig.vision, tp["vision"], torch.as_tensor(prep["patches"]),
        torch.as_tensor(prep["cos"]), torch.as_tensor(prep["sin"]),
        torch.as_tensor(prep["window_seg"]), torch.as_tensor(prep["full_seg"]),
        prep["is_full_layer"], use_flash=False)[torch.as_tensor(prep["inv_perm"])]
    _close(dense, want)


def test_qwen2_bf16_tower_matches_jax(setup):
    _, config, jp, tconfig, _ = setup
    grid = np.array([[1, 8, 8], [1, 4, 6]])
    patches = _patches(config.vision, 4, grid).astype(np.float32)
    jv = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp["vision"])
    want = np.asarray(j_vision.run_vision(config.vision, jv, patches, grid), np.float64)
    tv = params_from_numpy(_np_tree(jv), device="cpu", dtype=torch.bfloat16)
    got = t_vision.run_vision(tconfig.vision, tv, patches, grid)
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= 2e-2 * scale


def test_qwen2_run_vision_u8_matches_jax(setup):
    _, config, jp, tconfig, tp = setup
    cfg = ImageProcessorConfig(min_pixels=56 * 56, max_pixels=56 * 56 * 16,
                               defer_patchify=True)
    rng = np.random.default_rng(3)
    from PIL import Image
    images = [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
              for h, w in ((96, 124), (68, 68))]
    out = process_images(images, cfg)
    want = j_vision.run_vision_u8(config.vision, jp["vision"], out["pixel_u8"],
                                  out["image_grid_thw"], cfg)
    got = t_vision.run_vision_u8(tconfig.vision, tp["vision"], out["pixel_u8"],
                                 out["image_grid_thw"], _port(cfg))
    _close(got, want)


def test_qwen2_image_forward_matches_jax(setup):
    model, config, jp, tconfig, tp = setup
    grid = np.array([[1, 4, 4]])
    ids = np.array([[5, 6, VOCAB - 4] + [VOCAB - 3] * 4 + [8, 9]])
    attn = np.ones_like(ids)
    patches = _patches(config.vision, 5, grid)
    pos, _ = j_rope.get_rope_index(config, ids, grid, attn)
    tpos, _ = t_rope.get_rope_index(tconfig, ids, grid, attn)
    assert np.array_equal(tpos, pos)
    want, _ = j_model.forward(config, jp, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(attn),
                              image_embeds=j_vision.run_vision(config.vision, jp["vision"],
                                                               patches, grid))
    got, _ = t_model.forward(tconfig, tp, torch.as_tensor(ids), torch.as_tensor(pos),
                             torch.as_tensor(attn),
                             image_embeds=t_vision.run_vision(tconfig.vision, tp["vision"],
                                                              patches, grid))
    _close(got, want)
    with torch.no_grad():
        hf = model(input_ids=torch.tensor(ids), attention_mask=torch.tensor(attn),
                   pixel_values=torch.tensor(patches),
                   image_grid_thw=torch.tensor(grid)).logits
    _close(got, hf.numpy())


def test_qwen2_int8_tower_matches_jax(setup):
    """In float32 with x64 off, as the JAX package runs it: under x64 its
    activation quantizer computes in float64."""
    _, config, jp, tconfig, _ = setup
    grid = np.array([[1, 8, 12], [1, 4, 4]])
    patches = _patches(config.vision, 9, grid).astype(np.float32)
    jax.config.update("jax_enable_x64", False)
    try:
        j32 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)), jp["vision"])
        qv = jq.quantize_vision_params(j32)
        want = np.asarray(j_vision.run_vision(config.vision, qv, patches, grid))
        full = np.asarray(j_vision.run_vision(config.vision, j32, patches, grid))
    finally:
        jax.config.update("jax_enable_x64", True)
    assert qv["blocks"]["fc1_w"].dtype == jnp.int8 and qv["blocks"]["fc2_w"].dtype == jnp.int8
    with torch.no_grad():
        got = t_vision.run_vision(tconfig.vision, params_from_numpy(_np_tree(qv), device="cpu"),
                                  patches, grid)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 2e-2 * scale
    assert np.abs(want - full).max() > 1e-4   # really quantized
