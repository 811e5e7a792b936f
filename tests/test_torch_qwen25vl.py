"""The port's Qwen2.5-VL (socioreasoner_tpu_torch.models.qwen2_5_vl) against
the JAX package's, on one JAX init_params tree bridged with params_from_numpy.
Port functions get the port's own config objects, copied field for field
(`_port`).

Float32 throughout at Qwen25VLConfig.tiny(); the bound is max-abs 1e-4 on
logits and ViT embeddings (float32 rounding accumulated over the layers).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from socioreasoner_tpu.datasets.processor import (ImageProcessorConfig,
                                                  process_images)
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl import rope as j_rope
from socioreasoner_tpu.models.qwen2_5_vl import vision as j_vision
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
from socioreasoner_tpu_torch.models.qwen2_5_vl import rope as t_rope
from socioreasoner_tpu_torch.models.qwen2_5_vl import config as t_config
from socioreasoner_tpu_torch.models.qwen2_5_vl import vision as t_vision
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy

TOL = 1e-4


def _port(obj):
    """The port's own copy of a JAX-package config dataclass, field for field."""
    mod = importlib.import_module(type(obj).__module__.replace(
        "socioreasoner_tpu.", "socioreasoner_tpu_torch.", 1))
    cls = getattr(mod, type(obj).__name__)
    return cls(**{f.name: _port(getattr(obj, f.name))
                  if dataclasses.is_dataclass(getattr(obj, f.name)) else getattr(obj, f.name)
                  for f in dataclasses.fields(obj) if f.init})


@pytest.fixture(scope="module")
def setup():
    config = Qwen25VLConfig.tiny()
    jp = j_model.init_params(config, jax.random.key(3), dtype=jnp.float32,
                             with_vision=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return config, jp, tp


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def _images(rng, sizes=((96, 124), (68, 68))):
    return [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
            for h, w in sizes]


IMG_CFG = dict(min_pixels=56 * 56, max_pixels=56 * 56 * 16)


# ------------------------------------------------------------------ rope

def test_rope_device_side_matches_jax(setup):
    config = setup[0]
    t = config.text
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 50, size=(2, 3, 9))
    inv = j_rope.make_inv_freq(t.head_dim, t.rope_theta)
    axis = j_rope.mrope_channel_axis(t.head_dim, t.mrope_section)
    jc, js = j_rope.mrope_cos_sin(jnp.asarray(pos), jnp.asarray(inv), axis)
    tc, ts = t_rope.mrope_cos_sin(torch.as_tensor(pos), torch.as_tensor(inv), axis)
    _close(tc, jc, 1e-6)
    _close(ts, js, 1e-6)
    q = rng.normal(size=(2, 9, 4, t.head_dim)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, t.head_dim)).astype(np.float32)
    jq, jk = j_rope.apply_rotary(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, tk = t_rope.apply_rotary(torch.as_tensor(q), torch.as_tensor(k), tc, ts)
    _close(tq, jq, 1e-6)
    _close(tk, jk, 1e-6)


def test_rope_host_helpers_match_jax(setup):
    config = setup[0]
    grid = np.array([[1, 8, 12], [1, 6, 6]])
    ids = np.array([[5, 6] + [config.image_token_id] * 24 + [7]
                    + [config.image_token_id] * 9 + [8, 9]])
    for got, want in zip(t_rope.get_rope_index(_port(config), ids, grid),
                         j_rope.get_rope_index(config, ids, grid)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(t_rope.vision_window_index(grid, _port(config.vision)),
                         j_rope.vision_window_index(grid, config.vision)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(t_rope.vision_rope_cos_sin(grid, _port(config.vision)),
                         j_rope.vision_rope_cos_sin(grid, config.vision)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- vision

def test_init_params_shapes_match_jax(setup):
    config, jp, _ = setup
    tp = t_model.init_params(_port(config), torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert shapes(tp) == jshapes


def test_vision_tower_matches_jax(setup):
    config, jp, tp = setup
    cfg = ImageProcessorConfig(**IMG_CFG)
    out = process_images(_images(np.random.default_rng(1)), cfg)
    want = j_vision.run_vision(config.vision, jp["vision"], out["pixel_values"],
                               out["image_grid_thw"])
    got = t_vision.run_vision(_port(config.vision), tp["vision"], out["pixel_values"],
                              out["image_grid_thw"])
    assert got.shape == want.shape
    _close(got, want)


def test_run_vision_u8_matches_jax(setup):
    config, jp, tp = setup
    cfg = ImageProcessorConfig(**IMG_CFG, defer_patchify=True)
    out = process_images(_images(np.random.default_rng(2)), cfg)
    want = j_vision.run_vision_u8(config.vision, jp["vision"], out["pixel_u8"],
                                  out["image_grid_thw"], cfg)
    got = t_vision.run_vision_u8(_port(config.vision), tp["vision"], out["pixel_u8"],
                                 out["image_grid_thw"], _port(cfg))
    _close(got, want)


# ------------------------------------------------------------------ text

def _vlm_inputs(config, rng, n_img_tokens, B=2, L=40):
    ids = rng.integers(2, 200, size=(B, L))
    ids[0, 5:5 + n_img_tokens] = config.image_token_id
    attn = np.ones((B, L), np.int64)
    attn[1, L - 7:] = 0
    return ids, attn


def test_forward_logits_match_jax(setup):
    config, jp, tp = setup
    rng = np.random.default_rng(4)
    grid = np.array([[1, 4, 8]])
    n_img = 8
    ids, attn = _vlm_inputs(config, rng, n_img)
    pos, _ = j_rope.get_rope_index(config, ids, grid, attn)
    embeds = rng.normal(size=(n_img, config.text.hidden_size)).astype(np.float32)
    want, _ = j_model.forward(config, jp, jnp.asarray(ids), jnp.asarray(pos),
                              jnp.asarray(attn), image_embeds=jnp.asarray(embeds))
    got, _ = t_model.forward(_port(config), tp, torch.as_tensor(ids), torch.as_tensor(pos),
                             torch.as_tensor(attn), image_embeds=torch.as_tensor(embeds))
    assert got.shape == want.shape
    _close(got, want)


def test_forward_with_vision_inputs_matches_jax(setup):
    """forward(vision_inputs=...) runs the tower inside the model call."""
    config, jp, tp = setup
    cfg = ImageProcessorConfig(**IMG_CFG)
    out = process_images(_images(np.random.default_rng(7), ((56, 112),)), cfg)
    prep = j_vision.vision_host_inputs(config.vision, out["pixel_values"],
                                       out["image_grid_thw"])
    n_img = prep["patches"].shape[0] // config.vision.spatial_merge_unit
    ids, attn = _vlm_inputs(config, np.random.default_rng(8), n_img)
    pos, _ = j_rope.get_rope_index(config, ids, out["image_grid_thw"], attn)
    want, _ = j_model.forward(config, jp, jnp.asarray(ids), jnp.asarray(pos),
                              jnp.asarray(attn),
                              vision_inputs={k: jnp.asarray(v) for k, v in prep.items()})
    vi = {k: torch.as_tensor(v) for k, v in
          t_vision.vision_host_inputs(_port(config.vision), out["pixel_values"],
                                      out["image_grid_thw"]).items()}
    got, _ = t_model.forward(_port(config), tp, torch.as_tensor(ids), torch.as_tensor(pos),
                             torch.as_tensor(attn), vision_inputs=vi)
    _close(got, want)


def test_scatter_image_embeds_matches_jax(setup):
    config = setup[0]
    rng = np.random.default_rng(5)
    ids, _ = _vlm_inputs(config, rng, 6, L=12)
    ids[1, 2:4] = config.image_token_id
    tok = rng.normal(size=(2, 12, 8)).astype(np.float32)
    img = rng.normal(size=(8, 8)).astype(np.float32)
    want = j_model.scatter_image_embeds(jnp.asarray(ids), jnp.asarray(tok),
                                        jnp.asarray(img), config.image_token_id)
    got = t_model.scatter_image_embeds(torch.as_tensor(ids), torch.as_tensor(tok),
                                       torch.as_tensor(img), config.image_token_id)
    _close(got, want, 0)


def test_prefill_then_cached_decode_matches_uncached(setup):
    """A prefill into a stacked cache plus N one-token cached steps (the
    kernels' plain versions on CPU) reproduce the uncached forward's logits."""
    config, _, tp = setup
    config = _port(config)
    t = config.text
    rng = np.random.default_rng(6)
    B, P, N = 2, 11, 4
    seq = rng.integers(2, 200, size=(B, P + N))
    Lmax = 64
    cache = {"k": torch.zeros(t.num_hidden_layers, B, Lmax, t.num_key_value_heads, t.head_dim),
             "v": torch.zeros(t.num_hidden_layers, B, Lmax, t.num_key_value_heads, t.head_dim)}

    def pos_of(ids):
        p, _ = t_rope.get_rope_index(config, ids, None, np.ones_like(ids))
        return torch.as_tensor(p)

    full, _ = t_model.forward(config, tp, torch.as_tensor(seq), pos_of(seq))
    ar = torch.arange(Lmax)
    cache["kv_valid"] = (ar[None] < P).int().expand(B, Lmax)
    logits, cache = t_model.forward(
        config, tp, torch.as_tensor(seq[:, :P]), pos_of(seq[:, :P]), cache=cache,
        cache_positions=torch.arange(P)[None].expand(B, P))
    _close(logits, full[:, :P].numpy())
    for i in range(N):
        L = P + i
        cache["kv_valid"] = (ar[None] < L + 1).int().expand(B, Lmax)
        pos = torch.full((B, 3, 1), L)
        logits, cache = t_model.forward(
            config, tp, torch.as_tensor(seq[:, L:L + 1]), pos, cache=cache,
            cache_positions=torch.full((B, 1), L))
        _close(logits[:, 0], full[:, L].numpy())


def test_unported_features_raise(setup):
    config, _, tp = setup
    config = _port(config)
    ids = torch.zeros(1, 4, dtype=torch.long)
    pos = torch.zeros(1, 3, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_model.forward(config, tp, ids, pos, cp=object())
    moe = t_config.Qwen25VLConfig(text=t_config.TextConfig(n_experts=4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_model.init_params(moe, torch.Generator(), device="cpu")
    qwen2 = dataclasses.replace(config.vision, variant="qwen2")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_vision.vision_tower(qwen2, tp["vision"], None, None, None, None, None, ())
