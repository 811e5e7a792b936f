"""The port's SAM2 (models/sam2, distributed/seg_strategy) against HF
transformers' Sam2Model and against the JAX package.

HF: a tiny random Sam2Model (the config of tests/test_sam2_parity.py) in
float64 through the port's loader, held at that file's tolerances: FPN
features, and masks and IoU scores for box, point and mask prompts.
JAX: the same HF weights through the JAX package's loader (float32) and the
weight bridge; preprocess, the position embeddings, the predictor's
bucketed union masks and its single-object predict in float32, and the
random init's tree. SegStrategy: against the JAX one, empty prompts, the
encoder-output cache (a stage-2 pass hits it, a reversed subset decodes
from it, 0 disables it).
"""

import functools

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from socioreasoner_tpu.distributed.seg_strategy import SegStrategy as JSegStrategy
from socioreasoner_tpu.models.sam2 import encoder as j_enc
from socioreasoner_tpu.models.sam2 import model as j_model
from socioreasoner_tpu.models.sam2.config import Sam2Config as JSam2Config
from socioreasoner_tpu.models.sam2.loader import load_from_torch_state_dict as j_load
from socioreasoner_tpu.protocol import BatchProto as JBatchProto
from socioreasoner_tpu_torch.configs.worker_config import WorkerConfig
from socioreasoner_tpu_torch.distributed.seg_strategy import SegStrategy
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.models.sam2 import decoder as t_dec
from socioreasoner_tpu_torch.models.sam2 import encoder as t_enc
from socioreasoner_tpu_torch.models.sam2 import model as t_model
from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
from socioreasoner_tpu_torch.models.sam2.loader import load_from_torch_state_dict
from socioreasoner_tpu_torch.protocol import BatchProto

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def hf_sam2():
    from transformers.models.sam2.configuration_sam2 import (
        Sam2Config as HFSam2Config, Sam2HieraDetConfig, Sam2VisionConfig,
        Sam2MaskDecoderConfig, Sam2PromptEncoderConfig)
    from transformers.models.sam2.modeling_sam2 import Sam2Model
    torch.manual_seed(0)
    hiera = Sam2HieraDetConfig(
        hidden_size=16, blocks_per_stage=[1, 2, 2, 1],
        embed_dim_per_stage=[16, 32, 64, 128],
        num_attention_heads_per_stage=[1, 2, 2, 4],
        window_size_per_stage=[8, 4, 14, 7],
        global_attention_blocks=[4], image_size=[128, 128])
    vision = Sam2VisionConfig(
        backbone_config=hiera, backbone_channel_list=[128, 64, 32, 16],
        backbone_feature_sizes=[[32, 32], [16, 16], [8, 8]], fpn_hidden_size=32)
    cfg = HFSam2Config(
        vision_config=vision,
        prompt_encoder_config=Sam2PromptEncoderConfig(hidden_size=32, image_size=128),
        mask_decoder_config=Sam2MaskDecoderConfig(hidden_size=32, mlp_dim=64,
                                                  num_attention_heads=2,
                                                  iou_head_hidden_dim=32))
    return Sam2Model(cfg).double().eval()


@pytest.fixture(scope="module")
def port_f64(hf_sam2):
    config = Sam2Config.tiny_test()
    return config, load_from_torch_state_dict(config, hf_sam2.state_dict(),
                                              torch.float64, CPU)


@pytest.fixture(scope="module")
def jax_sam2(hf_sam2):
    """The JAX package's tree of the HF weights (float32), once a module."""
    return JSam2Config.tiny_test(), j_load(JSam2Config.tiny_test(), hf_sam2.state_dict(),
                                           jnp.float32)


@pytest.fixture(scope="module")
def port_f32(jax_sam2):
    """The port's tree through the weight bridge, with the decoder's mask
    projections scaled ×1000 on both sides so that the mask logits are of
    size ~0.1 (random weights give ~1e-4, all within the union check's
    1e-4 band)."""
    config, jp = jax_sam2
    tree = jax.tree.map(np.asarray, jp)
    for m in tree["decoder"]["hyper_mlps"]:
        m["fc_out_w"] = m["fc_out_w"] * 1000.0
    return Sam2Config.tiny_test(), params_from_numpy(tree, CPU), jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(0).normal(size=(1, 3, 128, 128))


def _port_embeddings(config, params, pixels):
    pos = torch.as_tensor(t_enc.hiera_pos_embed(params["encoder"]["hiera"], config.hiera,
                                                32, 32))
    x = torch.as_tensor(pixels.transpose(0, 2, 3, 1))
    return pos, x


def test_vision_encoder_matches_hf(hf_sam2, port_f64, pixels):
    config, params = port_f64
    with torch.no_grad():
        want = hf_sam2.vision_encoder(torch.tensor(pixels)).fpn_hidden_states
        pos, x = _port_embeddings(config, params, pixels)
        got = t_enc.image_encoder_forward(config, params["encoder"], x, pos)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 3, 1, 2).numpy(), w.numpy(),
                                   atol=1e-6, rtol=1e-5)


PROMPTS = {
    "box": dict(boxes=np.array([[[20.0, 30.0, 90.0, 100.0], [5.0, 5.0, 60.0, 64.0]]])),
    "point": dict(points=np.array([[[[40.0, 50.0], [70.0, 80.0]]]]),
                  labels=np.array([[[1, 1]]])),
    "mask": dict(points=np.array([[[[40.0, 50.0]]]]), labels=np.array([[[1]]]),
                 mask=np.random.default_rng(7).normal(size=(1, 1, 32, 32))),
}


@pytest.mark.parametrize("kind", sorted(PROMPTS))
def test_prompt_masks_match_hf(hf_sam2, port_f64, pixels, kind):
    config, params = port_f64
    pr = PROMPTS[kind]
    kwargs = {}
    if "boxes" in pr:
        kwargs["input_boxes"] = torch.tensor(pr["boxes"])
    if "points" in pr:
        kwargs["input_points"] = torch.tensor(pr["points"])
        kwargs["input_labels"] = torch.tensor(pr["labels"])
    if "mask" in pr:
        kwargs["input_masks"] = torch.tensor(pr["mask"])
    t = lambda k: torch.as_tensor(pr[k]) if k in pr else None  # noqa: E731
    with torch.no_grad():
        want = hf_sam2(pixel_values=torch.tensor(pixels), multimask_output=True, **kwargs)
        pos, x = _port_embeddings(config, params, pixels)
        emb = t_model.encode_image(config, params, x, pos)
        pe = torch.as_tensor(t_dec.image_wide_positional_embedding(config.prompt,
                                                                   params["prompt"]))
        masks, iou = t_model.predict_masks(
            config, params, emb, pe, t("points"), t("labels"), t("boxes"),
            multimask_output=True,
            input_masks=None if "mask" not in pr else
            torch.as_tensor(pr["mask"].transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(masks.numpy(), want.pred_masks.numpy(), atol=1e-7, rtol=1e-5)
    np.testing.assert_allclose(iou.numpy(), want.iou_scores.numpy(), atol=1e-8, rtol=1e-6)


def test_bridge_tree_matches_loader(hf_sam2, jax_sam2):
    """The JAX tree through the weight bridge (lists included) equals the
    port loader's tree of the same HF weights, leaf for leaf."""
    _, jp = jax_sam2
    bridged = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    loaded = load_from_torch_state_dict(Sam2Config.tiny_test(), hf_sam2.state_dict(),
                                        torch.float32, CPU)

    def walk(a, b, path):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,))
        else:
            assert a.dtype == b.dtype == torch.float32 and a.device == CPU, path
            assert torch.equal(a, b), path
    walk(bridged, loaded, ())
    assert isinstance(bridged["encoder"]["hiera"]["blocks"], list)
    assert len(bridged["encoder"]["hiera"]["blocks"]) == 6


@pytest.mark.parametrize("which", ["tiny_test", "large"])
def test_hiera_pos_embed_matches_jax(which):
    config = getattr(Sam2Config, which)()
    hc = config.hiera
    rng = np.random.default_rng(3)
    p = {"pos_embed": rng.normal(size=(1, hc.hidden_size, *hc.window_pos_bg_size)
                                 ).astype(np.float32),
         "pos_embed_window": rng.normal(size=(1, hc.hidden_size,
                                              hc.window_size_per_stage[0],
                                              hc.window_size_per_stage[0])).astype(np.float32)}
    grid = config.image_size // hc.patch_stride[0]
    want = j_enc.hiera_pos_embed(p, getattr(JSam2Config, which)().hiera, grid, grid)
    got = t_enc.hiera_pos_embed(p, hc, grid, grid)
    assert got.shape == want.shape == (1, grid, grid, hc.hidden_size)
    np.testing.assert_array_equal(got.astype(np.float32), want)
    x = rng.normal(size=(7, 7, 3))
    torch_bicubic = torch.nn.functional.interpolate(
        torch.tensor(x.transpose(2, 0, 1)[None]), size=(32, 32), mode="bicubic"
    ).numpy()[0].transpose(1, 2, 0)
    np.testing.assert_allclose(t_enc.bicubic_resize_hw(x, 32, 32), torch_bicubic, atol=1e-10)
    np.testing.assert_array_equal(t_enc.sine_position_encoding(grid // 4, grid // 4, 16),
                                  j_enc.sine_position_encoding(grid // 4, grid // 4, 16))


@pytest.mark.parametrize("size,S", [(756, 1024), (96, 128), (756, 128)])
def test_preprocess_matches_jax(size, S):
    """uint8 tile → normalized pixels: up (756→1024, the main path; 96→128)
    and down (756→128, the tiny pipeline), jax.image.resize "linear"."""
    img = np.random.default_rng(size + S).integers(0, 255, (size, size, 3), dtype=np.uint8)
    want = np.asarray(j_model.preprocess_image_device(img, S))
    got = t_model.preprocess_image_device(img, S, torch.float32, CPU)
    assert got.shape == (1, S, S, 3) and got.device == CPU
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


def _tiles(seed, n, px=96):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, (px, px, 3), dtype=np.uint8))
            for _ in range(n)]


UNION_PROMPTS = [
    [{"box": [10, 10, 40, 40]}],
    [{"box": [5, 5, 30, 30]},
     {"box": [50, 50, 90, 90], "points": [[60, 60], [70, 62], [80, 85]], "labels": [1, 1, 0]}],
    [],
]


def test_union_masks_match_jax(port_f32):
    """set_images + predict_objects_mask_batch (K and N bucketed to 2 and 4,
    padding points attending) against the JAX predictor: the union masks
    agree at every pixel but those whose JAX logit is within 1e-4 of 0."""
    config, tp, jp = port_f32
    imgs = _tiles(5, 3)
    out_size = (72, 72)
    jpred = j_model.Sam2Predictor(JSam2Config.tiny_test(), jp)
    jpred.set_images(imgs)
    want = jpred.predict_objects_mask_batch(UNION_PROMPTS, out_size)
    tpred = t_model.Sam2Predictor(config, tp)
    tpred.set_images(imgs)
    got = tpred.predict_objects_mask_batch(UNION_PROMPTS, out_size)

    # the JAX logits of each tile's chosen masks, at the output pixels
    pts, lbl, boxes, valid = (None if t is None else t.numpy()
                              for t in tpred.prompt_tensors(UNION_PROMPTS))
    masks, iou = jpred._predict(jp, jpred._embeddings, jpred.image_pe,
                                jnp.asarray(pts), jnp.asarray(lbl.astype(np.int32)),
                                jnp.asarray(boxes), multimask_output=True)
    masks, iou = np.asarray(masks), np.asarray(iou)
    best = np.take_along_axis(masks, iou.argmax(-1)[:, :, None, None, None], 2)[:, :, 0]
    near = ((np.abs(best) < 1e-4) & valid[:, :, None, None]).any(1)     # (B, h, w)
    h = near.shape[1]
    idx = np.minimum(((np.arange(out_size[0]) + 0.5) * h / out_size[0]).astype(int), h - 1)
    near = near[:, idx][:, :, idx]
    assert np.abs(best).max() > 1e-2          # the band excludes few pixels
    for b, (g, w) in enumerate(zip(got, want)):
        assert g.shape == out_size and g.dtype == np.uint8
        assert near[b].mean() < 0.05
        np.testing.assert_array_equal(g[~near[b]], w[~near[b]])
    assert got[2].sum() == 0 and 0 < got[1].sum() < got[1].size
    # the one-tile path (K and N not bucketed)
    jpred.set_image(imgs[1])
    tpred.set_image(imgs[1])
    one = tpred.predict_objects_mask(UNION_PROMPTS[1], out_size)
    assert (one == jpred.predict_objects_mask(UNION_PROMPTS[1], out_size)).mean() > 0.999
    assert not tpred.predict_objects_mask([], out_size).any()


def _counting(strat):
    calls = []
    orig = strat.predictor.set_images

    def counting(images):
        calls.append(len(images))
        return orig(images)
    strat.predictor.set_images = counting
    return calls


def _seg(strat, imgs, prompts, proto=BatchProto):
    return strat.segment(proto.from_dict(non_tensors={"seg_image": imgs,
                                                      "visual_prompt": prompts}))


def test_seg_strategy_matches_jax_and_empty_prompts(port_f32):
    """Batched segment() of three tiles, one without prompts (→ an empty
    768² mask without an encode), against the JAX SegStrategy."""
    config, tp, jp = port_f32
    imgs = _tiles(6, 3)
    prompts = [[{"box": [10, 10, 40, 40]}], [], [{"box": [20, 20, 60, 60]}]]
    strat = SegStrategy()
    strat.initialize(config, tp)
    calls = _counting(strat)
    out = _seg(strat, imgs, prompts)
    jstrat = JSegStrategy()
    jstrat.initialize(JSam2Config.tiny_test(), jp)
    want = _seg(jstrat, imgs, prompts, JBatchProto)
    assert calls == [2]
    assert all(o["mask"].shape == (768, 768) and o["mask"].dtype == np.uint8 for o in out)
    assert out[1]["mask"].sum() == 0
    for o, w in zip(out, want):
        assert (o["mask"] == w["mask"]).mean() > 0.999


def test_seg_strategy_embed_cache(port_f32):
    """A second segment() of the SAME source images (the stage-2 pass) skips
    the encoder and gives the same masks for the same prompts; a copy of an
    image is a miss (keyed on identity); seg_embed_cache 0 disables it."""
    config, tp, _ = port_f32
    strat = SegStrategy()
    strat.initialize(config, tp)
    calls = _counting(strat)
    imgs = _tiles(7, 2)
    s1 = [[{"box": [10, 10, 40, 40]}], [{"box": [20, 20, 60, 60]}]]
    s2 = [[{"box": [10, 10, 40, 40], "points": [[20, 20]], "labels": [1]}],
          [{"box": [20, 20, 60, 60]}]]
    out1 = _seg(strat, imgs, s1)
    assert calls == [2]
    _seg(strat, imgs, s2)
    assert calls == [2]
    out1b = _seg(strat, imgs, s1)
    assert calls == [2]
    for a, b in zip(out1, out1b):
        np.testing.assert_array_equal(a["mask"], b["mask"])
    _seg(strat, [im.copy() for im in imgs], s1)
    assert calls == [2, 2]
    wc = WorkerConfig()
    wc.strategy_args.strategy_config = {"seg_embed_cache": 0}
    strat.worker_config = wc
    _seg(strat, imgs, s1)
    _seg(strat, imgs, s1)
    assert calls == [2, 2, 2, 2]


def test_seg_strategy_cache_hit_subset_order(port_f32):
    """A cache-hit group that differs from the last encoded batch (a subset,
    reversed) decodes from the cached per-image embeddings, not from the
    predictor's last set_images state."""
    config, tp, _ = port_f32
    imgs = _tiles(11, 3)
    prompts = [[{"box": [8 + 10 * i, 8, 48 + 10 * i, 48]}] for i in range(3)]
    strat = SegStrategy()
    strat.initialize(config, tp)
    _seg(strat, imgs, prompts)
    calls = _counting(strat)
    out = _seg(strat, [imgs[2], imgs[0]], [prompts[2], prompts[0]])
    assert calls == []
    fresh = SegStrategy()
    fresh.initialize(config, tp)
    ref = _seg(fresh, [imgs[2], imgs[0]], [prompts[2], prompts[0]])
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a["mask"], b["mask"])
    assert any(a["mask"].sum() for a in out)


def test_init_params_matches_jax_shapes():
    """The port's random init has the JAX init's tree, shapes and dtype, on
    the device it is given."""
    config = Sam2Config.tiny_test()
    got = t_model.init_params(config, torch.Generator().manual_seed(0), torch.bfloat16, CPU)
    want = jax.eval_shape(functools.partial(j_model.init_params, JSam2Config.tiny_test(),
                                            dtype=jnp.bfloat16), jax.random.key(0))
    got_leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype), t.device.type), got))
    want_leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda s: (tuple(s.shape), "torch.bfloat16", "cpu"), want))
    assert got_leaves == want_leaves


@pytest.mark.parametrize("multimask", [True, False], ids=["multimask", "dynamic_single"])
def test_predict_matches_jax(port_f32, multimask):
    """The single-object predict surface: a point, a box and a low-res mask
    prompt in ORIGINAL pixels; with multimask off, the stability-based
    choice between the single mask and the best of the three. Scores and
    low-res logits in f32, and the full-size masks (linear upsampling) at
    every pixel whose JAX logit is not within 1e-4 of 0."""
    config, tp, jp = port_f32
    img = np.asarray(_tiles(13, 1)[0])
    hm = config.prompt.mask_input_size[0]
    kw = dict(point_coords=[[30.0, 40.0], [60.0, 20.0]], point_labels=[1, 0],
              box=[10.0, 12.0, 80.0, 70.0], multimask_output=multimask,
              mask_input=np.random.default_rng(4).normal(size=(1, hm, hm)) * 0.1)
    jpred = j_model.Sam2Predictor(JSam2Config.tiny_test(), jp)
    jpred.set_image(img)
    want = jpred.predict(**kw)
    tpred = t_model.Sam2Predictor(config, tp)
    tpred.set_image(img)
    got = tpred.predict(**kw)
    n = 3 if multimask else 1
    assert got[0].shape == (n, 96, 96) and got[0].dtype == bool
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)
    logits_up = np.asarray(jax.image.resize(want[2], (n, 96, 96), "linear"))
    far = np.abs(logits_up) > 1e-4
    assert far.mean() > 0.95
    np.testing.assert_array_equal(got[0][far], want[0][far])
