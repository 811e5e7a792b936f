"""The ViT's gradient through a train step given `vision_inputs`, against
the JAX package's, and the refusals that keep the segmented kernel (which
has no backward) out of a differentiable call.

The model call runs the tower with use_flash=False, dense attention in f32
softmax, on every device, as the JAX model call does; the serving paths
(run_vision, run_vision_u8) take the kernel on the GPU. Before this, on the
GPU, the kernel's output had no autograd node and every block's qkv_w,
qkv_b and norm1 got no gradient.

A train step of each package at Qwen25VLConfig.tiny() in float32, from one
JAX init_params tree, on one GRPO batch whose image rows come from four
56-px images through the tower; an optimizer that keeps the step's grads as
its state. Bounds: train_parity's (loss within 1e-3, grad norm within 2%),
and each leaf's gradient within 1e-5 of its scale (float32 rounding).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from PIL import Image

from socioreasoner_tpu.datasets.processor import ImageProcessorConfig, process_images
from socioreasoner_tpu.distributed import trainer as JT
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl import vision as j_vision
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.pipeline import losses as JL
from socioreasoner_tpu_torch.distributed import trainer as TT
from socioreasoner_tpu_torch.models.qwen2_5_vl import vision as t_vision
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.ops import flash_attention as t_fa
from socioreasoner_tpu_torch.pipeline import losses as TL
from tests.test_torch_engine import _port
from tests.test_torch_train import _grpo_batch, _tree_pairs

N_IMAGES = 4           # one 56-px image a row: 16 patches, 4 merged rows


def _keep_grads_jax():
    """An optax transformation that leaves the params and keeps the grads."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


class _KeepGrads(TT.Optimizer):
    """The port's counterpart: the grads of the last update as its state."""

    def __init__(self):
        super().__init__(schedule=lambda count: 0.0)

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        state["grads"] = list(grads)


@functools.lru_cache(maxsize=1)
def _steps():
    config = Qwen25VLConfig.tiny()
    jp = j_model.init_params(config, jax.random.key(5), dtype=jnp.float32, with_vision=True)
    np_params = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(2)
    images = [Image.fromarray(rng.integers(0, 255, (56, 56, 3), dtype=np.uint8))
              for _ in range(N_IMAGES)]
    pix = process_images(images, ImageProcessorConfig(min_pixels=56 * 56,
                                                      max_pixels=56 * 56))
    vi = j_vision.vision_host_inputs(config.vision, pix["pixel_values"], pix["image_grid_thw"])
    batch, _ = _grpo_batch(config, seed=4, n_img=len(vi["inv_perm"]) // N_IMAGES)

    jstate = JT.TrainState.create(jp, _keep_grads_jax())
    jstep = jax.jit(JT.make_train_step(config, JL.PPOLossConfig(), _keep_grads_jax()))
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items()},
              "vision_inputs": {k: jnp.asarray(v) for k, v in vi.items()}}
    jstate, jm = jstep(jstate, jbatch)

    topt = _KeepGrads()
    tparams = params_from_numpy(np_params, "cpu")
    tstate = TT.TrainState.create(tparams, topt)
    tstep = TT.make_train_step(_port(config), TL.PPOLossConfig(), topt)
    tvi = {k: torch.as_tensor(v) for k, v in t_vision.vision_host_inputs(
        _port(config.vision), pix["pixel_values"], pix["image_grid_thw"]).items()}
    tbatch = {**{k: torch.as_tensor(v) for k, v in batch.items()}, "vision_inputs": tvi}
    tstate, tm = tstep(tstate, tbatch)
    # the grads are aligned with tree_leaves(params)
    names = [(name, p) for name, p, _ in _tree_pairs(tstate.params, np_params)]
    leaves = TT.tree_leaves(tstate.params)
    assert len(names) == len(leaves) and all(p is q for (_, p), q in zip(names, leaves))
    tgrads = {name: g for (name, _), g in zip(names, tstate.opt_state["grads"])}
    return (jax.tree.map(np.asarray, jstate.opt_state), jm, tgrads, tm, np_params)


def test_train_step_with_vision_inputs_matches_jax():
    jgrads, jm, tgrads, tm, _ = _steps()
    loss_j, loss_t = float(jm["actor_train/loss"]), float(tm["actor_train/loss"])
    norm_j, norm_t = float(jm["actor_train/grad_norm"]), float(tm["actor_train/grad_norm"])
    assert abs(loss_t - loss_j) <= 1e-3
    assert abs(norm_t - norm_j) <= 2e-2 * norm_j


def _vit_pairs():
    """(leaf name, port grad, JAX grad) of every ViT leaf."""
    jgrads, _, tgrads, _, np_params = _steps()

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v
    want = dict(flat(jgrads))
    return [(name, tgrads[name], want[name]) for name in tgrads if name.startswith("vision/")]


def test_every_vit_leaf_gets_jax_gradient():
    """Every ViT leaf's gradient is there (qkv_w, qkv_b and norm1 of every
    block among them), is not zero, and equals JAX's within 1e-5 of its
    scale."""
    pairs = _vit_pairs()
    names = {name for name, _, _ in pairs}
    assert {"vision/blocks/qkv_w", "vision/blocks/qkv_b", "vision/blocks/norm1",
            "vision/patch_embed_w", "vision/merger_fc2_w"} <= names
    for name, got, want in pairs:
        assert got is not None, name
        got = got.detach().numpy()
        scale = np.abs(want).max()
        assert scale > 0 and np.abs(got).max() > 0, name
        assert np.abs(got - want).max() <= 1e-5 * scale, (name, np.abs(got - want).max(), scale)
        if name.startswith("vision/blocks/"):
            per_block = np.abs(got.reshape(got.shape[0], -1)).max(-1)
            assert (per_block > 0).all(), name


def test_vision_tower_refuses_the_kernel_under_grad():
    """use_flash=True asks for the segmented kernel, which has no backward:
    under autograd the tower raises on every device (on the CPU the plain
    path would be differentiable, but the GPU's kernel would drop the
    gradient); under no_grad, and without a leaf that requires grad, it
    runs and equals the dense tower."""
    config = _port(Qwen25VLConfig.tiny())
    _, _, _, _, np_params = _steps()
    params = params_from_numpy(np_params, "cpu")["vision"]
    rng = np.random.default_rng(3)
    grid = np.array([[1, 4, 8]])
    host = t_vision.vision_host_inputs(
        config.vision, rng.normal(size=(32, config.vision.patch_input_dim)).astype(np.float32),
        grid)
    args = [torch.as_tensor(host[k]) for k in ("patches", "cos", "sin", "window_seg",
                                               "full_seg")] + [host["is_full_layer"]]
    dense = t_vision.vision_tower(config.vision, params, *args)
    with torch.no_grad():
        flash = t_vision.vision_tower(config.vision, params, *args, use_flash=True)
    torch.testing.assert_close(flash, dense, rtol=0, atol=1e-5)
    params["blocks"]["qkv_w"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        t_vision.vision_tower(config.vision, params, *args, use_flash=True)
    out = t_vision.vision_tower(config.vision, params, *args)
    out.sum().backward()
    assert params["blocks"]["qkv_w"].grad.abs().max() > 0


@pytest.mark.cuda
def test_cuda_segmented_kernel_refuses_grad():
    """On the GPU the kernel wrapper raises when q, k or v requires grad
    (its output would carry no gradient), and launches without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(256, 16, 80, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    seg = torch.zeros(256, dtype=torch.int32)
    n = t_fa.flash_attention_segmented.launches
    with pytest.raises(RuntimeError, match="no backward"):
        t_fa.flash_attention_segmented(q.requires_grad_(), k, v, seg)
    assert t_fa.flash_attention_segmented.launches == n
    out = t_fa.flash_attention_segmented(q.detach(), k, v, seg)
    assert out.shape == q.shape and t_fa.flash_attention_segmented.launches == n + 1


def test_chip_smoke_vit_grad_check_on_cpu():
    """chip_smoke's train_parity ViT check at the tiny config on one 56-px
    tile: every block's qkv_w gradient there, each ViT leaf's gradient norm
    in bf16 within 2% of f32's."""
    import chip_smoke
    out = chip_smoke.run_vit_grad_check(_port(Qwen25VLConfig.tiny()), torch.device("cpu"),
                                        tile_px=56, text_tokens=24)
    assert out["kernel_refused_grad"] is None and len(out["qkv_w_grad_max_abs_per_block"]) == 4
    assert out["max_rel_norm_diff"] <= chip_smoke.PARITY_NORM_TOL
