"""The port's checkpoint reading and writing against the `safetensors`
package and the JAX package: utils/safetensors_io.py both ways and without
the package (BF16 included), the Qwen2.5-VL HF loader on a tiny random HF
model saved in f32 and bf16 under both name layouts, export round trips
through either package's loader and writer, and SAM2 from disk.

Loaded trees are compared leaf for leaf, bit for bit; the port model's
logits on its loaded tree against JAX's forward on JAX's, max-abs 1e-4 in
float32 (the bound of tests/test_torch_qwen25vl.py).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.models.qwen2_5_vl import export as j_export
from socioreasoner_tpu.models.qwen2_5_vl import loader as j_loader
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl import rope as j_rope
from socioreasoner_tpu.models.qwen2_5_vl.config import (Qwen25VLConfig, TextConfig,
                                                        VisionConfig)
from socioreasoner_tpu.models.sam2 import loader as j_sam_loader
from socioreasoner_tpu.models.sam2.config import Sam2Config as JSam2Config
from socioreasoner_tpu_torch.models.qwen2_5_vl import export as t_export
from socioreasoner_tpu_torch.models.qwen2_5_vl import loader as t_loader
from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.models.sam2 import loader as t_sam_loader
from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
from socioreasoner_tpu_torch.utils import safetensors_io as sio

from tests.test_torch_engine import _port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 512
CPU = "cpu"


# ------------------------------------------------------------ safetensors

def _sample_tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn((3, 5), generator=g),
        "f16": torch.randn((7,), generator=g).half(),
        "bf16": torch.randn((2, 3, 4), generator=g).bfloat16(),
        "i8": torch.randint(-128, 128, (9,), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 256, (4, 2), generator=g, dtype=torch.uint8),
        "i32": torch.randint(-2**31, 2**31 - 1, (3,), generator=g, dtype=torch.int32),
        "i64": torch.randint(-2**62, 2**62, (5,), generator=g, dtype=torch.int64),
        "bool": torch.rand((3, 3), generator=g) > 0.5,
        "scalar": torch.tensor(2.5, dtype=torch.float32),
        "empty": torch.empty((0, 4), dtype=torch.bfloat16),
    }


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_reader_reads_the_package_files(tmp_path):
    """A file the safetensors package wrote, every dtype the reader takes,
    a 0-d and an empty tensor, with metadata: bit-equal."""
    from safetensors.torch import save_file
    want = _sample_tensors()
    path = str(tmp_path / "a.safetensors")
    save_file(want, path, metadata={"format": "pt", "note": "x"})
    _assert_same(dict(sio.iter_file(path)), want)


def test_writer_files_read_in_the_package(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file
    want = _sample_tensors()
    path = str(tmp_path / "b.safetensors")
    sio.save_file(want, path, metadata={"format": "pt"})
    _assert_same(load_file(path), want)
    with safe_open(path, "pt") as f:
        assert f.metadata() == {"format": "pt"}
    _assert_same(dict(sio.iter_file(path)), want)


def test_sharded_writer_and_index_both_ways(tmp_path):
    """save_sharded's shards and index (the JAX package's names) read back
    through the index, by the port and by the package; a sharded checkpoint
    written by transformers reads through its index."""
    from safetensors.torch import load_file
    g = torch.Generator().manual_seed(1)
    want = {f"w{i}": torch.randn((16, 8), generator=g).bfloat16() for i in range(5)}
    wmap = sio.save_sharded(want.items(), str(tmp_path), max_shard_bytes=600)
    files = sorted(set(wmap.values()))
    assert files == [f"model-{i:05d}-of-00003.safetensors" for i in (1, 2, 3)]
    with open(tmp_path / sio.INDEX) as f:
        index = json.load(f)
    assert index["weight_map"] == wmap
    assert index["metadata"]["total_size"] == 5 * 16 * 8 * 2
    _assert_same(dict(sio.iter_safetensors(str(tmp_path))), want)
    from_package = {}
    for name in files:
        from_package.update(load_file(str(tmp_path / name)))
    _assert_same(from_package, want)

    from safetensors.torch import save_file
    hf = tmp_path / "hf"
    hf.mkdir()
    save_file({"a": want["w0"]}, str(hf / "x-1.safetensors"))
    save_file({"b": want["w1"]}, str(hf / "x-2.safetensors"))
    save_file({"c": want["w2"]}, str(hf / "stray.safetensors"))   # not in the index
    with open(hf / sio.INDEX, "w") as f:
        json.dump({"weight_map": {"a": "x-1.safetensors", "b": "x-2.safetensors"}}, f)
    _assert_same(dict(sio.iter_safetensors(str(hf))), {"a": want["w0"], "b": want["w1"]})


def test_reader_needs_no_safetensors_or_ml_dtypes(tmp_path):
    """BF16, F16 and F32 files of the safetensors package read in a process
    where neither `safetensors` nor `ml_dtypes` can be imported."""
    from safetensors.torch import save_file
    want = {k: v for k, v in _sample_tensors().items() if k in ("f32", "f16", "bf16")}
    path = str(tmp_path / "c.safetensors")
    save_file(want, path)
    code = (
        "import sys\n"
        "sys.modules['safetensors'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from socioreasoner_tpu_torch.utils.safetensors_io import iter_file\n"
        f"got = dict(iter_file({path!r}))\n"
        "print({k: [str(v.dtype), v.float().sum().item()] for k, v in got.items()})\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    assert eval(res.stdout) == {k: [str(v.dtype), v.float().sum().item()]
                                for k, v in want.items()}


def test_reader_refuses_a_tensor_past_the_end(tmp_path):
    path = tmp_path / "bad.safetensors"
    header = json.dumps({"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}})
    header += " " * (-len(header) % 8)
    path.write_bytes(len(header).to_bytes(8, "little") + header.encode() + b"\0" * 8)
    with pytest.raises(ValueError, match="does not fit"):
        list(sio.iter_file(str(path)))


# ------------------------------------------------------------ Qwen2.5-VL

@pytest.fixture(scope="module")
def hf_qwen():
    from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import (
        Qwen2_5_VLConfig, Qwen2_5_VLTextConfig, Qwen2_5_VLVisionConfig)
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import (
        Qwen2_5_VLForConditionalGeneration)
    torch.manual_seed(0)
    vis = Qwen2_5_VLVisionConfig(
        depth=4, hidden_size=64, intermediate_size=128, num_heads=4,
        patch_size=14, temporal_patch_size=2, spatial_merge_size=2,
        out_hidden_size=64, window_size=28, fullatt_block_indexes=[1, 3],
        in_channels=3, tokens_per_second=2)
    txt = Qwen2_5_VLTextConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=1024, rope_theta=1000000.0, rms_norm_eps=1e-6,
        rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        tie_word_embeddings=False)
    cfg = Qwen2_5_VLConfig(
        text_config=txt.to_dict(), vision_config=vis.to_dict(),
        image_token_id=VOCAB - 3, video_token_id=VOCAB - 2,
        vision_start_token_id=VOCAB - 4, vision_end_token_id=VOCAB - 1,
        bos_token_id=0, eos_token_id=1, pad_token_id=0, tie_word_embeddings=False)
    return Qwen2_5_VLForConditionalGeneration(cfg).eval()


def save_hf_checkpoint(model, path: str, dtype=torch.float32, layout: str = "new"):
    """An HF checkpoint directory of `model`: config.json and one
    safetensors file in `dtype`, under the transformers>=4.52 names
    ("new": model.language_model.*, model.visual.*) or the legacy ones."""
    from safetensors.torch import save_file
    os.makedirs(path, exist_ok=True)
    model.config.to_json_file(os.path.join(path, "config.json"))
    sd = {}
    for k, v in model.state_dict().items():
        if layout == "legacy":
            k = t_loader._normalize(k)
        sd[k] = v.detach().to(dtype).clone().contiguous()
    save_file(sd, os.path.join(path, "model.safetensors"), metadata={"format": "pt"})
    return path


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _same_tree(port, jax_tree, exact=True):
    """The port's tree equals a JAX tree leaf for leaf (keys of the nest,
    shapes, values; dtype compared by name)."""
    assert sorted(port) == sorted(jax_tree)
    for k in port:
        a, b = port[k], jax_tree[k]
        if isinstance(a, dict):
            _same_tree(a, b, exact)
            continue
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, k
        assert str(a.dtype).split(".")[-1] == str(b.dtype), k
        if exact:
            np.testing.assert_array_equal(_np(a), b.astype(np.float32)
                                          if str(b.dtype) == "bfloat16" else b, err_msg=k)


def _same_port_trees(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_port_trees(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("layout", ["new", "legacy"])
@pytest.mark.parametrize("file_dtype", ["f32", "bf16"])
def test_load_pretrained_matches_jax(hf_qwen, tmp_path, layout, file_dtype):
    """The port's load_pretrained (f32 and bf16 trees) equals JAX's leaf for
    leaf, bit for bit, from one HF directory; the config equals JAX's."""
    path = save_hf_checkpoint(hf_qwen, str(tmp_path / "ckpt"),
                              {"f32": torch.float32, "bf16": torch.bfloat16}[file_dtype],
                              layout)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tconf, tp = t_loader.load_pretrained(path, dtype=tdt, device=CPU)
        jconf, jp = j_loader.load_pretrained(path, dtype=jdt)
        assert tconf == _port(jconf)
        assert tconf.text.hidden_size == 64 and tconf.eos_token_id == 1
        _same_tree(tp, jax.tree.map(np.asarray, jp))
    # the state-dict loader gives the f32 directory's tree
    if file_dtype == "f32":
        _same_port_trees(t_loader.load_from_torch_state_dict(tconf, hf_qwen.state_dict(),
                                                             device=CPU),
                         t_loader.load_pretrained(path, dtype=torch.float32, device=CPU)[1])


def test_loaded_logits_match_jax(hf_qwen, tmp_path):
    """Port forward on its loaded tree against JAX's forward on its tree, a
    prompt with an image: logits within 1e-4 in float32."""
    from PIL import Image
    from socioreasoner_tpu.datasets.processor import ImageProcessorConfig, process_images
    path = save_hf_checkpoint(hf_qwen, str(tmp_path / "ckpt"))
    tconf, tp = t_loader.load_pretrained(path, dtype=torch.float32, device=CPU)
    jconf, jp = j_loader.load_pretrained(path, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    img = process_images([Image.fromarray(rng.integers(0, 255, (56, 84, 3), dtype=np.uint8))],
                         ImageProcessorConfig(min_pixels=56 * 56, max_pixels=56 * 56 * 4))
    n_img = int(np.prod(img["image_grid_thw"][0]) // 4)
    ids = np.array([[3, 4, jconf.vision_start_token_id] + [jconf.image_token_id] * n_img
                    + [5, 6, 7]])
    attn = np.ones_like(ids)
    pos, _ = j_rope.get_rope_index(jconf, ids, img["image_grid_thw"], attn)
    from socioreasoner_tpu.models.qwen2_5_vl import vision as j_vision
    from socioreasoner_tpu_torch.models.qwen2_5_vl import vision as t_vision
    jemb = j_vision.run_vision(jconf.vision, jp["vision"], img["pixel_values"],
                               img["image_grid_thw"])
    temb = t_vision.run_vision(tconf.vision, tp["vision"], img["pixel_values"],
                               img["image_grid_thw"])
    want, _ = j_model.forward(jconf, jp, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(attn),
                              image_embeds=jemb)
    got, _ = t_model.forward(tconf, tp, torch.as_tensor(ids), torch.as_tensor(pos),
                             torch.as_tensor(attn), image_embeds=temb)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def tiny_tree():
    config = Qwen25VLConfig.tiny(VOCAB)
    jp = j_model.init_params(config, jax.random.key(5), dtype=jnp.float32)
    return config, jp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_export_round_trips(tiny_tree, tmp_path, dtype):
    """port save_pretrained → port loader and JAX loader: the same tree
    (bf16 written as BF16); JAX save_pretrained → port loader; config.json
    equal to JAX's config_to_hf_dict; shards under JAX's names."""
    config, jp = tiny_tree
    tconf = _port(config)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out = str(tmp_path / "port")
    wmap = t_export.save_pretrained(tconf, tp, out, max_shard_bytes=64 * 1024)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f) == json.loads(json.dumps(j_export.config_to_hf_dict(config)))
    names = sorted(set(wmap.values()))
    assert len(names) > 1 and names[0] == f"model-00001-of-{len(names):05d}.safetensors"
    with open(os.path.join(out, sio.INDEX)) as f:
        assert json.load(f)["weight_map"] == wmap
    want_dt = "BF16" if dtype == torch.bfloat16 else "F32"
    assert {v["dtype"] for n in names
            for v in sio.read_header(os.path.join(out, n))[0].values()} == {want_dt}
    _, back = t_loader.load_pretrained(out, dtype=dtype, device=CPU)
    _same_port_trees(back, tp)
    jconf2, jback = j_loader.load_pretrained(out, dtype=jdt)
    assert _port(jconf2) == tconf
    _same_tree(back, jax.tree.map(np.asarray, jback))

    jdir = str(tmp_path / "jax")
    j_export.save_pretrained(config, jax.tree.map(lambda a: a.astype(jdt), jp), jdir)
    _, from_jax = t_loader.load_pretrained(jdir, dtype=dtype, device=CPU)
    _same_port_trees(from_jax, tp)
    # HF names and order of the two exports
    assert [n for n, _ in t_export.iter_hf_tensors(tconf, tp)] == \
        [n for n, _ in j_export.iter_hf_tensors(config, jp)]


def test_moe_tree_exports_and_loads_like_jax(tmp_path):
    """The MoE name map (router, experts, q/k norms, no qkv bias): the port's
    export of a JAX-initialised MoE tree loads into the JAX tree again in
    both packages (the port's model raises on MoE layers; its loader maps
    them)."""
    config = Qwen25VLConfig(
        vision=VisionConfig(depth=1, hidden_size=16, intermediate_size=32,
                            num_heads=2, out_hidden_size=32),
        text=TextConfig(vocab_size=128, hidden_size=32, intermediate_size=16,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=8,
                        mrope_section=(2, 1, 1), tie_word_embeddings=False,
                        use_qk_norm=True, n_experts=4, n_experts_per_tok=2,
                        attention_bias=False),
        bos_token_id=0, eos_token_id=1, pad_token_id=0)
    jp = jax.tree.map(np.asarray, j_model.init_params(config, jax.random.key(2), jnp.float32,
                                                      with_vision=False))
    tp = params_from_numpy(jp, CPU)
    path = str(tmp_path / "moe")
    t_export.save_pretrained(_port(config), tp, path)
    back = t_loader.load_params(_port(config), sio.iter_safetensors(path), torch.float32,
                                with_vision=False, device=CPU)
    assert back["layers"]["gate_w"].shape == (2, 4, 32, 16)
    assert torch.count_nonzero(back["layers"]["q_b"]) == 0     # zero biases filled
    jback = j_loader.load_params(config, j_loader.iter_safetensors(path), jnp.float32,
                                 with_vision=False)
    _same_tree(back, jax.tree.map(np.asarray, jback))
    for k in jp["layers"]:
        np.testing.assert_array_equal(back["layers"][k].numpy(), jp["layers"][k], err_msg=k)


def test_missing_layer_tensor_raises(tiny_tree, tmp_path):
    config, jp = tiny_tree
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    named = [(n, t) for n, t in t_export.iter_hf_tensors(_port(config), tp)
             if n != "model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(ValueError, match="up_w"):
        t_loader.load_params(_port(config), iter(named), torch.float32, device=CPU)


# ------------------------------------------------------------------ SAM2

def test_sam2_load_pretrained_matches_jax(tmp_path):
    """A tiny random HF Sam2Model saved to disk: the port's load_pretrained
    equals JAX's leaf for leaf (f32 and bf16), and the state-dict loader's
    tree."""
    from safetensors.torch import save_file
    from transformers.models.sam2.configuration_sam2 import (
        Sam2Config as HFSam2Config, Sam2HieraDetConfig, Sam2VisionConfig,
        Sam2MaskDecoderConfig, Sam2PromptEncoderConfig)
    from transformers.models.sam2.modeling_sam2 import Sam2Model
    torch.manual_seed(0)
    hiera = Sam2HieraDetConfig(
        hidden_size=16, blocks_per_stage=[1, 2, 2, 1], embed_dim_per_stage=[16, 32, 64, 128],
        num_attention_heads_per_stage=[1, 2, 2, 4], window_size_per_stage=[8, 4, 14, 7],
        global_attention_blocks=[4], image_size=[128, 128])
    vision = Sam2VisionConfig(
        backbone_config=hiera, backbone_channel_list=[128, 64, 32, 16],
        backbone_feature_sizes=[[32, 32], [16, 16], [8, 8]], fpn_hidden_size=32)
    model = Sam2Model(HFSam2Config(
        vision_config=vision,
        prompt_encoder_config=Sam2PromptEncoderConfig(hidden_size=32, image_size=128),
        mask_decoder_config=Sam2MaskDecoderConfig(hidden_size=32, mlp_dim=64,
                                                  num_attention_heads=2,
                                                  iou_head_hidden_dim=32))).eval()
    save_file({k: v.detach().clone().contiguous() for k, v in model.state_dict().items()},
              str(tmp_path / "model.safetensors"))
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tconf, tp = t_sam_loader.load_pretrained(str(tmp_path), Sam2Config.tiny_test(),
                                                 dtype=tdt, device=CPU)
        _, jtree = j_sam_loader.load_pretrained(str(tmp_path), JSam2Config.tiny_test(),
                                                dtype=jdt)
        assert tconf == Sam2Config.tiny_test()
        bridged = params_from_numpy(jax.tree.map(np.asarray, jtree), CPU, tdt)

        def walk(a, b, path=()):
            if isinstance(a, dict):
                assert sorted(a) == sorted(b), path
                for k in a:
                    walk(a[k], b[k], path + (k,))
            elif isinstance(a, list):
                assert len(a) == len(b), path
                for i, (x, y) in enumerate(zip(a, b)):
                    walk(x, y, path + (i,))
            else:
                assert a.dtype == b.dtype == tdt and torch.equal(a, b), path
        walk(tp, bridged)
    walk(t_sam_loader.load_from_torch_state_dict(Sam2Config.tiny_test(), model.state_dict(),
                                                 torch.bfloat16, CPU), tp)
