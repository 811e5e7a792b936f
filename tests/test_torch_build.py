"""The port's from-config path against the JAX package's: the yaml loader
(both example yamls, `defaults:` includes, ${...}, unknown keys), the
trackers, the build functions (policy, processor, dataset and both pipelines
from a yaml naming a tiny HF checkpoint with an offline tokenizer and a
SocioSeg directory), build_train_mesh on one GPU, and a CPU rehearsal of
chip_smoke's entry phase. tests/test_torch_entry.py runs the entry scripts
against the JAX pipelines on the same world.

Pipelines are built in float32 with a float32 KV cache on both sides (the
build functions' dtype and the engine's cache dtype are patched) and with a tiny
SAM2 in place of the yaml's SAM2-hiera-large (its loader from disk is held
in tests/test_torch_loaders.py).
"""

import dataclasses
import importlib.util
import os
import time

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from socioreasoner_tpu.configs import loader as j_loader
from socioreasoner_tpu.configs.rlvr_config import SocioSegConfig as JConfig
from socioreasoner_tpu.models.sam2.config import Sam2Config as JSam2Config
from socioreasoner_tpu.pipeline.rlvr import build as j_build
from socioreasoner_tpu.utils import tracking as j_tracking
from socioreasoner_tpu_torch.configs import loader as t_loader
from socioreasoner_tpu_torch.configs.rlvr_config import SocioSegConfig
from socioreasoner_tpu_torch.models.qwen2_5_vl import config as t_config
from socioreasoner_tpu_torch.models.qwen2_5_vl import export as t_export
from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.models.sam2 import model as t_sam
from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
from socioreasoner_tpu_torch.pipeline.rlvr import build as t_build
from socioreasoner_tpu_torch.utils import tracking as t_tracking
from socioreasoner_tpu_torch.utils.checkpoint import flatten

import chip_smoke
from tests.test_torch_engine import _port
from tests.test_torch_pipeline import _tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["examples/infer/rlvr_tpu.yaml", "examples/train/rlvr_tpu.yaml"]
CPU = torch.device("cpu")
IMG = {"min_pixels": 56 * 56, "max_pixels": 56 * 56 * 4}


# ------------------------------------------------------------ yaml loader

@pytest.mark.parametrize("example", EXAMPLES)
def test_load_config_of_the_example_yamls_matches_jax(example):
    path = os.path.join(REPO, example)
    got = t_loader.load_config(SocioSegConfig, path)
    want = j_loader.load_config(JConfig, path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert t_loader.load_yaml(path) == j_loader.load_yaml(path) == yaml.safe_load(open(path))
    assert got.actor_infer.generating_args.max_new_tokens == got.response_length == 2048


def test_defaults_interpolation_overrides_and_unknown_keys(tmp_path):
    """A hydra-style `defaults:` list (an include, then _self_), ${...}
    interpolation and overrides give the JAX loader's config; an unknown
    key raises in both."""
    (tmp_path / "base.yaml").write_text(
        "seed: 7\nprompt_length: 100\nactor_train:\n  training_args:\n"
        "    learning_rate: 2.0e-5\n    weight_decay: 0.5\n")
    (tmp_path / "main.yaml").write_text(
        "defaults:\n  - base\n  - missing_include\n  - _self_\n"
        "prompt_length: 200\nresponse_length: 30\n"
        "actor_train:\n  training_args:\n    weight_decay: 0.25\n"
        "actor_infer:\n  generating_args:\n    max_new_tokens: ${response_length}\n")
    path = str(tmp_path / "main.yaml")
    over = {"seed": 9, "actor_train": {"training_args": {"learning_rate": 3.0e-6}}}
    got = t_loader.load_config(SocioSegConfig, path, over)
    want = j_loader.load_config(JConfig, path, over)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    ta = got.actor_train.training_args
    assert (got.seed, got.prompt_length, ta.learning_rate, ta.weight_decay) == \
        (9, 200, 3.0e-6, 0.25)
    assert got.actor_infer.generating_args.max_new_tokens == 30
    # an unknown key lands in extra_fields where the dataclass has them,
    # and raises where it has none (StrategyArguments)
    (tmp_path / "extra.yaml").write_text("seed: 1\nno_such_knob: 3\n")
    (tmp_path / "bad.yaml").write_text(
        "actor_train:\n  strategy_args:\n    no_such_knob: 3\n")
    for loader, cls in ((t_loader, SocioSegConfig), (j_loader, JConfig)):
        extra = loader.load_config(cls, str(tmp_path / "extra.yaml")).extra_fields
        assert extra == {"no_such_knob": 3}
        with pytest.raises(ValueError, match="no_such_knob"):
            loader.load_config(cls, str(tmp_path / "bad.yaml"))


# --------------------------------------------------------------- trackers

def test_file_tracker_lines_match_jax(tmp_path, monkeypatch):
    """FileTracker's jsonl byte for byte, through create_tracker's file,
    multi and uninstalled-wandb paths; tensorboard writes its events."""
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    records = [({"loss": 0.25, "n": 3, "np": np.float32(1.5), "s": "x"}, 0),
               ({"loss": float("nan"), "grad": np.float64(2.0)}, 1)]
    for kind in ("file", "multi"):
        out = {}
        for name, mod in (("port", t_tracking), ("jax", j_tracking)):
            d = str(tmp_path / kind / name)
            tracker = mod.create_tracker(kind, log_dir=d)
            for values, step in records:
                tracker.log(values, step)
            tracker.close()
            out[name] = (tmp_path / kind / name / "metrics.jsonl").read_bytes()
        assert out["port"] == out["jax"] and out["port"].count(b"\n") == 2
    if importlib.util.find_spec("wandb") is None:
        with pytest.warns(UserWarning, match="not installed"):
            tracker = t_tracking.create_tracker("wandb", log_dir=str(tmp_path / "wb"))
        assert isinstance(tracker, t_tracking.FileTracker)
    pytest.importorskip("tensorboardX")
    tb = t_tracking.create_tracker("tensorboard", log_dir=str(tmp_path / "tb"))
    tb.log({"a": 1.0, "text": "skipped"}, 0)
    tb.log_text("t", "hello", 0)
    tb.close()
    assert any(f.startswith("events.") for f in os.listdir(tmp_path / "tb"))
    with pytest.raises(ValueError, match="unknown tracker"):
        t_tracking.create_tracker("nope")


# ---------------------------------------------------------- build functions

def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """An HF Qwen2.5-VL directory of Qwen25VLConfig.tiny() in f32 (the
    port's save_pretrained of a seeded init; tests/test_torch_loaders.py
    holds the loaders to files that transformers wrote) with an offline
    byte-level tokenizer at its special ids, a SocioSeg directory of 96-px
    tiles (4 test, 2 train), and a seeded tiny SAM2 as a numpy tree."""
    root = tmp_path_factory.mktemp("world")
    config = t_config.Qwen25VLConfig.tiny(512)
    ckpt = str(root / "qwen")
    t_export.save_pretrained(config, t_model.init_params(
        config, torch.Generator().manual_seed(0), device="cpu"), ckpt)
    chip_smoke.write_byte_tokenizer(ckpt, chip_smoke._TINY_SPECIAL, 512)
    data = str(root / "socioseg")
    chip_smoke.write_socioseg_dir(data, 96)
    sam_np = _numpy(t_sam.init_params(Sam2Config.tiny_test(),
                                      torch.Generator().manual_seed(1), device="cpu"))
    for m in sam_np["decoder"]["hyper_mlps"]:
        m["fc_out_w"] = m["fc_out_w"] * 1000.0
    return {"ckpt": ckpt, "data": data, "sam": sam_np, "root": root}


def _write_yaml(world, example, out_dir, **overlay):
    """examples/<example> with the world's paths, the tiny image bounds, a
    short prompt and response, greedy decoding, the JAX engine's exact
    sampler and actor_train on one device, plus `overlay`; returns
    (directory, file name)."""
    os.makedirs(out_dir, exist_ok=True)
    name = example.replace("/", "_")
    chip_smoke.write_entry_yaml(example, os.path.join(out_dir, name), {
        "pretrain": world["ckpt"], "output_dir": os.path.join(out_dir, "out"),
        "logging_dir": os.path.join(out_dir, "logs"),
        "tracker_kwargs": {"log_dir": os.path.join(out_dir, "tracker")},
        "checkpoint_config": {"output_dir": os.path.join(out_dir, "ckpt")},
        "rollout_batch_size": 2, "prompt_length": 640, "response_length": 6,
        # one device: the JAX build function would lay its train mesh over the
        # test run's 8 virtual CPU devices (fsdp_size -1), the port has one GPU
        "actor_train": {"data_args": {"dataset_dir": world["data"]},
                        "model_args": dict(IMG), "device_mapping": "[0]"},
        "actor_infer": {"generating_args": {"temperature": 0.0},
                        "strategy_args": {"strategy_config": {"sampler_exact": True}}},
        "track_with": "file"}, overlay)
    return out_dir, name


@pytest.fixture
def both_f32(monkeypatch, world):
    """Both packages' build functions in float32 with a float32 KV cache, and the
    tiny SAM2 (one tree) for the yaml's SAM2-hiera-large."""
    t_policy, j_policy = t_build.load_policy, j_build.load_policy
    t_kwargs, j_kwargs = t_build.default_engine_kwargs, j_build.default_engine_kwargs
    monkeypatch.setattr(t_build, "load_policy",
                        lambda cfg, dtype=None, device=None: t_policy(cfg, torch.float32, device))
    monkeypatch.setattr(j_build, "load_policy",
                        lambda cfg, dtype=None: j_policy(cfg, jnp.float32))
    monkeypatch.setattr(t_build, "default_engine_kwargs",
                        lambda cfg: {**t_kwargs(cfg), "cache_dtype": torch.float32})
    monkeypatch.setattr(j_build, "default_engine_kwargs",
                        lambda cfg: {**j_kwargs(cfg), "cache_dtype": jnp.float32})
    monkeypatch.setattr(t_build, "load_sam", lambda cfg, dtype=None, device=None: (
        Sam2Config.tiny_test(), params_from_numpy(world["sam"], device)))
    monkeypatch.setattr(j_build, "load_sam", lambda cfg, dtype=None: (
        JSam2Config.tiny_test(), jax.tree.map(jnp.asarray, world["sam"])))


def _configs(directory, name):
    path = os.path.join(directory, name)
    return t_loader.load_config(SocioSegConfig, path), j_loader.load_config(JConfig, path)


def _assert_trees_equal(tree, jtree):
    flat, jflat = flatten(tree), flatten(jax.tree.map(np.asarray, jtree))
    assert sorted(flat) == sorted(jflat)
    for k, v in flat.items():
        want = jflat[k]
        if str(want.dtype) == "bfloat16":
            want = want.astype(np.float32)
        np.testing.assert_array_equal(v.float().numpy(), want, err_msg=k)


def test_build_functions_match_jax(world, tmp_path):
    """load_policy (bf16, from the HF directory), build_processor (the HF
    tokenizer of the directory), load_dataset (both splits) against the JAX
    build functions; without a directory, the flagship config and
    SimpleTokenizer."""
    tcfg, jcfg = _configs(*_write_yaml(world, "train/rlvr_tpu.yaml", str(tmp_path)))
    tconf, tp = t_build.load_policy(tcfg, device="cpu")
    jconf, jp = j_build.load_policy(jcfg)
    assert tconf == _port(jconf)
    _assert_trees_equal(tp, jp)
    assert tp["embed"].dtype == torch.bfloat16
    tproc, jproc = t_build.build_processor(tcfg, tconf), j_build.build_processor(jcfg, jconf)
    assert type(tproc.tokenizer).__name__ == type(jproc.tokenizer).__name__
    for k in ("min_pixels", "max_pixels", "defer_patchify"):
        assert getattr(tproc.image_config, k) == getattr(jproc.image_config, k), k
    text = tproc.apply_chat_template("where are the parks?", 2)
    # the offline tokenizer encodes as the tests' byte tokenizer at the tiny ids
    assert tproc.tokenizer.encode(text) == jproc.tokenizer.encode(text) == \
        _tokenizer(t_build.SimpleTokenizer).encode(text)
    for split, n in (("test", 4), ("train", 2)):
        trows = t_build.load_dataset(tcfg, split, tproc)
        jrows = j_build.load_dataset(jcfg, split, jproc)
        assert len(trows) == len(jrows) == n
        for tr, jr in zip(trows, jrows):
            assert sorted(tr) == sorted(jr)
            for k in tr:           # arrays, strings and PIL images alike
                np.testing.assert_array_equal(np.asarray(tr[k]), np.asarray(jr[k]), err_msg=k)
    tcfg.pretrain = str(tmp_path / "no_such_dir")
    assert isinstance(t_build.build_processor(tcfg, tconf).tokenizer, t_build.SimpleTokenizer)


def test_random_policy_without_a_checkpoint_directory(world, tmp_path, monkeypatch):
    """No `pretrain` directory: a seeded random init at Qwen25VLConfig()'s
    architecture (the JAX package's shapes; other values). Checked on the
    config and the init call, not built at 3B on the CPU."""
    tcfg, _ = _configs(*_write_yaml(world, "infer/rlvr_tpu.yaml", str(tmp_path),
                                    pretrain="/no/such/dir"))
    seen = {}

    def fake_init(config, generator, dtype, device):
        seen.update(config=config, seed=generator.initial_seed(), dtype=dtype, device=device)
        return {"embed": torch.zeros(1)}
    monkeypatch.setattr(t_build.qmodel, "init_params", fake_init)
    config, _ = t_build.load_policy(tcfg, device="cpu")
    assert config == t_build.Qwen25VLConfig() == _port(j_build.Qwen25VLConfig())
    assert seen["seed"] == tcfg.seed == 42 and seen["dtype"] == torch.bfloat16


def test_build_pipelines_match_jax(world, tmp_path, both_f32):
    """build_infer_pipeline and build_train_pipeline from the yamls: the
    same dataset, collated stage-1 prompts and weights as the JAX build functions;
    the train pipeline's reference holds its own copy of the weights."""
    for example, split in (("infer/rlvr_tpu.yaml", "test"), ("train/rlvr_tpu.yaml", "train")):
        tcfg, jcfg = _configs(*_write_yaml(world, example, str(tmp_path / split)))
        if split == "test":
            tpipe = t_build.build_infer_pipeline(tcfg, device="cpu")
            jpipe = j_build.build_infer_pipeline(jcfg)
        else:
            tpipe = t_build.build_train_pipeline(tcfg, device="cpu")
            jpipe = j_build.build_train_pipeline(jcfg)
            _assert_trees_equal(tpipe.actor_train.params, jpipe.actor_train.params)
            _assert_trees_equal(tpipe.reference.params, jpipe.reference.params)
            assert tpipe.reference.params["embed"].untyped_storage().data_ptr() != \
                tpipe.actor_train.params["embed"].untyped_storage().data_ptr()
        assert tpipe.model_config == _port(jpipe.model_config)
        assert [r["id"] for r in tpipe.dataset] == [r["id"] for r in jpipe.dataset]
        tb, jb = tpipe.collator(tpipe.dataset), jpipe.collator(jpipe.dataset)
        assert sorted(tb.batch) == sorted(jb.batch)
        for k in tb.batch:
            np.testing.assert_array_equal(np.asarray(tb.batch[k]), np.asarray(jb.batch[k]),
                                          err_msg=k)
        engine = tpipe.actor_infer.engine
        assert engine.S == tcfg.actor_infer.infer_batch_size
        assert engine.params["layers"]["q_w"].dtype == torch.int8     # the yaml's single copy


@pytest.mark.parametrize("knobs", [
    {"tensor_model_parallel_size": 2}, {"fsdp_size": 2}, {"context_parallel_size": 2},
    {"pipeline_model_parallel_size": 2}, {"dp_size": 2}, {}],
    ids=["tp", "fsdp", "cp", "pp", "dp", "mapping"])
def test_build_train_mesh_on_one_gpu(world, tmp_path, knobs):
    """The example train yaml's knobs (fsdp_size -1) resolve to one device
    and no mesh; a knob above 1, or a device_mapping of four devices,
    raises, naming the multi-GPU queue (validate_config refuses a knob
    above 1 on one device first)."""
    def config(name, **actor_train):
        return _configs(*_write_yaml(world, "train/rlvr_tpu.yaml", str(tmp_path / name),
                                     actor_train=actor_train))[0]
    assert t_build.build_train_mesh(config("ok")) is None
    tcfg = config("four", device_mapping="list(range(0,4))",
                  strategy_args={"strategy_config": knobs})
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        t_build.build_train_mesh(tcfg)
    if knobs and "fsdp_size" not in knobs:
        with pytest.raises(ValueError, match="available devices"):
            t_build.build_train_mesh(config("one", strategy_args={"strategy_config": knobs}))


def test_chip_smoke_entry_phase_on_cpu(tmp_path):
    """chip_smoke's entry phase rehearsed at a tiny config on the CPU: the
    tree exported and read back bit for bit, both entry scripts' main() on
    the example yamls (tiny image bounds and lengths), every read held to
    the export's checksums, the infer files, one train step with its
    tracker file and pipeline checkpoint, and the checkpoint round trip."""
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig
    config = Qwen25VLConfig.tiny(512)
    params = t_model.init_params(config, torch.Generator().manual_seed(0),
                                 dtype=torch.bfloat16, device="cpu")
    export_dir = str(tmp_path / "export")
    stats, sums = chip_smoke.export_main_tree(config, params, export_dir, CPU)
    assert stats["shards"] == ["model.safetensors"] and stats["export_gb"] > 0
    data = str(tmp_path / "socioseg")
    chip_smoke.write_socioseg_dir(data, 96)
    small = {"prompt_length": 640, "response_length": 8,
             "actor_train": {"model_args": dict(IMG)}}
    out = chip_smoke.run_entry_path(export_dir, data, str(tmp_path / "runs"), CPU,
                                    want_sums=sums, infer_overlay=small, train_overlay=small)
    inf, tr = out["infer"], out["train"]
    assert inf["tiles"] == 4 and inf["files_written"] == 4 * 6 + 1
    assert inf["tokenizer"] == "PreTrainedTokenizerFast" and inf["launches"] == {}
    assert tr["samples"] == 16 and tr["tracker_lines"] == 1
    assert tr["train_shapes"] == [(2, 648)] and tr["logprob_shapes"] == [(8, 648)]
    assert tr["cache_slots"] == 24 and set(tr["timers_s"]) >= {"step", "rollout", "logprobs"}
    assert [r["bit_equal"] for r in out["reads"]] == [True] * 3
    trip = chip_smoke.checkpoint_round_trip(
        config, {k: v for k, v in params.items() if k != "vision"},
        chip_smoke.parity_batch(config, params, CPU, lens=(300, 200), seed=2), CPU,
        str(tmp_path / "ckpt"))
    assert trip["bit_equal"] and trip["optimizer_count"] == 1 and trip["mini_step"] == 1
