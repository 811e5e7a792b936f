"""The port's runtime and tooling modules against the JAX package's.

ops/flags, utils/context_managers, utils/profiling, runtime/log_monitor,
utils/checkpoint_manager, utils/native (the port's own copy of the host
library, built at first use: every function bit for bit against the JAX
package's library on seeded inputs) and runtime/resource_manager (the same
layouts and refusals over a device list as the JAX package's over the
test run's 8 virtual CPU devices).
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax

from socioreasoner_tpu.configs.worker_config import (StrategyArguments as JStrategyArguments,
                                                     WorkerConfig as JWorkerConfig)
from socioreasoner_tpu.ops import flags as j_flags
from socioreasoner_tpu.runtime import log_monitor as j_log
from socioreasoner_tpu.runtime.resource_manager import ResourceManager as JResourceManager
from socioreasoner_tpu.utils import checkpoint_manager as j_ckpt
from socioreasoner_tpu.utils import context_managers as j_ctx
from socioreasoner_tpu.utils import native as j_native
from socioreasoner_tpu.utils import profiling as j_prof
from socioreasoner_tpu_torch.configs.worker_config import StrategyArguments, WorkerConfig
from socioreasoner_tpu_torch.ops import flags
from socioreasoner_tpu_torch.runtime import log_monitor
from socioreasoner_tpu_torch.runtime.resource_manager import ResourceManager
from socioreasoner_tpu_torch.utils import checkpoint_manager, context_managers, native, profiling

CPU = torch.device("cpu")


# ------------------------------------------------------------------ flags

@pytest.mark.parametrize("explicit", [None, True, False])
@pytest.mark.parametrize("disabled", [False, True])
def test_use_flash_attention_follows_the_knob(monkeypatch, explicit, disabled):
    """An explicit choice wins in both packages; SOCIO_DISABLE_FLASH=1 turns
    the kernels off in both. Without either, JAX takes its kernels on a TPU
    only and the port its kernels' route everywhere (the wrappers take the
    plain version on a CPU tensor)."""
    if disabled:
        monkeypatch.setenv("SOCIO_DISABLE_FLASH", "1")
    else:
        monkeypatch.delenv("SOCIO_DISABLE_FLASH", raising=False)
    got = flags.use_flash_attention(explicit)
    if explicit is not None or disabled:
        assert got == j_flags.use_flash_attention(explicit)
    else:
        assert got is True and j_flags.use_flash_attention() is j_flags.on_tpu() is False
    assert flags.on_gpu() is torch.cuda.is_available()


def test_disabled_flash_refuses_the_card(monkeypatch):
    """SOCIO_DISABLE_FLASH=1 turns the kernels off for CPU tensors and
    raises for a CUDA device: the port never runs the card's attention
    through its plain version. The engine, the trainer's steps and the ViT
    ask with their tensors' device at every call."""
    import inspect
    import re
    from socioreasoner_tpu_torch.distributed import trainer
    from socioreasoner_tpu_torch.generation import engine
    from socioreasoner_tpu_torch.models.qwen2_5_vl import vision
    monkeypatch.setenv("SOCIO_DISABLE_FLASH", "1")
    for dev in (torch.device("cuda", 0), "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="SOCIO_DISABLE_FLASH=1 would run"):
            flags.use_flash_attention(device=dev)
    assert flags.use_flash_attention(device=CPU) is False
    assert flags.use_flash_attention() is False
    assert flags.use_flash_attention(True, device="cuda") is True
    monkeypatch.delenv("SOCIO_DISABLE_FLASH")
    assert flags.use_flash_attention(device="cuda") is True
    for mod, n in ((engine, 2), (trainer, 2), (vision, 1)):
        calls = re.findall(r"use_flash_attention\(([^)]*)\)", inspect.getsource(mod))
        assert len(calls) == n and all(c.startswith("device=") for c in calls), \
            (mod.__name__, calls)


def test_disabled_flash_decodes_densely(monkeypatch):
    """With SOCIO_DISABLE_FLASH=1 the engine never calls the prefill or
    decode kernels' wrappers (dense attention over the cache, as the JAX
    engine off the TPU) and gives the kernels' route's greedy tokens."""
    from socioreasoner_tpu_torch.generation.engine import DecodeEngine, Request
    from socioreasoner_tpu_torch.generation.sampling import SamplingParams
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
    from socioreasoner_tpu_torch.models.qwen2_5_vl import text as t_text
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import (
        Qwen25VLConfig, TextConfig, VisionConfig)
    config = Qwen25VLConfig(
        vision=VisionConfig(depth=1), text=TextConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=128,
            mrope_section=(16, 24, 24), vocab_size=512))
    params = t_model.init_params(config, torch.Generator().manual_seed(0), device="cpu",
                                 with_vision=False)
    sp = SamplingParams(temperature=0.0, do_sample=False, max_new_tokens=6)
    kw = dict(max_slots=2, max_len=64, decode_chunk=4, prefill_buckets=(16, 32),
              cache_dtype=torch.float32)
    reqs = lambda: [Request(i, list(range(3 + i, 12 + 2 * i)), sp) for i in range(2)]  # noqa: E731
    want = DecodeEngine(config, params, **kw).generate(reqs())

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called under SOCIO_DISABLE_FLASH=1")

    monkeypatch.setenv("SOCIO_DISABLE_FLASH", "1")
    monkeypatch.setattr(t_text, "flash_attention", refuse)
    monkeypatch.setattr(t_text, "paged_decode_attention", refuse)
    got = DecodeEngine(config, params, **kw).generate(reqs())
    assert [o.output_ids for o in got] == [o.output_ids for o in want]


# ------------------------------------------------------- context managers

def test_context_managers_match_jax(tmp_path, monkeypatch):
    """state_timing_manager fills the same keys; without a device memory
    API (here: no CUDA, JAX's CPU devices) the stats are empty on both
    sides; PROFILER_TIMELINE writes the port's Chrome trace; disable_gradients
    turns requires_grad off in the block and back on after it."""
    j_m, t_m = {}, {}
    with j_ctx.state_timing_manager(j_m, "step"):
        pass
    with context_managers.state_timing_manager(t_m, "step"):
        pass
    assert set(t_m) == set(j_m) == {"time/step/total"} and t_m["time/step/total"] >= 0
    assert context_managers.device_memory_stats() == j_ctx.device_memory_stats() == {}
    monkeypatch.setenv("PROFILER_TIMELINE", "1")
    with context_managers.local_profiler("block", str(tmp_path)):
        torch.ones(8).sum()
    trace = json.load(open(tmp_path / "block.json"))
    assert any(ev.get("ph") == "X" for ev in trace["traceEvents"])
    w = torch.ones(3, requires_grad=True)
    b = torch.ones(2)
    with j_ctx.disable_gradients(w), context_managers.disable_gradients({"w": [w]}, b):
        assert not w.requires_grad and not b.requires_grad
    assert w.requires_grad and not b.requires_grad


# --------------------------------------------------------------- profiling

def test_trace_summary_rows_match_jax_rows(tmp_path):
    """The port's rows carry the JAX package's fields, sorted by total time;
    on the CPU (no device plane) every host op is kept, as JAX falls back
    to the host plane; format_op_table prints the same table in both."""
    x = torch.randn(64, 64)
    out = profiling.trace_summary(lambda: x @ x, log_dir=str(tmp_path), top=10)
    assert torch.equal(out["result"], x @ x) and out["wall_s"] > 0
    assert os.path.isfile(os.path.join(out["trace_dir"], "trace.json"))
    rows = out["ops"]
    assert rows and all(set(r) == {"plane", "name", "total_us", "count", "avg_us"} for r in rows)
    assert [r["total_us"] for r in rows] == sorted((r["total_us"] for r in rows), reverse=True)
    assert any("mm" in r["name"] for r in rows) and out["device_us"] == 0
    assert profiling.format_op_table(rows) == j_prof.format_op_table(rows)


def test_parse_trace_device_planes(tmp_path):
    """Kernels, memcpys and memsets form each device's plane; device_only
    keeps only them when there are any; busy_us sums them."""
    events = [{"ph": "X", "cat": "kernel", "name": "k1", "dur": 5.0, "pid": 0},
              {"ph": "X", "cat": "kernel", "name": "k1", "dur": 3.0, "pid": 0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 1.0, "pid": 1},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 20.0, "pid": 77},
              {"ph": "i", "cat": "kernel", "name": "marker", "pid": 0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    dev = profiling.parse_trace(str(path))
    assert dev == [{"plane": "/device:GPU:0", "name": "k1", "total_us": 8.0, "count": 2,
                    "avg_us": 4.0},
                   {"plane": "/device:GPU:1", "name": "Memcpy HtoD", "total_us": 1.0,
                    "count": 1, "avg_us": 1.0}]
    every = profiling.parse_trace(str(path), device_only=False)
    assert every[0]["plane"] == "/host:CPU" and len(every) == 3
    assert profiling.busy_us(every) == 9.0


# ------------------------------------------------------------- log monitor

def test_exception_monitor_matches_jax(tmp_path):
    """The same records, the same stop threshold and the same message; one
    log file a worker."""
    errors = [ValueError("bad row"), KeyError("x")]
    outcomes = []
    for mod in (j_log, log_monitor):
        mon = mod.ExceptionMonitor(stop_threshold=2)
        mon.record("w0", errors[0])
        with pytest.raises(RuntimeError) as e:
            mon.record("w1", errors[1])
        outcomes.append((str(e.value), [(r["worker"], r["error"]) for r in
                                        mon.error_summary()]))
    assert outcomes[0] == outcomes[1]
    logger = log_monitor.setup_worker_logger("actor_0", str(tmp_path), logging.INFO)
    logger.info("hello")
    for h in logger.handlers:
        h.flush()
    assert "hello" in (tmp_path / "actor_0.log").read_text()
    assert log_monitor.setup_worker_logger("actor_0", str(tmp_path)).handlers == logger.handlers


# ------------------------------------------------------ checkpoint manager

def test_download_model_matches_jax(tmp_path, monkeypatch):
    root = tmp_path / "models"
    (root / "Qwen--Qwen2.5-VL-3B").mkdir(parents=True)
    (root / "plain").mkdir()
    for mod in (j_ckpt, checkpoint_manager):
        assert mod.download_model(str(root)) == str(root)
        assert mod.download_model("Qwen/Qwen2.5-VL-3B", [str(root)]) == str(
            root / "Qwen--Qwen2.5-VL-3B")
        monkeypatch.setenv(mod.MODEL_ROOTS_ENV, f"/nowhere:{root}")
        assert mod.download_model("plain") == str(root / "plain")
    msgs = []
    for mod in (j_ckpt, checkpoint_manager):
        with pytest.raises(FileNotFoundError) as e:
            mod.download_model("org/missing", [str(root)])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("keep", [0, 2])
def test_uploader_retention_matches_jax(tmp_path, keep):
    """Five checkpoints uploaded one after another: the same directories and
    files remain in both packages' destinations, and remove_local deletes
    the source."""
    src = tmp_path / "src"
    for step in (1, 2, 10, 3, 20):
        d = src / f"checkpoint-{step}"
        d.mkdir(parents=True)
        (d / "state.txt").write_text(str(step))
    listings = []
    for name, mod in (("jax", j_ckpt), ("port", checkpoint_manager)):
        up = mod.CheckpointUploader(str(tmp_path / name), keep_last_n=keep)
        for step in (1, 2, 10, 3, 20):
            up.upload(str(src / f"checkpoint-{step}"), blocking=True)
        up.wait()
        listings.append(sorted(os.listdir(tmp_path / name)))
    assert listings[0] == listings[1]
    assert len(listings[1]) == (5 if keep == 0 else keep)
    local = tmp_path / "local" / "checkpoint-7"
    local.mkdir(parents=True)
    up = checkpoint_manager.CheckpointUploader(str(tmp_path / "dst"), remove_local=True)
    up.upload(str(local))
    up.wait()
    assert not local.exists() and (tmp_path / "dst" / "checkpoint-7").is_dir()


# ------------------------------------------------------------------ native

def _mask(rng, h=61, w=47):
    m = (rng.random((h, w)) > 0.7).astype(np.uint8)
    m[5:20, 5:25] = 1
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_functions_bit_equal_jax(seed):
    """The port's library is its own build of its own copy of the source,
    and every one of its seven functions gives the JAX package's bits."""
    assert native.available() and j_native.available()
    assert native.LIB_PATH.is_file() and "socioreasoner_tpu_torch" in str(native.LIB_PATH)
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for mode in ("bilinear", "nearest"):
        for shape in ((70, 20), (19, 101)):
            np.testing.assert_array_equal(native.resize_u8(img, shape, mode),
                                          j_native.resize_u8(img, shape, mode))
        np.testing.assert_array_equal(native.resize_u8(img[:, :, 0], (30, 30), mode),
                                      j_native.resize_u8(img[:, :, 0], (30, 30), mode))
    tile = rng.integers(0, 256, (56, 84, 3), dtype=np.uint8)
    mean, std = np.array([0.48, 0.45, 0.40]), np.array([0.27, 0.26, 0.28])
    np.testing.assert_array_equal(native.patchify_normalize(tile, mean, std),
                                  j_native.patchify_normalize(tile, mean, std))
    m = _mask(rng)
    assert native.connected_components_count(m) == j_native.connected_components_count(m)
    for min_area in (0, 10):
        assert native.component_boxes(m, min_area) == j_native.component_boxes(m, min_area)
    for shape in ((4, 7), (7, 4), (5, 5)):
        cost = rng.random(shape)
        cost[0] = cost[1]                  # ties
        for a, b in zip(native.hungarian(cost), j_native.hungarian(cost)):
            np.testing.assert_array_equal(a, b)
    m2 = _mask(rng)
    z = np.zeros_like(m)
    assert native.mask_iou_native(m, m2) == j_native.mask_iou_native(m, m2)
    assert native.mask_iou_native(z, z, 1.0) == j_native.mask_iou_native(z, z, 1.0) == 1.0
    canvas = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    mask = np.zeros((32, 32), np.uint8)
    mask[4:20, 8:30] = 1
    for boxes, mk in (([[2, 2, 40, 50], [10, 30, 63, 63]], mask), ([], None)):
        np.testing.assert_array_equal(
            native.render_overlay(canvas, boxes, mk, box_width=3, alpha=0.3),
            j_native.render_overlay(canvas, boxes, mk, box_width=3, alpha=0.3))


def test_native_callers_match_jax():
    """The reward's Hungarian accuracy and mask IoU and the dataset's
    component count and boxes go through the native library, equal to the
    JAX package's."""
    from PIL import Image
    from socioreasoner_tpu.datasets import socioseg as j_seg
    from socioreasoner_tpu.pipeline.rlvr.rewards import socioseg as j_rew
    from socioreasoner_tpu_torch.datasets import socioseg as t_seg
    from socioreasoner_tpu_torch.pipeline.rlvr.rewards import socioseg as t_rew
    assert t_rew.linear_sum_assignment is native.hungarian
    rng = np.random.default_rng(5)
    m = Image.fromarray(_mask(rng) * 255)
    assert t_seg.count_components(m) == j_seg.count_components(m)
    assert t_seg.extract_gt_bboxes(m) == j_seg.extract_gt_bboxes(m)
    a, b = _mask(rng), _mask(rng)
    assert t_rew.mask_iou(a, b) == j_rew.mask_iou(a, b)


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises, naming g++ (no fallback)."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libbad.so")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not (tmp_path / "libbad.so").exists()


# ------------------------------------------------------- resource manager

CASES = [
    ("none", None, {}),
    ("tp2", "list(range(0,4))", {"tensor_model_parallel_size": 2}),
    ("fsdp", "list(range(4,8))", {}),
    ("dp_tp", None, {"dp_size": 2, "tensor_model_parallel_size": 2}),
    ("cp_pp", None, {"context_parallel_size": 2, "pipeline_model_parallel_size": 2}),
    ("one", [3], {}),
    ("fsdp_req", None, {"fsdp_size": 4, "tensor_model_parallel_size": 2}),
    ("bad_div", "list(range(0,3))", {"tensor_model_parallel_size": 2}),
    ("bad_fsdp", None, {"fsdp_size": 3}),
    ("bad_map", [99], {}),
]


@pytest.mark.parametrize("name,mapping,knobs", CASES, ids=[c[0] for c in CASES])
def test_resource_manager_matches_jax(name, mapping, knobs):
    """allocate_mesh over 8 devices: the same axis sizes (or None), the same
    devices by index, the same refusals; colocated alike."""
    j_rm = JResourceManager(jax.devices()[:8])
    devs = [torch.device("cpu")] * 8
    t_rm = ResourceManager(devs)
    j_cfg = JWorkerConfig(device_mapping=mapping,
                          strategy_args=JStrategyArguments(strategy_config=dict(knobs)))
    t_cfg = WorkerConfig(device_mapping=mapping,
                         strategy_args=StrategyArguments(strategy_config=dict(knobs)))
    try:
        j_mesh = j_rm.allocate_mesh(name, j_cfg)
    except ValueError as e:
        with pytest.raises(ValueError) as t_e:
            t_rm.allocate_mesh(name, t_cfg)
        assert str(t_e.value) == str(e)
        return
    t_mesh = t_rm.allocate_mesh(name, t_cfg)
    if j_mesh is None:
        assert t_mesh is None
    else:
        assert t_mesh.shape == dict(j_mesh.shape)
        assert t_mesh.devices.shape == np.array(j_mesh.devices).shape
    assert len(t_rm.role_devices[name]) == len(j_rm.role_devices[name])


def test_resource_manager_colocation_matches_jax():
    j_rm, t_rm = JResourceManager(jax.devices()[:8]), ResourceManager(
        [torch.device("cpu", i) for i in range(8)])
    roles = {"a": "list(range(0,4))", "b": "list(range(4,8))", "c": [1, 2]}
    for rm, wc in ((j_rm, JWorkerConfig), (t_rm, WorkerConfig)):
        for role, mapping in roles.items():
            rm.allocate_mesh(role, wc(device_mapping=mapping))
    for a, b in (("a", "b"), ("a", "c"), ("b", "c")):
        assert t_rm.colocated(a, b) == j_rm.colocated(a, b)
    assert ResourceManager([CPU, CPU]).num_devices == 2
