"""The port's model checkpoints and convert CLI: CheckpointManager (save,
restore, keep_last_n, asynchronous writes from host copies, restore onto a
template's dtype), TorchTrainStrategy's save → load → next step against an
uninterrupted run (chip_smoke's round trip at a tiny config, bit for bit on
the CPU), and tools/convert HF → native → HF, including a train checkpoint
and the JAX package's HF files on either side.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.models.qwen2_5_vl import export as j_export
from socioreasoner_tpu.models.qwen2_5_vl import loader as j_loader
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu_torch.models.qwen2_5_vl import export as t_export
from socioreasoner_tpu_torch.models.qwen2_5_vl import loader as t_loader
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.tools.convert import main as convert_main
from socioreasoner_tpu_torch.utils.checkpoint import CheckpointManager, flatten, unflatten

from tests.test_torch_engine import _port

CPU = torch.device("cpu")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((3, 4), generator=g),
                       "blocks": [torch.randn((2,), generator=g).bfloat16(),
                                  torch.arange(5, dtype=torch.int8)]},
            "opt_state": {"count": 7, "mu": [torch.randn((3, 4), generator=g)]},
            "step": 3}


def _equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_flatten_round_trip():
    tree = _tree()
    flat = flatten(tree)
    assert sorted(flat) == ["opt_state/count", "opt_state/mu/0", "params/blocks/0",
                            "params/blocks/1", "params/w", "step"]
    back = unflatten(flat)
    assert isinstance(back["params"]["blocks"], list)
    _equal(back, tree)
    with pytest.raises(ValueError, match="separator"):
        flatten({"a/b": torch.zeros(1)})


def test_manager_save_restore_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2, use_async=False)
    assert mgr.restore() == (None, None) and mgr.latest_step() is None
    for step in (1, 2, 5, 10):
        mgr.save(step, _tree(step), meta={"step": step})
    assert mgr.steps() == [5, 10] and mgr.latest_step() == 10
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_10", "checkpoint_5"]
    assert sorted(os.listdir(tmp_path / "checkpoint_5")) == ["meta.json", "state.pt"]
    tree, meta = mgr.restore()
    assert meta == {"step": 10}
    _equal(tree, _tree(10))
    tree, meta = mgr.restore(5)
    assert meta == {"step": 5}
    _equal(tree, _tree(5))
    # a new manager over the same directory finds them
    assert CheckpointManager(str(tmp_path)).latest_step() == 10


def test_manager_async_writes_host_copies(tmp_path):
    """An asynchronous save copies to the host before it returns: updating
    the tensors in place at once does not reach the checkpoint; wait()
    raises what the writer raised."""
    mgr = CheckpointManager(str(tmp_path), use_async=True)
    tree = _tree()
    want = {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in flatten(tree).items()}
    mgr.save(4, tree, meta={"a": 1})
    tree["params"]["w"].add_(1.0)
    tree["opt_state"]["mu"][0].zero_()
    mgr.wait()
    got, meta = mgr.restore(4)
    assert meta == {"a": 1}
    _equal(got, unflatten(want))
    mgr.save(5, {"x": torch.zeros(2)}, meta={"not json": object()})
    with pytest.raises(TypeError):
        mgr.wait()
    assert mgr.steps() == [4]
    mgr.save(6, _tree(6), wait=True)
    assert mgr.steps() == [4, 6]


def test_manager_restore_like_casts_and_checks(tmp_path):
    """restore(like=...) gives like's structure, dtypes and devices, and
    refuses a template of other keys or shapes."""
    mgr = CheckpointManager(str(tmp_path), use_async=False)
    tree = _tree()
    mgr.save(1, tree)
    like = _tree(9)
    like["params"]["w"] = like["params"]["w"].bfloat16()
    like["opt_state"]["mu"] = (like["opt_state"]["mu"][0].double(),)
    got, _ = mgr.restore(1, like=like)
    assert got["params"]["w"].dtype == torch.bfloat16 and got["params"]["w"].device == CPU
    assert torch.equal(got["params"]["w"], tree["params"]["w"].bfloat16())
    assert isinstance(got["opt_state"]["mu"], tuple)
    assert torch.equal(got["opt_state"]["mu"][0], tree["opt_state"]["mu"][0].double())
    assert got["step"] == 3 and got["opt_state"]["count"] == 7
    with pytest.raises(ValueError, match="missing"):
        mgr.restore(1, like={**like, "extra": torch.zeros(1)})
    like["params"]["w"] = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, like=like)


@pytest.mark.parametrize("steps_before", [2, 3], ids=["applied", "accumulating"])
def test_train_strategy_checkpoint_resumes_bit_equal(tmp_path, steps_before):
    """chip_smoke's round trip on the CPU at a tiny config: a strategy saved
    after 2 steps (the MultiSteps update just applied) or 3 (one micro-batch
    accumulated) and loaded into a fresh one has the same params, moments,
    accumulator and counters, and its next step equals the uninterrupted
    run's bit for bit."""
    import chip_smoke
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
    config = _port(Qwen25VLConfig.tiny())
    params = t_model.init_params(config, torch.Generator().manual_seed(3), device="cpu",
                                 with_vision=False)
    batch = chip_smoke.parity_batch(config, params, CPU, lens=(300, 280, 150, 60), seed=1)
    out = chip_smoke.checkpoint_round_trip(config, params, batch, CPU, str(tmp_path),
                                           steps_before=steps_before)
    assert out["bit_equal"]
    assert out["resumed"] == out["uninterrupted"]
    assert out["resumed"]["actor_train/grad_norm"] > 0
    assert out["optimizer_count"] == steps_before // 2
    assert out["mini_step"] == steps_before % 2


@pytest.fixture(scope="module")
def tiny_hf(tmp_path_factory):
    """A tiny Qwen2.5-VL tree and its HF directory written by the port."""
    config = Qwen25VLConfig.tiny(256)
    jp = j_model.init_params(config, jax.random.key(3), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    path = str(tmp_path_factory.mktemp("hf_in"))
    t_export.save_pretrained(_port(config), tp, path)
    return config, jp, tp, path


def _same(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_convert_hf_native_hf(tiny_hf, tmp_path):
    """HF → native → HF gives the input tensors; --bf16 casts on the way; the
    output reads in the JAX loader; --max_shard_gb shards it."""
    config, jp, tp, hf_in = tiny_hf
    native, hf_out = str(tmp_path / "native"), str(tmp_path / "hf_out")
    convert_main(["--checkpoint_path", hf_in, "--output_path", native, "--device", "cpu",
                  "--step", "7"])
    assert os.listdir(native) == ["checkpoint_7"]
    convert_main(["--checkpoint_path", native, "--output_path", hf_out,
                  "--max_shard_gb", str(100_000 / 1024 ** 3)])
    assert os.path.exists(os.path.join(hf_out, "model.safetensors.index.json"))
    _, back = t_loader.load_pretrained(hf_out, dtype=torch.float32, device=CPU)
    _same(back, tp)
    _, jback = j_loader.load_pretrained(hf_out, dtype=jnp.float32)
    for k, v in flatten(jax.tree.map(np.asarray, jback)).items():
        np.testing.assert_array_equal(flatten(tp)[k].numpy(), v, err_msg=k)

    hf_bf16 = str(tmp_path / "hf_bf16")
    convert_main(["--checkpoint_path", native, "--output_path", hf_bf16, "--bf16"])
    _, b16 = t_loader.load_pretrained(hf_bf16, dtype=torch.bfloat16, device=CPU)
    _same(b16, t_loader.load_pretrained(hf_in, dtype=torch.bfloat16, device=CPU)[1])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        convert_main(["--checkpoint_path", native, "--output_path", hf_bf16, "--bf16",
                      "--fp16"])
    with pytest.raises(SystemExit, match="neither"):
        convert_main(["--checkpoint_path", str(tmp_path), "--output_path", hf_bf16])


def test_convert_jax_hf_through_native(tiny_hf, tmp_path):
    """The JAX package's HF export converts to the port's native format and
    back to an HF directory that the JAX loader reads as its tree."""
    config, jp, tp, _ = tiny_hf
    jdir = str(tmp_path / "jax_hf")
    j_export.save_pretrained(config, jp, jdir)
    native, hf_out = str(tmp_path / "native"), str(tmp_path / "out")
    convert_main(["--checkpoint_path", jdir, "--output_path", native, "--device", "cpu"])
    convert_main(["--checkpoint_path", native, "--output_path", hf_out])
    _, jback = j_loader.load_pretrained(hf_out, dtype=jnp.float32)
    for k, v in flatten(jax.tree.map(np.asarray, jback)).items():
        np.testing.assert_array_equal(np.asarray(flatten(jax.tree.map(np.asarray, jp))[k]), v,
                                      err_msg=k)


def test_convert_train_checkpoint_exports_params_only(tiny_hf, tmp_path):
    """A checkpoint of TorchTrainStrategy.save_checkpoint (params and
    opt_state, no hf_config meta) needs --hf_config and exports its params."""
    from types import SimpleNamespace
    from socioreasoner_tpu_torch.distributed.torch_strategies import TorchTrainStrategy
    config, _, tp, hf_in = tiny_hf
    strat = TorchTrainStrategy()
    strat.initialize(_port(config), unflatten({k: v.clone() for k, v in flatten(tp).items()}),
                     training_args=SimpleNamespace(gradient_accumulation_steps=2),
                     checkpoint_dir=str(tmp_path / "train"))
    strat.save_checkpoint(2, wait=True)
    assert sorted(flatten(CheckpointManager(str(tmp_path / "train")).restore()[0])) == \
        sorted(flatten(strat._checkpoint_tree()))
    hf_out = str(tmp_path / "hf_out")
    with pytest.raises(SystemExit, match="hf_config"):
        convert_main(["--checkpoint_path", str(tmp_path / "train"), "--output_path", hf_out])
    convert_main(["--checkpoint_path", str(tmp_path / "train"), "--output_path", hf_out,
                  "--hf_config", os.path.join(hf_in, "config.json")])
    _, back = t_loader.load_pretrained(hf_out, dtype=torch.float32, device=CPU)
    _same(back, tp)
