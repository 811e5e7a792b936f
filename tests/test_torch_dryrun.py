"""The port's dry runs (socioreasoner_tpu_torch/tools/dryrun.py) on the CPU,
and chip_smoke's seq_pipe phase rehearsed at a tiny config.

  * dryrun_multichip over 8 cpu entries: the meshed train step, the MoE
    plane, cp ring and Ulysses (within 1e-3 of each other), pp GPipe, the
    tp decode engine's prefix fork, the SocioSegPipeline step over the mesh
    with two decode replicas;
  * dryrun_multiprocess(2): two gloo processes of the module's worker over
    a global dp 2 x fsdp 2 x tp 2 mesh (started once for the file);
  * entry() at a tiny config, and its refusal to pick the CPU by itself;
  * seq_pipe's (a)-(c) on cpu entries in float32 ((d) is this file's first
    two tests, which call what the phase calls).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from socioreasoner_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu_torch.tools import dryrun

CPU = torch.device("cpu")


def test_dryrun_multichip_on_cpu():
    out = dryrun.dryrun_multichip(8, [CPU] * 8)
    assert out["mesh"] == {"dp": 2, "fsdp": 2, "pp": 1, "sp": 1, "tp": 2}
    for k in ("loss", "moe_loss", "cp_loss", "ulysses_loss", "pp_loss",
              "socioseg_pipeline_loss"):
        assert np.isfinite(out[k]), k
    assert abs(out["cp_loss"] - out["ulysses_loss"]) < 1e-3
    assert out["tp_decode_forks"] >= 1
    with pytest.raises(ValueError, match="need 8 devices, have 2"):
        dryrun.dryrun_multichip(8, [CPU] * 2)


@pytest.fixture(scope="module")
def processes():
    return dryrun.dryrun_multiprocess(2, device="cpu", timeout=240)


def test_dryrun_multiprocess_on_cpu(processes):
    """Both processes join over gloo, hold their dp row of the global mesh,
    and end the train step with the same loss, bit for bit; each serves its
    own decode replica."""
    w0, w1 = processes
    assert w0["rank"] == 0 and w1["rank"] == 1
    assert w0["backend"] == w1["backend"] == "gloo"
    assert w0["loss_repr"] == w1["loss_repr"] and w1["loss_of_rank0"] == w0["loss"]
    assert w0["mesh"] == {"dp": 2, "fsdp": 2, "pp": 1, "sp": 1, "tp": 2}
    for w in processes:
        assert w["log_probs_finite"] and w["log_probs_shape"] == [4, 31]
        assert min(w["decoded"]) >= 1


def test_entry_and_config():
    """entry() builds the flagship forward (here at a tiny config) on the
    named device; without a device and a card it refuses; the dry runs'
    config on the card takes widths the kernels run."""
    fn, args = dryrun.entry("cpu", Qwen25VLConfig.tiny())
    logits = fn(*args)
    assert logits.shape == (1, 256, 512) and torch.isfinite(logits.float()).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            dryrun.entry()
    config, dtype = dryrun.dryrun_config(torch.device("cuda"))
    assert dtype == torch.bfloat16 and config.text.head_dim == 128
    assert config.vision.hidden_size // config.vision.num_heads == 80
    assert sum(config.text.mrope_section) == config.text.head_dim // 2


def test_chip_smoke_seq_pipe_phase_on_cpu(tmp_path):
    """chip_smoke's seq_pipe phase at Qwen25VLConfig.tiny(512) widths in
    float32 on cpu entries: (a)-(b) the strategies unsharded and under
    SEQ_PIPE_RUNS within the phase's limits, kernels 4-6 (their plain
    versions) counted by shape, none in the ring; the ring against kernel
    4's plain version on the same rows; (c) the pipeline step with the
    yaml's context_parallel_size 2 over two devices against one device
    (2 layers), the reference's launches at its log-prob chunk."""
    from socioreasoner_tpu_torch.datasets import processor as t_processor
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
    from socioreasoner_tpu_torch.models.sam2 import model as t_sam
    from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
    from tests.test_torch_pipeline import _tokenizer
    lens = (40, 33, 37, 36)
    config = chip_smoke.train_mesh_config(4, Qwen25VLConfig.tiny(512))
    params = chip_smoke.train_mesh_params(config, CPU, torch.float32)
    batch = chip_smoke.train_mesh_batch(config, params, CPU, lens=lens, L=48)
    res = chip_smoke.run_mesh_strategies(config, params, CPU, chip_smoke.seq_pipe_runs(CPU),
                                         batch, lr=1e-3, vp_mesh=None)
    assert chip_smoke.check_mesh_strategies(res) == []
    assert chip_smoke.check_ring_against_ulysses(res) == []
    # 2 steps x 4 layers x (2 forwards under remat, dq, dk/dv): Ulysses on
    # each of sp 2, GPipe on each of 2 micro-batches; the ring none
    for name in ("cp2_ulysses", "pp2", "pp2_vpp2"):
        assert res[name]["train_launches"]["launches"] == 2 * 4 * 2 * 4, name
        assert res[name]["logprob_launches"]["launches"] == 2 * 4 * 2, name
    assert res["cp2_ring"]["train_launches"]["launches"] == 0
    for name in chip_smoke.SEQ_PIPE_RUNS:
        assert res[name]["diffs"]["lp0_log_probs_max_abs"] < 1e-5, name
    ring = chip_smoke.ring_against_kernel(CPU, lens=lens, L=48, H=4, Hkv=2, D=16, timed=False)
    assert ring["ring_max_abs_diff_from_kernel4"] < 1e-5

    small = chip_smoke.train_mesh_config(2, Qwen25VLConfig.tiny(512))
    img_cfg = t_processor.ImageProcessorConfig(defer_patchify=True, min_pixels=56 * 56,
                                               max_pixels=56 * 56 * 4)
    processor = t_processor.SocioProcessor(_tokenizer(t_processor.SimpleTokenizer), img_cfg,
                                           image_token_id=small.image_token_id)
    sam_config = Sam2Config.tiny_test()
    sam_params = t_sam.init_params(sam_config, torch.Generator().manual_seed(1), device="cpu")
    full = t_model.init_params(small, torch.Generator().manual_seed(3), device="cpu")
    pipes = {name: chip_smoke.run_mesh_pipeline(
        small, chip_smoke._clone(full), sam_config, sam_params, str(tmp_path / name), CPU,
        devices, tile_px=96, img_cfg=img_cfg, processor=processor, prompt_length=640,
        response_length=8, knobs=chip_smoke.SEQ_PIPE_YAML_KNOBS if name == "cp2" else None)
        for name, devices in (("unsharded", [CPU]), ("cp2", [CPU] * 2))}
    assert pipes["cp2"]["mesh"] == {"dp": 1, "fsdp": 1, "pp": 1, "sp": 2, "tp": 1}
    assert all(p["rollout_equal_quantized_gather"] for p in pipes.values())
    # actor_train's ring launches nothing; the reference runs sp row 0
    assert {s[0] for s in pipes["cp2"]["kernel_shapes"]} == {8}
    for k, v in pipes["unsharded"]["metrics"].items():
        np.testing.assert_allclose(pipes["cp2"]["metrics"][k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
