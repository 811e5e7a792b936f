"""Both entry scripts of the port against the JAX package's build functions: each
`main()` on the example yaml (overlaid with the world of
tests/test_torch_build.py) against the JAX pipeline built from the same
yaml, at greedy in float32 with a float32 KV cache and the tiny SAM2 on
both sides (`both_f32`): run()'s files byte for byte, as
tests/test_torch_pipeline.py compares them, and a train step's metrics
within rtol 1e-5, atol 1e-6 (tests/test_torch_grpo_pipeline.py).
"""

import json
import os

import numpy as np

from socioreasoner_tpu.pipeline.rlvr import build as j_build
from socioreasoner_tpu_torch.examples import start_rlvr_socioseg_pipeline as train_entry
from socioreasoner_tpu_torch.examples import start_rlvr_socioseg_pipeline_infer as infer_entry

from tests.test_torch_build import _configs, _write_yaml, both_f32, world  # noqa: F401


def _files(directory):
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, directory)] = f.read()
    return out


def test_infer_entry_matches_jax(world, tmp_path, both_f32):
    """The port's infer entry main() on the infer yaml against the JAX
    build function's pipeline run() on the same yaml: the same files (masks,
    renders, stage-1 and stage-2 texts) and iou_acc.txt, byte for byte."""
    directory, name = _write_yaml(world, "infer/rlvr_tpu.yaml", str(tmp_path))
    pipe = infer_entry.main(["--config_path", directory, "--config_name", name,
                             "--device", "cpu"])
    got = _files(pipe.result_dir)
    jpipe = j_build.build_infer_pipeline(_configs(directory, name)[1])
    jpipe.result_dir = str(tmp_path / "jax_result")
    jpipe.run()
    want = _files(jpipe.result_dir)
    assert len(got) == 4 * 6 + 1 and sorted(got) == sorted(want)
    assert got == want
    assert any(v for k, v in got.items() if k.endswith(".txt") and "stage1" in k)


def test_train_entry_matches_jax(world, tmp_path, both_f32):
    """The port's train entry main() for one greedy step against the JAX
    build function's pipeline: the same metric keys, the step's metrics within
    rtol 1e-5, atol 1e-6 (timers and throughputs aside), the tracker's jsonl
    and the pipeline checkpoint written."""
    directory, name = _write_yaml(world, "train/rlvr_tpu.yaml", str(tmp_path),
                                  max_steps=1, save_steps=1, rollout_batch_size=1)
    pipe = train_entry.main(["--config_path", directory, "--config_name", name,
                             "--device", "cpu"])
    jcfg = _configs(directory, name)[1]
    jcfg.output_dir, jcfg.tracker_kwargs = str(tmp_path / "jax_out"), {
        "log_dir": str(tmp_path / "jax_tracker")}
    jpipe = j_build.build_train_pipeline(jcfg)
    jpipe.run()
    (got,), (want,) = pipe.state.log_history, jpipe.state.log_history
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in got if not k.startswith(("time/", "system/"))
           and not np.allclose(got[k], want[k], rtol=1e-5, atol=1e-6)}
    assert not bad, bad
    assert np.isfinite(got["map/actor_train/total_loss"])
    with open(os.path.join(directory, "tracker", "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [0]
    assert os.path.exists(os.path.join(directory, "out", "pipeline", "checkpoint-1",
                                       "state.json"))
