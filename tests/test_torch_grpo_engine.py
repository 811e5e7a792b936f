"""The port's SocioSegPipeline through the real tiny engines against the
JAX package's, and its entry points around the step loop.

The tiny pipelines of tests/test_torch_grpo_pipeline.py, greedy: with the
request-level rollout (generate_opt_level 1) and the batch one (0), the
same texts, masks and sequences each step as the JAX pipeline, the same
metric keys, finite losses. Sampled rollouts cannot be compared: the port's
torch.Generator and JAX's keys draw different tokens. Then the pipeline's
checkpoint resume, the yaml's reward worker_cls against the inline reward,
and a CPU rehearsal of chip_smoke's grpo phase.
"""

import os

import numpy as np
import pytest
import torch

from socioreasoner_tpu_torch.datasets import processor as t_processor
from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from tests.test_torch_engine import _port
from tests.test_torch_grpo_pipeline import (IMG, VOCAB, YAML_WORKER, _assert_rollouts_equal,
                                            _build, _capture, _leaves, _run_pair)
from tests.test_torch_pipeline import _tokenizer


@pytest.mark.parametrize("opt_level", [1, 0], ids=["request_level", "batch"])
def test_greedy_engine_pipeline_matches_jax(tmp_path, opt_level):
    """Two steps through the real engines at greedy: the same rollouts
    (texts, masks, sequences) as the JAX pipeline, the same metric keys,
    finite losses on both stages."""
    out = _run_pair(tmp_path, scripted=False, greedy=True, opt_level=opt_level,
                    overlap=False)
    (jpipe, jseen, jm), (tpipe, tseen, tm) = out["jax"], out["port"]
    assert len(tseen["rollouts"]) == len(jseen["rollouts"]) == 2
    for got, want in zip(tseen["rollouts"], jseen["rollouts"]):
        _assert_rollouts_equal(got, want)
    assert any(tseen["rollouts"][0]["map_texts"])
    assert set(tm) == set(jm)
    for stage in ("map", "sat"):
        assert np.isfinite(tm[f"{stage}/actor_train/total_loss"])
    engine = tpipe.actor_infer.engine
    # the n samples of a prompt fork its prefill, through the server and in
    # a batch generate alike
    assert engine.steps_executed > 0 and engine.forked_requests > 0


def test_checkpoint_resume(tmp_path):
    """save_steps 1: checkpoint-1 is written; a pipeline built with
    resume_from_checkpoint starts at step 1, with the metric log re-logged,
    and runs only the remaining step."""
    first = _build("port", str(tmp_path), max_steps=1, save_steps=1, resume=True)
    assert first.state.step == 0
    first.run()
    assert first.state.step == 1
    ckpt = tmp_path / "pipeline" / "checkpoint-1"
    assert sorted(os.listdir(ckpt)) == ["rng_state.npy", "state.json"]
    second = _build("port", str(tmp_path), max_steps=2, save_steps=1, resume=True)
    assert second.state.step == 1
    assert second.state.log_history == first.state.log_history
    seen = _capture(second)
    second.run()
    assert second.state.step == 2 and len(seen["rollouts"]) == 1
    assert len(second.state.log_history) == 2
    assert os.path.isdir(tmp_path / "pipeline" / "checkpoint-2")


def test_reward_worker_cls_matches_inline(tmp_path):
    """The yaml's worker_cls (the JAX package's dotted path, resolved by
    class name) scores a step as the inline reward does: the same reward
    arrays and means; a worker_cls that is not ported raises."""
    seen = {}
    for name, worker_cls in (("inline", None), ("yaml", YAML_WORKER)):
        pipe = _build("port", str(tmp_path / name), max_steps=1, worker_cls=worker_cls)
        assert (pipe.reward_worker is None) == (worker_cls is None)
        seen[name] = (_capture(pipe), pipe.run())
    (inline, im), (yaml, ym) = seen["inline"], seen["yaml"]
    got, want = yaml["rewards"][0], inline["rewards"][0]
    assert sorted(got) == sorted(k for k in want if not k.startswith("components/"))
    for k in got:
        if k != "metrics":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["metrics"] == want["metrics"]
    assert {k: v for k, v in ym.items() if k.startswith("critic/")} == \
        {k: v for k, v in im.items() if k.startswith("critic/")}
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        _build("port", str(tmp_path / "other"), worker_cls="my.rewards.MathRuleRewardWorker")


# ------------------------------------------------------- chip_smoke's grpo phase

def test_chip_smoke_grpo_path_on_cpu(tmp_path):
    """chip_smoke's grpo phase (the yaml's settings: n = 8, int8 single-copy
    rollout weights, prefix fork, generate_opt_level 1, backward_batch_size 8
    over 4 accumulation steps, the reward worker_cls), rehearsed at a tiny
    config on CPU tensors with SAM2 in bf16: pass 1 through the real engine
    with validation, pass 2 through crafted answers."""
    import chip_smoke
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
    from socioreasoner_tpu_torch.models.sam2 import model as t_sam
    config = _port(Qwen25VLConfig.tiny(VOCAB))
    params = t_model.init_params(config, torch.Generator().manual_seed(0), device="cpu")
    before = {n: t.clone() for n, t in _leaves(params)}
    sam_config = Sam2Config.tiny_test()
    sam_params = t_sam.init_params(sam_config, torch.Generator().manual_seed(1),
                                   dtype=torch.bfloat16, device="cpu")
    img_cfg = t_processor.ImageProcessorConfig(defer_patchify=True, **IMG)
    processor = t_processor.SocioProcessor(_tokenizer(t_processor.SimpleTokenizer), img_cfg,
                                           image_token_id=config.image_token_id)
    stats = chip_smoke.run_grpo_path(config, params, sam_config, sam_params, str(tmp_path),
                                     torch.device("cpu"), tile_px=96, img_cfg=img_cfg,
                                     processor=processor, prompt_length=640,
                                     response_length=8)
    p1, p2 = stats["pass1"], stats["pass2"]
    assert stats["samples_per_step"] == 16 and p1["steps"] == 2
    assert p1["cache_slots"] == 24 and p1["launches"] == {} == p2["launches"]
    assert p1["train_shapes"] == [(2, 648)] and p1["logprob_shapes"] == [(8, 648)]
    assert p1["forked_requests"] > 0 and p1["engine_steps"] > 0
    assert {"val_iou/mean"} <= set(p1["metrics"]) and len(p1["train_s_per_stage"]) == 4
    assert all(r["s1"][1] <= 8 and r["s2"][1] <= 8 for r in p1["response_lens"])
    assert p2["recomputed_equal"] and p2["reference_logprobs_unchanged"]
    assert min(p2["grad_norm"]) > 0 and p2["actor_logprob_max_abs_move"] > 0
    assert max(p2["rewards"]["map_response_level_rewards"]) > 0
    moved = [n for n, t in _leaves(params) if not torch.equal(t, before[n])]
    assert "embed" in moved                     # the policy trained in place
