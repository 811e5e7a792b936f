"""The host side of the port's GRPO pipeline against the JAX package's: the
SocioSeg rule rewards (exactly equal, on crafted answers, on a seeded batch
and on hypothesis-drawn box lists), the reward worker, the KL controllers,
WorkerState's save/load round trip with the host RNG, and
GenerateScheduler's request-level rollout through the tiny engines at
greedy (the same output matrix).

The pipeline itself is held against the JAX pipeline in
tests/test_torch_grpo_pipeline.py.
"""

import json
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from socioreasoner_tpu.distributed import jax_strategies as JS
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.pipeline import base_worker as j_worker
from socioreasoner_tpu.pipeline.rlvr.rewards import socioseg as j_rewards
from socioreasoner_tpu.protocol import BatchProto as JBatchProto
from socioreasoner_tpu.runtime import generate_scheduler as j_sched
from socioreasoner_tpu.utils import kl_controller as j_kl
from socioreasoner_tpu.utils import worker_state as j_state
from socioreasoner_tpu_torch.configs.worker_config import WorkerConfig
from socioreasoner_tpu_torch.distributed import torch_strategies as TS
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.pipeline import base_worker as t_worker
from socioreasoner_tpu_torch.pipeline.rlvr.rewards import socioseg as t_rewards
from socioreasoner_tpu_torch.protocol import BatchProto as TBatchProto
from socioreasoner_tpu_torch.runtime import generate_scheduler as t_sched
from socioreasoner_tpu_torch.utils import kl_controller as t_kl
from socioreasoner_tpu_torch.utils import worker_state as t_state
from tests.test_torch_engine import _port

GT = '[{"bbox_2d": [100, 100, 300, 300]}, {"bbox_2d": [400, 50, 600, 250]}]'


def _answer(items, think=True):
    return (("<think>t</think>" if think else "") + "<answer>" + json.dumps(items)
            + "</answer>")


def _s2(boxes, points):
    return [{"bbox_2d": b, "points": p} for b, p in zip(boxes, points)]


_MASK = np.zeros((64, 64), np.uint8)
_MASK[10:40, 5:30] = 1
_EMPTY = np.zeros((64, 64), np.uint8)
_SHIFTED = np.roll(_MASK, (7, 9), axis=(0, 1))
S1_BOXES = [[100, 100, 300, 300], [400, 50, 600, 250]]

# (stage-1 answer, stage-2 answer, stage-1 bbox text, gt bbox text, map mask,
# sat mask, gt mask)
CASES = {
    "well_formed": (_answer([{"bbox_2d": b} for b in S1_BOXES]),
                    _answer(_s2(S1_BOXES, [[[150, 150], [200, 250]], [[500, 100]]])),
                    json.dumps([{"bbox_2d": b} for b in S1_BOXES]), GT, _MASK, _MASK,
                    _MASK * 255),
    "points_on_box_edge": (_answer([{"bbox_2d": [103, 98, 302, 299]}]),
                           _answer(_s2(S1_BOXES, [[[100, 150]], [[500, 250]]])),
                           json.dumps([{"bbox_2d": b} for b in S1_BOXES]), GT, _MASK,
                           _SHIFTED, _MASK),
    "bad_json": ('<think>x</think><answer>[{"bbox_2d": [1, 2</answer>',
                 '<think>x</think><answer>[{"bbox_2d": [1, 2, 3, 4], "points": [[</answer>',
                 "[]", GT, _EMPTY, _MASK, _MASK),
    "extra_keys": (_answer([{"bbox_2d": S1_BOXES[0], "label": "park"},
                            {"bbox_2d": [1, 2, 3]}]),
                   _answer([{"bbox_2d": S1_BOXES[0], "points": [[150, 150]], "x": 1},
                            {"points": [[1, 2]]}]),
                   json.dumps([{"bbox_2d": b} for b in S1_BOXES]), GT, _MASK, _MASK, _MASK),
    "counts_differ_from_stage1": (_answer([{"bbox_2d": S1_BOXES[1]}]),
                                  _answer(_s2(S1_BOXES[:1], [[[150, 150], [160, 170]]])),
                                  json.dumps([{"bbox_2d": b} for b in S1_BOXES]), GT,
                                  _MASK, _MASK, _MASK),
    "over_120_objects": (_answer([{"bbox_2d": [i, i, i + 200, i + 200]} for i in range(130)]),
                         _answer(_s2([[i, i, i + 9, i + 9] for i in range(125)],
                                     [[[i + 4, i + 4]] * 3 for i in range(125)])),
                         json.dumps([{"bbox_2d": [i, i, i + 9, i + 9]} for i in range(125)]),
                         json.dumps([{"bbox_2d": [i, i, i + 210, i + 190]}
                                     for i in range(0, 260, 2)]), _MASK, _MASK, _MASK),
    "gt_empty_list": (_answer([{"bbox_2d": S1_BOXES[0]}]), _answer([]), "[]", "[]",
                      _MASK, _EMPTY, _EMPTY),
    "gt_single_quotes": (_answer([{"bbox_2d": [101, 99, 299, 301]}], think=False),
                         "<think>a</think>\n<answer>[]</answer><|im_end|>", "[]",
                         "[{'bbox_2d': [100, 100, 300, 300]}]", _MASK, _MASK, _MASK),
    "empty_masks": (_answer([]), "no answer tags at all", "[]", GT, _EMPTY, _EMPTY, _EMPTY),
}


def _components(mod, case):
    m1, s2, s1_boxes, gt, map_mask, sat_mask, gt_mask = case
    return np.array([
        mod.s1_format_reward(m1), mod.s1_length_reward(m1, gt),
        mod.s1_accuracy_reward(m1, gt), mod.s2_format_reward(s2, s1_boxes),
        mod.s2_length_reward(s2), mod.s2_accuracy_reward(sat_mask, gt_mask),
        mod.s2_accuracy_reward(map_mask, gt_mask)], np.float64)


def _rewards(mod, cases):
    m1, s2, s1_boxes, gt, map_masks, sat_masks, gt_masks = zip(*cases)
    return mod.compute_socioseg_rewards(
        map_responses=list(m1), sat_responses=list(s2), map_masks=list(map_masks),
        sat_masks=list(sat_masks), gt_masks=list(gt_masks), gt_bbox_texts=list(gt),
        stage1_bbox_texts=list(s1_boxes))


def _assert_rewards_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k == "metrics":
            assert got[k] == w
        else:
            assert got[k].dtype == w.dtype == np.float32
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reward_components_match_jax(case):
    """Each rule reward of a crafted answer pair, exactly, and the batch
    reward of the one case."""
    assert t_rewards.MAX_OBJECTS == j_rewards.MAX_OBJECTS == 120
    np.testing.assert_array_equal(_components(t_rewards, CASES[case]),
                                  _components(j_rewards, CASES[case]))
    _assert_rewards_equal(_rewards(t_rewards, [CASES[case]]),
                          _rewards(j_rewards, [CASES[case]]))


def test_crafted_rewards_cover_the_edges():
    """The crafted cases reach what they are named for."""
    got = {name: _components(t_rewards, case) for name, case in CASES.items()}
    assert got["well_formed"][3] == 2.0 and got["points_on_box_edge"][3] == 1.0
    assert got["counts_differ_from_stage1"][3] == 1.0 and got["bad_json"][3] == 1.0
    assert got["over_120_objects"][2] > 0 and got["gt_empty_list"][1] == 0.0
    assert got["gt_single_quotes"][2] == 1.0 and got["empty_masks"][5] == 0.0
    assert 0 < got["well_formed"][5] == 1.0 and 0 < got["points_on_box_edge"][5] < 1


def _seeded_cases(seed, n=32):
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n):
        k = int(rng.integers(0, 5))
        boxes = [sorted(rng.integers(0, 700, 2).tolist()) for _ in range(2 * k)]
        boxes = [[a[0], b[0], a[1] + 1, b[1] + 1] for a, b in zip(boxes[::2], boxes[1::2])]
        pts = [[[int(rng.integers(b[0], b[2] + 1)), int(rng.integers(b[1], b[3] + 1))]
                for _ in range(int(rng.integers(0, 4)))] for b in boxes]
        gt = [[int(x) for x in rng.integers(0, 350, 2)] for _ in range(int(rng.integers(0, 4)))]
        gt = [[x, y, x + int(rng.integers(5, 300)), y + int(rng.integers(5, 300))]
              for x, y in gt]
        s1 = [b if rng.random() < 0.7 else [b[0] + 3, b[1], b[2] + 4, b[3]] for b in boxes]
        masks = [(rng.random((48, 48)) < t).astype(np.uint8) for t in rng.random(3)]
        cases.append((_answer([{"bbox_2d": b} for b in boxes], think=bool(rng.random() < 0.8)),
                      _answer(_s2(s1, pts)), json.dumps([{"bbox_2d": b} for b in boxes]),
                      json.dumps([{"bbox_2d": b} for b in gt]), *masks))
    return cases


def test_seeded_batch_rewards_match_jax():
    cases = _seeded_cases(0)
    got, want = _rewards(t_rewards, cases), _rewards(j_rewards, cases)
    _assert_rewards_equal(got, want)
    assert len(set(got["map_response_level_rewards"].tolist())) > 8


_BOX = st.tuples(st.integers(0, 760), st.integers(0, 760), st.integers(1, 400),
                 st.integers(1, 400)).map(lambda t: [t[0], t[1], t[0] + t[2], t[1] + t[3]])


@settings(max_examples=60, deadline=None)
@given(pred=st.lists(_BOX, max_size=8), gt=st.lists(_BOX, max_size=8))
def test_box_rewards_match_jax_on_drawn_boxes(pred, gt):
    """Stage-1 format, length and Hungarian accuracy of drawn box lists."""
    text, gt_text = _answer([{"bbox_2d": b} for b in pred]), json.dumps(
        [{"bbox_2d": b} for b in gt])
    for fn in ("s1_length_reward", "s1_accuracy_reward"):
        assert getattr(t_rewards, fn)(text, gt_text) == getattr(j_rewards, fn)(text, gt_text)
    assert t_rewards.s1_format_reward(text) == j_rewards.s1_format_reward(text)
    pairs = [(np.array(pred, float).reshape(-1, 4), np.array(gt, float).reshape(-1, 4))]
    for a, b in pairs:
        if len(a) and len(b):
            np.testing.assert_array_equal(t_rewards.batch_iou(a, b), j_rewards.batch_iou(a, b))
            np.testing.assert_array_equal(t_rewards.batch_l1(a, b), j_rewards.batch_l1(a, b))


def test_reward_worker_matches_jax():
    """compute_rewards_split: the same tensors and metrics as the JAX
    worker's, the JAX one called without its cluster runtime."""
    cases = _seeded_cases(1, n=12)
    m1, s2, s1_boxes, gt, map_masks, sat_masks, gt_masks = zip(*cases)
    columns = {"map_response_text": list(m1), "sat_response_text": list(s2),
               "map_mask": list(map_masks), "sat_mask": list(sat_masks),
               "gt_mask": [m * 255 for m in gt_masks], "gt_bbox": list(gt),
               "bboxs_text": list(s1_boxes)}
    got = t_worker.SocioSegRuleRewardWorker(WorkerConfig()).compute_rewards_split(
        TBatchProto.from_dict(non_tensors=columns))
    # the JAX worker's method is a plain function under its dispatch marker
    want = j_worker.SocioSegRuleRewardWorker.compute_rewards_split(
        object.__new__(j_worker.SocioSegRuleRewardWorker),
        JBatchProto.from_dict(non_tensors=columns))
    assert sorted(got.batch) == sorted(want.batch)
    for k in want.batch:
        np.testing.assert_array_equal(got.batch[k], want.batch[k], err_msg=k)
    assert got.meta["metrics"] == want.meta["metrics"]


# ------------------------------------------------------- KL and worker state

@pytest.mark.parametrize("args", [(0.2, None, 10000), (0.2, 0.0, 10000), (0.1, 0.05, 500),
                                  (0.0, 1.0, 10)], ids=["fixed", "target0", "adaptive",
                                                        "adaptive_zero"])
def test_kl_controller_matches_jax(args):
    got, want = t_kl.get_kl_controller(*args), j_kl.get_kl_controller(*args)
    assert type(got).__name__ == type(want).__name__
    for current, n in ((0.01, 16), (0.3, 16), (0.06, 4), (2.0, 128)):
        got.update(current, n)
        want.update(current, n)
        assert got.value == want.value


def test_worker_state_round_trip_matches_jax(tmp_path):
    """save → state.json equal to the JAX package's; load in either package
    restores the step, the log and the host RNG (the same draws after)."""
    history = [{"step": 0, "critic/kl": 0.25, "time/step": 1.5},
               {"step": 1, "val_iou/mean": np.float64(0.5)}]
    out = {}
    for name, mod in (("port", t_state), ("jax", j_state)):
        random.seed(3)
        np.random.seed(3)
        random.random(), np.random.random(5)
        mod.WorkerState(step=2, log_history=[dict(h) for h in history]).save(
            str(tmp_path / name))
        out[name] = (random.random(), np.random.random(4).tolist())
        random.seed(99), np.random.seed(99)
    assert out["port"] == out["jax"]
    files = [(tmp_path / n / "state.json").read_text() for n in ("port", "jax")]
    assert files[0] == files[1]
    for load_mod, saved_by in ((t_state, "jax"), (t_state, "port"), (j_state, "port")):
        random.seed(99), np.random.seed(99)
        state = load_mod.WorkerState.load(str(tmp_path / saved_by))
        assert state.step == 2 and state.log_history == json.loads(files[0])["log_history"]
        assert (random.random(), np.random.random(4).tolist()) == out["jax"]
    assert t_state.WorkerState.latest_checkpoint(str(tmp_path / "none")) is None
    for step in (1, 10, 2):
        t_state.WorkerState(step=step).save(str(tmp_path / "pipe" / f"checkpoint-{step}"))
    assert t_state.WorkerState.latest_checkpoint(str(tmp_path / "pipe")) == \
        j_state.WorkerState.latest_checkpoint(str(tmp_path / "pipe")) == \
        str(tmp_path / "pipe" / "checkpoint-10")


# ---------------------------------------------------------------- scheduler

class _Args:
    temperature, top_p, top_k, max_new_tokens = 0.0, 1.0, 0, 7
    do_sample, num_return_sequences = False, 3
    extra_fields = {}


def test_generate_scheduler_matches_jax():
    """generate_requests at greedy through each package's decode strategy:
    the same (prompts × n, P + max_out) matrix, ordered by (prompt, sample);
    level 0 through the group's batch generate gives the same rows."""
    config = Qwen25VLConfig.tiny()
    jp = j_model.init_params(config, jax.random.key(5), dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, jp)
    prompts = np.array([[0, 0, 0, 5, 6, 7], [9, 10, 11, 12, 13, 14], [0, 21, 22, 23, 24, 25]])
    tensors = {"input_ids": prompts, "attention_mask": (prompts != 0).astype(np.int64)}
    kw = dict(max_slots=4, max_len=64, decode_chunk=4, prefill_buckets=(16,))
    outs = {}
    for side in ("jax", "port"):
        if side == "jax":
            strat = JS.JaxDecodeStrategy()
            strat.initialize(config, jp, engine_kwargs=dict(kw, cache_dtype=jnp.float32,
                                                            sampler_exact=True))
            group, sched, proto = j_sched.LocalGenerateGroup([strat]), j_sched, JBatchProto
        else:
            strat = TS.TorchDecodeStrategy()
            strat.initialize(_port(config), params_from_numpy(np_params, device="cpu"),
                             engine_kwargs=dict(kw, cache_dtype=torch.float32))
            group, sched, proto = t_sched.LocalGenerateGroup([strat]), t_sched, TBatchProto
        scheduler = sched.GenerateScheduler(group)
        batch = proto.from_dict(tensors=tensors, meta={"pad_token_id": 0})
        out = scheduler.generate_requests(batch, _Args())
        outs[side] = (np.asarray(out.batch["output"]),
                      scheduler.generate(batch, _Args(), opt_level=0),
                      strat.engine.forked_requests, [scheduler.counter.get_value()
                                                     for _ in range(3)])
    got, want = outs["port"], outs["jax"]
    assert got[0].shape == (9, 6 + 7)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], got[1])
    assert got[2] == want[2] > 0 and got[3] == want[3] == [0, 1, 2]
