"""The port's own copies of the JAX package's host modules against the
originals, on the same inputs: the Qwen2.5-VL config, BatchProto's
operations, the worker config, the image processor and chat template, and
SocioSeg's encode_sample with its mask components (scipy in the port, the
native host library in the JAX package). Exact equality throughout: the
code is numpy/PIL on both sides.
"""

import dataclasses
import json

import numpy as np
import pytest
from PIL import Image

from socioreasoner_tpu import protocol as j_protocol
from socioreasoner_tpu.configs import worker_config as j_worker
from socioreasoner_tpu.datasets import processor as j_proc
from socioreasoner_tpu.datasets import socioseg as j_seg
from socioreasoner_tpu.models.qwen2_5_vl import config as j_config
from socioreasoner_tpu_torch import protocol as t_protocol
from socioreasoner_tpu_torch.configs import worker_config as t_worker
from socioreasoner_tpu_torch.datasets import processor as t_proc
from socioreasoner_tpu_torch.datasets import socioseg as t_seg
from socioreasoner_tpu_torch.models.qwen2_5_vl import config as t_config

HF_DICT = {
    "vocab_size": 1000, "hidden_size": 256, "intermediate_size": 512,
    "num_hidden_layers": 3, "num_attention_heads": 8, "num_key_value_heads": 2,
    "rope_theta": 500000.0, "rms_norm_eps": 1e-5, "tie_word_embeddings": True,
    "rope_scaling": {"type": "mrope", "mrope_section": [8, 12, 12]},
    "vision_config": {"depth": 4, "hidden_size": 128, "intermediate_size": 256,
                      "num_heads": 4, "out_hidden_size": 256,
                      "fullatt_block_indexes": [1, 3], "window_size": 56},
    "image_token_id": 990, "video_token_id": 991, "vision_start_token_id": 992,
    "eos_token_id": [1, 2], "pad_token_id": 0,
}


@pytest.mark.parametrize("make", ["default", "tiny", "tiny96", "hf_dict"])
def test_config_matches_jax(make):
    def build(mod):
        if make == "default":
            return mod.Qwen25VLConfig()
        if make == "tiny":
            return mod.Qwen25VLConfig.tiny()
        if make == "tiny96":
            return mod.Qwen25VLConfig.tiny(96)
        return mod.Qwen25VLConfig.from_hf_dict(json.loads(json.dumps(HF_DICT)))
    got, want = build(t_config), build(j_config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for sub in ("vision", "text"):
        assert type(getattr(got, sub)).__module__ == t_config.__name__
    assert (got.vision.head_dim, got.vision.patch_input_dim, got.vision.spatial_merge_unit) \
        == (want.vision.head_dim, want.vision.patch_input_dim, want.vision.spatial_merge_unit)
    assert got.stop_set == want.stop_set


def _proto_pair():
    rng = np.random.default_rng(0)
    tensors = {"ids": rng.integers(0, 9, (7, 5)), "score": rng.normal(size=(7,))}
    non_tensors = {"tag": ["a", "b", "a", "c", "b", "a", "c"],
                   "text": [f"s{i}" for i in range(7)]}
    return tuple(mod.BatchProto.from_dict(tensors={k: v.copy() for k, v in tensors.items()},
                                          non_tensors=non_tensors, meta={"step": 3})
                 for mod in (t_protocol, j_protocol))


def _same(a, b):
    assert type(a).__module__ == t_protocol.__name__
    assert sorted(a.batch) == sorted(b.batch) and sorted(a.non_tensor) == sorted(b.non_tensor)
    for k in b.batch:
        np.testing.assert_array_equal(np.asarray(a.batch[k]), np.asarray(b.batch[k]))
    for k in b.non_tensor:
        assert a.non_tensor[k].tolist() == b.non_tensor[k].tolist()
    assert a.meta == b.meta


OPS = {
    "chunk": lambda p: p.chunk(3),
    "concat": lambda p: [type(p).concat(p.chunk(3)[::-1])],
    "repeat": lambda p: [p.repeat(2), p.repeat(3, interleave=False)],
    "group_by": lambda p: list(p.group_by("tag").values()),
    "select": lambda p: [p.select(["ids"], ["tag"]), p.select_idxs([4, 0, 2]),
                         p.select_idxs(np.arange(7) % 2 == 0), p.slice(1, 6, 2)],
    "pad": lambda p: [p.pad_to_divisor(4), p.pad_to_divisor(4).unpad()],
    "iterator": lambda p: list(p.make_iterator(3, epochs=2, shuffle=True, seed=5)),
    "reorder_rename": lambda p: [p.reorder([6, 5, 4, 3, 2, 1, 0]).rename("ids", "tokens")],
    "pop_union": lambda p: [p.pop(["score"], ["text"]), p],
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_batchproto_ops_match_jax(op):
    t, j = _proto_pair()
    got, want = OPS[op](t), OPS[op](j)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        _same(a, b)


def test_worker_config_matches_jax():
    got, want = (mod.WorkerConfig(name="actor", device_mapping="list(range(0,4))", world_size=4,
                                  model_args=mod.ModelArguments(max_pixels="1344 * 1344"))
                 for mod in (t_worker, j_worker))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.resolved_device_mapping() == want.resolved_device_mapping() == [0, 1, 2, 3]
    assert got.model_args.pixels("max_pixels") == want.model_args.pixels("max_pixels")
    assert got.generating_args.to_dict() == want.generating_args.to_dict()


def _images(seed, sizes=((96, 124), (68, 68), (200, 90))):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) for h, w in sizes]


@pytest.mark.parametrize("defer", [False, True])
def test_processor_matches_jax(defer):
    kw = dict(min_pixels=56 * 56, max_pixels=56 * 56 * 16, defer_patchify=defer)
    tcfg, jcfg = t_proc.ImageProcessorConfig(**kw), j_proc.ImageProcessorConfig(**kw)
    for f in dataclasses.fields(jcfg):
        np.testing.assert_array_equal(getattr(tcfg, f.name), getattr(jcfg, f.name))
    for h, w in ((96, 124), (1000, 30), (768, 768)):
        assert t_proc.smart_resize(h, w) == j_proc.smart_resize(h, w)
    got, want = t_proc.process_images(_images(1), tcfg), j_proc.process_images(_images(1), jcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], list):
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    text = "Where is the park? <image>"
    assert t_proc.build_chat_text(text, 2) == j_proc.build_chat_text(text, 2)
    tp = t_proc.SocioProcessor(t_proc.SimpleTokenizer(4096), tcfg, image_token_id=4000)
    jp = j_proc.SocioProcessor(j_proc.SimpleTokenizer(4096), jcfg, image_token_id=4000)
    a, b = tp(tp.apply_chat_template(text, 2), _images(2)[:2]), \
        jp(jp.apply_chat_template(text, 2), _images(2)[:2])
    assert sorted(a) == sorted(b)
    np.testing.assert_array_equal(np.asarray(a["input_ids"]), np.asarray(b["input_ids"]))
    assert tp.decode(a["input_ids"][:40]) == jp.decode(b["input_ids"][:40])


def _mask(seed, px=96):
    """A mask of several components: rectangles, a diagonal chain (joined
    only through corners), single pixels and one under the area cut."""
    rng = np.random.default_rng(seed)
    m = np.zeros((px, px), np.uint8)
    for _ in range(4):
        y, x = rng.integers(0, px - 20, 2)
        m[y:y + rng.integers(4, 20), x:x + rng.integers(4, 20)] = 255
    for i in range(12):
        m[60 + i, 10 + i] = 255
    m[5, 90] = m[90, 5] = 255
    m[2:4, 40:42] = 255
    return m


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mask_components_match_jax(seed):
    m = _mask(seed)
    img = Image.fromarray(m)
    assert t_seg.count_components(img) == j_seg.count_components(img)
    assert t_seg.extract_gt_bboxes(img) == j_seg.extract_gt_bboxes(img)
    assert t_seg.extract_gt_bboxes(img, min_area=0) == j_seg.extract_gt_bboxes(img, min_area=0)


def test_encode_sample_matches_jax():
    rng = np.random.default_rng(4)
    sample = {"id": "tile7", "question": "residential area", "tag": "t",
              "map": Image.fromarray(rng.integers(0, 255, (120, 96, 3), dtype=np.uint8)),
              "sat": rng.integers(0, 255, (120, 96, 3), dtype=np.uint8),
              "mask": Image.fromarray(_mask(5, 120)[:, :96])}
    kw = dict(min_pixels=56 * 56, max_pixels=56 * 56 * 4)
    got = t_seg.encode_sample(sample, t_proc.ImageProcessorConfig(**kw))
    want = j_seg.encode_sample(sample, j_proc.ImageProcessorConfig(**kw))
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], Image.Image):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
        elif isinstance(want[k], list):
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            assert got[k] == want[k], k
    assert t_seg.format_stage2_prompt("park", "[]") == j_seg.format_stage2_prompt("park", "[]")


def test_load_socioseg_dir_matches_jax(tmp_path):
    for split, tid in (("train", "a"), ("train", "b"), ("val", "c")):
        d = tmp_path / split / tid
        d.mkdir(parents=True)
        (d / "question.json").write_text(json.dumps({"question": f"q {tid}"}))
    for split in ("train", "val", "test"):
        assert t_seg.load_socioseg_dir(str(tmp_path), split) == \
            j_seg.load_socioseg_dir(str(tmp_path), split)


# ------------------------------------------- the two-stage pipeline's host copies

from socioreasoner_tpu.configs import rlvr_config as j_rlvr  # noqa: E402
from socioreasoner_tpu.configs import validation as j_validation  # noqa: E402
from socioreasoner_tpu.pipeline.rlvr import evaluation as j_eval  # noqa: E402
from socioreasoner_tpu.pipeline.rlvr import parsing as j_parsing  # noqa: E402
from socioreasoner_tpu.pipeline.rlvr.rewards import socioseg as j_rewards  # noqa: E402
from socioreasoner_tpu.utils import metrics as j_metrics  # noqa: E402
from socioreasoner_tpu_torch.configs import rlvr_config as t_rlvr  # noqa: E402
from socioreasoner_tpu_torch.configs import validation as t_validation  # noqa: E402
from socioreasoner_tpu_torch.pipeline.rlvr import evaluation as t_eval  # noqa: E402
from socioreasoner_tpu_torch.pipeline.rlvr import parsing as t_parsing  # noqa: E402
from socioreasoner_tpu_torch.pipeline.rlvr.rewards import socioseg as t_rewards  # noqa: E402
from socioreasoner_tpu_torch.utils import metrics as t_metrics  # noqa: E402

ANSWERS = [
    '<think>a</think><answer>[{"bbox_2d": [1, 2, 30, 40]}, {"bbox_2d": [5, 5, 9]}]</answer>',
    '<think>b</think> <answer>[{"bbox_2d": [1, 2, 30, 40], "points": [[3, 4], [5, 6]]},'
    ' {"bbox_2d": [7, 8, 9, 10], "points": [[1]]}, "junk", {"points": [[1, 2]]}]</answer>',
    '<answer>{"bbox_2d": [1, 2, 3, 4]}</answer>', '<answer>[{"bbox_2d": [1, 2</answer>',
    "no answer tags at all", '<|im_end|><think>t</think><answer>[]</answer><|endoftext|>',
    '<think>x</think><answer>[{"bbox_2d": [0, 0, 1, 1], "points": 5}]</answer>',
]


def _parsing_case():
    for text in ANSWERS:
        for fn in ("strip_special_tokens", "parse_answer_text", "parse_visual_prompts_s1",
                   "parse_visual_prompts_s2", "parse_bboxes", "has_think_answer_format"):
            assert getattr(t_parsing, fn)(text) == getattr(j_parsing, fn)(text), (fn, text)


def _masks(seed, n=6, px=64):
    rng = np.random.default_rng(seed)
    out = [(rng.random((px, px)) > t).astype(np.uint8) for t in rng.uniform(0.2, 0.9, n)]
    return out + [np.zeros((px, px), np.uint8)] * 2


def _evaluation_case():
    masks, gts = _masks(0), _masks(1)
    got = [t_eval.compute_giou(m, g * 255) for m, g in zip(masks, gts)]
    want = [j_eval.compute_giou(m, g * 255) for m, g in zip(masks, gts)]
    assert got == want and got[-1] == 1.0
    tags = ["cityA", "cityB", "", "cityA", "lvl2", "cityB", "", "cityA"]
    assert t_eval.grouped_giou(got, tags) == j_eval.grouped_giou(want, tags)
    assert t_eval.grouped_giou([], []) == j_eval.grouped_giou([], [])


def _mask_iou_case():
    masks, gts = _masks(2), _masks(3)
    pairs = list(zip(masks, gts)) + [(masks[0], masks[0][:32]), (masks[0].tolist(), gts[0]),
                                     (masks[1] * 7, gts[1].astype(bool))]
    for a, b in pairs:
        for empty in (0.0, 1.0):
            assert t_rewards.mask_iou(a, b, empty) == j_rewards.mask_iou(a, b, empty)


def _config_pair(mod, strategy_config=None, **kw):
    cfg = mod.SocioSegConfig(rollout_batch_size=4, prompt_length=4096, response_length=64,
                             **kw)
    cfg.actor_infer.strategy_args.strategy_name = "jax_decode"
    cfg.actor_infer.strategy_args.strategy_config = strategy_config
    cfg.seg_infer.strategy_args.strategy_name = "seg_infer"
    cfg.seg_infer.strategy_args.strategy_config = {"seg_encode_batch": 4, "seg_embed_cache": 0}
    return cfg


YAML_KNOBS = {"kv_quant": None, "weight_quant": "int8", "single_copy_quant": True,
              "act_quant": None, "prefix_fork": True}
STRATEGY_CONFIGS = [
    YAML_KNOBS, {"weight_quant": "int4"}, {"bogus_knob": 1}, {"kv_quant": "int4"},
    {"single_copy_quant": True}, {"act_quant": "int8", "weight_quant": "int4"},
    {"dp_size": 2}, {"dp_size": 2, "tensor_model_parallel_size": 2}, None,
]


def _configs_case():
    for overlap in (True, False):
        got = _config_pair(t_rlvr, YAML_KNOBS, overlap_restage=overlap, restage_group_size=3)
        want = _config_pair(j_rlvr, YAML_KNOBS, overlap_restage=overlap, restage_group_size=3)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.sequence_length == want.sequence_length == 4160
        assert got.num_return_sequences == want.num_return_sequences
    for mod in (t_rlvr, j_rlvr):          # ${var} strings resolve the same way
        ga = mod.RLVRConfig().actor_infer.generating_args
        assert ga.max_new_tokens == 512
    interp = {k: "${response_length}" for k in ("max_new_tokens",)}
    got, want = (mod.RLVRConfig(response_length=99, actor_infer=wmod.WorkerConfig(
        generating_args=wmod.GeneratingArguments(**interp)))
        for mod, wmod in ((t_rlvr, t_worker), (j_rlvr, j_worker)))
    assert got.actor_infer.generating_args.max_new_tokens == \
        want.actor_infer.generating_args.max_new_tokens == 99
    for sc in STRATEGY_CONFIGS:
        for n in (1, 4):
            outcome = []
            for mod, vmod in ((t_rlvr, t_validation), (j_rlvr, j_validation)):
                try:
                    vmod.validate_config(_config_pair(mod, sc), n_devices=n)
                    outcome.append(None)
                except ValueError as e:
                    outcome.append(str(e))
            assert outcome[0] == outcome[1], (sc, n, outcome)


def _metrics_case():
    def drive(mod):
        mm = mod.MetricsManager()
        mm.add_metric("a", 1.5)
        mm.add_metric("a", 2.5)
        mm.add_metrics({"b": np.arange(4.0), "c": 3})
        mm.add_domain_metrics("cityA", {"iou": [0.5, 0.25]})
        mm.add_time("step", 1.25)
        mm.add_time("step", 0.5)
        mm.add_token_throughput("", 1000, 2.0, n_chips=4, dp_size=2)
        mm.add_token_throughput("s2_", 10, 0.0)
        with mm.timer("t"):
            pass
        first = mm.reduce(reset=False)
        return first, mm.reduce(), mm.reduce()
    got, want = drive(t_metrics), drive(j_metrics)
    assert [sorted(g) for g in got] == [sorted(w) for w in want]
    for g, w in zip(got, want):
        g.pop("time/t", None), w.pop("time/t", None)
        assert g == w


HOST_COPIES = {"parsing": _parsing_case, "evaluation": _evaluation_case,
               "mask_iou": _mask_iou_case, "configs": _configs_case,
               "metrics": _metrics_case}


@pytest.mark.parametrize("copy", sorted(HOST_COPIES))
def test_pipeline_host_copies_match_jax(copy):
    """parsing, compute_giou/grouped_giou, mask_iou, SocioSegConfig with
    validate_config, MetricsManager: the port's copies against the
    originals on the same inputs."""
    HOST_COPIES[copy]()
