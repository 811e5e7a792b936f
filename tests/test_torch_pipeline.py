"""The port's two-stage SocioSeg infer pipeline against the JAX package's.

Tiny Qwen2.5-VL and tiny SAM2 (the configs of
tests/test_infer_pipeline_e2e.py) in float32, JAX and port params from one
seed through the weight bridge, greedy decoding: the stage-2 render and
restage collation, the sequential and overlapped _two_stage (texts, bbox
texts, masks), run()'s files and iou_acc.txt, and run() driven through real
SAM2 masks by a scripted decode worker that answers every request with a
crafted answer. Then a CPU rehearsal of chip_smoke's two_stage and sam2
phases.
"""

import functools
import json
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from socioreasoner_tpu.configs.rlvr_config import SocioSegConfig as JConfig
from socioreasoner_tpu.datasets import collator as j_collator
from socioreasoner_tpu.datasets import socioseg as j_seg
from socioreasoner_tpu.datasets.processor import (ImageProcessorConfig as JImageConfig,
                                                  SimpleTokenizer as JTokenizer,
                                                  SocioProcessor as JProcessor)
from socioreasoner_tpu.models.qwen2_5_vl import model as j_qwen
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.models.sam2 import model as j_sam
from socioreasoner_tpu.models.sam2.config import Sam2Config as JSam2Config
from socioreasoner_tpu.pipeline.rlvr.socioseg_infer_pipeline import (
    SocioSegInferPipeline as JPipeline)
from socioreasoner_tpu.runtime.generate_scheduler import LocalGenerateGroup as JGroup
from socioreasoner_tpu_torch.configs.rlvr_config import SocioSegConfig
from socioreasoner_tpu_torch.datasets import collator as t_collator
from socioreasoner_tpu_torch.datasets import processor as t_processor
from socioreasoner_tpu_torch.datasets import socioseg as t_seg
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
from socioreasoner_tpu_torch.pipeline.rlvr.socioseg_infer_pipeline import SocioSegInferPipeline
from socioreasoner_tpu_torch.runtime.generate_scheduler import LocalGenerateGroup

VOCAB = 512
SPECIAL = {"<|im_start|>": 300, "<|im_end|>": 1, "<|vision_start|>": VOCAB - 4,
           "<|vision_end|>": VOCAB - 1, "<|image_pad|>": VOCAB - 3,
           "<|video_pad|>": VOCAB - 2, "<|endoftext|>": 0}
IMG = dict(min_pixels=56 * 56, max_pixels=56 * 56 * 4)
ENGINE = {"max_slots": 2, "max_len": 700, "decode_chunk": 4, "prefill_buckets": (640,),
          "image_buckets": (0, 16, 32)}
# a crafted answer in the 756×756 space of the resized tile: stage 1 reads
# its boxes, stage 2 its boxes and points
ANSWER = ('<think>x</think><answer>[{"bbox_2d": [100, 100, 500, 460], '
          '"points": [[300, 250], [200, 380]]}, {"bbox_2d": [520, 40, 740, 300], '
          '"points": [[600, 150]]}]</answer>')


def _tokenizer(cls):
    """A byte tokenizer whose special ids match Qwen25VLConfig.tiny()."""
    tok = cls(vocab_size=VOCAB)
    tok.special = dict(SPECIAL)
    tok.id_to_special = {v: k for k, v in SPECIAL.items()}
    tok.pad_token_id, tok.eos_token_id = 0, 1
    return tok


def _tiles(n=2, px=96):
    rng = np.random.default_rng(0)
    tiles = []
    for i in range(n):
        mask = np.zeros((px, px), np.uint8)
        mask[20:50, 20:50] = 255
        tiles.append({"id": f"tile{i}", "question": "residential area",
                      "map": Image.fromarray(rng.integers(0, 255, (px, px, 3), dtype=np.uint8)),
                      "sat": Image.fromarray(rng.integers(0, 255, (px, px, 3), dtype=np.uint8)),
                      "mask": Image.fromarray(mask)})
    return tiles


def _config(cls, out_dir):
    cfg = cls(output_dir=out_dir, rollout_batch_size=2, prompt_length=640,
              response_length=24, save_steps=-1, track_with="stdout")
    ga = cfg.actor_infer.generating_args
    ga.max_new_tokens, ga.temperature = 8, 0.0
    return cfg


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """(JAX pipeline, port pipeline) on the same weights and tiles. The SAM2
    mask projections are scaled ×1000 (both sides) so that the mask logits
    are of size ~0.1, not ~1e-4, and agree in sign between the two."""
    config = Qwen25VLConfig.tiny(VOCAB)
    jq = j_qwen.init_params(config, jax.random.key(0), dtype=jnp.float32)
    js = jax.jit(functools.partial(j_sam.init_params, JSam2Config.tiny_test()))(
        jax.random.key(1))
    sam_np = jax.tree.map(np.asarray, js)
    for m in sam_np["decoder"]["hyper_mlps"]:
        m["fc_out_w"] = m["fc_out_w"] * 1000.0
    jpipe = JPipeline(
        _config(JConfig, str(tmp_path_factory.mktemp("jax"))), model_config=config,
        policy_params=jq, sam_config=JSam2Config.tiny_test(),
        sam_params=jax.tree.map(jnp.asarray, sam_np),
        processor=JProcessor(_tokenizer(JTokenizer), JImageConfig(**IMG),
                             image_token_id=config.image_token_id),
        dataset=[j_seg.encode_sample(t, JImageConfig(**IMG)) for t in _tiles()],
        engine_kwargs={**ENGINE, "cache_dtype": jnp.float32, "sampler_exact": True})
    from tests.test_torch_engine import _port
    tconfig = _port(config)
    tpipe = SocioSegInferPipeline(
        _config(SocioSegConfig, str(tmp_path_factory.mktemp("port"))), model_config=tconfig,
        policy_params=params_from_numpy(jax.tree.map(np.asarray, jq), "cpu"),
        sam_config=Sam2Config.tiny_test(), sam_params=params_from_numpy(sam_np, "cpu"),
        processor=t_processor.SocioProcessor(_tokenizer(t_processor.SimpleTokenizer),
                                             t_processor.ImageProcessorConfig(**IMG),
                                             image_token_id=config.image_token_id),
        dataset=[t_seg.encode_sample(t, t_processor.ImageProcessorConfig(**IMG))
                 for t in _tiles()],
        engine_kwargs={**ENGINE, "cache_dtype": torch.float32})
    return jpipe, tpipe


def test_render_and_restage_collate_match_jax(pipelines):
    """The stage-2 render of a crafted box text over a stage-1 mask and the
    restage collation of the rendered pair: pixel-equal images, equal ids,
    attention masks and M-RoPE position ids."""
    jpipe, tpipe = pipelines
    mask = np.zeros((768, 768), np.uint8)
    mask[100:400, 200:700] = 1
    btxt = json.dumps([{"bbox_2d": [5, 6, 40, 50]}, {"bbox_2d": [30, 10, 90, 33]}])
    prompts, j_imgs, t_imgs = [], [], []
    for jr, tr in zip(jpipe.dataset, tpipe.dataset):
        j_imgs.append(j_seg.render_visual_prompt(btxt, [jr["image_map"], jr["image_sat"]], mask))
        t_imgs.append(t_seg.render_visual_prompt(btxt, [tr["image_map"], tr["image_sat"]], mask))
        prompts.append(t_seg.format_stage2_prompt(tr["question"], btxt))
        assert prompts[-1] == j_seg.format_stage2_prompt(jr["question"], btxt)
    for a, b in zip(t_imgs, j_imgs):
        for x, y in zip(a, b):
            assert x.size == y.size and x.mode == y.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert not np.array_equal(np.asarray(t_imgs[0][0]), np.asarray(tpipe.dataset[0]["image_map"]))
    got = t_collator.collate_restage(tpipe.processor, tpipe.model_config, prompts, t_imgs, 640)
    want = j_collator.collate_restage(jpipe.processor, jpipe.model_config, prompts, j_imgs, 640)
    for k in ("input_ids", "attention_mask", "position_ids"):
        np.testing.assert_array_equal(np.asarray(got.batch[k]), np.asarray(want.batch[k]))
    for a, b in zip(got.non_tensor["pixel_values"], want.non_tensor["pixel_values"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _assert_same_outputs(got, want):
    assert got["map_texts"] == want["map_texts"]
    assert got["sat_texts"] == want["sat_texts"]
    assert got["bbox_texts"] == want["bbox_texts"]
    for key in ("s1_masks", "s2_masks"):
        for a, b in zip(got[key], want[key]):
            assert a.shape == (768, 768) and a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
    for a, b in zip(got["s2_images"], want["s2_images"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("overlap", [False, True], ids=["sequential", "overlapped"])
def test_two_stage_matches_jax(pipelines, overlap):
    """Greedy _two_stage on the same weights and tiles: the same stage-1 and
    stage-2 texts, bbox texts, masks and renders as the JAX pipeline, and
    the overlapped path the same as the sequential one."""
    jpipe, tpipe = pipelines
    for p in pipelines:
        p.pipeline_config.overlap_restage = overlap
    try:
        want = jpipe._two_stage(jpipe.dataset)
        got = tpipe._two_stage(tpipe.dataset)
        tpipe.pipeline_config.overlap_restage = not overlap
        other = tpipe._two_stage(tpipe.dataset)
    finally:
        for p in pipelines:
            p.pipeline_config.overlap_restage = True
    assert any(got["map_texts"])
    _assert_same_outputs(got, want)
    _assert_same_outputs(other, got)
    assert tpipe.evaluate_batch(tpipe.dataset) == jpipe.evaluate_batch(jpipe.dataset)


def _run(pipeline):
    """run() into a fresh directory → (giou_acc, iou_acc.txt, {file: bytes})."""
    pipeline.result_dir = tempfile.mkdtemp(dir=pipeline.pipeline_config.output_dir)
    giou = pipeline.run()
    files = {}
    for root, _, names in os.walk(pipeline.result_dir):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, pipeline.result_dir)] = f.read()
    return giou, files


def _same_run(got, want):
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    assert len(got[1]) == 2 * 6 + 1
    assert got[1]["iou_acc.txt"] == want[1]["iou_acc.txt"] == f"{got[0]}\n".encode()
    for name in want[1]:
        if name.endswith(".png"):
            np.testing.assert_array_equal(_png(got[1][name]), _png(want[1][name]),
                                          err_msg=name)
        else:
            assert got[1][name] == want[1][name], name


def _png(data: bytes) -> np.ndarray:
    import io
    return np.asarray(Image.open(io.BytesIO(data)))


def test_run_matches_jax(pipelines):
    """run(): the same file set (4 PNGs and 2 texts a tile, iou_acc.txt),
    file contents and giou as the JAX pipeline, and the metric log."""
    jpipe, tpipe = pipelines
    got, want = _run(tpipe), _run(jpipe)
    _same_run(got, want)
    assert got[0] == 0.0          # random answers parse to no box: empty masks
    assert set(tpipe.state.log_history[-1]) == set(jpipe.state.log_history[-1])


class ScriptedWorker:
    """A decode worker that answers every request, in server and in batch
    mode, with the tokens of one crafted answer."""

    def __init__(self, tokenizer, answer: str, pad_id: int):
        self.ids = list(tokenizer.encode(answer))
        self.pad_id = pad_id

    def start_server(self, data=None):
        pass

    def stop_server(self):
        pass

    def add_request(self, command, data):
        data["callback"](SimpleNamespace(request_id=data["request_id"],
                                         output_ids=list(self.ids)))

    def generate(self, batch, generating_args):
        ids = np.asarray(batch.batch["input_ids"])
        out = np.full((ids.shape[0], ids.shape[1] + len(self.ids)), self.pad_id, np.int64)
        out[:, :ids.shape[1]] = ids
        out[:, ids.shape[1]:] = self.ids
        return out


@pytest.mark.parametrize("overlap", [False, True], ids=["sequential", "overlapped"])
def test_scripted_answers_drive_sam2_like_jax(pipelines, overlap):
    """run() with both pipelines' decode replaced by the scripted worker:
    stage 1 segments the answer's boxes and stage 2 its boxes and points
    through real SAM2 masks; masks, renders, texts and iou_acc.txt agree."""
    jpipe, tpipe = pipelines
    saved = [(p.decode_replicas, p.decode_group) for p in pipelines]
    try:
        for p, group in ((jpipe, JGroup), (tpipe, LocalGenerateGroup)):
            w = ScriptedWorker(p.processor.tokenizer, ANSWER, p.model_config.pad_token_id)
            p.decode_replicas, p.decode_group = [w], group([w])
            p.pipeline_config.overlap_restage = overlap
        got, want = _run(tpipe), _run(jpipe)
    finally:
        for p, (reps, group) in zip(pipelines, saved):
            p.decode_replicas, p.decode_group = reps, group
            p.pipeline_config.overlap_restage = True
    _same_run(got, want)
    s1 = _png(got[1]["stage1/tile0.png"])
    s2 = _png(got[1]["stage2/tile0.png"])
    assert s1.shape == (768, 768) and 0 < s1.mean() < 255 and 0 < s2.mean() < 255
    assert not np.array_equal(s1, s2)       # stage 2's points change the masks
    assert 0.0 < got[0] < 1.0
    assert got[1]["stage1/tile0.txt"].decode() == ANSWER


def test_chip_smoke_two_stage_and_sam2_on_cpu():
    """chip_smoke's two_stage and sam2 phases (the yaml's knobs: int8
    single-copy weights, prefix fork, top_p 0.8), rehearsed at a tiny
    config on CPU tensors, SAM2 in bf16 against its f32 copy."""
    import chip_smoke
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import (
        Qwen25VLConfig as TConfig, TextConfig, VisionConfig)
    from socioreasoner_tpu_torch.models.sam2 import model as t_sam
    config = TConfig(
        vision=VisionConfig(depth=2, hidden_size=64, intermediate_size=128,
                            num_heads=4, out_hidden_size=64, window_size=28,
                            fullatt_block_indexes=(1,)),
        text=TextConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                        mrope_section=(2, 3, 3)))
    params = t_model.init_params(config, torch.Generator().manual_seed(0), device="cpu")
    sam_config = Sam2Config.tiny_test()
    sam_params = t_sam.init_params(sam_config, torch.Generator().manual_seed(1),
                                   dtype=torch.bfloat16, device="cpu")
    img_cfg = t_processor.ImageProcessorConfig(defer_patchify=True, **IMG)
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as out_dir:
        pipeline = chip_smoke.build_two_stage(config, params, sam_config, sam_params, out_dir,
                                              n_tiles=4, tile_px=96, img_cfg=img_cfg,
                                              prompt_length=1024, response_length=8)
        engine = pipeline.actor_infer.engine
        assert engine.params["layers"]["q_w"].dtype == torch.int8 and engine.prefix_fork
        assert params["layers"]["q_w"].dtype == torch.float32
        stats = chip_smoke.run_two_stage(pipeline, cpu)
        assert stats["tiles"] == 4 and stats["files_written"] == 4 * 6 + 1
        assert stats["prefill_rows"] == 8 and stats["launches"] == {}
        assert stats["sequential"]["prefill_calls"] >= 2 and stats["prefill_calls"] >= 2
        assert stats["vit_ms_per_tile_s1"] > 0 and stats["vit_ms_per_tile_s2"] > 0
        assert stats["cache_lalloc"] == engine.Lalloc and len(stats["s2_prompt_lens"]) == 4
        assert max(stats["s1_prompt_lens"]) < min(stats["s2_prompt_lens"]) <= 1024
        decode = chip_smoke.profile_decode_chunk(engine, cpu, max(stats["s2_prompt_lens"]))
        assert decode["steps"] == decode["profiled_steps"] == engine.decode_chunk
        assert decode["ms_per_step"] > 0 and not engine.has_work()
        sam = chip_smoke.run_sam2_checks(pipeline, cpu, reps=1)
    assert sam["encoded_tiles"] == 4 and sam["encoder_calls"] == 1
    assert sam["dtype"] == "torch.bfloat16" and sam["mask_pixels_agree_f32"] < 1.0
    assert all(0 < px < 768 * 768 for px in sam["s1_mask_px"] + sam["s2_mask_px"])
