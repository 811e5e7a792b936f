"""The port's serving stack against the JAX package's: DecodeEngine greedy
streams and step counts, prefix fork, image requests, the request server,
sampling, the stage-1 collator and the decode strategy; plus checks that no
port module imports jax or the JAX package (a subprocess, and the source).
JAX-package config objects are copied field for field into the port's own
classes (`_port`) before they reach a port function.

Float32 at Qwen25VLConfig.tiny(). Greedy decoding must agree token for token
(the JAX engine runs with sampler_exact=True, as the port always does);
sampled streams are compared by distribution only.
"""

import ast
import dataclasses
import importlib
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

# The suite runs under pytest-xdist, several worker processes on a machine of
# few cores (tier-1: 6 workers on 8). PyTorch's default of one intra-op
# thread a core puts ~6 x 8 threads on those cores, and the port's tests ran
# 5-20x slower under that load than alone: one thread a worker process.
# Every worker imports this module when it collects the suite (the port's
# test files import _port from it).
torch.set_num_threads(1)

from socioreasoner_tpu.datasets.processor import (ImageProcessorConfig,
                                                  SimpleTokenizer, SocioProcessor)
from socioreasoner_tpu.datasets.socioseg import encode_sample
from socioreasoner_tpu.generation import engine as j_engine
from socioreasoner_tpu.generation.sampling import SamplingParams as JSampling
from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu_torch.datasets import processor as t_processor
from socioreasoner_tpu_torch.datasets.socioseg import encode_sample as t_encode_sample
from socioreasoner_tpu_torch.generation import engine as t_engine
from socioreasoner_tpu_torch.generation.sampling import SamplingParams, sample_tokens
from socioreasoner_tpu_torch.generation.server import GenerateRequestType, GenerateServer
from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(obj):
    """The port's own copy of a JAX-package dataclass (a config, a
    BatchProto), field for field."""
    mod = importlib.import_module(type(obj).__module__.replace(
        "socioreasoner_tpu.", "socioreasoner_tpu_torch.", 1))
    cls = getattr(mod, type(obj).__name__)
    return cls(**{f.name: _port(getattr(obj, f.name))
                  if dataclasses.is_dataclass(getattr(obj, f.name)) else getattr(obj, f.name)
                  for f in dataclasses.fields(obj) if f.init})


@pytest.fixture(scope="module")
def setup():
    config = Qwen25VLConfig.tiny()
    jp = j_model.init_params(config, jax.random.key(7), dtype=jnp.float32,
                             with_vision=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return config, jp, tp


def _greedy(n, stops=()):
    return dict(temperature=0.0, do_sample=False, max_new_tokens=n, stop_token_ids=stops)


def _run_both(config, jp, tp, specs, engine_kw, image_embeds=None):
    """Run the same requests through both engines; specs are
    (request_id, prompt_ids, sampling kwargs, position_ids or None)."""
    je = j_engine.DecodeEngine(config, jp, cache_dtype=jnp.float32,
                               sampler_exact=True, **engine_kw)
    te = t_engine.DecodeEngine(_port(config), tp, cache_dtype=torch.float32, **engine_kw)
    emb_j = emb_t = None
    if image_embeds is not None:
        emb_j, emb_t = jnp.asarray(image_embeds), torch.as_tensor(image_embeds)
    jo = je.generate([j_engine.Request(
        request_id=rid, prompt_ids=list(p), sampling=JSampling(**sp),
        image_embeds=emb_j if pos is not None else None, position_ids=pos)
        for rid, p, sp, pos in specs])
    to = te.generate([t_engine.Request(
        request_id=rid, prompt_ids=list(p), sampling=SamplingParams(**sp),
        image_embeds=emb_t if pos is not None else None, position_ids=pos)
        for rid, p, sp, pos in specs])
    return je, te, jo, to


def _assert_same(je, te, jo, to):
    assert [o.request_id for o in to] == [o.request_id for o in jo]
    for a, b in zip(jo, to):
        assert b.output_ids == a.output_ids, (a.request_id, a.output_ids, b.output_ids)
        assert b.finish_reason == a.finish_reason
    assert te.steps_executed == je.steps_executed
    assert (te.prefill_rows, te.forked_requests) == (je.prefill_rows, je.forked_requests)


def test_engine_greedy_mixed_lengths_match_jax(setup):
    config, jp, tp = setup
    rng = np.random.default_rng(0)
    specs = [(i, rng.integers(2, 200, size=n).tolist(), _greedy(m), None)
             for i, (n, m) in enumerate(((5, 8), (9, 3), (14, 11)))]
    res = _run_both(config, jp, tp, specs, dict(
        max_slots=2, max_len=64, decode_chunk=4, prefill_buckets=(16, 32)))
    _assert_same(*res)


def test_engine_early_exit_and_stop_token_match_jax(setup):
    config, jp, tp = setup
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 200, size=6).tolist() for _ in range(2)]
    kw = dict(max_slots=2, max_len=128, decode_chunk=64, prefill_buckets=(16,),
              prefix_fork=False)
    je, te, jo, to = _run_both(config, jp, tp,
                               [(i, p, _greedy(3), None) for i, p in enumerate(prompts)], kw)
    _assert_same(je, te, jo, to)
    assert te.steps_executed <= 4                    # the 64-step chunk exited early
    # a stop token two tokens in: the chunk exits at the stop, not the budget
    stop = jo[1].output_ids[1]
    _assert_same(*_run_both(config, jp, tp, [("s", prompts[1], _greedy(50, (stop,)), None)], kw))


def test_engine_prefix_fork_matches_jax(setup):
    config, jp, tp = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, 200, size=7).tolist() for _ in range(2)]
    specs = [((i, j), p, _greedy(8), None) for i, p in enumerate(prompts) for j in range(2)]
    je, te, jo, to = _run_both(config, jp, tp, specs, dict(
        max_slots=4, max_len=64, decode_chunk=4, prefill_buckets=(16,)))
    _assert_same(je, te, jo, to)
    assert te.forked_requests == 2 and te.prefill_rows == 2


def test_engine_image_request_matches_jax(setup):
    config, jp, tp = setup
    from socioreasoner_tpu.models.qwen2_5_vl.rope import get_rope_index
    rng = np.random.default_rng(2)
    grid = np.array([[1, 4, 8]])
    ids = np.concatenate([[5, 6], [config.image_token_id] * 8, rng.integers(2, 200, 6)])
    pos, _ = get_rope_index(config, ids[None], grid)
    embeds = rng.normal(size=(8, config.text.hidden_size)).astype(np.float32)
    specs = [("img", ids.tolist(), _greedy(8), pos[0]),
             ("txt", rng.integers(2, 200, size=9).tolist(), _greedy(6), None)]
    _assert_same(*_run_both(config, jp, tp, specs, dict(
        max_slots=2, max_len=64, decode_chunk=4, prefill_buckets=(32,)),
        image_embeds=embeds))


def test_server_add_abort_stop_alive(setup):
    config, _, tp = setup
    engine = t_engine.DecodeEngine(_port(config), tp, max_slots=2, max_len=64, decode_chunk=2,
                                   prefill_buckets=(16,), cache_dtype=torch.float32)
    server = GenerateServer(engine)
    server.start()
    done = {}
    for i in range(3):
        server.add_request(GenerateRequestType.ADD, {
            "request_id": i, "prompt_ids": [5 + i, 6, 7],
            "sampling": SamplingParams(**_greedy(1000 if i == 0 else 3)),
            "callback": lambda out: done.__setitem__(out.request_id, out)})
    server.add_request(GenerateRequestType.ABORT, {"request_id": 0})
    deadline = time.time() + 60
    while len(done) < 2 and time.time() < deadline:
        time.sleep(0.02)
    assert sorted(done) == [1, 2]
    assert all(o.finish_reason == "length" and len(o.output_ids) == 3
               for o in done.values())
    assert server.add_request(GenerateRequestType.ALIVE_CHECK)["alive"]
    server.stop()
    assert not server.is_alive()
    assert not engine.has_work()                     # request 0 was aborted
    with pytest.raises(RuntimeError):
        server.add_request(GenerateRequestType.ALIVE_CHECK)


def test_sample_tokens_greedy_and_distribution():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 10.0, 0.0, 0.0], [5.0, 0.0, 0.0, 0.0]])
    one = torch.ones(2)
    greedy = sample_tokens(logits, gen, torch.zeros(2), one, torch.zeros(2, dtype=torch.long))
    assert greedy.tolist() == [1, 0]
    assert sample_tokens(logits, gen, one, one, torch.ones(2, dtype=torch.long)).tolist() == [1, 0]
    # distribution: temperature 1, top_k 3, top_p 0.9 against the masked softmax
    rng = np.random.default_rng(0)
    row = torch.as_tensor(rng.normal(size=40).astype(np.float32))
    n = 20000
    toks = sample_tokens(row[None].expand(n, -1), gen, torch.ones(n), torch.full((n,), 0.9),
                         torch.full((n,), 3, dtype=torch.long))
    p = torch.softmax(row.double(), 0)
    order = torch.argsort(p, descending=True)
    keep = order[:3]
    cum = torch.cumsum(p[order], 0)
    keep = keep[((cum - p[order])[:3] < 0.9)]
    want = torch.zeros(40, dtype=torch.float64)
    want[keep] = p[keep] / p[keep].sum()
    got = torch.bincount(toks, minlength=40).double() / n
    assert set(torch.nonzero(got).flatten().tolist()) <= set(keep.tolist())
    assert (got - want).abs().max().item() < 0.02


def _tiles(n, px=84):
    rng = np.random.default_rng(0)
    tiles = []
    for i in range(n):
        mask = np.zeros((px, px), np.uint8)
        mask[px // 4:px // 2, px // 5:px // 2] = 255
        tiles.append({"id": f"t{i}", "question": "residential area",
                      "map": Image.fromarray(rng.integers(0, 255, (px, px, 3), dtype=np.uint8)),
                      "sat": Image.fromarray(rng.integers(0, 255, (px, px, 3), dtype=np.uint8)),
                      "mask": Image.fromarray(mask)})
    return tiles


def test_collator_and_image_embeds_match_jax(setup):
    config, jp, tp = setup
    from socioreasoner_tpu.datasets.collator import SocioSegCollator as JCollator
    from socioreasoner_tpu.distributed.jax_strategies import batch_image_embeds as j_embeds
    from socioreasoner_tpu_torch.datasets.collator import SocioSegCollator as TCollator
    from socioreasoner_tpu_torch.distributed.torch_strategies import batch_image_embeds
    img_cfg = ImageProcessorConfig(min_pixels=56 * 56, max_pixels=56 * 56 * 4,
                                   defer_patchify=True)
    proc = SocioProcessor(SimpleTokenizer(config.text.vocab_size), img_cfg,
                          image_token_id=config.image_token_id)
    jb = JCollator(proc, config, prompt_length=512)(
        [encode_sample(t, img_cfg) for t in _tiles(2)])
    t_img_cfg, t_config = _port(img_cfg), _port(config)
    t_proc = t_processor.SocioProcessor(
        t_processor.SimpleTokenizer(config.text.vocab_size), t_img_cfg,
        image_token_id=config.image_token_id)
    tb = TCollator(t_proc, t_config, prompt_length=512)(
        [t_encode_sample(t, t_img_cfg) for t in _tiles(2)])
    assert sorted(tb.batch.keys()) == sorted(jb.batch.keys())
    for key in jb.batch.keys():
        np.testing.assert_array_equal(np.asarray(tb.batch[key]), np.asarray(jb.batch[key]))
    for a, b in zip(tb.non_tensor["map_grid_thw"], jb.non_tensor["map_grid_thw"]):
        np.testing.assert_array_equal(a, b)
    want = j_embeds(config, jp, jb, prefix="map_", image_config=img_cfg)
    got = batch_image_embeds(t_config, tp, tb, prefix="map_", image_config=t_img_cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_decode_strategy_generate_layout(setup):
    """TorchDecodeStrategy.generate: [left-padded prompt | response] rows,
    n per prompt, greedy responses equal to the engine's."""
    config, _, tp = setup
    from socioreasoner_tpu_torch.distributed.torch_strategies import TorchDecodeStrategy
    from socioreasoner_tpu_torch.protocol import BatchProto

    class Args:
        temperature, top_p, top_k, max_new_tokens = 0.0, 1.0, 0, 5
        do_sample, num_return_sequences = False, 2

    ids = np.array([[0, 0, 5, 6, 7], [8, 9, 10, 11, 12]])
    attn = (ids != 0).astype(np.int64)
    batch = BatchProto.from_dict(tensors={"input_ids": ids, "attention_mask": attn})
    strat = TorchDecodeStrategy()
    strat.initialize(_port(config), tp, engine_kwargs=dict(
        max_slots=4, max_len=64, decode_chunk=4, prefill_buckets=(16,),
        cache_dtype=torch.float32))
    out = strat.generate(batch, Args())
    assert out.shape[0] == 4
    np.testing.assert_array_equal(out[:, :5], np.repeat(ids, 2, axis=0))
    assert (out[0, 5:] == out[1, 5:]).all()          # greedy siblings agree
    assert strat.engine.forked_requests == 2
    # new weights: the fork registry is dropped, so the repeat prefills again
    strat.model_update(params=params_from_numpy({k: v for k, v in _numpy_tree(tp).items()},
                                                device="cpu"))
    again = strat.generate(batch, Args())
    np.testing.assert_array_equal(again, out)
    assert strat.engine.prefill_rows == 4


def test_chip_smoke_main_path_on_cpu():
    """chip_smoke's main path (collator → ViT embeds → server-mode decode),
    rehearsed at a tiny config on CPU tensors (the kernels' plain versions)."""
    import chip_smoke
    from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import (
        Qwen25VLConfig, TextConfig, VisionConfig)
    config = Qwen25VLConfig(
        vision=VisionConfig(depth=2, hidden_size=64, intermediate_size=128,
                            num_heads=4, out_hidden_size=64, window_size=28,
                            fullatt_block_indexes=(1,)),
        text=TextConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                        mrope_section=(2, 3, 3)))
    params = t_model.init_params(config, torch.Generator().manual_seed(0), device="cpu")
    img_cfg = t_processor.ImageProcessorConfig(min_pixels=56 * 56, max_pixels=56 * 56 * 4,
                                               defer_patchify=True)
    outs, engine, stats = chip_smoke.run_main_path(
        config, params, torch.device("cpu"), n_tiles=2, tile_px=96, img_cfg=img_cfg,
        buckets=(512, 1024), max_new=5, decode_chunk=4)
    assert [len(o.output_ids) for o in outs] == [5, 5]
    assert stats["image_rows"] == [18, 18] and stats["alive"]
    assert engine.steps_executed == 4 and stats["prefill_calls"] == 1
    assert not engine.has_work()


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke, imports without pulling in
    jax or any module of the JAX package, and a Cluster built from each
    worker_cls string of the JAX package holds the port's class."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import socioreasoner_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) >= 20, names\n"
        "new = {'utils.kl_controller', 'utils.worker_state', 'pipeline.base_pipeline',\n"
        "       'pipeline.base_worker', 'pipeline.rlvr.rewards.socioseg',\n"
        "       'runtime.generate_scheduler', 'pipeline.rlvr.socioseg_pipeline',\n"
        "       'pipeline.rlvr.rlvr_pipeline', 'pipeline.rlvr.math_vlm_pipeline',\n"
        "       'pipeline.rlvr.rewards.math_rule', 'datasets.loader', 'datasets.sampler',\n"
        "       'datasets.chat_template', 'runtime.dispatch', 'runtime.cluster',\n"
        "       'runtime.worker', 'pipeline.rlvr.rewards.general_rules',\n"
        "       'pipeline.rlvr.rewards.code_sandbox', 'pipeline.rlvr.rewards.llm_judge',\n"
        "       'distributed.sft', 'distributed.factory', 'ops.moe', 'models.llm',\n"
        "       'configs.agentic_config', 'pipeline.agentic.environment_worker',\n"
        "       'pipeline.agentic.agentic_pipeline', 'pipeline.agentic.agentic_vlm_pipeline',\n"
        "       'ops.flags', 'utils.context_managers', 'utils.profiling',\n"
        "       'runtime.log_monitor', 'utils.checkpoint_manager', 'utils.native',\n"
        "       'runtime.resource_manager', 'parallel.mesh', 'parallel.sharding',\n"
        "       'distributed.transfer', 'ops.vocab_parallel', 'runtime.initialize',\n"
        "       'utils.collective'}\n"
        "assert {pkg.__name__ + '.' + n for n in new} <= set(names), names\n"
        "for n in names: importlib.import_module(n)\n"
        "from socioreasoner_tpu_torch.configs.worker_config import WorkerConfig\n"
        "from socioreasoner_tpu_torch.runtime.cluster import Cluster\n"
        "for cls in ('SocioSegRuleRewardWorker', 'MathRuleRewardWorker',\n"
        "            'CodeSandboxRewardWorker', 'CrossThinkQARewardWorker',\n"
        "            'GeneralValRuleRewardWorker', 'RewardWorker', 'ActorWorker', 'SegWorker'):\n"
        "    c = Cluster(cls, 'socioreasoner_tpu.pipeline.base_worker.' + cls,\n"
        "                WorkerConfig(world_size=2))\n"
        "    assert type(c.workers[0]).__module__ == 'socioreasoner_tpu_torch.pipeline.base_worker'\n"
        "    c.shutdown()\n"
        "from socioreasoner_tpu_torch.configs.loader import load_config\n"
        "from socioreasoner_tpu_torch.configs.rlvr_config import SocioSegConfig\n"
        "cfg = load_config(SocioSegConfig, 'examples/train/rlvr_tpu.yaml')\n"
        "(name, wc), = cfg.rewards.items()\n"
        "c = Cluster(name, wc.worker_cls, wc)\n"
        "assert len(c.workers) == 16 and type(c.workers[0]).__name__ == 'SocioSegRuleRewardWorker'\n"
        "c.shutdown()\n"
        "import chip_smoke\n"
        "for f in ('phase_grpo', 'run_grpo_path', 'build_grpo', 'socioseg_train_config',\n"
        "          'grpo_answers', 'ScriptedDecodeWorker', '_phase_train_kernels',\n"
        "          'phase_rlvr', 'run_rlvr_path', 'run_math_vlm_path', 'run_vit_grad_check',\n"
        "          'phase_workers', 'run_workers_path', 'phase_families', 'serve_family',\n"
        "          'train_family', 'text_model_round_trip', 'run_qwen2_vl',\n"
        "          'phase_agentic', 'run_agentic_vlm', 'run_agentic_text',\n"
        "          'phase_parallel', 'run_tp_engines', 'run_dp_pipelines', 'tp_tie_check',\n"
        "          'profile_prefill', 'profiled', '_forced_logits',\n"
        "          'phase_train_mesh', 'run_mesh_strategies', 'check_mesh_strategies',\n"
        "          'run_mesh_pipeline', 'run_mesh_processes', 'check_mesh_processes',\n"
        "          'train_mesh_worker', 'run_mesh_step', 'kernel_shapes',\n"
        "          'train_mesh_config', 'train_mesh_params', 'train_mesh_batch',\n"
        "          'phase_head_dims', 'run_head_dim_model', 'written_text_model',\n"
        "          '_head_dim_kernels', '_head_dim_instance_check', 'library_kernels'):\n"
        "    assert callable(getattr(chip_smoke, f)), f\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'socioreasoner_tpu' or m.startswith('socioreasoner_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _port_sources():
    pkg = os.path.join(REPO, "socioreasoner_tpu_torch")
    files = [os.path.join(root, f) for root, _, names in os.walk(pkg)
             for f in names if f.endswith(".py")]
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def _jax_package_imports(path):
    """(line, module) of every import of socioreasoner_tpu or a module of it
    in the file, at any depth (function-level imports included)."""
    found = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n == "socioreasoner_tpu" or n.startswith("socioreasoner_tpu.")]
    return found


def test_port_sources_import_nothing_of_the_jax_package():
    files = _port_sources()
    assert len(files) >= 30
    rel = {os.path.relpath(f, REPO) for f in files}
    assert {"socioreasoner_tpu_torch/utils/kl_controller.py",
            "socioreasoner_tpu_torch/pipeline/base_worker.py",
            "socioreasoner_tpu_torch/pipeline/rlvr/socioseg_pipeline.py",
            "socioreasoner_tpu_torch/runtime/generate_scheduler.py",
            "socioreasoner_tpu_torch/ops/moe.py", "socioreasoner_tpu_torch/models/llm.py",
            "socioreasoner_tpu_torch/configs/agentic_config.py",
            "socioreasoner_tpu_torch/pipeline/agentic/environment_worker.py",
            "socioreasoner_tpu_torch/pipeline/agentic/agentic_pipeline.py",
            "socioreasoner_tpu_torch/pipeline/agentic/agentic_vlm_pipeline.py",
            "socioreasoner_tpu_torch/ops/flags.py",
            "socioreasoner_tpu_torch/utils/context_managers.py",
            "socioreasoner_tpu_torch/utils/profiling.py",
            "socioreasoner_tpu_torch/runtime/log_monitor.py",
            "socioreasoner_tpu_torch/utils/checkpoint_manager.py",
            "socioreasoner_tpu_torch/utils/native.py",
            "socioreasoner_tpu_torch/runtime/resource_manager.py",
            "socioreasoner_tpu_torch/parallel/mesh.py",
            "socioreasoner_tpu_torch/parallel/sharding.py",
            "socioreasoner_tpu_torch/distributed/transfer.py",
            "socioreasoner_tpu_torch/ops/vocab_parallel.py",
            "socioreasoner_tpu_torch/runtime/initialize.py",
            "socioreasoner_tpu_torch/utils/collective.py",
            "chip_smoke.py"} <= rel
    bad = {os.path.relpath(f, REPO): hits for f in files if (hits := _jax_package_imports(f))}
    assert not bad, bad


def test_jax_package_import_finder_sees_every_form(tmp_path):
    """The AST check catches module-level, function-level and aliased
    imports, and leaves the port's own package alone."""
    src = tmp_path / "m.py"
    src.write_text("import socioreasoner_tpu_torch.ops\n"
                   "from socioreasoner_tpu_torch import protocol\n"
                   "import socioreasoner_tpu.protocol as p\n"
                   "def f():\n"
                   "    from socioreasoner_tpu.models import llm\n"
                   "    import socioreasoner_tpu\n")
    assert _jax_package_imports(str(src)) == [
        (3, "socioreasoner_tpu.protocol"), (5, "socioreasoner_tpu.models"),
        (6, "socioreasoner_tpu")]
