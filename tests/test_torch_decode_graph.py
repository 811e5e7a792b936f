"""The engine's decode step as one CUDA graph (generation/engine.py).

On the CPU, where the step runs eagerly: the device-state buffers keep
their addresses across admissions and releases, a CPU engine and a tp
engine capture nothing, and set_params marks the graph stale and decodes
as a fresh engine on the new weights. The step's parity with the JAX engine is
held in tests/test_torch_engine.py.

On the card (`-m cuda`; skipped without one): a small random Qwen2.5-VL
text decoder at head dim 128 (kernel 3 or 3q) with int8 single-copy
weights and 16 slots, its greedy rows against the same engine with its
graph switched off, token for token over chunks with admissions and
releases between them, with a bf16 and an int8 cache; one capture and
every step after the first replayed, kernel 3's (3q's) launches counted
at each replay as its twin's are at each eager step; fresh random draws
on each replay; set_params capturing again into the stale graph's
memory pool, at no more device memory; a
capture while another thread launches kernels on the card; and two
replicas' engines starting to decode at once from their own threads.

No JAX here: the card tests run in a process that never imports it.
"""

import threading

import numpy as np
import pytest
import torch

from socioreasoner_tpu_torch.generation import engine as t_engine
from socioreasoner_tpu_torch.generation.sampling import SamplingParams
from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
from socioreasoner_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig, TextConfig
from socioreasoner_tpu_torch.ops import decode_attention
from socioreasoner_tpu_torch.ops.quant import quantize_decode_params
from socioreasoner_tpu_torch.utils import profiling


def _greedy(n):
    return SamplingParams(temperature=0.0, do_sample=False, max_new_tokens=n)


def _sampled(n):
    return SamplingParams(temperature=1.0, top_p=1.0, max_new_tokens=n)


def _requests(specs):
    return [t_engine.Request(request_id=i, prompt_ids=p, sampling=s) for i, p, s in specs]


def _cpu_tree(config, seed):
    return t_model.init_params(config, torch.Generator().manual_seed(seed),
                               dtype=torch.float32, device="cpu", with_vision=False)


def _cpu_specs(seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(2, 200, size=n).tolist(), _greedy(m))
            for i, (n, m) in enumerate(((5, 7), (9, 3), (12, 10), (7, 5), (3, 9)))]


CPU_KW = dict(max_slots=2, max_len=64, decode_chunk=4, prefill_buckets=(16,))


def test_state_buffers_keep_their_addresses():
    """Admission and release copy into the decode step's buffers and the
    step updates them in place: every buffer and cache keeps its data_ptr
    from the first decode step to the last, over five requests through two
    slots."""
    config = Qwen25VLConfig.tiny()
    engine = t_engine.DecodeEngine(config, _cpu_tree(config, 0),
                                   cache_dtype=torch.float32, **CPU_KW)
    ptrs = lambda: {k: v.data_ptr() for k, v in  # noqa: E731
                    list(engine._dev_state.items()) + list(engine.caches.items())}
    before = ptrs()
    seen = []
    step = engine.step

    def spy():
        out = step()
        seen.append(ptrs())
        return out
    engine.step = spy
    outs = engine.generate(_requests(_cpu_specs()))
    assert len(outs) == 5 and all(o.finish_reason == "length" for o in outs)
    assert len(seen) >= 4 and all(p == before for p in seen)


def test_cpu_and_tp_engines_capture_nothing():
    """The graph is for one CUDA device: a CPU engine and a tp engine run
    the same step eagerly, and give the same greedy tokens."""
    config = Qwen25VLConfig.tiny()
    tree = _cpu_tree(config, 1)
    outs = []
    for mesh in (None, [torch.device("cpu")] * 2):
        engine = t_engine.DecodeEngine(config, tree, cache_dtype=torch.float32, mesh=mesh,
                                       **CPU_KW)
        outs.append([o.output_ids for o in engine.generate(_requests(_cpu_specs(1)))])
        assert engine.steps_executed > 0
        assert engine.graph_captures == engine.graph_steps == 0 and engine._graph is None
    assert outs[0] == outs[1]


def test_set_params_drops_the_graph():
    """set_params marks what the engine holds for a graph stale, so that no
    replay runs it again, and the engine then decodes as a fresh engine
    built on the new weights."""
    config = Qwen25VLConfig.tiny()
    engine = t_engine.DecodeEngine(config, _cpu_tree(config, 2), cache_dtype=torch.float32,
                                   **CPU_KW)
    engine.generate(_requests(_cpu_specs(2)))
    engine._graph = object()                       # what a capture leaves
    new = _cpu_tree(config, 3)
    engine.set_params(new)
    assert engine._graph_stale
    fresh = t_engine.DecodeEngine(config, new, cache_dtype=torch.float32, **CPU_KW)
    got, want = (e.generate(_requests(_cpu_specs(4))) for e in (engine, fresh))
    assert [o.output_ids for o in got] == [o.output_ids for o in want]


# -------------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode step is captured as a CUDA graph")
    return torch.device("cuda")


def _card_config():
    """Qwen2.5-VL's text decoder cut small at head dim 128, so that decode
    runs kernel 3 (3q with an int8 cache); no stop token (eos -1): every
    request runs to its length, so two engines admit and release alike."""
    return Qwen25VLConfig(
        vision=Qwen25VLConfig.tiny().vision,
        text=TextConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                        head_dim=128, mrope_section=(16, 24, 24),
                        tie_word_embeddings=False),
        image_token_id=509, video_token_id=510, vision_start_token_id=508,
        bos_token_id=0, eos_token_id=-1, pad_token_id=0)


def _card_tree(config, seed, dev):
    tree = t_model.init_params(config, torch.Generator(device=dev).manual_seed(seed),
                               dtype=torch.bfloat16, device=dev, with_vision=False)
    return quantize_decode_params(tree, inplace=True)     # int8 single-copy


def _card_engine(config, tree, graphed, kv_quant=None, seed=0):
    engine = t_engine.DecodeEngine(config, tree, max_slots=16, max_len=256, decode_chunk=8,
                                   prefill_buckets=(16, 32), kv_quant=kv_quant, seed=seed)
    assert engine._graphed
    engine._graphed = graphed                      # the eager twin: its graph off
    return engine


def _card_specs(seed, n=24):
    """n requests, every third greedy, the rest sampled at temperature 1,
    of 6-30 prompt tokens and 5-20 new ones: 16 slots take the first 16,
    and the rest are admitted as those finish, across three and more
    chunks of 8 steps."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(2, 500, size=int(rng.integers(6, 31))).tolist(),
             (_greedy if i % 3 == 0 else _sampled)(int(rng.integers(5, 21))))
            for i in range(n)]


def _greedy_outputs(outs, specs):
    greedy = {i for i, _, s in specs if not s.do_sample}
    return {o.request_id: o.output_ids for o in outs if o.request_id in greedy}


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_graphed_decode_equals_eager(cuda, kv_quant):
    """The greedy rows of the graphed engine equal its eager twin's token for
    token, over chunks with admissions and releases between them; one
    capture after the first decode step, run eagerly under a launch span
    marked replay=0 capture=1, and every later step replayed under one
    marked replay=1. Kernel 3 (3q with the int8 cache) counts one launch a
    layer and a step in both engines: a replay adds the calls its capture
    recorded."""
    config = _card_config()
    tree = _card_tree(config, 11, cuda)
    specs = _card_specs(5)
    kernel = (decode_attention.paged_decode_attention if kv_quant is None
              else decode_attention.paged_decode_attention_int8)
    engines = [_card_engine(config, tree, g, kv_quant) for g in (True, False)]
    launched = []
    before = kernel.launches
    with profiling.recording() as rec:
        outs = [engines[0].generate(_requests(specs))]
    launched.append(kernel.launches - before)
    before = kernel.launches
    outs.append(engines[1].generate(_requests(specs)))
    launched.append(kernel.launches - before)
    graphed, eager = engines
    launches = [e["attrs"] for e in rec.events() if e["name"] == "engine.decode.launch"]
    assert len(launches) == graphed.steps_executed
    assert launches[0] == {"replay": 0, "capture": 1}
    assert all(a == {"replay": 1} for a in launches[1:])
    assert graphed.steps_executed == eager.steps_executed >= 3 * graphed.decode_chunk
    assert _greedy_outputs(outs[0], specs) == _greedy_outputs(outs[1], specs)
    assert [len(o.output_ids) for o in outs[0]] == [s.max_new_tokens for _, _, s in specs]
    assert graphed.graph_captures == 1 and graphed.graph_steps == graphed.steps_executed - 1
    assert eager.graph_captures == eager.graph_steps == 0
    layers = config.text.num_hidden_layers
    assert launched == [layers * graphed.steps_executed] * 2


@pytest.mark.cuda
def test_replays_draw_fresh_uniforms(cuda):
    """With a zero LM head every logit is 0, so a temperature-1 row's token
    comes from the step's random draws alone: a replay that reused its
    capture's draws would emit one token over and over."""
    config = _card_config()
    tree = _card_tree(config, 12, cuda)
    tree["lm_head"].zero_()
    engine = _card_engine(config, tree, True)
    outs = engine.generate(_requests([(i, [3 + i] * 8, _sampled(17)) for i in range(16)]))
    assert engine.graph_captures == 1 and engine.steps_executed == 16
    assert engine.graph_steps == 15
    decoded = [o.output_ids[1:] for o in outs]           # the 16 decode-step tokens
    assert all(len(set(row)) > 4 for row in decoded), decoded
    assert len({tuple(row) for row in decoded}) == 16


@pytest.mark.cuda
def test_set_params_captures_again(cuda):
    """After set_params the graphed engine captures again, into the stale
    graph's memory pool, and decodes as a fresh eager engine on the new
    weights. Capturing again five times over takes no more device memory
    than the first capture did."""
    config = _card_config()
    engine = _card_engine(config, _card_tree(config, 13, cuda), True)
    specs = _card_specs(6, n=20)
    engine.generate(_requests(specs))
    assert engine.graph_captures == 1
    new = _card_tree(config, 14, cuda)
    engine.set_params(new)
    steps0 = engine.steps_executed
    got = engine.generate(_requests(specs))
    want = _card_engine(config, new, False).generate(_requests(specs))
    assert engine.graph_captures == 2
    assert engine.graph_steps == engine.steps_executed - 2
    assert engine.steps_executed > steps0
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    for _ in range(5):
        engine.set_params(new)
        engine.generate(_requests(specs[:4]))
    torch.cuda.synchronize()
    assert engine.graph_captures == 7
    assert torch.cuda.memory_reserved() <= reserved
    assert _greedy_outputs(got, specs) == _greedy_outputs(want, specs)


@pytest.mark.cuda
def test_capture_beside_another_thread(cuda):
    """The capture is thread-local: another thread that launches kernels and
    reads results back on the same card all through it (as the pipeline's
    ViT does) neither breaks the capture nor changes the greedy tokens."""
    config = _card_config()
    tree = _card_tree(config, 15, cuda)
    specs = _card_specs(7)
    stop = threading.Event()
    errors, launched = [], []

    def busy():
        try:
            a = torch.randn(1024, 1024, device=cuda, dtype=torch.bfloat16)
            while not stop.is_set():
                for _ in range(8):
                    a = torch.tanh(a @ a)
                launched.append(float(a.float().mean()))
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)
    worker = threading.Thread(target=busy, daemon=True)
    worker.start()
    try:
        engine = _card_engine(config, tree, True)
        got = engine.generate(_requests(specs))
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive() and not errors, errors
    assert len(launched) > 1
    want = _card_engine(config, tree, False).generate(_requests(specs))
    assert engine.graph_captures == 1 and engine.graph_steps == engine.steps_executed - 1
    assert _greedy_outputs(got, specs) == _greedy_outputs(want, specs)


@pytest.mark.cuda
def test_two_replicas_capture_at_once(cuda):
    """Two engines on one card, each served from its own thread (dp
    replicas), start decoding together: each captures its own graph (one
    capture at a time, the other thread's steps running meanwhile), and each
    engine's greedy tokens equal its eager twin's."""
    config = _card_config()
    tree = _card_tree(config, 16, cuda)
    specs = [_card_specs(8), _card_specs(9)]
    engines = [_card_engine(config, tree, True, seed=s) for s in (1, 2)]
    start = threading.Barrier(2)
    got, errors = [None, None], []

    def serve(i):
        try:
            start.wait(timeout=60)
            got[i] = engines[i].generate(_requests(specs[i]))
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)
    workers = [threading.Thread(target=serve, args=(i,), daemon=True) for i in (0, 1)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
    assert not any(w.is_alive() for w in workers) and not errors, errors
    for i, engine in enumerate(engines):
        want = _card_engine(config, tree, False, seed=i + 1).generate(_requests(specs[i]))
        assert engine.graph_captures == 1 and engine.graph_steps == engine.steps_executed - 1
        assert _greedy_outputs(got[i], specs[i]) == _greedy_outputs(want, specs[i])
