"""Falcon3-7B on the port's normal path, at a tiny size on the CPU.

Falcon3 is a LlamaForCausalLM at head dim 256 (12 / 4 heads, RoPE theta
1000042, an untied head, no biases). A tiny config of that shape (head dim
256, 3 / 1 heads, 2 layers) on seeded random weights from the benchmark's
own weights.py runs through DecodeEngine (prefill, then decode through the
cache, prefix fork on) and is held on its logits against the benchmark's
plain reference decoder (benchmark/reference/decoder.py: one full forward
over prompt and response in float32). Also: config_from_hf_dict on the
benchmark's Falcon3-7B configuration; forked siblings against their leader;
per-row `max_new_tokens` and `temperature` in DynamicSamplingScheduler, a
row without them sampled exactly as before; the scheduler's spans and
counters; kernel 3's counter names.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from socioreasoner_tpu_torch.configs import worker_config as t_wc
from socioreasoner_tpu_torch.generation import engine as t_engine
from socioreasoner_tpu_torch.generation.engine import DecodeEngine, Request
from socioreasoner_tpu_torch.generation.sampling import SamplingParams
from socioreasoner_tpu_torch.models.llm import config_from_hf_dict
from socioreasoner_tpu_torch.ops import decode_attention as t_dec
from socioreasoner_tpu_torch.protocol import BatchProto
from socioreasoner_tpu_torch.runtime import generate_scheduler as t_sched
from socioreasoner_tpu_torch.utils import profiling

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import decoder as ref_decoder  # noqa: E402
import weights as bench_weights  # noqa: E402

FALCON3 = json.loads((BENCH / "configs" / "falcon3_7b.json").read_text())
TINY = dict(FALCON3, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=3, num_key_value_heads=1, vocab_size=300,
            bos_token_id=1, eos_token_id=2)
# float32 on both sides over two layers: the two differ only in the order of
# their sums (the engine's batched matmuls and cached attention against the
# reference's one sequence), ~1e-6 of logits ~0.3 wide
LOGIT_TOL = 1e-4


def test_config_from_hf_dict_reads_falcon3_widths():
    cfg = config_from_hf_dict(FALCON3)
    t = cfg.text
    assert (t.hidden_size, t.intermediate_size, t.num_hidden_layers) == (3072, 23040, 28)
    assert (t.num_attention_heads, t.num_key_value_heads, t.head_dim) == (12, 4, 256)
    assert (t.vocab_size, t.rope_theta, t.rms_norm_eps) == (131072, 1000042, 1e-6)
    assert t.mrope_section == (128, 0, 0)
    assert not t.tie_word_embeddings and not t.attention_bias and not t.use_qk_norm
    assert not t.n_experts
    assert cfg.eos_token_id == 11
    tree = bench_weights.text_weights(TINY, 0, "cpu", dtype=torch.float32)
    assert tree["layers"]["q_w"].shape == (2, 128, 3 * 256)
    assert tree["layers"]["k_w"].shape == (2, 128, 256)
    assert tree["lm_head"].shape == (128, 300)
    assert not tree["layers"]["q_b"].any()


def _engine(tree, **kw):
    kw = dict(dict(max_slots=4, max_len=96, decode_chunk=4, prefill_buckets=(16, 32, 64),
                   cache_dtype=torch.float32, device="cpu", prefix_fork=True), **kw)
    return DecodeEngine(config_from_hf_dict(TINY), tree, **kw)


def _recording_sampler(monkeypatch):
    """Every logits block the engine samples from, (rows, vocab) float32:
    the prefill's rows, then each decode step's slots."""
    seen = []
    real = t_engine.sample_tokens

    def sample(logits, *a, **k):
        seen.append(logits.detach().float().clone())
        return real(logits, *a, **k)
    monkeypatch.setattr(t_engine, "sample_tokens", sample)
    return seen


def _reference_logits(tree, ids):
    hid = ref_decoder.decoder_hidden(TINY, tree, torch.as_tensor(ids),
                                     torch.arange(len(ids)))
    head = ref_decoder.head_weight(tree)
    return torch.cat([lg for _, lg in ref_decoder.logits_blocks(hid, head)])


def _greedy(n):
    return SamplingParams(temperature=1e-5, do_sample=False, max_new_tokens=n)


def test_engine_prefill_then_cached_decode_matches_the_reference(monkeypatch):
    tree = bench_weights.text_weights(TINY, 7, "cpu", dtype=torch.float32)
    seen = _recording_sampler(monkeypatch)
    prompt = [int(t) for t in np.random.default_rng(3).integers(3, 300, 13)]
    eng = _engine(tree)
    out, = eng.generate([Request(request_id="a", prompt_ids=prompt, sampling=_greedy(11))])
    assert len(out.output_ids) == 11 and out.finish_reason == "length"
    assert eng.steps_executed == 10 and eng.prefill_rows == 1
    # the prefill samples row 0; the request holds slot 0 in every step
    got = torch.stack([lg[0] for lg in seen])
    want = _reference_logits(tree, prompt + out.output_ids[:-1])[len(prompt) - 1:]
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= LOGIT_TOL
    assert out.output_ids == want.argmax(-1).tolist()


def test_forked_siblings_decode_as_their_leader(monkeypatch):
    tree = bench_weights.text_weights(TINY, 8, "cpu", dtype=torch.float32)
    seen = _recording_sampler(monkeypatch)
    prompt = [int(t) for t in np.random.default_rng(4).integers(3, 300, 21)]
    eng = _engine(tree)
    outs = eng.generate([Request(request_id=j, prompt_ids=prompt, sampling=_greedy(9))
                         for j in range(3)])
    assert eng.prefill_rows == 1 and eng.forked_requests == 2
    assert outs[1].output_ids == outs[0].output_ids == outs[2].output_ids
    # the leader (slot 0) samples its first token in the prefill; a fork
    # (slots 1, 2) rewrites the prompt's last row in its first decode step
    # and samples its first token there, one step behind its leader
    leader = torch.stack([seen[0][0]] + [lg[0] for lg in seen[1:9]])
    siblings = [torch.stack([lg[s] for lg in seen[1:10]]) for s in (1, 2)]
    assert torch.equal(siblings[0], siblings[1])          # one step, the same cache
    assert (siblings[0] - leader).abs().max().item() <= LOGIT_TOL
    want = _reference_logits(tree, prompt + outs[0].output_ids[:-1])[len(prompt) - 1:]
    assert (leader - want).abs().max().item() <= LOGIT_TOL


# ------------------------------------------------- per-row sampling

def test_row_sampling_takes_the_rows_own_keys():
    args = t_wc.GeneratingArguments(max_new_tokens=64, temperature=0.99, top_p=0.99,
                                    top_k=100, num_return_sequences=8)
    sp = SamplingParams.from_generating_args(args)
    assert t_sched.row_sampling(sp, {"prompt_ids": [1]}, args) is sp
    own = t_sched.row_sampling(sp, {"max_new_tokens": 1536, "temperature": 0.0}, args)
    assert (own.max_new_tokens, own.do_sample, own.top_k, own.top_p) == (1536, False, 100, 0.99)
    warm = t_sched.row_sampling(sp, {"temperature": 0.5}, args)
    assert (warm.temperature, warm.do_sample, warm.max_new_tokens) == (0.5, True, 64)


class _EchoWorker:
    """A decode worker that answers each request at once with
    max_new_tokens copies of its first prompt token, recording its
    sampling."""

    def __init__(self):
        self.sampling = {}

    def start_server(self):
        pass

    def stop_server(self):
        pass

    def add_request(self, command, data):
        if command.name == "ADD":
            sp = data["sampling"]
            self.sampling[data["request_id"]] = sp
            data["callback"](SimpleNamespace(
                request_id=data["request_id"], finish_reason="length",
                output_ids=[data["prompt_ids"][0]] * sp.max_new_tokens))
        return {"alive": True}


def _collate(rows):
    P = 8
    ids = np.zeros((len(rows), P), np.int64)
    attn = np.zeros_like(ids)
    for i, r in enumerate(rows):
        ids[i, P - len(r["prompt_ids"]):] = r["prompt_ids"]
        attn[i, P - len(r["prompt_ids"]):] = 1
    return BatchProto.from_dict(tensors={"input_ids": ids, "attention_mask": attn},
                                meta={"pad_token_id": 0})


def test_scheduler_serves_each_rows_own_sampling_and_records_its_spans():
    rows = [{"prompt_ids": [5, 6, 7], "max_new_tokens": 4, "temperature": 0.0},
            {"prompt_ids": [8, 9], "max_new_tokens": 6},
            {"prompt_ids": [10, 11, 12, 13]}]
    worker = _EchoWorker()
    cluster = SimpleNamespace(workers=[worker], start_server=lambda: None,
                              stop_server=lambda: None)
    rewards = []

    def reward(texts, rs):
        rewards.append(len(texts))
        return {"response_level_rewards": np.zeros(len(texts), np.float32)}
    sched = t_sched.DynamicSamplingScheduler(
        cluster, _collate, reward_fns={"math": reward}, is_use_additional_prompts=False,
        max_running_requests=4, max_additional_running_prompts=0)
    args = t_wc.GeneratingArguments(max_new_tokens=3, temperature=0.99, top_p=0.99,
                                    top_k=100, num_return_sequences=2)
    with profiling.recording() as rec:
        batch = sched.get_batch(iter(rows), 3, args)
    sp = SamplingParams.from_generating_args(args)
    got = worker.sampling
    assert got[(0, 0, 0)] == got[(0, 1, 0)] == SamplingParams(
        temperature=1e-5, top_p=0.99, top_k=100, max_new_tokens=4, do_sample=False)
    assert got[(1, 0, 0)] == SamplingParams(temperature=0.99, top_p=0.99, top_k=100,
                                            max_new_tokens=6, do_sample=True)
    assert got[(2, 0, 0)] is sp or got[(2, 0, 0)] == sp
    out = batch.meta["output"]
    assert out.shape == (6, 8 + 6)
    assert [int((r[8:] != 0).sum()) for r in out] == [4, 4, 6, 6, 3, 3]
    assert rewards == [2, 2, 2]
    ev = rec.events()
    groups = [e for e in ev if e["name"] == "rollout.group"]
    batch_span, = [e for e in ev if e["name"] == "rollout.batch"]
    assert [(g["attrs"]["n"], g["attrs"]["prompt_len"], g["attrs"]["tokens"])
            for g in groups] == [(2, 3, 8), (2, 2, 12), (2, 4, 6)]
    assert all(g["parent"] == batch_span["id"] for g in groups)
    assert sum(e["name"] == "rollout.reward" for e in ev) == 3
    assert rec.counters() == {"groups_done": 3, "responses_done": 6}


def test_counters_are_off_outside_recording():
    profiling.count("groups_done")
    with profiling.recording() as rec:
        profiling.count("groups_done", 2)
        profiling.count("responses_done")
    profiling.count("groups_done")
    assert rec.counters() == {"groups_done": 2, "responses_done": 1}


@pytest.mark.parametrize("quant,D,n_split,name", [
    (False, 256, 1, "k3.bf16_256.split1"), (True, 256, 2, "k3.int8_256.split2"),
    (False, 128, 8, "k3.bf16_128.split8"), (False, 512, 1, "k3.bf16_sliced.split1")])
def test_kernel3_counter_names_its_instance_and_split(quant, D, n_split, name):
    plan = t_dec.DecodePlan(quant, 128, 12, 4, D, 3328, n_split, 28, [0] * 14, (0, 0))
    assert plan.counter == name


@pytest.mark.cuda
def test_cuda_replayed_steps_count_kernel3_by_instance():
    """On the card a decode step is a captured graph's replay: the replays
    add their recorded kernel-3 calls to the instance counter, so over the
    recording it reads layers x decode steps, as the launches do."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode step is captured as a CUDA graph")
    dev = torch.device("cuda")
    tree = bench_weights.text_weights(TINY, 9, dev)
    eng = DecodeEngine(config_from_hf_dict(TINY), tree, max_slots=4, max_len=192,
                       decode_chunk=8, prefill_buckets=(32, 64), device=dev)
    prompt = [int(t) for t in np.random.default_rng(5).integers(3, 300, 40)]
    n0 = t_dec.paged_decode_attention.launches
    with profiling.recording() as rec:
        eng.generate([Request(request_id=j, prompt_ids=prompt, sampling=_greedy(30))
                      for j in range(3)])
    layers = TINY["num_hidden_layers"]
    assert eng.graph_steps > 0 and eng.graph_captures == 1
    assert t_dec.paged_decode_attention.launches - n0 == layers * eng.steps_executed
    n = t_dec.split_count(4, 1, eng.Lalloc, t_dec._sm_count(dev.index or 0))
    got = {k: v for k, v in rec.counters().items() if k.startswith("k3.")}
    assert got == {f"k3.bf16_256.split{n}": layers * eng.steps_executed}
