"""The port's host spans (utils/profiling.py): the switch, the records, and
the spans of the serving path.

The recorder: nothing recorded and no clock read while it is off; parents
by thread; spans opened on one thread and closed on another; epoch
nanoseconds through the anchor; many threads at once. The engine and
server: Σ engine.decode steps against steps_executed, decode_tokens
against the tokens decode made, one request.wait a request under the span
open at its receipt, why each admission group ended, one server.idle a
stretch. The overlapped two-stage pipeline: one pipeline.restage_group a
group, each holding its vision.embeds. On the card: a span brackets the
kernel it waits for, on the device trace's clock.
"""

import json
import math
import sys
import threading
import time

import numpy as np
import pytest
import torch

from socioreasoner_tpu_torch.generation import engine as t_engine
from socioreasoner_tpu_torch.generation.sampling import SamplingParams
from socioreasoner_tpu_torch.generation.server import GenerateRequestType, GenerateServer
from socioreasoner_tpu_torch.models.qwen2_5_vl import model as t_model
from socioreasoner_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def tiny():
    config = Qwen25VLConfig.tiny()
    params = t_model.init_params(config, torch.Generator().manual_seed(0), device="cpu")
    return config, params


def _engine(tiny, **kw):
    config, params = tiny
    kw = {"max_slots": 2, "max_len": 64, "decode_chunk": 4, "prefill_buckets": (16, 32),
          "cache_dtype": torch.float32, **kw}
    return t_engine.DecodeEngine(config, params, **kw)


def _greedy(n):
    return SamplingParams(temperature=0.0, do_sample=False, max_new_tokens=n)


def _requests(specs):
    return [t_engine.Request(request_id=rid, prompt_ids=list(p), sampling=_greedy(m))
            for rid, p, m in specs]


def _named(events, name):
    return [e for e in events if e["name"] == name]


# ------------------------------------------------------------- the recorder
def test_off_path_records_nothing_and_reads_no_clock(tiny, monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read while recording is off")
    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert not profiling.active()
    assert profiling.span("x", a=1) is profiling.span("y")
    assert profiling.begin("x") is None
    with profiling.span("x") as sp:
        sp.set(a=2)
    engine = _engine(tiny)
    requests = _requests([(0, [5, 6, 7], 6), (1, [8, 9, 10, 11], 3)])
    outs = engine.generate(requests)
    assert [len(o.output_ids) for o in outs] == [6, 3]
    assert all(r.wait is None for r in requests)
    monkeypatch.undo()
    with profiling.recording() as rec:
        pass
    assert rec.events() == [] and rec.totals() == {}


def test_nesting_and_parents_by_thread():
    gate = threading.Barrier(2)

    def work(tag):
        with profiling.span(f"{tag}.outer", tag=tag) as outer:
            gate.wait(timeout=10)           # both threads hold an open span
            with profiling.span(f"{tag}.inner"):
                gate.wait(timeout=10)
            outer.set(done=True)

    with profiling.recording() as rec:
        threads = [threading.Thread(target=work, args=(t,), name=f"worker-{t}")
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
    ev = {e["name"]: e for e in rec.events()}
    assert set(ev) == {"a.outer", "a.inner", "b.outer", "b.inner"}
    for tag in ("a", "b"):
        outer, inner = ev[f"{tag}.outer"], ev[f"{tag}.inner"]
        assert outer["parent"] == 0 and inner["parent"] == outer["id"]
        assert outer["thread"] == inner["thread"] == f"worker-{tag}"
        assert outer["attrs"] == {"tag": tag, "done": True}
        assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]
    assert len({e["id"] for e in ev.values()}) == 4
    tot = rec.totals()
    assert set(tot) == set(ev) and all(n == 1 and s >= 0 for s, n in tot.values())


def test_begin_on_one_thread_close_on_another_and_the_switch():
    with profiling.recording() as rec:
        with profiling.span("submit") as submit:
            opened = profiling.begin("wait", request="r0")
        closer = threading.Thread(target=opened.close, kwargs={"slot": 3}, name="closer")
        closer.start()
        closer.join(timeout=10)
        late = profiling.begin("late")
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    late.close()                            # after the recording ended: dropped
    assert not profiling.active()
    ev = {e["name"]: e for e in rec.events()}
    assert set(ev) == {"submit", "wait"}
    assert ev["wait"]["parent"] == submit.sid and ev["wait"]["thread"] == "MainThread"
    assert ev["wait"]["attrs"] == {"request": "r0", "slot": 3}


def test_epoch_export_through_the_anchor():
    before = time.time_ns()
    with profiling.recording() as rec:
        p0 = time.perf_counter_ns()
        with profiling.span("sleep"):
            time.sleep(0.02)
        p1 = time.perf_counter_ns()
    after = time.time_ns()
    (e,) = rec.events()
    perf0, epoch0 = rec.anchor_ns
    assert before <= epoch0 <= after
    # the anchor maps the perf_counter stamps one to one
    assert p0 - perf0 <= e["start_ns"] - epoch0 <= e["end_ns"] - epoch0 <= p1 - perf0
    assert 0.02e9 <= e["end_ns"] - e["start_ns"] <= p1 - p0
    assert before <= e["start_ns"] and e["end_ns"] <= after + 1_000_000
    assert rec.totals()["sleep"][0] == pytest.approx((e["end_ns"] - e["start_ns"]) / 1e9)


def test_many_threads_lose_no_span():
    n_threads, n_spans = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            def work():
                for _ in range(n_spans):
                    with profiling.span("outer"):
                        with profiling.span("inner"):
                            pass
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    ev = rec.events()
    assert len(ev) == 2 * n_threads * n_spans
    assert len({e["id"] for e in ev}) == len(ev)
    by_id = {e["id"]: e for e in ev}
    for e in _named(ev, "inner"):
        parent = by_id[e["parent"]]
        assert parent["name"] == "outer" and parent["thread"] == e["thread"]
    assert rec.totals()["outer"][1] == n_threads * n_spans


# ------------------------------------------------------- engine and server
def test_engine_spans_match_its_counters(tiny):
    engine = _engine(tiny, max_slots=3)
    rng = np.random.default_rng(0)
    a, b = (rng.integers(2, 200, size=n).tolist() for n in (7, 12))
    specs = [("a0", a, 9), ("a1", a, 9), ("b", b, 5), ("c", [5, 6, 7], 12), ("d", b[:4], 2)]
    steps0, tokens0 = engine.steps_executed, engine.decode_tokens
    with profiling.recording() as rec:
        with profiling.span("test.submit") as submit:
            outs = engine.generate(_requests(specs))
    ev = rec.events()
    decode = _named(ev, "engine.decode")
    assert decode and sum(e["attrs"]["steps"] for e in decode) \
        == engine.steps_executed - steps0
    # a prefilled request's first token comes from its prefill; a fork's
    # first token from a decode step
    made = sum(len(o.output_ids) for o in outs) - engine.prefill_rows
    assert engine.decode_tokens - tokens0 == made and engine.forked_requests == 1
    waits = _named(ev, "request.wait")
    assert sorted(e["attrs"]["request"] for e in waits) == sorted(s[0] for s in specs)
    assert all(e["parent"] == submit.sid and e["thread"] == "MainThread" for e in waits)
    assert {e["attrs"]["how"] for e in waits} == {"prefill", "fork"}
    assert sum(e["attrs"]["B"] for e in _named(ev, "engine.prefill")) == engine.prefill_rows
    reads = _named(ev, "engine.prefill.read")
    assert len(reads) == len(_named(ev, "engine.prefill"))
    assert sum(e["attrs"]["pairs"] for e in _named(ev, "engine.fork")) == 1
    # every launch is one decode step; the per-step reads plus one download
    # a chunk (and the read that ends a chunk early) are the decode reads
    launches = _named(ev, "engine.decode.launch")
    assert len(launches) == engine.steps_executed - steps0
    # a CPU engine runs its steps eagerly: no replay, no capture
    assert all(e["attrs"] == {"replay": 0} for e in launches)
    assert len(_named(ev, "engine.decode.read")) >= len(launches) + len(decode)
    by_id = {e["id"]: e for e in ev}
    for e in launches:
        assert by_id[e["parent"]]["name"] == "engine.decode"
    assert by_id[decode[0]["parent"]]["name"] == "engine.step"
    for e in _named(ev, "engine.admit"):
        assert e["attrs"]["why"] in ("slots", "bucket", "image_budget", "queue_empty")
    assert rec.totals()["engine.step"][1] == len(_named(ev, "engine.step"))


def test_admission_groups_say_why_they_ended(tiny):
    engine = _engine(tiny, max_slots=2, prefix_fork=False)
    long = list(range(2, 22))                 # bucket 32; the rest bucket 16
    specs = [("s0", [5, 6], 2), ("s1", [7, 8], 2), ("s2", [9, 10], 2), ("l", long, 2),
             ("s3", [11, 12], 2)]
    with profiling.recording() as rec:
        engine.generate(_requests(specs))
    admits = [(e["attrs"]["rows"], e["attrs"]["why"], e["attrs"]["forks"])
              for e in _named(rec.events(), "engine.admit")]
    # two slots fill; the next short request goes alone (the long one has
    # another bucket); the long one takes the last free slot; the last
    # request empties the queue
    assert admits == [(2, "slots", 0), (1, "bucket", 0), (1, "slots", 0),
                      (1, "queue_empty", 0)]


def test_server_request_wait_parent_and_idle_stretches(tiny):
    engine = _engine(tiny)
    server = GenerateServer(engine)
    done = {}
    with profiling.recording() as rec:
        server.start()
        time.sleep(0.1)                      # idle: one span, not one a sleep
        with profiling.span("pipeline.submit") as submit:
            for i in range(3):
                server.add_request(GenerateRequestType.ADD, {
                    "request_id": ("s1", i, 0), "prompt_ids": [5 + i, 6, 7],
                    "sampling": _greedy(3),
                    "callback": lambda out: done.__setitem__(out.request_id, out)})
        deadline = time.time() + 60
        while len(done) < 3 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        server.stop()
    assert not server.is_alive() and len(done) == 3
    ev = rec.events()
    waits = _named(ev, "request.wait")
    assert sorted(e["attrs"]["request"] for e in waits) == [("s1", i, 0) for i in range(3)]
    assert all(e["parent"] == submit.sid and e["thread"] == "MainThread" for e in waits)
    idle = _named(ev, "server.idle")
    assert 2 <= len(idle) <= 4 and idle[0]["end_ns"] - idle[0]["start_ns"] >= 0.05e9
    assert all(e["thread"] == "generate-server" for e in idle + _named(ev, "engine.step"))
    # idle stretches and engine steps never overlap on the server thread
    spans = sorted((e["start_ns"], e["end_ns"]) for e in idle + _named(ev, "engine.step"))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


# ---------------------------------------------------------------- pipeline
def test_overlapped_pipeline_restage_groups_hold_their_vit(tmp_path):
    from socioreasoner_tpu_torch.configs.rlvr_config import SocioSegConfig
    from socioreasoner_tpu_torch.datasets import processor as t_processor
    from socioreasoner_tpu_torch.datasets import socioseg as t_seg
    from socioreasoner_tpu_torch.models.sam2 import model as t_sam
    from socioreasoner_tpu_torch.models.sam2.config import Sam2Config
    from socioreasoner_tpu_torch.pipeline.rlvr.socioseg_infer_pipeline import (
        SocioSegInferPipeline)
    from tests.test_torch_pipeline import ENGINE, IMG, VOCAB, _config, _tiles, _tokenizer

    n = 3
    config = Qwen25VLConfig.tiny(VOCAB)
    img = t_processor.ImageProcessorConfig(**IMG)
    pipe = SocioSegInferPipeline(
        _config(SocioSegConfig, str(tmp_path)), model_config=config,
        policy_params=t_model.init_params(config, torch.Generator().manual_seed(0),
                                          device="cpu"),
        sam_config=Sam2Config.tiny_test(),
        sam_params=t_sam.init_params(Sam2Config.tiny_test(),
                                     torch.Generator().manual_seed(1), device="cpu"),
        processor=t_processor.SocioProcessor(_tokenizer(t_processor.SimpleTokenizer), img,
                                             image_token_id=config.image_token_id),
        dataset=[], engine_kwargs={**ENGINE, "cache_dtype": torch.float32})
    rows = [t_seg.encode_sample(t, img) for t in _tiles(n)]
    group_size = max(2, min(8, n // 2))     # the overlapped path's default
    with profiling.recording() as rec:
        gious = pipe.evaluate_batch(rows)
    assert len(gious) == n
    ev = rec.events()
    by_id = {e["id"]: e for e in ev}
    (chunk,) = _named(ev, "pipeline.chunk")
    groups = _named(ev, "pipeline.restage_group")
    assert len(groups) == math.ceil(n / group_size)
    assert [g["attrs"]["group"] for g in groups] == list(range(len(groups)))
    assert sum(g["attrs"]["tiles"] for g in groups) == n
    vit = _named(ev, "vision.embeds")
    assert [by_id[v["parent"]]["name"] for v in vit] \
        == ["pipeline.submit_s1"] + ["pipeline.restage_group"] * len(groups)
    for g in groups:
        kids = {e["name"] for e in ev if e["parent"] == g["id"]}
        assert {"vision.embeds", "seg.segment", "pipeline.render",
                "pipeline.collate"} <= kids
        assert g["parent"] == chunk["id"]
    assert sum(e["attrs"]["tiles"] for e in _named(ev, "pipeline.segment_s2")) == n
    waits = _named(ev, "request.wait")
    assert len(waits) == 2 * n
    for w in waits:
        stage = w["attrs"]["request"][0]
        assert by_id[w["parent"]]["name"] == ("pipeline.submit_s1" if stage == "s1"
                                              else "pipeline.restage_group")
    assert {e["thread"] for e in _named(ev, "engine.decode")} == {"generate-server"}


# -------------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the span is held to a kernel on the device trace")
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_brackets_its_kernel_on_the_device_trace(cuda, tmp_path):
    """A span around torch.cuda._sleep and a synchronize, under device-only
    torch.profiler: the kernel's interval lies inside the span's epoch
    interval within 20 µs (the trace's ts plus baseTimeNanoseconds)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(cuda)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)        # the trace's first kernel, outside any span
        torch.cuda.synchronize(cuda)
        with profiling.recording() as rec:
            for _ in range(5):
                with profiling.span("sleep"):
                    torch.cuda._sleep(2_000_000)
                    torch.cuda.synchronize(cuda)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    kernels = sorted((ev["ts"] + base_us, ev["ts"] + ev["dur"] + base_us)
                     for ev in trace["traceEvents"]
                     if ev.get("ph") == "X" and ev.get("cat") == "kernel"
                     and ev["dur"] > 200)[1:]
    spans = sorted((e["start_ns"] / 1e3, e["end_ns"] / 1e3) for e in rec.events())
    print(f"span_kernel kernels {kernels} spans {spans}")
    assert len(kernels) == len(spans) == 5
    lead = [k0 - s0 for (k0, _), (s0, _) in zip(kernels, spans)]
    trail = [s1 - k1 for (_, k1), (_, s1) in zip(kernels, spans)]
    print(f"span_kernel_skew_us lead {[round(x, 2) for x in lead]} "
          f"trail {[round(x, 2) for x in trail]}")
    assert min(lead) >= -20 and min(trail) >= -20
