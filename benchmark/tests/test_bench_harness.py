"""The benchmark's own checks that need no card: the count functions
against hand-worked shapes, the result line, BENCHMARK.json against its
character and range rules, every file found by name, the
traffic generator's repeatability, and the import rules.

    python3 -m pytest benchmark/tests -q
"""

import ast
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(REPO)]

import generator  # noqa: E402
import harness  # noqa: E402
import peaks  # noqa: E402

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "socioreasoner_tpu"}


# ------------------------------------------------------------------ counts

def test_peaks_and_pairs_hand_worked():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 989e12) == pytest.approx(1.0)
    assert peaks.bound(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")
    assert peaks.seg_pairs([0, 0, 1, 1, 1]) == 4 + 9
    assert peaks.causal_pairs(3, [3]) == 1 + 2 + 3
    assert peaks.causal_pairs(3, [2]) == 1 + 2 + 2
    assert peaks.prefix_causal_pairs(4) == 10


def test_kernel_counts_hand_worked():
    shape = {"heads": 2, "kv_heads": 1, "head_dim": 8, "layers": 1, "cache_bytes": 2}
    k3 = harness.count_module("k3")
    # one slot of 3 cached tokens, 2 steps: 4 then 5 keys
    flops, nbytes = k3.work([{"kv0": [3], "steps": 2}], shape)
    assert flops == 4 * 2 * 8 * 9
    assert nbytes == 9 * 1 * 8 * 2 * 2 + 2 * (2 * 8 * 2 * 2)
    assert k3.work([{"kv0": [3], "steps": 2}], dict(shape, layers=3)) == (3 * flops, 3 * nbytes)
    k1 = harness.count_module("k1")
    recs = [{"tokens": 4, "pairs": 8, "heads": 2, "head_dim": 4},
            {"tokens": 4, "pairs": 16, "heads": 2, "head_dim": 4}]
    assert k1.work(recs, {}) == (4 * 2 * 4 * (8 + 16), 2 * 4 * 4 * 2 * 4 * 2)
    assert (k1.RECORDS, k3.RECORDS) == ("vit", "decode")


def test_kernel_names_match():
    k1, k3 = (harness.count_module(k) for k in ("k1", "k3"))
    seg = "void attention_sm90_kernel<80, true, false>(FwdParams)"
    gqa = "void attention_sm90_kernel<128, false, false>(FwdParams)"
    dec = "void socio_decode::paged_decode_kernel<__nv_bfloat16, 128, false>(DecodeArgs)"
    assert k1.match(seg) and not k1.match(gqa) and not k1.match(dec)
    assert k1.match("void attention_sm90_sliced_kernel<true>(FwdParams)")
    assert k3.match(dec) and not k3.match(gqa) and not k3.match(seg)


def test_model_flops_hand_worked():
    model = harness.count_module("model")
    shape = {"hidden": 4, "heads": 2, "kv_heads": 1, "head_dim": 2, "intermediate": 8,
             "layers": 1, "vocab": 10}
    body, head = model.matmul_params(shape)
    assert body == 4 * (2 + 2) * 2 + 2 * 2 * 4 + 3 * 4 * 8 and head == 40
    one = model.flops({"decode": [{"kv0": [2], "steps": 1}]}, shape)
    assert one == 2.0 * (body + head) + 4.0 * 2 * 2 * 3


# ------------------------------------------------------------- result line

def test_result_line_keys_and_order():
    line = harness.result_line(correct=True, attempted=3, failed=0,
                               metrics={"setup_s": {"value": 1.5, "unit": "s"}},
                               device={"platform": "gpu", "kind": "x", "count": 1,
                                       "memory_peak_bytes": 1},
                               checks={"served_gap_max": {"value": 0.1, "limit": 0.5,
                                                          "ok": True}},
                               breakdown={"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device",
                         "breakdown", "checks"]
    assert "\n" not in line


# ----------------------------------------------------------- BENCHMARK.json

def test_benchmark_json_keeps_its_rules():
    spec = SPEC
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"][:2] == ["python3", "benchmark/run.py"] and len(spec["command"]) <= 32
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and (REPO / p).is_dir()
        assert not p.startswith("/") and ".." not in p
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for group in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[group]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in spec["workloads"])
    four = 0
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert four <= max(1, len(spec["workloads"]) // 4)
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in spec["workloads"]:
        got = harness.cell_metrics(spec, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert harness.cell_metrics(spec, w["name"], "per_layer")
        for m in harness.cell_metrics(spec, w["name"], "per_layer"):
            assert m["moves"] in {x["name"] for x in got}
    assert len(json.dumps(spec)) <= 64 * 1024


def test_each_cell_finds_its_files_by_name():
    for w in SPEC["workloads"]:
        cfg = harness.config_file(SPEC, w["config"])
        assert cfg["source"] == harness.find_config(SPEC, w["config"])["source"]
        assert set(cfg["reduced"]) == set(harness.find_config(SPEC, w["config"])["reduced"])
        tr = harness.traffic_file(w["traffic"])
        assert hasattr(harness.entry_module(tr["entry"]), "run")
        limits = harness.load_json(BENCH / "limits" / f"{w['name']}.json")
        assert all("limit" in v for v in limits.values())
        for m in harness.cell_metrics(SPEC, w["name"], "per_layer"):
            assert callable(harness.metric_reader(m["name"]).read)
    for k in ("k1", "k3"):
        mod = harness.count_module(k)
        assert callable(mod.match) and callable(mod.work)


def test_readers_return_nothing_without_a_trace():
    from types import SimpleNamespace
    run = SimpleNamespace(slice=None, shape={}, counters={}, slice_counts={}, work={}, e2e={})
    for m in SPEC["per_layer"]:
        if m["source"] == "device_trace":
            assert harness.metric_reader(m["name"]).read(run) is None


def test_idle_and_mfu_divide_by_the_untraced_wall():
    from types import SimpleNamespace
    import readers
    sl = SimpleNamespace(window_s=4.0, busy_s=1.0, kernels=[("k", 0.0, 1.0)])
    shape = {"hidden": 4, "heads": 2, "kv_heads": 1, "head_dim": 2, "intermediate": 8,
             "layers": 1, "vocab": 10}
    work = {"decode": [{"kv0": [2], "steps": 1}]}
    run = SimpleNamespace(slice=sl, shape=shape, work=work, untraced_wall_s=2.0)
    # the traced slice's own 4 s of wall is not the denominator
    assert readers.idle_share(run) == pytest.approx(50.0)
    flops = harness.count_module("model").flops(work, shape)
    assert readers.mfu(run) == pytest.approx(100.0 * flops / (2.0 * peaks.BF16_FLOP_PER_S))
    run.untraced_wall_s = None
    assert readers.idle_share(run) is None and readers.mfu(run) is None
    run.slice_counts = {"tiles": 4}
    assert readers.device_s_per_unit(run, "tiles") == pytest.approx(0.25)
    assert readers.device_s_per_unit(run, "requests") is None


# ----------------------------------------------------------------- traffic

def test_tile_chunks_repeat_by_seed():
    tr = dict(harness.traffic_file("socioseg_infer"), tile_px=56, tiles_per_chunk=3)
    one = next(generator.tile_chunks(tr, 99))
    two = next(generator.tile_chunks(tr, 99))
    other = next(generator.tile_chunks(tr, 100))
    for x, y in zip(one, two):
        assert all(np.array_equal(x[k], y[k]) for k in ("map", "sat", "mask"))
        assert x["question"] == y["question"]
    assert not np.array_equal(one[0]["map"], other[0]["map"])
    assert len(one) == 3 and one[0]["map"].shape == (56, 56, 3)


def test_generator_takes_large_seeds():
    assert generator.rng_for(2**40 + 3, 1).integers(0, 10) >= 0
    assert generator.rng_for(-5, 1).integers(0, 10) >= 0


# ----------------------------------------------------------------- imports

def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_nothing_under_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        bad = set(_top_imports(f)) & FORBIDDEN
        assert not bad, f"{f}: {bad}"
    # compared whole: the port's name begins with the JAX package's
    assert "socioreasoner_tpu_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        bad = set(_top_imports(f)) & (FORBIDDEN | {"socioreasoner_tpu_torch"})
        assert not bad, f"{f}: {bad}"


def test_a_run_refuses_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "socioreasoner_tpu.protocol", object())
    assert harness.forbidden_modules() == ["socioreasoner_tpu.protocol"]


def test_run_exits_without_a_card(monkeypatch, capsys):
    import torch
    import run as bench_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = SPEC["workloads"][0]["name"]
    rc = bench_run.main(["--workload", cell, "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no result" in out.err


# ----------------------------------------------------------------- tracing

def test_trace_reduction_hand_worked(tmp_path):
    import tracing
    sl = tracing.TraceSlice(host=False)
    base_ns = 1_000_000_000
    sl.t0_ns, sl.t1_ns = base_ns + 0, base_ns + 100_000     # a 100 us slice
    sl.spans = [("engine.step", base_ns + 10_000, base_ns + 60_000)]
    events = [{"ph": "X", "cat": "kernel", "name": "k_a", "ts": 0.0, "dur": 20.0},
              {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 10.0, "dur": 20.0},
              {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 70.0, "dur": 10.0},
              {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 95.0, "dur": 10.0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events, "baseTimeNanoseconds": base_ns}))
    sl._read(str(path))
    assert sl.window_s == pytest.approx(100e-6)
    # union: [0, 30] + [70, 80] + [95, 100] (clipped) = 45 us
    assert sl.busy_s == pytest.approx(45e-6)
    gaps = sl.idle_gaps()
    assert [round(s * 1e6) for _, s in gaps] == [40, 15]
    assert gaps[0][0] == "engine.step" and gaps[1][0] == "host: outside the traced spans"
    assert sl.device_time(lambda n: n == "k_a") == (pytest.approx(40e-6), 3)
    bd = sl.breakdown()
    assert bd["device_ops"][0][0] == "k_a" and len(bd["idle_gaps"]) == 2
