"""The rollout cell's parts that need no card: kernel 2's count functions,
the per-layer readers of rlvr_rollout.falcon3_7b on synthetic slices and
span lists (each None without its slice, counters or spans, never 0), and
a whole run of the entry at a tiny Falcon3-shaped width on the CPU (set-up,
warm-up, window, result, the check against the reference), with the timed
path broken underneath, which the check has to catch.

    python3 -m pytest benchmark/tests -q
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(REPO)]

import harness  # noqa: E402
import run as bench_run  # noqa: E402

CELL = "rlvr_rollout.falcon3_7b"
CPU = torch.device("cpu")
SHAPE = {"heads": 2, "kv_heads": 1, "head_dim": 8, "layers": 2, "hidden": 4,
         "intermediate": 8, "vocab": 10, "cache_bytes": 2}


# ------------------------------------------------------------------ counts

def test_kernel2_counts_hand_worked():
    k2 = harness.count_module("k2")
    assert k2.RECORDS == "prefill"
    # rows of 3 and 1 tokens: 6 + 1 causal pairs; q, k, v read, o written
    flops, nbytes = k2.work([{"lens": [3, 1]}], SHAPE)
    assert flops == 2 * 4 * 2 * 8 * (6 + 1)
    assert nbytes == 2 * (3 + 1) * (2 * 2 + 2 * 1) * 8 * 2
    assert k2.work([], SHAPE) == (0.0, 0.0)


def test_kernel2_name_matches_the_prefill_kernel_alone():
    k2 = harness.count_module("k2")
    assert k2.match("void attention_sm90_kernel<256, false, false>(FwdParams)")
    assert k2.match("void attention_sm90_sliced_kernel<false>(FwdParams)")
    assert not k2.match("void attention_sm90_kernel<80, true, false>(FwdParams)")
    assert not k2.match("void socio_decode::paged_decode_kernel<__nv_bfloat16, 256, false>"
                        "(DecodeArgs)")


# ------------------------------------------------------------------ readers

class _Slice:
    """A traced slice's figures as tracing.TraceSlice gives them."""

    def __init__(self, kernels, window_s=1.0, busy_s=0.5):
        self.kernels, self.window_s, self.busy_s = kernels, window_s, busy_s

    def device_time(self, match):
        sel = [d for n, _, d in self.kernels if match(n)]
        return sum(sel) / 1e6, len(sel)

    def n_kernels(self):
        return len(self.kernels)


def _run(**kw):
    base = dict(slice=None, shape=SHAPE, counters={}, slice_counts={}, work={},
                untraced_wall_s=None, spans=None, window_ns=None, e2e={})
    return SimpleNamespace(**dict(base, **kw))


def _reader(name):
    return harness.metric_reader(name).read


NEW = [m["name"] for m in harness.load_spec()["per_layer"] if CELL in m.get("workloads", [])]


def test_the_cell_reports_its_metrics():
    assert sorted(NEW) == sorted(["k3_roofline.rollout", "k2_roofline.rollout", "mfu.rollout",
                                  "slot_use.rollout", "group_s.rollout"])
    names = [m["name"] for m in harness.cell_metrics(harness.load_spec(), CELL, "end_to_end")]
    assert sorted(names) == ["setup_s", "tiles_per_s"]


@pytest.mark.parametrize("name", NEW)
def test_each_reader_finds_nothing_in_an_empty_run(name):
    assert _reader(name)(_run()) is None


def test_device_trace_readers_on_a_synthetic_slice():
    dec = "void socio_decode::paged_decode_kernel<__nv_bfloat16, 256, false>(DecodeArgs)"
    pre = "void attention_sm90_kernel<256, false, false>(FwdParams)"
    sl = _Slice([(dec, 0.0, 10.0), (dec, 20.0, 10.0), (pre, 40.0, 5.0)], busy_s=0.25)
    work = {"decode": [{"kv0": [3, 5], "steps": 2}], "prefill": [{"lens": [4]}]}
    run = _run(slice=sl, work=work, untraced_wall_s=0.5)
    k3 = harness.count_module("k3")
    f3, b3 = k3.work(work["decode"], SHAPE)
    assert _reader("k3_roofline.rollout")(run) == pytest.approx(
        100 * max(b3 / 3.35e12, f3 / 989e12) / 20e-6)
    f2, b2 = harness.count_module("k2").work(work["prefill"], SHAPE)
    assert _reader("k2_roofline.rollout")(run) == pytest.approx(
        100 * max(b2 / 3.35e12, f2 / 989e12) / 5e-6)
    flops = harness.count_module("model").flops(work, SHAPE)
    assert _reader("mfu.rollout")(run) == pytest.approx(100 * flops / (0.5 * 989e12))
    # a slice without prefill launches or records: kernel 2 has nothing to read
    assert _reader("k2_roofline.rollout")(_run(slice=_Slice([(dec, 0.0, 10.0)]),
                                               work={"decode": work["decode"]})) is None
    assert _reader("mfu.rollout")(_run(slice=sl, work=work)) is None    # no untraced wall


def test_slot_use_from_the_windows_counters():
    run = _run(counters={"decode_tokens": 96, "decode_steps": 1, "slots": 128})
    assert _reader("slot_use.rollout")(run) == pytest.approx(75.0)
    assert _reader("slot_use.rollout")(_run(counters={"decode_tokens": 0, "decode_steps": 0,
                                                      "slots": 128})) is None


def test_group_seconds_of_the_groups_completed_in_the_window():
    def ev(name, a, b):
        return {"name": name, "start_ns": int(a * 1e9), "end_ns": int(b * 1e9)}
    spans = [ev("rollout.group", 0, 12), ev("rollout.group", 5, 9), ev("rollout.group", 8, 30),
             ev("engine.step", 10, 11), ev("rollout.group", 2, 4)]
    run = _run(spans=spans, window_ns=(int(5e9), int(20e9)))
    assert _reader("group_s.rollout")(run) == pytest.approx((12 + 4) / 2)
    assert _reader("group_s.rollout")(_run(spans=spans[3:], window_ns=(int(5e9), int(20e9)))) \
        is None


# ----------------------------------------------------------- a tiny run

def tiny_context(seed=2**33 + 7, control=False, seconds=0.3, **traffic):
    """The rollout cell at a tiny width: Falcon3's head dim 256 at 3 / 1
    heads, 2 layers of hidden 128, a vocabulary of 300; 8 slots, groups of 2,
    prompts of 6-20 tokens, responses of 4-24."""
    spec = harness.load_spec()
    cell = harness.find_cell(spec, CELL)
    cfg = dict(harness.config_file(spec, cell["config"]), hidden_size=128,
               intermediate_size=256, num_hidden_layers=2, num_attention_heads=3,
               num_key_value_heads=1, vocab_size=300, bos_token_id=1, eos_token_id=2)
    tr = dict(harness.traffic_file(cell["traffic"]), rollout_batch_size=64,
              num_return_sequences=2, max_running_requests=8,
              max_additional_running_prompts=4, prompt_median=10, prompt_min=6,
              prompt_max=20, response_median=12, response_min=4, response_max=24,
              token_min=3, greedy_every=3, greedy_min_response=16, decode_chunk=4,
              prefill_buckets=[16, 32], warm_groups=3)
    tr.update(traffic)
    return bench_run.cell_context(CELL, seed=seed, seconds=seconds, trace=False, device=CPU,
                                  spec=spec, config=cfg, traffic=tr, control=control)


def tiny_rollout(**kw):
    return bench_run.run_cell(tiny_context(**kw))


def test_tiny_rollout_run_is_correct_and_reports_its_metrics():
    out = tiny_rollout()
    line = json.loads(harness.result_line(
        correct=out["correct"], attempted=out["attempted"], failed=out["failed"],
        metrics=out["metrics"], device=out["device"], checks=out["checks"]))
    assert line["correct"], out["checks"]
    assert set(line["metrics"]) == {"tiles_per_s", "setup_s"}
    got = out["readings"]
    assert got["gen_tokens_per_s"] > 0
    assert line["metrics"]["tiles_per_s"]["value"] == pytest.approx(
        got["gen_tokens_per_s"] / got["mean_group_tokens"])
    assert got["judged_requests"] >= 2 and got["served_gap_max"] < 1e-3
    assert got["served_gap_mean"] <= got["served_gap_max"]
    assert got["greedy_cut"] >= 1        # greedy requests in a slot at the close are checked too
    assert set(out["checks"]) == {"served_gap_max", "served_gap_mean"}
    assert got["window_counts"]["forked_requests"] > 0
    assert got["fork_share"] == pytest.approx(0.5, abs=0.2)      # n = 2: one of two forks


def test_a_broken_timed_path_comes_out_incorrect(monkeypatch):
    """A token altered where it is produced: the sampler's ids shifted by one."""
    from socioreasoner_tpu_torch.generation import engine as eng
    real = eng.sample_tokens
    monkeypatch.setattr(eng, "sample_tokens",
                        lambda logits, *a, **k: (real(logits, *a, **k) + 1) % logits.shape[-1])
    out = tiny_rollout()
    assert not out["correct"], out["checks"]
    for name in ("served_gap_max", "served_gap_mean"):
        assert out["checks"][name]["value"] > out["checks"][name]["limit"]


def test_the_control_is_judged_in_the_programs_place():
    out = tiny_rollout(control=True)
    got = out["readings"]
    for stat in ("max", "mean"):
        check = out["checks"][f"served_gap_{stat}"]
        assert check["value"] == got[f"control_gap_{stat}"]
        assert got[f"served_gap_{stat}"] <= check["limit"]
    assert out["correct"] == all(c["ok"] for c in out["checks"].values())


@pytest.mark.parametrize("greedy_every", [16, 3])
def test_mean_group_tokens_is_what_the_rows_draw(greedy_every):
    """tiles_per_s divides by the mean tokens a group samples: the drawn
    caps of many rows average to it, whatever the seed."""
    rollout = harness.entry_module("rlvr_rollout")
    tr = dict(harness.traffic_file(harness.find_cell(harness.load_spec(), CELL)["traffic"]),
              prompt_median=8, prompt_min=4, prompt_max=16, greedy_every=greedy_every)
    n = int(tr["num_return_sequences"])
    expect = rollout.mean_group_tokens(tr)
    for seed in (7, 2**31 + 11):
        it = rollout.rows(tr, 2 * tr["token_min"], seed)
        drawn = [n * next(it)["max_new_tokens"] for _ in range(20000)]
        assert sum(drawn) / len(drawn) == pytest.approx(expect, rel=0.01)


def test_the_window_goes_on_past_a_filled_batch():
    """A window that outlasts one get_batch: the next batch follows (the
    first one's end aborts what it still holds), and the run is judged as
    one window."""
    out = tiny_rollout(seconds=3.0, rollout_batch_size=4, max_additional_running_prompts=2)
    got = out["readings"]
    assert got["batches_filled"] >= 1
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert got["window_counts"]["groups_done"] > 4


class _HostSlice:
    """A traced slice without the profiler (a CPU run has no device to
    trace): it keeps the spans the entry hands it."""

    kernels, spans, window_s, busy_s = [], [], 0.0, 0.0

    def __init__(self):
        self.spans = []

    def start(self):
        self.t0_ns = __import__("time").time_ns()
        self.started = True

    def stop(self):
        self.stopped = True


def test_the_traced_slice_holds_an_admission_and_its_untraced_wall():
    ctx = tiny_context(seconds=1.5, trace_lead_s=0.5)
    ctx.slice = _HostSlice()
    res = harness.entry_module("rlvr_rollout").run(ctx)
    assert ctx.slice.started and ctx.slice.stopped
    reader = res["reader"]
    assert reader["slice_counts"]["decode_steps"] > 0
    assert reader["work"]["prefill"] and all(r["lens"] for r in reader["work"]["prefill"])
    assert sum(r["steps"] for r in reader["work"]["decode"]) == \
        reader["slice_counts"]["decode_steps"]
    assert reader["untraced_wall_s"] > 0
    names = {n.split(":", 1)[1] for n, _, _ in ctx.slice.spans}
    assert {"engine.step", "engine.prefill", "engine.decode"} <= names
    assert res["checks"]["served_gap_max"]["ok"]
