"""The harness's path on the CPU at a tiny size, with the port's plain
attention route: a whole run of the entry (set-up, warm-up, window,
result, the comparison with the reference), the same run with the timed
path broken underneath, which the comparison has to catch, and with the
control put in the program's place.

    python3 -m pytest benchmark/tests -q
"""

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(REPO)]

import harness  # noqa: E402
import run as bench_run  # noqa: E402

CPU = torch.device("cpu")


def tiny_infer(seed=2**33 + 5, control=False, seconds=0.5):
    """The infer cell at a tiny width: a 2-layer decoder of hidden 1024
    (logits spread like the full model's) and a 4-block ViT, 4 tiles of
    224 px a chunk, 8 tokens a stage, the tiny SAM2."""
    spec = harness.load_spec()
    cell = next(w for w in spec["workloads"] if w["traffic"] == "socioseg_infer")
    cfg = harness.config_file(spec, cell["config"])
    cfg.update(hidden_size=1024, intermediate_size=2048, num_hidden_layers=2,
               num_attention_heads=8, num_key_value_heads=2,
               rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]})
    cfg["vision_config"] = dict(cfg["vision_config"], depth=4, hidden_size=64,
                                intermediate_size=128, num_heads=4, out_hidden_size=1024,
                                fullatt_block_indexes=[1, 3])
    tr = dict(harness.traffic_file(cell["traffic"]), tiles_per_chunk=4, tile_px=224,
              min_pixels=3136, response_length=8, infer_batch_size=4, sam2="tiny_test",
              chunks_prepared=2, greedy_every=2, check_tiles=2)
    ctx = bench_run.cell_context(cell["name"], seed=seed, seconds=seconds, trace=False,
                                 device=CPU, spec=spec, config=cfg, traffic=tr,
                                 control=control)
    return bench_run.run_cell(ctx)


def _line(out):
    return json.loads(harness.result_line(
        correct=out["correct"], attempted=out["attempted"], failed=out["failed"],
        metrics=out["metrics"], device=out["device"], checks=out["checks"]))


def test_tiny_infer_run_is_correct_and_reports_its_metrics():
    out = tiny_infer()
    line = _line(out)
    assert line["correct"], out["checks"]
    assert set(line["metrics"]) == {"tiles_per_s", "setup_s"}
    assert line["metrics"]["tiles_per_s"]["value"] > 0
    assert out["readings"]["judged_requests"] >= 2
    assert out["checks"]["prompt_mismatch"]["value"] == 0
    assert list(line)[-1] == "checks"


def _altered_tokens(monkeypatch):
    """A token altered where it is produced: the sampler's ids shifted by one."""
    from socioreasoner_tpu_torch.generation import engine as eng
    real = eng.sample_tokens
    monkeypatch.setattr(eng, "sample_tokens",
                        lambda logits, *a, **k: (real(logits, *a, **k) + 1) % logits.shape[-1])


def _stale_cache(monkeypatch):
    """A step that returns its state unchanged: each prefill writes its rows
    into a copy of the slots' caches, so the slots keep what they held."""
    from socioreasoner_tpu_torch.generation.engine import DecodeEngine
    real = DecodeEngine._prefill

    def prefill(self, *a, **k):
        kept = self.caches
        self.caches = {n: t.clone() for n, t in kept.items()}
        try:
            return real(self, *a, **k)
        finally:
            self.caches = kept
    monkeypatch.setattr(DecodeEngine, "_prefill", prefill)


@pytest.mark.parametrize("fault", [_altered_tokens, _stale_cache])
def test_a_broken_timed_path_comes_out_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    out = tiny_infer()
    assert not out["correct"], out["checks"]
    assert out["checks"]["served_gap_max"]["value"] > out["checks"]["served_gap_max"]["limit"]


def _one_bit(group=128):
    """A control far below int4: each weight's sign times its column's mean
    magnitude. At this tiny size int4 rounds too little to move a greedy
    token, so the test takes a coarser one to see the control fail."""
    def fn(name, w):
        if w.dim() < 2 or name.endswith("_ln") or name.endswith("_b"):
            return w
        wf = w.float()
        return torch.sign(wf) * wf.abs().mean(dim=-2, keepdim=True)
    return fn


@pytest.mark.parametrize("coarse", [False, True])
def test_the_control_is_judged_in_the_programs_place(monkeypatch, coarse):
    from reference import compare
    if coarse:
        monkeypatch.setattr(compare, "int4_groups", _one_bit)
    out = tiny_infer(control=True)
    check, got = out["checks"]["served_gap_max"], out["readings"]
    assert check["value"] == got["control_gap_max"]
    assert got["served_gap_max"] <= check["limit"]
    assert out["correct"] == (got["control_gap_max"] <= check["limit"])
    if coarse:
        assert not out["correct"], out["checks"]
