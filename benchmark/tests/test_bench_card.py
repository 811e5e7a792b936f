"""Checks that need the card (the `cuda` marker; each decides inside the
test and skips without one): at each cell's own sizes, the control (the
plain reference one precision below the configuration's) has to come out
not correct under the cell's limit on three seeds, while the program's own
readings stay within it.

    python3 -m pytest benchmark/tests -q -m cuda       # on the machine with the card
"""

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(REPO)]

import control  # noqa: E402
import harness  # noqa: E402

SEEDS = (2_900_000_001, 2_900_000_002, 2_900_000_003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_spec()["workloads"]])
def test_the_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    dev = torch.device("cuda", 0)
    limit = harness.load_json(BENCH / "limits" / f"{cell}.json")["served_gap_max"]["limit"]
    for r in control.readings(cell, SEEDS, 5.0, dev):
        print(json.dumps({k: r[k] for k in ("seed", "correct", "readings", "checks")}))
        assert not r["correct"], r
        assert r["checks"]["served_gap_max"]["value"] == r["readings"]["control_gap_max"] > limit, r
        assert r["readings"]["served_gap_max"] <= limit, r
