"""The readings that a cell's correctness limits are set from.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,... --seconds <s>

Runs the cell once a seed in this one process (a short window at the
cell's own load and sizes) with the control put in the program's place:
the plain reference one precision below the configuration's (int8 weights
for a bf16 model, int4 for an int8 one, products in bf16). Each seed's
line gives `correct`, the control's verdict under the cell's limits, which
has to come out false, and the readings: the program's own number beside
the control's. A limit lies above the largest program reading and below
the smallest control reading (PERF.md gives both). Needs the CUDA device;
the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

import run as bench_run  # noqa: E402


def readings(cell: str, seeds, seconds: float, device):
    import gc
    import torch
    torch.cuda.set_device(device)
    for seed in seeds:
        torch.cuda.reset_peak_memory_stats(device)
        ctx = bench_run.cell_context(cell, seed=seed, seconds=seconds, trace=False,
                                     device=device, control=True)
        out = bench_run.run_cell(ctx)
        yield {"seed": seed, "correct": out["correct"], "readings": out["readings"],
               "checks": out["checks"], "metrics": out["metrics"]}
        del ctx, out
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for r in readings(args.workload, [int(s) for s in args.seeds.split(",")],
                      args.seconds, dev):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
