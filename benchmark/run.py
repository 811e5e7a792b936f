"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up, measures for --seconds, checks what the timed path
produced against the plain reference, and prints one JSON line as the last
line of standard output: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics read from a profiled steady slice of the
window. The numbers compared, each beside its limit, close standard error
and the result line. The cell, its configuration, its traffic mix and its
metrics are found by the names in BENCHMARK.json; nothing here names a
cell. Exits non-zero, printing no result, without the CUDA devices the cell
asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
if REPO not in sys.path:
    sys.path.insert(1, REPO)

import harness  # noqa: E402

T_PROCESS = harness.process_start_time()

# caches at fixed places inside the checkout (the port's kernel library
# builds into its own _build/ there); no library may pull in JAX
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(BENCH, "_cache", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BENCH, "_cache", "triton"))
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import json  # noqa: E402
from types import SimpleNamespace  # noqa: E402


def cell_context(cell_name: str, *, seed: int, seconds: float, trace: bool, device,
                 spec=None, config=None, traffic=None, limits=None, control=False):
    """Everything an entry needs to run one cell, found by name."""
    import tracing
    spec = spec or harness.load_spec()
    cell = harness.find_cell(spec, cell_name)
    if limits is None:
        limits = {k: v["limit"] for k, v in harness.load_json(
            harness.BENCH_DIR / "limits" / f"{cell_name}.json").items()}
    traffic = traffic or harness.traffic_file(cell["traffic"])
    return SimpleNamespace(
        spec=spec, cell=cell, seed=int(seed), seconds=float(seconds), trace=bool(trace),
        device=device, config=config or harness.config_file(spec, cell["config"]),
        traffic=traffic, limits=limits,
        slice=tracing.TraceSlice(host=bool(traffic.get("trace_host", True))) if trace else None,
        control=control)


def read_per_layer(ctx, res):
    """Each per-layer metric of the cell from its own reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    run = SimpleNamespace(slice=ctx.slice, **res["reader"], e2e=res["e2e"])
    out = {}
    for m in harness.cell_metrics(ctx.spec, ctx.cell["name"], "per_layer"):
        value = harness.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(ctx) -> dict:
    """Drive the cell; return the result's parts (metrics by the trace
    flag, device, checks, counts)."""
    entry = harness.entry_module(ctx.traffic["entry"])
    res = entry.run(ctx)
    setup_s = res["window_start_epoch"] - T_PROCESS
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": (__import__("torch").cuda.get_device_name(ctx.device)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": int(ctx.cell["chips"]),
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    units = {m["name"]: m["unit"] for m in ctx.spec["end_to_end"]}
    if ctx.trace:
        metrics = read_per_layer(ctx, res)
        device["busy_s"] = ctx.slice.busy_s
        device["window_s"] = ctx.slice.window_s
        breakdown = ctx.slice.breakdown()
    else:
        e2e = dict(res["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": units[m["name"]]}
                   for m in harness.cell_metrics(ctx.spec, ctx.cell["name"], "end_to_end")}
        breakdown = None
    correct = (all(c["ok"] for c in res["checks"].values())
               and res["failed"] == 0 and res["attempted"] > 0)
    return {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device, "checks": res["checks"],
            "breakdown": breakdown, "readings": res.get("readings", {}),
            "setup_s": setup_s, "window_s": res["window_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    import torch
    why = harness.check_cuda(int(cell["chips"]))
    if why:
        print(f"benchmark: {why}; no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    ctx = cell_context(args.workload, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device=device, spec=spec)
    out = run_cell(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps({"readings": out["readings"], "setup_s": out["setup_s"],
                      "window_s": out["window_s"]}), file=sys.stderr)
    print(harness.checks_text(out["checks"]), file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct=out["correct"], attempted=out["attempted"],
                              failed=out["failed"], metrics=out["metrics"],
                              device=out["device"], checks=out["checks"],
                              breakdown=out["breakdown"]))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
