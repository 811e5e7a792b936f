"""The benchmark's common machinery: BENCHMARK.json, the files found by name,
the import guard, the device checks and the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own under this folder, found by the
name that BENCHMARK.json gives it:

  configs/<config>.json      sizes, source, reduced, assumed, deployment
  traffic/<traffic>.json     the parameters that generator.py's one generator
                             reads; its "entry" names entries/<entry>.py
  metrics/<metric>.py        a reader: read(run) -> float | None
  counts/<kernel>.py         a kernel's operations and bytes from shapes
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
REPO_DIR = BENCH_DIR.parent
SPEC_PATH = REPO_DIR / "BENCHMARK.json"

# top-level module names that no run may hold: JAX, and the JAX package
# (compared whole: the port's name begins with the JAX package's)
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "socioreasoner_tpu")


def process_start_time() -> float:
    """The epoch second at which this process started (its start tick in
    /proc/self/stat over the boot time), or now where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def load_spec(path: Path = SPEC_PATH) -> Dict:
    with open(path) as f:
        return json.load(f)


def find_cell(spec: Dict, name: str) -> Dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def find_config(spec: Dict, name: str) -> Dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def config_file(spec: Dict, name: str) -> Dict:
    """The configuration's file as BENCHMARK.json names it."""
    return load_json(REPO_DIR / find_config(spec, name)["file"])


def traffic_file(name: str) -> Dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def load_module(path: Path, name: Optional[str] = None):
    """A module from its file, under a name of the benchmark's own."""
    name = name or "benchmark_file_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(name: str):
    return load_module(BENCH_DIR / "entries" / f"{name}.py", f"benchmark_entry_{name}")


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py")


def count_module(kernel: str):
    return load_module(BENCH_DIR / "counts" / f"{kernel}.py", f"benchmark_count_{kernel}")


def cell_metrics(spec: Dict, cell: str, group: str) -> List[Dict]:
    """The end_to_end or per_layer metrics that `cell` reports: those that
    list it under "workloads", or that list no cells; a per-layer metric
    without "workloads" is reported where its `moves` metric is."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if group == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_TOP)


def check_cuda(chips: int) -> Optional[str]:
    """Why this machine cannot run a cell of `chips` cards, or None."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}"
    return None


def result_line(*, correct: bool, attempted: int, failed: int, metrics: Dict,
                device: Dict, checks: Dict, breakdown: Optional[Dict] = None) -> str:
    """The last line of standard output: the result's keys, the checks
    (each compared number beside its limit) last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def checks_text(checks: Dict) -> str:
    return "\n".join(f"check {name}: {c['value']!r} limit {c['limit']!r} "
                     f"({'ok' if c['ok'] else 'FAILED'})" for name, c in checks.items())
