#!/usr/bin/env python3
"""Device time of the port's decode attention (kernels 3 and 3q) by CUDA kernel.

    python3 scripts/torch_decode_profile.py [--root CHECKOUT] [--n 20]

Builds the stacked 36-layer cache of chip_smoke.py's decode checks (the main
phase's Lalloc 2816, 2 kv heads x 128, 16 q heads), bf16 and int8 codes with
f32 scales, at S=4 (lengths 0, 1, 1500, 2813) and S=32 (mixed lengths), and
calls ``paged_decode_attention`` over all 36 layers. Prints one JSON line per
(branch, slot count): each CUDA kernel's device ms and launches a layer from
torch.profiler, the sweep's device ms a layer from a CUDA graph replay, and
the wrapper's ms a layer (CUDA events, host launch included). The first line
is the card's name and power limit. ``--root`` imports the port from another
checkout (to compare two trees in one run); the script uses only the public
wrapper, so it runs against any tree of the port. ``--splits 1,2,4,8,16``
instead times the S=4 sweeps (and one with every length 1, the call's fixed
cost) with the plan's split count forced to each value (trees with
``split_count``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

LAYERS, LALLOC, HKV, H, D = 36, 2816, 2, 16, 128
CASES = {4: [0, 1, 1500, LALLOC - 3],
         32: [0, 1, 64, LALLOC - 1] + [(97 * i) % LALLOC for i in range(1, 29)]}


def _events_ms(fn, n):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _graph_ms(fn, n):
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _events_ms(graph.replay, n)


def _by_kernel(fn, calls):
    """{CUDA kernel name: (device ms, launches)} over `calls` calls of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.device_time_total / 1e3 / calls, e.count / calls)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def _caches(da, gen, S):
    """bf16 k, v and int8 k, v, k scales, v scales of LAYERS layers."""
    import torch
    kc = torch.randn(LAYERS, S, LALLOC, HKV, D, generator=gen, device=gen.device)
    kc = kc.to(torch.bfloat16)
    vc = torch.randn_like(kc)
    out = [kc, vc]
    for x in (kc, vc):
        code, scale = da.quantize_kv(x.reshape(-1, LALLOC, HKV, D))
        out += [code.reshape(kc.shape),
                scale.reshape(LAYERS, S, LALLOC, HKV).transpose(-1, -2).contiguous()]
    kc, vc, k8, ks, v8, vs = out
    return (kc, vc), (k8, v8, ks, vs)


def _split_sweep(da, gen, splits, n):
    import torch
    S = 4
    q = torch.randn(S, H, D, generator=gen, device=gen.device).to(torch.bfloat16)
    bf16, int8 = _caches(da, gen, S)
    # a graph node's floor on this card: 36 fills of a tensor of the output's size
    t = torch.empty(S, H, D, dtype=torch.bfloat16, device=gen.device)
    print(json.dumps({"graph_node_floor_ms": _graph_ms(
        lambda: [t.zero_() for _ in range(LAYERS)], n) / LAYERS}), flush=True)
    for lens in (CASES[S], [1] * S):
        lengths = torch.tensor(lens, dtype=torch.int32, device=gen.device)
        for branch, (k, v, *scales) in (("bf16", bf16), ("int8", int8)):
            for n_split in splits:
                da.split_count = lambda *_, n_split=n_split: n_split
                da._PLANS.clear()
                sweep = lambda: [da.paged_decode_attention(   # noqa: E731
                    q, k, v, lengths, *scales, layer=i) for i in range(LAYERS)]
                try:
                    ms = _graph_ms(sweep, n) / LAYERS
                except RuntimeError as e:
                    ms = str(e).splitlines()[0]
                print(json.dumps({"branch": branch, "slots": S, "lengths": lens,
                                  "n_split": n_split, "graph_device_ms_per_layer": ms}),
                      flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--splits", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    from socioreasoner_tpu_torch.ops import decode_attention as da
    if not torch.cuda.is_available():
        print("torch_decode_profile: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.splits:
        return _split_sweep(da, gen, [int(n) for n in args.splits.split(",")], args.n)
    for S, lens in CASES.items():
        q = torch.randn(S, H, D, generator=gen, device=dev).to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        bf16, int8 = _caches(da, gen, S)
        for branch, (k, v, *scales) in (("bf16", bf16), ("int8", int8)):
            sweep = lambda: [da.paged_decode_attention(   # noqa: E731
                q, k, v, lengths, *scales, layer=i) for i in range(LAYERS)]
            kernels = _by_kernel(sweep, 5)
            plan = getattr(da, "decode_plan", None)     # absent from older trees
            n_split = None if plan is None else plan(q, k, v, lengths, *scales,
                                                     stacked=True).n_split
            print(json.dumps({
                "branch": branch, "slots": S, "lengths": lens if S <= 8 else "mixed",
                "root": args.root, "n_split": n_split,
                "kernels": {name: {"device_ms_per_layer": ms / LAYERS,
                                   "launches_per_layer": c / LAYERS}
                            for name, (ms, c) in kernels.items()},
                "graph_device_ms_per_layer": _graph_ms(sweep, args.n) / LAYERS,
                "ms_per_layer": _events_ms(sweep, args.n) / LAYERS}), flush=True)
        del bf16, int8
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
