"""Device times of the attention kernels at chip_smoke.py's main shapes, for
the port in a given checkout: the tool for holding one tree's kernels
against another's on the same card.

    python3 -m socioreasoner_tpu_torch.tools.kernel_times --root CHECKOUT --tag NAME

prints one line, `KERNEL_TIMES {json}`: the device ms (a CUDA graph of ten
calls, median of 20 replays) of kernel 1 a tile (28 window + 4 full layers
of the ViT, S=5832, 16 x 80, on the plans the tower builds), kernel 2 (B=2
L=2048 16/2 x 128, kv 2016 and 1), kernels 4, 5 and 6 (B=4 L=2304 16/2 x
128, kv 2304/2080/1000/1, kernel 6 on a plan built once) and kernel 7 (a
sweep of its 36 layers at the diagnostic script's shape, a graph of ten
sweeps; with the library's empty kernel, where the tree has it, the same
36 launches with and without programmatic dependent launch; and the wall
seconds of the checkout's own chip_smoke.py check of kernel 7), with the
card's name and power limit. --root is the directory that holds the checkout's
`socioreasoner_tpu_torch/` (default: this one's); the kernels build there on
first use. Compare two trees in one call to the card, each in its own
process (two builds of the library in one process refuse the second's
launches), in turns: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def _timers(torch):
    def cuda_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def graph_call_ms(fn, reps=10):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        return cuda_ms(graph.replay) / reps
    return graph_call_ms


def kernel_times(seed: int = 0) -> dict:
    """The device ms of kernels 1, 2, 4, 5 and 6 at the main shapes, for the
    port this process imported."""
    # absolute imports: run against another checkout, this file's code
    # times whichever socioreasoner_tpu_torch comes first on sys.path
    import numpy as np
    import torch
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import VisionConfig
    from socioreasoner_tpu_torch.models.qwen2_5_vl.rope import vision_window_index
    from socioreasoner_tpu_torch.ops import flash_attention as fa
    from socioreasoner_tpu_torch.ops import flash_attention_bwd as fb

    graph_call_ms = _timers(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    out = {}
    vcfg = VisionConfig()
    _, wseg, fseg = vision_window_index(np.array([[1, 54, 54], [1, 54, 54]]), vcfg)
    S, H, D = len(wseg), 16, 80
    q, k, v = randn(S, H, D), randn(S, H, D), randn(S, H, D)
    bq, bk = fa.seg_block_sizes(S)
    span = max(fa.seg_max_span_blocks(wseg, bq, bk), fa.seg_max_span_blocks(fseg, bq, bk))
    layer = {}
    for name, seg_np in (("window", wseg), ("full", fseg)):
        seg = torch.as_tensor(seg_np)
        plan = fa.seg_plan(seg, H, dev, block_q=bq, block_k=bk, max_span_blocks=span)
        layer[name] = graph_call_ms(lambda: fa.flash_attention_segmented(
            q, k, v, seg, block_q=bq, block_k=bk, max_span_blocks=span, plan=plan))
    n_full = len(vcfg.fullatt_block_indexes)
    out["flash_attention_segmented"] = ((vcfg.depth - n_full) * layer["window"]
                                        + n_full * layer["full"])
    B, L = 2, 2048
    q, k, v = randn(B, L, 16, 128), randn(B, L, 2, 128), randn(B, L, 2, 128)
    mask = (torch.arange(L, device=dev)[None]
            < torch.tensor([2016, 1], device=dev)[:, None]).to(torch.int32)
    out["flash_attention"] = graph_call_ms(lambda: fa.flash_attention(q, k, v, mask))
    B, L = 4, 2304
    q, k, v, do = randn(B, L, 16, 128), randn(B, L, 2, 128), randn(B, L, 2, 128), \
        randn(B, L, 16, 128)
    lens = torch.tensor([2304, 2080, 1000, 1], dtype=torch.int32, device=dev)
    o, lse = fb.flash_attention_fwd_lse(q, k, v, lens)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    plan = fb.dkv_plan(lens, B, L, L, 16, 2, True, dev)
    out["flash_attention_fwd_lse"] = graph_call_ms(
        lambda: fb.flash_attention_fwd_lse(q, k, v, lens))
    out["flash_attention_bwd_dq"] = graph_call_ms(
        lambda: fb.flash_attention_bwd_dq(q, k, v, do, lse, delta, lens))
    out["flash_attention_bwd_dkv"] = graph_call_ms(
        lambda: fb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, lens, plan=plan))
    del q, k, v, do, o, lse, delta, plan
    out.update(row_writer_times(torch, graph_call_ms, randn))
    out.update(row_writer_check(randn))
    return out


def row_writer_times(torch, graph_call_ms, randn) -> dict:
    """Kernel 7's 36-layer sweep (caches (36, 24, 1536, 2, 128), every slot
    at row 520) and, where the tree's library has the empty kernel, 36 of
    its launches with and without PDL: device ms a sweep."""
    from socioreasoner_tpu_torch.ops import cache_write as cw
    L, S, Lalloc, Hkv, D = 36, 24, 1536, 2, 128
    k_all, v_all = randn(L, S, Lalloc, Hkv, D), randn(L, S, Lalloc, Hkv, D)
    knew, vnew = randn(S, 1, Hkv, D), randn(S, 1, Hkv, D)
    positions = torch.full((S,), 520, dtype=torch.int32, device=k_all.device)

    def sweep():
        for i in range(L):
            cw.write_rows(k_all, v_all, knew, vnew, positions, i)
    out = {"write_rows_sweep": graph_call_ms(sweep)}
    if hasattr(cw, "launch_noop"):
        for key, pdl in (("noop_sweep_pdl", True), ("noop_sweep_no_pdl", False)):
            out[key] = graph_call_ms(lambda: [cw.launch_noop(k_all.device, pdl)
                                              for _ in range(L)])
    return out


def row_writer_check(randn) -> dict:
    """The checkout's own chip_smoke.py check of kernel 7
    (`_row_writer_kernel`: its bit-for-bit checks and its timings), run
    twice: each run's wall seconds, and the second run's profiler sum of the
    kernel's time a sweep (its device_ms) and, where the check takes it, a
    sweep's time from a graph of ten; empty where the checkout has no such
    check."""
    import importlib.util
    import time
    from socioreasoner_tpu_torch.ops import _build
    path = Path(_build.PKG_DIR).parent / "chip_smoke.py"
    if not path.is_file():
        return {}
    spec = importlib.util.spec_from_file_location("chip_smoke_of_checkout", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not hasattr(smoke, "_row_writer_kernel"):
        return {}
    seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        row = smoke._row_writer_kernel(randn)
        seconds.append(time.perf_counter() - t0)
    return {"row_writer_check_s": seconds, "row_writer_device_ms": row["device_ms"],
            "row_writer_graph_device_ms": row.get("graph_device_ms")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="the checkout whose socioreasoner_tpu_torch/ is timed")
    ap.add_argument("--tag", default="tree", help="a name for the line")
    args = ap.parse_args(argv)
    if args.root is not None and Path(args.root).resolve() != \
            Path(__file__).resolve().parents[2]:
        # this file's code over the other checkout's port, in a process of
        # its own (the other tree may not have this tool)
        root = str(Path(args.root).resolve())
        code = ("import runpy, sys; sys.path.insert(0, sys.argv[1]); "
                "sys.argv = [sys.argv[2], '--tag', sys.argv[3]]; "
                "runpy.run_path(sys.argv[0], run_name='__main__')")
        return subprocess.run([sys.executable, "-c", code, root, __file__, args.tag],
                              cwd=root).returncode
    import torch
    from socioreasoner_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA device", file=sys.stderr)
        return 1
    _build.build()
    times = kernel_times()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print("KERNEL_TIMES " + json.dumps({"tag": args.tag, "package": str(_build.PKG_DIR),
                                        "card": smi.stdout.strip(), **times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
