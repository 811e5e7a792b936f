"""Checkpoint conversion CLI: HuggingFace <-> the port's native format.

The port's counterpart of socioreasoner_tpu/tools/convert.py (the
reference's `mcore_adapter/tools/convert.py` role). The native format is
utils/checkpoint.py's (`checkpoint_<step>/` directories that
`CheckpointManager` writes and `TorchTrainStrategy` resumes from), not the
JAX package's orbax one: the two packages exchange weights as HF
checkpoints.

Direction is auto-detected from the input layout:
  - HF dir (config.json + *.safetensors)   -> native checkpoint
  - native dir (checkpoint_<step>/)        -> HF dir (config.json + safetensors)

Usage:
  python -m socioreasoner_tpu_torch.tools.convert \
      --checkpoint_path /path/to/in --output_path /path/to/out \
      [--bf16 | --fp16] [--step N] [--no-vision] [--max_shard_gb 4] [--device cpu]

An HF checkpoint is loaded onto --device (the GPU unless one is named) on
its way to the native one. Train checkpoints written by
`TorchTrainStrategy.save_checkpoint` (which also carry `opt_state`)
convert fine: only the `params` subtree is exported.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import torch


def _is_hf_dir(path: str) -> bool:
    return (os.path.isfile(os.path.join(path, "config.json"))
            and bool(glob.glob(os.path.join(path, "*.safetensors"))))


def _is_native_dir(path: str) -> bool:
    return bool(glob.glob(os.path.join(path, "checkpoint_*"))
                or glob.glob(os.path.join(path, "checkpoint-*")))


def _dtype(args) -> torch.dtype:
    if args.bf16 and args.fp16:
        raise SystemExit("--bf16 and --fp16 are mutually exclusive")
    if args.bf16:
        return torch.bfloat16
    if args.fp16:
        return torch.float16
    return torch.float32


def convert_hf_to_native(args) -> None:
    from ..models.qwen2_5_vl.export import config_to_hf_dict
    from ..models.qwen2_5_vl.loader import load_pretrained
    from ..utils.checkpoint import CheckpointManager

    with open(os.path.join(args.checkpoint_path, "config.json")) as f:
        hf_cfg = json.load(f)
    with_vision = (not args.no_vision) and "vision_config" in hf_cfg
    dtype = _dtype(args)
    print(f"[convert] HF -> native: {args.checkpoint_path} "
          f"(model_type={hf_cfg.get('model_type')}, vision={with_vision}, "
          f"dtype={str(dtype).split('.')[-1]})")
    config, params = load_pretrained(args.checkpoint_path, dtype=dtype,
                                     with_vision=with_vision, device=args.device)
    mgr = CheckpointManager(args.output_path, keep_last_n=1, use_async=False)
    mgr.save(args.step or 0, {"params": params},
             meta={"hf_config": config_to_hf_dict(config),
                   "source": os.path.abspath(args.checkpoint_path)},
             wait=True)
    mgr.close()
    print(f"[convert] wrote native checkpoint step {args.step or 0} "
          f"-> {args.output_path}")


def convert_native_to_hf(args) -> None:
    from ..models.qwen2_5_vl.config import Qwen25VLConfig
    from ..models.qwen2_5_vl.export import save_pretrained
    from ..utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(args.checkpoint_path, keep_last_n=100, use_async=False)
    state, meta = mgr.restore(args.step)
    mgr.close()
    if state is None:
        raise SystemExit(f"no checkpoint found under {args.checkpoint_path}")
    if meta is None or "hf_config" not in meta:
        if args.hf_config is None:
            raise SystemExit(
                "checkpoint has no hf_config meta (a train checkpoint?); "
                "pass --hf_config /path/to/config.json")
        with open(args.hf_config) as f:
            hf_cfg = json.load(f)
    else:
        hf_cfg = meta["hf_config"]
    config = Qwen25VLConfig.from_hf_dict(hf_cfg)
    params = state["params"] if "params" in state else state
    if args.bf16 or args.fp16:
        dtype = _dtype(args)

        def cast(tree):
            if isinstance(tree, dict):
                return {k: cast(v) for k, v in tree.items()}
            return tree.to(dtype)
        params = cast(params)
    print(f"[convert] native -> HF: step={args.step or 'latest'} "
          f"-> {args.output_path}")
    save_pretrained(config, params, args.output_path,
                    max_shard_bytes=int(args.max_shard_gb * 1024 ** 3))
    print(f"[convert] wrote HF checkpoint -> {args.output_path}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="socioreasoner_tpu_torch.tools.convert",
        description="Convert checkpoints between HF and the port's native format "
                    "(direction auto-detected from the input layout).")
    p.add_argument("--checkpoint_path", required=True)
    p.add_argument("--output_path", default="./output")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fp16", action="store_true")
    p.add_argument("--step", type=int, default=None,
                   help="native step to read (default: latest) or write "
                        "(default: 0)")
    p.add_argument("--no-vision", action="store_true",
                   help="skip the vision tower when loading an HF VL ckpt")
    p.add_argument("--hf_config", default=None,
                   help="config.json to use when a native ckpt has no "
                        "hf_config meta")
    p.add_argument("--max_shard_gb", type=float, default=4.0)
    p.add_argument("--device", default=None,
                   help="where an HF checkpoint is loaded (default: the GPU)")
    args = p.parse_args(argv)

    src = args.checkpoint_path
    if not os.path.isdir(src):
        raise SystemExit(f"not a directory: {src}")
    if _is_hf_dir(src):
        convert_hf_to_native(args)
    elif _is_native_dir(src):
        convert_native_to_hf(args)
    else:
        raise SystemExit(
            f"{src} is neither an HF dir (config.json + safetensors) nor a "
            f"native checkpoint dir (checkpoint_<step>/)")


if __name__ == "__main__":
    main()
