"""Safetensors files read and written with torch alone.

The port's counterpart of the `safetensors` package calls of the JAX
package (`iter_safetensors` in socioreasoner_tpu/models/qwen2_5_vl/loader.py
and `safetensors.numpy.save_file` in export.py). Neither numpy nor the
`safetensors` package is on the path: numpy has no bfloat16, and released
Qwen2.5-VL checkpoints are BF16.

A file is an 8-byte little-endian header length, a JSON header
`{name: {"dtype", "shape", "data_offsets": [begin, end]}}` with an optional
`"__metadata__"` of strings, and the tensors' raw little-endian bytes, which
the offsets index from the end of the header with no gaps. Reading maps the
file and makes each tensor with `torch.frombuffer` over the map, so a tensor
costs no host memory until it is copied (to the device, or into another
dtype). A directory is read through `model.safetensors.index.json` when it
has one, else every `*.safetensors` file in it, in name order.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch

DTYPES: Dict[str, torch.dtype] = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
INDEX = "model.safetensors.index.json"


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def read_header(path: str) -> Tuple[Dict, int]:
    """(header without __metadata__, offset of the data) of one file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def iter_file(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every tensor in one file, in name order. The
    tensors are views of a private (copy-on-write) map of the file: writing
    to one never reaches the file."""
    header, start = read_header(path)
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else None
    for name in sorted(header):
        info = header[name]
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the "
                             f"reader does not take ({sorted(DTYPES)})")
        dtype, shape = DTYPES[info["dtype"]], tuple(info["shape"])
        begin, end = info["data_offsets"]
        numel = 1
        for d in shape:
            numel *= d
        if end - begin != numel * _itemsize(dtype) or start + end > size:
            raise ValueError(f"{path}: {name} {info} does not fit the file")
        if numel == 0:
            yield name, torch.empty(shape, dtype=dtype)
            continue
        yield name, torch.frombuffer(mm, dtype=dtype, offset=start + begin,
                                     count=numel).reshape(shape)


def iter_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Stream (name, tensor) from the safetensors files of a checkpoint
    directory, as the JAX loader finds them: those the index names, else
    every *.safetensors file."""
    index = os.path.join(path, INDEX)
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    for fname in files:
        yield from iter_file(os.path.join(path, fname))


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (on any device) to one file. Tensors are laid out by element size, largest first, then by name, as
    the safetensors package lays them out, so every tensor starts at a
    multiple of its element size. One tensor at a time is copied to the
    host."""
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} cannot be written "
                             f"({sorted(DTYPES)})")
    order = sorted(tensors, key=lambda k: (-_itemsize(tensors[k].dtype), k))
    header: Dict = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                # the layout change runs where the tensor lives
                host = t.contiguous().to("cpu").reshape(-1).view(torch.uint8)
                f.write(memoryview(host.numpy()))


def save_sharded(named: Iterable[Tuple[str, torch.Tensor]], path: str,
                 max_shard_bytes: int = 4 * 1024 ** 3) -> Dict[str, str]:
    """Write (name, tensor) pairs as HF shards under `path`: one
    `model.safetensors`, or `model-0000i-of-0000n.safetensors` files plus
    `model.safetensors.index.json` when they pass `max_shard_bytes` (a new
    shard starts where the next tensor would pass it), each with the
    `{"format": "pt"}` metadata that HF's loader reads. The pairs are
    grouped first (tensors held by reference) and written shard by shard.
    Returns the weight map {name: file}."""
    shards: List[Dict[str, torch.Tensor]] = [{}]
    sizes = [0]
    for name, t in named:
        nbytes = t.numel() * t.element_size()
        if sizes[-1] + nbytes > max_shard_bytes and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = t
        sizes[-1] += nbytes
    n = len(shards)
    weight_map: Dict[str, str] = {}
    for i, shard in enumerate(shards):
        fname = (f"model-{i + 1:05d}-of-{n:05d}.safetensors" if n > 1
                 else "model.safetensors")
        save_file(shard, os.path.join(path, fname), {"format": "pt"})
        weight_map.update({name: fname for name in shard})
    if n > 1:
        with open(os.path.join(path, INDEX), "w") as f:
            json.dump({"metadata": {"total_size": sum(sizes)},
                       "weight_map": weight_map}, f)
    return weight_map
