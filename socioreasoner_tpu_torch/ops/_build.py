"""Build and load the port's CUDA kernels.

All sources in ``socioreasoner_tpu_torch/csrc`` compile with ``nvcc`` for
``sm_90a`` (one nvcc process per ``.cu`` file, all started together) and link
into ONE shared library with a plain C interface, loaded through ctypes. The
library lands in ``socioreasoner_tpu_torch/_build/`` under a name
that hashes the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing file. Nothing is built at import time: the
first kernel launch calls :func:`library`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C entry points and their argument types: every pointer and the stream as
# c_void_p (a bare Python int would be cut to 32 bits).
SIGNATURES = {
    "socio_flash_prefill_bf16":
        [_P] * 5 + [_I] * 6 + [_LL] * 12 + [_I, _F, _P],
    "socio_prefill_tile_bounds":
        [_I] * 6 + [_P],
    "socio_gqa_item":
        [_I] * 5 + [_P],
    "socio_head_dim_instance":
        [_I] * 2,
    "socio_head_dim_slices":
        [_I] * 2,
    "socio_flash_segmented_bf16":
        [_P] * 7 + [_I] * 4 + [_LL] * 8 + [_F, _P],
    "socio_paged_decode_encode":
        [_I] + [_P] * 4,
    "socio_paged_decode":
        [_I] + [_P] * 6 + [_I, _P, _P],
    "socio_write_rows_bf16":
        [_P] * 5 + [_I] * 3 + [_LL] * 6 + [_P],
    "socio_noop":
        [_I, _P],
    "socio_flash_train_fwd_bf16":
        [_P] * 6 + [_I] * 6 + [_LL] * 12 + [_I, _F, _P],
    "socio_flash_train_dq_bf16":
        [_P] * 8 + [_I] * 6 + [_LL] * 15 + [_I, _F, _P],
    "socio_flash_train_dkv_bf16":
        [_P] * 13 + [_I] * 7 + [_LL] * 18 + [_I, _F, _P],
}


def sources():
    return sorted(list(CSRC_DIR.glob("*.cu")) + list(CSRC_DIR.glob("*.cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsocio_attention_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> "tuple[Path, float]":
    """Compile the library if it is missing; returns (path, seconds spent)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs = [p.communicate()[1] for p in procs]       # waits for each
    failed = [f"{p.args[-1]}:\n{err}" for p, err in zip(procs, logs) if p.returncode]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"link:\n{link.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    if verbose:              # ptxas register / shared-memory report
        print("".join(logs), end="", file=sys.stderr)
    os.replace(tmp, out)          # atomic: a concurrent loader sees all or nothing
    return out, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")
