"""ctypes bindings to the port's native host library, the counterpart of
socioreasoner_tpu/utils/native.py.

The library is the port's own copy of the JAX package's host code,
``socioreasoner_tpu_torch/csrc/socio_host.cpp``: uint8 resize, Qwen patch
rows, connected components and their boxes, the Hungarian assignment, mask
IoU and the stage-2 overlay render. ``g++`` builds it at first use into the
git-ignored ``socioreasoner_tpu_torch/_build/`` (again when the source is
newer), with the JAX package's flags, so both libraries compute the same
bits. A failed build raises: nothing falls back to scipy, cv2 or PIL.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SRC = PKG_DIR / "csrc" / "socio_host.cpp"
BUILD_DIR = PKG_DIR / "_build"
LIB_PATH = BUILD_DIR / "libsocio_host.so"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_LOCK = threading.Lock()


def build(force: bool = False) -> Path:
    """Compile the library unless an up-to-date one exists. The output is
    written under a temporary name and renamed, so concurrent builders never
    load a half-written file."""
    if (not force and LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= SRC.stat().st_mtime):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC}:\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB_PATH


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_f32p = ctypes.POINTER(ctypes.c_float)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_f64p = ctypes.POINTER(ctypes.c_double)
        i64 = ctypes.c_int64
        u8 = ctypes.c_uint8
        lib.resize_bilinear_u8.argtypes = [c_u8p, i64, i64, i64, c_u8p, i64, i64]
        lib.resize_nearest_u8.argtypes = [c_u8p, i64, i64, i64, c_u8p, i64, i64]
        lib.patchify_normalize.argtypes = [c_u8p, i64, i64, c_f32p, c_f32p,
                                           i64, i64, i64, c_f32p]
        lib.connected_components.argtypes = [c_u8p, i64, i64, c_i32p]
        lib.connected_components.restype = i64
        lib.component_boxes.argtypes = [c_u8p, i64, i64, i64, c_i64p, i64]
        lib.component_boxes.restype = i64
        lib.hungarian.argtypes = [c_f64p, i64, i64, c_i64p]
        lib.mask_iou.argtypes = [c_u8p, c_u8p, i64]
        lib.mask_iou.restype = ctypes.c_double
        lib.render_overlay.argtypes = [c_u8p, i64, i64, c_i64p, i64, u8, u8, u8,
                                       i64, c_u8p, i64, i64, u8, u8, u8,
                                       ctypes.c_double]
        _LIB = lib
        return lib


def available() -> bool:
    """True once the library builds and loads (a failed build raises from
    every function below)."""
    try:
        _load()
    except Exception:
        return False
    return True


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _binary(mask) -> np.ndarray:
    return np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8))


def resize_u8(img: np.ndarray, out_hw: Tuple[int, int], mode: str = "bilinear"
              ) -> np.ndarray:
    """uint8 (H, W[, C]) resize, bilinear with half-pixel centres or
    nearest."""
    lib = _load()
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    oh, ow = out_hw
    out = np.empty((oh, ow, c), np.uint8)
    fn = lib.resize_bilinear_u8 if mode == "bilinear" else lib.resize_nearest_u8
    fn(_ptr(img, ctypes.c_uint8), h, w, c, _ptr(out, ctypes.c_uint8), oh, ow)
    return out[:, :, 0] if squeeze else out


def patchify_normalize(img: np.ndarray, mean: np.ndarray, std: np.ndarray,
                       patch_size: int = 14, merge_size: int = 2,
                       temporal_patch_size: int = 2) -> np.ndarray:
    """uint8 HWC (already resized) → (S, 3*tps*ps*ps) float32 Qwen patch
    rows."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    gh, gw = h // patch_size, w // patch_size
    out = np.empty((gh * gw, 3 * temporal_patch_size * patch_size ** 2), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.patchify_normalize(_ptr(img, ctypes.c_uint8), h, w,
                           _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float),
                           patch_size, merge_size, temporal_patch_size,
                           _ptr(out, ctypes.c_float))
    return out


def connected_components_count(mask: np.ndarray) -> int:
    """The number of 8-connected components of mask > 0."""
    lib = _load()
    mask = _binary(mask)
    h, w = mask.shape
    return int(lib.connected_components(_ptr(mask, ctypes.c_uint8), h, w, None))


def component_boxes(mask: np.ndarray, min_area: int = 10, max_boxes: int = 512
                    ) -> List[List[int]]:
    """[x1, y1, x2, y2] (x2, y2 exclusive) per 8-connected component of
    mask > 0 with pixel area > min_area, in the raster order of each
    component's first pixel."""
    lib = _load()
    mask = _binary(mask)
    h, w = mask.shape
    out = np.zeros((max_boxes, 5), np.int64)
    n = int(lib.component_boxes(_ptr(mask, ctypes.c_uint8), h, w, min_area,
                                _ptr(out, ctypes.c_int64), max_boxes))
    return out[:n, :4].tolist()


def hungarian(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal-cost assignment: (rows, cols) as scipy's
    linear_sum_assignment returns them."""
    lib = _load()
    cost = np.ascontiguousarray(cost, np.float64)
    n, m = cost.shape
    if n <= m:
        out = np.zeros(n, np.int64)
        lib.hungarian(_ptr(cost, ctypes.c_double), n, m, _ptr(out, ctypes.c_int64))
        return np.arange(n), out
    cost_t = np.ascontiguousarray(cost.T)
    out = np.zeros(m, np.int64)
    lib.hungarian(_ptr(cost_t, ctypes.c_double), m, n, _ptr(out, ctypes.c_int64))
    return out, np.arange(m)


def mask_iou_native(a: np.ndarray, b: np.ndarray, empty_value: float = 0.0) -> float:
    """Pixel IoU of a > 0 and b > 0; both empty → empty_value."""
    lib = _load()
    a, b = _binary(a).reshape(-1), _binary(b).reshape(-1)
    v = float(lib.mask_iou(_ptr(a, ctypes.c_uint8), _ptr(b, ctypes.c_uint8), a.size))
    return empty_value if v < 0 else v


def render_overlay(img: np.ndarray, boxes: List[List[int]],
                   mask: Optional[np.ndarray], *,
                   box_color=(0, 0, 255), box_width: int = 2,
                   mask_color=(255, 0, 0), alpha: float = 0.4) -> np.ndarray:
    """An RGB uint8 copy of img with the boxes' outlines and the mask
    alpha-blended over it."""
    lib = _load()
    out = np.ascontiguousarray(np.asarray(img), np.uint8).copy()
    h, w = out.shape[:2]
    barr = (np.ascontiguousarray(np.asarray(boxes, np.int64).reshape(-1, 4))
            if boxes else np.zeros((0, 4), np.int64))
    if mask is not None:
        m = _binary(mask)
        mp, mh, mw = _ptr(m, ctypes.c_uint8), m.shape[0], m.shape[1]
    else:
        mp, mh, mw = None, 0, 0
    lib.render_overlay(_ptr(out, ctypes.c_uint8), h, w, _ptr(barr, ctypes.c_int64),
                       len(barr), box_color[0], box_color[1], box_color[2], box_width,
                       mp, mh, mw, mask_color[0], mask_color[1], mask_color[2], alpha)
    return out
