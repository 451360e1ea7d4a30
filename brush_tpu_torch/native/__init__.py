"""Native (C++) host code, loaded with ctypes (port of brush_tpu/native/).

Two pieces: a single-pass COLMAP points3D.bin parser (colmap.cpp, the
port's own copy of the reference's source), where per-record
`struct.unpack` is too slow for a point cloud of millions; and the PNG
row unfilter (png.cpp), whose Average and Paeth rows are sequential along
a row. The reference's other native piece, the KD-tree k-NN of knn.cpp,
has its counterpart on the card: `splats.knn_mean_distance`.

The library is built with g++ at first use into native/build/ (listed in
.gitignore) under a name that carries a hash of the sources, so an edited
source rebuilds. Where no compiler is found, `available()` is False and
the callers run in Python and numpy (`datasets.colmap.read_points3d`,
`datasets.png`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [os.path.join(_DIR, name) for name in ("colmap.cpp", "png.cpp")]
BUILD_DIR = os.path.join(_DIR, "build")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _lib_path() -> str:
    digest = hashlib.sha1()
    for source in _SOURCES:
        with open(source, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libbrush_native-{digest.hexdigest()[:12]}.so")


def _build(path: str) -> bool:
    """g++ the sources into `path`; False when there is no compiler or the
    build fails. -march=native is safe: the library is never shipped, it
    is built on the machine that loads it."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [gxx, "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, *_SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, path)
    return True


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.colmap_points3d_count.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.colmap_points3d_count.restype = ctypes.c_int64
        lib.colmap_points3d_parse.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.colmap_points3d_parse.restype = ctypes.c_int64
        lib.png_unfilter.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.png_unfilter.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_points3d_bin(data: bytes):
    """(positions (n,3) f32, colors (n,3) f32) from COLMAP points3D.bin."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    buf = np.frombuffer(data, dtype=np.uint8)
    ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    n = lib.colmap_points3d_count(ptr, len(data))
    # 51 bytes a point at the least: refuse a count the data cannot hold
    # before allocating for it.
    if n < 0 or n > (len(data) - 8) // 51:
        raise ValueError("malformed or truncated points3D.bin")
    pos = np.empty((n, 3), np.float32)
    rgb = np.empty((n, 3), np.float32)
    parsed = lib.colmap_points3d_parse(
        ptr, len(data),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if parsed != n:
        raise ValueError("truncated points3D.bin")
    return pos, rgb


def png_unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The image bytes (h, stride) of 8-bit PNG scanlines `rows` (h,
    1 + stride) uint8, each led by its filter byte; bpp = bytes a pixel."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rows = np.ascontiguousarray(rows, np.uint8)
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    bad = lib.png_unfilter(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, stride, bpp,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if bad:
        raise ValueError(f"PNG: unknown row filter {int(rows[bad - 1, 0])}")
    return out
