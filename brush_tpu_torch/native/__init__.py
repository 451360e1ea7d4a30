"""Native (C++) host code, loaded with ctypes (port of brush_tpu/native/).

Three pieces: the KD-tree k-NN of the initial splat scales (knn.cpp)
and a single-pass COLMAP points3D.bin parser (colmap.cpp), the port's own
copies of the reference's sources, where the brute force is O(n^2) and
per-record `struct.unpack` is too slow for a point cloud of millions; and
the PNG row unfilter (png.cpp), whose Average and Paeth rows are
sequential along a row.

The library is built with g++ at first use into native/build/ (listed in
.gitignore) under a name that carries a hash of the sources, so an edited
source rebuilds; with OpenMP where the toolchain has it (the k-NN queries
run in parallel), as the reference builds it. Processes that start at once
(test workers) build one at a time (`build_once`, which the CUDA kernels'
build shares). Where no compiler is found, `available()` is False and
each caller takes its other route: the brute-force k-NN on the points'
device (`splats.knn_route`), Python and numpy
(`datasets.colmap.read_points3d`, `datasets.png`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [os.path.join(_DIR, name)
            for name in ("knn.cpp", "colmap.cpp", "png.cpp")]
BUILD_DIR = os.path.join(_DIR, "build")

_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path(build_dir: str, stem: str, inputs) -> str:
    """build_dir/lib<stem>-<hash>.so, the hash over the bytes of the files
    `inputs` in their order: an edited input names another library, so a
    stale one is never loaded."""
    digest = hashlib.sha1()
    for path in inputs:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(build_dir,
                        f"lib{stem}-{digest.hexdigest()[:12]}.so")


def build_once(build_dir: str, paths, compile_missing) -> bool:
    """Whether the libraries `paths` exist, built by this process or
    another. One build at a time across processes (an exclusive lock on
    build_dir/build.lock), each looking for the libraries again once it
    holds the lock. compile_missing(todo) gets {path: temporary path} of
    the libraries still missing, writes what it can and returns the paths
    whose temporary file it wrote; each lands by an atomic rename, so no
    process loads a half-written library, and the others' temporary files
    go. The host library and the CUDA kernels (ops/cuda/build.py) build
    through it."""
    if all(os.path.exists(p) for p in paths):
        return True
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            todo = {p: f"{p}.{os.getpid()}.tmp" for p in paths
                    if not os.path.exists(p)}
            written = compile_missing(todo) if todo else ()
            for path, tmp in todo.items():
                if path in written:
                    os.replace(tmp, path)
                elif os.path.exists(tmp):
                    os.remove(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return all(os.path.exists(p) for p in paths)


def _compile(todo) -> set:
    """g++ the sources into the one temporary path of todo, with -fopenmp
    and, where the toolchain has no OpenMP, without. -march=native is
    safe: the library is never shipped, it is built on the machine that
    loads it."""
    (path, tmp), = todo.items()
    cmd = [shutil.which("g++"), "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", "-o", tmp, *_SOURCES]
    for flags in (["-fopenmp"], []):
        try:
            subprocess.run(cmd + flags, check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        return {path}
    return set()


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path(BUILD_DIR, "brush_native", _SOURCES)
        if not (os.path.exists(path) or shutil.which("g++")
                and build_once(BUILD_DIR, [path], _compile)):
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.knn_mean_distance.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.knn_mean_distance.restype = None
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


def knn_distances(positions: np.ndarray, k: int = 3) -> np.ndarray:
    """sqrt(sum of the k smallest squared distances) / k of each point of
    positions (n, 3), the point itself among its k (reference:
    gaussian_splats.rs:108-120), float32 (n,). With fewer than k points
    the missing neighbours count 0 and the sum is still divided by k, as
    in brush_tpu.native.knn_distances; k above 16 counts as 16."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    pts = np.ascontiguousarray(positions, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"positions must be (n, 3), got {pts.shape}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    n = pts.shape[0]
    out = np.empty(n, dtype=np.float32)
    lib.knn_mean_distance(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n), ctypes.c_int(k),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


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
