"""The port's native k-NN (brush_tpu_torch/native/knn.cpp) against
brush_tpu.native's and against the brute force, and the initial splat
scales it gives, on the CPU. Skips only where no g++ is found.

brush_tpu.native builds its library with g++ straight onto its final path
and, if a load fails, gives up for the life of the process. Test workers
that start at once each begin that build (tests/test_native.py asks for
the library while it is collected), and a worker that loads a
half-written file loses the reference library for the whole test run.
`reference_native` gets it loaded in such a worker; it touches only the
module's private state and its build artefact, never its sources.
"""

import fcntl
import os
import shutil
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from brush_tpu import native as j_native
from brush_tpu.splats import from_random as j_from_random
from brush_tpu.splats import knn_mean_distance as j_knn_mean_distance

from brush_tpu_torch import native, splats
from brush_tpu_torch.splats import (
    from_random, knn_extents, knn_mean_distance, knn_route,
)
from torch_threads import pin_threads

pin_threads()


# reference_native's lock and temporary builds (listed in .gitignore).
REF_BUILD_DIR = native.BUILD_DIR
REF_WAIT_S = 60.0     # how long a worker tries before it gives up
REF_SETTLED_S = 2.0   # a library file untouched this long is no longer
                      # being written by a compiler


def _whole_library(path):
    """Is `path` a complete 64-bit ELF file that no compiler is writing:
    its section header table, which the linker writes last, lies inside
    the file, and the file has not changed for REF_SETTLED_S?"""
    try:
        st = os.stat(path)
        with open(path, "rb") as f:
            head = f.read(64)
    except OSError:
        return False
    if len(head) < 64 or head[:5] != b"\x7fELF\x02":
        return False
    (shoff,) = struct.unpack_from("<Q", head, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", head, 0x3A)
    return (st.st_size >= shoff + shentsize * shnum
            and time.time() - st.st_mtime >= REF_SETTLED_S)


def _build_reference(target):
    """brush_tpu.native's sources, with its own g++ flags (OpenMP, else
    none), into a temporary file in REF_BUILD_DIR, renamed onto `target`
    at once: a load never sees this build half-written."""
    tmp = os.path.join(REF_BUILD_DIR, f"brush_tpu_native.{os.getpid()}.tmp")
    sources = [os.path.join(j_native._DIR, s) for s in j_native._SOURCES]
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, *sources]
    for flags in (["-fopenmp"], []):
        try:
            subprocess.run(cmd + flags, check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, target)
        return True
    return False


def reference_native():
    """brush_tpu.native loaded, in a process whose first load lost the
    race: where g++ exists, under an exclusive lock on a file in
    REF_BUILD_DIR, wait until its library is a whole file that loads;
    build it (_build_reference) when no such file is there, clear the
    module's sticky failure and load again; retry for up to REF_WAIT_S.
    Returns whether the library is loaded."""
    if j_native.available():
        return True
    if shutil.which("g++") is None:
        return False
    os.makedirs(REF_BUILD_DIR, exist_ok=True)
    deadline = time.monotonic() + REF_WAIT_S
    with open(os.path.join(REF_BUILD_DIR, "brush_tpu_native.lock"),
              "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            while True:
                target = j_native._LIB_PATH
                if _whole_library(target) or _build_reference(target):
                    j_native._build_failed = False
                    j_native._lib = None
                    if j_native.available():
                        return True
                if time.monotonic() > deadline:
                    return False
                time.sleep(1.0)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture(autouse=True)
def native_library():
    if shutil.which("g++") is None:
        pytest.skip("no g++ here to build the native libraries")
    assert native.available(), "g++ is here, and the port's library fails"
    assert reference_native(), "g++ is here, and brush_tpu's library fails"


def _points(case):
    rng = np.random.default_rng(3)
    return {
        "uniform": rng.uniform(-2.0, 2.0, (5000, 3)),
        "normal_k5": rng.normal(size=(3000, 3)) * 10.0,
        "duplicates": np.zeros((10, 3)),          # tests/test_native.py:28
        "clustered": np.repeat(rng.normal(size=(50, 3)), 7, axis=0),
        "fewer_than_k": rng.normal(size=(2, 3)),
        "one": rng.normal(size=(1, 3)),
        "empty": np.zeros((0, 3)),
    }[case].astype(np.float32)


@pytest.mark.parametrize("case", ["uniform", "normal_k5", "duplicates",
                                  "clustered", "fewer_than_k", "one",
                                  "empty"])
def test_knn_distances_match_reference(case):
    """Bit-equal to brush_tpu.native.knn_distances: the same source and
    flags; with fewer points than k the missing neighbours count 0."""
    pts = _points(case)
    k = 5 if case == "normal_k5" else 3
    got = native.knn_distances(pts, k)
    want = j_native.knn_distances(pts, k)
    assert got.dtype == np.float32 and got.shape == (pts.shape[0],)
    np.testing.assert_array_equal(got, want)
    if case == "duplicates":
        np.testing.assert_array_equal(got, 0.0)


@pytest.mark.parametrize("case", ["uniform", "normal_k5", "clustered"])
def test_knn_distances_match_brute_force(case):
    """Within 1e-6 relative of knn_mean_distance, the exact brute force
    the port runs where no g++ builds the library."""
    pts = _points(case)
    k = 5 if case == "normal_k5" else 3
    got = native.knn_distances(pts, k)
    want = knn_mean_distance(torch.tensor(pts), k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_knn_distances_check_arguments():
    with pytest.raises(ValueError, match="positions"):
        native.knn_distances(np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError, match="k"):
        native.knn_distances(np.zeros((4, 3), np.float32), 0)


@pytest.mark.parametrize("count", [2000, 2])
def test_from_random_scales_match_reference(count):
    """from_random on the same seed: extents bit-equal to brush_tpu's
    (its native KD-tree), log-scales within 1 ulp (the log's rounding)."""
    assert knn_route() == "native"
    sp = from_random(np.random.default_rng(0), [-1.5] * 3, [1.5] * 3,
                     count=count, sh_degree=1, device="cpu")
    js = j_from_random(np.random.default_rng(0), [-1.5] * 3, [1.5] * 3,
                       count=count, sh_degree=1)
    pos = np.asarray(js.means)[:count]
    np.testing.assert_array_equal(sp.means[:count].numpy(), pos)
    np.testing.assert_array_equal(knn_extents(pos, "cpu").numpy(),
                                  j_knn_mean_distance(pos, 3))
    np.testing.assert_array_max_ulp(sp.log_scales[:count].numpy(),
                                    np.asarray(js.log_scales)[:count],
                                    maxulp=1)


def test_knn_route_without_native_is_device(monkeypatch):
    """With the native library hidden, the route is the brute force on the
    points' device, chosen once, and the scales agree within 1e-6."""
    pts = _points("uniform")
    want = knn_extents(pts, "cpu").numpy()
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "knn_distances", lambda *a: pytest.fail(
        "the native k-NN ran on the device route"))
    knn_route.cache_clear()
    try:
        assert splats.knn_route() == "device"
        got = knn_extents(pts, "cpu").numpy()
    finally:
        knn_route.cache_clear()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_knn_large_is_fast():
    """tests/test_native.py:35-45's bound: 200k points under 10 s."""
    pts = np.random.default_rng(1).normal(size=(200_000, 3)).astype(
        np.float32)
    t0 = time.perf_counter()
    out = native.knn_distances(pts, 3)
    dt = time.perf_counter() - t0
    assert np.isfinite(out).all() and (out > 0).all()
    assert dt < 10.0, f"kd-tree too slow: {dt:.1f} s for 200k points"


def test_reference_native_recovers_from_a_half_written_library(
        tmp_path, monkeypatch):
    """A worker whose brush_tpu.native load met a half-written library (the
    load failed and the failure stuck; loading the truncated file here
    would not even fail cleanly, dlopen can fault on it): reference_native
    ends with the library loaded from a whole file, whose k-NN is the
    port's bit for bit. Every patched global is restored afterwards."""
    with open(j_native._LIB_PATH, "rb") as f:
        whole = f.read()
    lib = tmp_path / "libbrush_native.so"
    lib.write_bytes(whole[:len(whole) // 3])
    monkeypatch.setattr(j_native, "_LIB_PATH", str(lib))
    monkeypatch.setattr(j_native, "_lib", None)
    monkeypatch.setattr(j_native, "_build_failed", True)
    monkeypatch.setattr(sys.modules[__name__], "REF_BUILD_DIR",
                        str(tmp_path))
    assert not _whole_library(str(lib)) and not j_native.available()
    assert reference_native()
    assert j_native._lib is not None and not j_native._build_failed
    assert os.path.getsize(lib) > len(whole) // 3
    pts = _points("uniform")
    np.testing.assert_array_equal(j_native.knn_distances(pts, 3),
                                  native.knn_distances(pts, 3))
