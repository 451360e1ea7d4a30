"""The port's native k-NN (brush_tpu_torch/native/knn.cpp) against
brush_tpu.native's and against the brute force, and the initial splat
scales it gives, on the CPU. Skips only where g++ cannot build the native
library, as tests/test_native.py does.
"""

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


@pytest.fixture(autouse=True)
def native_library():
    if not native.available():
        pytest.skip("g++ cannot build the native library here")
    if not j_native.available():
        pytest.skip("g++ cannot build brush_tpu's native library here")


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
