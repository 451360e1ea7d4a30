"""The port's package boundary and data types against brush_tpu: import
isolation, constants, camera, Splats construction, the model converter,
and PLY import (including the trained castle model in docs/)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import brush_tpu.constants as jconst
from brush_tpu.camera import Camera as JCamera
from brush_tpu.camera import rotmat_to_quat as j_rotmat_to_quat
from brush_tpu.datasets.ply import load_splats_from_ply as j_load_ply
from brush_tpu.datasets.ply import splats_to_ply as j_to_ply
from brush_tpu.splats import from_random as j_from_random

import brush_tpu_torch.constants as tconst
from brush_tpu_torch.camera import Camera, rotmat_to_quat
from brush_tpu_torch.convert import splats_from_numpy
from brush_tpu_torch.datasets.ply import load_splats_from_ply
from brush_tpu_torch.splats import from_random, knn_mean_distance
from torch_threads import pin_threads

pin_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASTLE = os.path.join(ROOT, "docs", "castle_r5_30k.ply")


def _np(splats):
    return {k: v.cpu().numpy() for k, v in splats.params().items()}


def test_import_loads_neither_jax_nor_brush_tpu():
    code = (
        "import sys, brush_tpu_torch, brush_tpu_torch.render, "
        "brush_tpu_torch.eval, brush_tpu_torch.datasets.ply, "
        "brush_tpu_torch.convert, brush_tpu_torch.train, "
        "brush_tpu_torch.optim, brush_tpu_torch.config, "
        "brush_tpu_torch.ops.cuda.rasterize_bwd, "
        "brush_tpu_torch.ops.cuda.segsum, brush_tpu_torch.utils.profiler\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brush_tpu'))\n"
        "assert not bad, bad\nprint('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_constants_match_reference():
    for name in ("TILE_WIDTH", "TILE_SIZE", "COV_BLUR", "NEAR_PLANE_Z",
                 "ALPHA_EPS", "ALPHA_MAX", "TRANSMITTANCE_EPS", "SH_C0"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    for d in range(5):
        assert tconst.sh_coeffs_for_degree(d) == jconst.sh_coeffs_for_degree(d)
        c = jconst.sh_coeffs_for_degree(d)
        assert tconst.sh_degree_from_coeffs(c) == d
    with pytest.raises(ValueError):
        tconst.sh_degree_from_coeffs(5)


def test_camera_matches_reference():
    kw = dict(position=[0.4, -1.0, -5.0], rotation=[0.9, 0.1, -0.3, 0.2],
              fov_x=1.1, fov_y=0.8, center_uv=[0.45, 0.55])
    jc, tc = JCamera(**kw), Camera(**kw)
    for size in [(640, 480), (33, 17)]:
        np.testing.assert_array_equal(tc.focal(size), jc.focal(size))
        np.testing.assert_array_equal(tc.center(size), jc.center(size))
    np.testing.assert_array_equal(tc.world_to_local(), jc.world_to_local())
    np.testing.assert_array_equal(tc.local_to_world(), jc.local_to_world())
    rng = np.random.default_rng(2)
    for q in rng.normal(size=(16, 4)):
        rot = Camera([0, 0, 0], q / np.linalg.norm(q), 1.0,
                     1.0).local_to_world()[:3, :3]
        np.testing.assert_array_equal(rotmat_to_quat(rot),
                                      j_rotmat_to_quat(rot))


def test_from_random_makes_the_reference_draws():
    js = j_from_random(np.random.default_rng(3), [-1, -2, -3], [1, 2, 3],
                       count=300, sh_degree=2)
    ts = from_random(np.random.default_rng(3), [-1, -2, -3], [1, 2, 3],
                     count=300, sh_degree=2, device="cpu")
    assert ts.capacity == js.capacity and ts.n_live == int(js.n_live)
    jp = {k: np.asarray(v) for k, v in js.params().items()}
    tp = _np(ts)
    for k in ("means", "sh_coeffs", "quats", "raw_opacity"):
        np.testing.assert_array_equal(tp[k], jp[k], k)
    # The reference's log scales come from its own 3-NN (KD-tree or an
    # |a|^2+|b|^2-2ab brute force that cancels for near points); the
    # port's distances are exact float32 differences.
    np.testing.assert_allclose(tp["log_scales"], jp["log_scales"],
                               atol=1e-3)
    np.testing.assert_array_equal(ts.active_mask().numpy(),
                                  np.asarray(js.active_mask()))


def test_knn_mean_distance_is_exact():
    rng = np.random.default_rng(4)
    # A cluster far from the origin: the case the expanded form cancels.
    p = (rng.normal(size=(500, 3)) * 1e-3 + 100.0).astype(np.float32)
    d2 = ((p[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1)
    want = np.sqrt(np.sort(d2, axis=1)[:, :3].sum(1)) / 3
    got = knn_mean_distance(torch.tensor(p), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert knn_mean_distance(torch.tensor(p[:2]), 3).shape == (2,)


def test_convert_carries_reference_leaves():
    js = j_from_random(np.random.default_rng(5), [-1] * 3, [1] * 3,
                       count=100, sh_degree=1, capacity=256)
    params = {k: np.asarray(v) for k, v in js.params().items()}
    ts = splats_from_numpy(params, int(js.n_live), device="cpu")
    assert ts.n_live == 100 and ts.capacity == 256
    for k, v in _np(ts).items():
        np.testing.assert_array_equal(v, params[k], k)
    with pytest.raises(ValueError, match="missing"):
        splats_from_numpy({"means": params["means"]}, 1, device="cpu")
    with pytest.raises(ValueError, match="n_live"):
        splats_from_numpy(params, 1000, device="cpu")


def test_castle_ply_loads_like_reference():
    with open(CASTLE, "rb") as f:
        data = f.read()
    js = j_load_ply(data)
    ts = load_splats_from_ply(data, device="cpu")
    assert ts.n_live == int(js.n_live) == 90977
    assert ts.capacity == js.capacity and ts.sh_count == 16
    jp = {k: np.asarray(v) for k, v in js.params().items()}
    for k, v in _np(ts).items():
        np.testing.assert_array_equal(v, jp[k], k)


@pytest.mark.parametrize("encoding", ["binary", "ascii"])
def test_ply_round_trip_from_reference_export(encoding):
    js = j_from_random(np.random.default_rng(6), [-1] * 3, [1] * 3,
                       count=20, sh_degree=1)
    data = j_to_ply(js)
    if encoding == "ascii":
        head, body = data.split(b"end_header\n")
        rows = np.frombuffer(body, np.float32).reshape(20, -1)
        text = "\n".join(" ".join(repr(float(x)) for x in r) for r in rows)
        data = (head.replace(b"binary_little_endian", b"ascii")
                + b"end_header\n" + text.encode())
    ts = load_splats_from_ply(data, device="cpu")
    jp = {k: np.asarray(v) for k, v in j_load_ply(data).params().items()}
    for k, v in _np(ts).items():
        np.testing.assert_array_equal(v, jp[k], k)
    with pytest.raises(ValueError, match="end_header"):
        load_splats_from_ply(b"ply\n", device="cpu")
