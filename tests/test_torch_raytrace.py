"""The port's ray-traced castle and quality harness against the JAX repo's.

brush_tpu_torch/datasets/raytrace.py against scripts/raytrace_scene.py
(numpy; its functions need Pillow only for the PNG and JPEG files, which
this file asks of them only in the JPEG comparison): the scene's arrays,
the traced images on the CPU (hit masks equal, RGBA within 1e-6, missed
rays exactly zero), the surface points, and the two dataset layouts
loaded by both packages' load_dataset. Then the harvest of
docs/castle_r5_30k.ply on traced views through the port's eval_view
against brush_tpu's eval_view (its XLA render on the CPU), and the
harness scripts scripts/torch_train_synth.py and scripts/torch_harvest.py
at a tiny size.
"""

import importlib.util
import os
import re
import subprocess
import sys
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brush_tpu.datasets import load_dataset as j_load_dataset
from brush_tpu.datasets.colmap import _read_points3d_bin as j_points
from brush_tpu.datasets.loading import LoadDatasetArgs as JArgs
from brush_tpu.datasets.nerf import camera_from_transform as j_cam
from brush_tpu.datasets.ply import load_splats_from_ply as j_load_ply
from brush_tpu.eval import eval_view as j_eval_view

from brush_tpu_torch.constants import SH_C0
from brush_tpu_torch.datasets import load_dataset, png
from brush_tpu_torch.datasets import raytrace as rt
from brush_tpu_torch.datasets import testing as dt
from brush_tpu_torch.datasets.colmap import _read_points3d_bin
from brush_tpu_torch.datasets.loading import LoadDatasetArgs
from brush_tpu_torch.datasets.nerf import camera_from_transform
from brush_tpu_torch.datasets.ply import load_splats_from_ply
from brush_tpu_torch.eval import eval_view
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.ops.sh import view_colors
from brush_tpu_torch.train import SplatTrainer
from brush_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_datasets import assert_dataset_equal
from torch_threads import pin_threads

pin_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASTLE_PLY = os.path.join(ROOT, "docs", "castle_r5_30k.ply")
FOV = dt.CASTLE_FOV_X


def script(name: str):
    """scripts/NAME.py as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def rs():
    return script("raytrace_scene")


def script_u8(img: np.ndarray) -> np.ndarray:
    """scripts/raytrace_scene.py:_png_bytes' quantization."""
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def loaded_u8(image: np.ndarray) -> np.ndarray:
    """A loader's float32 pixels (u8 / 255) back as u8."""
    return np.rint(image * 255.0).astype(np.uint8)


def test_build_scene_equals_script(rs):
    want, got = rs.build_scene(), rt.build_scene()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), k)


# 3 train views (orbit seed 1) and 2 val views (seed 2) at 64x48.
VIEWS = [("train", 1, 3, i) for i in range(3)] + [("val", 2, 2, i)
                                                   for i in range(2)]


@pytest.mark.parametrize("split,seed,n,i", VIEWS,
                         ids=[f"{s}{i}" for s, _, _, i in VIEWS])
def test_render_view_matches_script(rs, split, seed, n, i):
    c2w = rs._views(n, seed)[i]
    np.testing.assert_array_equal(dt.orbit_views(n, seed)[i], c2w)
    scene = rs.build_scene()
    want = rs.render_view(scene, c2w, 64, 48, FOV)
    got = rt.render_view(rt.build_scene(), c2w, 64, 48, FOV, device="cpu",
                         chunk=1000)
    assert got.dtype == torch.float32 and got.shape == (48, 64, 4)
    got = got.numpy()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    assert 0.2 < got[..., 3].mean() < 0.9
    assert (got[got[..., 3] == 0] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        rt.quantize_u8(torch.from_numpy(got)).numpy(), script_u8(want))


def test_surface_points_equal_script(rs):
    want = rs._surface_points(rs.build_scene(), 3000)
    got = rt.surface_points(rt.build_scene(), 3000)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_nerf_scene_loads_alike_in_both_packages(rs, tmp_path):
    path = str(tmp_path / "castle.zip")
    rt.write_nerf_scene(path, rt.build_scene(), 3, 2, 32, device="cpu")
    t, j = load_dataset(path), j_load_dataset(path)
    assert_dataset_equal(t, j)
    assert (len(t.train.views), len(t.eval.views)) == (3, 2)
    scene = rs.build_scene()
    for views, c2ws in ((t.train.views, rs._views(3, 1)),
                        (t.eval.views, rs._views(2, 2))):
        for view, c2w in zip(views, c2ws):
            assert view.image.shape == (32, 32, 4)
            np.testing.assert_array_equal(
                loaded_u8(view.image),
                script_u8(rs.render_view(scene, c2w, 32, 32, FOV)))
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == sorted(
            [f"train/r_{i}.png" for i in range(3)]
            + [f"val/r_{i}.png" for i in range(2)]
            + ["transforms_train.json", "transforms_val.json"])


# The script's COLMAP JPEGs (Pillow, quality 96, its default 4:2:0 chroma
# subsampling, which at 32x32 blurs colour across whole primitives)
# against the port's lossless PNGs of the same views: within 10/255 on
# average and 160/255 at a pixel (measured: means 3.6/255 to 7.2/255 a
# view, the largest pixel 138/255).
JPEG_MEAN_TOL, JPEG_MAX_TOL = 10 / 255, 160 / 255


def test_colmap_scene_loads_alike_in_both_packages(rs, tmp_path):
    path = str(tmp_path / "castle_colmap.zip")
    rt.write_colmap_scene(path, rt.build_scene(), 5, 32, device="cpu")
    args = dict(eval_split_every=3)
    t = load_dataset(path, LoadDatasetArgs(**args))
    assert_dataset_equal(t, j_load_dataset(path, JArgs(**args)))
    assert (len(t.train.views), len(t.eval.views)) == (3, 2)

    scene = rs.build_scene()
    views = [v for _, v in sorted(
        [(int(re.search(r"(\d+)", v.name).group(1)), v)
         for v in t.train.views + t.eval.views], key=lambda p: p[0])]
    for view, c2w in zip(views, rs._views(5, 1)):
        img = rs.render_view(scene, c2w, 32, 32, FOV)
        white = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
        assert view.image.shape == (32, 32, 3)
        np.testing.assert_array_equal(loaded_u8(view.image),
                                      script_u8(white))

    with zipfile.ZipFile(path) as zf:
        data = zf.read("sparse/0/points3D.bin")
        assert sorted(n for n in zf.namelist() if n.startswith("images/")) \
            == [f"images/r_{i}.png" for i in range(5)]
    pts, cols = rs._surface_points(scene, rt.COLMAP_POINTS)
    for got in (_read_points3d_bin(data), j_points(data)):
        np.testing.assert_array_equal(got[0], pts.astype(np.float32))
        np.testing.assert_array_equal(
            got[1], np.clip(cols * 255, 0, 255).astype(np.uint8)
            .astype(np.float32) / np.float32(255.0))

    # The script's own COLMAP zip: the same cameras and split, JPEG pixels.
    jpath = str(tmp_path / "script_colmap.zip")
    rs.write_colmap_zip(jpath, scene, 5, 32)
    j = j_load_dataset(jpath, JArgs(**args))
    for ts, js in ((t.train, j.train), (t.eval, j.eval)):
        assert len(ts.views) == len(js.views)
        for tv, jv in zip(ts.views, js.views):
            for f in ("position", "rotation", "center_uv"):
                np.testing.assert_array_equal(getattr(tv.camera, f),
                                              getattr(jv.camera, f))
            assert (tv.camera.fov_x, tv.camera.fov_y) == (jv.camera.fov_x,
                                                          jv.camera.fov_y)
            err = np.abs(tv.image - jv.image)
            assert err.mean() <= JPEG_MEAN_TOL and err.max() <= JPEG_MAX_TOL


def pinned(ts, js, cam, size):
    """Both packages' castle with the splats whose view colour leaves the
    record pipeline's u16 range (and [-3.9, 3.9]) carrying that colour,
    clamped, as a DC term alone: tests/test_torch_castle.py's pinning, so
    the port's pipeline and brush_tpu's XLA render see the same colours."""
    col = view_colors(ts.means, ts.sh_coeffs,
                      camera_params(cam, size, device="cpu"))
    out = (col.abs() > 3.9).any(dim=1) & ts.active_mask()
    sh = ts.sh_coeffs.clone()
    sh[out] = 0.0
    sh[out, 0] = (col[out].clamp(-3.9, 3.9) - 0.5) / SH_C0
    return (ts.replace(sh_coeffs=sh),
            js.replace(sh_coeffs=jnp.asarray(sh.numpy())), int(out.sum()))


HARVEST_SIZE = 160


@pytest.mark.parametrize("view", [0, 1])
def test_harvest_matches_reference(view):
    """PSNR and SSIM of the trained castle on a traced val view at
    160x160, block size 512: the port's eval_view (the record pipeline,
    the plain kernels on the CPU) against brush_tpu's (its XLA render and
    metrics on the CPU), within 0.01 dB and 1e-4 (measured 1e-5 dB and
    7e-7)."""
    with open(CASTLE_PLY, "rb") as f:
        data = f.read()
    size = (HARVEST_SIZE, HARVEST_SIZE)
    c2w = dt.orbit_views(16, seed=2)[view]
    img = rt.render_view(rt.build_scene(), c2w, *size, FOV, device="cpu")
    gt = rt.quantize_u8(img).numpy().astype(np.float32) / 255.0
    cam = camera_from_transform(c2w, FOV, *size)
    ts, js, n_pinned = pinned(load_splats_from_ply(data, device="cpu"),
                              j_load_ply(data), cam, size)
    assert 40 < n_pinned < 100
    got = eval_view(ts, cam, gt, block_size=512)
    want = j_eval_view(js, j_cam(c2w, FOV, *size), gt, block_size=512)
    assert got.dropped == 0
    assert 15.0 < got.psnr < 40.0
    assert abs(got.psnr - want.psnr) <= 0.01
    assert abs(got.ssim - want.ssim) <= 1e-4


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("raytrace") / "tiny.zip")
    rt.write_nerf_scene(path, rt.build_scene(), 6, 2, 32, device="cpu")
    return path


def test_train_synth_script_runs(tiny_scene, capsys):
    mod = script("torch_train_synth")
    assert mod.main([tiny_scene, "21", "1024", "256", "10", "1", "32",
                     "--device", "cpu", "--min-psnr", "5"]) == 0
    text = capsys.readouterr().out
    assert text.count("  eval PSNR ") == 2
    m = re.search(r"FINAL: PSNR (\S+) SSIM (\S+) splats (\d+) ", text)
    assert m and np.isfinite(float(m[1])) and np.isfinite(float(m[2]))
    assert int(m[3]) == 256


@pytest.mark.parametrize("model", ["ply", "ckpt"])
def test_harvest_script_runs(tiny_scene, tmp_path, capsys, model):
    mod = script("torch_harvest")
    prefix = str(tmp_path / "castle")
    path = CASTLE_PLY
    if model == "ckpt":
        with open(CASTLE_PLY, "rb") as f:
            splats = load_splats_from_ply(f.read(), device="cpu")
        path = save_checkpoint(str(tmp_path / "ckpt_0000300.npz"),
                               SplatTrainer().init_state(splats), 300)
    assert mod.main([tiny_scene, path, prefix, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    views = re.findall(r"view (\d+): PSNR (\S+) SSIM (\S+)", text)
    assert [v[0] for v in views] == ["0", "1"]
    m = re.search(r"MEAN over 2 views: PSNR (\d+\.\d{3}) SSIM (\d\.\d{4})",
                  text)
    assert m and abs(float(m[1]) - np.mean([float(v[1]) for v in views])) \
        < 1e-3
    grid = png.decode_png(open(f"{prefix}_views.png", "rb").read())
    # A row of three 32x32 panels for each of the two views.
    assert grid.shape == (64, 96, 3)
    # A checkpoint's splats are exported beside the grid.
    assert os.path.exists(f"{prefix}.ply") == (model == "ckpt")
    if model == "ckpt":
        assert "checkpoint step 300" in text
        with open(f"{prefix}.ply", "rb") as f:
            assert load_splats_from_ply(f.read(), device="cpu").n_live \
                == 90977


def test_harness_imports_neither_jax_nor_the_reference():
    """The tracer and the harness scripts load no module of JAX, of
    brush_tpu or of scripts/raytrace_scene.py."""
    code = (
        "import importlib.util, os, sys\n"
        "import brush_tpu_torch.datasets.raytrace\n"
        "for n in ('torch_raytrace_scene', 'torch_harvest', "
        "'torch_train_synth', 'torch_trace_overhead'):\n"
        "    spec = importlib.util.spec_from_file_location(n, os.path.join("
        "'scripts', n + '.py'))\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brush_tpu', 'raytrace_scene'))\n"
        "assert not bad, bad\nprint('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
