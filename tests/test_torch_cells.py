"""Raster cells (cell=(gw, gh)) in the port against brush_tpu.

The JAX package honours the cell only on its Pallas path, so the render
is held to render_splats(backend="pallas") in interpret mode on the CPU,
on the scene of tests/test_pipeline.py:251-328 (300 splats, 80x48: 5x3
tiles, a grid that no tested cell divides). The port runs on CPU tensors,
i.e. through the plain versions of its kernels. The JAX trainer and CLI
render through XLA on the CPU, which ignores the cell: those tests hold the
port's cell grouping to the exact tile path.
"""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close_quantized

from brush_tpu import cli as j_cli
from brush_tpu.camera import Camera as JCamera
from brush_tpu.ops.binning import precompute_tile_masks as j_masks
from brush_tpu.ops.rasterize_reference import camera_params as j_cp
from brush_tpu.ops.rasterize_tiled import assemble_image as j_assemble
from brush_tpu.render import pack_decode_rows as j_decode
from brush_tpu.render import render_splats as j_render
from brush_tpu.splats import from_random as j_from_random

from brush_tpu_torch import cli
from brush_tpu_torch.camera import Camera
from brush_tpu_torch.convert import splats_from_numpy
from brush_tpu_torch.ops.binning import precompute_tile_masks
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.render import assemble_image, pack_decode_rows
from brush_tpu_torch.render import render_splats
from test_torch_cli import TRAIN, nerf_zip, read_metrics  # noqa: F401
from test_torch_ops import _proj_both, _scene
from test_torch_train import steps_match_reference

CELLS = [(2, 1), (2, 2), (4, 2), (3, 1)]
CAM = dict(position=[0, 0, -6.0], rotation=[1, 0, 0, 0], fov_x=np.pi / 3,
           fov_y=np.pi / 3)
SIZE = (80, 48)
# The port at a cell against its own tile path: the per-pixel arithmetic is
# the same (pixel coordinates are absolute), but a cell's bbox rounds a
# splat's 3-sigma tile bbox out to whole cells, so at a cell a splat also
# reaches pixels past that bbox where its alpha still passes 1/255 (an opaque
# splat's fringe; tests/test_torch_castle.py shows it on the castle, in both
# packages). No splat of this scene has such a fringe, so the two are equal
# but for float32 summation order in the plain version's block math
# (measured <= 1.2e-7) and alpha-threshold flips.
SELF_ATOL = 1e-6


def scene(n=300, seed=5):
    """test_pipeline.py's _scene: the JAX splats and the port's copy."""
    js = j_from_random(np.random.default_rng(seed), [-2, -2, -2], [2, 2, 2],
                       count=n, sh_degree=1)
    ts = splats_from_numpy({k: np.asarray(v) for k, v in js.params().items()},
                           int(js.n_live), device="cpu")
    return js, ts


def j_args(js, size):
    return (js.means, js.log_scales, js.quats, js.sh_coeffs, js.raw_opacity,
            j_cp(JCamera(**CAM), size), size)


def t_args(ts, size):
    return (ts.means, ts.log_scales, ts.quats, ts.sh_coeffs, ts.raw_opacity,
            camera_params(Camera(**CAM), size, device="cpu"), size)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_masks_and_decode_rows_match_reference(cell):
    """Counts, masks and `small` of the exact pretest, and the packed
    decode rows, equal brush_tpu/ops/binning.py:123-183 in cell units; some
    splats' cell bboxes exceed 8x8 cells (the conservative bbox records)."""
    sc = _scene(n=600, seed=4)
    sc["log_scales"][:40] += 3.0
    jp, tp = _proj_both(sc, (640, 448))
    opac = np.random.default_rng(5).uniform(0.002, 1.0, 600).astype(
        np.float32)
    jm = j_masks(jp, jnp.asarray(opac), cell=cell)
    tm = precompute_tile_masks(tp, torch.tensor(opac), cell=cell)
    for f in ("counts", "mask_lo", "mask_hi", "pc_pack", "small"):
        np.testing.assert_array_equal(
            getattr(tm, f).numpy(),
            np.asarray(getattr(jm, f)).astype(getattr(tm, f).numpy().dtype),
            f)
    assert (~tm.small.numpy() & (tm.counts.numpy() > 0)).any()
    prod_j = jp.visible & (jm.counts > 0)
    prod_t = tp.visible & (tm.counts > 0)
    jd = j_decode(jp, jm, jnp.where(prod_j, jm.counts, 0), cell=cell)
    td = pack_decode_rows(tp, tm, torch.where(prod_t, tm.counts, 0),
                          cell=cell)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd).astype(np.int64))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_image_matches_pallas_and_tiles(cell):
    """The image at a cell against the Pallas pipeline at the same cell
    (the tolerance of tests/test_pipeline.py:270-272: the TPU kernel takes
    sigma in the cell's frame as a polynomial), the same records and drops;
    and against the port's own (1, 1) image within SELF_ATOL."""
    js, ts = scene()
    kw = dict(active=None, block_size=128, max_isects=2048, needs_grad=False)
    img_j, aux_j = j_render(*j_args(js, SIZE), backend="pallas",
                            scan_passes=3, cell=cell,
                            **dict(kw, active=js.active_mask()))
    img_t, aux_t = render_splats(*t_args(ts, SIZE), cell=cell,
                                 **dict(kw, active=ts.active_mask()))
    img_1, aux_1 = render_splats(*t_args(ts, SIZE),
                                 **dict(kw, active=ts.active_mask()))
    assert img_t.shape == (48, 80, 4)
    assert_close_quantized(img_t.numpy(), np.asarray(img_j), atol=2e-3,
                           flip_tol=0.05, max_flip_frac=2e-3,
                           err_msg=f"cell {cell} vs pallas")
    assert_close_quantized(img_t.numpy(), img_1.numpy(), atol=SELF_ATOL,
                           flip_tol=0.05, max_flip_frac=2e-3,
                           err_msg=f"cell {cell} vs (1, 1)")
    for f in ("num_visible", "num_isects", "num_dropped"):
        assert int(getattr(aux_t, f)) == int(getattr(aux_j, f)), f
    assert 0 < int(aux_t.num_isects) < int(aux_1.num_isects)
    assert int(aux_t.num_dropped) == 0


def test_cell_grads_match_pallas():
    """The five parameter gradients of sum(img^2) at cell (2, 2) with exact
    float32 cotangents, against jax.grad through the Pallas pipeline at the
    same cell, scaled by the reference's largest value, with the bound of
    tests/test_pipeline.py:322-328."""
    import jax

    js, ts = scene(n=200, seed=6)
    size = (48, 48)
    kw = dict(block_size=128, max_isects=2048, cell=(2, 2),
              pack_grad_sort=False)
    cpj = j_cp(JCamera(**CAM), size)

    def f(means, log_scales, quats, sh, opac):
        img, _ = j_render(means, log_scales, quats, sh, opac, cpj, size,
                          active=js.active_mask(), backend="pallas",
                          scan_passes=3, **kw)
        return jnp.sum(img ** 2)

    g_j = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        js.means, js.log_scales, js.quats, js.sh_coeffs, js.raw_opacity)
    params = [p.clone().requires_grad_(True) for p in t_args(ts, size)[:5]]
    img, _ = render_splats(*params, *t_args(ts, size)[5:],
                           active=ts.active_mask(), **kw)
    (img ** 2).sum().backward()
    for name, p, want in zip(("means", "log_scales", "quats", "sh_coeffs",
                              "raw_opacity"), params, g_j):
        a, b = p.grad.numpy(), np.asarray(want)
        assert np.isfinite(a).all(), name
        scale = max(np.abs(b).max(), 1e-6)
        assert_close_quantized(a / scale, b / scale, atol=1e-3,
                               flip_tol=0.1, max_flip_frac=5e-3,
                               err_msg=f"cell grads {name}")


@pytest.mark.parametrize("cell", [(3, 1), (4, 2)])
def test_assemble_image_matches_reference(cell):
    """Cell blocks row-major over the cell, a grid that does not divide the
    image (80x48: 5x3 tiles, so 2x3 cells of (3, 1), 2x2 of (4, 2))."""
    gw, gh = cell
    cells_x, cells_y = -(-5 // gw), -(-3 // gh)
    blocks = np.random.default_rng(7).normal(
        size=(cells_x * cells_y, 256 * gw * gh, 4)).astype(np.float32)
    want = np.asarray(j_assemble(jnp.asarray(blocks), SIZE, cells_x, cells_y,
                                 cell=cell))
    got = assemble_image(torch.tensor(blocks), SIZE, cells_x, cells_y, cell)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cell_trainer_steps_match_reference():
    """SplatTrainer(raster_cell=(2, 2)) against the JAX trainer with the
    same knob, three steps at the bounds of
    tests/test_torch_train.py:steps_match_reference (losses within 1e-5).
    The JAX trainer's CPU render ignores the cell, so this holds the port's
    cell grouping to the exact path."""
    steps_match_reference(3, raster_cell=(2, 2))


def test_cli_train_cell_matches_reference(nerf_zip, tmp_path):  # noqa: F811
    """`cli --device cpu train --cell 2x2` (its evals at the cell too)
    against `brush_tpu.cli train --cell 2x2`, whose CPU render is the exact
    path: the per-step losses within 1e-5, as at (1, 1)
    (tests/test_torch_cli.py), and the eval PSNR within 1e-3 dB."""
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    argv = ["train", "--source", nerf_zip, *TRAIN, "--eval-every", "2",
            "--cell", "2x2"]
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["--device", "cpu", *argv, "--checkpoint-dir", str(tdir)])
        j_cli.main(["--platform", "cpu", *argv, "--checkpoint-dir",
                    str(jdir)])
    t_log, j_log = read_metrics(str(tdir)), read_metrics(str(jdir))
    t_loss = [(r["step"], r["loss"]) for r in t_log if "loss" in r]
    j_loss = [(r["step"], r["loss"]) for r in j_log if "loss" in r]
    assert [s for s, _ in t_loss] == [s for s, _ in j_loss] == [0, 1, 2, 3]
    for (_, a), (_, b) in zip(t_loss, j_loss):
        assert np.isfinite(a) and abs(a - b) <= 1e-5, (a, b)
    t_psnr = [r["eval_psnr"] for r in t_log if "eval_psnr" in r]
    j_psnr = [r["eval_psnr"] for r in j_log if "eval_psnr" in r]
    assert len(t_psnr) == len(j_psnr) == 1
    assert abs(t_psnr[0] - j_psnr[0]) <= 1e-3
    assert os.path.exists(tdir / "ckpt_final.npz")
