"""The port at a real scene's scale against brush_tpu, on the CPU.

The trained castle (docs/castle_r5_30k.ply: 90,977 splats, SH degree 3)
seen from a camera of its training orbit, rendered with gradients by
brush_tpu.render.render_splats(backend="xla") and by the port's pipeline
on CPU tensors (the plain versions of its kernels): the image, and the
gradients of sum(img^2) with respect to all five parameters; the same
view by the port's XLA backend against brush_tpu's; and a crop of the
castle at raster cell (2, 2) against (1, 1), in both packages.

The record pipeline (the port's, and the reference's Pallas one) stores
colours as u16 over [-4, 4] (ops/cuda/rasterize_fwd.quantize_color), which
the XLA path does not. 56 of the castle's splats leave that range in this
view (up to 17.4; their DC coefficients reach 40), and the blue of the
pixels they cover differs by up to 0.02 between the two paths. So for the
pipeline case both packages render a copy of the castle whose
out-of-range splats keep their view colour, clamped to [-3.9, 3.9], as a
DC term alone.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close_quantized

from brush_tpu.datasets.nerf import camera_from_transform as j_cam
from brush_tpu.datasets.ply import load_splats_from_ply as j_load
from brush_tpu.ops.rasterize_reference import camera_params as j_cp
from brush_tpu.render import render_splats as j_render

from brush_tpu_torch.camera import focal_to_fov, fov_to_focal
from brush_tpu_torch.constants import SH_C0
from brush_tpu_torch.datasets import testing as dt
from brush_tpu_torch.datasets.nerf import camera_from_transform
from brush_tpu_torch.datasets.ply import load_splats_from_ply
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.ops.sh import view_colors
from brush_tpu_torch.render import render_splats
from torch_threads import pin_threads

pin_threads()

CASTLE_PLY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "castle_r5_30k.ply")
NAMES = ("means", "log_scales", "quats", "sh_coeffs", "raw_opacity")
VIEW = 200   # the 800x800 training views at a quarter of their width
# name: (image side, field of view): the view at 200x200 (marked slow), and
# its central 96x96 window (the same focal length), which tier 1 runs.
CASES = {"view": (VIEW, dt.CASTLE_FOV_X),
         "crop": (96, focal_to_fov(fov_to_focal(dt.CASTLE_FOV_X, VIEW), 96))}


@pytest.fixture(scope="module")
def castle():
    with open(CASTLE_PLY, "rb") as f:
        data = f.read()
    return j_load(data), load_splats_from_ply(data, device="cpu")


@pytest.mark.parametrize("case", [
    pytest.param("view", marks=pytest.mark.slow),   # 23-33 s on the CPU
    "crop"])
def test_castle_matches_reference_xla(castle, case):
    """Image: assert_close_quantized's defaults (the u16 quantization bound
    2e-4, counted threshold flips; measured at most 9 of the 160,000
    values beyond it, the largest 8.3e-3). Gradients, each scaled by the
    reference's largest entry: tests/test_torch_render_grads.py's rule, the
    bulk within 3e-4 and at most 2e-3 of the entries up to 0.05 (measured
    <= 1e-3 of the entries, the largest 0.019, on the quaternions)."""
    js, ts = castle
    side, fov = CASES[case]
    size = (side, side)
    c2w = dt.orbit_views(1, seed=1)[0]
    cp = camera_params(camera_from_transform(c2w, fov, side, side), size,
                       device="cpu")
    col = view_colors(ts.means, ts.sh_coeffs, cp)
    out = ((col.abs() > 3.9).any(dim=1) & ts.active_mask())
    assert 40 < int(out.sum()) < 100
    sh = ts.sh_coeffs.clone()
    sh[out] = 0.0
    sh[out, 0] = (col[out].clamp(-3.9, 3.9) - 0.5) / SH_C0
    ts = ts.replace(sh_coeffs=sh)
    js = js.replace(sh_coeffs=jnp.asarray(sh.numpy()))

    cpj = j_cp(j_cam(c2w, fov, side, side), size)

    def f(*params):
        img, _ = j_render(*params, cpj, size, active=js.active_mask(),
                          backend="xla")
        return jnp.sum(img ** 2), img

    (_, img_j), g_j = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4),
                                         has_aux=True)(
        *(getattr(js, k) for k in NAMES))
    params = [getattr(ts, k).clone().requires_grad_(True) for k in NAMES]
    img, aux = render_splats(*params, cp, size, active=ts.active_mask())
    (img ** 2).sum().backward()
    assert int(aux.num_dropped) == 0 and int(aux.num_isects) > 50_000
    assert float(img.detach()[..., 3].mean()) > 0.1
    assert_close_quantized(img.detach().numpy(), np.asarray(img_j),
                           err_msg=f"castle {case} image")
    for name, p, want in zip(NAMES, params, g_j):
        a, b = p.grad.numpy(), np.asarray(want)
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max()
        assert scale > 0, name
        assert_close_quantized(a / scale, b / scale, atol=3e-4, flip_tol=0.05,
                               err_msg=f"castle {case} grad {name}")


def test_castle_xla_matches_reference_xla(castle):
    """The port's XLA backend against brush_tpu's at 200x200, both exact
    float32, so no colour is pinned (the out-of-range splats render as
    they are on both sides), with gradients of sum(img^2). Image: within
    1e-5 but for at most 5e-4 of the values, each within 5e-3 (alpha and
    transmittance threshold flips of float32 rounding; measured 27 of
    160,000 beyond 1e-5, the largest 1.9e-3). Gradients, each scaled by
    the reference's largest entry: within 1e-4 but for at most 5e-4 of the
    entries, each within 0.02 (measured at most 1.4e-4 of them, on the
    means, the largest 0.0104), tighter than the pipeline case's 3e-4,
    2e-3 and 0.05."""
    js, ts = castle
    side, fov = CASES["view"]
    size = (side, side)
    c2w = dt.orbit_views(1, seed=1)[0]
    cp = camera_params(camera_from_transform(c2w, fov, side, side), size,
                       device="cpu")
    cpj = j_cp(j_cam(c2w, fov, side, side), size)

    @jax.jit
    def grads(*params):
        def f(*params):
            img, _ = j_render(*params, cpj, size, active=js.active_mask(),
                              backend="xla")
            return jnp.sum(img ** 2), img
        return jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4),
                                  has_aux=True)(*params)

    (_, img_j), g_j = grads(*(getattr(js, k) for k in NAMES))
    params = [getattr(ts, k).clone().requires_grad_(True) for k in NAMES]
    img, aux = render_splats(*params, cp, size, active=ts.active_mask(),
                             backend="xla")
    (img ** 2).sum().backward()
    assert int(aux.num_dropped) == 0 and int(aux.num_isects) > 150_000
    assert_close_quantized(img.detach().numpy(), np.asarray(img_j),
                           atol=1e-5, flip_tol=5e-3, max_flip_frac=5e-4,
                           err_msg="castle xla image")
    for name, p, want in zip(NAMES, params, g_j):
        a, b = p.grad.numpy(), np.asarray(want)
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max()
        assert scale > 0, name
        assert_close_quantized(a / scale, b / scale, atol=1e-4,
                               flip_tol=0.02, max_flip_frac=5e-4,
                               err_msg=f"castle xla grad {name}")


def test_castle_cell_fringe_matches_pallas(castle):
    """A cell's image differs from the tile path's where an opaque splat's
    alpha still passes 1/255 past its 3-sigma tile bbox and the cell's bbox,
    rounded out to whole cells, reaches those pixels. brush_tpu's Pallas
    pipeline (interpret mode) shows the same: the central 128x128 window of
    an 800x800 view, at (2, 2) against (1, 1), in each package. The pixels
    that move by more than 2e-3 are the same (measured 14 of 16,384, up to
    0.0212 in both), and the two packages' changes agree within 1e-5
    (measured 4.5e-6), with the JAX cell rule's flips allowed (its kernel
    takes sigma in the cell's frame as a polynomial)."""
    js, ts = castle
    side = 128
    fov = focal_to_fov(fov_to_focal(dt.CASTLE_FOV_X, 800), side)
    size = (side, side)
    c2w = dt.orbit_views(1, seed=1)[0]
    cp = camera_params(camera_from_transform(c2w, fov, side, side), size,
                       device="cpu")
    cpj = j_cp(j_cam(c2w, fov, side, side), size)
    kw = dict(max_isects=1 << 16, needs_grad=False)
    change = []
    for render, s, c, act in ((j_render, js, cpj, js.active_mask()),
                              (render_splats, ts, cp, ts.active_mask())):
        extra = dict(backend="pallas", scan_passes=3) \
            if render is j_render else {}
        img = {}
        for cell in ((1, 1), (2, 2)):
            im, aux = render(*(getattr(s, k) for k in NAMES), c, size,
                             active=act, cell=cell, **kw, **extra)
            assert int(aux.num_dropped) == 0
            img[cell] = np.asarray(im)
        change.append(img[(2, 2)] - img[(1, 1)])
    moved = [np.abs(d).max(-1) > 2e-3 for d in change]
    print(f"cell (2, 2) against (1, 1): {int(moved[0].sum())} (brush_tpu), "
          f"{int(moved[1].sum())} (port) pixels beyond 2e-3, up to "
          f"{np.abs(change[0]).max()}, {np.abs(change[1]).max()}; changes "
          f"apart by up to {np.abs(change[1] - change[0]).max()}")
    assert moved[1].sum() >= 10
    np.testing.assert_array_equal(moved[1], moved[0])
    assert_close_quantized(change[1], change[0], atol=1e-5, flip_tol=0.05,
                           err_msg="cell (2, 2) change")
