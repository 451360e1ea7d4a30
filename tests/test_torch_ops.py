"""The port's per-splat stages against brush_tpu: SH, projection, the
dense oracle, the tile pretest and the decode rows.

Inputs are made once with numpy and handed to both packages. XLA on the
CPU may contract and reorder float32 arithmetic that PyTorch evaluates op
by op, so float results are held to a few float32 ulps (rtol 1e-5) and
integer results (radii, tile bboxes, masks, counts) must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close_quantized

from brush_tpu.camera import Camera as JCamera
from brush_tpu.ops.binning import popcount_u32 as j_popcount
from brush_tpu.ops.binning import precompute_tile_masks as j_masks
from brush_tpu.ops.projection import Projection as JProjection
from brush_tpu.ops.projection import project_splats as j_project
from brush_tpu.ops.rasterize_reference import camera_params as j_cp
from brush_tpu.ops.rasterize_reference import pixel_grid as j_pixel_grid
from brush_tpu.ops.rasterize_reference import render_oracle as j_oracle
from brush_tpu.ops.sh import sh_basis as j_sh_basis
from brush_tpu.ops.sh import sh_to_color as j_sh_to_color
from brush_tpu.render import pack_decode_rows as j_decode

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.ops.binning import (
    popcount_u32, precompute_tile_masks, precompute_tile_masks_plain,
)
from brush_tpu_torch.ops.cuda import build
from brush_tpu_torch.ops.cuda.testing import (
    HAND_PRETEST_CASES, HAND_PRETEST_CELLS, hand_pretest,
)
from brush_tpu_torch.ops.projection import Projection, project_splats
from brush_tpu_torch.ops.rasterize_reference import (
    camera_params, pixel_grid, render_oracle,
)
from brush_tpu_torch.ops.sh import (
    sh_basis, sh_coeffs_grad_plain, sh_to_color, view_colors,
    view_dirs_plain,
)
from brush_tpu_torch.render import pack_decode_rows
from torch_threads import pin_threads

pin_threads()

CAM = dict(position=[0.3, -0.2, -6.0], rotation=[0.99, 0.05, -0.08, 0.03],
           fov_x=1.4, fov_y=1.2)


def _cams(img_size):
    jc = JCamera(**CAM)
    jc.rotation = jc.rotation / np.linalg.norm(jc.rotation)
    tc = Camera(**CAM)
    tc.rotation = tc.rotation / np.linalg.norm(tc.rotation)
    return j_cp(jc, img_size), camera_params(tc, img_size, device="cpu")


def _scene(n=400, seed=0, thin=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ls = np.log(rng.uniform(0.02, 0.6, (n, 3)))
    # Near-singular covariances: two tiny axes make the projected 2x2
    # covariance cancel in float32 (det may round to <= 0).
    ls[:thin, 1:] = -12.0
    sc = {
        "means": rng.uniform(-3, 3, (n, 3)),
        "log_scales": ls,
        "quats": q,
        "sh_coeffs": rng.normal(0, 0.5, (n, 9, 3)),
        "raw_opacity": rng.normal(0, 2, n),
    }
    return {k: v.astype(np.float32) for k, v in sc.items()}


def _proj_both(sc, img_size):
    jcp, tcp = _cams(img_size)
    jp = j_project(jnp.asarray(sc["means"]), jnp.asarray(sc["log_scales"]),
                   jnp.asarray(sc["quats"]), jcp.viewmat, jcp.focal,
                   jcp.pixel_center, img_size)
    tp = project_splats(torch.tensor(sc["means"]),
                        torch.tensor(sc["log_scales"]),
                        torch.tensor(sc["quats"]), tcp.viewmat, tcp.focal,
                        tcp.pixel_center, img_size)
    return jp, tp


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_matches_reference(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(300, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    k = (degree + 1) ** 2
    coeffs = rng.normal(size=(300, k + 2, 3)).astype(np.float32)
    np.testing.assert_allclose(
        sh_basis(degree, torch.tensor(d)).numpy(),
        np.asarray(j_sh_basis(degree, jnp.asarray(d))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        sh_to_color(degree, torch.tensor(d), torch.tensor(coeffs)).numpy(),
        np.asarray(j_sh_to_color(degree, jnp.asarray(d),
                                 jnp.asarray(coeffs))),
        rtol=1e-5, atol=1e-5)


def test_sh_degree_out_of_range_raises():
    with pytest.raises(ValueError):
        sh_basis(5, torch.zeros(1, 3))


@pytest.mark.parametrize("extra", [0, 2])
@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_coeffs_grad_plain_is_autograds(degree, extra):
    """The backward kernel's twin against autograd's gradient of
    sh_to_color with respect to the coefficients, bit for bit (int32
    views: torch.equal takes -0 for +0), with zeros of both signs in the
    colour's gradient. At degree 0 autograd's one select adds no zero-filled
    slice, so its -0 products stay -0 where the twin's + 0 gives +0: the
    values are compared there."""
    rng = np.random.default_rng(30 + degree)
    n, k = 300, (degree + 1) ** 2 + extra
    d = rng.normal(size=(n, 3))
    d = torch.tensor((d / np.linalg.norm(d, axis=1, keepdims=True)
                      ).astype(np.float32))
    coeffs = torch.tensor(rng.normal(size=(n, k, 3)).astype(np.float32),
                          requires_grad=True)
    g = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32))
    g[::7] = 0.0
    g[1::9, 1] = -0.0
    (want,) = torch.autograd.grad(sh_to_color(degree, d, coeffs), coeffs, g)
    got = sh_coeffs_grad_plain(degree, d, g, k)
    assert got.shape == (n, k, 3)
    assert not got[:, (degree + 1) ** 2:].any()
    if degree == 0:
        assert torch.equal(got, want)
        assert bool((want.view(torch.int32) != got.view(torch.int32)).any())
    else:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_view_dirs_plain_within_an_ulp_of_vector_norms():
    """The kernels' directions (their norm's squares summed as (x x + z z)
    + y y) against view_colors' CPU path (torch.linalg.vector_norm)."""
    rng = np.random.default_rng(5)
    means = torch.tensor(rng.uniform(-4, 4, (2000, 3)).astype(np.float32))
    campos = torch.tensor([0.3, -0.2, -6.0])
    d = means - campos
    want = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=1e-12)
    got = view_dirs_plain(means, campos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2.4e-7,
                               atol=0)


def test_view_colors_on_cpu_launches_nothing():
    """CPU tensors take the plain code: the SH kernels' launch counts
    stay where they were, and the colour is sh_to_color's at
    vector_norm's directions."""
    sc = _scene(n=64)
    _, tcp = _cams((64, 48))
    before = build.launch_counts()
    means = torch.tensor(sc["means"])
    coeffs = torch.tensor(sc["sh_coeffs"], requires_grad=True)
    col = view_colors(means, coeffs, tcp)
    col.sum().backward()
    assert build.launch_counts() == before
    d = means - tcp.viewmat[:3, 3]
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                        min=1e-12)
    assert torch.equal(col, sh_to_color(2, d, coeffs))


@pytest.mark.parametrize("thin", [0, 60])
def test_projection_matches_reference(thin):
    sc = _scene(thin=thin)
    img_size = (160, 96)
    jp, tp = _proj_both(sc, img_size)
    vis = np.asarray(jp.visible)
    np.testing.assert_array_equal(tp.visible.numpy(), vis)
    assert 0 < vis.sum() < vis.size
    np.testing.assert_allclose(tp.xy.numpy()[vis], np.asarray(jp.xy)[vis],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tp.depth.numpy(), np.asarray(jp.depth),
                               rtol=1e-6)
    # Conics of the near-singular splats are ill-conditioned (they are the
    # inverse of a cancelling 2x2): compare those only for finiteness.
    ok = vis.copy()
    ok[:thin] = False
    np.testing.assert_allclose(tp.conic.numpy()[ok],
                               np.asarray(jp.conic)[ok], rtol=2e-4,
                               atol=1e-6)
    assert np.isfinite(tp.conic.numpy()).all()
    assert np.isfinite(tp.xy.numpy()).all()
    for f in ("radius", "tile_min", "tile_max"):
        np.testing.assert_array_equal(getattr(tp, f).numpy()[ok],
                                      np.asarray(getattr(jp, f))[ok], f)


def test_pixel_grid_matches_reference():
    np.testing.assert_array_equal(pixel_grid((7, 5)).numpy(),
                                  np.asarray(j_pixel_grid((7, 5))))


def test_oracle_matches_reference():
    sc = _scene(n=150, seed=3)
    img_size = (48, 40)
    jcp, tcp = _cams(img_size)
    want = j_oracle(*(jnp.asarray(sc[k]) for k in (
        "means", "log_scales", "quats", "sh_coeffs", "raw_opacity")),
        jcp, img_size, block_size=64)
    got = render_oracle(*(torch.tensor(sc[k]) for k in (
        "means", "log_scales", "quats", "sh_coeffs", "raw_opacity")),
        tcp, img_size, block_size=64)
    # Both are unquantized float32; only rounding and rare threshold flips
    # separate them.
    assert_close_quantized(got.numpy(), np.asarray(want), atol=1e-5,
                           err_msg="oracle")


def test_tile_masks_and_decode_rows_match_reference():
    sc = _scene(n=600, seed=4)
    sc["log_scales"][:40] += 2.5     # some bboxes past 8x8 tiles
    img_size = (320, 224)
    jp, tp = _proj_both(sc, img_size)
    rng = np.random.default_rng(5)
    opac = rng.uniform(0.002, 1.0, 600).astype(np.float32)
    jm = j_masks(jp, jnp.asarray(opac))
    tm = precompute_tile_masks(tp, torch.tensor(opac))
    for f in ("counts", "mask_lo", "mask_hi", "pc_pack", "small"):
        np.testing.assert_array_equal(
            getattr(tm, f).numpy(),
            np.asarray(getattr(jm, f)).astype(getattr(tm, f).numpy().dtype),
            f)
    assert (~tm.small.numpy() & (tm.counts.numpy() > 0)).any()
    prod_j = jp.visible & (jm.counts > 0)
    prod_t = tp.visible & (tm.counts > 0)
    jd = j_decode(jp, jm, jnp.where(prod_j, jm.counts, 0))
    td = pack_decode_rows(tp, tm, torch.where(prod_t, tm.counts, 0))
    np.testing.assert_array_equal(td.numpy(),
                                  np.asarray(jd).astype(np.int64))


@pytest.mark.parametrize("cell", HAND_PRETEST_CELLS)
@pytest.mark.parametrize("case", HAND_PRETEST_CASES)
def test_hand_pretest_layouts_match_reference(case, cell):
    """The plain twin of the pretest kernel on the layouts made by hand
    (ops/cuda/testing.hand_pretest: edges and corners, sign 0, ellipses
    touching a neighbour up to rounding, opacity at 1/255, degenerate and
    NaN conics, bboxes of 0 to 9x9 cells): every output equal to the
    reference's. The card tests hold the kernel to this twin."""
    d = hand_pretest(case, cell)
    n = d["opac"].shape[0]
    rest = dict(depth=np.ones(n, np.float32), radius=np.ones(n, np.int32))
    keys = ("xy", "depth", "conic", "radius", "tile_min", "tile_max",
            "visible")
    jp = JProjection(*(jnp.asarray({**d, **rest}[k]) for k in keys))
    tp = Projection(*(torch.tensor({**d, **rest}[k]) for k in keys))
    jm = j_masks(jp, jnp.asarray(d["opac"]), cell=cell)
    tm = precompute_tile_masks_plain(tp, torch.tensor(d["opac"]), cell=cell)
    for f in ("counts", "mask_lo", "mask_hi", "pc_pack", "small"):
        np.testing.assert_array_equal(
            getattr(tm, f).numpy(),
            np.asarray(getattr(jm, f)).astype(getattr(tm, f).numpy().dtype),
            f)
    if case == "touch":   # the ulp steps cross the boundary
        assert len(set(tm.counts.tolist())) > 1


def test_popcount_u32_wraps_like_reference():
    v = np.concatenate([
        np.array([0, 1, 0xFF, 0x80000000, 0xFFFFFFFF, 0xF0F0F0F0],
                 np.uint32),
        np.random.default_rng(6).integers(0, 2**32, 500, dtype=np.uint32)])
    want = np.asarray(j_popcount(jnp.asarray(v)))
    # Held as int64 values and as int32 bit patterns (high bit set).
    got64 = popcount_u32(torch.tensor(v.astype(np.int64))).numpy()
    got32 = popcount_u32(torch.tensor(v.view(np.int32))).numpy()
    np.testing.assert_array_equal(got64, want)
    np.testing.assert_array_equal(got32, want)
    np.testing.assert_array_equal(want, [bin(int(x)).count("1") for x in v])

