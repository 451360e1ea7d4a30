"""The port's XLA backend against brush_tpu's, on the CPU.

ops/binning.build_intersections (and the box test under it),
ops/rasterize_tiled.make_rasterizer and render_splats(backend="xla"), each
fed the same inputs as its brush_tpu counterpart: scenes made from numpy
seeds, JAX on the CPU (jitted where it compiles a loop), the port on CPU
tensors. Both sides are exact float32, so the tolerances are float32
rounding: summation orders differ (XLA's fused reductions and cumsums,
torch's bmm and index_add_).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brush_tpu.camera import Camera as JCamera
from brush_tpu.ops.binning import build_intersections as j_build
from brush_tpu.ops.binning import can_be_visible as j_can_be_visible
from brush_tpu.ops.binning import ellipse_intersects_aabb as j_ellipse
from brush_tpu.ops.projection import project_splats as j_project
from brush_tpu.ops.rasterize_reference import camera_params as j_cp
from brush_tpu.ops.rasterize_tiled import make_rasterizer as j_rasterizer
from brush_tpu.render import render_splats as j_render

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.constants import SH_C0
from brush_tpu_torch.ops.binning import (
    build_intersections, can_be_visible, ellipse_intersects_aabb,
    precompute_tile_masks,
)
from brush_tpu_torch.ops.projection import project_splats
from brush_tpu_torch.ops.rasterize_reference import (
    camera_params, render_oracle,
)
from brush_tpu_torch.ops.rasterize_tiled import make_rasterizer
from brush_tpu_torch.render import render_splats
from torch_threads import pin_threads

pin_threads()

CAM = dict(position=[0.3, -0.2, -7.0], rotation=[0.99, 0.05, -0.08, 0.03],
           fov_x=1.4, fov_y=1.2)
NAMES = ("means", "log_scales", "quats", "sh_coeffs", "raw_opacity")


def cams(img_size):
    """The same camera for both packages (rotation normalized once)."""
    rot = np.asarray(CAM["rotation"]) / np.linalg.norm(CAM["rotation"])
    kw = dict(CAM, rotation=rot)
    return (j_cp(JCamera(**kw), img_size),
            camera_params(Camera(**kw), img_size, device="cpu"))


def scene(n, seed, sh_degree=1, big=0, behind=0, opac=(0.1, 0.3)):
    """Random anisotropic splats (float32 numpy): `big` of them with
    scales past an 8x8-tile bbox, `behind` of them behind the camera."""
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    sh = np.zeros((n, k, 3))
    sh[:, 0] = (rng.uniform(0, 1, (n, 3)) - 0.5) / SH_C0
    sh[:, 1:] = rng.normal(0, 0.2, (n, k - 1, 3))
    means = rng.uniform(-2.5, 2.5, (n, 3))
    means[:behind, 2] = -9.0 - rng.uniform(0, 2, behind)
    ls = np.log(rng.uniform(0.05, 0.6, (n, 3)))
    ls[behind:behind + big] += 2.0
    o = rng.uniform(*opac, n)
    sc = dict(means=means, log_scales=ls, quats=rng.normal(size=(n, 4)),
              sh_coeffs=sh, raw_opacity=np.log(o / (1 - o)))
    return {k: v.astype(np.float32) for k, v in sc.items()}


def projections(sc, img_size):
    jcp, tcp = cams(img_size)
    q = sc["quats"] / np.linalg.norm(sc["quats"], axis=1, keepdims=True)
    jp = jax.jit(functools.partial(j_project, img_size=img_size))(
        jnp.asarray(sc["means"]), jnp.asarray(sc["log_scales"]),
        jnp.asarray(q), jcp.viewmat, jcp.focal, jcp.pixel_center)
    tp = project_splats(torch.tensor(sc["means"]),
                        torch.tensor(sc["log_scales"]), torch.tensor(q),
                        tcp.viewmat, tcp.focal, tcp.pixel_center, img_size)
    return jp, tp


def sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x.astype(np.float64)))).astype(np.float32)


# name: (n, image, pool, align, big, behind). big: splats whose bbox
# exceeds 8 tiles (the bbox fallback); "overflow*": a pool smaller than
# the records; "slot_bits": 65,536 tiles leave 15 slot bits, fewer than
# the pool needs, so the tile grouping takes the stable-sort fallback.
BIN_CASES = {
    "align1": (600, (320, 224), 1 << 14, 1, 0, 0),
    "align512": (600, (320, 224), 1 << 14, 512, 0, 0),
    "bbox_fallback": (600, (320, 224), 1 << 15, 1, 40, 0),
    "overflow": (600, (320, 224), 2000, 1, 40, 0),
    "overflow_align512": (600, (320, 224), 4096, 512, 40, 0),
    "behind_camera": (600, (320, 224), 1 << 14, 1, 0, 250),
    "empty": (300, (320, 224), 1 << 12, 512, 0, 300),
    "slot_bits": (40, (4096, 4096), 1 << 18, 1, 0, 0),
}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_build_intersections_matches_reference(case):
    """Every field equal to brush_tpu's, bit for bit (integer bookkeeping
    on the same projection; the projections agree exactly here)."""
    n, size, pool, align, big, behind = BIN_CASES[case]
    sc = scene(n, seed=4, big=big, behind=behind, opac=(0.002, 1.0))
    jp, tp = projections(sc, size)
    opac = sigmoid(sc["raw_opacity"])
    tiles = (-(-size[0] // 16), -(-size[1] // 16))
    ji = jax.jit(functools.partial(j_build, tile_bounds=tiles,
                                   max_isects=pool, align=align))(
        jp, jnp.asarray(opac))
    ti = build_intersections(tp, torch.tensor(opac), tiles, pool,
                             align=align)
    for f in ji._fields:
        np.testing.assert_array_equal(
            getattr(ti, f).numpy(),
            np.asarray(getattr(ji, f)).astype(getattr(ti, f).numpy().dtype),
            err_msg=f"{case} {f}")
    visible, isects = int(ti.num_visible), int(ti.num_isects)
    dropped = int(ti.num_dropped)
    if case == "empty":
        assert visible == 0 and isects == 0 and dropped == 0
        return
    assert isects > 0
    assert (dropped > 0) == case.startswith("overflow")
    if case == "behind_camera":
        assert 0 < visible <= n - behind
    if big:
        m = precompute_tile_masks(tp, torch.tensor(opac))
        assert bool((~m.small & ti.producing).any())
    if align > 1:
        s = ti.starts.numpy()
        assert (s[s < pool] % align == 0).all()
        pad = ti.isect_gid.numpy() == n
        assert pad.any()


def test_box_test_matches_reference():
    """ellipse_intersects_aabb and can_be_visible on 50,000 random boxes,
    conics (some near-degenerate) and opacities (some below 1/255), at
    cells (1, 1) and (2, 2): equal to brush_tpu's but for at most 1 in
    10,000 boundary flips (float32 rounding of the same polynomial;
    measured 0)."""
    rng = np.random.default_rng(9)
    m = 50_000
    a = rng.uniform(1.0, 400.0, m)     # covariances: radii up to 20 px
    c = rng.uniform(1.0, 400.0, m)
    b = rng.uniform(-1, 1, m) * np.sqrt(a * c)
    b[:2000] = np.sqrt(a[:2000] * c[:2000]) * (1 - 1e-6)   # near-singular
    det = a * c - b * b
    conic = (np.stack([c, -b, a], 1) / det[:, None]).astype(np.float32)
    ext = rng.choice([4.0, 8.0, 16.0], (m, 2)).astype(np.float32)
    box = rng.uniform(0, 160, (m, 2)).astype(np.float32)
    xy = (box + rng.normal(0, 20, (m, 2))).astype(np.float32)
    opac = rng.uniform(0.001, 1.0, m).astype(np.float32)
    tx = np.floor(xy[:, 0] / 16 + rng.normal(0, 1, m)).astype(np.int32)
    ty = np.floor(xy[:, 1] / 16 + rng.normal(0, 1, m)).astype(np.int32)
    t = torch.tensor
    got = ellipse_intersects_aabb(
        t(box[:, 0]), t(box[:, 1]), t(ext[:, 0]), t(ext[:, 1]), t(xy[:, 0]),
        t(xy[:, 1]), *(t(conic[:, i]) for i in range(3))).numpy()
    want = np.asarray(j_ellipse(
        jnp.asarray(box[:, 0]), jnp.asarray(box[:, 1]),
        jnp.asarray(ext[:, 0]), jnp.asarray(ext[:, 1]),
        jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1]),
        *(jnp.asarray(conic[:, i]) for i in range(3))))
    assert 0.05 < want.mean() < 0.95
    assert (got != want).sum() <= m // 10_000
    for cell in ((1, 1), (2, 2)):
        got = can_be_visible(t(tx), t(ty), t(xy), t(conic), t(opac),
                             cell=cell).numpy()
        want = np.asarray(j_can_be_visible(
            jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(xy),
            jnp.asarray(conic), jnp.asarray(opac), cell=cell))
        assert 0.01 < want.mean() < 0.99, cell
        assert (got != want).sum() <= m // 10_000, cell


def raster_inputs(seed=7, size=(64, 48), n=300, pool=1 << 14):
    """brush_tpu's binning of a scene, and the compact attributes: the
    same arrays feed both rasterizers."""
    sc = scene(n, seed, opac=(0.1, 0.9))
    jp, _ = projections(sc, size)
    opac = sigmoid(sc["raw_opacity"])
    tiles = (-(-size[0] // 16), -(-size[1] // 16))
    isect = jax.jit(functools.partial(j_build, tile_bounds=tiles,
                                      max_isects=pool))(jp, jnp.asarray(opac))
    order = np.asarray(isect.order)
    rng = np.random.default_rng(seed + 1)
    attrs = dict(xy=np.asarray(jp.xy)[order],
                 conic=np.asarray(jp.conic)[order],
                 color=rng.uniform(-0.5, 1.5, (n, 3)).astype(np.float32),
                 opac=opac[order])
    recs = dict(isect_gid=np.asarray(isect.isect_gid),
                starts=np.asarray(isect.starts), ends=np.asarray(isect.ends),
                tile_ids=np.arange(tiles[0] * tiles[1], dtype=np.int32))
    cot = rng.normal(size=(tiles[0] * tiles[1], 256, 4)).astype(np.float32)
    return tiles, pool, attrs, recs, cot


def port_raster(tiles, pool, attrs, recs, cot, block):
    raster = make_rasterizer(tiles[0], tiles[0] * tiles[1], pool, block)
    a = {k: torch.tensor(v, requires_grad=True) for k, v in attrs.items()}
    img = raster(*a.values(), *(torch.tensor(v) for v in recs.values()))
    (img * torch.tensor(cot)).sum().backward()
    return img.detach().numpy(), [a[k].grad.numpy() for k in attrs]


def assert_rows_close(got, want, rtol, what):
    """Each gradient component (a column) within rtol of its largest."""
    for name, g, w in zip(("xy", "conic", "color", "opac"), got, want):
        g = g.reshape(g.shape[0], -1)
        w = w.reshape(w.shape[0], -1)
        scale = np.abs(w).max(axis=0)
        assert (scale > 0).all(), f"{what} {name}"
        np.testing.assert_array_less(np.abs(g - w).max(axis=0),
                                     rtol * scale, err_msg=f"{what} {name}")


@pytest.mark.parametrize("block", [8, 32])
def test_rasterizer_matches_reference(block):
    """make_rasterizer on brush_tpu's records against brush_tpu's: the
    image within 1e-5, the four gradients (of a seeded cotangent) within
    1e-4 of each component's largest value."""
    tiles, pool, attrs, recs, cot = raster_inputs()
    img, grads = port_raster(tiles, pool, attrs, recs, cot, block)
    raster = j_rasterizer(tiles[0], tiles[0] * tiles[1], pool, block)
    fn = jax.jit(lambda *a: raster(*a, *(jnp.asarray(v)
                                         for v in recs.values())))
    img_j, vjp = jax.vjp(fn, *(jnp.asarray(v) for v in attrs.values()))
    grads_j = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    assert float(img_j[..., 3].max()) > 0.5
    np.testing.assert_allclose(img, np.asarray(img_j), atol=1e-5, rtol=0)
    assert_rows_close(grads, grads_j, 1e-4, f"block {block}")


def test_rasterizer_block_size_invariance():
    """Rounds of 8 and of 64 records give the same image within 1e-5 (as
    tests/test_render_tiled.py:163 holds brush_tpu's) and the same
    gradients within 1e-5 of each component's largest."""
    args = raster_inputs(seed=11)
    img_a, g_a = port_raster(*args, block=8)
    img_b, g_b = port_raster(*args, block=64)
    np.testing.assert_allclose(img_a, img_b, atol=1e-5, rtol=0)
    assert_rows_close(g_a, g_b, 1e-5, "block 8 against 64")


def test_rasterizer_checks_tile_ids():
    raster = make_rasterizer(4, 12, 64, 8)
    z = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="tile_ids"):
        raster(z, torch.zeros(3, 3), torch.zeros(3, 3), torch.zeros(3),
               torch.zeros(64, dtype=torch.int64),
               torch.zeros(12, dtype=torch.int64),
               torch.zeros(12, dtype=torch.int64),
               torch.arange(6))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_render_xla_matches_reference(degree):
    """render_splats(backend="xla") with gradients against brush_tpu's
    (jitted): 200 splats and 40 padding rows at 64x48, SH degree 0-3, a
    seeded image cotangent. The image within 1e-5; the gradients of the
    five parameters and of xy_dummy within 1e-4 of each one's largest
    entry; RenderAux equal field by field. And the image against the
    port's dense render_oracle within 2e-5 (brush_tpu's own bound for its
    XLA render at low opacity, tests/test_render_tiled.py:59)."""
    size = (64, 48)
    cap, live = 240, 200
    sc = scene(cap, seed=20 + degree, sh_degree=degree)
    active = np.arange(cap) < live
    cot = np.random.default_rng(degree).normal(
        size=(size[1], size[0], 4)).astype(np.float32)
    jcp, tcp = cams(size)

    @jax.jit
    def j_grads(*p):
        def loss(*p):
            img, aux = j_render(*p[:5], jcp, size, xy_dummy=p[5],
                                active=jnp.asarray(active), backend="xla",
                                block_size=16)
            return jnp.sum(img * cot), (img, aux)
        return jax.value_and_grad(loss, argnums=tuple(range(6)),
                                  has_aux=True)(*p)

    (_, (img_j, aux_j)), g_j = j_grads(
        *(jnp.asarray(sc[k]) for k in NAMES), jnp.zeros((cap, 2)))
    p = [torch.tensor(sc[k], requires_grad=True) for k in NAMES]
    dummy = torch.zeros((cap, 2), requires_grad=True)
    img, aux = render_splats(*p, tcp, size, xy_dummy=dummy,
                             active=torch.tensor(active), backend="xla",
                             block_size=16)
    (img * torch.tensor(cot)).sum().backward()

    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j),
                               atol=1e-5, rtol=0)
    for name, a, b in zip(NAMES + ("xy_dummy",), p + [dummy], g_j):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0, name
        assert np.abs(a.grad.numpy()[live:]).max() == 0, name
        np.testing.assert_allclose(a.grad.numpy() / scale, b / scale,
                                   atol=1e-4, rtol=0, err_msg=name)
    for f in aux_j._fields:
        np.testing.assert_array_equal(getattr(aux, f).numpy(),
                                      np.asarray(getattr(aux_j, f)), f)
    assert int(aux.num_isects) > 0 and int(aux.num_dropped) == 0
    oracle = render_oracle(*(torch.tensor(sc[k]) for k in NAMES), tcp, size,
                           active=torch.tensor(active))
    np.testing.assert_allclose(img.detach().numpy(), oracle.numpy(),
                               atol=2e-5, rtol=0)


def test_render_xla_without_grad_and_pool():
    """needs_grad=False runs the same path without autograd, bit-equal;
    the pool is max_isects as given (not rounded as the record pipeline
    rounds it), so a pool short of the records drops what brush_tpu's XLA
    path drops."""
    size = (64, 48)
    sc = scene(200, seed=3)
    _, tcp = cams(size)
    p = [torch.tensor(sc[k], requires_grad=True) for k in NAMES]
    img, aux = render_splats(*p, tcp, size, backend="xla")
    img_ng, aux_ng = render_splats(*p, tcp, size, backend="xla",
                                   needs_grad=False)
    assert img.requires_grad and not img_ng.requires_grad
    assert torch.equal(img.detach(), img_ng)
    assert torch.equal(aux.order, aux_ng.order)
    pool = int(aux.num_isects) - 100
    _, aux_t = render_splats(*p, tcp, size, backend="xla", max_isects=pool,
                             needs_grad=False)
    jcp, _ = cams(size)
    _, aux_j = jax.jit(lambda *q: j_render(*q, jcp, size, backend="xla",
                                           max_isects=pool))(
        *(jnp.asarray(sc[k]) for k in NAMES))
    assert int(aux_t.num_dropped) == int(aux_j.num_dropped) == 100
    assert int(aux_t.num_isects) == int(aux_j.num_isects) == pool
