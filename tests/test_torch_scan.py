"""The TPU kernels' truncated log-T scan (scan_passes < 3) in the port.

brush_tpu's shipping paths run both rasterizer kernels at scan_passes=2:
within each batch of k_lanes records, log T's prefix sums take every term
cut to two bfloat16 parts (brush_tpu/ops/pallas/rasterize_fwd.py:153-197).
The port's plain versions (CPU tensors) are held here to the Pallas
kernels in interpret mode at 2 and at 3, on a layout made so that the two
settings give a different final_idx (ops/cuda/testing.scan_edge), on a
deep tile where the backward's truncated carries drift, at raster cells,
on a strip and on the aligned records; and the port's render and trainer
at their default (2) against brush_tpu's. The CUDA kernels' mode is held
to these plain versions on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close_quantized

from brush_tpu.camera import Camera as JCamera
from brush_tpu.ops.pallas.raster_vjp import (
    make_pallas_rasterizer as j_make_pallas_rasterizer,
)
from brush_tpu.ops.pallas.rasterize_bwd import rasterize_bwd_pallas
from brush_tpu.ops.pallas.rasterize_fwd import rasterize_fwd_pallas
from brush_tpu.ops.rasterize_reference import camera_params as j_cp
from brush_tpu.render import render_splats as j_render

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.ops.cuda import rasterize_bwd as t_bwd
from brush_tpu_torch.ops.cuda import rasterize_fwd as t_raster
from brush_tpu_torch.constants import ALPHA_EPS, ALPHA_MAX
from brush_tpu_torch.ops.cuda.testing import (
    HAND_CELL_CASES, HAND_TILE_CASES, SCAN_EDGE_DEEP, SCAN_EDGE_LANES,
    SCAN_EDGE_PIXELS, T_EPS_SCAN, hand_cells, hand_tiles,
    rasterize_bwd_twin, rasterize_fwd_twin, scan_edge, scan_rest_f32,
    times_exp_f32,
)
from brush_tpu_torch.ops.pipeline import make_pallas_rasterizer, scan_lanes
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.render import render_splats
from test_torch_aligned import _case_inputs, _cotangent
from test_torch_cuda import (
    CAM, flip_check, make_scene, port_records, rows_close,
)
from test_torch_train import steps_match_reference
from torch_threads import pin_threads

pin_threads()

NAMES = ["means", "log_scales", "quats", "sh_coeffs", "raw_opacity"]


def pallas_fwd(packed, starts, ends, tiles_x, passes, k_lanes, cell=(1, 1),
               tile_base=0):
    """rasterize_fwd_pallas in interpret mode on numpy arguments (the pool
    padded by k_lanes slack columns); numpy (img, log_t, fidx)."""
    n = len(starts)
    out = rasterize_fwd_pallas(
        jnp.asarray(np.pad(packed.view(np.uint32), ((0, 0), (0, k_lanes)))),
        jnp.asarray(starts), jnp.asarray(ends),
        tile_base + jnp.arange(n, dtype=jnp.int32), tiles_x=tiles_x,
        num_tiles=n, max_isects=packed.shape[1], k_lanes=k_lanes,
        interpret=True, scan_passes=passes, cell=cell)
    return tuple(np.asarray(o) for o in out)


def pallas_bwd(packed, starts, ends, tiles_x, v_out, log_t, fidx, passes,
               k_lanes, cell=(1, 1), tile_base=0):
    """rasterize_bwd_pallas in interpret mode; numpy rows (9, pool), the
    slots outside every range zeroed (the kernel leaves them unwritten)."""
    n = len(starts)
    pool = packed.shape[1]
    rows = np.asarray(rasterize_bwd_pallas(
        jnp.asarray(np.pad(packed.view(np.uint32), ((0, 0), (0, k_lanes)))),
        jnp.asarray(v_out), jnp.asarray(log_t), jnp.asarray(fidx),
        jnp.asarray(starts), jnp.asarray(ends),
        tile_base + jnp.arange(n, dtype=jnp.int32), tiles_x=tiles_x,
        num_tiles=n, max_isects=pool, k_lanes=k_lanes, interpret=True,
        scan_passes=passes, cell=cell))[:9, :pool]
    return np.where(in_ranges(starts, ends, pool), rows, 0.0)


def in_ranges(starts, ends, pool):
    live = np.zeros(pool, bool)
    for s, e in zip(np.asarray(starts), np.asarray(ends)):
        live[s:e] = True
    return live


def tensors(*arrays):
    """Copies of numpy arrays (JAX's are read-only) as CPU tensors."""
    return [torch.tensor(np.asarray(a)) for a in arrays]


def port_fwd(packed, starts, ends, tiles_x, passes, k_lanes, cell=(1, 1),
             tile_base=0):
    out = t_raster.rasterize_fwd(
        *tensors(packed, starts, ends), tiles_x, cell, tile_base,
        scan_passes=passes, k_lanes=k_lanes)
    return tuple(o.numpy() for o in out)


def port_bwd(packed, starts, ends, tiles_x, v_out, log_t, fidx, passes,
             k_lanes, cell=(1, 1), tile_base=0):
    p, s, e, v, lt, f = tensors(packed, starts, ends, v_out, log_t, fidx)
    return t_bwd.rasterize_bwd(p, s, e, tiles_x, v, lt, f, cell, tile_base,
                               scan_passes=passes, k_lanes=k_lanes).numpy()


@pytest.fixture(scope="module")
def edge():
    """scan_edge's arguments and, at scan_passes 2 and 3, both packages'
    forward outputs; a seeded mixed-sign image cotangent."""
    packed, starts, ends, tiles_x = scan_edge()
    args = (packed, starts, ends, tiles_x)
    fwd = {(side, p): f(*args, p, SCAN_EDGE_LANES)
           for p in (2, 3) for side, f in (("port", port_fwd),
                                           ("pallas", pallas_fwd))}
    v_out = np.random.default_rng(5).normal(
        size=(len(starts), 256, 4)).astype(np.float32)
    return args, fwd, v_out


def test_scan_edge_layout():
    """The named pixels' tiles cross in their second batch, the second
    tile starts off the 128-slot grid, the deep tile spans more than four
    batches."""
    packed, starts, ends, _ = scan_edge()
    assert starts[1] % 128 and starts[0] % 128 == 0
    assert ends[2] - starts[2] == SCAN_EDGE_DEEP > 4 * SCAN_EDGE_LANES
    assert packed.shape[1] >= ends[-1]


@pytest.mark.parametrize("passes", [2, 3])
def test_scan_edge_final_idx_matches_pallas(edge, passes):
    """At scan_passes 2 and 3 the plain forward's final_idx equals the
    Pallas kernel's at every pixel, and its image and T agree within the
    kernel tests' 1e-5 (T = exp(log T), ROADMAP Queue 3 #1)."""
    _, fwd, _ = edge
    img, log_t, fidx = fwd["port", passes]
    img_j, log_t_j, fidx_j = fwd["pallas", passes]
    np.testing.assert_array_equal(fidx, fidx_j)
    flip_check(img, log_t, fidx, img_j, log_t_j, fidx_j, atol=1e-5,
               transmittance=True)


def test_scan_edge_passes_differ(edge):
    """At each named pixel the truncated scan crosses LOG_T_EPS one record
    away from the exact one, in the direction of its records' truncation
    residual, in both packages; the other pixels' final_idx agree."""
    _, fwd, _ = edge
    for side in ("port", "pallas"):
        f2, f3 = fwd[side, 2][2], fwd[side, 3][2]
        named = np.zeros_like(f2, bool)
        for tile, pixel, sign in SCAN_EDGE_PIXELS:
            assert f2[tile, pixel] - f3[tile, pixel] == sign, side
            named[tile, pixel] = True
        np.testing.assert_array_equal(f2[~named], f3[~named])


def test_scan_effect_matches_pallas(edge):
    """The mode's effect, not only its result: (port at 2 - port at 3)
    against (Pallas at 2 - Pallas at 3), with a mixed-sign cotangent.
      - The forward's image and log T: the effect is one record at the
        named pixels (measured 1.04e-5 on the image, 0.072 on log T); the
        difference of effects lies within 1e-6 and 2e-5 (measured 3e-7 and
        2.9e-6, the packages' float32 gap at one setting).
      - The backward's rows, each side on its own forward's outputs: the
        effect (measured 1.1e-4 of a row's largest value) comes from the
        named pixels' final_idx; the difference within 1e-5 (9.9e-7).
      - The backward's rows on one forward's outputs (the Pallas forward's
        at 3): on the deep tile the effect is the truncated carries' drift
        over its five batches (measured 3.0e-6 of a row's largest value),
        and the difference of effects must stay under a quarter of it
        (measured 3.9e-7)."""
    args, fwd, v_out = edge
    for i, (what, bound) in enumerate((("img", 1e-6), ("log_t", 2e-5))):
        eff_t = fwd["port", 2][i] - fwd["port", 3][i]
        eff_j = fwd["pallas", 2][i] - fwd["pallas", 3][i]
        gap = np.abs(eff_t - eff_j).max()
        assert gap <= bound and gap <= 0.1 * np.abs(eff_j).max(), what

    def effects(inputs):
        rows = {(side, p): f(*args, v_out, *inputs(side, p), p,
                             SCAN_EDGE_LANES)
                for p in (2, 3) for side, f in (("port", port_bwd),
                                                ("pallas", pallas_bwd))}
        scale = np.abs(rows["pallas", 3]).max(axis=1, keepdims=True)
        return ((rows["port", 2] - rows["port", 3]) / scale,
                (rows["pallas", 2] - rows["pallas", 3]) / scale)

    eff_t, eff_j = effects(lambda side, p: fwd[side, p][1:])
    gap = np.abs(eff_t - eff_j).max()
    assert np.abs(eff_j).max() > 5e-5 and gap <= 1e-5
    eff_t, eff_j = effects(lambda side, p: fwd["pallas", 3][1:])
    deep = slice(int(args[1][2]), int(args[2][2]))
    drift = np.abs(eff_j[:, deep]).max()
    assert drift > 1e-6 and np.abs(eff_t - eff_j)[:, deep].max() <= 0.25 * drift


@pytest.mark.parametrize("case", ["all_tiles", "deep_cell"])
def test_scan_cells_match_pallas(case):
    """The raster-cell layouts at (2, 2) and scan_passes=2, k_lanes 256
    (the pipeline's budget at that cell, scan_lanes): forward and backward
    against the Pallas kernels in interpret mode."""
    packed, starts, ends, cells_x, cell = hand_cells(case)
    k = scan_lanes(512, cell)
    assert k == 256
    img, log_t, fidx = port_fwd(packed, starts, ends, cells_x, 2, k, cell)
    want = pallas_fwd(packed, starts, ends, cells_x, 2, k, cell)
    flip_check(img, log_t, fidx, *want, atol=1e-5, transmittance=True)
    v_out = np.random.default_rng(6).normal(size=img.shape).astype(
        np.float32)
    got = port_bwd(packed, starts, ends, cells_x, v_out, want[1], want[2],
                   2, k, cell)
    rows = pallas_bwd(packed, starts, ends, cells_x, v_out, want[1],
                      want[2], 2, k, cell)
    rows_close(torch.tensor(got), torch.tensor(rows), 3e-4, case)


def test_scan_strip_matches_pallas():
    """A strip of tiles from tile_base 5 (ranges starting off the 128
    grid) of a scene's records at scan_passes=2: forward and backward
    against the Pallas kernels with tile_ids from tile_base."""
    got = port_records(make_scene(512, seed=21, scale_hi=0.5), (64, 48),
                       2048)
    base, k = 5, 6
    packed = got["packed"].numpy()
    starts = got["starts"][base:base + k].numpy()
    ends = got["ends"][base:base + k].numpy()
    assert (starts % 128).any() and (ends - starts).max() > 0
    args = (packed, starts, ends, got["tiles_x"])
    img, log_t, fidx = port_fwd(*args, 2, 128, tile_base=base)
    want = pallas_fwd(*args, 2, 128, tile_base=base)
    flip_check(img, log_t, fidx, *want, atol=1e-5, transmittance=True)
    v_out = np.random.default_rng(7).normal(size=img.shape).astype(
        np.float32)
    rows_close(
        torch.tensor(port_bwd(*args, v_out, want[1], want[2], 2, 128,
                              tile_base=base)),
        torch.tensor(pallas_bwd(*args, v_out, want[1], want[2], 2, 128,
                                tile_base=base)), 3e-4, "strip")


def test_aligned_rasterizer_runs_forward_2_backward_3():
    """make_pallas_rasterizer as the reference's: the forward at
    scan_passes=2, the backward at 3, over its k_lanes. Its image is the
    plain forward's at 2 bit for bit, and its image (within 1e-5 but for
    counted threshold flips) and gradients (3e-4 of each one's largest
    value) match brush_tpu's aligned rasterizer in interpret mode."""
    arrays, tiles_x, num_tiles = _case_inputs("vjp_matches_xla")
    k_lanes, pool = 128, 1024
    params = [torch.tensor(a, requires_grad=True) for a in arrays[:4]]
    gid, starts, ends = (torch.tensor(a) for a in arrays[4:])
    tile_ids = torch.arange(num_tiles, dtype=torch.int32)
    img = make_pallas_rasterizer(tiles_x, num_tiles, pool, k_lanes)(
        *params, gid, starts, ends, tile_ids)
    packed = t_raster.pack_isect_splats(*(p.detach() for p in params), gid,
                                        pool, k_lanes)
    s32, e32 = starts.to(torch.int32), ends.to(torch.int32)
    assert torch.equal(img.detach(), t_raster.rasterize_fwd(
        packed, s32, e32, tiles_x, scan_passes=2, k_lanes=k_lanes)[0])
    v = _cotangent("vjp_matches_xla", num_tiles)
    (img * torch.tensor(v)).sum().backward()

    raster_j = j_make_pallas_rasterizer(tiles_x, num_tiles, pool, k_lanes,
                                        interpret=True)
    j_args = [jnp.asarray(a) for a in arrays]
    img_j, vjp = jax.vjp(lambda *p: raster_j(*p, *j_args[4:],
                                             jnp.asarray(tile_ids.numpy())),
                         *j_args[:4])
    assert_close_quantized(img.detach().numpy(), np.asarray(img_j),
                           atol=1e-5, err_msg="aligned image")
    for p, g in zip(params, vjp(jnp.asarray(v))):
        g = np.asarray(g)
        scale = max(np.abs(g).max(), 1e-12)
        assert np.abs(p.grad.numpy() - g).max() <= 3e-4 * scale


def test_scan_falls_back_to_exact_where_lanes_are_not_128_aligned():
    """k_lanes 192 (block_size 192) is no multiple of 128: the TPU kernels
    take the exact scan there, and so do the port's plain versions and
    render_splats, bit for bit."""
    packed, starts, ends, tiles_x = scan_edge()
    exact = port_fwd(packed, starts, ends, tiles_x, 3, None)
    for a, b in zip(port_fwd(packed, starts, ends, tiles_x, 2, 192), exact):
        np.testing.assert_array_equal(a, b)
    v_out = np.random.default_rng(8).normal(
        size=(len(starts), 256, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        port_bwd(packed, starts, ends, tiles_x, v_out, *exact[1:], 2, 192),
        port_bwd(packed, starts, ends, tiles_x, v_out, *exact[1:], 3, None))
    sc = make_scene(200, seed=4)
    t = [torch.tensor(sc[k]) for k in NAMES]
    cp = camera_params(Camera(**CAM), (64, 48), device="cpu")
    a, _ = render_splats(*t, cp, (64, 48), block_size=192, needs_grad=False)
    b, _ = render_splats(*t, cp, (64, 48), block_size=192, needs_grad=False,
                         scan_passes=3)
    assert torch.equal(a, b)


def test_render_default_matches_reference_default():
    """render_splats and its gradients at the default (scan_passes=2 and
    k_lanes max(128, block_size)) against brush_tpu's render_splats at its
    default in Pallas interpret mode, f32 gradient rows: the rule of
    tests/test_torch_render_grads.py (each gradient scaled by its largest
    reference value, the bulk within 3e-4)."""
    size = (64, 48)
    sc = make_scene(100, seed=3, scale_hi=0.5, sh_degree=1)
    v = np.random.default_rng(103).normal(
        size=(size[1], size[0], 4)).astype(np.float32)
    cpj = j_cp(JCamera(**CAM), size)

    def f(*p):
        img, _ = j_render(*p, cpj, size, backend="pallas",
                          pack_grad_sort=False)
        return jnp.sum(img * v), img

    (_, img_j), g_j = jax.value_and_grad(f, argnums=tuple(range(5)),
                                         has_aux=True)(
        *(jnp.asarray(sc[k]) for k in NAMES))
    params = [torch.tensor(sc[k], requires_grad=True) for k in NAMES]
    img, _ = render_splats(*params, camera_params(Camera(**CAM), size,
                                                  device="cpu"),
                           size, pack_grad_sort=False)
    (img * torch.tensor(v)).sum().backward()
    assert_close_quantized(img.detach().numpy(), np.asarray(img_j),
                           atol=1e-5, err_msg="image at the default")
    for k, p, g in zip(NAMES, params, g_j):
        g = np.asarray(g)
        scale = max(np.abs(g).max(), 1e-12)
        assert_close_quantized(p.grad.numpy() / scale, g / scale, atol=3e-4,
                               flip_tol=0.05, err_msg=k)


def test_trainer_steps_at_default_match_reference():
    """Three SplatTrainer steps at the port's default (the record pipeline
    at scan_passes=2) against the JAX trainer, at the bounds of
    test_torch_train.steps_match_reference."""
    steps_match_reference(3)


# The CUDA kernels' truncated scan carries T as running products (csrc/
# scan.cuh); ops/cuda/testing's twins follow them step by step. Layouts:
# (name, passes, k_lanes or None for the pipeline's scan_lanes at 512).
TWIN_LAYOUTS = ([(f"tile {c}", 2, 128) for c in HAND_TILE_CASES]
                + [("scan_edge", 2, 128), ("scan_edge", 2, 512),
                   ("scan_edge", 1, 128), ("tile deep", 1, 512)]
                + [(f"cell {c}", 2, None) for c in HAND_CELL_CASES]
                + [("strip", 2, 128)])


def twin_layout(name):
    """(packed, starts, ends, cells_x, cell, tile_base) as numpy arrays
    and ints for a TWIN_LAYOUTS name."""
    kind, _, case = name.partition(" ")
    if kind == "tile":
        return (*hand_tiles(case), (1, 1), 0)
    if kind == "cell":
        return (*hand_cells(case), 0)
    if kind == "scan_edge":
        return (*scan_edge(), (1, 1), 0)
    got = port_records(make_scene(512, seed=21, scale_hi=0.5), (64, 48),
                       2048)
    base, k = 5, 6
    return (got["packed"].numpy(), got["starts"][base:base + k].numpy(),
            got["ends"][base:base + k].numpy(), got["tiles_x"], (1, 1), base)


@pytest.mark.parametrize("layout", TWIN_LAYOUTS,
                         ids=lambda v: f"{v[0]}-p{v[1]}-k{v[2]}")
def test_kernel_twin_matches_plain(layout):
    """The CUDA kernels' truncated scan as their CPU twins compute it
    (T and the crossing by running products, each record's T by the rest
    of its term past its bfloat16 parts; the backward's T carried across
    the scan batches) against rasterize_fwd_plain and rasterize_bwd_plain
    in the log domain at the same scan_passes, on every hand layout,
    scan_edge at both k_lanes and at one part, the raster cells and a
    strip. Tolerances are the card's gates: the image within 1e-5 with at
    most 2e-3 of the pixels flipped, log T compared as T, final_idx equal
    elsewhere; the backward (on the plain forward's outputs, a seeded
    cotangent) within 1e-4 of each row's largest value (measured at two
    parts: 1.5e-6 on the image, 3.6e-7 on T, no final_idx apart, 1.6e-5
    on the rows). On scan_edge the named pixels' final_idx is the plain
    version's."""
    name, passes, k = layout
    packed, starts, ends, cells_x, cell, base = twin_layout(name)
    k = scan_lanes(512, cell) if k is None else k
    args = (*tensors(packed, starts, ends), cells_x, cell, base)
    want = t_raster.rasterize_fwd_plain(*args, scan_passes=passes,
                                        k_lanes=k)
    got = rasterize_fwd_twin(*args, passes=passes, k_lanes=k)
    flip_check(*(o.numpy() for o in got), *(w.numpy() for w in want),
               atol=1e-5, transmittance=True)
    if name == "scan_edge":
        for tile, pixel, _ in SCAN_EDGE_PIXELS:
            assert int(got[2][tile, pixel]) == int(want[2][tile, pixel])
    v_out = torch.tensor(np.random.default_rng(9).normal(
        size=(*want[1].shape, 4)).astype(np.float32))
    b_args = (*args[:4], v_out, want[1], want[2], cell, base)
    rows_close(rasterize_bwd_twin(*b_args, passes=passes),
               t_bwd.rasterize_bwd_plain(*b_args, scan_passes=passes,
                                         k_lanes=k), 1e-4, name)


def test_kernel_twin_scan_edge_matches_pallas(edge):
    """The twins on scan_edge against the Pallas kernels in interpret mode
    at scan_passes=2: final_idx equal at every pixel (the named ones one
    record from the exact scan's), the image within 1e-5 and T; the
    backward on the Pallas forward's outputs within 3e-4 of each row's
    largest value, as this file holds the plain version to Pallas."""
    args, fwd, v_out = edge
    got = rasterize_fwd_twin(*tensors(*args[:3]), args[3], passes=2,
                             k_lanes=SCAN_EDGE_LANES)
    img_j, log_t_j, fidx_j = fwd["pallas", 2]
    np.testing.assert_array_equal(got[2].numpy(), fidx_j)
    flip_check(*(o.numpy() for o in got), img_j, log_t_j, fidx_j,
               atol=1e-5, transmittance=True)
    for tile, pixel, sign in SCAN_EDGE_PIXELS:
        assert int(got[2][tile, pixel]) - fwd["pallas", 3][2][tile, pixel] \
            == sign
    p, s_, e, v, lt, f = tensors(*args[:3], v_out, log_t_j, fidx_j)
    rows_close(rasterize_bwd_twin(p, s_, e, args[3], v, lt, f, passes=2),
               torch.tensor(pallas_bwd(*args, v_out, log_t_j, fidx_j, 2,
                                       SCAN_EDGE_LANES)), 3e-4, "scan_edge")


@pytest.mark.parametrize("passes", [1, 2])
def test_scan_rest_factor_and_threshold(passes):
    """What the kernels' products rest on, swept over every float32 alpha
    step of 2^-18 in [ALPHA_EPS, ALPHA_MAX]: the rest of log1p(-alpha)
    past its bfloat16 parts is at most 2^-16 (two parts) or 2^-8 (one) of
    the term, and times_exp(1, rest) is exp(rest) within 1e-7 (two
    parts: 1 + rest) and 1.5e-7 (one: a cubic). T_EPS_SCAN is exp of the
    float32 log(1e-4) that the plain version compares with, rounded to
    float32."""
    alpha = torch.arange(ALPHA_EPS, ALPHA_MAX, 2.0 ** -18,
                         dtype=torch.float64).float()
    lom = torch.log1p(-alpha)
    rest = scan_rest_f32(lom, passes)
    bound = 2.0 ** -16 if passes == 2 else 2.0 ** -8
    assert (rest.abs() <= bound * lom.abs()).all()
    got = times_exp_f32(torch.ones_like(rest), rest, passes).double()
    err = (got - torch.exp(rest.double())).abs().max()
    assert err <= (1e-7 if passes == 2 else 1.5e-7), float(err)
    assert T_EPS_SCAN == float(np.float32(np.exp(np.float64(
        np.float32(np.log(1e-4))))))
