"""The strip mode of the port (a rank's strip of raster cells from
tile_base) against brush_tpu, on the CPU: the coverage restriction, the
plain versions of both rasterizers against the Pallas kernels in interpret
mode with tile_ids = tile_base + arange(k), and the strip-local record
pipeline against make_pallas_pipeline(raster_tiles=k). The CUDA kernels'
strip mode is held to these plain versions in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close_quantized

from brush_tpu.ops.binning import cell_bbox as j_cell_bbox
from brush_tpu.ops.binning import precompute_tile_masks as j_masks
from brush_tpu.ops.binning import restrict_masks_parts as j_parts
from brush_tpu.ops.binning import restrict_masks_to_strip as j_to_strip
from brush_tpu.ops.pallas.raster_vjp import make_pallas_pipeline
from brush_tpu.ops.pallas.rasterize_bwd import rasterize_bwd_pallas
from brush_tpu.ops.pallas.rasterize_fwd import rasterize_fwd_pallas

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.ops.binning import (
    cell_bbox, precompute_tile_masks, restrict_masks_parts,
    restrict_masks_to_strip,
)
from brush_tpu_torch.ops.cuda import rasterize_bwd as t_bwd
from brush_tpu_torch.ops.cuda import rasterize_fwd as t_raster
from brush_tpu_torch.ops.pipeline import RecordPipeline
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.parallel.train_step import meta_rows, strip_decode
from brush_tpu_torch.render import record_inputs
from test_torch_cuda import CAM, flip_check, make_scene, port_records
from test_torch_ops import _proj_both, _scene
from torch_threads import pin_threads

pin_threads()

K_LANES = 128
u32 = lambda t: t.numpy().view(np.uint32)

# Cell-row strips of the 640x448 scene (40x28 tiles; 20x14 cells of
# (2, 2)): empty, partial, the whole frame, across the last row, past it.
STRIPS = [(5, 5), (3, 9), (0, 28), (12, 16), (26, 31), (28, 32)]


@pytest.fixture(scope="module")
def masked_scene():
    """600 splats at 640x448, 40 of them large enough for the
    conservative bbox records: both projections and masks at (1, 1) and
    (2, 2), and the opacities."""
    sc = _scene(n=600, seed=4)
    sc["log_scales"][:40] += 3.0
    jp, tp = _proj_both(sc, (640, 448))
    opac = np.random.default_rng(5).uniform(0.002, 1.0, 600).astype(
        np.float32)
    masks = {cell: (j_masks(jp, jnp.asarray(opac), cell=cell),
                    precompute_tile_masks(tp, torch.tensor(opac), cell=cell))
             for cell in ((1, 1), (2, 2))}
    return jp, tp, masks


def _same(got, want, what):
    for name, g, w in zip(("counts", "mask_lo", "mask_hi", "tmin_y",
                           "bbox_h"), got, want):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(w).astype(np.int64), f"{what} {name}")


@pytest.mark.parametrize("strip", STRIPS)
def test_restrict_masks_match_reference(strip, masked_scene):
    """restrict_masks_to_strip (tile rows) and restrict_masks_parts on the
    cell bbox at (2, 2), as the sharded step calls it, bit-equal to the
    reference's on small and bbox splats."""
    jp, tp, masks = masked_scene
    lo, hi = strip
    jm, tm = masks[(1, 1)]
    prod_j = jp.visible & (jm.counts > 0)
    prod_t = tp.visible & (tm.counts > 0)
    got = restrict_masks_to_strip(tp, tm, torch.where(prod_t, tm.counts, 0),
                                  lo, hi)
    _same(got, j_to_strip(jp, jm, jnp.where(prod_j, jm.counts, 0), lo, hi),
          f"tiles {strip}")
    whole = restrict_masks_to_strip(tp, tm, torch.where(prod_t, tm.counts, 0),
                                    0, 28)
    assert bool((whole[0] == torch.where(prod_t, tm.counts, 0)).all())
    if strip == (3, 9):   # both kinds of splat are cut
        cut = got[0] < whole[0]
        assert bool((cut & tm.small).any()) and bool((cut & ~tm.small).any())

    jm, tm = masks[(2, 2)]
    jx, jy, jx1, jy1 = j_cell_bbox(jp, (2, 2))
    tx, ty, tx1, ty1 = cell_bbox(tp, (2, 2))
    got = restrict_masks_parts(
        ty, torch.clamp(tx1 - tx, 1, 1023), torch.clamp(ty1 - ty, min=1),
        tm.small, tm.mask_lo, tm.mask_hi,
        torch.where(tp.visible & (tm.counts > 0), tm.counts, 0),
        lo // 2, hi // 2)
    want = j_parts(
        jy, jnp.clip(jx1 - jx, 1, 1023), jnp.maximum(jy1 - jy, 1), jm.small,
        jm.mask_lo, jm.mask_hi,
        jnp.where(jp.visible & (jm.counts > 0), jm.counts, 0),
        lo // 2, hi // 2)
    _same(got, want, f"cells {strip}")


# (cell, image, strip base, strip cells): 4x3 tiles, a strip of two rows
# from row 2, its second row past the image; 3x2 cells of (2, 2), a strip
# of three rows from row 1, two past the image.
KERNEL_STRIPS = {
    "tiles": ((1, 1), (64, 48), 8, 8),
    "cells": ((2, 2), (80, 48), 3, 9),
}


def strip_args(got, base, k):
    """The frame's starts/ends cut to cells [base, base + k), the cells
    past the image empty (as the pipeline gives them)."""
    num = got["num_tiles"]
    inside = min(k, num - base)
    pad = lambda x: torch.cat([x[base:base + inside],
                               got["ends"][-1:].expand(k - inside)])
    return pad(got["starts"]), pad(got["ends"])


@pytest.mark.parametrize("case", list(KERNEL_STRIPS))
def test_strip_rasterizers_match_pallas(case):
    """rasterize_fwd_plain and rasterize_bwd_plain at tile_base > 0 against
    rasterize_fwd_pallas / rasterize_bwd_pallas (interpret mode,
    scan_passes 3) with tile_ids = tile_base + arange(k), on the records
    of the whole frame: the forward within test_torch_kernels.py's rule
    (1e-5, log T in transmittance space), the backward rows within
    test_torch_grads.py's 3e-4 of each row's largest value. The cells past
    the image are empty; the strip's cells are the whole-frame call's, bit
    for bit."""
    cell, size, base, k = KERNEL_STRIPS[case]
    got = port_records(make_scene(512, seed=21, scale_hi=0.5), size, 2048,
                       cell=cell)
    starts, ends = strip_args(got, base, k)
    inside = got["num_tiles"] - base
    packed_j = jnp.asarray(np.pad(u32(got["packed"]), ((0, 0), (0, K_LANES))))
    tile_ids = base + jnp.arange(k, dtype=jnp.int32)
    kw = dict(tiles_x=got["tiles_x"], num_tiles=k, max_isects=2048,
              k_lanes=K_LANES, interpret=True, scan_passes=3, cell=cell)
    img_j, log_t_j, fidx_j = rasterize_fwd_pallas(
        packed_j, jnp.asarray(starts.numpy()), jnp.asarray(ends.numpy()),
        tile_ids, **kw)
    args = (got["packed"], starts, ends, got["tiles_x"], cell)
    img, log_t, fidx = t_raster.rasterize_fwd(*args, base)
    flip_check(img.numpy(), log_t.numpy(), fidx.numpy(), np.asarray(img_j),
               np.asarray(log_t_j), np.asarray(fidx_j), atol=1e-5,
               transmittance=True)
    assert (fidx[:inside] >= 0).any()
    assert not img[inside:].any() and not log_t[inside:].any()
    assert bool((fidx[inside:] == -1).all())
    whole = t_raster.rasterize_fwd(got["packed"], got["starts"], got["ends"],
                                   got["tiles_x"], cell)
    for a, b in zip((img, log_t, fidx), whole):
        assert torch.equal(a[:inside], b[base:])

    v_out = np.random.default_rng(22).normal(size=img.shape).astype(
        np.float32)
    want = np.asarray(rasterize_bwd_pallas(
        packed_j, jnp.asarray(v_out), log_t_j, fidx_j,
        jnp.asarray(starts.numpy()), jnp.asarray(ends.numpy()), tile_ids,
        **kw))[:9]
    grads = t_bwd.rasterize_bwd(*args[:4], torch.tensor(v_out),
                                torch.tensor(np.asarray(log_t_j)),
                                torch.tensor(np.asarray(fidx_j)), cell,
                                base).numpy()
    lo, hi = int(starts[0]), int(ends[inside - 1])
    assert hi > lo and not grads[:, :lo].any() and not grads[:, hi:].any()
    for r in range(9):
        scale = np.abs(want[r, lo:hi]).max() + 1e-8
        np.testing.assert_allclose(grads[r, lo:hi] / scale,
                                   want[r, lo:hi] / scale, atol=3e-4,
                                   err_msg=f"{case} row {r}")


# (cell, image, ranks, rank): the strip of `rank` among `ranks` row-aligned
# strips, as the sharded step cuts it: 5x3 tiles on 2 ranks, rank 1 rows
# [2, 4) (its second row past the image); 3x2 cells of (2, 2) on 4 ranks,
# rank 1 (one row inside) and rank 3 (past the image: no record).
PIPE_STRIPS = {
    "tiles": ((1, 1), (80, 48), 2, 1),
    "cells": ((2, 2), (80, 48), 4, 1),
    "past": ((2, 2), (80, 48), 4, 3),
}


@pytest.mark.parametrize("case", list(PIPE_STRIPS))
def test_strip_pipeline_matches_pallas(case):
    """The strip-local record pipeline (RecordPipeline with tile_base and
    raster_tiles) against make_pallas_pipeline(raster_tiles=k) on the same
    restricted inputs (built by the port; their restriction is held to
    the reference above): image cells within 1e-5 at (1, 1) and
    test_torch_cells.py's 2e-3 at (2, 2) (the TPU kernel's sigma
    polynomial in the cell's frame), the same live and unclamped record
    counts, and the attribute gradients of sum(img * v), each row scaled
    by its largest reference value, within test_torch_render_grads.py's
    3e-4 (exact float32 cotangents through the re-sort)."""
    cell, size, ranks, rank = PIPE_STRIPS[case]
    sc = make_scene(300, seed=23, scale_hi=0.5)
    cp = camera_params(Camera(**CAM), size, device="cpu")
    rec = record_inputs(*(torch.tensor(sc[k]) for k in (
        "means", "log_scales", "quats", "sh_coeffs", "raw_opacity")), cp,
        size, cell=cell)
    cells_x = -(-size[0] // (16 * cell[0]))
    cells_y = -(-size[1] // (16 * cell[1]))
    rows = -(-cells_y // ranks)
    base, k = rank * rows * cells_x, rows * cells_x
    decode, depth_key = strip_decode(meta_rows(rec, cell), rank * rows,
                                     (rank + 1) * rows)
    attrs9 = rec.attrs9.detach()
    n, pool = attrs9.shape[1], 2048
    p = 256 * cell[0] * cell[1]
    v = np.random.default_rng(24).normal(size=(k, p, 4)).astype(np.float32)

    raster = make_pallas_pipeline(
        cells_x, cells_x * cells_y, pool, n, k_lanes=K_LANES, raster_tiles=k,
        interpret=True, scan_passes=3, pack_grad_sort=False, cell=cell)
    args_j = (jnp.asarray(decode.numpy().astype(np.uint32)),
              jnp.asarray(depth_key.numpy().astype(np.uint32)),
              base + jnp.arange(k, dtype=jnp.int32))

    def f(a):
        img, _, total, raw = raster(a, *args_j)
        return jnp.sum(img * v), (img, total, raw)

    (_, (img_j, total_j, raw_j)), g_j = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(attrs9.numpy()))

    a9 = attrs9.clone().requires_grad_(True)
    img, _, total, raw = RecordPipeline.apply(
        a9, decode, depth_key, cells_x, cells_x * cells_y, pool, False, cell,
        base, k)
    (img * torch.tensor(v)).sum().backward()

    assert img.shape == (k, p, 4)
    assert int(total) == int(total_j) and int(raw) == int(raw_j)
    assert (int(total) == 0) == (case == "past")
    assert_close_quantized(img.detach().numpy(), np.asarray(img_j),
                           atol=1e-5 if cell == (1, 1) else 2e-3,
                           flip_tol=0.05, err_msg=case)
    g_j = np.asarray(g_j)
    if case == "past":
        assert not a9.grad.any() and not g_j.any()
        return
    for r in range(9):
        scale = np.abs(g_j[r]).max()
        assert scale > 0, r
        assert_close_quantized(a9.grad[r].numpy() / scale, g_j[r] / scale,
                               atol=3e-4, flip_tol=0.05, max_flip_frac=5e-3,
                               err_msg=f"{case} row {r}")
