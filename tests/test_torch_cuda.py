"""The port's CUDA kernels on the card, and the port's device rules.

This file imports nothing of JAX, so it also runs on a machine with a
card and no JAX (see README: `pytest --noconftest -m cuda`). Tests marked
`cuda` hold each CUDA kernel to its plain PyTorch version on the same
inputs and skip without a card; the rest run anywhere. Its scene helpers
are shared with test_torch_kernels.py.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.ops.cuda import build
from brush_tpu_torch.ops.cuda import expand as t_expand
from brush_tpu_torch.ops.cuda import rasterize_bwd as t_bwd
from brush_tpu_torch.ops.cuda import rasterize_fwd as t_raster
from brush_tpu_torch.ops.cuda import segsum as t_seg
from brush_tpu_torch.ops.cuda.testing import (
    HAND_CELL_CASES, HAND_DEEP, HAND_EDGE_IMAGE, HAND_EXPAND_CASES,
    HAND_LAYOUTS, HAND_POISON_FROM, HAND_POOL, HAND_SMALL_LIVE, HAND_SMALL_N,
    HAND_SMALL_POOL, HAND_TILE_CASES, cell_pixel_centres, hand_cells,
    fwd_warp_patches, hand_expand, hand_segments, hand_small_pool,
    hand_tiles, may_reach_f32, scan_edge, sigma_f32, sigma_max_f32,
    warp_patches,
)
from brush_tpu_torch.ops.pipeline import depth_order, scan_lanes, tile_bins
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.render import record_inputs, render_splats
from torch_threads import pin_threads

pin_threads()

# (n, image, pool, largest scale): a plain scene; large splats so the bbox
# (> 8x8 tiles) path expands; a pool smaller than the records (overflow).
SCENES = {
    "small": (512, (64, 48), 2048, 0.5),
    "bbox_splats": (200, (160, 128), 16384, 3.0),
    "overflow": (512, (64, 48), 512, 0.5),
}
CAM = dict(position=[0, 0, -6.0], rotation=[1, 0, 0, 0], fov_x=np.pi / 2,
           fov_y=np.pi / 2)


def make_scene(n, seed, scale_hi=0.5, sh_degree=1):
    """Random splats in front of a camera at z=-6 (numpy, float32)."""
    rng = np.random.default_rng(seed)
    quats = rng.normal(size=(n, 4))
    k = (sh_degree + 1) ** 2
    return {
        "means": rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32),
        "log_scales": np.log(rng.uniform(0.02, scale_hi, (n, 3))).astype(
            np.float32),
        "quats": (quats / np.linalg.norm(quats, axis=1, keepdims=True)
                  ).astype(np.float32),
        "sh_coeffs": rng.normal(0, 0.6, (n, k, 3)).astype(np.float32),
        "raw_opacity": rng.normal(0.5, 1.5, n).astype(np.float32),
    }


def port_records(sc, img_size, pool, device="cpu", cell=(1, 1)):
    """The port's stages up to the tile sort on `device` (CPU tensors go
    through the plain kernels), in raster cells of `cell` tiles ("tiles_x"
    and "num_tiles" then count cells)."""
    cp = camera_params(Camera(**CAM), img_size, device=device)
    t = {k: torch.tensor(v, device=device) for k, v in sc.items()}
    rec = record_inputs(t["means"], t["log_scales"], t["quats"],
                        t["sh_coeffs"], t["raw_opacity"], cp, img_size,
                        cell=cell)
    d = depth_order(rec.attrs9, rec.decode, rec.depth_key, pool)
    tiles_x = -(-img_size[0] // (16 * cell[0]))
    num_tiles = tiles_x * -(-img_size[1] // (16 * cell[1]))
    keys, recs = t_expand.expand(d.f5, d.u5, d.cum, d.total, tiles_x,
                                 num_tiles, pool)
    packed, starts, ends = tile_bins(keys, recs, num_tiles)
    return dict(f5=d.f5, u5=d.u5, cum=d.cum, total=d.total,
                raw_total=d.raw_total, offsets=d.offsets, order=d.order,
                keys=keys, recs=recs, packed=packed, starts=starts,
                ends=ends, tiles_x=tiles_x, num_tiles=num_tiles)


def hand_tile_args(case, device):
    """hand_tiles(case) as the rasterizers' arguments."""
    packed, starts, ends, tiles_x = hand_tiles(case)
    return (torch.tensor(packed, device=device),
            torch.tensor(starts, device=device),
            torch.tensor(ends, device=device), tiles_x)


def kernel_constant(kernel, name):
    """The integer `constexpr int <name> = ...;` of csrc/<kernel>.cu."""
    import os
    import re

    with open(os.path.join(build.CSRC, f"{kernel}.cu")) as f:
        found = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    assert len(found) == 1, f"{kernel}.cu: {name} {found}"
    return int(found[0])


def close_with_flips(got, want, atol, flip_tol=0.01, max_flip_frac=2e-3,
                     what=""):
    """The rule of tests/conftest.assert_close_quantized: within atol
    except a counted few alpha-threshold flips, each within flip_tol."""
    diff = np.abs(got - want)
    n_flip = int((diff > atol).sum())
    assert diff.max() <= flip_tol, f"{what}: max diff {diff.max():.2e}"
    assert n_flip <= max(1, int(max_flip_frac * diff.size)), (
        f"{what}: {n_flip}/{diff.size} beyond atol {atol:.0e}")


def flip_check(img, log_t, fidx, want_img, want_log_t, want_fidx, atol,
               transmittance=False):
    """img and log_t (or, with transmittance, T = exp(log_t)) close with
    counted flips; final_idx must agree on every pixel whose outputs
    agreed within atol, up to the same flip budget (a sub-atol flip at the
    T threshold changes it too)."""
    if transmittance:
        log_t, want_log_t = np.exp(log_t), np.exp(want_log_t)
    close_with_flips(img, want_img, atol, what="img")
    close_with_flips(log_t, want_log_t, atol, what="log_t")
    near = ((np.abs(img - want_img) <= atol).all(-1)
            & (np.abs(log_t - want_log_t) <= atol))
    n_bad = int(((fidx != want_fidx) & near).sum())
    assert n_bad <= max(1, int(2e-3 * fidx.size)), f"{n_bad} final_idx"


def test_cuda_request_without_cuda_raises():
    """Asking for the card on a machine without one raises; nothing
    carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from brush_tpu_torch.splats import from_random

    with pytest.raises(RuntimeError, match="cuda"):
        from_random(np.random.default_rng(0), [-1] * 3, [1] * 3, count=8)
    with pytest.raises(RuntimeError, match="cuda"):
        camera_params(Camera(**CAM), (16, 16))


def test_wrappers_reject_bad_inputs():
    r = port_records(make_scene(64, 0), (32, 32), 512)
    with pytest.raises(ValueError, match="f5"):
        t_expand.expand(r["f5"].double(), r["u5"], r["cum"], r["total"],
                        r["tiles_x"], r["num_tiles"], 512)
    with pytest.raises(ValueError, match="packed"):
        t_raster.rasterize_fwd(r["packed"][:7], r["starts"], r["ends"],
                               r["tiles_x"])
    img, log_t, fidx = t_raster.rasterize_fwd(r["packed"], r["starts"],
                                              r["ends"], r["tiles_x"])
    with pytest.raises(ValueError, match="v_out"):
        t_bwd.rasterize_bwd(r["packed"], r["starts"], r["ends"],
                            r["tiles_x"], img[..., :3], log_t, fidx)
    with pytest.raises(ValueError, match="final_idx"):
        t_bwd.rasterize_bwd(r["packed"], r["starts"], r["ends"],
                            r["tiles_x"], img, log_t, fidx.long())
    for bad in (-1, 2.5):
        with pytest.raises(ValueError, match="tile_base"):
            t_raster.rasterize_fwd(r["packed"], r["starts"], r["ends"],
                                   r["tiles_x"], (1, 1), bad)
        with pytest.raises(ValueError, match="tile_base"):
            t_bwd.rasterize_bwd(r["packed"], r["starts"], r["ends"],
                                r["tiles_x"], img, log_t, fidx, (1, 1), bad)
    rows = torch.zeros((t_bwd.GRAD_ROWS, 512))
    with pytest.raises(ValueError, match="rows"):
        t_seg.segment_sum(rows[:8], r["offsets"], r["cum"], r["total"])
    with pytest.raises(ValueError, match="offsets"):
        t_seg.segment_sum(rows, r["offsets"].long(), r["cum"], r["total"])


def test_expand_plain_canonicalizes_negative_zero():
    """-0.0 in a record field is written as +0.0, as the TPU kernel's
    matmul gather leaves it."""
    r = port_records(make_scene(64, 0), (32, 32), 512)
    f5 = r["f5"].clone()
    f5[3] = -0.0
    _, recs = t_expand.expand_plain(f5, r["u5"], r["cum"], r["total"],
                                    r["tiles_x"], r["num_tiles"], 512)
    assert int(r["total"][0]) > 0 and not recs[3].any()


def hand_expand_args(case, device):
    """hand_expand(case) as the expand wrapper's arguments."""
    f5, u5, cum, total, tiles_x, num_tiles, pool = hand_expand(case)
    return (*(torch.tensor(a, device=device) for a in (f5, u5, cum, total)),
            tiles_x, num_tiles, pool)


# The expand kernel's slots a block (csrc/expand.cu kThreads * kPer).
EXPAND_BLOCK = 1024


@pytest.mark.parametrize("case", HAND_EXPAND_CASES)
def test_hand_expand_layouts_reach_their_cases(case):
    """Each layout of ops/cuda/testing.hand_expand has what its name says,
    and the wrapper (the plain version here) expands it into tile keys
    inside the grid, records in slot order and sentinels past `total`."""
    f5, u5, cum, total, tiles_x, num_tiles, pool = hand_expand_args(
        case, "cpu")
    n, live = f5.shape[1], int(total[0])
    counts = torch.diff(cum, prepend=torch.zeros(1, dtype=torch.int32))
    offsets = cum - counts
    u = u5.to(torch.int64) & 0xFFFFFFFF
    small = ((u[2] >> 10) & 1) == 1
    keys, recs = t_expand.expand(f5, u5, cum, total, tiles_x, num_tiles,
                                 pool)
    assert bool((keys[live:] == num_tiles).all())
    assert bool((recs[:7, live:] == 0).all() and (recs[7, live:] == n).all())
    assert bool(((keys[:live] >= 0) & (keys[:live] < num_tiles)).all())
    owners = recs[7, :live].to(torch.int64)
    assert bool((owners[1:] >= owners[:-1]).all())
    if n:
        assert torch.equal(counts[small], (torch.stack(
            [((u[3] >> b) & 1) + ((u[4] >> b) & 1) for b in range(32)])
            .sum(0))[small].to(torch.int32))
    rank = torch.arange(live) - offsets[owners]
    in_live = offsets < live
    if case == "bbox_span":
        w = int(torch.argmax(torch.where(small, 0, counts)))
        first, last = int(offsets[w]), int(cum[w]) - 1
        assert last // EXPAND_BLOCK - first // EXPAND_BLOCK >= 2
    elif case in ("zero_owners", "zero_run"):
        zero_inside = (counts == 0) & (cum < live)
        assert int(zero_inside.sum()) >= (2600 if case == "zero_run"
                                          else 50)
        if case == "zero_run":   # the run lies inside one kernel block
            at = offsets[zero_inside]
            assert int(at.max()) // EXPAND_BLOCK == int(at.min()) \
                // EXPAND_BLOCK
    elif case == "full_mask":
        assert int(rank.max()) == 63
        assert bool(((u[3] == 0xFFFFFFFF) & (u[4] == 0xFFFFFFFF)).any())
        assert bool(((u[3] == 0) & (u[4] == 1 << 31)).any())
    elif case == "high_word":
        in_hi = rank >= torch.stack([(u[3] >> b) & 1 for b in range(32)]
                                    ).sum(0)[owners]
        assert float(in_hi.float().mean()) > 0.8
    elif case == "total_pool":
        assert live == pool == int(cum[-1])
    elif case == "total_zero":
        assert live == 0 < int(cum[-1])
    elif case == "n_zero":
        assert n == 0 and live == 0 and pool > 0
    elif case == "block_start":
        starts = set(offsets[in_live & (counts > 0)].tolist())
        assert {512, 1024, 2048, 3072} <= starts
        assert bool((~small & (counts > 0)).any() and small.any())
    else:   # ragged
        assert pool % 4 and 0 < live == int(cum[-1]) < pool


def _cell_reach(case):
    """For each record of hand_cells(case): its cell, and the (pixel,
    record) pairs of that cell that pass the kernels' pretest (0 <= sigma
    <= sigma_max, float32 as the sweeps round it), as a (records, pixels)
    bool array per cell, with the cell's pixel centres."""
    return _reach(*hand_cells(case))


def _reach(packed, starts, ends, cells_x, cell):
    """_cell_reach on any records: packed (8, pool) int32 numpy, starts
    and ends a cell each."""
    f = packed[:5].view(np.float32)
    o_words = packed[6].view(np.uint32) >> 16
    out = []
    for c, (s, e) in enumerate(zip(starts, ends)):
        px, py = cell_pixel_centres(cell, c, cells_x)
        sig = sigma_f32(*(f[r, s:e, None] for r in range(5)), px[None],
                        py[None])
        smax = sigma_max_f32(o_words[s:e])[:, None]
        out.append(((sig >= 0) & (sig <= smax), px, py, sig, s, e))
    return packed, starts, ends, cells_x, cell, out


@pytest.mark.parametrize("case", HAND_CELL_CASES)
def test_hand_cell_layouts_reach_their_cases(case):
    """Each layout of ops/cuda/testing.hand_cells has what its name says,
    counted with the kernels' own float32 pretest."""
    packed, starts, ends, cells_x, cell, reach = _cell_reach(case)
    gw, gh = cell
    assert packed.shape[1] % 256 == 0 and int(ends[-1]) <= packed.shape[1]
    assert bool((starts[1:] == ends[:-1]).all()) and starts[0] == 0
    f = packed[:5].view(np.float32)
    o_words = packed[6].view(np.uint32) >> 16

    def tiles_hit(passes, px, py, c):
        ox, oy = 16 * gw * (c % cells_x), 16 * gh * (c // cells_x)
        sub = ((py - oy) // 16).astype(int) * gw + ((px - ox) // 16).astype(
            int)
        return [set(sub[row].tolist()) for row in passes]

    if case == "one_tile":
        for c, (passes, px, py, *_) in enumerate(reach):
            hit = tiles_hit(passes, px, py, c)
            assert all(len(h) == 1 for h in hit)
            assert set().union(*hit) == {0, 1, 2, 3}
    elif case == "all_tiles":
        for c, (passes, px, py, *_) in enumerate(reach):
            assert all(h == {0, 1, 2, 3}
                       for h in tiles_hit(passes, px, py, c))
    elif case == "corner_pixel":
        passes, px, py, sig, s, e = reach[0]
        corner = np.flatnonzero(o_words[s:e] == 65535)
        assert len(corner) == 4 and corner.min() > 0
        assert sorted(int(passes[k].sum()) for k in corner) == [1] * 4
        hit = {(float(px[passes[k]][0]), float(py[passes[k]][0]))
               for k in corner}
        assert hit == {(0.5, 0.5), (31.5, 0.5), (0.5, 31.5), (31.5, 31.5)}
        # The one pixel is active: alpha = exp(-sigma) >= 1 / 255.
        assert all(np.exp(-sig[k][passes[k]][0]) >= 1 / 255 for k in corner)
    elif case == "deep_cell":
        for kernel in ("rasterize_fwd", "rasterize_bwd"):
            assert ends[0] - starts[0] == HAND_DEEP > 3 * kernel_constant(
                kernel, "kBatch")
    elif case == "pretest_edge":
        lo = hi = 0
        for c, (passes, px, py, sig, s, e) in enumerate(reach):
            edge = np.arange(40, e - s)   # after 40 background records
            bound = np.log(np.float32(255.0) * (
                o_words[s:e].astype(np.float32) / np.float32(65535.0)))
            for k in edge:
                least = [sig[k][(px >= x0) & (px < x0 + 16) & (py >= y0)
                                & (py < y0 + 4)].min()
                         for x0, y0 in warp_patches(cell, c, cells_x)]
                near = np.abs(np.array(least) - bound[k]) <= 4e-4 * abs(
                    bound[k])
                assert near.any(), (c, k)
                lo += int(min(least) < bound[k])
                hi += int(np.array(least)[near].min() > bound[k] + 1e-4)
        assert lo >= 20 and hi >= 20, (lo, hi)
    elif case == "hyperbolic":
        cxx, cxy, cyy = f[2], f[3], f[4]
        live = slice(0, int(ends[-1]))
        indefinite = (cxx * cyy < cxy * cxy)[live]
        assert int(indefinite.sum()) == 80
        assert all(any(p.any(axis=1)[::5]) for p, *_ in reach)
    else:   # edge_4x2
        assert cell == (4, 2) and len(starts) == 4 and cells_x == 2
        w_img, h_img = HAND_EDGE_IMAGE
        assert (16 * 4 * cells_x > w_img) and (16 * 2 * 2 > h_img)
        for c, (passes, px, py, *_) in enumerate(reach):
            inside = (px < w_img) & (py < h_img)
            assert passes[:, inside].any()
            if c % 2 or c // 2:   # a cell that crosses the image's edge
                assert passes[:, ~inside].any() and not inside.all()


def _reach_rects(cell, c, cells_x):
    """The rectangles of pixel centres the kernels cull cell c's records
    against, as ((x0, y0) corners, width, height): rasterize_fwd's tiles
    and its warps' 8x4 patches, rasterize_bwd's warps' 16x4 patches."""
    gw, gh = cell
    ox, oy = 16 * gw * (c % cells_x), 16 * gh * (c // cells_x)
    tiles = [(ox + 16 * (sub % gw), oy + 16 * (sub // gw))
             for sub in range(gw * gh)]
    return {"fwd tile": (tiles, 16, 16),
            "fwd 8x4": (fwd_warp_patches(cell, c, cells_x), 8, 4),
            "bwd 16x4": (warp_patches(cell, c, cells_x), 16, 4)}


def _kept(packed, s, e, corners, w, h):
    """may_reach_f32 of records s..e against each rectangle (corners, w,
    h), as the kernels call it: (records, rectangles) bool."""
    f = packed[:5].view(np.float32)
    smax = sigma_max_f32(packed[6, s:e].view(np.uint32) >> 16)
    xa = np.array([x for x, _ in corners], np.float32) + np.float32(0.5)
    ya = np.array([y for _, y in corners], np.float32) + np.float32(0.5)
    return may_reach_f32(*(f[r, s:e, None] for r in range(5)),
                         smax[:, None], xa[None], xa[None] + (w - 1),
                         ya[None], ya[None] + (h - 1))


def _scene_cell_args(cell):
    """A seeded scene's records at raster cell `cell` (CPU, plain
    kernels) as hand_cells gives its layouts: numpy packed, starts, ends,
    cells_x and the cell."""
    n, img_size, pool, scale_hi = SCENES["small"]
    r = port_records(make_scene(n, 31, scale_hi), img_size, pool, "cpu",
                     cell)
    return (r["packed"].numpy(), r["starts"].numpy(), r["ends"].numpy(),
            r["tiles_x"], cell)


@pytest.mark.parametrize("layout", [f"hand {c}" for c in HAND_CELL_CASES]
                         + ["scene 2x2", "scene 4x2"])
def test_reach_rule_keeps_every_passing_pair(layout):
    """csrc/reach.cuh's rule (its float32 twin, may_reach_f32) keeps every
    record that has a (record, pixel) pair passing the kernels' float32
    pretest, for the pixel's tile and 8x4 warp patch (rasterize_fwd's
    culls) and its 16x4 warp patch (rasterize_bwd's lists): on the layouts
    of ops/cuda/testing.hand_cells (pretest_edge puts records within 3e-4
    of the bound) and on a seeded scene's records at cells (2, 2) and (4,
    2)."""
    kind, name = layout.split()
    args = (hand_cells(name) if kind == "hand" else
            _scene_cell_args(tuple(int(v) for v in name.split("x"))))
    packed, starts, ends, cells_x, cell, reach = _reach(*args)
    dropped = 0
    for c, (passes, px, py, sig, s, e) in enumerate(reach):
        assert passes.any()
        for rect, (corners, w, h) in _reach_rects(cell, c, cells_x).items():
            keep = _kept(packed, s, e, corners, w, h)
            x0 = np.array([x for x, _ in corners])[:, None]
            y0 = np.array([y for _, y in corners])[:, None]
            inside = ((px[None] > x0) & (px[None] < x0 + w)
                      & (py[None] > y0) & (py[None] < y0 + h))
            assert (inside.sum(0) == 1).all()   # the rectangles tile it
            missed = passes & ~keep[:, inside.argmax(0)]
            assert not missed.any(), (rect, c, np.argwhere(missed)[:5])
            dropped += int((~keep).sum())
    assert dropped > 0   # the rule culls something on every layout


def test_reach_rule_drops_one_tile_records_at_other_tiles():
    """On hand_cells' one_tile layout (each record's footprint inside one
    tile of its cell) may_reach_f32 drops nearly every record at the
    cell's three other tiles: the work rasterize_fwd's tile cull saves."""
    packed, starts, ends, cells_x, cell, reach = _cell_reach("one_tile")
    others = dropped = 0
    for c, (passes, px, py, sig, s, e) in enumerate(reach):
        corners, w, h = _reach_rects(cell, c, cells_x)["fwd tile"]
        keep = _kept(packed, s, e, corners, w, h)
        ox, oy = 16 * cell[0] * (c % cells_x), 16 * cell[1] * (c // cells_x)
        sub = (((py - oy) // 16).astype(int) * cell[0]
               + ((px - ox) // 16).astype(int))
        home = sub[passes.argmax(1)]   # the one tile each record reaches
        assert passes.any(1).all()
        other = np.ones_like(keep)
        other[np.arange(len(home)), home] = False
        assert keep[~other].all()
        others += int(other.sum())
        dropped += int((other & ~keep).sum())
    assert dropped >= 0.95 * others, (dropped, others)


def test_rasterize_fwd_plain_counts_reach_pairs():
    """rasterize_fwd_plain(count_pairs=True, reach=may_reach_f32): the
    pairs whose record may reach the pixel's warp patch lie between the
    active pairs and all pairs, leave the outputs unchanged, and hardly
    change with the cell (the work a culling kernel must do), where all
    pairs grow with it (chip_smoke.raster_bounds' two bounds)."""
    counts = {}
    for cell in ((1, 1), (2, 2), (4, 2)):
        n, img_size, pool, scale_hi = SCENES["small"]
        r = port_records(make_scene(n, 2, scale_hi), img_size, pool, "cpu",
                         cell)
        args = (r["packed"], r["starts"], r["ends"], r["tiles_x"], cell)
        *out, (pairs, active, reach) = t_raster.rasterize_fwd_plain(
            *args, count_pairs=True, reach=may_reach_f32)
        *want, (pairs_w, active_w) = t_raster.rasterize_fwd_plain(
            *args, count_pairs=True)
        assert all(torch.equal(a, b) for a, b in zip(out, want))
        assert (pairs, active) == (pairs_w, active_w)
        assert 0 < active <= reach < pairs
        counts[cell] = (pairs, reach)
    for cell in ((2, 2), (4, 2)):
        assert counts[cell][0] > 2 * counts[(1, 1)][0]
        assert abs(counts[cell][1] / counts[(1, 1)][1] - 1) < 0.01


def test_rasterize_bwd_plain_counts_reach_pairs():
    """rasterize_bwd_plain(count_pairs=True, reach=may_reach_f32): the
    pairs whose record the kernel's per-warp list keeps (the 16x4 patch's
    largest final_idx and reach.cuh's rule) lie between the active pairs
    and all pairs the sweep evaluates, leave the rows unchanged, and
    hardly change with the cell where all pairs grow with it
    (chip_smoke.raster_bounds' rasterize_bwd_reach)."""
    counts = {}
    for cell in ((1, 1), (2, 2), (4, 2)):
        n, img_size, pool, scale_hi = SCENES["small"]
        r = port_records(make_scene(n, 2, scale_hi), img_size, pool, "cpu",
                         cell)
        args = (r["packed"], r["starts"], r["ends"], r["tiles_x"], cell)
        _, log_t, fidx = t_raster.rasterize_fwd_plain(*args)
        v_out = torch.tensor(np.random.default_rng(3).normal(
            size=(*log_t.shape, 4)).astype(np.float32))
        b_args = (*args[:4], v_out, log_t, fidx, cell)
        grads, swept, active, reach = t_bwd.rasterize_bwd_plain(
            *b_args, count_pairs=True, reach=may_reach_f32)
        want, swept_w, active_w = t_bwd.rasterize_bwd_plain(
            *b_args, count_pairs=True)
        assert torch.equal(grads, want)
        assert (swept, active) == (swept_w, active_w)
        assert 0 < active <= reach < swept
        counts[cell] = (swept, reach)
    for cell in ((2, 2), (4, 2)):
        assert counts[cell][0] > 2 * counts[(1, 1)][0]
        assert abs(counts[cell][1] / counts[(1, 1)][1] - 1) < 0.05


def test_hand_small_pool_reaches_its_cases():
    """ops/cuda/testing.hand_small_pool: the CLI's capacity and live
    splats, spans of segment_sum's kernel wholly inside one splat and spans
    holding dozens, splats over several spans, padding rows; and on rows of
    multiples of 1/16 the plain version's sums are exact."""
    offsets, cum, total = hand_small_pool()
    span = kernel_constant("segsum", "kSpan")
    counts = cum - offsets
    live = int(total[0])
    assert len(cum) == HAND_SMALL_N and live == int(cum[-1]) < HAND_SMALL_POOL
    assert 2500 < int((counts > 0).sum()) <= HAND_SMALL_LIVE
    assert not counts[HAND_SMALL_LIVE:].any() and (counts == 0).sum() > 5000
    starts_in = np.bincount(offsets[counts > 0] // span,
                            minlength=-(-live // span))
    assert starts_in.max() >= 30
    first, last = offsets // span, (cum - 1) // span
    assert int((last - first)[counts > 0].max()) >= 3
    whole = (offsets <= span * (first + 1)) & (cum >= span * (first + 2))
    assert bool((whole & (counts > 0)).any())   # a span inside one splat
    rows = torch.tensor(np.random.default_rng(8).integers(
        -63, 64, (t_bwd.GRAD_ROWS, HAND_SMALL_POOL)) / 16.0,
        dtype=torch.float32)
    got = t_seg.segment_sum(rows, *(torch.tensor(a) for a in (
        offsets, cum, total)))
    prefix = np.concatenate([np.zeros((t_bwd.GRAD_ROWS, 1)), np.cumsum(
        rows.numpy().astype(np.float64), axis=1)], axis=1)
    want = prefix[:, cum] - prefix[:, offsets]   # exact: 1/16 steps
    np.testing.assert_array_equal(got.numpy(), want)


def test_library_name_follows_source_and_headers(tmp_path, monkeypatch):
    """A library's file name carries a hash of its source and of every
    header beside it, so editing a shared header (tile_order.cuh) can
    never leave a stale library loaded."""
    for fname, text in (("a.cu", "// a"), ("b.cu", "// b"),
                        ("shared.cuh", "// h")):
        (tmp_path / fname).write_text(text)
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    a, b = build._lib_path("a"), build._lib_path("b")
    assert a != b and a == build._lib_path("a")
    (tmp_path / "shared.cuh").write_text("// h, edited")
    assert build._lib_path("a") != a and build._lib_path("b") != b
    a = build._lib_path("a")
    (tmp_path / "a.cu").write_text("// a, edited")
    assert build._lib_path("a") != a


def test_kernel_sources_find_their_headers():
    """Every header a kernel source includes lies beside it, where nvcc
    looks first and the library's hash covers it."""
    import os
    import re

    for name in build.SOURCES:
        with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
            for header in re.findall(r'#include "([^"]+)"', f.read()):
                assert header.endswith(".cuh")
                assert os.path.isfile(os.path.join(build.CSRC, header))


# ---- on the card: each CUDA kernel against its plain version ----------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_cuda_expand_equals_plain(name):
    _need_cuda()
    n, img_size, pool, scale_hi = SCENES[name]
    r = port_records(make_scene(n, 5, scale_hi), img_size, pool, "cuda")
    args = (r["f5"], r["u5"], r["cum"], r["total"], r["tiles_x"],
            r["num_tiles"], pool)
    before = t_expand.launches
    keys, recs = t_expand.expand(*args)
    torch.cuda.synchronize()
    assert t_expand.launches == before + 1
    pk, pr = t_expand.expand_plain(*args)
    assert torch.equal(keys, pk) and torch.equal(recs, pr)


@pytest.mark.cuda
@pytest.mark.parametrize("case", HAND_EXPAND_CASES)
def test_cuda_expand_hand_layouts_equal_plain(case):
    """The layouts made by hand (ops/cuda/testing.hand_expand): the kernel
    byte-equal to the plain version, and two launches bit-equal."""
    _need_cuda()
    args = hand_expand_args(case, "cuda")
    keys, recs = t_expand.expand(*args)
    again = t_expand.expand(*args)
    torch.cuda.synchronize()
    pk, pr = t_expand.expand_plain(*args)
    assert torch.equal(keys, pk) and torch.equal(recs, pr)
    assert torch.equal(keys, again[0]) and torch.equal(recs, again[1])


@pytest.mark.cuda
def test_cuda_wrappers_replay_in_a_graph():
    """Each kernel wrapper (and index_add_, segment_sum's library call)
    captured in a CUDA graph replays to its eager outputs: chip_smoke.py
    times kernels on the device by such replays (device_ms)."""
    _need_cuda()
    n, img_size, pool, scale_hi = SCENES["small"]
    r = port_records(make_scene(n, 5, scale_hi), img_size, pool, "cuda")
    r_args = (r["packed"], r["starts"], r["ends"], r["tiles_x"])
    img, log_t, fidx = t_raster.rasterize_fwd(*r_args)
    v_out = torch.randn(img.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(3))
    rows = torch.randn((t_bwd.GRAD_ROWS, pool), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(4))
    ids = t_seg.slot_owners(r["cum"], r["total"], pool)
    n_splats = r["cum"].shape[0]
    calls = {
        "expand": lambda: t_expand.expand(
            r["f5"], r["u5"], r["cum"], r["total"], r["tiles_x"],
            r["num_tiles"], pool),
        "rasterize_fwd": lambda: t_raster.rasterize_fwd(*r_args),
        "rasterize_bwd": lambda: (t_bwd.rasterize_bwd(
            *r_args, v_out, log_t, fidx),),
        "segment_sum": lambda: (t_seg.segment_sum(
            rows, r["offsets"], r["cum"], r["total"]),),
        "index_add_": lambda: (torch.zeros(
            (t_bwd.GRAD_ROWS, n_splats), device="cuda").index_add_(
                1, ids, rows[:, :ids.shape[0]].contiguous()),)}
    for name, call in calls.items():
        want = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = call()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if name in ("index_add_",):   # atomic adds: order may differ
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
            else:
                assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["small", "bbox_splats"])
def test_cuda_rasterize_fwd_matches_plain(name):
    _need_cuda()
    n, img_size, pool, scale_hi = SCENES[name]
    r = port_records(make_scene(n, 6, scale_hi), img_size, pool, "cuda")
    args = (r["packed"], r["starts"], r["ends"], r["tiles_x"])
    before = t_raster.launches
    img, log_t, fidx = t_raster.rasterize_fwd(*args)
    torch.cuda.synchronize()
    assert t_raster.launches == before + 1
    want = t_raster.rasterize_fwd_plain(*args)
    flip_check(img.cpu().numpy(), log_t.cpu().numpy(), fidx.cpu().numpy(),
               *(w.cpu().numpy() for w in want), atol=1e-5)
    _same_bits((img, log_t, fidx), t_raster.rasterize_fwd(*args))


def _same_bits(got, again):
    for a, b in zip(got, again):
        assert torch.equal(a, b), "two launches on the same inputs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("case", HAND_TILE_CASES)
def test_cuda_rasterize_fwd_hand_tiles_match_plain(case):
    """The layouts made by hand (ops/cuda/testing.hand_tiles): kernel against
    plain, and a second launch bit-equal. On the opaque tile the records
    behind the last crossing change no bit of the output."""
    _need_cuda()
    args = hand_tile_args(case, "cuda")
    img, log_t, fidx = t_raster.rasterize_fwd(*args)
    torch.cuda.synchronize()
    want = t_raster.rasterize_fwd_plain(*args)
    flip_check(img.cpu().numpy(), log_t.cpu().numpy(), fidx.cpu().numpy(),
               *(w.cpu().numpy() for w in want), atol=1e-5)
    _same_bits((img, log_t, fidx), t_raster.rasterize_fwd(*args))
    if case == "opaque":
        cut = torch.full_like(args[2], HAND_POISON_FROM)
        _same_bits((img, log_t, fidx), t_raster.rasterize_fwd(
            args[0], args[1], cut, args[3]))
        assert int(fidx.max()) < HAND_POISON_FROM - 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["deep", "opaque"])
def test_cuda_rasterize_bwd_on_hand_tiles(case):
    """rasterize_bwd on the forward kernel's log T and final_idx for the
    deep and the saturating tile: the two kernels' active sets agree, so
    the rows match the plain version's on the same inputs."""
    _need_cuda()
    args = hand_tile_args(case, "cuda")
    _, log_t, fidx = t_raster.rasterize_fwd(*args)
    gen = torch.Generator(device="cuda").manual_seed(17)
    v_out = torch.randn((args[1].shape[0], 256, 4), generator=gen,
                        device="cuda")
    b_args = (*args, v_out, log_t, fidx)
    got = t_bwd.rasterize_bwd(*b_args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    rows_close(got, t_bwd.rasterize_bwd_plain(*b_args), 1e-4, case)
    assert torch.equal(got, t_bwd.rasterize_bwd(*b_args))


def hand_cell_args(case, device, seed=23):
    """hand_cells(case) as rasterize_bwd's arguments on `device`: the
    forward's log T and final_idx (the kernel's on the card, the plain
    version's on the CPU) and a seeded image cotangent."""
    packed, starts, ends, cells_x, cell = hand_cells(case)
    args = (torch.tensor(packed, device=device),
            torch.tensor(starts, device=device),
            torch.tensor(ends, device=device), cells_x)
    _, log_t, fidx = t_raster.rasterize_fwd(*args, cell)
    v_out = torch.tensor(np.random.default_rng(seed).normal(
        size=(*log_t.shape, 4)).astype(np.float32), device=device)
    return (*args, v_out, log_t, fidx, cell)


@pytest.mark.cuda
@pytest.mark.parametrize("case", HAND_CELL_CASES)
def test_cuda_rasterize_fwd_hand_cells_match_plain(case):
    """The raster-cell layouts made by hand (ops/cuda/testing.hand_cells),
    which the tile cull and the per-warp lists of the forward kernel must
    get right (records reaching one tile, one corner pixel, sigma at a
    patch's pretest edge, hyperbolic conics, edge cells at (4, 2)): the
    kernel against plain at the tile tests' tolerances, one launch
    counted, and a second launch bit-equal."""
    _need_cuda()
    packed, starts, ends, cells_x, cell = hand_cells(case)
    args = (torch.tensor(packed, device="cuda"),
            torch.tensor(starts, device="cuda"),
            torch.tensor(ends, device="cuda"), cells_x, cell)
    before = t_raster.launches
    img, log_t, fidx = t_raster.rasterize_fwd(*args)
    torch.cuda.synchronize()
    assert t_raster.launches == before + 1
    assert bool((fidx >= 0).any())
    want = t_raster.rasterize_fwd_plain(*args)
    flip_check(img.cpu().numpy(), log_t.cpu().numpy(), fidx.cpu().numpy(),
               *(w.cpu().numpy() for w in want), atol=1e-5)
    _same_bits((img, log_t, fidx), t_raster.rasterize_fwd(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("case", HAND_CELL_CASES)
def test_cuda_rasterize_bwd_hand_cells_match_plain(case):
    """The raster-cell layouts made by hand (ops/cuda/testing.hand_cells):
    the kernel within 1e-4 of each row's largest value of the plain
    version's rows, one launch counted, and a second launch bit-equal."""
    _need_cuda()
    b_args = hand_cell_args(case, "cuda")
    before = t_bwd.launches
    got = t_bwd.rasterize_bwd(*b_args)
    torch.cuda.synchronize()
    assert t_bwd.launches == before + 1
    assert torch.isfinite(got).all() and got.abs().max() > 0
    rows_close(got, t_bwd.rasterize_bwd_plain(*b_args), 1e-4, case)
    assert torch.equal(got, t_bwd.rasterize_bwd(*b_args))


# Every hand layout, and scan_edge, for the truncated scan (scan_passes=2).
SCAN_LAYOUTS = ([("tile", c) for c in HAND_TILE_CASES + ("scan_edge",)]
                + [("cell", c) for c in HAND_CELL_CASES])


@pytest.mark.cuda
def test_cuda_scan_instantiations_keep_occupancy():
    """What nvcc made of the rasterizers' instantiations, read on the card:
    the truncated scan's (one and two bfloat16 parts) hold as many blocks
    an SM as the exact path's, and the backward's sweeps spill nothing."""
    _need_cuda()
    fwd = t_raster.kernel_attrs()
    for cells in (False, True):
        for passes in (1, 2):
            assert fwd[cells, passes][2] == fwd[cells, 0][2] > 0
    bwd = t_bwd.kernel_attrs()
    for passes in (1, 2):
        assert bwd[passes][2] == bwd[0][2] > 0
    assert all(a[1] == 0 for a in bwd.values())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", SCAN_LAYOUTS,
                         ids=[f"{k}-{c}" for k, c in SCAN_LAYOUTS])
def test_cuda_truncated_scan_matches_plain(layout):
    """Both kernels at scan_passes=2 (batches of 128 records at tiles, of
    the pipeline's scan_lanes at cells) against their plain versions on
    every hand layout, at the tolerances of the exact path's tests; a
    second launch of each bit-equal. On scan_edge the kernel's final_idx
    is the plain version's at the named pixels, and differs from the
    kernel's own at scan_passes=3. log T is held in transmittance space
    (as the Pallas comparisons hold it): the kernel carries T as running
    products (csrc/scan.cuh), the plain version sums log T by torch's
    reductions, and on the 600 records of scan_edge's deep tile (log T
    -8.4, T 2e-4) the float32 sums of logs part by some 1e-5."""
    _need_cuda()
    kind, case = layout
    if case == "scan_edge":
        packed, starts, ends, tiles_x = scan_edge()
        cell = (1, 1)
    elif kind == "tile":
        packed, starts, ends, tiles_x = hand_tiles(case)
        cell = (1, 1)
    else:
        packed, starts, ends, tiles_x, cell = hand_cells(case)
    args = (torch.tensor(packed, device="cuda"),
            torch.tensor(starts, device="cuda"),
            torch.tensor(ends, device="cuda"), tiles_x, cell)
    scan = dict(scan_passes=2, k_lanes=scan_lanes(128 if kind == "tile"
                                                  else 512, cell))
    img, log_t, fidx = t_raster.rasterize_fwd(*args, **scan)
    torch.cuda.synchronize()
    want = t_raster.rasterize_fwd_plain(*args, **scan)
    flip_check(img.cpu().numpy(), log_t.cpu().numpy(), fidx.cpu().numpy(),
               *(w.cpu().numpy() for w in want), atol=1e-5,
               transmittance=True)
    _same_bits((img, log_t, fidx), t_raster.rasterize_fwd(*args, **scan))
    if case == "scan_edge":
        from brush_tpu_torch.ops.cuda.testing import SCAN_EDGE_PIXELS

        exact = t_raster.rasterize_fwd(*args)[2]
        for tile, pixel, sign in SCAN_EDGE_PIXELS:
            assert int(fidx[tile, pixel]) == int(want[2][tile, pixel])
            assert int(fidx[tile, pixel] - exact[tile, pixel]) == sign
    v_out = torch.tensor(np.random.default_rng(29).normal(
        size=(*log_t.shape, 4)).astype(np.float32), device="cuda")
    b_args = (*args[:4], v_out, log_t, fidx, cell)
    got = t_bwd.rasterize_bwd(*b_args, **scan)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    rows_close(got, t_bwd.rasterize_bwd_plain(*b_args, **scan), 1e-4, case)
    assert torch.equal(got, t_bwd.rasterize_bwd(*b_args, **scan))


@pytest.mark.cuda
def test_cuda_rasterize_fwd_hyperbolic_conic_matches_plain():
    _need_cuda()
    n, img_size, pool, scale_hi = SCENES["small"]
    r = port_records(make_scene(n, 9, scale_hi), img_size, pool, "cuda")
    packed = r["packed"].clone()
    live = int(r["total"][0])
    hyper = torch.tensor([1.0, -1.5, 1.0], device="cuda").view(torch.int32)
    packed[2:5, :live:7] = hyper[:, None]
    args = (packed, r["starts"], r["ends"], r["tiles_x"])
    img, log_t, fidx = t_raster.rasterize_fwd(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(img).all() and torch.isfinite(log_t).all()
    want = t_raster.rasterize_fwd_plain(*args)
    flip_check(img.cpu().numpy(), log_t.cpu().numpy(), fidx.cpu().numpy(),
               *(w.cpu().numpy() for w in want), atol=1e-5)
    _same_bits((img, log_t, fidx), t_raster.rasterize_fwd(*args))


@pytest.mark.cuda
def test_cuda_render_matches_cpu():
    _need_cuda()
    sc = make_scene(512, 8)
    out = {}
    for dev in ("cpu", "cuda"):
        t = {k: torch.tensor(v, device=dev) for k, v in sc.items()}
        out[dev] = render_splats(
            t["means"], t["log_scales"], t["quats"], t["sh_coeffs"],
            t["raw_opacity"], camera_params(Camera(**CAM), (64, 48),
                                            device=dev),
            (64, 48), needs_grad=False)
    torch.cuda.synchronize()
    close_with_flips(out["cuda"][0].cpu().numpy(), out["cpu"][0].numpy(),
                     atol=1e-5, what="render")
    assert int(out["cuda"][1].num_isects) == int(out["cpu"][1].num_isects)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [(2, 2), (3, 1), (4, 2)])
def test_cuda_rasterizers_at_cells_match_plain(cell):
    """Both rasterizers at a raster cell (the deep-tile scene: several
    staging batches a cell; 32x32 is 2x2 tiles, which (3, 1) and (4, 2) do
    not divide): forward against plain (tolerances of the tile tests),
    backward on the kernel forward's outputs within 1e-4 of each row's
    largest value, launches counted once, repeats bit-equal."""
    _need_cuda()
    n, img_size, pool, scale_hi = BWD_SCENES["deep_tiles"]
    r = port_records(make_scene(n, 12, scale_hi), img_size, pool, "cuda",
                     cell)
    args = (r["packed"], r["starts"], r["ends"], r["tiles_x"], cell)
    before = (t_raster.launches, t_bwd.launches)
    img, log_t, fidx = t_raster.rasterize_fwd(*args)
    torch.cuda.synchronize()
    p = 256 * cell[0] * cell[1]
    assert img.shape == (r["num_tiles"], p, 4) and log_t.shape[1] == p
    want = t_raster.rasterize_fwd_plain(*args)
    flip_check(img.cpu().numpy(), log_t.cpu().numpy(), fidx.cpu().numpy(),
               *(w.cpu().numpy() for w in want), atol=1e-5)
    _same_bits((img, log_t, fidx), t_raster.rasterize_fwd(*args))
    gen = torch.Generator(device="cuda").manual_seed(19)
    v_out = torch.randn((*log_t.shape, 4), generator=gen, device="cuda")
    b_args = (*args[:4], v_out, log_t, fidx, cell)
    got = t_bwd.rasterize_bwd(*b_args)
    torch.cuda.synchronize()
    assert (t_raster.launches, t_bwd.launches) == (before[0] + 2,
                                                   before[1] + 1)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    rows_close(got, t_bwd.rasterize_bwd_plain(*b_args), 1e-4, f"{cell}")
    assert torch.equal(got, t_bwd.rasterize_bwd(*b_args))


@pytest.mark.cuda
def test_cuda_render_at_cell_matches_tiles():
    """render_splats at cell (2, 2) on the card, with gradients: the image
    of the tile path within 1e-5 but for counted flips, fewer records."""
    _need_cuda()
    sc = make_scene(512, 8)
    t = {k: torch.tensor(v, device="cuda") for k, v in sc.items()}
    cp = camera_params(Camera(**CAM), (80, 48), device="cuda")
    out = {cell: render_splats(t["means"], t["log_scales"], t["quats"],
                               t["sh_coeffs"], t["raw_opacity"], cp, (80, 48),
                               cell=cell)
           for cell in ((1, 1), (2, 2))}
    torch.cuda.synchronize()
    close_with_flips(out[(2, 2)][0].detach().cpu().numpy(),
                     out[(1, 1)][0].detach().cpu().numpy(), atol=1e-5,
                     what="cell render")
    assert 0 < int(out[(2, 2)][1].num_isects) < int(
        out[(1, 1)][1].num_isects)


def rows_close(got, want, rtol, what=""):
    """Each gradient row within rtol of that row's largest |value|."""
    for r in range(want.shape[0]):
        scale = float(want[r].abs().max())
        err = float((got[r] - want[r]).abs().max())
        assert err <= rtol * scale, f"{what} row {r}: {err:.3e} > " \
            f"{rtol:.0e} x {scale:.3e}"


# (n, image, pool, largest scale) for rasterize_bwd: the plain scenes; a
# 32x32 image under 4000 splats, so each of its 4 tiles holds several
# staging batches of records; an image 5 tiles wide.
BWD_SCENES = {
    "small": SCENES["small"],
    "bbox_splats": SCENES["bbox_splats"],
    "hyperbolic": SCENES["small"],
    "deep_tiles": (4000, (32, 32), 16384, 0.3),
    "early_end": (4000, (32, 32), 16384, 0.3),
    "odd_tiles_x": (600, (80, 48), 4096, 0.5),
}
STAGING_BATCH = kernel_constant("rasterize_bwd", "kBatch")


def _bwd_args(case, seed):
    n, img_size, pool, scale_hi = BWD_SCENES[case]
    r = port_records(make_scene(n, seed, scale_hi), img_size, pool, "cuda")
    packed = r["packed"].clone()
    if case == "hyperbolic":
        live = int(r["total"][0])
        hyper = torch.tensor([1.0, -1.5, 1.0], device="cuda").view(
            torch.int32)
        packed[2:5, :live:7] = hyper[:, None]
    _, log_t, fidx = t_raster.rasterize_fwd(packed, r["starts"], r["ends"],
                                            r["tiles_x"])
    if case == "early_end":
        # Every pixel stops inside the tile's second batch from the back
        # of the sweep, each at its own record.
        pix = torch.arange(256, device="cuda", dtype=torch.int32)[None, :]
        stop = r["starts"][:, None] + STAGING_BATCH + 7 + pix % 61
        fidx = torch.minimum(fidx, stop)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    v_out = torch.randn((r["num_tiles"], 256, 4), generator=gen,
                        device="cuda")
    return (packed, r["starts"], r["ends"], r["tiles_x"], v_out, log_t,
            fidx), r


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BWD_SCENES))
def test_cuda_rasterize_bwd_matches_plain(case):
    """Kernel vs plain on the kernel forward's own log T and final_idx: the
    same active set (same rounded sigma, same libdevice exp), so the rows
    differ only in float32 rounding and summation order. A second launch
    on the same inputs is bit-equal."""
    _need_cuda()
    args, r = _bwd_args(case, 14)
    if case in ("deep_tiles", "early_end"):
        assert int((r["ends"] - r["starts"]).max()) > 2 * STAGING_BATCH
    if case == "odd_tiles_x":
        assert r["tiles_x"] % 2 == 1
    before = t_bwd.launches
    got = t_bwd.rasterize_bwd(*args)
    torch.cuda.synchronize()
    assert t_bwd.launches == before + 1
    assert torch.isfinite(got).all()
    rows_close(got, t_bwd.rasterize_bwd_plain(*args), 1e-4, case)
    assert torch.equal(got, t_bwd.rasterize_bwd(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_cuda_segment_sum_matches_plain(name):
    _need_cuda()
    n, img_size, pool, scale_hi = SCENES[name]
    r = port_records(make_scene(n, 15, scale_hi), img_size, pool, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = torch.randn((t_bwd.GRAD_ROWS, pool), generator=gen,
                       device="cuda")
    rows[:, int(r["total"][0]):] = 0.0
    args = (rows, r["offsets"], r["cum"], r["total"])
    before = t_seg.launches
    got = t_seg.segment_sum(*args)
    torch.cuda.synchronize()
    assert t_seg.launches == before + 1
    rows_close(got, t_seg.segment_sum_plain(*args), 1e-5, name)
    assert torch.equal(got, t_seg.segment_sum(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["span", "splat"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", HAND_LAYOUTS)
def test_cuda_segment_sum_hand_layouts(case, aligned, kernel):
    """The hand-made layouts, kernel against plain: as they are (the span
    kernel) and followed by splats of count 0 up to kSplatMinSplats splats,
    a capacity's padding (the splat kernel: csrc/segsum.cu picks it from
    that many splats on); the rows also from a buffer that starts 4 bytes
    off a 16-byte boundary, which takes the kernel's 4-byte copies. Slots
    at and past `total` hold garbage that must not be summed."""
    _need_cuda()
    offsets, cum, total = hand_segments(case)
    if kernel == "splat":
        pad = np.full(kernel_constant("segsum", "kSplatMinSplats")
                      - len(offsets), cum[-1], np.int32)
        offsets, cum = np.concatenate([offsets, pad]), np.concatenate(
            [cum, pad])
    offsets, cum, total = (torch.tensor(x, device="cuda")
                           for x in (offsets, cum, total))
    gen = torch.Generator(device="cuda").manual_seed(16)
    buf = torch.randn(t_bwd.GRAD_ROWS * HAND_POOL + 1, generator=gen,
                      device="cuda")
    rows = buf[0 if aligned else 1:][:t_bwd.GRAD_ROWS * HAND_POOL].view(
        t_bwd.GRAD_ROWS, HAND_POOL)
    assert (rows.data_ptr() % 16 == 0) == aligned
    got = t_seg.segment_sum(rows, offsets, cum, total)
    torch.cuda.synchronize()
    want = t_seg.segment_sum_plain(rows, offsets, cum, total)
    if case == "total_zero":
        assert not got.any() and not want.any()
    else:
        rows_close(got, want, 1e-5, case)
    assert torch.equal(got, t_seg.segment_sum(rows, offsets, cum, total))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_segment_sum_small_pool(aligned):
    """The CLI-sized layout (ops/cuda/testing.hand_small_pool) with rows of
    multiples of 1/16, so every order of summation gives the same floats:
    the kernel equal to the plain version at `total` = all live slots, one
    slot into and the middle of the longest splat, and 0; rows also from a
    buffer 4 bytes off a 16-byte boundary; two launches bit-equal."""
    _need_cuda()
    offsets, cum, total = hand_small_pool()
    w = int(np.argmax(cum - offsets))
    gen = torch.Generator(device="cuda").manual_seed(18)
    size = t_bwd.GRAD_ROWS * HAND_SMALL_POOL
    buf = torch.randint(-63, 64, (size + 1,), generator=gen,
                        device="cuda").to(torch.float32) / 16.0
    rows = buf[0 if aligned else 1:][:size].view(t_bwd.GRAD_ROWS,
                                                 HAND_SMALL_POOL)
    offsets, cum = (torch.tensor(x, device="cuda") for x in (offsets, cum))
    for value in (int(total[0]), int(offsets[w]) + 1,
                  (int(offsets[w]) + int(cum[w])) // 2, 0):
        t = torch.tensor([value], dtype=torch.int32, device="cuda")
        got = t_seg.segment_sum(rows, offsets, cum, t)
        torch.cuda.synchronize()
        assert torch.equal(got, t_seg.segment_sum_plain(rows, offsets, cum,
                                                        t)), value
        assert torch.equal(got, t_seg.segment_sum(rows, offsets, cum, t))


@pytest.mark.cuda
def test_cuda_render_grads_match_cpu():
    """The whole differentiable render on the card (four kernels) against
    the CPU (four plain versions)."""
    _need_cuda()
    sc = make_scene(512, 16)
    names = ["means", "log_scales", "quats", "sh_coeffs", "raw_opacity"]
    grads = {}
    for dev in ("cpu", "cuda"):
        p = [torch.tensor(sc[k], device=dev, requires_grad=True)
             for k in names]
        img, _ = render_splats(*p, camera_params(Camera(**CAM), (64, 48),
                                                 device=dev), (64, 48),
                               pack_grad_sort=False)
        (img ** 2).sum().backward()
        grads[dev] = [x.grad.cpu() for x in p]
    for name, a, b in zip(names, grads["cuda"], grads["cpu"]):
        assert torch.isfinite(a).all(), name
        close_with_flips((a / b.abs().max()).numpy(),
                         (b / b.abs().max()).numpy(), atol=1e-4,
                         flip_tol=0.05, what=name)


@pytest.mark.cuda
def test_cuda_render_xla_matches_cpu():
    """render_splats(backend="xla") on the card (plain PyTorch: exact
    binning and the tiled rasterizer, no kernel launched) against the
    same on the CPU: the record counts equal, the image within 1e-5 and the
    gradients within 1e-4 of each one's largest entry, with a counted few
    threshold flips (index_add_ on the card sums with atomics)."""
    _need_cuda()
    sc = make_scene(512, 16)
    names = ["means", "log_scales", "quats", "sh_coeffs", "raw_opacity"]
    out = {}
    for dev in ("cpu", "cuda"):
        for mod in (t_expand, t_raster, t_bwd, t_seg):
            mod.launches = 0
        p = [torch.tensor(sc[k], device=dev, requires_grad=True)
             for k in names]
        img, aux = render_splats(*p, camera_params(Camera(**CAM), (64, 48),
                                                   device=dev), (64, 48),
                                 backend="xla")
        (img ** 2).sum().backward()
        assert not any(m.launches for m in (t_expand, t_raster, t_bwd,
                                            t_seg))
        out[dev] = (img.detach().cpu(), [x.grad.cpu() for x in p], aux)
    (img_c, g_c, aux_c), (img_g, g_g, aux_g) = out["cpu"], out["cuda"]
    for f in ("num_visible", "num_isects", "num_dropped"):
        assert int(getattr(aux_g, f)) == int(getattr(aux_c, f)), f
    close_with_flips(img_g.numpy(), img_c.numpy(), atol=1e-5, what="img")
    for name, a, b in zip(names, g_g, g_c):
        assert torch.isfinite(a).all(), name
        close_with_flips((a / b.abs().max()).numpy(),
                         (b / b.abs().max()).numpy(), atol=1e-4,
                         flip_tol=0.05, what=name)


@pytest.mark.cuda
def test_cuda_aligned_rasterizer_matches_cpu():
    """make_pallas_rasterizer on the card (rasterize_fwd, rasterize_bwd
    and the backward's segment_sum on build_intersections(align=128)
    records: one launch each, no expand) against the CPU (the plain
    versions) on the same records: the pool bit-equal, the image within
    1e-5 and the gradients within 1e-4 of each one's largest entry, with
    a counted few threshold flips; a second backward pass on the card
    gives the same gradient bits (ROADMAP Queue 3 #12)."""
    _need_cuda()
    from brush_tpu_torch.ops.binning import build_intersections
    from brush_tpu_torch.ops.pipeline import make_pallas_rasterizer
    from brush_tpu_torch.render import detached, project_inputs

    sc = {k: torch.tensor(v) for k, v in make_scene(512, 16).items()}
    size, tiles, pool, lanes = (64, 48), (4, 3), 8192, 128
    num_tiles = tiles[0] * tiles[1]
    with torch.no_grad():
        proj, color, opac, xy = project_inputs(
            sc["means"], sc["log_scales"], sc["quats"], sc["sh_coeffs"],
            sc["raw_opacity"], camera_params(Camera(**CAM), size,
                                             device="cpu"), size)
    isect = build_intersections(detached(proj), opac, tiles, pool,
                                align=lanes)
    assert int((isect.ends - isect.starts).sum()) == int(isect.num_isects)
    assert int(isect.num_isects) > 1000
    leaves = [a[isect.order] for a in (xy, proj.conic, color, opac)]
    cot = torch.randn((num_tiles, 256, 4),
                      generator=torch.Generator().manual_seed(3))
    out = {}
    for dev in ("cpu", "cuda"):
        mods = (t_expand, t_raster, t_bwd, t_seg)
        for mod in mods:
            mod.launches = 0
        params = [a.detach().to(dev).requires_grad_(True) for a in leaves]
        records = [t.to(dev) for t in (isect.isect_gid, isect.starts,
                                       isect.ends)]
        raster = make_pallas_rasterizer(tiles[0], num_tiles, pool, lanes)
        img = raster(*params, *records, torch.arange(num_tiles, device=dev))
        (img * cot.to(dev)).sum().backward()
        want = [0, 1, 1, 1] if dev == "cuda" else [0, 0, 0, 0]
        assert [mod.launches for mod in mods] == want
        again = [a.detach().to(dev).requires_grad_(True) for a in leaves]
        (raster(*again, *records, torch.arange(num_tiles, device=dev))
         * cot.to(dev)).sum().backward()
        assert all(torch.equal(p.grad, q.grad)
                   for p, q in zip(params, again))
        packed = t_raster.pack_isect_splats(
            *[a.to(dev) for a in leaves], records[0], pool, lanes)
        out[dev] = (img.detach().cpu(), [p.grad.cpu() for p in params],
                    packed.cpu())
    (img_c, g_c, pool_c), (img_g, g_g, pool_g) = out["cpu"], out["cuda"]
    assert torch.equal(pool_g, pool_c)
    close_with_flips(img_g.numpy(), img_c.numpy(), atol=1e-5, what="img")
    for name, a, b in zip(("xy", "conic", "color", "opac"), g_g, g_c):
        assert torch.isfinite(a).all(), name
        close_with_flips((a / b.abs().max()).numpy(),
                         (b / b.abs().max()).numpy(), atol=1e-4,
                         flip_tol=0.05, what=name)


# ---- stage marks (brush_tpu_torch.utils.profiler) ---------------------

TRAIN_STAGES = [
    "upload", "record_inputs", "depth_order", "expand", "tile_bins",
    "rasterize_fwd", "assemble", "loss", "loss backward", "rasterize_bwd",
    "grad_resort", "segment_sum", "to_global", "autograd rest",
    "densify_stats", "adam", "step end",
]


def test_stage_marks_are_inert_outside_a_recording(monkeypatch):
    """A mark outside profiler.record() records nothing (CPU work passes
    through the marks untouched); record() refuses a machine without
    CUDA rather than timing nothing."""
    from brush_tpu_torch.utils import profiler

    profiler.mark("anything")
    assert profiler._marks is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiler.record():
            pass
    assert profiler._marks is None


@pytest.mark.cuda
def test_cuda_stage_marks_cover_a_train_step():
    """One SplatTrainer step on the card, recorded: every stage of the
    step is marked once, in stream order, the backward's on the autograd
    thread included."""
    _need_cuda()
    from brush_tpu_torch.splats import from_random
    from brush_tpu_torch.train import SceneBatch, SplatTrainer
    from brush_tpu_torch.utils import profiler

    sp = from_random(np.random.default_rng(0), [-1] * 3, [1] * 3, count=256,
                     sh_degree=1, device="cuda")
    trainer = SplatTrainer()
    state = trainer.init_state(sp)
    batch = SceneBatch(np.zeros((48, 64, 3), np.float32), Camera(**CAM))
    with profiler.record() as entries:
        trainer.step(state, batch)
    stages = profiler.chain(entries)
    assert [name for name, _ in stages] == TRAIN_STAGES
    assert all(ms >= 0.0 for _, ms in stages)


@pytest.mark.cuda
def test_cuda_cli_train(tmp_path):
    """`cli train --device cuda` on a tiny NeRF zip (8 train and 2 val
    views at 32x32): every step launches the four kernels, the losses are
    finite and the final eval and export run."""
    _need_cuda()
    import json

    from brush_tpu_torch import cli
    from brush_tpu_torch.datasets import testing as dt

    rng = np.random.default_rng(0)
    splits = {split: [(c2w, rng.integers(0, 256, (32, 32, 4), np.uint8))
                      for c2w in dt.orbit_views(n, seed=seed)]
              for split, n, seed in (("train", 8, 1), ("val", 2, 2))}
    source = str(tmp_path / "tiny.zip")
    dt.write_nerf_zip(source, splits)
    for mod in (t_expand, t_raster, t_bwd, t_seg):
        mod.launches = 0
    cli.main(["--device", "cuda", "train", "--source", source, "--iters",
              "4", "--init-count", "64", "--sh-degree", "1", "--block-size",
              "32", "--log-every", "1", "--checkpoint-dir", str(tmp_path),
              "--export", str(tmp_path / "out.ply")])
    launches = [mod.launches for mod in (t_expand, t_raster, t_bwd, t_seg)]
    assert min(launches) >= 4, launches
    with open(tmp_path / "metrics.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert (tmp_path / "out.ply").stat().st_size > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [(1, 1), (2, 2)])
def test_cuda_strip_kernels_match_plain(cell):
    """Both rasterizers on a strip at tile_base > 0 (the deep-tile scene's
    records; its last cells past the image, empty): against their plain
    versions (the tile tests' tolerances), launches counted once, repeats
    bit-equal; and every output of the strip's cells, forward and
    backward, equal in every bit to the whole-frame launch's there (a
    strip moves only the pixel origin)."""
    _need_cuda()
    n, img_size, pool, scale_hi = BWD_SCENES["deep_tiles"]
    r = port_records(make_scene(n, 16, scale_hi), img_size, pool, "cuda",
                     cell)
    num = r["num_tiles"]
    base, k = num // 2, num // 2 + 2
    inside = num - base
    tail = r["ends"][-1:].expand(k - inside)
    starts = torch.cat([r["starts"][base:], tail])
    ends = torch.cat([r["ends"][base:], tail])
    args = (r["packed"], starts, ends, r["tiles_x"], cell, base)
    before = (t_raster.launches, t_bwd.launches)
    img, log_t, fidx = t_raster.rasterize_fwd(*args)
    torch.cuda.synchronize()
    want = t_raster.rasterize_fwd_plain(*args)
    flip_check(img.cpu().numpy(), log_t.cpu().numpy(), fidx.cpu().numpy(),
               *(w.cpu().numpy() for w in want), atol=1e-5)
    _same_bits((img, log_t, fidx), t_raster.rasterize_fwd(*args))
    assert not img[inside:].any() and bool((fidx[inside:] == -1).all())
    whole = t_raster.rasterize_fwd(r["packed"], r["starts"], r["ends"],
                                   r["tiles_x"], cell)
    _same_bits((img[:inside], log_t[:inside], fidx[:inside]),
               (w[base:] for w in whole))

    gen = torch.Generator(device="cuda").manual_seed(23)
    v_whole = torch.randn((*whole[1].shape, 4), generator=gen, device="cuda")
    v_out = torch.cat([v_whole[base:], torch.zeros_like(v_whole[:k - inside])])
    b_args = (*args[:4], v_out, log_t, fidx, cell, base)
    got = t_bwd.rasterize_bwd(*b_args)
    torch.cuda.synchronize()
    assert (t_raster.launches, t_bwd.launches) == (before[0] + 3,
                                                   before[1] + 1)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    rows_close(got, t_bwd.rasterize_bwd_plain(*b_args), 1e-4, f"{cell}")
    assert torch.equal(got, t_bwd.rasterize_bwd(*b_args))
    lo = int(r["starts"][base])
    full = t_bwd.rasterize_bwd(r["packed"], r["starts"], r["ends"],
                               r["tiles_x"], v_whole, whole[1], whole[2],
                               cell)
    assert torch.equal(got[:, lo:], full[:, lo:])


@pytest.mark.cuda
def test_cuda_strip_pipeline_at_base_0_is_the_frame():
    """At tile_base 0 over all the cells (one rank's strip at world size
    1, and every unsharded pipeline) the strip binning gives the frame's
    bins in every bit, and the pipeline's image, order and counts are
    those of tile_bins and the forward kernel over the whole frame, the
    kernel in the pipeline's default scan (scan_passes=2, k_lanes 512)."""
    _need_cuda()
    from brush_tpu_torch.ops.pipeline import RecordPipeline, strip_bins

    sc = make_scene(2000, 17)
    t = {k: torch.tensor(v, device="cuda") for k, v in sc.items()}
    cp = camera_params(Camera(**CAM), (80, 48), device="cuda")
    rec = record_inputs(t["means"], t["log_scales"], t["quats"],
                        t["sh_coeffs"], t["raw_opacity"], cp, (80, 48))
    d = depth_order(rec.attrs9.detach(), rec.decode, rec.depth_key, 16384)
    keys, recs = t_expand.expand(d.f5, d.u5, d.cum, d.total, 5, 15, 16384)
    for a, b in zip(strip_bins(keys, recs, 15, 0, 15),
                    tile_bins(keys, recs, 15)):
        assert torch.equal(a, b)
    bins = tile_bins(keys, recs, 15)
    frame = t_raster.rasterize_fwd(*bins, 5, scan_passes=2, k_lanes=512)
    a9 = rec.attrs9.detach().clone().requires_grad_(True)
    img, order, total, raw = RecordPipeline.apply(
        a9, rec.decode, rec.depth_key, 5, 15, 16384, True)
    img.square().sum().backward()
    assert int(total) > 0
    assert torch.equal(order, d.order)
    assert torch.equal(total, d.total[0])
    assert torch.equal(raw, d.raw_total)
    assert torch.equal(img, frame[0])
    assert torch.isfinite(a9.grad).all() and a9.grad.abs().sum() > 0


@pytest.mark.cuda
def test_cuda_cli_train_shard_equals_train(tmp_path):
    """`cli train --shard --device cuda` without torchrun: a world of one
    process over NCCL, made and destroyed by the command; every logged
    loss equals `cli train`'s in every bit."""
    _need_cuda()
    import json

    from brush_tpu_torch import cli
    from brush_tpu_torch.datasets import testing as dt

    rng = np.random.default_rng(0)
    splits = {split: [(c2w, rng.integers(0, 256, (32, 32, 4), np.uint8))
                      for c2w in dt.orbit_views(n, seed=seed)]
              for split, n, seed in (("train", 8, 1), ("val", 2, 2))}
    source = str(tmp_path / "tiny.zip")
    dt.write_nerf_zip(source, splits)
    losses = []
    for flags in ([], ["--shard"]):
        ck = tmp_path / f"ck{len(losses)}"
        cli.main(["--device", "cuda", "train", "--source", source, "--iters",
                  "4", "--init-count", "64", "--sh-degree", "1",
                  "--block-size", "32", "--log-every", "1",
                  "--checkpoint-dir", str(ck), *flags])
        with open(ck / "metrics.jsonl") as f:
            losses.append([json.loads(line)["loss"] for line in f])
    assert not torch.distributed.is_initialized()
    assert len(losses[0]) == 4 and losses[1] == losses[0]


@pytest.mark.cuda
def test_cuda_viewer_frame_is_the_in_process_render():
    """A /api/frame over HTTP from a ViewerServer serving splats on the
    card decodes to the frame made in-process (render_splats ->
    pack_rgba_u32 -> the premultiplied composite over 24), and launches
    expand and rasterize_fwd once each."""
    _need_cuda()
    import json
    import socket
    import urllib.request

    from brush_tpu_torch.datasets.png import decode_png
    from brush_tpu_torch.render import pack_rgba_u32
    from brush_tpu_torch.splats import from_dense
    from brush_tpu_torch.viewer.server import RenderService, ViewerServer

    sc = make_scene(2048, 9)
    sp = from_dense(sc["means"], sc["sh_coeffs"], sc["quats"],
                    sc["raw_opacity"], sc["log_scales"], device="cuda")
    render = RenderService(block_size=512)
    render.publish(sp)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = ViewerServer(render, port=port)
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    url = f"http://127.0.0.1:{port}"
    try:
        for _ in range(200):
            try:
                json.loads(urllib.request.urlopen(url + "/api/state",
                                                  timeout=5).read())
                break
            except OSError:
                time.sleep(0.05)
        query = "&".join(f"{k}={v}" for k, v in (
            ("px", 0), ("py", 0), ("pz", -6), ("qw", 1), ("qx", 0),
            ("qy", 0), ("qz", 0), ("fovx", np.pi / 2), ("fovy", np.pi / 2),
            ("w", 64), ("h", 48)))
        urllib.request.urlopen(f"{url}/api/frame?{query}", timeout=120)
        t_expand.launches = t_raster.launches = 0
        png = urllib.request.urlopen(f"{url}/api/frame?{query}",
                                     timeout=120).read()
        counts = (t_expand.launches, t_raster.launches)
    finally:
        srv.shutdown()
        serving.join(timeout=30)
    img, _ = render_splats(
        sp.means, sp.log_scales, sp.quats, sp.sh_coeffs, sp.raw_opacity,
        camera_params(Camera(**CAM), (64, 48), device="cuda"), (64, 48),
        active=sp.active_mask(), block_size=512, needs_grad=False)
    packed = pack_rgba_u32(img).cpu().numpy()
    rgba = packed.view(np.uint8).reshape(48, 64, 4)
    a = rgba[..., 3:4].astype(np.float32) / 255.0
    want = np.clip(rgba[..., :3].astype(np.float32) + 24.0 * (1 - a), 0,
                   255).astype(np.uint8)
    assert np.array_equal(decode_png(png), want)
    assert counts == (1, 1)
    assert want.std() > 5.0


@pytest.mark.cuda
def test_cuda_trace_holds_the_kernels(tmp_path):
    """profiler.trace around a render on the card: the Chrome trace holds
    the span and the expand and rasterize_fwd kernels."""
    _need_cuda()
    import glob
    import json

    from brush_tpu_torch.utils import profiler

    sc = make_scene(2048, 10)
    t = {k: torch.tensor(v, device="cuda") for k, v in sc.items()}
    cam = camera_params(Camera(**CAM), (64, 48), device="cuda")
    go = lambda: render_splats(t["means"], t["log_scales"], t["quats"],
                               t["sh_coeffs"], t["raw_opacity"], cam,
                               (64, 48), needs_grad=False)
    go()
    with profiler.trace(str(tmp_path)):
        with profiler.span("frame"):
            go()
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert "frame" in names
    assert any("expand_kernel" in n for n in names)
    assert any("rasterize_fwd_kernel" in n for n in names)


def test_full_f32_holds_across_threads():
    """full_f32's flags are global to the process, and the viewer renders
    on its request threads while its worker trains: while any thread is in
    a block they stay off, and the last thread out restores them."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    from brush_tpu_torch.device import full_f32

    bad = []

    def work():
        for _ in range(300):
            with full_f32():
                if (torch.backends.cuda.matmul.allow_tf32
                        or torch.backends.cudnn.allow_tf32):
                    bad.append(1)
                time.sleep(0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work)
                   for _ in range(2 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not bad
        assert torch.backends.cudnn.allow_tf32
    finally:
        sys.setswitchinterval(interval)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
