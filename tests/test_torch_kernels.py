"""The port's expand and rasterize_fwd against the Pallas kernels, and
rasterize_bwd on the layouts made by hand.

The port builds a scene's record inputs with its own stages and the plain
versions of its CUDA kernels (CPU tensors); the Pallas kernels then run in
interpret mode on the same depth-ordered inputs and the same packed pool.
The expand pools must be byte-equal; the rasterizer outputs agree within
the alpha-threshold flip rule of conftest.assert_close_quantized at atol
1e-5. The CUDA kernels themselves are tested in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brush_tpu.ops.pallas.expand import WINDOW_ALIGN, build_comp_rows
from brush_tpu.ops.pallas.expand import expand_pallas
from brush_tpu.ops.pallas.rasterize_bwd import rasterize_bwd_pallas
from brush_tpu.ops.pallas.rasterize_fwd import quantize_color as j_qc
from brush_tpu.ops.pallas.rasterize_fwd import quantize_opac as j_qo
from brush_tpu.ops.pallas.rasterize_fwd import rasterize_fwd_pallas

from brush_tpu_torch.ops.cuda import expand as t_expand
from brush_tpu_torch.ops.cuda import rasterize_bwd as t_bwd
from brush_tpu_torch.ops.cuda import rasterize_fwd as t_raster
from brush_tpu_torch.ops.cuda.testing import (
    HAND_CELL_CASES, HAND_DEEP, HAND_EXPAND_PALLAS, HAND_OPAQUE_FROM,
    HAND_POISON_FROM, HAND_TILE_CASES, hand_cells, hand_tiles,
)
from test_torch_cuda import (
    SCENES, flip_check, hand_cell_args, hand_expand_args, hand_tile_args,
    kernel_constant, make_scene, port_records,
)
from torch_threads import pin_threads

pin_threads()

K_EXP = 512
u32 = lambda t: t.numpy().view(np.uint32)


def jax_expand(r, pool):
    """expand_pallas (interpret mode) on the port's depth-ordered inputs,
    through the reference's own build_comp_rows and window starts
    (raster_vjp.py:237-272). Returns numpy (keys, recs) in slot order."""
    f5 = jnp.asarray(r["f5"].numpy())
    u5 = jnp.asarray(r["u5"].numpy().view(np.uint32))
    cum = jnp.asarray(r["cum"].numpy())
    n = f5.shape[1]
    offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32), cum[:-1]])
    d0 = u5[2]
    window = K_EXP + 2 * WINDOW_ALIGN
    n_pad = -(-n // WINDOW_ALIGN) * WINDOW_ALIGN + window
    comps = build_comp_rows(
        f5[0], f5[1], f5[2], f5[3], f5[4], u5[0], u5[1],
        d0 & jnp.uint32(0x3FF), (d0 >> 11) & jnp.uint32(0x7FF),
        (d0 >> 22) | (((d0 >> 10) & jnp.uint32(1)) << 10), u5[3], u5[4],
        offsets, n_pad, cum=cum)
    starts_blk = jnp.arange(pool // K_EXP, dtype=jnp.int32) * K_EXP
    w0 = jnp.searchsorted(cum, starts_blk, side="right").astype(jnp.int32)
    s_lo = jnp.clip((w0 // WINDOW_ALIGN) * WINDOW_ALIGN, 0, n_pad - window)
    keys, recs = expand_pallas(
        comps, s_lo, jnp.asarray(r["total"].numpy()), tiles_x=r["tiles_x"],
        num_tiles=r["num_tiles"], n=n, max_isects=pool, k_exp=K_EXP,
        interpret=True)
    return np.asarray(keys), np.asarray(recs)


@pytest.mark.parametrize("name", list(SCENES))
def test_expand_plain_byte_equal_to_pallas(name):
    n, img_size, pool, scale_hi = SCENES[name]
    got = port_records(make_scene(n, seed=1, scale_hi=scale_hi), img_size,
                       pool)
    keys, recs = jax_expand(got, pool)
    np.testing.assert_array_equal(u32(got["keys"]), keys)
    np.testing.assert_array_equal(u32(got["recs"]), recs)
    live = got["cum"] > 0
    if name == "bbox_splats":
        small = (got["u5"][2].to(torch.int64) >> 10) & 1
        assert bool(((small == 0) & live).any()), "no bbox splat expanded"
    if name == "overflow":
        assert int(got["raw_total"]) > pool == int(got["total"][0])
    else:
        assert 0 < int(got["total"][0]) == int(got["cum"][-1]) < pool


@pytest.mark.parametrize("case", HAND_EXPAND_PALLAS)
def test_expand_hand_layouts_byte_equal_to_pallas(case):
    """The splat layouts made by hand (ops/cuda/testing.hand_expand) whose
    pool is whole 512-slot blocks and whose blocks keep the Pallas
    kernel's window (at most 512 + 128 owners a block): expand_plain
    byte-equal to expand_pallas in interpret mode."""
    f5, u5, cum, total, tiles_x, num_tiles, pool = hand_expand_args(
        case, "cpu")
    assert pool % K_EXP == 0
    keys, recs = t_expand.expand_plain(f5, u5, cum, total, tiles_x,
                                       num_tiles, pool)
    j_keys, j_recs = jax_expand(dict(f5=f5, u5=u5, cum=cum, total=total,
                                     tiles_x=tiles_x, num_tiles=num_tiles),
                                pool)
    np.testing.assert_array_equal(u32(keys), j_keys)
    np.testing.assert_array_equal(u32(recs), j_recs)


def test_tile_bins_groups_records_stably():
    got = port_records(make_scene(512, seed=7), (64, 48), 2048)
    keys = got["keys"].numpy()
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got["packed"].numpy(),
                                  got["recs"].numpy()[:, perm])
    # Row 7 holds each live record's compact splat id: the splat whose
    # slots [offsets, cum) hold the record before the tile sort.
    total = int(got["total"][0])
    owner = np.searchsorted(got["cum"].numpy(), np.arange(total),
                            side="right")
    assert total > 0 and len(np.unique(owner)) > 1
    np.testing.assert_array_equal(got["recs"][7].numpy()[:total], owner)
    np.testing.assert_array_equal(np.sort(got["packed"][7].numpy()[:total]),
                                  owner)
    bins = np.searchsorted(keys[perm], np.arange(got["num_tiles"] + 1))
    np.testing.assert_array_equal(got["starts"].numpy(), bins[:-1])
    np.testing.assert_array_equal(got["ends"].numpy(), bins[1:])


def _raster_args(got):
    return (got["packed"], got["starts"], got["ends"], got["tiles_x"])


@pytest.mark.parametrize("name", ["small", "bbox_splats"])
def test_rasterize_fwd_plain_matches_pallas(name):
    n, img_size, pool, scale_hi = SCENES[name]
    got = port_records(make_scene(n, seed=2, scale_hi=scale_hi), img_size,
                       pool)
    k_lanes = 128
    packed = np.pad(u32(got["packed"]), ((0, 0), (0, k_lanes)))
    img_j, log_t_j, fidx_j = rasterize_fwd_pallas(
        jnp.asarray(packed), jnp.asarray(got["starts"].numpy()),
        jnp.asarray(got["ends"].numpy()),
        jnp.arange(got["num_tiles"], dtype=jnp.int32),
        tiles_x=got["tiles_x"], num_tiles=got["num_tiles"],
        max_isects=pool, k_lanes=k_lanes, interpret=True, scan_passes=3)
    img, log_t, fidx = t_raster.rasterize_fwd(*_raster_args(got))
    # The TPU kernel evaluates sigma as an expanded rank-6 polynomial in
    # tile-local coordinates; its ~1e-6 cancellation error reaches log T
    # amplified by 1 / (1 - alpha) (up to 1000x near ALPHA_MAX), measured
    # up to 7e-5 on log T where T itself is ~5e-3. So log T is held in
    # transmittance space, where the image sees it, at the same atol.
    flip_check(img.numpy(), log_t.numpy(), fidx.numpy(),
                np.asarray(img_j), np.asarray(log_t_j), np.asarray(fidx_j),
                atol=1e-5, transmittance=True)
    assert np.abs(log_t.numpy() - np.asarray(log_t_j)).max() < 1e-3
    assert (fidx.numpy() >= 0).any()


@pytest.mark.parametrize("case", HAND_TILE_CASES)
def test_rasterize_fwd_hand_tiles_match_pallas(case):
    """Tile layouts made by hand (ops/cuda/testing.hand_tiles), which the
    scenes' ~170 records a tile do not reach: the plain rasterizer against
    the Pallas kernel in interpret mode, at the scenes' tolerance."""
    packed, starts, ends, tiles_x = hand_tiles(case)
    num_tiles, pool = len(starts), packed.shape[1]
    k_lanes = 128
    img_j, log_t_j, fidx_j = rasterize_fwd_pallas(
        jnp.asarray(np.pad(packed.view(np.uint32), ((0, 0), (0, k_lanes)))),
        jnp.asarray(starts), jnp.asarray(ends),
        jnp.arange(num_tiles, dtype=jnp.int32), tiles_x=tiles_x,
        num_tiles=num_tiles, max_isects=pool, k_lanes=k_lanes,
        interpret=True, scan_passes=3)
    args = hand_tile_args(case, "cpu")
    img, log_t, fidx = t_raster.rasterize_fwd(*args)
    flip_check(img.numpy(), log_t.numpy(), fidx.numpy(), np.asarray(img_j),
               np.asarray(log_t_j), np.asarray(fidx_j), atol=1e-5,
               transmittance=True)
    counts = ends - starts
    if case == "deep":
        # Deeper than three staging batches of either CUDA rasterizer, no
        # multiple of a batch or of the records a step takes.
        for kernel in ("rasterize_fwd", "rasterize_bwd"):
            batch = kernel_constant(kernel, "kBatch")
            assert counts[0] == HAND_DEEP > 3 * batch
            assert HAND_DEEP % batch
            assert HAND_DEEP % kernel_constant(kernel, "kUnroll")
        # No pixel saturates before the fourth batch.
        assert int(fidx[0].min()) > 3 * kernel_constant("rasterize_fwd",
                                                        "kBatch")
    if case == "opaque":
        # Every pixel crosses in the middle of one staging batch; the
        # records behind change nothing: the same outputs with the range
        # cut before them.
        batch = kernel_constant("rasterize_fwd", "kBatch")
        assert HAND_OPAQUE_FROM <= int(fidx.min())
        assert int(fidx.max()) < HAND_OPAQUE_FROM + 100 < HAND_POISON_FROM
        assert HAND_OPAQUE_FROM // batch == (HAND_OPAQUE_FROM + 100) // batch
        assert HAND_OPAQUE_FROM % batch and (HAND_OPAQUE_FROM + 100) % batch
        cut = t_raster.rasterize_fwd(
            args[0], args[1], torch.full_like(args[2], HAND_POISON_FROM),
            tiles_x)
        assert torch.equal(fidx, cut[2]) and torch.equal(log_t, cut[1])
        np.testing.assert_allclose(img.numpy(), cut[0].numpy(), atol=1e-6)
    if case == "opacity_edge":
        words = packed[6].view(np.uint32) >> 16
        hit = set(words[fidx.numpy()[fidx.numpy() >= 0]].tolist())
        assert hit == {258, 65535}   # 0, 1, 255 and 256 stay under 1/255
    if case == "empty_between":
        assert counts.tolist() == [150, 0, 150]
        assert not img[1].any() and not log_t[1].any()
        assert bool((fidx[1] == -1).all()) and bool((fidx[2] >= 150).any())
    if case == "odd_tiles_x":
        assert tiles_x % 2 == 1 and num_tiles > tiles_x


# The forward's hand-made cells held to the Pallas kernel: all but two.
# pretest_edge's records have conics up to a hundred times steeper than a
# scene's, and on them the TPU kernel's rank-6 polynomial sigma (cell-
# local terms up to |cxx| 16^2) cancels: emulated in float32 it moves
# sigma by up to 1.4e-4 and alpha by up to 7.7e-5 on the pairs that pass
# (1e-6 and 6e-8 on all_tiles), which leaves 29 image values of 8192 off
# by 1e-5 to 5.8e-5 at 15 pixels with final_idx equal; no pair's alpha
# crosses ALPHA_EPS under it (scripts/hand_cells_pallas_gap.py prints
# these). one_tile's records (0.5-0.9 pixels wide) move alpha by up to
# 3.7e-5 the same way; 6 of its 8192 values lie beyond 1e-5 (the budget
# is 16), but 82 did in two of 22 runs of this test, though neither side
# changed a bit when run again and again at 1-8 torch threads, side by
# side, on 1-3 cores or through the compile cache (ROADMAP Queue 3 #18):
# its count is left to no run's chance. The card tests hold the kernel to
# the plain version on every layout.
FWD_HAND_CELLS = tuple(c for c in HAND_CELL_CASES
                       if c not in ("pretest_edge", "one_tile"))


@pytest.mark.parametrize("case", FWD_HAND_CELLS)
def test_rasterize_fwd_hand_cells_match_pallas(case):
    """The raster-cell layouts made by hand (ops/cuda/testing.hand_cells):
    the plain rasterizer against the Pallas kernel in interpret mode at
    the layout's cell ((2, 2), or (4, 2) over an image it does not
    divide), at the bound of test_rasterize_fwd_hand_tiles_match_pallas
    (log T held in transmittance space, ROADMAP Queue 3 #1)."""
    packed, starts, ends, cells_x, cell = hand_cells(case)
    num_cells, pool = len(starts), packed.shape[1]
    k_lanes = 128
    img_j, log_t_j, fidx_j = rasterize_fwd_pallas(
        jnp.asarray(np.pad(packed.view(np.uint32), ((0, 0), (0, k_lanes)))),
        jnp.asarray(starts), jnp.asarray(ends),
        jnp.arange(num_cells, dtype=jnp.int32), tiles_x=cells_x,
        num_tiles=num_cells, max_isects=pool, k_lanes=k_lanes,
        interpret=True, scan_passes=3, cell=cell)
    img, log_t, fidx = t_raster.rasterize_fwd(
        torch.tensor(packed), torch.tensor(starts), torch.tensor(ends),
        cells_x, cell)
    assert img.shape == (num_cells, 256 * cell[0] * cell[1], 4)
    flip_check(img.numpy(), log_t.numpy(), fidx.numpy(), np.asarray(img_j),
               np.asarray(log_t_j), np.asarray(fidx_j), atol=1e-5,
               transmittance=True)
    assert (fidx.numpy() >= 0).any()


def test_rasterize_fwd_hyperbolic_conic_stays_finite():
    """Records with an indefinite conic (det < 0: f32 cancellation in the
    projection can emit one) send sigma far below zero away from their
    centre; exp takes max(sigma, 0), so the output stays finite and equal
    to the Pallas kernel's (regression of the reference's 96f7512)."""
    n, img_size, pool, scale_hi = SCENES["small"]
    got = port_records(make_scene(n, seed=9, scale_hi=scale_hi), img_size,
                       pool)
    packed = got["packed"].clone()
    live = int(got["total"][0])
    hyper = torch.tensor([1.0, -1.5, 1.0]).view(torch.int32)
    packed[2:5, :live:7] = hyper[:, None]
    packed[0:2, :live:7] = torch.tensor([4.0, 4.0]).view(torch.int32)[:, None]
    img, log_t, fidx = t_raster.rasterize_fwd(
        packed, got["starts"], got["ends"], got["tiles_x"])
    assert torch.isfinite(img).all() and torch.isfinite(log_t).all()
    img_j, log_t_j, fidx_j = rasterize_fwd_pallas(
        jnp.asarray(np.pad(u32(packed), ((0, 0), (0, 128)))),
        jnp.asarray(got["starts"].numpy()), jnp.asarray(got["ends"].numpy()),
        jnp.arange(got["num_tiles"], dtype=jnp.int32),
        tiles_x=got["tiles_x"], num_tiles=got["num_tiles"],
        max_isects=pool, k_lanes=128, interpret=True, scan_passes=3)
    flip_check(img.numpy(), log_t.numpy(), fidx.numpy(), np.asarray(img_j),
               np.asarray(log_t_j), np.asarray(fidx_j), atol=1e-5,
               transmittance=True)


def test_rasterize_fwd_empty_tiles():
    packed = torch.zeros((8, 256), dtype=torch.int32)
    zeros = torch.zeros(6, dtype=torch.int32)
    img, log_t, fidx = t_raster.rasterize_fwd(packed, zeros, zeros, 3)
    assert torch.all(img == 0) and torch.all(log_t == 0)
    assert torch.all(fidx == -1)


def test_rasterize_fwd_counts_pairs():
    """count_pairs = every live pixel's records up to its crossing one,
    and those of them whose alpha reaches ALPHA_EPS."""
    got = port_records(make_scene(512, seed=3), (64, 48), 2048)
    *_, fidx, (pairs, active) = t_raster.rasterize_fwd_plain(
        *_raster_args(got), count_pairs=True)
    all_pairs = 256 * int((got["ends"] - got["starts"]).sum())
    assert 0 < active < pairs <= all_pairs
    # Every pixel with a final_idx has an active pair.
    assert active >= int((fidx >= 0).sum())


def test_quantize_rounds_half_to_even_like_jax():
    # Values that land exactly on .5 steps: both frameworks round half to
    # even, so the u16 codes agree bit for bit.
    c = np.concatenate([
        np.array([-5.0, -4.0, 0.0, 4.0, 5.0, np.nan], np.float32),
        ((np.arange(-8, 9) + 0.5) / (65535.0 / 8.0) - 4.0).astype(
            np.float32),
        np.random.default_rng(0).uniform(-4.5, 4.5, 1000).astype(np.float32),
    ])
    c = c[~np.isnan(c)]
    np.testing.assert_array_equal(
        t_raster.quantize_color(torch.tensor(c)).numpy(),
        np.asarray(j_qc(jnp.asarray(c))).astype(np.int32))
    o = np.concatenate([np.array([-0.1, 0.0, 1.0, 1.5], np.float32),
                        (np.arange(9) + 0.5).astype(np.float32) / 65535.0])
    np.testing.assert_array_equal(
        t_raster.quantize_opac(torch.tensor(o)).numpy(),
        np.asarray(j_qo(jnp.asarray(o))).astype(np.int32))


def test_record_rows_roundtrip():
    rng = np.random.default_rng(4)
    f = [torch.tensor(rng.normal(size=64).astype(np.float32))
         for _ in range(5)]
    q = [torch.tensor(rng.integers(0, 65536, 64)) for _ in range(4)]
    rows = torch.stack(t_raster.pack_record_rows(*f, *q,
                                                 torch.arange(64)))
    dec = t_raster.unpack_record_rows(rows)
    for a, b in zip(dec[:5], f):
        assert torch.equal(a, b)
    for a, b, scale in zip(dec[5:], q, [t_raster.decode_color] * 3
                           + [t_raster.decode_opac]):
        assert torch.equal(a, scale(b))


# rasterize_bwd's hand layouts held to the Pallas kernel: two tiles of
# hand_tiles at (1, 1), and the (2, 2) cells of hand_cells whose records
# stay clear of the alpha threshold (pretest_edge puts records on it, where
# the TPU kernel's polynomial sigma rounds to either side; the card tests
# hold the kernel to the plain version there).
BWD_HAND = [("tiles", "deep"), ("tiles", "opaque"), ("cells", "one_tile"),
            ("cells", "all_tiles"), ("cells", "corner_pixel"),
            ("cells", "deep_cell"), ("cells", "hyperbolic")]


@pytest.mark.parametrize("kind,case", BWD_HAND)
def test_rasterize_bwd_plain_hand_layouts_match_pallas(kind, case):
    """rasterize_bwd_plain against rasterize_bwd_pallas in interpret mode
    (scan_passes 3) on the same records, the same log T and final_idx (the
    plain forward's) and a seeded cotangent, at (1, 1) and at cell (2, 2):
    each row within 3e-4 of its largest value, the bound of
    test_torch_grads.test_rasterize_bwd_plain_matches_pallas."""
    if kind == "tiles":
        args = hand_tile_args(case, "cpu")
        _, log_t, fidx = t_raster.rasterize_fwd(*args)
        v_out = torch.tensor(np.random.default_rng(29).normal(
            size=(*log_t.shape, 4)).astype(np.float32))
        b_args = (*args, v_out, log_t, fidx, (1, 1))
    else:
        b_args = hand_cell_args(case, "cpu")
    packed, starts, ends, tiles_x, v_out, log_t, fidx, cell = b_args
    pool, live = packed.shape[1], int(ends[-1])
    want = np.asarray(rasterize_bwd_pallas(
        jnp.asarray(np.pad(u32(packed), ((0, 0), (0, 128)))),
        jnp.asarray(v_out.numpy()), jnp.asarray(log_t.numpy()),
        jnp.asarray(fidx.numpy()), jnp.asarray(starts.numpy()),
        jnp.asarray(ends.numpy()),
        jnp.arange(starts.shape[0], dtype=jnp.int32), tiles_x=tiles_x,
        num_tiles=starts.shape[0], max_isects=pool, k_lanes=128,
        interpret=True, scan_passes=3, cell=cell))[:9, :live]
    got = t_bwd.rasterize_bwd(*b_args).numpy()
    assert np.isfinite(got).all() and not got[:, live:].any()
    assert np.abs(want).max() > 0
    for r in range(9):
        scale = np.abs(want[r]).max() + 1e-8
        np.testing.assert_allclose(got[r, :live] / scale, want[r] / scale,
                                   atol=3e-4, err_msg=f"row {r} ({case})")
