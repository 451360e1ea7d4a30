"""Kernel arguments made by hand, which the scenes do not reach.

chip_smoke.py and the tests (tests/test_torch_kernels.py and
test_torch_grads.py against the Pallas kernels, tests/test_torch_cuda.py
on the card) hold rasterize_fwd and rasterize_bwd to their plain versions
on these tile layouts (`hand_tiles`) and raster-cell layouts
(`hand_cells`), expand on these splat layouts (`hand_expand`), and
segment_sum on these segment layouts (`hand_segments`,
`hand_small_pool`), the truncated log-T scan of both rasterizers on
`scan_edge`, where it and the exact scan give a different final_idx, and
the projection's kernels and backward twin on `hand_projection`'s rows
(tests/test_torch_projection.py, tests/test_torch_cuda.py).
`may_reach_f32` is the float32 twin of the rule by
which both rasterizers leave records out of a tile's or a warp's work
(csrc/reach.cuh), `warp_patches` and `fwd_warp_patches` the rectangles
they apply it to. `rasterize_fwd_twin` and `rasterize_bwd_twin` follow
the CUDA kernels' truncated scan step by step on CPU tensors (T as
running products, csrc/scan.cuh), where the plain versions follow the
TPU kernels' log-domain formula.
"""

import numpy as np

HAND_TILE_CASES = ("deep", "opaque", "opacity_edge", "empty_between",
                   "odd_tiles_x")
HAND_DEEP = 1301                                # the "deep" tile's records
HAND_OPAQUE_FROM, HAND_POISON_FROM = 200, 400   # the "opaque" tile's parts


def hand_tiles(case):
    """Rasterizer arguments made by hand, which the scenes do not reach:
    (packed (8, pool) int32, starts, ends, tiles_x) as numpy arrays. Records
    lie tile after tile, centred inside their tile, with colours in
    [-0.3, 1.5] and splat ids 0, 1, .. in row 7.
      deep: a tile of HAND_DEEP faint records (more than three staging
        batches of either rasterizer, no multiple of a batch or of the
        records a step takes), beside one of 130;
      opaque: one tile of 700 records: 200 faint ones, then from
        HAND_OPAQUE_FROM wide records of opacity 0.5-0.9, so every pixel
        crosses the transmittance threshold in the middle of a batch, each
        at its own record; from HAND_POISON_FROM bright records of opacity
        0.99 that must leave every output untouched;
      opacity_edge: sharp records centred on pixel centres (sigma 0, so
        alpha is the opacity) with opacity words 0, 1, 255, 256 (just under
        1/255), 258 (just over) and 65535;
      empty_between: an empty tile between two of 150 records;
      odd_tiles_x: 3 x 2 tiles of 40-100 records each."""
    rng = np.random.default_rng(41)
    grid = {"deep": (2, 1), "opaque": (1, 1), "opacity_edge": (2, 1),
            "empty_between": (3, 1), "odd_tiles_x": (3, 2)}[case]
    tiles_x, tiles_y = grid

    def records(tile, count, opac_lo, opac_hi, radius_lo, radius_hi):
        """count records of one tile: float32 x, y, cxx, cxy, cyy and u16
        words r, g, b, opacity."""
        ox, oy = 16.0 * (tile % tiles_x), 16.0 * (tile // tiles_x)
        radius = rng.uniform(radius_lo, radius_hi, count)
        inv = 1.0 / radius ** 2
        return dict(
            x=ox + rng.uniform(0.0, 16.0, count),
            y=oy + rng.uniform(0.0, 16.0, count),
            cxx=inv, cxy=inv * rng.uniform(-0.3, 0.3, count),
            cyy=inv * rng.uniform(0.7, 1.3, count),
            rgb=rng.integers(30300, 45050, (3, count)),
            o=np.round(rng.uniform(opac_lo, opac_hi, count) * 65535.0))

    faint = (0.008, 0.03, 3.0, 8.0)
    if case == "deep":
        tiles = [records(0, HAND_DEEP, 0.005, 0.015, 3.0, 8.0),
                 records(1, 130, *faint)]
    elif case == "opaque":
        parts = [records(0, HAND_OPAQUE_FROM, *faint),
                 records(0, HAND_POISON_FROM - HAND_OPAQUE_FROM,
                         0.5, 0.9, 6.0, 12.0),
                 records(0, 300, 0.99, 0.99, 20.0, 30.0)]
        parts[2]["rgb"][:] = 65535
        tiles = [{k: np.concatenate([p[k] for p in parts], axis=-1)
                  for k in parts[0]}]
    elif case == "opacity_edge":
        words = np.array([0, 1, 255, 256, 258, 65535])
        tiles = []
        for tile in range(2):
            rec = records(tile, 48, 0.0, 0.0, 1.0, 1.0)
            rec["x"] = np.floor(rec["x"]) + 0.5
            rec["y"] = np.floor(rec["y"]) + 0.5
            rec["cxy"][:] = 0.0
            rec["cyy"][:] = 1.0
            rec["o"] = words[rng.integers(0, len(words), 48)]
            tiles.append(rec)
    elif case == "empty_between":
        mid = (0.02, 0.4, 2.0, 6.0)
        tiles = [records(0, 150, *mid), records(1, 0, *mid),
                 records(2, 150, *mid)]
    else:
        tiles = [records(t, int(rng.integers(40, 101)), 0.02, 0.6, 1.5, 6.0)
                 for t in range(tiles_x * tiles_y)]
    packed, starts, ends = _pack(tiles)
    return packed, starts, ends, tiles_x


SCAN_EDGE_LANES = 128   # scan_edge's batches (k_lanes)
SCAN_EDGE_CROSS = 100   # bulk records of a crossing batch up to the flip
SCAN_EDGE_MARGIN = 1e-5  # the exact prefix's distance from LOG_T_EPS
SCAN_EDGE_DEEP = 600    # the deep tile's identical records
# The named pixels: (tile, pixel index in the tile, the sign of the bulk
# records' truncation residual); the truncated scan crosses one record
# later than the exact one at the first, one record earlier at the second.
SCAN_EDGE_PIXELS = ((0, 8 * 16 + 8, 1), (1, 8 * 16 + 8, -1))
_LOG_T_EPS = np.log(np.float32(1e-4)).astype(np.float64)


def bf16_parts_f32(x, passes):
    """ops/cuda/rasterize_fwd.bf16_parts in numpy float32 (round to the
    nearest bfloat16, ties to even, as csrc/scan.cuh's bf16_round)."""
    rem = np.asarray(x, np.float32)
    out = np.zeros_like(rem)
    for _ in range(passes):
        u = rem.view(np.uint32).astype(np.uint64)
        u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
        c = u.astype(np.uint32).view(np.float32)
        rem = (rem - c).astype(np.float32)
        out = (out + c).astype(np.float32)
    return out


def _lom_f32(o_word, dx, dy, cxx, cyy):
    """log1p(-alpha) of a record at offset (dx, dy) from a pixel centre,
    opacity word o_word, axis-aligned conic, in float32 op by op as the
    plain rasterizer computes it."""
    f = np.float32
    dx, dy, cxx, cyy = f(dx), f(dy), f(cxx), f(cyy)
    sigma = f(0.5) * (cxx * dx * dx + cyy * dy * dy)
    o = f(o_word) * f(1.0 / 65535.0)
    alpha = min(f(0.999), o * np.exp(-sigma))
    return np.log1p(-alpha)


def scan_edge():
    """A tile layout on which scan_passes=2 and the exact scan give a
    different final_idx (batches of SCAN_EDGE_LANES): (packed, starts,
    ends, tiles_x) as numpy arrays, 3 x 1 tiles.
      tiles 0 and 1: one named pixel each (SCAN_EDGE_PIXELS, the tile's
        pixel (8, 8), near the tile's centre, where the TPU kernel's
        polynomial sigma hardly cancels). Its records are sharp (radius
        0.3, 0.1 px off the centre: no other pixel's alpha reaches 1/255
        but the tuner's neighbour's), in depth order: faint ones filling
        the tile's first batch, then a tuner, then identical bulk records
        (log1p(-alpha) about -0.08) whose bfloat16 truncation residual
        is large and of one sign (positive at tile 0, negative at tile
        1). The tuner's place is solved so that the exact prefix of log T
        reaches LOG_T_EPS at the SCAN_EDGE_CROSS-th bulk record, in the
        second batch, SCAN_EDGE_MARGIN from it: beyond it at tile 0,
        short of it at tile 1. The truncated sum has moved by some 3e-5
        there (100 residuals), three times the margin, against a float32
        summation noise of a few 1e-6 (ulps of 9.2): so the two scans
        flip by one record, each in its own direction, and no summation
        order decides either. Tile 1 starts off the 128-slot grid.
      tile 2: SCAN_EDGE_DEEP identical wide records (radius 6, alpha
        about 0.014 at the centre, log T -8.44 there at the end): more
        than four batches, no crossing,
        and at every pixel the same residual record after record, so the
        backward's truncated carries drift linearly."""
    rng = np.random.default_rng(97)
    f = np.float32
    radius = 0.3
    inv = 1.0 / radius ** 2
    k = SCAN_EDGE_CROSS
    words = np.arange(4000, 7500)
    tiles, start = [], 0
    for tile, _, sign in SCAN_EDGE_PIXELS:
        px, py = 16.0 * tile + 8.5, 8.5
        # The offset as the rasterizer sees it: float32 x minus the centre.
        off = np.float64(f(px + 0.1) - f(px))
        loms = np.array([_lom_f32(w, off, 0.0, inv, inv) for w in words])
        res = (bf16_parts_f32(loms, 2).astype(np.float64)
               - loms.astype(np.float64))
        fit = (loms > -0.09) & (loms < -0.07)
        # A residual of 0.7 of its largest (2^-21 here) and of the named
        # sign: one ulp of log1p(-alpha) more or less (float32 and the TPU
        # kernel's sigma) moves it little, where near 2^-21 (a tie of
        # the second part's rounding) it would flip its sign.
        wb = int(words[fit][np.argmin(np.abs(sign * res[fit]
                                             - 0.7 * 2.0 ** -21))])
        lom_b = np.float64(loms[words == wb][0])
        base = start // SCAN_EDGE_LANES * SCAN_EDGE_LANES
        n_pre = base + SCAN_EDGE_LANES - start - 1   # the tuner ends it
        target = _LOG_T_EPS - sign * SCAN_EDGE_MARGIN - k * lom_b
        # Faint records to some 0.1 short of the target, the tuner the rest.
        wp = int(round((1.0 - np.exp((target + 0.1) / n_pre)) / 0.946
                       * 65535.0))
        lom_p = np.float64(_lom_f32(wp, off, 0.0, inv, inv))
        want = target - n_pre * lom_p       # the tuner's log1p(-alpha)
        wt = 13107                          # opacity 0.2
        dx = np.sqrt(2.0 * np.log(wt / 65535.0 / -np.expm1(want)) / inv)
        for _ in range(4):   # Newton on the float32 value, in float64
            got = np.float64(_lom_f32(wt, f(px + dx) - f(px), 0.0, inv,
                                      inv))
            h = 1e-4
            slope = (np.float64(_lom_f32(wt, dx + h, 0.0, inv, inv))
                     - np.float64(_lom_f32(wt, dx - h, 0.0, inv, inv))) / (
                         2 * h)
            dx -= (got - want) / slope
        n_bulk, n_tail = k + 20, 40
        count = n_pre + 1 + n_bulk + n_tail
        x = np.concatenate([np.full(n_pre, px + 0.1), [px + dx],
                            np.full(n_bulk, px + 0.1),
                            rng.uniform(16.0 * tile, 16.0 * tile + 16, n_tail)])
        y = np.concatenate([np.full(n_pre + 1 + n_bulk, py),
                            rng.uniform(0.0, 16.0, n_tail)])
        o = np.concatenate([np.full(n_pre, wp), [wt], np.full(n_bulk, wb),
                            np.round(rng.uniform(0.01, 0.05, n_tail)
                                     * 65535.0)])
        conic = np.concatenate([np.full(n_pre + 1 + n_bulk, inv),
                                np.full(n_tail, 1.0 / 16.0)])
        tiles.append(dict(x=x, y=y, cxx=conic, cxy=np.zeros(count),
                          cyy=conic, rgb=rng.integers(30300, 45050,
                                                      (3, count)), o=o))
        start += count
    n = SCAN_EDGE_DEEP
    tiles.append(dict(x=np.full(n, 40.3), y=np.full(n, 7.8),
                      cxx=np.full(n, 1.0 / 36.0), cxy=np.zeros(n),
                      cyy=np.full(n, 1.0 / 36.0),
                      rgb=np.repeat(rng.integers(30300, 45050, (3, 1)), n,
                                    axis=1),
                      o=np.full(n, np.round(0.014 * 65535.0))))
    packed, starts, ends = _pack(tiles)
    return packed, starts, ends, 3


def _pack(cells, pool=None):
    """Records given cell by cell (dicts of x, y, cxx, cxy, cyy, rgb (3,
    count) u16 words, o u16 words) as (packed (8, pool) int32, starts,
    ends): the records in order, splat ids 0, 1, .. in row 7; pool defaults
    to the records rounded up to 256, plus 256."""
    counts = np.array([len(rec["x"]) for rec in cells])
    ends = np.cumsum(counts)
    total = int(ends[-1])
    if pool is None:
        pool = -(-total // 256) * 256 + 256
    assert total <= pool
    packed = np.zeros((8, pool), np.uint32)
    for row, key in enumerate(("x", "y", "cxx", "cxy", "cyy")):
        packed[row, :total] = np.concatenate(
            [rec[key] for rec in cells]).astype(np.float32).view(np.uint32)
    rgb = np.concatenate([rec["rgb"] for rec in cells], axis=1).astype(
        np.uint32)
    o = np.concatenate([rec["o"] for rec in cells]).astype(np.uint32)
    packed[5, :total] = rgb[0] | (rgb[1] << 16)
    packed[6, :total] = rgb[2] | (o << 16)
    packed[7, :total] = np.arange(total)
    return (packed.view(np.int32), (ends - counts).astype(np.int32),
            ends.astype(np.int32))


HAND_EXPAND_CASES = ("bbox_span", "zero_owners", "zero_run", "full_mask",
                     "high_word", "total_pool", "total_zero", "n_zero",
                     "block_start", "ragged")
# The cases the Pallas kernel takes: a pool of whole 512-slot blocks, each
# block's owners inside its window (at most 512 + 128: counts >= 1 but for
# a few), and n > 0 (brush_tpu's build_comp_rows cannot stack zero
# splats). "zero_run" puts 2600 owners of count 0 inside one block,
# "ragged" has pool % 4 != 0, "n_zero" no splat.
HAND_EXPAND_PALLAS = tuple(c for c in HAND_EXPAND_CASES
                           if c not in ("zero_run", "ragged", "n_zero"))
HAND_EXPAND_GRID = (64, 48)   # tiles_x, tiles_y


def hand_expand(case):
    """Expand arguments made by hand, which the scenes do not reach:
    (f5 (5, n) float32, u5 (5, n) int32, cum (n,) int32, total (1,) int32,
    tiles_x, num_tiles, pool) as numpy arrays and ints, on a 64 x 48 tile
    grid. Splats lie in depth order; a small splat (bbox <= 8x8 tiles) has
    a 64-bit mask of its tiles on the fixed 8x8 layout, a bbox splat its
    bbox (mask_lo = its height); a splat of count 0 is a small one with an
    empty mask. Positions and conics are random float32 with some -0.0
    and +0.0 (written as +0.0), the colour words random u32.
      bbox_span: a 60 x 45 bbox splat (2700 slots) among small ones, its
        slots spanning three 1024-slot blocks of the kernel;
      zero_owners: owners of count 0 inside the live range, alone and in
        runs of up to 8;
      zero_run: 2600 owners of count 0 in a run inside one block (more
        than two of the kernel's 1024-owner windows);
      full_mask: masks with all 64 bits set (ranks 0-63) and masks of bit
        63 alone;
      high_word: masks with at most two bits in the low word and many in
        the high one (most ranks in the high word);
      total_pool: the records fill the pool exactly (total == pool ==
        cum[-1]);
      total_zero: records in cum but `total` 0: every slot a sentinel;
      n_zero: no splat at all (n 0, total 0);
      block_start: owners of 8 slots each (small and bbox splats in turn),
        so owners start exactly at every 512- and 1024-slot block start;
      ragged: a pool of 3001 slots (pool % 4 == 1), the records short of
        it."""
    rng = np.random.default_rng(HAND_EXPAND_CASES.index(case) + 53)
    tiles_x, tiles_y = HAND_EXPAND_GRID
    rows = []   # (d0, mask_lo, mask_hi, count) a splat

    def small(mask):
        tx = int(rng.integers(0, tiles_x - 7))
        ty = int(rng.integers(0, tiles_y - 7))
        d0 = tx | 1 << 10 | ty << 11 | int(rng.integers(1, 9)) << 22
        rows.append((d0, mask & 0xFFFFFFFF, mask >> 32, bin(mask).count("1")))

    def bits(k):
        return sum(1 << int(b) for b in rng.choice(64, k, replace=False))

    def bbox(bw, bh):
        tx = int(rng.integers(0, tiles_x - bw + 1))
        ty = int(rng.integers(0, tiles_y - bh + 1))
        rows.append((tx | ty << 11 | bw << 22, bh, 0, bw * bh))

    def smalls(count, lo=1, hi=12):
        for _ in range(count):
            small(bits(int(rng.integers(lo, hi + 1))))

    pool, total = None, None
    if case == "bbox_span":
        smalls(150)
        bbox(60, 45)
        smalls(150)
        bbox(12, 9)
        pool = 5120
    elif case == "zero_owners":
        for _ in range(700):
            if rng.random() < 0.15:
                for _ in range(int(rng.integers(1, 9))):
                    small(0)
            else:
                smalls(1, 1, 10)
        pool = 4608
    elif case == "zero_run":
        smalls(150)
        for _ in range(2600):
            small(0)
        smalls(150)
        pool = 2560
    elif case == "full_mask":
        for i in range(90):
            small((1 << 64) - 1 if i % 3 else 1 << 63)
        pool = 4096
    elif case == "high_word":
        for _ in range(300):
            lo = sum(1 << int(b) for b in rng.choice(
                32, int(rng.integers(0, 3)), replace=False))
            hi = sum(1 << (32 + int(b)) for b in rng.choice(
                32, int(rng.integers(1, 16)), replace=False))
            small(lo | hi)
        pool = 3072
    elif case == "total_pool":
        pool = 4096
        while not rows or rows[-1][3] == 0 or sum(r[3] for r in rows) < pool:
            left = pool - sum(r[3] for r in rows)
            small(bits(int(min(left, rng.integers(1, 12)))))
        small(0)
    elif case == "total_zero":
        smalls(300)
        pool, total = 3072, 0
    elif case == "n_zero":
        pool = 512
    elif case == "block_start":
        for i in range(448):
            if i % 2:
                bbox(4, 2)
            else:
                small(bits(8))
        pool = 4096
    else:   # ragged
        smalls(400)
        pool = 3001
    n = len(rows)
    meta = np.array(rows, np.int64).reshape(n, 4).T
    cum = np.cumsum(meta[3]).astype(np.int32)
    if total is None:
        total = min(int(cum[-1]), pool) if n else 0
    f5 = rng.normal(0.0, 40.0, (5, n)).astype(np.float32)
    f5[rng.random((5, n)) < 0.05] = -0.0
    f5[rng.random((5, n)) < 0.05] = 0.0
    u5 = np.stack([rng.integers(0, 1 << 32, n, dtype=np.uint64),
                   rng.integers(0, 1 << 32, n, dtype=np.uint64),
                   *meta[:3]]).astype(np.uint32).view(np.int32)
    return (f5, u5, cum, np.array([total], np.int32), tiles_x,
            tiles_x * tiles_y, pool)


HAND_CELL_CASES = ("one_tile", "all_tiles", "corner_pixel", "deep_cell",
                   "pretest_edge", "hyperbolic", "edge_4x2")
HAND_CELL_POOL = 2048   # every (2, 2) layout: one pool, two cells
HAND_EDGE_IMAGE = (80, 48)   # edge_4x2's image: 5 x 3 tiles


def sigma_f32(x, y, cxx, cxy, cyy, px, py):
    """The kernels' sigma in float32, operation by operation as the sweeps
    round it (numpy broadcasting over records and pixel centres)."""
    f = np.float32
    dx = (f(x) - f(px)).astype(f)
    dy = (f(y) - f(py)).astype(f)
    quad = (f(cxx) * dx * dx).astype(f) + (f(cyy) * dy * dy).astype(f)
    return (f(0.5) * quad.astype(f)).astype(f) + (f(cxy) * dx * dy).astype(f)


def sigma_max_f32(o_words):
    """The pretest's bound of each record, as the kernels decode it:
    log(255 o) + 1e-4 in float32 (rasterize_fwd.cu, rasterize_bwd.cu)."""
    o = (np.asarray(o_words, np.float32) * np.float32(1.0 / 65535.0)).astype(
        np.float32)
    with np.errstate(divide="ignore"):
        return (np.log(np.float32(255.0) * o).astype(np.float32)
                + np.float32(1e-4)).astype(np.float32)


def cell_pixel_centres(cell, c, cells_x):
    """Pixel centres (x, y) of cell c, row-major over the cell."""
    gw, gh = cell
    ox, oy = 16 * gw * (c % cells_x), 16 * gh * (c // cells_x)
    yy, xx = np.mgrid[0:16 * gh, 0:16 * gw]
    return (ox + xx.ravel() + 0.5).astype(np.float32), \
        (oy + yy.ravel() + 0.5).astype(np.float32)


def warp_patches(cell, c, cells_x):
    """The rasterize_bwd kernel's warp patches of cell c: a list of
    (x0, y0) corners of 16 x 4 pixel blocks, four a tile, tile by tile."""
    gw, gh = cell
    ox, oy = 16 * gw * (c % cells_x), 16 * gh * (c // cells_x)
    return [(ox + 16 * (sub % gw), oy + 16 * (sub // gw) + 4 * w)
            for sub in range(gw * gh) for w in range(4)]


def fwd_warp_patches(cell, c, cells_x):
    """The rasterize_fwd kernel's warp patches of cell c: a list of
    (x0, y0) corners of 8 x 4 pixel blocks, eight a tile (two to a row),
    tile by tile."""
    gw, gh = cell
    ox, oy = 16 * gw * (c % cells_x), 16 * gh * (c // cells_x)
    return [(ox + 16 * (sub % gw) + 8 * (w % 2),
             oy + 16 * (sub // gw) + 4 * (w // 2))
            for sub in range(gw * gh) for w in range(8)]


def may_reach_f32(x, y, cxx, cxy, cyy, sigma_max, xa, xb, ya, yb):
    """csrc/reach.cuh's may_reach in float32, broadcasting over records
    and rectangles (numpy arrays, or float32 torch tensors on one device):
    False only where no pixel centre of [xa, xb] x [ya, yb] can pass the
    pretest sigma <= sigma_max, that is where the conic is positive
    definite, the record's centre lies outside the rectangle and its least
    sigma over the rectangle (on the edges, each a quadratic minimized at
    its clamped vertex) exceeds sigma_max by more than 1e-5 of the terms'
    magnitude. Every operation rounds to float32 as the kernel's do, one
    at a time (nvcc may fuse some into multiply-adds; the margin is some
    170 ulp of the terms)."""
    args = (x, y, cxx, cxy, cyy, sigma_max, xa, xb, ya, yb)
    if isinstance(x, np.ndarray) or np.isscalar(x):
        x, y, cxx, cxy, cyy, smax, xa, xb, ya, yb = (
            np.asarray(a, np.float32) for a in args)
        fmin, fmax = np.fmin, np.fmax   # fminf, fmaxf: NaN-dropping
    else:
        import torch

        smax = sigma_max
        fmin, fmax = torch.fmin, torch.fmax
    with np.errstate(all="ignore"):
        definite = (cxx > 0) & (cyy > 0) & (cxx * cyy - cxy * cxy > 0)
        dxl, dxh, dyl, dyh = x - xb, x - xa, y - yb, y - ya
        outside = (dxl > 0) | (dxh < 0) | (dyl > 0) | (dyh < 0)

        def quad(dx, dy):
            return 0.5 * (cxx * dx * dx + cyy * dy * dy) + cxy * dx * dy

        def clamp(v, lo, hi):
            return fmin(fmax(v, lo), hi)

        least = fmin(
            fmin(quad(clamp(-cxy * dyl / cxx, dxl, dxh), dyl),
                 quad(clamp(-cxy * dyh / cxx, dxl, dxh), dyh)),
            fmin(quad(dxl, clamp(-cxy * dxl / cyy, dyl, dyh)),
                 quad(dxh, clamp(-cxy * dxh / cyy, dyl, dyh))))
        mx = fmax(abs(dxl), abs(dxh))
        my = fmax(abs(dyl), abs(dyh))
        mag = cxx * mx * mx + cyy * my * my + 2.0 * abs(cxy) * mx * my
        far = least > smax + 1e-5 * (mag + 1.0)   # reach.cuh kReachMargin
    return ~(definite & outside & far)


# The truncated scan's crossing threshold as the kernels hold it: T is
# compared with exp of the float32 log(TRANSMITTANCE_EPS) (-9.2103405),
# rounded to float32 (csrc/rasterize_fwd.cu kTEpsScan).
T_EPS_SCAN = float.fromhex("0x1.a36e2cp-14")


def fma_f32(a, b, c):
    """fmaf on float32 tensors (or numbers): a b + c rounded once, through
    float64, where a b is exact (where the float64 sum falls on a float32
    tie, the second rounding may differ from fmaf's in the last bit)."""
    import torch

    a, b, c = (torch.as_tensor(v, dtype=torch.float32).double()
               for v in (a, b, c))
    return (a * b + c).float()


def scan_rest_f32(x, passes):
    """csrc/scan.cuh's scan_rest: x less its first `passes` bfloat16 parts,
    exactly."""
    from brush_tpu_torch.ops.cuda.rasterize_fwd import bf16_parts

    return x - bf16_parts(x, passes)


def times_exp_f32(v, r, passes):
    """csrc/scan.cuh's times_exp: v exp(r) for a scan rest r, one fmaf at
    two parts or more, a cubic at one."""
    if passes >= 2:
        return fma_f32(v, r, v)
    sixth = fma_f32(r, 1.0 / 6.0, 0.5)   # 1/6 rounded to float32 first
    return v * fma_f32(r, fma_f32(r, sixth, 1.0), 1.0)


def _twin_records(packed, starts, ends, tiles_x, cell, tile_base, order):
    """What both twins share: the decoded pool rows (float32, as the
    kernels decode them), each cell's pixel centres (C, P) x and y, and
    the pool slot of each cell's record at each step (C, L), -1 past the
    cell's range: in depth order from starts (order 1) or back to front
    from ends (order -1)."""
    import torch

    from brush_tpu_torch.ops.cuda.rasterize_fwd import (
        cell_lanes, unpack_record_rows,
    )

    rows = unpack_record_rows(packed)
    n = starts.shape[0]
    pix = torch.stack([cell_lanes(tiles_x, cell, tile_base + t, packed.device)
                       for t in range(n)]) if n else torch.zeros(0, 0, 2)
    s, e = starts.long(), ends.long()
    steps = int((e - s).clamp(min=0).max()) if n else 0
    i = torch.arange(steps)[None, :]
    slot = s[:, None] + i if order == 1 else e[:, None] - 1 - i
    slot = torch.where((slot >= s[:, None]) & (slot < e[:, None]), slot, -1)
    return rows, pix[..., 0], pix[..., 1], slot


def _twin_alpha(rows, j, px, py):
    """The kernels' pair arithmetic for records j (C,) over pixels (C, P):
    sigma op by op, the pretest (0 <= sigma <= log(255 o) + 1e-4), vis,
    alpha; returns (fields of j, vis, alpha, active) with active the pairs
    that count."""
    import torch

    from brush_tpu_torch.constants import ALPHA_EPS, ALPHA_MAX

    f = [r[j.clamp(min=0)][:, None] for r in rows]
    x, y, cxx, cxy, cyy, _, _, _, o = f
    dx, dy = x - px, y - py
    sigma = 0.5 * (cxx * dx * dx + cyy * dy * dy) + cxy * dx * dy
    smax = torch.log(255.0 * o) + 1e-4
    vis = torch.exp(-sigma)
    alpha = torch.clamp(o * vis, max=ALPHA_MAX)
    active = ((j >= 0)[:, None] & (sigma >= 0.0) & (sigma <= smax)
              & (alpha >= ALPHA_EPS))
    return f, dx, dy, vis, alpha, active


def rasterize_fwd_twin(packed, starts, ends, tiles_x, cell=(1, 1),
                       tile_base=0, passes=2, k_lanes=512):
    """csrc/rasterize_fwd.cu's truncated scan (passes 1 or 2, batches of
    k_lanes slots from each cell's start rounded down to 128) step by step
    on CPU tensors, every pixel of every cell at once, a record a step:
    T carried as a running product t_cur with each record's term cut to
    `passes` bfloat16 parts (T before the record t_cur exp(-rest), after
    it that times 1 - alpha, as fmaf(-alpha, before, before)), the crossing
    test that product against T_EPS_SCAN, t_exact the product of the exact
    terms, which t_cur takes at each scan batch's first slot. (The kernel
    takes it at the warp's first record of the batch that passes the
    pretest; no term of the pixel's moves either product before that.)
    Returns (img (C, P, 4), log_t (C, P), final_idx (C, P)) as
    rasterize_fwd_plain does."""
    import torch

    rows, px, py, slot = _twin_records(packed, starts, ends, tiles_x, cell,
                                       tile_base, 1)
    shape = px.shape
    one = torch.ones(shape)
    t_cur, t_exact = one.clone(), one.clone()
    alive = torch.ones(shape, dtype=torch.bool)
    rgb = [torch.zeros(shape) for _ in range(3)]
    fidx = torch.full(shape, -1, dtype=torch.int64)
    base = (starts.long() // 128 * 128)[:, None]
    for i in range(slot.shape[1]):
        j = slot[:, i]
        first = ((j[:, None] - base) % k_lanes == 0) & (j >= 0)[:, None]
        t_cur = torch.where(first, t_exact, t_cur)
        f, _, _, _, alpha, active = _twin_alpha(rows, j, px, py)
        active &= alive
        rest = scan_rest_f32(torch.log1p(-alpha), passes)
        before = times_exp_f32(t_cur, -rest, passes)
        after = fma_f32(-alpha, before, before)
        cross = active & ~(after > T_EPS_SCAN)
        alive &= ~cross
        ok = active & ~cross
        fac = alpha * before
        rgb = [torch.where(ok, fma_f32(fac, c, acc), acc)
               for c, acc in zip(f[5:8], rgb)]
        t_cur = torch.where(ok, after, t_cur)
        t_exact = torch.where(ok, fma_f32(-alpha, t_exact, t_exact), t_exact)
        fidx = torch.where(ok, j[:, None], fidx)
    img = torch.stack([*rgb, 1.0 - t_exact], dim=-1)
    return img, torch.log(t_exact), fidx.to(torch.int32)


def rasterize_bwd_twin(packed, starts, ends, tiles_x, v_out, log_t, fidx,
                       cell=(1, 1), tile_base=0, passes=2):
    """csrc/rasterize_bwd.cu's truncated scan step by step on CPU tensors,
    every pixel of every cell at once, a record a step back to front from
    min(end, the cell's largest final_idx + 1) - 1: T behind the record
    t_cur starts at exp(log_t); T before it t_cur / (1 - alpha); T in front
    of it that times exp(rest of log1p(-alpha) past its `passes` bfloat16
    parts), one fmaf; the colour behind adds each record's cw fac cut to
    its parts. No scan batch enters: the TPU kernel's batch totals and
    suffix sums add the same cut terms in another order. Returns grads
    (9, pool), each row summed over the record's cell, as
    rasterize_bwd_plain does."""
    import torch

    from brush_tpu_torch.ops.cuda.rasterize_fwd import bf16_parts

    last = torch.minimum(ends.long(), fidx.long().amax(dim=1) + 1)
    rows, px, py, slot = _twin_records(packed, starts, last, tiles_x, cell,
                                       tile_base, -1)
    grads = torch.zeros((9, packed.shape[1]))
    vr, vg, vb, va = v_out.unbind(-1)
    t_cur = torch.exp(log_t)
    tfva = t_cur * va
    s_behind = torch.zeros(px.shape)
    fi = fidx.long()
    for i in range(slot.shape[1]):
        j = slot[:, i]
        f, dx, dy, vis, alpha, active = _twin_alpha(rows, j, px, py)
        active &= j[:, None] <= fi
        _, _, cxx, cxy, cyy, cr, cg, cb, o = f
        ra = 1.0 / (1.0 - alpha)
        cw = cr * vr + cg * vg + cb * vb
        t_before = t_cur * ra
        fac = alpha * t_before
        v_alpha = cw * t_before + ra * (tfva - s_behind)
        s_behind = torch.where(active, s_behind + bf16_parts(
            cw * fac, passes), s_behind)
        t_cur = torch.where(active, times_exp_f32(
            t_before, scan_rest_f32(torch.log1p(-alpha), passes), passes),
            t_cur)
        vs = -o * vis * v_alpha
        vx, vy = vs * dx, vs * dy
        terms = (cxx * vx + cxy * vy, cxy * vx + cyy * vy, 0.5 * vx * dx,
                 vx * dy, 0.5 * vy * dy, fac * vr, fac * vg, fac * vb,
                 vis * v_alpha)
        sums = torch.stack([torch.where(active, g, 0.0).sum(dim=1)
                            for g in terms])
        live = j >= 0
        grads[:, j[live]] = sums[:, live]
    return grads

def hand_cells(case):
    """Backward arguments at raster cells made by hand, which the scenes do
    not reach: (packed (8, pool) int32, starts, ends, cells_x, cell) as
    numpy arrays and ints. Every (2, 2) layout has two cells side by side
    in a pool of HAND_CELL_POOL slots (one shape for the Pallas kernel).
      one_tile: records whose footprint (sigma <= log(255 o)) reaches one
        tile of their cell only, in every tile;
      all_tiles: wide records at the cell's centre, each reaching all four
        tiles;
      corner_pixel: among faint wide records, one record at each corner of
        the first cell that reaches its corner pixel and no other (o 1,
        sigma 5.3 there, 8.1 at the next pixel);
      deep_cell: HAND_DEEP faint records in the first cell, more than
        three staging batches of either rasterizer;
      pretest_edge: records outside a warp's 16 x 4 patch whose least
        sigma over the patch's pixel centres lies within 3e-4 (relative)
        of log(255 o), on either side, with anisotropic and rotated
        conics: the per-warp lists must keep every one whose pair can
        pass;
      hyperbolic: every fifth record has an indefinite conic (cxx cyy <
        cxy^2), the rest ordinary;
      edge_4x2: cells of (4, 2) tiles over an 80 x 48 image (5 x 3 tiles,
        which (4, 2) does not divide: the right and bottom cells lie
        partly outside), records in and across the image's edge."""
    rng = np.random.default_rng(HAND_CELL_CASES.index(case) + 71)
    cell = (4, 2) if case == "edge_4x2" else (2, 2)
    gw, gh = cell
    cells_x = 2

    def records(count, x, y, radius, opac, aniso=0.3):
        inv = 1.0 / np.asarray(radius, np.float64) ** 2
        return dict(
            x=np.asarray(x, np.float64), y=np.asarray(y, np.float64),
            cxx=inv * np.ones(count),
            cxy=inv * rng.uniform(-aniso, aniso, count),
            cyy=inv * rng.uniform(1.0 - aniso, 1.0 + aniso, count),
            rgb=rng.integers(30300, 45050, (3, count)),
            o=np.round(np.asarray(opac, np.float64) * 65535.0))

    def spread(c, count, opac_lo, opac_hi, radius_lo, radius_hi):
        ox, oy = 16 * gw * (c % cells_x), 16 * gh * (c // cells_x)
        return records(count, ox + rng.uniform(0, 16 * gw, count),
                       oy + rng.uniform(0, 16 * gh, count),
                       rng.uniform(radius_lo, radius_hi, count),
                       rng.uniform(opac_lo, opac_hi, count))

    def join(parts):
        return {k: np.concatenate([p[k] for p in parts], axis=-1)
                for k in parts[0]}

    cells = []
    if case == "one_tile":
        for c in range(2):
            sub = rng.integers(0, 4, 160)
            ox = 32 * c + 16 * (sub % 2) + rng.uniform(5.0, 11.0, 160)
            oy = 16 * (sub // 2) + rng.uniform(5.0, 11.0, 160)
            cells.append(records(160, ox, oy, rng.uniform(0.5, 0.9, 160),
                                 rng.uniform(0.3, 0.9, 160), aniso=0.2))
    elif case == "all_tiles":
        for c in range(2):
            cells.append(records(
                120, 32 * c + 16 + rng.uniform(-3, 3, 120),
                16 + rng.uniform(-3, 3, 120), rng.uniform(6.0, 12.0, 120),
                rng.uniform(0.02, 0.3, 120)))
    elif case == "corner_pixel":
        back = spread(0, 100, 0.01, 0.05, 6.0, 12.0)
        a = np.sqrt(5.3)   # 0.5 (a^2 + a^2) = 5.3 at the corner pixel
        corners = dict(
            x=np.array([0.5 - a, 31.5 + a, 0.5 - a, 31.5 + a]),
            y=np.array([0.5 - a, 0.5 - a, 31.5 + a, 31.5 + a]),
            cxx=np.ones(4), cxy=np.zeros(4), cyy=np.ones(4),
            rgb=rng.integers(30300, 45050, (3, 4)),
            o=np.full(4, 65535.0))
        parts = []
        for i, at in enumerate((10, 40, 70, 95)):   # depth places
            prev = (0, 10, 40, 70)[i]
            parts.append({k: v[..., prev:at] for k, v in back.items()})
            parts.append({k: v[..., i:i + 1] for k, v in corners.items()})
        parts.append({k: v[..., 95:] for k, v in back.items()})
        cells = [join(parts), spread(1, 60, 0.02, 0.3, 2.0, 6.0)]
    elif case == "deep_cell":
        cells = [spread(0, HAND_DEEP, 0.005, 0.015, 3.0, 8.0),
                 spread(1, 130, 0.008, 0.03, 3.0, 8.0)]
    elif case == "pretest_edge":
        for c in range(2):
            count = 96
            patches = warp_patches(cell, c, cells_x)
            pick = rng.integers(0, len(patches), count)
            o = np.round(rng.uniform(0.05, 1.0, count) * 65535.0)
            rec = dict(x=np.zeros(count), y=np.zeros(count),
                       cxx=np.zeros(count), cxy=np.zeros(count),
                       cyy=np.zeros(count),
                       rgb=rng.integers(30300, 45050, (3, count)), o=o)
            target = np.log(255.0 * (o / 65535.0)) * (
                1.0 + rng.uniform(-3e-4, 3e-4, count))
            for i in range(count):
                x0, y0 = patches[pick[i]]
                px, py = np.meshgrid(x0 + 0.5 + np.arange(16),
                                     y0 + 0.5 + np.arange(4))
                # A centre 1-6 pixels outside the patch, on any side.
                side = rng.integers(0, 4)
                gap = rng.uniform(1.0, 6.0)
                along = rng.uniform(-2.0, 18.0)
                cx, cy = [(x0 + along, y0 - gap), (x0 + along, y0 + 4 + gap),
                          (x0 - gap, y0 + rng.uniform(-2, 6)),
                          (x0 + 16 + gap, y0 + rng.uniform(-2, 6))][side]
                cyy = rng.uniform(0.3, 3.0)
                cxy = rng.uniform(-0.8, 0.8) * np.sqrt(cyy)
                d_x, d_y = cx - px, cy - py
                least = (0.5 * (d_x ** 2 + cyy * d_y ** 2)
                         + cxy * d_x * d_y).min()
                k = target[i] / least
                rec["x"][i], rec["y"][i] = cx, cy
                rec["cxx"][i], rec["cxy"][i], rec["cyy"][i] = (
                    k, k * cxy, k * cyy)
            cells.append(join([spread(c, 40, 0.01, 0.05, 4.0, 10.0), rec]))
    elif case == "hyperbolic":
        for c in range(2):
            rec = spread(c, 200, 0.02, 0.5, 1.5, 6.0)
            inv = 1.0 / rng.uniform(2.0, 6.0, 40) ** 2
            rec["cxx"][::5] = inv
            rec["cxy"][::5] = -1.5 * inv
            rec["cyy"][::5] = inv
            cells.append(rec)
    else:   # edge_4x2: 2 x 2 cells over 5 x 3 tiles
        w_img, h_img = HAND_EDGE_IMAGE
        for c in range(4):
            ox, oy = 64 * (c % 2), 32 * (c // 2)
            w = min(64, w_img - ox) + 3.0   # a little past the image edge
            h = min(32, h_img - oy) + 3.0
            cells.append(records(
                90, ox + rng.uniform(-1.0, w, 90),
                oy + rng.uniform(-1.0, h, 90), rng.uniform(1.5, 6.0, 90),
                rng.uniform(0.02, 0.6, 90)))
    pool = HAND_CELL_POOL if cell == (2, 2) else None
    packed, starts, ends = _pack(cells, pool)
    return packed, starts, ends, cells_x, cell


# segment_sum's hand layouts (the kernel's spans: csrc/segsum.cu kSpan).
HAND_LAYOUTS = ["long_segment", "empty_runs", "straddle", "total_zero"]
HAND_POOL = 4096


def hand_segments(case):
    """(offsets, cum, total) int32 numpy for 700 splats (no multiple of a
    256-splat block) of 1-4 slots each in a pool of HAND_POOL, the last 40
    empty. long_segment: one splat of 1101 slots, longer than a 1024-slot
    span; empty_runs: 20 empty splats after every 16; straddle: `total`
    falls one slot into a splat, which keeps that slot, and every later
    splat gets zero; total_zero: no live slot."""
    rng = np.random.default_rng(31)
    counts = rng.integers(1, 5, 700)
    if case == "long_segment":
        counts[300] = 1101
    if case == "empty_runs":
        for i in range(16, 700, 36):
            counts[i:i + 20] = 0
    counts[-40:] = 0
    cum = np.cumsum(counts)
    offsets = cum - counts
    total = int(cum[-1])
    assert total <= HAND_POOL
    if case == "straddle":
        w = 350 + int(np.argmax(counts[350:] >= 3))
        total = int(offsets[w]) + 1
    if case == "total_zero":
        total = 0
    return (offsets.astype(np.int32), cum.astype(np.int32),
            np.array([total], np.int32))


HAND_SMALL_N = 8192       # the CLI's capacity
HAND_SMALL_LIVE = 3000    # splats in front of the camera
HAND_SMALL_POOL = 131072


def hand_small_pool():
    """segment_sum at the CLI's sizes: (offsets, cum, total) int32 numpy
    for HAND_SMALL_N splats in a pool of HAND_SMALL_POOL. The first
    HAND_SMALL_LIVE own 1-40 slots each, one in 20 of them none, every
    200th 2,000-6,000 (over several spans of the kernel, some of them
    wholly), and the rest of the capacity none (padding rows); about
    120,000 live slots, so spans crossed by one splat and spans holding
    dozens."""
    rng = np.random.default_rng(43)
    counts = np.zeros(HAND_SMALL_N, np.int64)
    live = HAND_SMALL_LIVE
    counts[:live] = rng.integers(1, 41, live)
    counts[:live][rng.random(live) < 0.05] = 0
    counts[100:live:200] = rng.integers(2000, 6001, len(range(100, live, 200)))
    cum = np.cumsum(counts)
    total = int(cum[-1])
    assert total <= HAND_SMALL_POOL
    return ((cum - counts).astype(np.int32), cum.astype(np.int32),
            np.array([total], np.int32))


# The tile pretest's hand layouts (csrc/tile_pretest.cu), each laid out
# for raster cells of `cell` tiles.
HAND_PRETEST_CASES = ("edges", "touch", "opacity", "conics", "boxes", "nan",
                      "empty")
HAND_PRETEST_CELLS = ((1, 1), (2, 2), (4, 2))
HAND_TOUCH_ULPS = (-6, -3, -2, -1, 0, 1, 2, 3, 6)   # "touch": conic steps


def _conic(sx, sy, theta):
    """(a, b, c) of a gaussian of standard deviations (sx, sy) px along
    axes turned by theta: the inverse of its 2x2 covariance."""
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    inv = rot @ np.diag([1.0 / sx ** 2, 1.0 / sy ** 2]) @ rot.T
    return inv[0, 0], inv[0, 1], inv[1, 1]


def hand_pretest(case, cell=(1, 1)):
    """Tile-pretest arguments made by hand, which the scenes do not reach:
    a dict of numpy arrays xy (n, 2), conic (n, 3), opac (n,) float32,
    tile_min, tile_max (n, 2) int32 and visible (n,) bool, for raster cells
    of cell = (gw, gh) tiles (W = 16 gw by H = 16 gh pixels).
      edges: centres exactly on cell edges and corners (|dx_c| == ext: the
        centre test's inclusive edge) and at cell centres (dx_c == 0: sign
        0), tiny and wide ellipses, over 4x4-cell bboxes;
      touch: ellipses whose 1/255 level set reaches a neighbouring cell's
        edge or corner up to rounding (the conic HAND_TOUCH_ULPS ulps
        either side too);
      opacity: opacities at float32(1/255), where 255 o rounds to 1 (sig
        0), and one and two ulps either side (sig < 0, sig just above 0);
      conics: a <= 0, c <= 0, hyperbolic (b^2 > ac), parabolic (b^2 == ac)
        and all-zero conics;
      boxes: cell bboxes of 0 x 0, 0 x 5, 5 x 0, 1x1, 8x8, 9x1, 1x9, 8x9,
        9x9 and reversed (max < min), on the cell grid and off it (tile
        bounds inside a cell) and at negative tiles;
      nan: invisible splats with NaN conics (and NaN centres), visible ones
        with NaN or infinite conics;
      empty: no splat.
    """
    gw, gh = cell
    W, H = 16.0 * gw, 16.0 * gh
    rows = []   # (x, y, (a, b, c), opac, (tx0, ty0, tx1, ty1), visible)

    def box(cx0, cy0, bw, bh):
        """The tile bbox of the cell bbox [cx0, cx0 + bw) x [cy0, ...)."""
        return (cx0 * gw, cy0 * gh, (cx0 + bw) * gw, (cy0 + bh) * gh)

    if case == "edges":
        us = (1.0, 1.5, 2.0, 2.5, 3.0)
        shapes = ((0.3, 0.3, 0.0), (W / 4, H / 4, 0.0), (W, H / 3, 0.4),
                  (W / 2, 2 * H, -1.1))
        for k, (u, v) in enumerate((u, v) for u in us for v in us):
            cx0, cy0 = 3 + k % 5, 2 + k // 5
            for sx, sy, th in shapes:
                rows.append(((cx0 + u) * W, (cy0 + v) * H, _conic(sx, sy, th),
                             0.6, box(cx0, cy0, 4, 4), True))
    elif case == "touch":
        ex, ey = W / 2, H / 2
        for k, o in enumerate((0.9, 0.35, 0.05)):
            sig = np.log(np.float32(o) * np.float32(255.0))
            for fa, fc in ((1.0, 1.0), (0.5, 0.5), (1.0, 0.25), (0.25, 1.0)):
                base = np.array([2 * sig * fa / ex ** 2, 0.0,
                                 2 * sig * fc / ey ** 2], np.float32)
                for j, step in enumerate(HAND_TOUCH_ULPS):
                    con = base.copy()
                    for _ in range(abs(step)):
                        con = np.nextafter(con, np.float32(step * np.inf))
                    cx0, cy0 = 2 + 4 * k, 3 + 4 * j
                    rows.append(((cx0 + 1.5) * W, (cy0 + 1.5) * H,
                                 tuple(con), o, box(cx0, cy0, 3, 3), True))
    elif case == "opacity":
        o = np.float32(1 / 255)
        ops = [o]
        for direction in (0.0, 1.0):
            v = o
            for _ in range(2):
                v = np.nextafter(v, np.float32(direction))
                ops.append(v)
        ops += [np.float32(1.01 / 255), np.float32(0.5)]
        for k, op in enumerate(ops):
            for j, (u, v) in enumerate(((1.5, 1.5), (1.0, 1.0), (1.2, 1.7))):
                rows.append(((4 + u) * W, (2 + 3 * k + v) * H,
                             _conic(W / 3, H / 5, 0.3 * j), op,
                             box(4, 2 + 3 * k, 3, 3), True))
    elif case == "conics":
        conics = ((0.0, 0.0, 0.02), (-0.01, 0.0, 0.02), (0.02, 0.0, -0.01),
                  (0.01, 0.05, 0.01), (0.02, -0.03, 0.005),
                  (0.01, 0.01, 0.01), (0.0, 0.0, 0.0), (1e-6, 0.0, 1e-6),
                  (-0.01, 0.02, -0.01), (0.0, 0.02, 0.0))
        for k, con in enumerate(conics):
            for j, (u, v) in enumerate(((2.0, 2.0), (2.5, 1.5), (1.3, 2.9))):
                rows.append(((3 * j + u) * W, (4 * k + v) * H, con, 0.8,
                             box(3 * j, 4 * k, 4, 4), True))
    elif case == "boxes":
        sizes = ((0, 0), (0, 5), (5, 0), (1, 1), (8, 8), (9, 1), (1, 9),
                 (8, 9), (9, 9), (-1, 2), (2, -3))
        for k, (bw, bh) in enumerate(sizes):
            for j, r in enumerate((2.0, 0.7 * W, 3.0 * W)):
                cx0, cy0 = 12 * j, 12 * k
                x = (cx0 + max(bw, 1) / 2.0) * W
                y = (cy0 + max(bh, 1) / 2.0) * H
                con = _conic(r, r * 0.8, 0.5 * k)
                rows.append((x, y, con, 0.9, box(cx0, cy0, bw, bh), True))
                # Off the cell grid: tile bounds inside cells.
                tx0, ty0, tx1, ty1 = box(cx0, cy0, bw, bh)
                rows.append((x, y, con, 0.9, (tx0 + gw // 2, ty0 + gh - 1,
                                              tx1 + gw - 1, ty1 + gh // 2),
                             True))
        for tx0, ty0 in ((-3, -1), (-1, -5), (-gw, 0)):
            rows.append((tx0 * 16.0 + 5.0, ty0 * 16.0 + 7.0,
                         _conic(12.0, 9.0, 0.2), 0.7,
                         (tx0, ty0, tx0 + 3 * gw, ty0 + 2 * gh), True))
    elif case == "nan":
        nan, inf = np.nan, np.inf
        for k in range(6):
            b = box(2 + 3 * k, 2, 2, 2) if k % 3 else (0, 0, 0, 0)
            rows.append((nan, nan, (nan, nan, nan), 0.5, b, False))
            rows.append(((3 + 3 * k) * W, 3 * H, (nan, nan, nan), 0.5,
                         box(2 + 3 * k, 2, 2, 2), False))
        for k, con in enumerate(((nan, nan, nan), (nan, 0.0, 0.01),
                                 (inf, 0.0, inf), (0.01, -inf, 0.01))):
            for j, (u, v) in enumerate(((1.5, 1.5), (1.0, 2.0))):
                rows.append(((3 * k + u) * W, (2 + 3 * j + v) * H, con, 0.5,
                             box(3 * k, 2 + 3 * j, 3, 3), True))
    elif case != "empty":
        raise ValueError(f"unknown case {case}")

    n = len(rows)
    return {
        "xy": np.array([(r[0], r[1]) for r in rows], np.float32).reshape(
            n, 2),
        "conic": np.array([r[2] for r in rows], np.float32).reshape(n, 3),
        "opac": np.array([r[3] for r in rows], np.float32).reshape(n),
        "tile_min": np.array([r[4][:2] for r in rows], np.int32).reshape(
            n, 2),
        "tile_max": np.array([r[4][2:] for r in rows], np.int32).reshape(
            n, 2),
        "visible": np.array([r[5] for r in rows], bool).reshape(n),
    }


HAND_PROJECTION_CASES = ("thin", "behind", "det_zero", "inactive",
                         "off_frame", "quat_norms", "culled_xy")
HAND_PROJECTION_ROWS = 300   # two blocks of the kernels and a ragged one
HAND_PROJECTION_SPECIAL = 60   # each case's hand-made rows, first


def _det_zero_quat():
    """A quaternion (w, 0, 0, z) near a 45-degree turn about z whose
    normalised R00 = 1 - 2 z z and R10 = 2 w z are one float32 (float32
    arithmetic, op by op): a splat with one huge axis along it, seen from
    the origin along z, has c00 == c01 == c11, so det == 0."""
    w0 = np.float32(np.cos(np.pi / 8)).view(np.int32)
    z0 = np.float32(np.sin(np.pi / 8)).view(np.int32)
    for dw, dz in ((i, j) for i in range(-16, 17) for j in range(-16, 17)):
        w = np.int32(w0 + dw).view(np.float32)
        z = np.int32(z0 + dz).view(np.float32)
        norm = np.sqrt(w * w + z * z)
        wn, zn = w / norm, z / norm
        if np.float32(1) - np.float32(2) * (zn * zn) == np.float32(2) * (
                wn * zn):
            return np.array([w, 0, 0, z], np.float32)
    raise AssertionError("no quaternion found")


def hand_projection(case):
    """Projection arguments made by hand, which the scenes do not reach: a
    dict of numpy arrays means, log_scales (n, 3), quats (n, 4) raw,
    active (n,) bool or None, the gradients g_xy (n, 2) and g_conic (n, 3)
    (normal, a few zeros of both signs), the camera's viewmat (4, 4),
    focal and pixel_center (2,) float32, img_size, and `special`: the
    indices of the rows made for the case. HAND_PROJECTION_ROWS rows:
    HAND_PROJECTION_SPECIAL hand-made, the rest a random draw in front of
    the camera.
      thin: near-singular splats, two log scales at -12 (the projected
        covariance cancels in float32);
      behind: rows behind the near plane, a few just either side of it;
      det_zero: one huge axis along _det_zero_quat() at (0, 0, z) seen
        from the origin with fx == fy: the 2D det is exactly 0;
      inactive: `active` given, a third of the rows False;
      off_frame: centres beyond the frustum clamp (1.3x the half field of
        view) and bboxes just off the frame's edges;
      quat_norms: raw norms from 0 and 1e-13 (under the 1e-12 clamp) to
        1e6, signs mixed;
      culled_xy: every special row culled (behind or inactive) with a
        large xy gradient."""
    from brush_tpu_torch.camera import Camera

    rng = np.random.default_rng(1000)
    n, k = HAND_PROJECTION_ROWS, HAND_PROJECTION_SPECIAL
    img_size = (64, 48)
    cam = Camera(position=[0.3, -0.2, -6.0],
                 rotation=np.array([0.99, 0.05, -0.08, 0.03])
                 / np.linalg.norm([0.99, 0.05, -0.08, 0.03]),
                 fov_x=1.4, fov_y=1.2)
    means = rng.uniform(-2.5, 2.5, (n, 3))
    log_scales = np.log(rng.uniform(0.02, 0.6, (n, 3)))
    quats = rng.normal(size=(n, 4))
    active = None
    g_xy, g_conic = rng.normal(size=(n, 2)), rng.normal(size=(n, 3))
    sp = slice(0, k)
    if case == "thin":
        log_scales[sp, 1:] = -12.0
        log_scales[:k // 2, 0] = rng.uniform(-1.0, 1.5, k // 2)
    elif case in ("behind", "culled_xy"):
        # View depth is about world z + 6: depths from -4 to 0.02.
        means[sp, 2] = rng.uniform(-10.0, -5.98, k)
        if case == "behind":
            # On the camera's axis at view depths about the near plane.
            vm = cam.world_to_local()
            depths = np.array([0.0, 0.005, 0.009, 0.0099, 0.0101, 0.011,
                               0.015, 0.02])
            means[:8] = np.linalg.solve(vm[:3, :3], np.stack(
                [np.zeros(8), np.zeros(8), depths]) - vm[:3, 3:]).T
        else:
            means[:k // 2, 2] = rng.uniform(-10.0, -6.5, k // 2)
            active = np.ones(n, bool)
            active[k // 2:k] = False
            means[k // 2:k, 2] = rng.uniform(-2.0, 2.0, k - k // 2)
            g_xy[sp] *= 1e3
    elif case == "det_zero":
        img_size = (64, 64)
        cam = Camera(position=[0.0, 0.0, 0.0], rotation=[1.0, 0.0, 0.0, 0.0],
                     fov_x=1.2, fov_y=1.2)
        means[:, 2] += 7.0
        means[sp] = 0.0
        means[sp, 2] = rng.uniform(3.0, 8.0, k)
        quats[sp] = _det_zero_quat()
        log_scales[sp] = [7.5, -30.0, -30.0]
        log_scales[sp, 0] += rng.uniform(0.0, 1.0, k)
    elif case == "inactive":
        active = rng.uniform(size=n) > 1.0 / 3.0
    elif case == "off_frame":
        # View-space x / z from -3 to 3 (the clamp is near +-0.93), and
        # centres a bbox's width past each edge.
        means[sp, 0] = rng.uniform(-3.0, 3.0, k) * 6.0
        means[:k // 2, 1] = rng.choice([-1.0, 1.0], k // 2) * 4.4
    elif case == "quat_norms":
        norms = np.array([0.0, 1e-13, 1e-12, 1e-6, 1e-3, 0.5, 1.0, 3.0,
                          1e3, 1e6])
        quats[sp] *= (np.resize(norms, k) / np.linalg.norm(
            quats[sp], axis=1))[:, None]
        quats[sp] *= rng.choice([-1.0, 1.0], (k, 4))
    else:
        raise ValueError(f"unknown case {case}")
    g_xy[::23] = 0.0
    g_conic[1::19, 1] = -0.0
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    return {"means": f32(means), "log_scales": f32(log_scales),
            "quats": f32(quats), "active": active,
            "g_xy": f32(g_xy), "g_conic": f32(g_conic),
            "viewmat": f32(cam.world_to_local()),
            "focal": f32(cam.focal(img_size)),
            "pixel_center": f32(cam.center(img_size)),
            "img_size": img_size, "special": np.arange(k)}
