"""Kernel arguments made by hand, which the scenes do not reach.

chip_smoke.py and the tests (tests/test_torch_kernels.py against the Pallas
kernels, tests/test_torch_cuda.py on the card) hold rasterize_fwd and
rasterize_bwd to their plain versions on these tile layouts
(`hand_tiles`), and expand on these splat layouts (`hand_expand`).
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
    counts = np.array([len(rec["x"]) for rec in tiles])
    ends = np.cumsum(counts)
    total = int(ends[-1])
    pool = -(-total // 256) * 256 + 256
    packed = np.zeros((8, pool), np.uint32)
    for row, key in enumerate(("x", "y", "cxx", "cxy", "cyy")):
        packed[row, :total] = np.concatenate(
            [rec[key] for rec in tiles]).astype(np.float32).view(np.uint32)
    rgb = np.concatenate([rec["rgb"] for rec in tiles], axis=1).astype(
        np.uint32)
    o = np.concatenate([rec["o"] for rec in tiles]).astype(np.uint32)
    packed[5, :total] = rgb[0] | (rgb[1] << 16)
    packed[6, :total] = rgb[2] | (o << 16)
    packed[7, :total] = np.arange(total)
    return (packed.view(np.int32), (ends - counts).astype(np.int32),
            ends.astype(np.int32), tiles_x)


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
