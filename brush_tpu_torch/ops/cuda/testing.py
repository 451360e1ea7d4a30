"""Rasterizer arguments made by hand, which the scenes do not reach.

chip_smoke.py and the tests (tests/test_torch_kernels.py against the Pallas
kernel, tests/test_torch_cuda.py on the card) hold rasterize_fwd and
rasterize_bwd to their plain versions on these tile layouts.
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
