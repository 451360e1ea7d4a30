"""Forward tile rasterizer over the packed record pool, and the pool layout.

Replaces brush_tpu/ops/pallas/rasterize_fwd.py (rasterize_fwd_pallas,
:500), its tile mode, its raster-cell mode (cell=(gw, gh): records per
(splat, cell of gw x gh tiles), P = 256 gw gh pixels a cell, row-major
over the cell) and its strip mode (tile_base: the cells are the run of the
image's cells from tile_base, the only form of `tile_ids` the JAX package
passes). The CUDA kernel is brush_tpu_torch/csrc/rasterize_fwd.cu
(one block per 16x16 tile of a cell, heavy cells first, one pixel a
thread, eight records a step behind a sigma pretest, T as a running
product, records staged by cp.async; its header gives the design and the
bound).
`rasterize_fwd_plain` below is the same function in PyTorch: CPU tensors
take it, and tests and chip_smoke.py hold the kernel to it.

The packed pool is (8, pool) int32 holding u32 bit patterns:
  rows 0-4: x, y, cxx, cxy, cyy as bitcast float32;
  row  5:   colour r | g << 16 as u16 fixed point (quantize_color);
  row  6:   colour b | opacity << 16 (quantize_opac);
  row  7:   splat id, read only by the backward: the record pipeline's
            compact id, pack_isect_splats' global id.
Colour quantizes over [COLOR_LO, COLOR_HI] (step ~1.2e-4) and opacity over
[0, 1] (step 1.5e-5). torch.round, like jnp.round, rounds half to even.
"""

from __future__ import annotations

import math

import torch

from brush_tpu_torch.constants import TILE_SIZE, TILE_WIDTH, TRANSMITTANCE_EPS
from brush_tpu_torch.ops.compositing import SplatBlock, alpha_terms
from brush_tpu_torch.ops.cuda import build

LOG_T_EPS = math.log(TRANSMITTANCE_EPS)
PACK_ROWS = 8

COLOR_LO = -4.0
COLOR_HI = 4.0
COLOR_SCALE = 65535.0 / (COLOR_HI - COLOR_LO)
OPAC_SCALE = 65535.0
PLAIN_CHUNK = 1024  # records per block step of the plain rasterizer
LANE_ALIGN = 128   # the TPU kernels' batches start on this slot boundary
K_LANES = 512      # the TPU kernels' default batch (rasterize_fwd.py:503)
SIGMA_MARGIN = 1e-4  # the kernels' pretest: sigma <= log(255 o) + this


def to_i32_bits(v: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> the same bit patterns as int32."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def quantize_color(c: torch.Tensor) -> torch.Tensor:
    """float32 colour -> u16 value (int32)."""
    q = torch.round((torch.clamp(c, COLOR_LO, COLOR_HI) - COLOR_LO)
                    * COLOR_SCALE)
    return q.to(torch.int32)


def quantize_opac(o: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(o, 0.0, 1.0) * OPAC_SCALE).to(torch.int32)


def decode_color(q: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * (1.0 / COLOR_SCALE) + COLOR_LO


def decode_opac(q: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * (1.0 / OPAC_SCALE)


def pack_colop(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two u16 values -> one u32 word (lo | hi << 16) as int32 bits."""
    return to_i32_bits(lo.to(torch.int64) | (hi.to(torch.int64) << 16))


def pack_record_rows(xy0, xy1, cxx, cxy, cyy, qr, qg, qb, qo, splat_id):
    """The 8 packed int32 rows from same-shape components: float32
    xy/conic (bitcast), u16 q* from quantize_*, integer splat ids."""
    bc = lambda v: v.contiguous().view(torch.int32)
    return [bc(xy0), bc(xy1), bc(cxx), bc(cxy), bc(cyy),
            pack_colop(qr, qg), pack_colop(qb, qo), splat_id.to(torch.int32)]


def pack_isect_splats(xy, conic, color, opac, isect_gid, max_isects: int,
                      k_lanes: int = 512) -> torch.Tensor:
    """Per-splat attributes gathered into the record order of
    ops/binning.build_intersections, packed: the (PACK_ROWS, max_isects +
    k_lanes) int32 pool of brush_tpu/ops/pallas/rasterize_fwd.py
    (pack_isect_splats, :110-131), bit for bit. xy (n, 2), conic (n, 3),
    color (n, 3), opac (n,) float32; isect_gid (max_isects,) ids in [0, n]
    of any integer dtype; row 7 holds the global id.

    A padding slot carries id n. JAX's gather clamps it, so the slot holds
    splat n - 1's record; torch's raises on an index past the end, so the
    ids are clamped here as JAX does (with n = 0 the slots stay zero, where
    JAX's gather refuses). The k_lanes zero columns are the TPU kernel's
    slack for a batch window near the pool's end; no range reaches them.
    """
    if tuple(isect_gid.shape) != (max_isects,):
        raise ValueError(f"isect_gid must be ({max_isects},), got "
                         f"{tuple(isect_gid.shape)}")
    n = xy.shape[0]
    dev = xy.device
    packed = torch.zeros((PACK_ROWS, max_isects + k_lanes),
                         dtype=torch.int32, device=dev)
    if n == 0:
        return packed
    rows = torch.stack(pack_record_rows(
        xy[:, 0], xy[:, 1], conic[:, 0], conic[:, 1], conic[:, 2],
        quantize_color(color[:, 0]), quantize_color(color[:, 1]),
        quantize_color(color[:, 2]), quantize_opac(opac),
        torch.arange(n, dtype=torch.int32, device=dev)), dim=1)  # (n, 8)
    gid = isect_gid.to(device=dev, dtype=torch.int64).clamp(max=n - 1)
    packed[:, :max_isects] = rows[gid].T
    return packed


def unpack_record_rows(blk: torch.Tensor):
    """(8, K) int32 records -> 9 float32 rows (x, y, conic, rgb, opacity)."""
    f = lambda r: blk[r].contiguous().view(torch.float32)
    c0 = blk[5].to(torch.int64) & 0xFFFFFFFF
    c1 = blk[6].to(torch.int64) & 0xFFFFFFFF
    return (f(0), f(1), f(2), f(3), f(4),
            decode_color(c0 & 0xFFFF), decode_color(c0 >> 16),
            decode_color(c1 & 0xFFFF), decode_opac(c1 >> 16))


def cell_pixels(cell) -> int:
    """P, the pixels of a raster cell of gw x gh tiles."""
    return TILE_SIZE * int(cell[0]) * int(cell[1])


def cell_lanes(cells_x: int, cell, c: int, device):
    """The pixel centres (P, 2) of the image's cell c (its global id),
    row-major over the whole cell:
    pixel k lies at (k % (16 gw), k // (16 gw)) from the cell's corner
    ((c % cells_x) 16 gw, (c // cells_x) 16 gh), as in the TPU kernel
    (rasterize_fwd.py:215-240). At cell (1, 1) a cell is a tile."""
    gw, gh = int(cell[0]), int(cell[1])
    cw, ch = TILE_WIDTH * gw, TILE_WIDTH * gh
    lane = torch.arange(cell_pixels(cell), device=device)
    return torch.stack([
        ((c % cells_x) * cw + lane % cw).to(torch.float32) + 0.5,
        ((c // cells_x) * ch + lane // cw).to(torch.float32) + 0.5,
    ], dim=1)


def bf16_parts(x: torch.Tensor, passes: int) -> torch.Tensor:
    """x (float32) as the sum of its first `passes` bfloat16 parts, each
    rounded to nearest even: c0 = bf16(x), c1 = bf16(x - c0), ... The TPU
    kernels' MXU scan sums these parts (rasterize_fwd.py:153-197,
    _cumsum_lanes_mxu); at 2 each term keeps about 16 mantissa bits. Each
    part lies at least 8 bits below the one before, so their sum is exact
    in float32 and only the prefix sum's order rounds."""
    rem = x
    out = torch.zeros_like(x)
    for _ in range(passes):
        c = rem.to(torch.bfloat16).to(torch.float32)
        rem = rem - c
        out = out + c
    return out


def scan_mode(scan_passes: int, k_lanes: int | None):
    """(passes, k_lanes) as the kernels take them: passes 0 for the exact
    scan, else the bfloat16 parts a term keeps. The TPU kernels truncate
    at fewer than 3 passes over batches of whole 128-lane blocks and take
    the exact scan otherwise (rasterize_fwd.py:171-172); k_lanes None is
    their default 512. Raises on anything but positive ints."""
    k_lanes = K_LANES if k_lanes is None else k_lanes
    if int(scan_passes) != scan_passes or scan_passes < 1:
        raise ValueError(f"scan_passes must be an int >= 1, got "
                         f"{scan_passes!r}")
    if int(k_lanes) != k_lanes or k_lanes < 1:
        raise ValueError(f"k_lanes must be an int >= 1, got {k_lanes!r}")
    trunc = scan_passes < 3 and k_lanes % LANE_ALIGN == 0
    return (int(scan_passes) if trunc else 0), int(k_lanes)


def scan_batches(s: int, e: int, k_lanes: int):
    """The TPU kernels' batches of a cell's range [s, e): k_lanes records
    a batch from the 128-aligned slot at or below s (rasterize_fwd.py:318,
    rasterize_bwd.py:107-110), each cut to [s, e): (lo, hi) in order."""
    base = (s // LANE_ALIGN) * LANE_ALIGN
    return [(max(b, s), min(b + k_lanes, e))
            for b in range(base, e, k_lanes)]


def rasterize_fwd_plain(packed, starts, ends, tiles_x: int, cell=(1, 1),
                        tile_base: int = 0, count_pairs: bool = False,
                        reach=None, scan_passes: int = 3,
                        k_lanes: int | None = None):
    """PyTorch version of csrc/rasterize_fwd.cu: one cell at a time, each
    cell's records in chunks of (P pixels x PLAIN_CHUNK) block math — the
    transmittance is exp of a cumsum of log1p(-alpha), and the early-out
    stays set once crossed, so the result is the kernel's sequential loop
    up to float32 summation order.

    scan_passes < 3 with k_lanes (default 512) a multiple of 128 is the
    TPU kernel's truncated scan (scan_mode): the cell's records go in the
    kernel's batches (scan_batches), and within a batch the crossing test
    and each record's T take the cumsum of bf16_parts(log1p(-alpha),
    scan_passes); log T and the early-out carry from batch to batch by the
    exact terms, as rasterize_fwd.py:437-469 does. Otherwise the scan is
    exact, as at scan_passes=3.

    cell=(gw, gh): starts/ends index raster cells of gw x gh tiles,
    tiles_x is the number of cells a row, and a cell has P = 256 gw gh
    pixels (cell_lanes gives their order). Local cell t is the image's cell
    tile_base + t (a strip of the frame; 0: the whole frame); a cell past
    the image comes with starts == ends. Returns (img (C, P, 4), log_t
    (C, P), final_idx (C, P)); with count_pairs also (pairs, active): the
    (pixel, record) pairs the sequential loop evaluates (each live pixel's
    records up to its crossing one), and those of them whose alpha reaches
    ALPHA_EPS; with count_pairs and `reach` (ops/cuda/testing.may_reach_f32,
    the kernel's cull rule) (pairs, active, reach_pairs): reach_pairs those
    of the pairs whose record `reach` keeps for the pixel's 8x4 warp patch
    of the kernel, the pairs a kernel that culls by that rule evaluates.
    """
    passes, k_lanes = scan_mode(scan_passes, k_lanes)
    dev = packed.device
    n_cells = starts.shape[0]
    p = cell_pixels(cell)
    img = torch.zeros((n_cells, p, 4), dtype=torch.float32, device=dev)
    log_t_out = torch.zeros((n_cells, p), dtype=torch.float32, device=dev)
    fidx_out = torch.full((n_cells, p), -1, dtype=torch.int32, device=dev)
    pairs = active = reach_pairs = 0
    for t, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        if e <= s:
            continue
        pix = cell_lanes(tiles_x, cell, tile_base + t, dev)
        if reach is not None:
            # Each pixel's 8x4 patch (patches lie on multiples of 8 and 4
            # in the image) as the corner centre of its rectangle.
            corner = torch.stack([torch.floor(pix[:, 0] / 8.0) * 8.0,
                                  torch.floor(pix[:, 1] / 4.0) * 4.0], 1)
            patches, patch_of = torch.unique(corner, dim=0,
                                             return_inverse=True)
            pxa, pya = patches[:, 0] + 0.5, patches[:, 1] + 0.5
        log_t = torch.zeros(p, dtype=torch.float32, device=dev)
        rgb = torch.zeros((p, 3), dtype=torch.float32, device=dev)
        alive = torch.ones(p, dtype=torch.bool, device=dev)
        fidx = torch.full((p,), -1, dtype=torch.int64, device=dev)
        chunks = (scan_batches(s, e, k_lanes) if passes else
                  [(b, min(b + PLAIN_CHUNK, e))
                   for b in range(s, e, PLAIN_CHUNK)])
        for b, be in chunks:
            x, y, cxx, cxy, cyy, cr, cg, cb, o = unpack_record_rows(
                packed[:, b:be])
            alpha = alpha_terms(pix, SplatBlock(
                xy=torch.stack([x, y], dim=1),
                conic=torch.stack([cxx, cxy, cyy], dim=1), color=None,
                opac=o, valid=True))
            ok = alpha > 0.0
            lom = torch.log1p(-alpha)
            scanned = bf16_parts(lom, passes) if passes else lom
            after = log_t[:, None] + torch.cumsum(scanned, dim=1)
            before = after - lom
            act = alive[:, None] & (after > LOG_T_EPS)
            if count_pairs:
                seen = alive[:, None] & (before > LOG_T_EPS)
                pairs += int(seen.sum())
                active += int((seen & ok).sum())
                if reach is not None:
                    smax = torch.log(255.0 * o) + SIGMA_MARGIN
                    keep = reach(x[:, None], y[:, None], cxx[:, None],
                                 cxy[:, None], cyy[:, None], smax[:, None],
                                 pxa[None], pxa[None] + 7.0, pya[None],
                                 pya[None] + 3.0)
                    reach_pairs += int((seen & keep[:, patch_of].T).sum())
            fac = alpha * torch.exp(before) * act
            rgb = rgb + fac @ torch.stack([cr, cg, cb], dim=1)
            log_t = log_t + (lom * act).sum(dim=1)
            idx = torch.arange(b, be, device=dev)
            fidx = torch.maximum(fidx, torch.where(
                act & ok, idx[None, :], -1).amax(dim=1))
            alive = alive & (after[:, -1] > LOG_T_EPS)
        img[t, :, :3] = rgb
        img[t, :, 3] = 1.0 - torch.exp(log_t)
        log_t_out[t] = log_t
        fidx_out[t] = fidx.to(torch.int32)
    if count_pairs and reach is not None:
        return img, log_t_out, fidx_out, (pairs, active, reach_pairs)
    if count_pairs:
        return img, log_t_out, fidx_out, (pairs, active)
    return img, log_t_out, fidx_out


def check_cell(cell) -> tuple:
    """cell as a tuple of two positive ints; raises on anything else."""
    gw, gh = (int(v) for v in cell)
    if gw < 1 or gh < 1 or (gw, gh) != tuple(cell):
        raise ValueError(f"cell must be two positive ints, got {cell!r}")
    return gw, gh


def check_tile_base(tile_base) -> int:
    """tile_base as a non-negative int; raises on anything else."""
    if int(tile_base) != tile_base or tile_base < 0:
        raise ValueError(f"tile_base must be an int >= 0, got {tile_base!r}")
    return int(tile_base)


def _check_inputs(packed, starts, ends):
    pool = packed.shape[1] if packed.dim() == 2 else -1
    c = starts.shape[0] if starts.dim() == 1 else -1
    build.check_tensors(("packed", packed, (PACK_ROWS, pool), torch.int32),
                        ("starts", starts, (c,), torch.int32),
                        ("ends", ends, (c,), torch.int32))


def rasterize_fwd(packed, starts, ends, tiles_x: int, cell=(1, 1),
                  tile_base: int = 0, *, scan_passes: int = 3,
                  k_lanes: int | None = None):
    """Rasterize on the inputs' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Cell c covers records
    [starts[c], ends[c]) of `packed`; cell=(gw, gh) makes each a raster
    cell of gw x gh tiles, tiles_x then counting cells (a cell of (1, 1) is
    a tile); cell c lies at the image's cell tile_base + c. Returns (img
    (C, P, 4), log_t (C, P), final_idx (C, P)), P = 256 gw gh.

    scan_passes and k_lanes are the TPU kernel's (rasterize_fwd_plain
    says what they compute). The default 3 is the exact scan; JAX's
    rasterize_fwd_pallas defaults to scan_passes=2 and k_lanes=512, and
    the record pipeline passes the render's own."""
    _check_inputs(packed, starts, ends)
    gw, gh = check_cell(cell)
    tile_base = check_tile_base(tile_base)
    passes, k_lanes = scan_mode(scan_passes, k_lanes)
    if packed.device.type == "cpu":
        return rasterize_fwd_plain(packed, starts, ends, tiles_x, (gw, gh),
                                   tile_base, scan_passes=scan_passes,
                                   k_lanes=k_lanes)
    if packed.device.type != "cuda":
        raise ValueError(f"rasterize_fwd: unsupported device {packed.device}")
    packed, starts, ends = (t.contiguous() for t in (packed, starts, ends))
    n_cells = starts.shape[0]
    p = cell_pixels((gw, gh))
    dev = packed.device
    img = torch.empty((n_cells, p, 4), dtype=torch.float32, device=dev)
    log_t = torch.empty((n_cells, p), dtype=torch.float32, device=dev)
    fidx = torch.empty((n_cells, p), dtype=torch.int32, device=dev)
    # Scratch for the kernel's own cell order (heaviest cells start first).
    order = torch.empty_like(starts)
    build.launch("rasterize_fwd_launch", dev, packed.data_ptr(),
                 packed.shape[1], starts.data_ptr(), ends.data_ptr(), n_cells,
                 tile_base, tiles_x, gw, gh, passes, k_lanes, img.data_ptr(),
                 log_t.data_ptr(), fidx.data_ptr(), order.data_ptr())
    return img, log_t, fidx


def kernel_attrs() -> dict:
    """What nvcc made of each instantiation of the CUDA kernel, read on the
    card (cudaFuncGetAttributes): {(cells, passes): (registers a thread,
    local memory a thread in bytes, blocks an SM can hold)}; cells False
    is the tile kernel, passes 0 the exact scan."""
    return {(cells, passes): build.read_attrs("rasterize_fwd_attrs",
                                              int(cells), passes)
            for cells in (False, True) for passes in (0, 1, 2)}
