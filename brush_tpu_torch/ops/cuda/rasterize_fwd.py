"""Forward tile rasterizer over the packed record pool, and the pool layout.

Replaces brush_tpu/ops/pallas/rasterize_fwd.py (rasterize_fwd_pallas,
:500), its tile mode and its raster-cell mode (cell=(gw, gh): records per
(splat, cell of gw x gh tiles), P = 256 gw gh pixels a cell, row-major
over the cell). The CUDA kernel is brush_tpu_torch/csrc/rasterize_fwd.cu
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
  row  7:   compact splat id (read only by the backward; zero in inference).
Colour quantizes over [COLOR_LO, COLOR_HI] (step ~1.2e-4) and opacity over
[0, 1] (step 1.5e-5). torch.round, like jnp.round, rounds half to even.
"""

from __future__ import annotations

import ctypes
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

# Launches of the CUDA kernel (not of the plain version) in this process.
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


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
    """The pixel centres (P, 2) of cell c, row-major over the whole cell:
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


def rasterize_fwd_plain(packed, starts, ends, tiles_x: int, cell=(1, 1),
                        count_pairs: bool = False):
    """PyTorch version of csrc/rasterize_fwd.cu: one cell at a time, each
    cell's records in chunks of (P pixels x PLAIN_CHUNK) block math — the
    transmittance is exp of a cumsum of log1p(-alpha), and the early-out
    stays set once crossed, so the result is the kernel's sequential loop
    up to float32 summation order.

    cell=(gw, gh): starts/ends index raster cells of gw x gh tiles,
    tiles_x is the number of cells a row, and a cell has P = 256 gw gh
    pixels (cell_lanes gives their order). Returns (img (C, P, 4), log_t
    (C, P), final_idx (C, P)); with count_pairs also (pairs, active): the
    (pixel, record) pairs the sequential loop evaluates (each live pixel's
    records up to its crossing one), and those of them whose alpha reaches
    ALPHA_EPS.
    """
    dev = packed.device
    n_cells = starts.shape[0]
    p = cell_pixels(cell)
    img = torch.zeros((n_cells, p, 4), dtype=torch.float32, device=dev)
    log_t_out = torch.zeros((n_cells, p), dtype=torch.float32, device=dev)
    fidx_out = torch.full((n_cells, p), -1, dtype=torch.int32, device=dev)
    pairs = active = 0
    for t, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        if e <= s:
            continue
        pix = cell_lanes(tiles_x, cell, t, dev)
        log_t = torch.zeros(p, dtype=torch.float32, device=dev)
        rgb = torch.zeros((p, 3), dtype=torch.float32, device=dev)
        alive = torch.ones(p, dtype=torch.bool, device=dev)
        fidx = torch.full((p,), -1, dtype=torch.int64, device=dev)
        for b in range(s, e, PLAIN_CHUNK):
            be = min(b + PLAIN_CHUNK, e)
            x, y, cxx, cxy, cyy, cr, cg, cb, o = unpack_record_rows(
                packed[:, b:be])
            alpha = alpha_terms(pix, SplatBlock(
                xy=torch.stack([x, y], dim=1),
                conic=torch.stack([cxx, cxy, cyy], dim=1), color=None,
                opac=o, valid=True))
            ok = alpha > 0.0
            lom = torch.log1p(-alpha)
            after = log_t[:, None] + torch.cumsum(lom, dim=1)
            before = after - lom
            act = alive[:, None] & (after > LOG_T_EPS)
            if count_pairs:
                seen = alive[:, None] & (before > LOG_T_EPS)
                pairs += int(seen.sum())
                active += int((seen & ok).sum())
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
    if count_pairs:
        return img, log_t_out, fidx_out, (pairs, active)
    return img, log_t_out, fidx_out


def check_cell(cell) -> tuple:
    """cell as a tuple of two positive ints; raises on anything else."""
    gw, gh = (int(v) for v in cell)
    if gw < 1 or gh < 1 or (gw, gh) != tuple(cell):
        raise ValueError(f"cell must be two positive ints, got {cell!r}")
    return gw, gh


def _check_inputs(packed, starts, ends):
    if packed.dtype != torch.int32 or packed.dim() != 2 \
            or packed.shape[0] != PACK_ROWS:
        raise ValueError(f"packed must be ({PACK_ROWS}, pool) int32, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    for name, t in (("starts", starts), ("ends", ends)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be (C,) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if starts.shape != ends.shape:
        raise ValueError("starts and ends differ in shape")
    devs = {t.device for t in (packed, starts, ends)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def rasterize_fwd(packed, starts, ends, tiles_x: int, cell=(1, 1)):
    """Rasterize on the inputs' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Cell c covers records
    [starts[c], ends[c]) of `packed`; cell=(gw, gh) makes each a raster
    cell of gw x gh tiles, tiles_x then counting cells (a cell of (1, 1) is
    a tile). Returns (img (C, P, 4), log_t (C, P), final_idx (C, P)),
    P = 256 gw gh."""
    _check_inputs(packed, starts, ends)
    gw, gh = check_cell(cell)
    if packed.device.type == "cpu":
        return rasterize_fwd_plain(packed, starts, ends, tiles_x, (gw, gh))
    if packed.device.type != "cuda":
        raise ValueError(f"rasterize_fwd: unsupported device {packed.device}")
    global launches
    packed, starts, ends = (t.contiguous() for t in (packed, starts, ends))
    n_cells = starts.shape[0]
    p = cell_pixels((gw, gh))
    dev = packed.device
    img = torch.empty((n_cells, p, 4), dtype=torch.float32, device=dev)
    log_t = torch.empty((n_cells, p), dtype=torch.float32, device=dev)
    fidx = torch.empty((n_cells, p), dtype=torch.int32, device=dev)
    # Scratch for the kernel's own cell order (heaviest cells start first).
    order = torch.empty_like(starts)
    lib = build.load("rasterize_fwd")
    fn = lib.rasterize_fwd_launch
    fn.argtypes = [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P]
    fn.restype = _I
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(packed.data_ptr(), packed.shape[1], starts.data_ptr(),
                ends.data_ptr(), n_cells, tiles_x, gw, gh, img.data_ptr(),
                log_t.data_ptr(), fidx.data_ptr(), order.data_ptr(), stream)
    build.check(rc, "rasterize_fwd")
    launches += 1
    return img, log_t, fidx
