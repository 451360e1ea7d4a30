"""Exact per-tile pretest: each splat's tile coverage as a 64-bit mask.

Port of brush_tpu/ops/binning.py:172-331 (the part the record pipeline
runs). Each splat evaluates the ellipse-vs-box test (helpers.wgsl:220-279)
densely over its bbox on a fixed 8x8 layout — mask bit k covers tile
(cmin_x + k % 8, cmin_y + k // 8) — so the intersection pool holds only
exact hits. Splats whose bbox exceeds 8x8 fall back to conservative bbox
records (`small` False, count = bbox area).

u32 quantities (masks, packed popcounts) are held as int64 values in
[0, 2^32): PyTorch's uint32 has few operators, and int32's arithmetic
right shift would smear the sign bit into every field above bit 31.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from brush_tpu_torch.constants import TILE_WIDTH
from brush_tpu_torch.ops.projection import Projection

MASK_BITS = 64
U32 = 0xFFFFFFFF


class TileMasks(NamedTuple):
    """Per-splat exact-pretest results (global splat order)."""

    counts: torch.Tensor   # (N,) int64 exact (or conservative) record count
    mask_lo: torch.Tensor  # (N,) int64 in [0, 2^32): bits 0-31 of the mask
    mask_hi: torch.Tensor  # (N,) int64 in [0, 2^32): bits 32-63
    pc_pack: torch.Tensor  # (N,) int64: popcount of each mask byte, 4b each
    small: torch.Tensor    # (N,) bool — mask is authoritative (<= 8x8 bbox)


def cell_bbox(proj: Projection, cell=(1, 1)):
    """Tile bbox -> raster-cell bbox (inclusive min, exclusive max).

    A raster cell is cell=(gw, gh) tiles; (1, 1) is the identity."""
    gw, gh = cell
    tmin = proj.tile_min.to(torch.int64)
    tmax = proj.tile_max.to(torch.int64)
    cmin_x = torch.div(tmin[:, 0], gw, rounding_mode="floor")
    cmin_y = torch.div(tmin[:, 1], gh, rounding_mode="floor")
    cmax_x = torch.div(tmax[:, 0] + (gw - 1), gw, rounding_mode="floor")
    cmax_y = torch.div(tmax[:, 1] + (gh - 1), gh, rounding_mode="floor")
    return cmin_x, cmin_y, cmax_x, cmax_y


def precompute_tile_masks(proj: Projection, opac: torch.Tensor,
                          cell=(1, 1)) -> TileMasks:
    """Evaluate the exact tile test densely over each splat's 8x8 bbox.

    The per-(kx, ky) quantities of the sign-test form (see
    brush_tpu/ops/binning.py:_edge_hits) factor into (8, N) row and
    column pieces combined at (8, 8, N), in the reference's operation
    order so borderline decisions round the same way.
    """
    dev = opac.device
    cmin_x, cmin_y, cmax_x, cmax_y = cell_bbox(proj, cell)
    bbox_w = cmax_x - cmin_x
    bbox_h = cmax_y - cmin_y
    area = torch.where(proj.visible, bbox_w * bbox_h,
                       torch.zeros_like(bbox_w))
    small = (bbox_w <= 8) & (bbox_h <= 8) & (area > 0)

    gw, gh = cell
    wpx = float(TILE_WIDTH * gw)
    hpx = float(TILE_WIDTH * gh)
    ext_x = wpx / 2.0
    ext_y = hpx / 2.0
    sig = torch.log(opac * 255.0)
    scale = 1.0 / (2.0 * sig)
    ca = proj.conic[:, 0] * scale
    cb = proj.conic[:, 1] * scale
    cc = proj.conic[:, 2] * scale

    k8 = torch.arange(8, dtype=torch.float32, device=dev)[:, None]   # (8, 1)
    k8i = torch.arange(8, dtype=torch.int64, device=dev)[:, None]
    cxf = cmin_x.to(torch.float32)
    cyf = cmin_y.to(torch.float32)
    dx_c = (proj.xy[:, 0] - cxf * wpx - ext_x)[None, :] - k8 * wpx   # (8, N)
    dy_c = (proj.xy[:, 1] - cyf * hpx - ext_y)[None, :] - k8 * hpx
    rx = torch.abs(dx_c) <= ext_x
    ry = torch.abs(dy_c) <= ext_y
    sx = torch.sign(dx_c)
    sy = torch.sign(dy_c)
    px = sx * ext_x - dx_c          # cpx: nearest corner -> center, x
    py = sy * ext_y - dy_c
    gx1 = ca[None, :] * px
    gy1 = cc[None, :] * py
    axm1 = gx1 * px - 1.0           # ca*cpx^2 - 1 (folds the -1 of c)
    ay = gy1 * py                   # cc*cpy^2
    pxb = (2.0 * cb)[None, :] * px  # cross-term coefficient of c
    e1k = -sx * wpx                 # edge-1 direction dx1 = -sx*2ext_x
    e1a = e1k * gx1
    e1b = e1k * cb[None, :]
    e2k = -sy * hpx
    e2a = e2k * gy1
    e2b = e2k * cb[None, :]
    kx_ok = k8i < bbox_w[None, :]
    ky_ok = k8i < bbox_h[None, :]

    a1 = (ca * (wpx * wpx))[None, None, :]                     # (1, 1, N)
    a2 = (cc * (hpx * hpx))[None, None, :]
    alive = ((sig > 0.0) & (area > 0))[None, None, :]

    X = lambda v: v[None, :, :]     # kx pieces -> (1, 8, N)
    Y = lambda v: v[:, None, :]     # ky pieces -> (8, 1, N)
    c = X(axm1) + Y(ay) + X(pxb) * Y(py)
    hb1 = X(e1a) + X(e1b) * Y(py)
    hb2 = Y(e2a) + Y(e2b) * X(px)
    in0 = c <= 0.0                  # f(0) <= 0, shared by both edges

    def vertex(a, hb):
        return ((hb * hb >= a * c) & (hb <= 0.0) & (hb + a >= 0.0)
                & (a > 0.0))

    hit = (
        (X(rx) & Y(ry)) | in0
        | (a1 + 2.0 * hb1 + c <= 0.0) | vertex(a1, hb1)
        | (a2 + 2.0 * hb2 + c <= 0.0) | vertex(a2, hb2)
    )
    hit = hit & X(kx_ok) & Y(ky_ok) & alive                     # (8, 8, N)
    bits = hit.reshape(MASK_BITS, -1).to(torch.int64)           # (64, N)

    weights = torch.arange(32, dtype=torch.int64, device=dev)[:, None]
    mask_lo = (bits[0:32] << weights).sum(dim=0)
    mask_hi = (bits[32:64] << weights).sum(dim=0)
    nib = 4 * torch.div(weights, 8, rounding_mode="floor")
    pc_pack = ((bits[0:32] << nib).sum(dim=0)
               | ((bits[32:64] << nib).sum(dim=0) << 16))
    cnt_exact = bits.sum(dim=0)
    counts = torch.where(small, cnt_exact, area)
    return TileMasks(counts=counts, mask_lo=mask_lo, mask_hi=mask_hi,
                     pc_pack=pc_pack, small=small)


def popcount_u32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of u32 values held in int64 (the classic bit-parallel
    reduction; the multiply's carries past bit 31 are masked off, which is
    the u32 wrap the reference's version relies on)."""
    v = v & U32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & U32) >> 24


def _ones_below64(x: torch.Tensor):
    """(lo, hi) u32 halves (int64 values) of a 64-bit mask with bits
    [0, x) set, x clamped to [0, 64] (brush_tpu/ops/binning.py:334-348)."""
    x = torch.clamp(x, 0, 64)
    xl = torch.clamp(x, 0, 32)
    xh = torch.clamp(x - 32, 0, 32)
    return (1 << xl) - 1, (1 << xh) - 1


def restrict_masks_parts(ty0, bbox_w, bbox_h, small, mask_lo, mask_hi,
                         counts_g, row_lo: int, row_hi: int):
    """Restrict each splat's coverage to the cell rows [row_lo, row_hi)
    (brush_tpu/ops/binning.py:350-407), elementwise over N; u32 values in
    int64, as everywhere in this module.

    Small splats keep the mask bits of the rows inside the strip (bit k
    covers row ty0 + k // 8 on the fixed 8x8 layout, so the kept bits are
    [lo_r 8, hi_r 8)) and count their popcount; bbox splats clip their
    row range, tmin_y moving to its first kept row, and count
    (hi_r - lo_r) bbox_w. Returns (counts_d, mask_lo_d, mask_hi_d,
    tmin_y_d, bbox_h_d), the last the clipped row count that
    render.pack_decode_parts stashes for bbox splats."""
    lo_r = torch.minimum(torch.clamp(row_lo - ty0, min=0), bbox_h)
    hi_r = torch.minimum(torch.clamp(row_hi - ty0, min=0), bbox_h)
    a_lo, a_hi = _ones_below64(lo_r * 8)
    b_lo, b_hi = _ones_below64(hi_r * 8)
    m_lo = mask_lo & b_lo & ~a_lo
    m_hi = mask_hi & b_hi & ~a_hi
    cnt_small = popcount_u32(m_lo) + popcount_u32(m_hi)
    cnt_bbox = (hi_r - lo_r) * bbox_w

    producing = counts_g > 0
    counts_d = torch.where(producing, torch.where(small, cnt_small,
                                                  cnt_bbox), 0)
    m_lo = torch.where(producing, m_lo, 0)
    m_hi = torch.where(producing, m_hi, 0)
    tmin_y_d = torch.where(small, ty0, ty0 + lo_r)
    return counts_d, m_lo, m_hi, tmin_y_d, hi_r - lo_r


def restrict_masks_to_strip(proj: Projection, masks: TileMasks, counts_g,
                            row_lo: int, row_hi: int):
    """restrict_masks_parts from a projection's tile bbox and its masks
    (brush_tpu/ops/binning.py:350-375; tile rows, cell (1, 1))."""
    ty0 = proj.tile_min[:, 1].to(torch.int64)
    bbox_w = torch.clamp(
        (proj.tile_max[:, 0] - proj.tile_min[:, 0]).to(torch.int64), 1, 1023)
    bbox_h = torch.clamp(
        (proj.tile_max[:, 1] - proj.tile_min[:, 1]).to(torch.int64), min=1)
    return restrict_masks_parts(ty0, bbox_w, bbox_h, masks.small,
                                masks.mask_lo, masks.mask_hi, counts_g,
                                row_lo, row_hi)
