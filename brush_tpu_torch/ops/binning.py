"""Tile binning: the exact per-tile pretest and the intersection records.

Port of brush_tpu/ops/binning.py. Each splat evaluates the ellipse-vs-box
test (helpers.wgsl:220-279) densely over its bbox on a fixed 8x8 layout —
mask bit k covers tile (cmin_x + k % 8, cmin_y + k // 8) — so the
intersection pool holds only exact hits; on the card one CUDA kernel
(csrc/tile_pretest.cu) computes it, bit-equal to the plain twin here.
Splats whose bbox exceeds 8x8 fall back to conservative bbox records
(`small` False, count = bbox area).
The record pipeline (ops/pipeline.py) builds its records from these masks
with the expand kernel; build_intersections builds the XLA backend's
depth-then-tile ordered records from them in plain PyTorch.

u32 quantities (masks, packed popcounts, depth bits, packed sort keys) are
held as int64 values in [0, 2^32): PyTorch's uint32 has few operators,
int32's arithmetic right shift would smear the sign bit into every field
above bit 31, and int64 keys sort in the unsigned order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from brush_tpu_torch.constants import TILE_WIDTH
from brush_tpu_torch.ops.cuda import tile_pretest as cuda_pretest
from brush_tpu_torch.ops.projection import Projection

MASK_BITS = 64
U32 = 0xFFFFFFFF


def _edge_hits(a, half_b, c):
    """Does the conic quadratic f(t) = a t^2 + 2 half_b t + c reach f <= 0
    on t in [0, 1] (one box edge)? Sign tests on the polynomial, sqrt- and
    division-free (brush_tpu/ops/binning.py:56-88): an end inside, or the
    vertex inside [0, 1] with its value <= 0 (guarded by a > 0)."""
    return ((c <= 0.0)
            | (a + 2.0 * half_b + c <= 0.0)
            | ((half_b * half_b >= a * c) & (half_b <= 0.0) & (-half_b <= a)
               & (a > 0.0)))


def ellipse_intersects_aabb(box_x, box_y, ext_x, ext_y, ex, ey, ca, cb, cc):
    """Ellipse (conic level set 1) against an axis-aligned box of centre
    (box_x, box_y) and half-extents (ext_x, ext_y) (helpers.wgsl:238-262,
    brush_tpu/ops/binning.py:91-119): the centre inside the box, or either
    edge from the box corner nearest the centre reaching the interior."""
    dx_c = ex - box_x
    dy_c = ey - box_y
    center_inside = (torch.abs(dx_c) <= ext_x) & (torch.abs(dy_c) <= ext_y)
    sx = torch.sign(dx_c)
    sy = torch.sign(dy_c)
    cpx = box_x + sx * ext_x - ex
    cpy = box_y + sy * ext_y - ey
    gx = ca * cpx + cb * cpy
    gy = cb * cpx + cc * cpy
    c = cpx * gx + cpy * gy - 1.0
    dx1 = -sx * (2.0 * ext_x)       # horizontal edge: nearest -> far corner
    dy2 = -sy * (2.0 * ext_y)       # vertical edge
    edge1 = _edge_hits(ca * (4.0 * ext_x * ext_x), dx1 * gx, c)
    edge2 = _edge_hits(cc * (4.0 * ext_y * ext_y), dy2 * gy, c)
    return center_inside | edge1 | edge2


def can_be_visible(tile_x, tile_y, xy, conic, opac, cell=(1, 1)):
    """Does the splat's 1/255-alpha iso-ellipse touch raster cell (tile_x,
    tile_y) of cell=(gw, gh) tiles? (helpers.wgsl:264-279,
    brush_tpu/ops/binning.py:122-143)."""
    gw, gh = cell
    sigma = torch.log(opac * 255.0)
    scale = 1.0 / (2.0 * sigma)
    ca = conic[..., 0] * scale
    cb = conic[..., 1] * scale
    cc = conic[..., 2] * scale
    ext_x = float(TILE_WIDTH * gw) / 2.0
    ext_y = float(TILE_WIDTH * gh) / 2.0
    cx = tile_x.to(torch.float32) * (TILE_WIDTH * gw) + ext_x
    cy = tile_y.to(torch.float32) * (TILE_WIDTH * gh) + ext_y
    hit = ellipse_intersects_aabb(cx, cy, ext_x, ext_y, xy[..., 0],
                                  xy[..., 1], ca, cb, cc)
    return (sigma > 0.0) & hit


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
    """The exact tile test of each splat over its 8x8 bbox window, on the
    inputs' device: the CUDA kernel (ops/cuda/tile_pretest.py) for CUDA
    tensors, precompute_tile_masks_plain for CPU tensors. Both give the
    same bits."""
    if opac.device.type == "cpu":
        return precompute_tile_masks_plain(proj, opac, cell)
    return TileMasks(*cuda_pretest.tile_pretest(
        proj.xy, proj.conic, opac, proj.tile_min, proj.tile_max,
        proj.visible, cell))


def precompute_tile_masks_plain(proj: Projection, opac: torch.Tensor,
                                cell=(1, 1)) -> TileMasks:
    """Evaluate the exact tile test densely over each splat's 8x8 bbox
    (the CUDA kernel's twin, csrc/tile_pretest.cu).

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


def select_bit64(m_lo: torch.Tensor, m_hi: torch.Tensor,
                 rank: torch.Tensor) -> torch.Tensor:
    """Position of the rank-th set bit (0-indexed) of the 64-bit masks
    (m_lo, m_hi), u32 values in int64, for 0 <= rank < popcount (other
    ranks give some position in [0, 64)). The half by the popcount of
    m_lo, then a binary search on the popcounts of the lower halves of
    shrinking windows: elementwise, O(1) memory a mask. The reference
    decodes the same position from per-byte popcounts
    (brush_tpu/ops/binning.py:409-438), the expand kernel with SWAR
    steps."""
    lo_cnt = popcount_u32(m_lo)
    in_hi = rank >= lo_cnt
    word = torch.where(in_hi, m_hi, m_lo) & U32
    r = torch.where(in_hi, rank - lo_cnt, rank)
    pos = torch.zeros_like(rank)
    for width in (16, 8, 4, 2, 1):
        c = popcount_u32((word >> pos) & ((1 << width) - 1))
        up = r >= c
        pos = torch.where(up, pos + width, pos)
        r = torch.where(up, r - c, r)
    return torch.where(in_hi, pos + 32, pos)


class Intersections(NamedTuple):
    """The XLA backend's intersection records (index bookkeeping only)."""

    order: torch.Tensor        # (N,) int64 depth order: compact -> global id
    isect_gid: torch.Tensor    # (max_isects,) int64 record -> compact id
    starts: torch.Tensor       # (num_tiles,) int64 range start per tile
    ends: torch.Tensor         # (num_tiles,) int64 range end (exclusive)
    num_visible: torch.Tensor  # () int32
    num_isects: torch.Tensor   # () int32 records surviving the exact test
    num_dropped: torch.Tensor  # () int32 records lost to pool overflow
    producing: torch.Tensor    # (N,) bool, global order: emits >= 1 record


def build_intersections(proj: Projection, opac: torch.Tensor,
                        tile_bounds, max_isects: int,
                        align: int = 1) -> Intersections:
    """Depth-then-tile ordered intersection records
    (brush_tpu/ops/binning.py:441-628), on the inputs' device.

    Inputs are in global splat order and carry no gradient (pass detached
    tensors); the records index the depth-compact order `order`. Splats
    with records sort by their depth bits (stably; the rest after them);
    a pool of max_isects slots takes their records in that order, slot ->
    splat by marks at each splat's offset and a cumsum, slot -> tile by
    the rank-th set bit of the splat's mask (small splats) or row-major
    over its bbox; one sort of (tile << slot_bits) | slot keys groups the
    records by tile, depth order kept (a stable sort of the tile ids when
    the pool needs more slot bits), and searchsorted gives each tile's
    range. The overflow guard is the reference's: an f32 shadow cumsum
    zeroes the counts of splats that start past 4 max_isects, and the
    reported total is that cumsum's last value clamped at 2^31 - 1024, so
    num_dropped = max(total - max_isects, 0) is the reference's.

    align > 1 pads each tile's range to start on a multiple of `align`;
    padding slots carry splat id n (the reference's Pallas layout).
    """
    dev = opac.device
    n = proj.xy.shape[0]
    tiles_x, tiles_y = int(tile_bounds[0]), int(tile_bounds[1])
    num_tiles = tiles_x * tiles_y
    i64 = torch.int64

    masks = precompute_tile_masks(proj, opac)
    producing = proj.visible & (masks.counts > 0)
    tmin = proj.tile_min.to(i64)
    tmax = proj.tile_max.to(i64)
    # Per-splat decode rows, gathered once into depth order: count,
    # mask_lo, mask_hi, tmin_x, tmin_y, bbox_w, small.
    decode_g = torch.stack([
        torch.where(producing, masks.counts, 0), masks.mask_lo,
        masks.mask_hi, tmin[:, 0], tmin[:, 1],
        torch.clamp(tmax[:, 0] - tmin[:, 0], min=1), masks.small.to(i64),
    ], dim=1)

    depth_bits = torch.clamp(proj.depth, min=1e-20).view(torch.int32)
    depth_key = torch.where(producing, depth_bits.to(i64), U32)
    order = torch.sort(depth_key, stable=True).indices
    num_visible = proj.visible.sum().to(torch.int32)

    decode = decode_g[order]
    counts_c = decode[:, 0]
    cum_f = torch.cumsum(counts_c.to(torch.float32), dim=0)
    beyond = cum_f - counts_c.to(torch.float32) > 4.0 * max_isects
    counts_c = torch.where(beyond, 0, counts_c)
    offsets = torch.cumsum(counts_c, dim=0) - counts_c
    total = torch.clamp(cum_f[-1], max=2.0**31 - 1024).to(torch.int32)

    # Slot -> compact splat: a mark at each producing splat's offset (the
    # reference's scatter drops offsets past the pool), then a cumsum.
    starts_at = offsets[(counts_c > 0) & (offsets < max_isects)]
    marks = torch.zeros(max_isects, dtype=i64, device=dev)
    marks.index_add_(0, starts_at, torch.ones_like(starts_at))
    splat = torch.cumsum(marks, dim=0) - 1
    slot = torch.arange(max_isects, dtype=i64, device=dev)
    valid = (splat >= 0) & (slot < total)
    splat = torch.clamp(splat, 0, n - 1)

    d = decode[splat]
    rank = slot - offsets[splat]
    w_i = d[:, 5]
    pos = select_bit64(d[:, 1], d[:, 2], rank)
    dy_b = torch.div(rank, w_i, rounding_mode="floor")
    small = d[:, 6] > 0
    dy = torch.where(small, pos >> 3, dy_b)
    dx = torch.where(small, pos & 7, rank - dy_b * w_i)
    tile_id = (d[:, 4] + dy) * tiles_x + (d[:, 3] + dx)
    key = torch.where(valid, tile_id, num_tiles)

    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    slot_bits = 32 - tile_bits
    if max_isects <= (1 << slot_bits):
        packed = torch.sort((key << slot_bits) | slot).values
        sorted_key = packed >> slot_bits
        isect_gid = splat[packed & ((1 << slot_bits) - 1)]
    else:
        sorted_key, perm = torch.sort(key, stable=True)
        isect_gid = splat[perm]

    boundaries = torch.arange(num_tiles + 1, dtype=i64, device=dev)
    tile_bins = torch.searchsorted(sorted_key, boundaries, right=False)
    num_isects = tile_bins[-1].to(torch.int32)
    num_dropped = torch.clamp(total - max_isects, min=0).to(torch.int32)

    if align <= 1:
        return Intersections(order, isect_gid, tile_bins[:-1], tile_bins[1:],
                             num_visible, num_isects, num_dropped, producing)

    # Aligned re-layout (:584-628): each run of equal keys takes its pad at
    # its end, so a record's aligned position is its slot plus the pads of
    # the runs before it.
    change = sorted_key[1:] != sorted_key[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    is_end = torch.cat([change, one])
    is_start = torch.cat([one, change])
    run_start = torch.cummax(torch.where(is_start, slot, 0), dim=0).values
    run_len_at_end = slot - run_start + 1
    real = sorted_key < num_tiles
    end_pad = torch.where(is_end & real, (-run_len_at_end) % align, 0)
    pad_cum = torch.cumsum(end_pad, dim=0)
    pads_excl = pad_cum - end_pad
    new_pos = torch.where(real, slot + pads_excl, max_isects)

    pads_before = pads_excl[torch.clamp(tile_bins, max=max_isects - 1)]
    pads_before = torch.where(tile_bins >= max_isects, pad_cum[-1],
                              pads_before)
    aligned_starts = tile_bins[:-1] + pads_before[:-1]
    counts = tile_bins[1:] - tile_bins[:-1]
    starts = torch.clamp(aligned_starts, max=max_isects)
    ends = torch.clamp(aligned_starts + counts, max=max_isects)

    # Padding and overflow slots carry splat id n (dropped by the
    # reference's scatters).
    gid_aligned = torch.full((max_isects,), n, dtype=i64, device=dev)
    keep = new_pos < max_isects
    gid_aligned[new_pos[keep]] = isect_gid[keep]
    return Intersections(order, gid_aligned, starts, ends, num_visible,
                         num_isects, num_dropped, producing)
