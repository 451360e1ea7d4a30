"""The record pipeline: sort -> expand -> sort -> rasterize, and its VJP.

Port of brush_tpu/ops/pallas/raster_vjp.py, make_pallas_pipeline
(:101-451), as plain PyTorch glue around the four kernels (ops/cuda/),
which run as CUDA kernels on CUDA tensors and as their plain versions on
CPU tensors. Forward:

  1. colour and opacity quantize to u16 halves packed two to a word;
  2. one stable sort on the depth key orders every per-splat field; its
     indices are `order` (compact -> global);
  3. record counts are recomputed from the sorted decode rows (popcount of
     the mask halves for small splats, bbox area otherwise), and offsets
     come from an overflow-guarded cumsum;
  4. expand writes each producing splat's records into the pool, record
     row 7 holding the splat's compact id;
  5. a stable sort on the tile key groups the records per tile (stability
     keeps depth order inside a tile);
  6. searchsorted gives each tile's [start, end), and rasterize_fwd
     composites each tile.

cell=(gw, gh) (raster_vjp.py:138-168) runs all of this in the cell
domain: the decode rows come in cell units (render.pack_decode_rows),
"tiles" are raster cells of gw x gh tiles, cells_x and num_cells replace
tiles_x and num_tiles, there is one record per (splat, cell), and both
rasterizers sweep the cell's P = 256 gw gh pixels. expand is cell-agnostic.
cell (1, 1) is the tile pipeline. The TPU pipeline's tiles_per_step
shrink is a Mosaic scoped-VMEM limit with no counterpart here; its k_lanes
budget (raster_vjp.py:154-162) is kept (scan_lanes), because k_lanes sets
the batches of the truncated log-T scan.

scan_passes and k_lanes (make_pallas_pipeline's, default 2 and 512) go to
both rasterizers: below 3 passes, with k_lanes a multiple of 128, each
batch of k_lanes records scans log T from bf16 parts of its terms, as the
TPU kernels do (ops/cuda/rasterize_fwd.rasterize_fwd_plain); 3 is exact.

tile_base and raster_tiles (raster_vjp.py:117-125,275-309) make the whole
pipeline strip-local: the caller passes decode rows restricted to the
strip's cell rows (ops/binning.restrict_masks_parts), so the pool holds
only the strip's records; expand's keys (global cell ids) minus tile_base
are the local keys, and keys outside [0, raster_tiles) and expand's
sentinel become the local sentinel raster_tiles; the tile sort, the bins,
both rasterizers and the backward run over the strip's raster_tiles cells
(local cell t is the image's cell tile_base + t); a local cell past the
image's num_cells gets an empty range. The backward needs no strip mask:
the pool is the strip's. The defaults, 0 and num_cells, are the whole
frame, bit for bit.

`infer_pipeline` runs this without gradients. `RecordPipeline` is the
differentiable version; its backward
(raster_vjp.py:336-424):

  1. rasterize_bwd gives per-record gradient rows in tile order;
  2. a sort on row 7 groups each splat's records at its offsets (compact
     ids are assigned in depth order, so the sorted ids are the slot
     owners); with pack_grad_sort the conic and colour rows ride the
     gather as bf16 pairs, as the reference's default does;
  3. rows at slots >= total are zeroed and segment_sum sums per splat;
  4. the per-splat rows return to global order through `order`.
Gradients are taken at the quantized colour and opacity and passed
straight through to the unquantized inputs, as in the reference.

`make_pallas_rasterizer` (raster_vjp.py:453-512) is the other way to feed
the two rasterizers: the records of ops/binning.build_intersections(
align=k_lanes) in place of expand's, packed by pack_isect_splats, and a
backward that sorts the gradient rows by the records' global ids (the
reference scatter-adds them) and sums them per splat with segment_sum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from brush_tpu_torch.ops.binning import popcount_u32
from brush_tpu_torch.ops.cuda.expand import expand
from brush_tpu_torch.ops.cuda.rasterize_bwd import rasterize_bwd
from brush_tpu_torch.ops.cuda.rasterize_fwd import (
    PACK_ROWS, pack_colop, pack_isect_splats, quantize_color, quantize_opac,
    rasterize_fwd, to_i32_bits,
)
from brush_tpu_torch.ops.cuda.segsum import segment_sum
from brush_tpu_torch.utils.profiler import mark, span


class DepthOrder(NamedTuple):
    """The depth-ordered expand inputs and the bookkeeping the backward
    needs; int32 scalars stay on the device."""

    f5: torch.Tensor         # (5, n) float32 x, y, cxx, cxy, cyy
    u5: torch.Tensor         # (5, n) int32 colop0, colop1, decode rows
    cum: torch.Tensor        # (n,) int32 inclusive record-count cumsum
    offsets: torch.Tensor    # (n,) int32 exclusive cumsum (cum - counts)
    total: torch.Tensor      # (1,) int32 live records, clamped to the pool
    raw_total: torch.Tensor  # () int32 unclamped record count
    order: torch.Tensor      # (n,) int64 compact -> global splat index


def depth_order(attrs9, decode, depth_key, max_isects: int) -> DepthOrder:
    """Stages 1-3. attrs9 (9, n) float32 global order (x, y, cxx, cxy, cyy,
    r, g, b, opacity); decode (3, n) u32 values in int64
    (render.pack_decode_rows); depth_key (n,) int64, 2^32 - 1 for splats
    that produce no record."""
    colop0 = pack_colop(quantize_color(attrs9[5]), quantize_color(attrs9[6]))
    colop1 = pack_colop(quantize_color(attrs9[7]), quantize_opac(attrs9[8]))
    order = torch.sort(depth_key, stable=True).indices
    f5 = attrs9[0:5][:, order].contiguous()
    u5 = torch.stack([colop0, colop1, to_i32_bits(decode[0]),
                      to_i32_bits(decode[1]), to_i32_bits(decode[2])])
    u5 = u5[:, order].contiguous()

    d0 = decode[0][order]
    m_lo = decode[1][order]
    small = ((d0 >> 10) & 1) == 1
    counts = torch.where(small, popcount_u32(m_lo)
                         + popcount_u32(decode[2][order]),
                         (d0 >> 22) * m_lo)
    # Overflow-safe offsets (raster_vjp.py:216-233): an f32 shadow cumsum
    # zeroes the counts of splats whose records start safely past the pool,
    # so the exact cumsum stays bounded; raw_total reports clamped.
    counts_f = counts.to(torch.float32)
    cum_f = torch.cumsum(counts_f, dim=0)
    beyond = cum_f - counts_f > 4.0 * max_isects
    counts = torch.where(beyond, 0, counts)
    cum = torch.cumsum(counts, dim=0)
    raw_total = torch.clamp(cum_f[-1], max=2.0 ** 31 - 1024).to(torch.int32)
    total = torch.clamp(cum[-1:], max=max_isects).to(torch.int32)
    return DepthOrder(f5, u5, cum.to(torch.int32),
                      (cum - counts).to(torch.int32), total, raw_total, order)


def tile_bins(keys, recs, num_tiles: int):
    """Stage 5: stable tile sort of the pool -> (packed (8, pool) int32,
    starts (T,) int32, ends (T,) int32). Row 7 carries each record's
    compact splat id (the backward re-sorts on it; the forward ignores
    it)."""
    skeys, perm = torch.sort(keys, stable=True)
    packed = recs[:, perm]
    bounds = torch.arange(num_tiles + 1, dtype=skeys.dtype,
                          device=skeys.device)
    bins = torch.searchsorted(skeys, bounds).to(torch.int32)
    return packed, bins[:-1].contiguous(), bins[1:].contiguous()


def strip_bins(keys, recs, num_cells: int, tile_base: int,
               raster_tiles: int):
    """Stage 5 in the strip-local cell domain (raster_vjp.py:275-309):
    global keys -> local ones (outside the strip and expand's sentinel ->
    raster_tiles), tile_bins over raster_tiles, and empty ranges for the
    local cells past the image."""
    local = keys - tile_base
    local = torch.where((local >= 0) & (local < raster_tiles), local,
                        raster_tiles)
    packed, starts, ends = tile_bins(local, recs, raster_tiles)
    past = max(num_cells - tile_base, 0)
    if past < raster_tiles:
        ends = torch.cat([ends[:past], starts[past:]])
    return packed, starts, ends


def scan_lanes(k_lanes: int, cell=(1, 1)) -> int:
    """k_lanes under the TPU pipeline's budget for a cell of P = 256 gw gh
    pixels (raster_vjp.py:154-162): at most max(128, 2^18 / P), rounded
    down to a power of two."""
    budget = max(128, (256 * 1024) // (256 * cell[0] * cell[1]))
    return min(int(k_lanes), 1 << (budget.bit_length() - 1))


def _forward(attrs9, decode, depth_key, cells_x: int, num_cells: int,
             max_isects: int, cell=(1, 1), tile_base: int = 0,
             raster_tiles: int | None = None, scan_passes: int = 2,
             k_lanes: int = 512):
    """Stages 1-6 -> (DepthOrder, (packed, starts, ends), (img, log_t,
    final_idx)); the strip's raster_tiles cells from tile_base (default:
    the whole frame); k_lanes as scan_lanes leaves it."""
    # The packed decode rows hold a 10-bit cell x and an 11-bit cell y
    # (raster_vjp.py:146-153, in cell units).
    if cells_x > 1023 or num_cells > cells_x * 2047:
        raise ValueError("image too large for the packed decode rows")
    with span("depth_order"):
        d = depth_order(attrs9, decode, depth_key, max_isects)
    with span("expand"):
        keys, recs = expand(d.f5, d.u5, d.cum, d.total, cells_x, num_cells,
                            max_isects)
    if raster_tiles is None:
        raster_tiles = num_cells
    with span("tile_bins"):
        bins = strip_bins(keys, recs, num_cells, tile_base, raster_tiles)
    with span("rasterize_fwd"):
        out = rasterize_fwd(*bins, cells_x, tuple(cell), tile_base,
                            scan_passes=scan_passes, k_lanes=k_lanes)
    return d, bins, out


def infer_pipeline(attrs9, decode, depth_key, cells_x: int, num_cells: int,
                   max_isects: int, cell=(1, 1), tile_base: int = 0,
                   raster_tiles: int | None = None, scan_passes: int = 2,
                   k_lanes: int = 512):
    """The whole inference pipeline. Returns (img_cells (C, P, 4), total,
    raw_total): total is the live records clamped to the pool, raw_total
    the unclamped count (raw_total - total were dropped). With a strip, C
    is raster_tiles."""
    if attrs9.requires_grad:
        raise ValueError(
            "infer_pipeline is inference-only: an input requires grad; "
            "render with needs_grad=True (RecordPipeline) to differentiate")
    d, _, (img, _, _) = _forward(
        attrs9, decode, depth_key, cells_x, num_cells, max_isects, cell,
        tile_base, raster_tiles, scan_passes, scan_lanes(k_lanes, cell))
    return img, d.total[0], d.raw_total


def _pack_bf16_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two f32 rows -> one int32 row of bf16 halves (a in the high 16 bits);
    the conversion rounds to nearest even, as astype(bfloat16) does."""
    bf = lambda v: (v.to(torch.bfloat16).view(torch.int16).to(torch.int64)
                    & 0xFFFF)
    return to_i32_bits((bf(a) << 16) | bf(b))


def _unpack_bf16_pair(u: torch.Tensor):
    """Inverse of _pack_bf16_pair: int32 row -> two f32 rows."""
    u = u.to(torch.int64) & 0xFFFFFFFF
    f = lambda h: to_i32_bits(h << 16).view(torch.float32)
    return f(u >> 16), f(u & 0xFFFF)


def grad_resort(grads, ids, total, pack_grad_sort: bool) -> torch.Tensor:
    """Backward step 2-3: gradient rows (9, pool) in tile order -> sorted
    by compact splat id (pool row 7; sentinel records carry id n and sort
    past `total`), zeroed at slots >= total."""
    perm = torch.sort(ids, stable=True).indices
    if pack_grad_sort:
        bits = lambda r: grads[r].view(torch.int32)
        payload = torch.stack([
            bits(0), bits(1), _pack_bf16_pair(grads[2], grads[3]),
            _pack_bf16_pair(grads[4], grads[5]),
            _pack_bf16_pair(grads[6], grads[7]), bits(8)])[:, perm]
        f = lambda r: payload[r].contiguous().view(torch.float32)
        rows = torch.stack([f(0), f(1), *_unpack_bf16_pair(payload[2]),
                            *_unpack_bf16_pair(payload[3]),
                            *_unpack_bf16_pair(payload[4]), f(5)])
    else:
        rows = grads[:, perm]
    live = torch.arange(rows.shape[1], device=rows.device) < total
    return torch.where(live, rows, torch.zeros((), device=rows.device))


class RecordPipeline(torch.autograd.Function):
    """The differentiable record pipeline (make_pallas_pipeline with
    needs_grad=True). Differentiable in attrs9 only; decode and depth_key
    are integer bookkeeping.

    apply(attrs9, decode, depth_key, cells_x, num_cells, max_isects,
    pack_grad_sort, cell, tile_base, raster_tiles, scan_passes, k_lanes) ->
    (img_cells (C, P, 4), order (n,) int64, total () int32, raw_total ()
    int32); with a strip (tile_base, raster_tiles) C is raster_tiles;
    scan_passes and k_lanes (default 2 and 512, make_pallas_pipeline's)
    reach both rasterizers, k_lanes as scan_lanes leaves it.
    """

    @staticmethod
    def forward(ctx, attrs9, decode, depth_key, cells_x, num_cells,
                max_isects, pack_grad_sort, cell=(1, 1), tile_base=0,
                raster_tiles=None, scan_passes=2, k_lanes=512):
        k_lanes = scan_lanes(k_lanes, cell)
        d, (packed, starts, ends), (img, log_t, fidx) = _forward(
            attrs9, decode, depth_key, cells_x, num_cells, max_isects, cell,
            tile_base, raster_tiles, scan_passes, k_lanes)
        ctx.save_for_backward(packed, starts, ends, log_t, fidx, d.offsets,
                              d.cum, d.total, d.order)
        ctx.cells_x = cells_x
        ctx.cell = tuple(cell)
        ctx.tile_base = tile_base
        ctx.pack_grad_sort = pack_grad_sort
        ctx.scan = dict(scan_passes=scan_passes, k_lanes=k_lanes)
        total = d.total[0].clone()
        ctx.mark_non_differentiable(d.order, total, d.raw_total)
        return img, d.order, total, d.raw_total

    @staticmethod
    def backward(ctx, g_img, _g_order, _g_total, _g_raw):
        mark("loss backward")
        packed, starts, ends, log_t, fidx, offsets, cum, total, order = \
            ctx.saved_tensors
        grads = rasterize_bwd(packed, starts, ends, ctx.cells_x,
                              g_img.contiguous(), log_t, fidx, ctx.cell,
                              ctx.tile_base, **ctx.scan)
        mark("rasterize_bwd")
        rows = grad_resort(grads, packed[PACK_ROWS - 1], total,
                           ctx.pack_grad_sort)
        mark("grad_resort")
        per_splat = segment_sum(rows, offsets, cum, total)
        mark("segment_sum")
        acc = torch.empty_like(per_splat)
        acc[:, order] = per_splat
        mark("to_global")
        return (acc, None, None, None, None, None, None, None, None, None,
                None, None)


def strip_base(tile_ids: torch.Tensor, num_tiles: int) -> int:
    """tile_base of `tile_ids` (num_tiles,), which must be the contiguous
    run of tiles from tile_ids[0] (the only form the JAX package passes);
    raises otherwise. Reads tile_ids to the host."""
    if tuple(tile_ids.shape) != (num_tiles,):
        raise ValueError(f"tile_ids must be ({num_tiles},), got "
                         f"{tuple(tile_ids.shape)}")
    ids = tile_ids.to("cpu", torch.int64)
    base = int(ids[0]) if num_tiles else 0
    if base < 0 or not torch.equal(ids, torch.arange(base, base + num_tiles)):
        raise ValueError("tile_ids must be a contiguous run of tiles "
                         "from tile_ids[0]")
    return base


class AlignedRaster(torch.autograd.Function):
    """make_pallas_rasterizer's autograd Function; gradients reach xy,
    conic, color and opac only."""

    @staticmethod
    def forward(ctx, xy, conic, color, opac, isect_gid, starts, ends,
                tiles_x, tile_base, max_isects, k_lanes):
        packed = pack_isect_splats(xy, conic, color, opac, isect_gid,
                                   max_isects, k_lanes)
        starts, ends = (t.to(torch.int32).contiguous() for t in (starts,
                                                                 ends))
        # The forward at rasterize_fwd_pallas's default scan_passes=2 over
        # batches of this rasterizer's k_lanes, the backward at
        # rasterize_bwd_pallas's exact 3 (raster_vjp.py:467-470, 491-494).
        img, log_t, fidx = rasterize_fwd(packed, starts, ends, tiles_x,
                                         (1, 1), tile_base, scan_passes=2,
                                         k_lanes=k_lanes)
        ctx.save_for_backward(packed, isect_gid, starts, ends, log_t, fidx)
        ctx.tiles_x, ctx.tile_base, ctx.n = tiles_x, tile_base, xy.shape[0]
        return img

    @staticmethod
    def backward(ctx, g):
        packed, isect_gid, starts, ends, log_t, fidx = ctx.saved_tensors
        grads = rasterize_bwd(packed, starts, ends, ctx.tiles_x,
                              g.contiguous(), log_t, fidx, (1, 1),
                              ctx.tile_base, scan_passes=3)
        acc = aligned_splat_sums(grads, isect_gid, ctx.n).T
        return (acc[:, 0:2], acc[:, 2:5], acc[:, 5:8], acc[:, 8],
                None, None, None, None, None, None, None)


def aligned_splat_sums(grads, isect_gid, n: int) -> torch.Tensor:
    """The aligned backward's per-splat sums (raster_vjp.py:497-506, one
    scatter-add there): grads (9, pool) in slot order, isect_gid the
    slots' global ids (padding slots carry id n; the pool's slack lanes
    past isect_gid take n too) -> (9, n). A stable sort by id groups each
    splat's slots in slot order, and segment_sum adds them: the CUDA
    kernel on CUDA tensors, whose fixed order repeats bit for bit, the
    plain version on CPU tensors. Id n's slots sort last, past `total`."""
    dev = grads.device
    if n == 0:
        return torch.zeros((grads.shape[0], 0), dtype=torch.float32,
                           device=dev)
    gid = torch.full((grads.shape[1],), n, dtype=torch.int64, device=dev)
    gid[:isect_gid.shape[0]] = isect_gid
    sorted_gid, perm = torch.sort(gid, stable=True)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    offsets = torch.searchsorted(sorted_gid, ids).to(torch.int32)
    cum = torch.searchsorted(sorted_gid, ids, right=True).to(torch.int32)
    return segment_sum(grads[:, perm].contiguous(), offsets, cum,
                       cum[-1:].contiguous())


def make_pallas_rasterizer(tiles_x: int, num_tiles: int, max_isects: int,
                           k_lanes: int):
    """The rasterizer on aligned records (brush_tpu/ops/pallas/
    raster_vjp.py:453-512), the call signature of ops/rasterize_tiled.
    make_rasterizer: raster(xy, conic, color, opac, isect_gid, starts, ends,
    tile_ids) -> (num_tiles, TILE_SIZE, 4), with the per-compact-splat
    attributes and the records of build_intersections(align=k_lanes).

    Runs the CUDA kernels (rasterize_fwd, then rasterize_bwd and
    segment_sum in the backward) on CUDA tensors and their plain versions
    on CPU tensors; a failed build or launch raises. As in the reference,
    the forward truncates its log-T scan (scan_passes=2, batches of
    k_lanes) and the backward's is exact (scan_passes=3). The forward
    packs the pool with pack_isect_splats (max_isects + k_lanes slots);
    the backward sums the per-record gradient rows per splat in slot order
    (aligned_splat_sums: a stable sort by global id, then segment_sum), so
    two backward passes on the card give the same bits. Gradients are
    taken at the quantized colour and opacity and passed straight through.

    The kernels take a strip's first tile, not a list: tile_ids must be the
    contiguous run from tile_ids[0] (strip_base raises otherwise), which
    costs one read to the host a call. Only tests and chip_smoke.py call
    this; the training step runs the record pipeline.
    """

    def raster(xy, conic, color, opac, isect_gid, starts, ends, tile_ids):
        tile_base = strip_base(tile_ids, num_tiles)
        if tuple(starts.shape) != (num_tiles,):
            raise ValueError(f"starts must be ({num_tiles},), got "
                             f"{tuple(starts.shape)}")
        return AlignedRaster.apply(xy, conic, color, opac, isect_gid, starts,
                                   ends, tiles_x, tile_base, max_isects,
                                   k_lanes)

    return raster
