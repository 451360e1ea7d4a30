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
cell (1, 1) is the tile pipeline. The TPU pipeline's cell-dependent knobs
(the k_lanes VMEM budget, the tiles_per_step shrink) are Mosaic
scoped-VMEM limits with no counterpart here.

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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from brush_tpu_torch.ops.binning import popcount_u32
from brush_tpu_torch.ops.cuda.expand import expand
from brush_tpu_torch.ops.cuda.rasterize_bwd import rasterize_bwd
from brush_tpu_torch.ops.cuda.rasterize_fwd import (
    PACK_ROWS, pack_colop, quantize_color, quantize_opac, rasterize_fwd,
    to_i32_bits,
)
from brush_tpu_torch.ops.cuda.segsum import segment_sum
from brush_tpu_torch.utils.profiler import mark


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


def _forward(attrs9, decode, depth_key, cells_x: int, num_cells: int,
             max_isects: int, cell=(1, 1)):
    """Stages 1-6 -> (DepthOrder, (packed, starts, ends), (img, log_t,
    final_idx))."""
    # The packed decode rows hold a 10-bit cell x and an 11-bit cell y
    # (raster_vjp.py:146-153, in cell units).
    if cells_x > 1023 or num_cells > cells_x * 2047:
        raise ValueError("image too large for the packed decode rows")
    d = depth_order(attrs9, decode, depth_key, max_isects)
    mark("depth_order")
    keys, recs = expand(d.f5, d.u5, d.cum, d.total, cells_x, num_cells,
                        max_isects)
    mark("expand")
    bins = tile_bins(keys, recs, num_cells)
    mark("tile_bins")
    out = rasterize_fwd(*bins, cells_x, tuple(cell))
    mark("rasterize_fwd")
    return d, bins, out


def infer_pipeline(attrs9, decode, depth_key, cells_x: int, num_cells: int,
                   max_isects: int, cell=(1, 1)):
    """The whole inference pipeline. Returns (img_cells (C, P, 4), total,
    raw_total): total is the live records clamped to the pool, raw_total
    the unclamped count (raw_total - total were dropped)."""
    if attrs9.requires_grad:
        raise ValueError(
            "infer_pipeline is inference-only: an input requires grad; "
            "render with needs_grad=True (RecordPipeline) to differentiate")
    d, _, (img, _, _) = _forward(attrs9, decode, depth_key, cells_x,
                                 num_cells, max_isects, cell)
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
    pack_grad_sort, cell) -> (img_cells (C, P, 4), order (n,)
    int64, total () int32, raw_total () int32).
    """

    @staticmethod
    def forward(ctx, attrs9, decode, depth_key, cells_x, num_cells,
                max_isects, pack_grad_sort, cell=(1, 1)):
        d, (packed, starts, ends), (img, log_t, fidx) = _forward(
            attrs9, decode, depth_key, cells_x, num_cells, max_isects, cell)
        ctx.save_for_backward(packed, starts, ends, log_t, fidx, d.offsets,
                              d.cum, d.total, d.order)
        ctx.cells_x = cells_x
        ctx.cell = tuple(cell)
        ctx.pack_grad_sort = pack_grad_sort
        total = d.total[0].clone()
        ctx.mark_non_differentiable(d.order, total, d.raw_total)
        return img, d.order, total, d.raw_total

    @staticmethod
    def backward(ctx, g_img, _g_order, _g_total, _g_raw):
        mark("loss backward")
        packed, starts, ends, log_t, fidx, offsets, cum, total, order = \
            ctx.saved_tensors
        grads = rasterize_bwd(packed, starts, ends, ctx.cells_x,
                              g_img.contiguous(), log_t, fidx, ctx.cell)
        mark("rasterize_bwd")
        rows = grad_resort(grads, packed[PACK_ROWS - 1], total,
                           ctx.pack_grad_sort)
        mark("grad_resort")
        per_splat = segment_sum(rows, offsets, cum, total)
        mark("segment_sum")
        acc = torch.empty_like(per_splat)
        acc[:, order] = per_splat
        mark("to_global")
        return acc, None, None, None, None, None, None, None
