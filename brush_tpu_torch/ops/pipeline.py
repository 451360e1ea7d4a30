"""The inference record pipeline: sort -> expand -> sort -> rasterize.

Port of brush_tpu/ops/pallas/raster_vjp.py, make_pallas_pipeline(
needs_grad=False)._fwd_impl (:179-321), as plain PyTorch glue around the
two kernels (ops/cuda/expand.py, ops/cuda/rasterize_fwd.py), which run as
CUDA kernels on CUDA tensors and as their plain versions on CPU tensors:

  1. colour and opacity quantize to u16 halves packed two to a word;
  2. one stable sort on the depth key orders every per-splat field;
  3. record counts are recomputed from the sorted decode rows (popcount of
     the mask halves for small splats, bbox area otherwise), and offsets
     come from an overflow-guarded cumsum;
  4. expand writes each producing splat's records into the pool;
  5. a stable sort on the tile key groups the records per tile (stability
     keeps depth order inside a tile), record row 7 is zero-filled;
  6. searchsorted gives each tile's [start, end), and rasterize_fwd
     composites each tile.

Gradients are not ported yet: an input that requires grad raises.
"""

from __future__ import annotations

import torch

from brush_tpu_torch.ops.binning import popcount_u32
from brush_tpu_torch.ops.cuda.expand import expand
from brush_tpu_torch.ops.cuda.rasterize_fwd import (
    PACK_ROWS, pack_colop, quantize_color, quantize_opac, rasterize_fwd,
    to_i32_bits,
)


def depth_order(attrs9, decode, depth_key, max_isects: int):
    """Stages 1-3. attrs9 (9, n) float32 global order (x, y, cxx, cxy, cyy,
    r, g, b, opacity); decode (3, n) u32 values in int64
    (render.pack_decode_rows); depth_key (n,) int64, 2^32 - 1 for splats
    that produce no record.

    Returns the expand inputs (f5, u5, cum, total) in depth order and
    raw_total, the unclamped record count (int32 scalars on the device).
    """
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
    return f5, u5, cum.to(torch.int32), total, raw_total


def tile_bins(keys, recs, num_tiles: int):
    """Stage 5: stable tile sort of the pool -> (packed (8, pool) int32
    with row 7 zero, starts (T,) int32, ends (T,) int32)."""
    skeys, perm = torch.sort(keys, stable=True)
    packed = torch.zeros_like(recs)
    packed[:PACK_ROWS - 1] = recs[:PACK_ROWS - 1][:, perm]
    bounds = torch.arange(num_tiles + 1, dtype=skeys.dtype,
                          device=skeys.device)
    bins = torch.searchsorted(skeys, bounds).to(torch.int32)
    return packed, bins[:-1].contiguous(), bins[1:].contiguous()


def infer_pipeline(attrs9, decode, depth_key, tiles_x: int, num_tiles: int,
                   max_isects: int):
    """The whole inference pipeline. Returns (img_tiles (T, 256, 4),
    total, raw_total): total is the live records clamped to the pool,
    raw_total the unclamped count (raw_total - total were dropped)."""
    if attrs9.requires_grad:
        raise ValueError(
            "the record pipeline is inference-only: gradients through the "
            "kernels are not ported yet (slice 2)")
    if tiles_x > 1023 or num_tiles > tiles_x * 2047:
        raise ValueError("image too large for the packed decode rows")
    f5, u5, cum, total, raw_total = depth_order(attrs9, decode, depth_key,
                                                max_isects)
    keys, recs = expand(f5, u5, cum, total, tiles_x, num_tiles, max_isects)
    packed, starts, ends = tile_bins(keys, recs, num_tiles)
    img, _log_t, _fidx = rasterize_fwd(packed, starts, ends, tiles_x)
    return img, total[0], raw_total
