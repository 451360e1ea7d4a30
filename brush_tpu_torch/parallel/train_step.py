"""The sharded train step (port of brush_tpu/parallel/train_step.py,
make_sharded_train_step with its record-pipeline loss).

Dataflow of a step on each rank (sharding.py gives the decomposition):

  row-sharded:  projection, SH, sigmoid and the exact cell pretest on this
                rank's block of splat rows (render.record_inputs);
  all-gather:   the nine attribute rows (GatherColumns, differentiable)
                and six packed metadata rows (no gradient) of every rank;
  strip-local:  the coverage masks restricted to this rank's strip of cell
                rows (ops/binning.restrict_masks_parts), the decode rows
                packed from them, and the record pipeline (depth sort,
                expand, tile sort, both rasterizers, backward) over a pool
                of the strip's records only: from the expand on, a rank's
                work follows its strip's share of the records; only the
                N-long depth sort is common work;
  all-gather:   the image strips (GatherStrips), assembled into the image;
                every rank computes the same loss;
  backward:     each rank's strip pool gives gradient records, summed per
                splat by segment_sum; GatherColumns' backward
                reduce-scatters the per-splat cotangents to the rows' own
                rank, where the densification statistics and Adam run.

Strips are whole rows of raster cells, ceil(cells_y / ranks) rows each, so
the last ranks may own strips that run past the image (their cells render
empty).

backend="xla" (the reference's `_loss_xla`, :251-312) replaces the strip
pipeline by the XLA backend of render_splats: each rank projects its rows,
gathers the attributes (GatherColumns) and the detached projection, bins
the whole frame (build_intersections over every splat, the same on every
rank), rasterizes its contiguous ceil(tiles_y / ranks) rows of tiles with
the tiled rasterizer and gathers the image tiles (GatherStrips). Its
stats are the frame's (replicated, not summed), and max_strip_isects is
the frame's record count: the binning is not strip-local. It ignores
`cell` (single-tile blocks), as the reference's does.
"""

from __future__ import annotations

import math

import torch

from brush_tpu_torch.config import TrainConfig
from brush_tpu_torch.constants import TILE_WIDTH
from brush_tpu_torch.device import full_f32
from brush_tpu_torch.ops.binning import (
    build_intersections, cell_bbox, restrict_masks_parts,
)
from brush_tpu_torch.ops.cuda.rasterize_fwd import check_cell, to_i32_bits
from brush_tpu_torch.ops.pipeline import RecordPipeline
from brush_tpu_torch.ops.projection import Projection
from brush_tpu_torch.ops.rasterize_reference import CameraParams
from brush_tpu_torch.parallel.sharding import (
    GatherColumns, GatherStrips, Mesh, gather_columns,
)
from brush_tpu_torch.render import (
    BACKENDS, U32_MAX, assemble_image, default_max_isects, pack_decode_parts,
    project_inputs, record_inputs, xla_tiles,
)
from brush_tpu_torch.ssim import Ssim
from brush_tpu_torch.train import (
    StepStats, TrainState, image_loss, trainable, update_state,
)
from brush_tpu_torch.utils.profiler import mark

def meta_rows(rec, cell) -> torch.Tensor:
    """The six u32 rows a rank gathers, as int32 bits (train_step.py:
    173-188), in cell units: [cmin_x | cmin_y << 16, bbox_w | bbox_h << 16,
    counts | small << 31, mask_lo, mask_hi, depth key]."""
    cmin_x, cmin_y, cmax_x, cmax_y = cell_bbox(rec.proj, cell)
    bbox_w = torch.clamp(cmax_x - cmin_x, 1, 1023)
    bbox_h = torch.clamp(cmax_y - cmin_y, min=1)
    counts = torch.where(rec.producing, rec.masks.counts, 0)
    return to_i32_bits(torch.stack([
        cmin_x | (cmin_y << 16), bbox_w | (bbox_h << 16),
        counts | (rec.masks.small.to(torch.int64) << 31),
        rec.masks.mask_lo, rec.masks.mask_hi, rec.depth_key]))


def strip_decode(meta: torch.Tensor, row_lo: int, row_hi: int):
    """Gathered meta rows -> (decode (3, N), depth_key (N,)), both int64
    u32 values, restricted to the cell rows [row_lo, row_hi)
    (train_step.py:190-212): a splat with no record in the strip gets the
    sentinel depth key and empty decode rows."""
    u = meta.to(torch.int64) & U32_MAX
    tmin_x, tmin_y = u[0] & 0xFFFF, u[0] >> 16
    bbox_w, bbox_h = u[1] & 0xFFFF, u[1] >> 16
    counts, small = u[2] & 0x7FFFFFFF, (u[2] >> 31) == 1
    counts_d, m_lo, m_hi, tmin_y_d, bbox_h_d = restrict_masks_parts(
        tmin_y, bbox_w, bbox_h, small, u[3], u[4], counts, row_lo, row_hi)
    decode = pack_decode_parts(tmin_x, tmin_y_d, bbox_w, bbox_h_d, counts_d,
                               small, m_lo, m_hi)
    return decode, torch.where(counts_d > 0, u[5], U32_MAX)


def strip_pool(max_isects: int, slack: float, ranks: int,
               block_size: int) -> int:
    """A strip's record pool (train_step.py:110-115): its share of
    max_isects times the slack, at most max_isects, rounded up as
    render.pool_size rounds the whole frame's, so num_dropped agrees."""
    k_align = math.lcm(max(128, block_size), 512)
    pool = min(max_isects, int(max_isects * slack / ranks))
    return max(-(-pool // k_align) * k_align, k_align)


def make_sharded_train_step(
    mesh: Mesh,
    config: TrainConfig,
    capacity: int,
    img_size,
    channels: int,
    sh_count: int,
    max_isects: int | None = None,
    block_size: int = 32,
    backend: str = "auto",
    strip_pool_slack: float = 2.0,
    cell=(1, 1),
    pack_grad_sort: bool = True,
):
    """Build the sharded train step of a capacity-`capacity` model on the
    mesh's ranks.

    Returns step(state, gt, viewmat, focal, pixel_center, lr_mean, step_idx)
    -> (state, StepStats), where `state` holds this rank's block of
    capacity / ranks rows (shard_state) and n_live counts the whole model;
    every rank calls it with the same ground truth and camera. The stats
    count every rank: num_visible, num_isects and num_dropped are sums,
    max_strip_isects the largest unclamped strip record count (on the
    "xla" path the frame's counts, its pool max_isects).
    strip_pool_slack over-provisions each strip's pool against an uneven
    spread of records (ShardedTrainer adapts it). cell=(gw, gh): strips are
    rows of raster cells (see render_splats). backend: "pallas" and "auto"
    the strip pipeline, "xla" the replicated binning and the tiled
    rasterizer (see the module docstring), on CPU and CUDA tensors alike.
    """
    n_dev = mesh.size
    if capacity % n_dev:
        raise ValueError(f"capacity {capacity} not divisible by mesh size "
                         f"{n_dev}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    cell = check_cell(cell)
    rows_per = capacity // n_dev
    tiles_x = -(-int(img_size[0]) // TILE_WIDTH)
    tiles_y = -(-int(img_size[1]) // TILE_WIDTH)
    cells_x, cells_y = -(-tiles_x // cell[0]), -(-tiles_y // cell[1])
    num_cells = cells_x * cells_y
    strip_crows = -(-cells_y // n_dev)
    cells_per = strip_crows * cells_x
    row_lo = mesh.rank * strip_crows
    tile_base = mesh.rank * cells_per
    if max_isects is None:
        max_isects = default_max_isects(capacity, img_size)
    pool = strip_pool(max_isects, strip_pool_slack, n_dev, block_size)
    ssim = Ssim(config.ssim_window_size, 3)
    rows = mesh.rank * rows_per + torch.arange(rows_per, device=mesh.device)

    strip_rows = -(-tiles_y // n_dev)      # the XLA path's tile rows
    tiles_per = strip_rows * tiles_x

    def render_strips(params, xy_dummy, cam, active):
        """The strip pipeline: (image, producing rows, stats after the
        backward)."""
        rec = record_inputs(
            params["means"], params["log_scales"], params["quats"],
            params["sh_coeffs"], params["raw_opacity"], cam, img_size,
            xy_dummy=xy_dummy, active=active, cell=cell)
        mark("record_inputs")
        attrs9 = GatherColumns.apply(rec.attrs9, mesh)
        decode, depth_key = strip_decode(
            gather_columns(meta_rows(rec, cell), mesh), row_lo,
            row_lo + strip_crows)
        mark("strip_inputs")
        # make_pallas_pipeline's default scan_passes=2 over batches of
        # max(128, block_size) (brush_tpu/parallel/train_step.py:107-120).
        img_l, _, total, raw_total = RecordPipeline.apply(
            attrs9, decode, depth_key, cells_x, num_cells, pool,
            pack_grad_sort, cell, tile_base, cells_per, 2,
            max(128, block_size))
        img = assemble_image(GatherStrips.apply(img_l, mesh)[:num_cells],
                             img_size, cells_x, cells_y, cell)
        mark("assemble")

        def stats():
            # One gather of every rank's (records, dropped, visible,
            # unclamped records): sums and the largest strip, without
            # waiting.
            mine = torch.stack([
                total.to(torch.int64),
                torch.clamp(raw_total - pool, min=0).to(torch.int64),
                rec.proj.visible.sum().to(torch.int64),
                raw_total.to(torch.int64)])
            every = gather_columns(mine[:, None], mesh)
            sums = every.sum(dim=1).to(torch.int32)
            return (sums[2], sums[0], sums[1],
                    every[3].max().to(torch.int32))

        return img, rec.producing, stats

    def render_xla(params, xy_dummy, cam, active):
        """The reference's _loss_xla: replicated binning, this rank's rows
        of tiles through the tiled rasterizer."""
        proj, color, opac, xy = project_inputs(
            params["means"], params["log_scales"], params["quats"],
            params["sh_coeffs"], params["raw_opacity"], cam, img_size,
            xy_dummy=xy_dummy, active=active)
        attrs = GatherColumns.apply(torch.stack([
            xy[:, 0], xy[:, 1], proj.conic[:, 0], proj.conic[:, 1],
            proj.conic[:, 2], color[:, 0], color[:, 1], color[:, 2], opac,
        ]), mesh).t()
        f = gather_columns(torch.cat([
            proj.xy.t(), proj.depth[None], proj.conic.t()]).detach(), mesh)
        i = gather_columns(torch.cat([
            proj.radius[None], proj.tile_min.t(), proj.tile_max.t(),
            proj.visible[None].to(torch.int32)]), mesh)
        proj_f = Projection(xy=f[0:2].t(), depth=f[2], conic=f[3:6].t(),
                            radius=i[0], tile_min=i[1:3].t(),
                            tile_max=i[3:5].t(), visible=i[5] > 0)
        mark("project_inputs")
        isect = build_intersections(proj_f, attrs[:, 8].detach(),
                                    (tiles_x, tiles_y), max_isects, align=1)
        mark("binning")
        img_l = xla_tiles(attrs, isect, tiles_x, max_isects, block_size,
                          mesh.rank * tiles_per, tiles_per)
        mark("xla raster")
        img = assemble_image(
            GatherStrips.apply(img_l, mesh)[:tiles_x * tiles_y], img_size,
            tiles_x, tiles_y)
        mark("assemble")
        producing = isect.producing[mesh.rank * rows_per:
                                    (mesh.rank + 1) * rows_per]
        # The frame's stats on every rank; the pool is the frame's, so the
        # peak per-rank demand is the frame's record count (:309-311).
        return img, producing, lambda: (
            isect.num_visible, isect.num_isects, isect.num_dropped,
            isect.num_isects)

    render_rows = render_xla if backend == "xla" else render_strips

    def step(state: TrainState, gt, viewmat, focal, pixel_center,
             lr_mean: float, step_idx: int):
        splats = state.splats
        if splats.capacity != rows_per:
            raise ValueError(f"state holds {splats.capacity} rows, this "
                             f"rank's block is {rows_per}")
        params, xy_dummy = trainable(splats)
        cam = CameraParams(viewmat, focal, pixel_center)
        with full_f32():
            img, producing, stats = render_rows(
                params, xy_dummy, cam, rows < splats.n_live)
            loss = image_loss(img, gt, channels, config, ssim)
            mark("loss")
            loss.backward()
            mark("autograd rest")
        num_visible, num_isects, num_dropped, max_strip = stats()
        new_state = update_state(config, state, params, xy_dummy,
                                 producing, step_idx, img_size, lr_mean)
        return new_state, StepStats(
            loss=loss.detach(), num_visible=num_visible,
            num_isects=num_isects, num_dropped=num_dropped,
            max_strip_isects=max_strip)

    return step
