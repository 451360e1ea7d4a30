"""The render (port of brush_tpu/render.py, render_splats with
backend="pallas").

Stages: project all splats densely with a validity mask; SH colour and
opacity; the exact per-tile pretest (64-bit coverage masks); the depth key
and the packed decode rows; then the record pipeline (ops/pipeline.py:
sort -> expand kernel -> sort -> rasterize_fwd kernel); the tiles are
assembled into the image. With cell=(gw, gh) the pretest, the decode rows
and the whole record pipeline work in raster cells of gw x gh tiles (one
record per (splat, cell)); cell (1, 1) is the tile path.

Differentiation (needs_grad=True): projection and SH are plain autograd;
the record pipeline is the custom autograd Function RecordPipeline
(rasterize_bwd and segment_sum kernels). The tile pretest, the depth key
and the decode rows are integer bookkeeping built from detached tensors,
as the reference builds them from stop_gradient values. The reference
threads a zero `xy_dummy` through the render so screen-space gradients
surface for densification (render.py:22-25): it is added to the projected
centres, so d(loss)/d(xy_dummy) lands at global splat indices.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from brush_tpu_torch.constants import TILE_WIDTH
from brush_tpu_torch.device import full_f32
from brush_tpu_torch.ops.binning import (
    TileMasks, cell_bbox, precompute_tile_masks,
)
from brush_tpu_torch.ops.cuda.rasterize_fwd import check_cell
from brush_tpu_torch.ops.pipeline import RecordPipeline, infer_pipeline
from brush_tpu_torch.ops.projection import Projection, project_splats
from brush_tpu_torch.ops.rasterize_reference import (
    CameraParams, normalize_quats, view_colors,
)
from brush_tpu_torch.utils.profiler import mark

U32_MAX = 0xFFFFFFFF


class RenderAux(NamedTuple):
    """Side outputs of a render (reference: RenderAux, lib.rs:21-33)."""

    num_visible: torch.Tensor  # () int32
    num_isects: torch.Tensor   # () int32
    num_dropped: torch.Tensor  # () int32 records lost to pool overflow
    visible: torch.Tensor      # (N,) bool, global order
    order: torch.Tensor        # (N,) int64 compact -> global (depth order);
                               # zeros when rendered with needs_grad=False
    producing: torch.Tensor    # (N,) bool, global order: emits >= 1 record


def default_max_isects(n: int, img_size, cap: int = 1 << 23) -> int:
    """Static intersection-pool size (render.py:55-70): 8 slots a splat,
    at least 64k, at most one per (splat, tile) and `cap`."""
    tiles = ((-(-int(img_size[0]) // TILE_WIDTH))
             * (-(-int(img_size[1]) // TILE_WIDTH)))
    return min(max(n * 8, 64 * 1024), n * tiles, cap)


def pool_size(n: int, img_size, max_isects: int | None = None,
              block_size: int = 32) -> int:
    """The record pool render_splats allocates: max_isects (default
    default_max_isects) rounded up to a multiple of lcm(max(128,
    block_size), 512), as the reference's record pipeline rounds it
    (render.py:240-246), so num_dropped agrees with it."""
    if max_isects is None:
        max_isects = default_max_isects(n, img_size)
    k_align = math.lcm(max(128, block_size), 512)
    return -(-max_isects // k_align) * k_align


def pack_decode_parts(tmin_x, tmin_y, bbox_w, bbox_h, counts, small, m_lo,
                      m_hi) -> torch.Tensor:
    """(3, n) u32 decode rows as int64 values:
      row 0: tmin_x (10b) | small << 10 | tmin_y << 11 (11b) | bbox_w << 22
      row 1: mask_lo for small splats, the bbox height for bbox splats
      row 2: mask_hi
    Rows 1-2 are zero for splats that produce no record."""
    i64 = lambda v: v.to(torch.int64)
    small = small.to(torch.bool)
    prod = counts > 0
    d0 = (i64(tmin_x) | (i64(small) << 10) | (i64(tmin_y) << 11)
          | (i64(bbox_w) << 22)) & U32_MAX
    stash = torch.where(small, i64(m_lo), i64(bbox_h))
    d1 = torch.where(prod, stash, 0)
    d2 = torch.where(prod, i64(m_hi), 0)
    return torch.stack([d0, d1, d2], dim=0)


def pack_decode_rows(proj, masks, counts_g, cell=(1, 1)) -> torch.Tensor:
    """Per-splat decode state for the expand kernel (render.py:73-106)."""
    cmin_x, cmin_y, cmax_x, cmax_y = cell_bbox(proj, cell)
    bbox_w = torch.clamp(cmax_x - cmin_x, 1, 1023)
    bbox_h = torch.clamp(cmax_y - cmin_y, min=1)
    return pack_decode_parts(cmin_x, cmin_y, bbox_w, bbox_h, counts_g,
                             masks.small, masks.mask_lo, masks.mask_hi)


def pack_rgba_u32(img: torch.Tensor) -> torch.Tensor:
    """(h, w, 4) float RGBA -> (h, w) packed RGBA8 words, returned as
    int32 bit patterns (so `.numpy().view(np.uint8)` gives the bytes)."""
    q = torch.clamp(img * 255.0, 0.0, 255.0).to(torch.int64)
    v = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def assemble_image(img_tiles: torch.Tensor, img_size, tiles_x: int,
                   tiles_y: int, cell=(1, 1)) -> torch.Tensor:
    """(T, P, 4) -> (h, w, 4), cropping the padding
    (rasterize_tiled.py:263-275). cell=(gw, gh): the blocks are raster
    cells of gw x gh tiles (P = 256 gw gh, row-major over the cell), and
    tiles_x/tiles_y count cells."""
    w, h = int(img_size[0]), int(img_size[1])
    cw, ch = TILE_WIDTH * int(cell[0]), TILE_WIDTH * int(cell[1])
    img = img_tiles.reshape(tiles_y, tiles_x, ch, cw, 4)
    img = img.permute(0, 2, 1, 3, 4).reshape(tiles_y * ch, tiles_x * cw, 4)
    return img[:h, :w]


class RecordInputs(NamedTuple):
    """What the record pipeline takes, in global splat order."""

    attrs9: torch.Tensor     # (9, N) f32: x, y, cxx, cxy, cyy, r, g, b, opac
    decode: torch.Tensor     # (3, N) int64 u32 values (pack_decode_rows)
    depth_key: torch.Tensor  # (N,) int64 depth bits, 2^32-1 if no record
    proj: Projection         # detached
    producing: torch.Tensor  # (N,) bool: emits >= 1 record
    masks: TileMasks         # the exact pretest, in cell units


def record_inputs(means, log_scales, quats, sh_coeffs, raw_opacity,
                  cam: CameraParams, img_size, xy_dummy=None,
                  active=None, cell=(1, 1)) -> RecordInputs:
    """Projection, SH colour, opacity, the tile pretest, the depth key and
    the decode rows (render.py:250-285), in float32 with TF32 off; the
    pretest and the decode rows in units of cell=(gw, gh). Only attrs9
    carries gradients: the pretest, the depth key and the decode rows see
    detached tensors (render.py:275-277, :168), so autograd records none of
    the pretest's (8, 8, N) float work."""
    with full_f32():
        proj = project_splats(
            means, log_scales, normalize_quats(quats),
            cam.viewmat, cam.focal, cam.pixel_center, img_size,
            active=active,
        )
        color = view_colors(means, sh_coeffs, cam)
    opac = torch.sigmoid(raw_opacity)
    xy = proj.xy if xy_dummy is None else proj.xy + xy_dummy

    proj_sg = Projection(*(t.detach() for t in proj))
    masks = precompute_tile_masks(proj_sg, opac.detach(), cell=cell)
    producing = proj_sg.visible & (masks.counts > 0)
    counts_g = torch.where(producing, masks.counts, 0)
    # Positive float32 bits order like the floats; int64 keeps the
    # 0xFFFFFFFF sentinel past every real key (as int32 it would be -1).
    depth_bits = torch.clamp(proj_sg.depth, min=1e-20).view(torch.int32)
    depth_key = torch.where(producing, depth_bits.to(torch.int64), U32_MAX)
    attrs9 = torch.stack([
        xy[:, 0], xy[:, 1], proj.conic[:, 0], proj.conic[:, 1],
        proj.conic[:, 2], color[:, 0], color[:, 1], color[:, 2], opac,
    ])
    decode = pack_decode_rows(proj_sg, masks, counts_g, cell=cell)
    return RecordInputs(attrs9, decode, depth_key, proj_sg, producing,
                        masks)


BACKENDS = ("auto", "pallas", "xla")


def render_splats(
    means: torch.Tensor,
    log_scales: torch.Tensor,
    quats: torch.Tensor,
    sh_coeffs: torch.Tensor,
    raw_opacity: torch.Tensor,
    cam: CameraParams,
    img_size,
    xy_dummy: torch.Tensor | None = None,
    active: torch.Tensor | None = None,
    max_isects: int | None = None,
    block_size: int = 32,
    backend: str = "auto",
    scan_passes: int = 2,
    pack_grad_sort: bool = True,
    cell: tuple = (1, 1),
    needs_grad: bool = True,
    bwd_tiles_per_step: int | None = None,
) -> tuple[torch.Tensor, RenderAux]:
    """Render (h, w, 4) RGBA on the tensors' device; img_size is (w, h).

    The arguments are the reference's (brush_tpu/render.py:185-202).
    quats are normalized internally. The pool (max_isects, default
    default_max_isects) rounds up to a multiple of lcm(max(128,
    block_size), 512) exactly as the reference's record pipeline does, so
    num_dropped agrees; block_size has no other effect here.
    backend is checked and selects nothing: the record pipeline always
    runs through the kernel wrappers, which launch the CUDA kernels on
    CUDA tensors and run their plain PyTorch versions on CPU tensors.
    "xla" (the reference's plain path) is refused on CUDA tensors, where
    the port has no plain path. scan_passes and bwd_tiles_per_step are
    accepted and do nothing: the port computes what scan_passes=3 computes
    (the log-T scan's truncation at 2 is not reproduced), and the backward
    takes no tiles-per-step knob.
    needs_grad=True renders through the differentiable RecordPipeline
    (pack_grad_sort: the backward's conic and colour cotangents ride the
    grad re-sort as bf16 pairs, the reference's default; False keeps them
    float32); needs_grad=False through the inference pipeline, which
    refuses inputs that require grad and returns aux.order as zeros.
    cell=(gw, gh) rasterizes in raster cells of gw x gh tiles: one record
    per (splat, cell), P = 256 gw gh pixels swept per record; (1, 1) is
    the tile path. The image is the same but for alpha-threshold flips
    and, as in the reference, the fringe of an opaque splat past its
    3-sigma tile bbox, which a cell's bbox (rounded out to whole cells)
    reaches.
    """
    del scan_passes, bwd_tiles_per_step   # documented no-ops
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "xla" and means.is_cuda:
        raise ValueError('backend="xla" runs on CPU tensors only: on the '
                         "card the record pipeline is the CUDA kernels")
    cell = check_cell(cell)
    n = means.shape[0]
    w, h = int(img_size[0]), int(img_size[1])
    tiles_x = -(-w // TILE_WIDTH)
    tiles_y = -(-h // TILE_WIDTH)
    cells_x = -(-tiles_x // cell[0])
    cells_y = -(-tiles_y // cell[1])
    max_isects = pool_size(n, img_size, max_isects, block_size)

    rec = record_inputs(means, log_scales, quats, sh_coeffs, raw_opacity,
                        cam, img_size, xy_dummy=xy_dummy, active=active,
                        cell=cell)
    mark("record_inputs")
    proj, producing = rec.proj, rec.producing
    num_cells = cells_x * cells_y
    if needs_grad:
        img_cells, order, total, raw_total = RecordPipeline.apply(
            rec.attrs9, rec.decode, rec.depth_key, cells_x, num_cells,
            max_isects, pack_grad_sort, cell)
    else:
        img_cells, total, raw_total = infer_pipeline(
            rec.attrs9, rec.decode, rec.depth_key, cells_x, num_cells,
            max_isects, cell)
        order = torch.zeros(n, dtype=torch.int64, device=means.device)

    aux = RenderAux(
        num_visible=proj.visible.sum().to(torch.int32),
        num_isects=total,
        num_dropped=torch.clamp(raw_total - max_isects, min=0),
        visible=proj.visible,
        order=order,
        producing=producing,
    )
    img = assemble_image(img_cells, img_size, cells_x, cells_y, cell)
    mark("assemble")
    return img, aux
