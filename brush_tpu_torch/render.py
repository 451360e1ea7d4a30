"""The render (port of brush_tpu/render.py, render_splats).

Stages of the record pipeline (backend "pallas" or "auto"): project all
splats densely with a validity mask; SH colour and opacity; the exact
per-tile pretest (64-bit coverage masks); the depth key and the packed
decode rows; then the record pipeline (ops/pipeline.py: sort -> expand
kernel -> sort -> rasterize_fwd kernel); the tiles are assembled into the
image. With cell=(gw, gh) the pretest, the decode rows and the whole
record pipeline work in raster cells of gw x gh tiles (one record per
(splat, cell)); cell (1, 1) is the tile path.

The XLA backend (backend "xla", render.py:299-331 of the reference): the
same projection, SH colour and opacity, then exact float32 binning
(ops/binning.build_intersections) and the lockstep tiled rasterizer with
its hand-written backward (ops/rasterize_tiled.py), plain PyTorch on any
device: no quantized records, no colour clamp, no rounded pool.

Differentiation (needs_grad=True): on the card the projection and the SH
colour are autograd Functions over their kernels (plain autograd on the
CPU); the record pipeline is the custom autograd Function RecordPipeline
(rasterize_bwd and segment_sum kernels), the XLA rasterizer the Function
rasterize_tiled.TiledRaster. The tile pretest, the depth key, the decode
rows and the binning are integer bookkeeping built from detached tensors,
as the reference builds them from stop_gradient values. The reference
threads a zero `xy_dummy` through the render so screen-space gradients
surface for densification (render.py:22-25): it is added to the projected
centres, so d(loss)/d(xy_dummy) lands at global splat indices.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from brush_tpu_torch.constants import TILE_WIDTH
from brush_tpu_torch.device import full_f32
from brush_tpu_torch.ops.binning import (
    Intersections, TileMasks, build_intersections, cell_bbox,
    precompute_tile_masks,
)
from brush_tpu_torch.ops.cuda import projection as cuda_projection
from brush_tpu_torch.ops.cuda.rasterize_fwd import check_cell
from brush_tpu_torch.ops.pipeline import RecordPipeline, infer_pipeline
from brush_tpu_torch.ops.projection import (
    Projection, normalize_quats, project_splats,
)
from brush_tpu_torch.ops.rasterize_reference import CameraParams
from brush_tpu_torch.ops.sh import view_colors
from brush_tpu_torch.utils.profiler import count, grad_span, mark, span

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


def project_inputs(means, log_scales, quats, sh_coeffs, raw_opacity,
                   cam: CameraParams, img_size, xy_dummy=None, active=None):
    """The differentiable per-splat stages (render.py:250-273): the
    projection and the SH colour in float32 with TF32 off, the sigmoid
    opacity, and the centres plus xy_dummy. Returns (proj, color, opac,
    xy). CUDA tensors take the projection's kernels (ops/cuda/
    projection.project), CPU tensors the plain code. Spans `project` and
    `sh` time the two parts, and while recording `backward/project` and
    `backward/sh` their backward."""
    bwd_proj, bwd_sh = grad_span("backward/project"), grad_span("backward/sh")
    with full_f32():
        with span("project"):
            means_p, scales_p, quats_p = bwd_proj.inputs(
                means, log_scales, quats)
            if means.device.type == "cuda":
                proj = cuda_projection.project(
                    means_p, scales_p, quats_p, cam.viewmat, cam.focal,
                    cam.pixel_center, img_size, active=active)
            else:
                proj = project_splats(
                    means_p, scales_p, normalize_quats(quats_p),
                    cam.viewmat, cam.focal, cam.pixel_center, img_size,
                    active=active,
                )
            xy, conic = bwd_proj.outputs(proj.xy, proj.conic)
            proj = proj._replace(xy=xy, conic=conic)
        with span("sh"):
            color = bwd_sh.outputs(view_colors(
                means, bwd_sh.inputs(sh_coeffs), cam))
    opac = torch.sigmoid(raw_opacity)
    xy = proj.xy if xy_dummy is None else proj.xy + xy_dummy
    return proj, color, opac, xy


def detached(proj: Projection) -> Projection:
    return Projection(*(t.detach() for t in proj))


def record_inputs(means, log_scales, quats, sh_coeffs, raw_opacity,
                  cam: CameraParams, img_size, xy_dummy=None,
                  active=None, cell=(1, 1)) -> RecordInputs:
    """project_inputs, then the tile pretest, the depth key and the decode
    rows (render.py:275-285), the pretest and the decode rows in units of
    cell=(gw, gh). Only attrs9 carries gradients: the pretest, the depth
    key and the decode rows see detached tensors (render.py:275-277,
    :168), so autograd records none of the pretest's (8, 8, N) float
    work. Spans: project_inputs' two, then `tile_pretest` and `pack`."""
    proj, color, opac, xy = project_inputs(
        means, log_scales, quats, sh_coeffs, raw_opacity, cam, img_size,
        xy_dummy=xy_dummy, active=active)
    proj_sg = detached(proj)
    with span("tile_pretest"):
        masks = precompute_tile_masks(proj_sg, opac.detach(), cell=cell)
    with span("pack"):
        producing = proj_sg.visible & (masks.counts > 0)
        counts_g = torch.where(producing, masks.counts, 0)
        # Positive float32 bits order like the floats; int64 keeps the
        # 0xFFFFFFFF sentinel past every real key (as int32 it would be
        # -1).
        depth_bits = torch.clamp(proj_sg.depth, min=1e-20).view(torch.int32)
        depth_key = torch.where(producing, depth_bits.to(torch.int64),
                                U32_MAX)
        attrs9 = torch.stack([
            xy[:, 0], xy[:, 1], proj.conic[:, 0], proj.conic[:, 1],
            proj.conic[:, 2], color[:, 0], color[:, 1], color[:, 2], opac,
        ])
        decode = pack_decode_rows(proj_sg, masks, counts_g, cell=cell)
    return RecordInputs(attrs9, decode, depth_key, proj_sg, producing,
                        masks)


def xla_tiles(attrs: torch.Tensor, isect: Intersections, tiles_x: int,
              max_isects: int, block_size: int, first_tile: int = 0,
              count: int | None = None) -> torch.Tensor:
    """The XLA rasterizer over tiles [first_tile, first_tile + count) of
    the binned frame (all of it by default): attrs (N, 9) in global order
    (x, y, cxx, cxy, cyy, r, g, b, opac), gathered into depth order by one
    differentiable row gather (render.py:311-315); tiles past the frame
    render empty. Returns (count, 256, 4)."""
    from brush_tpu_torch.ops.rasterize_tiled import make_rasterizer

    num_tiles = isect.starts.shape[0]
    count = num_tiles if count is None else count
    a = attrs[isect.order]
    pad = max(first_tile + count - num_tiles, 0)
    starts = torch.nn.functional.pad(isect.starts, (0, pad))
    ends = torch.nn.functional.pad(isect.ends, (0, pad))
    sl = slice(first_tile, first_tile + count)
    tile_ids = torch.arange(first_tile, first_tile + count,
                            dtype=torch.int64, device=attrs.device)
    raster = make_rasterizer(tiles_x, count, max_isects, block_size)
    return raster(a[:, 0:2], a[:, 2:5], a[:, 5:8], a[:, 8], isect.isect_gid,
                  starts[sl], ends[sl], tile_ids)


def _render_xla(means, log_scales, quats, sh_coeffs, raw_opacity, cam,
                img_size, xy_dummy, active, max_isects, block_size):
    """The XLA backend (render.py:299-331): exact binning on the detached
    projection and opacity (align 1), the (N, 9) row gather into depth
    order, the tiled rasterizer, the image."""
    tiles_x = -(-int(img_size[0]) // TILE_WIDTH)
    tiles_y = -(-int(img_size[1]) // TILE_WIDTH)
    with span("project_inputs"):
        proj, color, opac, xy = project_inputs(
            means, log_scales, quats, sh_coeffs, raw_opacity, cam, img_size,
            xy_dummy=xy_dummy, active=active)
    isect = build_intersections(detached(proj), opac.detach(),
                                (tiles_x, tiles_y), max_isects, align=1)
    mark("binning")
    attrs = torch.cat([xy, proj.conic, color, opac[:, None]], dim=1)
    img_tiles = xla_tiles(attrs, isect, tiles_x, max_isects, block_size)
    mark("xla raster")
    aux = RenderAux(
        num_visible=isect.num_visible,
        num_isects=isect.num_isects,
        num_dropped=isect.num_dropped,
        visible=proj.visible,
        order=isect.order,
        producing=isect.producing,
    )
    img = assemble_image(img_tiles, img_size, tiles_x, tiles_y)
    mark("assemble")
    return img, aux


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
    quats are normalized internally.

    backend selects the path, on CPU and CUDA tensors alike:
    - "pallas" and "auto": the record pipeline through the kernel
      wrappers, which launch the CUDA kernels on CUDA tensors and run
      their plain PyTorch versions on CPU tensors. The pool (max_isects,
      default default_max_isects) rounds up to a multiple of lcm(max(128,
      block_size), 512) exactly as the reference's record pipeline does,
      so num_dropped agrees; block_size also sets the scan's k_lanes
      (scan_passes below). Unlike
      the reference's "auto", which takes its XLA path on the CPU
      (render.py:236-237), "auto" is the record pipeline on every device:
      on the CPU the kernels' plain versions are what stands for the card.
    - "xla": the reference's XLA path in plain PyTorch (see the module
      docstring): colour and opacity in float32 without quantization or
      clamp, rounds of block_size records, the pool exactly max_isects.
      cell, pack_grad_sort and needs_grad=False's inference pipeline do
      not apply; needs_grad=False runs it without autograd. No backend
      falls back to another.
    scan_passes (the record pipeline's; "xla" takes none) is the TPU
    kernels' log-T scan: the default 2, as in the reference, scans each
    batch of k_lanes = max(128, block_size) records from its terms cut to
    two bfloat16 parts (about 16 mantissa bits), 3 is exact; both
    rasterizers follow it (ops/pipeline.py). bwd_tiles_per_step is
    accepted and does nothing: the backward takes no tiles-per-step knob.
    needs_grad=True renders the record pipeline through the differentiable
    RecordPipeline (pack_grad_sort: the backward's conic and colour
    cotangents ride the grad re-sort as bf16 pairs, the reference's
    default; False keeps them float32); needs_grad=False through the
    inference pipeline, which refuses inputs that require grad and returns
    aux.order as zeros.
    cell=(gw, gh) rasterizes in raster cells of gw x gh tiles: one record
    per (splat, cell), P = 256 gw gh pixels swept per record; (1, 1) is
    the tile path. The image is the same but for alpha-threshold flips
    and, as in the reference, the fringe of an opaque splat past its
    3-sigma tile bbox, which a cell's bbox (rounded out to whole cells)
    reaches.
    """
    del bwd_tiles_per_step   # a documented no-op
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "xla":
        if max_isects is None:
            max_isects = default_max_isects(means.shape[0], img_size)
        with contextlib.nullcontext() if needs_grad else torch.no_grad():
            return _render_xla(means, log_scales, quats, sh_coeffs,
                               raw_opacity, cam, img_size, xy_dummy, active,
                               max_isects, block_size)
    cell = check_cell(cell)
    n = means.shape[0]
    w, h = int(img_size[0]), int(img_size[1])
    tiles_x = -(-w // TILE_WIDTH)
    tiles_y = -(-h // TILE_WIDTH)
    cells_x = -(-tiles_x // cell[0])
    cells_y = -(-tiles_y // cell[1])
    max_isects = pool_size(n, img_size, max_isects, block_size)
    k_lanes = max(128, block_size)   # render.py:241

    with span("record_inputs"):
        rec = record_inputs(means, log_scales, quats, sh_coeffs, raw_opacity,
                            cam, img_size, xy_dummy=xy_dummy, active=active,
                            cell=cell)
    proj, producing = rec.proj, rec.producing
    num_cells = cells_x * cells_y
    if needs_grad:
        img_cells, order, total, raw_total = RecordPipeline.apply(
            rec.attrs9, rec.decode, rec.depth_key, cells_x, num_cells,
            max_isects, pack_grad_sort, cell, 0, None, scan_passes,
            k_lanes)
    else:
        img_cells, total, raw_total = infer_pipeline(
            rec.attrs9, rec.decode, rec.depth_key, cells_x, num_cells,
            max_isects, cell, scan_passes=scan_passes, k_lanes=k_lanes)
        order = torch.zeros(n, dtype=torch.int64, device=means.device)

    with span("assemble"):
        aux = RenderAux(
            num_visible=proj.visible.sum().to(torch.int32),
            num_isects=total,
            num_dropped=torch.clamp(raw_total - max_isects, min=0),
            visible=proj.visible,
            order=order,
            producing=producing,
        )
        img = assemble_image(img_cells, img_size, cells_x, cells_y, cell)
    count("rows", n)
    count("visible", aux.num_visible)
    count("records", total)
    count("pool_slots", max_isects)
    return img, aux
