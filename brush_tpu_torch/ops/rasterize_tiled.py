"""The tiled rasterizer with its hand-written backward, in plain PyTorch
(port of brush_tpu/ops/rasterize_tiled.py, the JAX package's XLA backend).

The forward mirrors rasterize.wgsl: every tile walks its depth-sorted
record range (ops/binning.build_intersections), compositing front to back
with the sticky 1e-4 transmittance early-out. The backward mirrors
rasterize_backwards.wgsl: one back-to-front sweep that rebuilds T from the
forward's final log T and visits the forward's contributing set through
the per-pixel `final_idx` (rasterize.wgsl:112), with dense (tile, pixel,
record) block math and index_add_ for the per-splat sums.

All tiles advance in lockstep rounds of `block_size` records up to the
longest range; short tiles mask out. Each round builds (T, 256, K) float
temporaries. The JAX package has no Pallas kernel on this path, and this
module has no CUDA kernel: it is the exact float32 render, independent of
the record pipeline's quantized records and kernels.
"""

from __future__ import annotations

import math

import torch

from brush_tpu_torch.constants import (
    ALPHA_EPS, ALPHA_MAX, TILE_SIZE, TILE_WIDTH, TRANSMITTANCE_EPS,
)
from brush_tpu_torch.device import full_f32
from brush_tpu_torch.render import assemble_image  # noqa: F401 (re-export)

LOG_T_EPS = math.log(TRANSMITTANCE_EPS)


def tile_pixel_coords(tile_ids: torch.Tensor, tiles_x: int) -> torch.Tensor:
    """(T, TILE_SIZE, 2) pixel-centre coordinates of the given tiles."""
    tile_ids = tile_ids.to(torch.int64)
    tx = (tile_ids % tiles_x).to(torch.float32)
    ty = torch.div(tile_ids, tiles_x, rounding_mode="floor").to(torch.float32)
    k = torch.arange(TILE_SIZE, device=tile_ids.device)
    px = (k % TILE_WIDTH).to(torch.float32)
    py = torch.div(k, TILE_WIDTH, rounding_mode="floor").to(torch.float32)
    x = tx[:, None] * TILE_WIDTH + px[None, :] + 0.5
    y = ty[:, None] * TILE_WIDTH + py[None, :] + 0.5
    return torch.stack([x, y], dim=-1)


def _block_alpha(pix, bxy, bconic, bopac, lane_mask):
    """(T, P, K) alpha of a round's records at each pixel, 0 where a record
    does not contribute; with vis, the offsets and the conic terms."""
    dx = bxy[:, None, :, 0] - pix[:, :, None, 0]
    dy = bxy[:, None, :, 1] - pix[:, :, None, 1]
    cx = bconic[:, None, :, 0]
    cy = bconic[:, None, :, 1]
    cz = bconic[:, None, :, 2]
    sigma = 0.5 * (cx * dx * dx + cz * dy * dy) + cy * dx * dy
    # Clamped exp: a det < 0 conic can push sigma below -88, where exp(-sigma)
    # is inf and the backward's v_sigma would be NaN (its lanes are masked).
    vis = torch.exp(-torch.clamp(sigma, min=0.0))
    alpha = torch.clamp(bopac[:, None, :] * vis, max=ALPHA_MAX)
    ok = (sigma >= 0.0) & (alpha >= ALPHA_EPS) & lane_mask[:, None, :]
    return torch.where(ok, alpha, 0.0), vis, dx, dy, cx, cy, cz


class _Geometry:
    """The static sizes of one rasterizer (make_rasterizer's arguments)."""

    def __init__(self, tiles_x, num_tiles, max_isects, block_size):
        self.tiles_x = int(tiles_x)
        self.num_tiles = int(num_tiles)
        self.max_isects = int(max_isects)
        self.k = int(block_size)

    def rounds(self, starts, ends) -> int:
        """Rounds of k records up to the longest range: one host read."""
        if self.num_tiles == 0:
            return 0
        return -(-max(int((ends - starts).max()), 0) // self.k)

    def block(self, r, starts, ends, isect_gid, n):
        """Round r's record indices (T, K), lane mask and compact ids. Ids
        out of [0, n) (the aligned layout's padding) are clamped, as the
        reference's gathers clamp them; such lanes are masked."""
        lanes = torch.arange(self.k, device=starts.device)
        idx = starts[:, None] + r * self.k + lanes[None, :]
        lane_mask = idx < ends[:, None]
        gid = isect_gid[torch.clamp(idx, 0, self.max_isects - 1)]
        return idx, lane_mask, torch.clamp(gid, 0, n - 1)


def _forward(geom: _Geometry, xy, conic, color, opac, isect_gid, starts,
             ends, tile_ids):
    """(img (T, P, 4), log T (T, P), final_idx (T, P)) of the tiles."""
    dev = xy.device
    t, p = geom.num_tiles, TILE_SIZE
    starts = starts.to(torch.int64)
    ends = ends.to(torch.int64)
    pix = tile_pixel_coords(tile_ids, geom.tiles_x)
    log_t = torch.zeros((t, p), dtype=torch.float32, device=dev)
    alive = torch.ones((t, p), dtype=torch.bool, device=dev)
    rgb = torch.zeros((t, p, 3), dtype=torch.float32, device=dev)
    final_idx = torch.full((t, p), -1, dtype=torch.int64, device=dev)
    for r in range(geom.rounds(starts, ends)):
        idx, lane_mask, gid = geom.block(r, starts, ends, isect_gid,
                                         xy.shape[0])
        alpha, _, _, _, _, _, _ = _block_alpha(pix, xy[gid], conic[gid],
                                               opac[gid], lane_mask)
        lom = torch.log1p(-alpha)
        log_t_after = log_t[:, :, None] + torch.cumsum(lom, dim=-1)
        # Sticky early-out (rasterize.wgsl:87-90): the crossing record is
        # not composited and the pixel never revives, which keeps the
        # backward's final_idx replay consistent.
        act = alive[:, :, None] & (log_t_after > LOG_T_EPS)
        fac = alpha * torch.exp(log_t_after - lom) * act
        rgb = rgb + torch.bmm(fac, color[gid])
        log_t = log_t + torch.sum(lom * act, dim=-1)
        alive = alive & (log_t_after[..., -1] > LOG_T_EPS)
        contributed = act & (alpha > 0.0)
        final_idx = torch.maximum(final_idx, torch.where(
            contributed, idx[:, None, :], -1).amax(dim=-1))
    img = torch.cat([rgb, (1.0 - torch.exp(log_t))[..., None]], dim=-1)
    return img, log_t, final_idx


def _backward(geom: _Geometry, g, xy, conic, color, opac, isect_gid, starts,
              ends, tile_ids, log_t_final, final_idx):
    """Gradients (v_xy, v_conic, v_color, v_opac) of the compact splats
    from the image cotangent g (T, P, 4)."""
    dev = xy.device
    n = xy.shape[0]
    starts = starts.to(torch.int64)
    ends = ends.to(torch.int64)
    v_rgb = g[..., :3].contiguous()
    v_a = g[..., 3]
    t_final = torch.exp(log_t_final)
    pix = tile_pixel_coords(tile_ids, geom.tiles_x)
    v_xy = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    v_conic = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    v_color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    v_opac = torch.zeros((n,), dtype=torch.float32, device=dev)
    log_t_end = log_t_final            # log T after every later record
    s_behind = torch.zeros_like(t_final)   # (colour . v_rgb) behind
    for r in reversed(range(geom.rounds(starts, ends))):
        idx, lane_mask, gid = geom.block(r, starts, ends, isect_gid, n)
        bcolor = color[gid]
        bopac = opac[gid]
        alpha, vis, dx, dy, cx, cy, cz = _block_alpha(
            pix, xy[gid], conic[gid], bopac, lane_mask)
        # The forward's contributing set, through final_idx
        # (rasterize_backwards.wgsl:229 `isect_id <= final_isect`).
        act = (idx[:, None, :] <= final_idx[:, :, None]) & (alpha > 0.0)
        m = torch.log1p(-alpha) * act
        m_inc = torch.cumsum(m, dim=-1)
        m_tot = m_inc[..., -1]
        # log T after record s = log_t_end - (sum of m over the later ones).
        log_t_after = log_t_end[:, :, None] - (m_tot[:, :, None] - m_inc)
        t_before = torch.exp(log_t_after - m)
        fac = alpha * t_before * act

        cw = torch.bmm(v_rgb, bcolor.transpose(1, 2))
        c_inc = torch.cumsum(cw * fac, dim=-1)
        c_tot = c_inc[..., -1]
        buffer_behind = s_behind[:, :, None] + (c_tot[:, :, None] - c_inc)
        ra = 1.0 / (1.0 - alpha)
        v_alpha = act * (cw * t_before - buffer_behind * ra
                         + t_final[:, :, None] * ra * v_a[:, :, None])
        v_sigma = -bopac[:, None, :] * vis * v_alpha

        g_xy = torch.stack([
            torch.sum(v_sigma * (cx * dx + cy * dy), dim=1),
            torch.sum(v_sigma * (cy * dx + cz * dy), dim=1)], dim=-1)
        g_conic = torch.stack([
            torch.sum(v_sigma * 0.5 * dx * dx, dim=1),
            torch.sum(v_sigma * dx * dy, dim=1),
            torch.sum(v_sigma * 0.5 * dy * dy, dim=1)], dim=-1)
        g_color = torch.bmm(fac.transpose(1, 2), v_rgb)
        g_opac = torch.sum(vis * v_alpha * act, dim=1)

        flat = gid.reshape(-1)
        v_xy.index_add_(0, flat, g_xy.reshape(-1, 2))
        v_conic.index_add_(0, flat, g_conic.reshape(-1, 3))
        v_color.index_add_(0, flat, g_color.reshape(-1, 3))
        v_opac.index_add_(0, flat, g_opac.reshape(-1))
        log_t_end = log_t_end - m_tot
        s_behind = s_behind + c_tot
    return v_xy, v_conic, v_color, v_opac


class TiledRaster(torch.autograd.Function):
    """The rasterizer as an autograd Function: the forward keeps log T and
    final_idx, the backward is the back-to-front sweep. Gradients reach
    xy, conic, color and opac only."""

    @staticmethod
    def forward(ctx, geom, xy, conic, color, opac, isect_gid, starts, ends,
                tile_ids):
        with full_f32():
            img, log_t, final_idx = _forward(geom, xy, conic, color, opac,
                                             isect_gid, starts, ends,
                                             tile_ids)
        ctx.geom = geom
        ctx.save_for_backward(xy, conic, color, opac, isect_gid, starts,
                              ends, tile_ids, log_t, final_idx)
        return img

    @staticmethod
    def backward(ctx, g):
        with full_f32():
            grads = _backward(ctx.geom, g, *ctx.saved_tensors)
        return (None, *grads, None, None, None, None)


def make_rasterizer(tiles_x: int, num_tiles: int, max_isects: int,
                    block_size: int):
    """The tiled rasterizer for `num_tiles` tiles of an image `tiles_x`
    tiles wide over a pool of max_isects records, in rounds of block_size.

    Returns raster(xy, conic, color, opac, isect_gid, starts, ends,
    tile_ids) -> (num_tiles, TILE_SIZE, 4): per-compact-splat attributes
    (xy (n, 2), conic (n, 3), color (n, 3), opac (n,)) and the records of
    ops/binning.build_intersections; tile_ids (num_tiles,) names the image
    tiles to render and starts/ends their ranges (the whole image
    single-device, a contiguous slice of tiles a rank when sharded).

    Each call reads the longest range to the host once (the round count is
    data-dependent). The products run with TF32 off (the reference pins
    Precision.HIGHEST). On CUDA tensors index_add_ sums the backward's
    per-splat gradients with atomics, so repeats may differ in the last
    bits; on the CPU the result is deterministic.
    """
    geom = _Geometry(tiles_x, num_tiles, max_isects, block_size)

    def raster(xy, conic, color, opac, isect_gid, starts, ends, tile_ids):
        if tuple(tile_ids.shape) != (geom.num_tiles,):
            raise ValueError(f"tile_ids must be ({geom.num_tiles},), got "
                             f"{tuple(tile_ids.shape)}")
        return TiledRaster.apply(geom, xy, conic, color, opac, isect_gid,
                                 starts, ends, tile_ids)

    return raster
