"""Front-to-back alpha compositing as dense (pixels x splats) block math.

Port of brush_tpu/ops/compositing.py (reference: rasterize.wgsl:57-101).
T is a running product of (1 - alpha), computed as exp(cumsum(log1p(-a)))
along the splat axis; the T < 1e-4 early-out is a mask that stays set once
crossed (the reference's `done` flag). This is the port's dense oracle;
the record pipeline's rasterizer is checked against it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from brush_tpu_torch.constants import ALPHA_EPS, ALPHA_MAX, TRANSMITTANCE_EPS

LOG_T_EPS = math.log(TRANSMITTANCE_EPS)


class SplatBlock(NamedTuple):
    """A block of K depth-ordered splats (padded entries have valid=False)."""

    xy: torch.Tensor     # (K, 2) projected centers, pixels
    conic: torch.Tensor  # (K, 3) inverse covariance upper triangle
    color: torch.Tensor  # (K, 3) RGB
    opac: torch.Tensor   # (K,) opacity after sigmoid
    valid: torch.Tensor  # (K,) bool


def alpha_terms(pix: torch.Tensor, blk: SplatBlock) -> torch.Tensor:
    """(P, K) alpha per (pixel, splat), 0 where the splat does not
    contribute (sigma < 0, alpha < 1/255, or padding); rasterize.wgsl:80-85.
    exp takes max(sigma, 0) so a det < 0 conic cannot overflow it."""
    dx = blk.xy[None, :, 0] - pix[:, None, 0]
    dy = blk.xy[None, :, 1] - pix[:, None, 1]
    cx, cy, cz = blk.conic[:, 0], blk.conic[:, 1], blk.conic[:, 2]
    sigma = 0.5 * (cx * dx * dx + cz * dy * dy) + cy * dx * dy
    vis = torch.exp(-torch.clamp(sigma, min=0.0))
    alpha = torch.clamp(blk.opac * vis, max=ALPHA_MAX)
    ok = (sigma >= 0.0) & (alpha >= ALPHA_EPS) & blk.valid
    return torch.where(ok, alpha, torch.zeros_like(alpha))


class CompositeCarry(NamedTuple):
    log_t: torch.Tensor  # (P,) log transmittance so far
    rgb: torch.Tensor    # (P, 3) accumulated color
    alive: torch.Tensor  # (P,) bool, False once the early-out crossed


def composite_fwd_block(pix: torch.Tensor, carry: CompositeCarry,
                        blk: SplatBlock) -> CompositeCarry:
    """Composite one block of splats front-to-back over P pixels."""
    alpha = alpha_terms(pix, blk)
    lom = torch.log1p(-alpha)                      # 0 for non-contributors
    log_t_after = carry.log_t[:, None] + torch.cumsum(lom, dim=1)
    act = (log_t_after > LOG_T_EPS) & carry.alive[:, None]
    fac = alpha * torch.exp(log_t_after - lom) * act
    rgb = carry.rgb + fac @ blk.color
    log_t = carry.log_t + (lom * act).sum(dim=1)
    alive = carry.alive & (log_t_after[:, -1] > LOG_T_EPS)
    return CompositeCarry(log_t=log_t, rgb=rgb, alive=alive)


def composite_pixels(pix, xy, conic, color, opac, valid,
                     block_size: int = 256) -> torch.Tensor:
    """Composite depth-ordered splats over P pixels -> (P, 4) RGBA, with
    alpha = 1 - T_final (rasterize.wgsl:103-105)."""
    p = pix.shape[0]
    dev = pix.device
    carry = CompositeCarry(
        log_t=torch.zeros(p, dtype=torch.float32, device=dev),
        rgb=torch.zeros((p, 3), dtype=torch.float32, device=dev),
        alive=torch.ones(p, dtype=torch.bool, device=dev),
    )
    for s in range(0, xy.shape[0], block_size):
        e = s + block_size
        blk = SplatBlock(xy=xy[s:e], conic=conic[s:e], color=color[s:e],
                         opac=opac[s:e], valid=valid[s:e])
        carry = composite_fwd_block(pix, carry, blk)
    alpha_out = 1.0 - torch.exp(carry.log_t)
    return torch.cat([carry.rgb, alpha_out[:, None]], dim=-1)
