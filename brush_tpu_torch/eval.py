"""Held-out evaluation: PSNR / SSIM (port of brush_tpu/eval.py; reference:
brush-train/src/eval.rs)."""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.render import render_splats
from brush_tpu_torch.splats import Splats
from brush_tpu_torch.ssim import Ssim


class EvalView(NamedTuple):
    psnr: float
    ssim: float
    rendered: np.ndarray | None = None  # kept only when keep_image is set
    pool: int | None = None  # intersection pool that rendered clean
    dropped: int = 0  # records still dropped after the pool's growth


def psnr_from_mse(mse: torch.Tensor) -> torch.Tensor:
    """PSNR = 10 * log10(1 / mse) (eval.rs:60)."""
    return 10.0 * torch.log(1.0 / mse) / np.log(10.0)


def eval_view(splats: Splats, camera, gt_image: np.ndarray,
              block_size: int = 32, keep_image: bool = False,
              cell=(1, 1), pool: int | None = None) -> EvalView:
    """PSNR/SSIM of one view on the splats' device; MSE on RGB only
    (eval.rs:48-65).

    The intersection pool grows until nothing drops (eval.py:46-65): a
    truncated pool silently erases the deepest geometry, so a grown pool,
    rounded up to a power of two, is tried up to four times.
    """
    h, w = gt_image.shape[:2]
    cam = camera_params(camera, (w, h), device=splats.device)
    max_isects = pool
    for _ in range(4):
        img, aux = render_splats(
            splats.means, splats.log_scales, splats.quats,
            splats.sh_coeffs, splats.raw_opacity,
            cam, (w, h), active=splats.active_mask(), block_size=block_size,
            max_isects=max_isects, cell=cell, needs_grad=False,
        )
        dropped = int(aux.num_dropped)
        if dropped == 0:
            break
        need = 2 * (int(aux.num_isects) + dropped)
        max_isects = 1 << (need - 1).bit_length()
    if dropped > 0:
        logging.getLogger(__name__).warning(
            "eval_view: %d records still dropped after pool growth; "
            "PSNR/SSIM are computed on a TRUNCATED render", dropped,
        )
    render_rgb = img[..., :3]
    gt_rgb = torch.as_tensor(np.asarray(gt_image[..., :3], np.float32),
                             device=splats.device)
    mse = torch.mean((render_rgb - gt_rgb) ** 2)
    psnr = float(psnr_from_mse(mse))
    ssim = float(Ssim(11, 3).ssim(render_rgb[None], gt_rgb[None]))
    return EvalView(
        psnr=psnr, ssim=ssim,
        rendered=render_rgb.cpu().numpy() if keep_image else None,
        pool=max_isects, dropped=dropped,
    )


def eval_stats(splats: Splats, views, block_size: int = 32,
               keep_images: bool = False, cell=(1, 1)) -> list[EvalView]:
    """Evaluate (camera, gt_image) pairs (eval.rs:27-77); the grown pool
    carries monotonically across views."""
    out = []
    pool = None
    for cam, img in views:
        ev = eval_view(splats, cam, img, block_size, keep_image=keep_images,
                       cell=cell, pool=pool)
        if ev.pool is not None:
            pool = ev.pool if pool is None else max(pool, ev.pool)
        out.append(ev)
    return out
