"""Dense reference renderer — the port's numerics oracle.

Port of brush_tpu/ops/rasterize_reference.py: composites every splat
against every pixel (no tiles, no binning) in global depth order with the
projection / SH / compositing math of the record pipeline. O(N x pixels):
for tests and small scenes only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from brush_tpu_torch.device import full_f32, resolve_device
from brush_tpu_torch.ops.compositing import composite_pixels
from brush_tpu_torch.ops.projection import normalize_quats, project_splats
from brush_tpu_torch.ops.sh import view_colors


class CameraParams(NamedTuple):
    """Camera data as float32 tensors on the render's device."""

    viewmat: torch.Tensor       # (4, 4) world-to-view
    focal: torch.Tensor         # (2,) fx, fy
    pixel_center: torch.Tensor  # (2,) cx, cy


def camera_params(camera, img_size, device="cuda") -> CameraParams:
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return CameraParams(
        viewmat=f32(camera.world_to_local()),
        focal=f32(camera.focal(img_size)),
        pixel_center=f32(camera.center(img_size)),
    )


def pixel_grid(img_size, device="cpu") -> torch.Tensor:
    """(H*W, 2) pixel-center coordinates (x, y); img_size is (w, h)."""
    w, h = int(img_size[0]), int(img_size[1])
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def render_oracle(means, log_scales, quats, sh_coeffs, raw_opacity,
                  cam: CameraParams, img_size, active=None,
                  block_size: int = 256) -> torch.Tensor:
    """Render (h, w, 4) RGBA float32; quats are normalized internally."""
    with full_f32():
        proj = project_splats(
            means, log_scales, normalize_quats(quats),
            cam.viewmat, cam.focal, cam.pixel_center, img_size,
            active=active,
        )
        color = view_colors(means, sh_coeffs, cam)
        opac = torch.sigmoid(raw_opacity)
        key = torch.where(proj.visible, proj.depth,
                          torch.full_like(proj.depth, float("inf")))
        order = torch.sort(key, stable=True).indices
        out = composite_pixels(
            pixel_grid(img_size, means.device), proj.xy[order],
            proj.conic[order], color[order], opac[order],
            proj.visible[order], block_size=block_size,
        )
    w, h = int(img_size[0]), int(img_size[1])
    return out.reshape(h, w, 4)
