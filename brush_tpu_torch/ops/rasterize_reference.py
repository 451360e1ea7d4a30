"""Dense reference renderer — the port's numerics oracle.

Port of brush_tpu/ops/rasterize_reference.py: composites every splat
against every pixel (no tiles, no binning) in global depth order with the
projection / SH / compositing math of the record pipeline. O(N x pixels):
for tests and small scenes only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from brush_tpu_torch.constants import sh_degree_from_coeffs
from brush_tpu_torch.device import full_f32, resolve_device
from brush_tpu_torch.ops.compositing import composite_pixels
from brush_tpu_torch.ops.cuda import sh as cuda_sh
from brush_tpu_torch.ops.projection import project_splats
from brush_tpu_torch.ops.sh import sh_to_color


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


def view_colors(means, sh_coeffs, cam: CameraParams) -> torch.Tensor:
    """SH colour per splat. The reference takes the translation column of
    the world-to-view matrix as the "camera position" for the view
    directions (project_visible.wgsl:232); replicated for parity. The view
    direction is a constant for autograd, as in the reference
    (gather_grads.wgsl): colour gradients reach the SH coefficients only,
    never the means. CUDA tensors go to the kernels of ops/cuda/sh.py (the
    colour and its backward), CPU tensors to the plain code below."""
    degree = sh_degree_from_coeffs(sh_coeffs.shape[1])
    campos = cam.viewmat[:3, 3]
    if sh_coeffs.device.type != "cpu":
        return cuda_sh.sh_color(means, campos, sh_coeffs, degree)
    viewdir = means.detach() - campos
    viewdir = viewdir / torch.clamp(
        torch.linalg.vector_norm(viewdir, dim=-1, keepdim=True), min=1e-12)
    return sh_to_color(degree, viewdir, sh_coeffs)


def normalize_quats(quats: torch.Tensor) -> torch.Tensor:
    return quats / torch.clamp(
        torch.linalg.vector_norm(quats, dim=-1, keepdim=True), min=1e-12)


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
