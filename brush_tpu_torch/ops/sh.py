"""Spherical-harmonics colour evaluation, degrees 0-4 (port of
brush_tpu/ops/sh.py; reference: project_visible.wgsl:51-147).

`view_colors`, the render's SH colour: the CUDA kernels of ops/cuda/sh.py
(csrc/sh.cu) for CUDA tensors, the plain code for CPU tensors. That plain
code is also the kernels' twin: `sh_to_color` of the forward and
`sh_coeffs_grad_plain` of the backward, each at the kernels' view
directions `view_dirs_plain`."""

from __future__ import annotations

import torch

from brush_tpu_torch.constants import (
    SH_C0, sh_coeffs_for_degree, sh_degree_from_coeffs,
)
from brush_tpu_torch.ops.cuda import sh as cuda_sh


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit directions -> (..., (degree+1)^2) basis, band-major."""
    if not 0 <= degree <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {degree}")

    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    bases = [torch.full_like(x, SH_C0)]

    if degree >= 1:
        f0a = 0.48860251190292
        bases += [-f0a * y, f0a * z, -f0a * x]

    if degree >= 2:
        z2 = z * z
        f0b = -1.092548430592079 * z
        f1a = 0.5462742152960395
        fc1 = x * x - y * y
        fs1 = 2.0 * x * y
        p6 = 0.9461746957575601 * z2 - 0.3153915652525201
        bases += [f1a * fs1, f0b * y, p6, f0b * x, f1a * fc1]

    if degree >= 3:
        f0c = -2.285228997322329 * z2 + 0.4570457994644658
        f1b = 1.445305721320277 * z
        f2a = -0.5900435899266435
        fc2 = x * fc1 - y * fs1
        fs2 = x * fs1 + y * fc1
        p12 = z * (1.865881662950577 * z2 - 1.119528997770346)
        bases += [f2a * fs2, f1b * fs1, f0c * y, p12, f0c * x, f1b * fc1,
                  f2a * fc2]

    if degree >= 4:
        f0d = z * (-4.683325804901025 * z2 + 2.007139630671868)
        f1c = 3.31161143515146 * z2 - 0.47308734787878
        f2b = -1.770130769779931 * z
        f3a = 0.6258357354491763
        fc3 = x * fc2 - y * fs2
        fs3 = x * fs2 + y * fc2
        p20 = 1.984313483298443 * z * p12 - 1.006230589874905 * p6
        bases += [
            f3a * fs3, f2b * fs2, f1c * fs1, f0d * y, p20,
            f0d * x, f1c * fc1, f2b * fc2, f3a * fc3,
        ]

    return torch.stack(bases, dim=-1)


def sh_to_color(degree: int, dirs: torch.Tensor,
                coeffs: torch.Tensor) -> torch.Tensor:
    """(N, 3) RGB = basis(dirs) . coeffs + 0.5 (project_visible.wgsl:235).

    coeffs: (N, K, 3) with K >= (degree+1)^2. The contraction runs in the
    reference's order (one multiply-add per basis) so the f32 sums round
    the same way.
    """
    k = sh_coeffs_for_degree(degree)
    basis = sh_basis(degree, dirs)
    color = basis[:, 0:1] * coeffs[:, 0, :]
    for i in range(1, k):
        color = color + basis[:, i:i + 1] * coeffs[:, i, :]
    return color + 0.5


def sh_coeffs_grad_plain(degree: int, dirs: torch.Tensor, g: torch.Tensor,
                         k: int) -> torch.Tensor:
    """The gradient (N, k, 3) of sh_to_color(degree, dirs, coeffs) with
    respect to coeffs (N, k, 3), given the colour's gradient g (N, 3):
    basis_i(dirs) * g, each product as autograd forms it, plus 0 (so a -0
    product comes out as the +0 that autograd's zero-filled slices add to
    it when more than one coefficient is used), and zero past
    (degree+1)^2. The twin of csrc/sh.cu's backward."""
    kd = sh_coeffs_for_degree(degree)
    if k < kd:
        raise ValueError(f"k = {k} coefficients: degree {degree} needs "
                         f"{kd}")
    basis = sh_basis(degree, dirs)
    out = torch.zeros((dirs.shape[0], k, 3), dtype=g.dtype, device=g.device)
    out[:, :kd, :] = basis[:, :, None] * g[:, None, :] + 0.0
    return out


def view_dirs_plain(means: torch.Tensor, campos: torch.Tensor
                    ) -> torch.Tensor:
    """The view directions of csrc/sh.cu: (means - campos) over its norm
    clamped at 1e-12, the norm as sqrt((dx dx + dz dz) + dy dy), op by op:
    the order of torch.linalg.vector_norm's CUDA reduction (view_colors'
    plain path; the CPU's vector_norm may sum the squares in another
    order). The kernels' twin for the tests and chip_smoke.py: the
    package itself never calls it."""
    d = means - campos
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    norm = torch.sqrt((dx * dx + dz * dz) + dy * dy)
    return d / torch.clamp(norm, min=1e-12)


def view_colors(means, sh_coeffs, cam) -> torch.Tensor:
    """SH colour per splat seen by cam (a CameraParams). The reference
    takes the translation column of the world-to-view matrix as the
    "camera position" for the view directions (project_visible.wgsl:232);
    replicated for parity. The view direction is a constant for autograd,
    as in the reference (gather_grads.wgsl): colour gradients reach the SH
    coefficients only, never the means. CUDA tensors go to the kernels of
    ops/cuda/sh.py (the colour and its backward), CPU tensors to the plain
    code below."""
    degree = sh_degree_from_coeffs(sh_coeffs.shape[1])
    campos = cam.viewmat[:3, 3]
    if sh_coeffs.device.type != "cpu":
        return cuda_sh.sh_color(means, campos, sh_coeffs, degree)
    viewdir = means.detach() - campos
    viewdir = viewdir / torch.clamp(
        torch.linalg.vector_norm(viewdir, dim=-1, keepdim=True), min=1e-12)
    return sh_to_color(degree, viewdir, sh_coeffs)
