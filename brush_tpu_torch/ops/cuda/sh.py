"""The SH colour and its backward as two CUDA kernels: each splat's view
direction, the SH basis of degree 0-4 at it and its contraction with the
splat's coefficients; backward, the coefficients' gradient.

Replaces no TPU kernel (brush_tpu/ops/sh.py is plain XLA). The kernels are
brush_tpu_torch/csrc/sh.cu (one thread a splat, a block's coefficient rows
staged through shared memory; its header gives the design and the bound).
ops/sh.view_colors calls `sh_color` for CUDA tensors: an
autograd Function whose forward launches `sh_color_fwd` and whose backward
launches `sh_color_bwd`. Their plain twins, which run for CPU tensors and
which the card tests hold them to bit for bit, are ops/sh.sh_to_color and
ops/sh.sh_coeffs_grad_plain at the directions of ops/sh.view_dirs_plain.

Inputs: means (n, 3) float32; campos (3,) float32, any stride (the
translation column of the world-to-view matrix); coeffs (n, k, 3) float32
with (degree + 1)^2 <= k < 2^16; degree in [0, 4]; the colour's gradient
(n, 3) float32. Outputs: the colour (n, 3) float32; the coefficients'
gradient (n, k, 3) float32, zero past the (degree + 1)^2 used.
"""

from __future__ import annotations

import torch

from brush_tpu_torch.ops.cuda import build


def _check_inputs(means, campos, rows, degree, k, rows_name):
    """rows: the coefficients (forward) or the colour's gradient."""
    if not isinstance(degree, int) or not 0 <= degree <= 4:
        raise ValueError(f"degree must be an int in [0, 4], got {degree}")
    n = means.shape[0] if means.dim() == 2 else -1
    rows_shape = (n, 3) if rows_name == "g_color" else (n, k, 3)
    build.check_tensors(("means", means, (n, 3), torch.float32),
                        ("campos", campos, (3,), torch.float32),
                        (rows_name, rows, rows_shape, torch.float32))
    if not (degree + 1) ** 2 <= k < (1 << 16):
        raise ValueError(f"k = {k} coefficients: degree {degree} needs "
                         f"[{(degree + 1) ** 2}, 2^16)")
    if n >= (1 << 30):
        raise ValueError(f"{n} splats: the kernels index fewer than 2^30")
    if means.device.type != "cuda":
        raise ValueError(f"sh_color: the kernels take CUDA tensors, got "
                         f"{means.device} (ops/sh.sh_to_color is the "
                         f"CPU's)")


def sh_color_fwd(means, campos, coeffs, degree: int) -> torch.Tensor:
    """The SH colour (n, 3) of each splat seen from campos, on the current
    stream."""
    k = coeffs.shape[1] if coeffs.dim() == 3 else -1
    _check_inputs(means, campos, coeffs, degree, k, "coeffs")
    means, coeffs = means.contiguous(), coeffs.contiguous()
    color = torch.empty((means.shape[0], 3), dtype=torch.float32,
                        device=means.device)
    build.launch("sh_color_fwd_launch", means.device, means.data_ptr(),
                 campos.data_ptr(), campos.stride(0), coeffs.data_ptr(), k,
                 means.shape[0], degree, color.data_ptr())
    return color


def sh_color_bwd(means, campos, g_color, degree: int,
                 k: int) -> torch.Tensor:
    """The coefficients' gradient (n, k, 3) from the colour's, on the
    current stream. g_color arrives from autograd as a view of the record
    inputs' gradient; it is made contiguous (12 bytes a splat) before the
    launch."""
    _check_inputs(means, campos, g_color, degree, k, "g_color")
    means, g_color = means.contiguous(), g_color.contiguous()
    g_coeffs = torch.empty((means.shape[0], k, 3), dtype=torch.float32,
                           device=means.device)
    build.launch("sh_color_bwd_launch", means.device, means.data_ptr(),
                 campos.data_ptr(), campos.stride(0), g_color.data_ptr(), k,
                 means.shape[0], degree, g_coeffs.data_ptr())
    return g_coeffs


class _ShColor(torch.autograd.Function):
    """The colour from the coefficients; the means and campos take no
    gradient and are all the backward keeps."""

    @staticmethod
    def forward(ctx, means, campos, coeffs, degree):
        ctx.save_for_backward(means, campos)
        ctx.degree, ctx.k = degree, coeffs.shape[1]
        return sh_color_fwd(means, campos, coeffs, degree)

    @staticmethod
    def backward(ctx, g_color):
        means, campos = ctx.saved_tensors
        return None, None, sh_color_bwd(means, campos, g_color, ctx.degree,
                                        ctx.k), None


def sh_color(means, campos, coeffs, degree: int) -> torch.Tensor:
    """The SH colour (n, 3) under autograd: the gradient reaches coeffs
    only (the view direction is a constant, as in the reference)."""
    return _ShColor.apply(means.detach(), campos.detach(), coeffs, degree)
