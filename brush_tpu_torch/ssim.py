"""SSIM with a gaussian window (port of brush_tpu/ssim.py; reference:
brush-train/src/ssim.rs).

The reference's padding of ceil(window/2) (ssim.rs:48) is kept: the output
is two pixels larger than the input and the zero-padded border is averaged
into the score. The blur is a grouped float32 convolution run with TF32
off, as the reference pins Precision.HIGHEST — in the backward too: the
blur is an autograd Function whose backward convolution also runs under
full_f32, since autograd runs it after the forward's context has closed.
The clamps use torch.maximum, which splits the gradient at a tie as
jnp.maximum does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from brush_tpu_torch.device import full_f32


def gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    """Normalized 1D gaussian (ssim.rs:7-14)."""
    extent = window_size // 2
    xs = np.arange(window_size, dtype=np.float32)
    vals = np.exp(-((xs - extent) ** 2) / (2.0 * sigma**2))
    return vals / vals.sum()


class _Blur(torch.autograd.Function):
    """Grouped 2D convolution with a fixed kernel, TF32 off both ways."""

    @staticmethod
    def forward(ctx, img, weights, padding, groups):
        ctx.save_for_backward(weights)
        ctx.conf = (img.shape, padding, groups)
        with full_f32():
            return F.conv2d(img, weights, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, grad):
        (weights,) = ctx.saved_tensors
        shape, padding, groups = ctx.conf
        with full_f32():
            g = torch.nn.grad.conv2d_input(shape, weights, grad,
                                           padding=padding, groups=groups)
        return g, None, None, None


class Ssim:
    """SSIM measure over NHWC float images in [0, 1]."""

    def __init__(self, window_size: int = 11, channels: int = 3,
                 sigma: float = 1.5):
        w1 = gaussian_window(window_size, sigma)
        w2 = np.outer(w1, w1).astype(np.float32)
        # (out_ch, in_ch / groups = 1, kh, kw), grouped per channel.
        self.weights = torch.as_tensor(
            np.tile(w2[None, None], (channels, 1, 1, 1)))
        self.channels = channels
        # The window on each device it was used on: a copy from host memory
        # synchronizes the stream, so a training loss makes it once.
        self._weights_on: dict = {}
        self.padding = -(-window_size // 2)

    def _blur(self, img_nchw: torch.Tensor) -> torch.Tensor:
        wts = self._weights_on.get(img_nchw.device)
        if wts is None:
            wts = self._weights_on[img_nchw.device] = self.weights.to(
                img_nchw.device)
        return _Blur.apply(img_nchw, wts, self.padding, self.channels)

    def ssim(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """Mean SSIM of two (N, H, W, C) images (ssim.rs:42-102)."""
        x = img1.permute(0, 3, 1, 2)
        y = img2.permute(0, 3, 1, 2)
        mu_x = self._blur(x)
        mu_y = self._blur(y)
        mu_xx = mu_x * mu_x
        mu_yy = mu_y * mu_y
        mu_xy = mu_x * mu_y
        zero = torch.zeros((), dtype=mu_x.dtype, device=mu_x.device)
        sigma_xx = torch.maximum(self._blur(x * x) - mu_xx, zero)
        sigma_yy = torch.maximum(self._blur(y * y) - mu_yy, zero)
        sigma_xy = self._blur(x * y) - mu_xy

        c1 = 0.01**2
        c2 = 0.03**2
        ssim_map = ((2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)) / (
            (mu_xx + mu_yy + c1) * (sigma_xx + sigma_yy + c2))
        return ssim_map.mean()
