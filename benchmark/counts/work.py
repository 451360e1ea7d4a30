"""Operations and bytes of the splat algorithm, counted at its level.

The yardstick of the benchmark's roofline shares and of `mfu`: what the
algorithm needs for a cell's inputs, never what one implementation does.
A rasterizer's work is the contributing (pixel, splat) pairs: the pairs
whose alpha reaches 1/255 before the pixel's transmittance ends
(reference/splat.py counts them from the cell's own inputs). Its bytes
are each input read once and each output written once. A later change
that culls better, fuses two kernels or drops one leaves these counts as
they are, so no share can pass 100 % unless the time is wrong.

Float32 throughout: 4 bytes a value. Operation tallies (adds,
multiplies, compares; exp, log and a division count one each):

  rasterize forward, a pair: dx, dy (2); sigma (9); exp (1); alpha (1);
    the 1/255 and T tests (2); T * alpha (1); colour (6); T update (2): 24
  rasterize backward, a pair: sigma, exp, alpha again (12); T before the
    splat (2); the colour behind (6); dL/dalpha (12); dL/dsigma (2);
    xy (6), conic (7), colour (3), opacity (1) gradients; their sums (9): 60
  projection, a splat: world to view (15); quaternion to rotation (22);
    R S (9); the 3D covariance (30); the Jacobian (8); its product with W
    (12); the 2D covariance (24); blur, inverse, radius, bbox (20); the
    view direction (9); sigmoid (3): 152, and SH: the degree's basis
    (3 degree 3: 30) plus a multiply-add a coefficient and channel
  projection backward, a splat: twice its forward
  loss, a pixel and channel: L1 (3); five 11 x 11 gaussian blurs,
    separable (5 x 44); the SSIM map (12): 235; backward twice that
  Adam, a parameter: 12
  densification statistics, a splat: 8
"""

from __future__ import annotations

F32 = 4
ATTRS = 9              # x, y, conic (3), colour (3), opacity
FWD_PAIR_OPS = 24
BWD_PAIR_OPS = 60
PROJ_OPS = 152
LOSS_OPS = 235
ADAM_OPS = 12
DENSIFY_OPS = 8

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def sh_ops(coeffs: int) -> int:
    basis = {1: 1, 4: 8, 9: 18, 16: 30}.get(coeffs, 2 * coeffs)
    return basis + 2 * 3 * coeffs


def params_per_splat(coeffs: int) -> int:
    """Means 3, SH 3 a coefficient, quaternion 4, opacity 1, scales 3."""
    return 3 + 3 * coeffs + 4 + 1 + 3


def raster_fwd(pairs: int, splats: int, records: int, pixels: int):
    """(ops, bytes): the drawn splats' attributes and their records' ids
    read once, RGBA written once a pixel."""
    return (FWD_PAIR_OPS * pairs,
            F32 * (ATTRS * splats + records + 4 * pixels))


def raster_bwd(pairs: int, splats: int, records: int, pixels: int):
    """(ops, bytes): attributes and record ids read, dL/dRGBA and the
    final T read a pixel, the attributes' gradients written."""
    return (BWD_PAIR_OPS * pairs,
            F32 * (2 * ATTRS * splats + records + 5 * pixels))


def projection(splats: int, coeffs: int, backward: bool = False):
    """(ops, bytes) over `splats` splats: parameters read, attributes
    written (backward: attribute gradients and parameters read, parameter
    gradients written)."""
    ops = PROJ_OPS + sh_ops(coeffs)
    p = params_per_splat(coeffs)
    if backward:
        return 2 * ops * splats, F32 * splats * (ATTRS + 2 * p)
    return ops * splats, F32 * splats * (p + ATTRS)


def loss(pixels: int, channels: int, backward: bool = False):
    """(ops, bytes): image and ground truth read, the loss (backward: the
    image's gradient) written."""
    k = 2 if backward else 1
    return (k * LOSS_OPS * pixels * channels,
            F32 * pixels * channels * (3 if backward else 2))


def adam(splats: int, coeffs: int):
    """(ops, bytes): parameters, gradients and both moments read,
    parameters and moments written."""
    n = splats * params_per_splat(coeffs)
    return ADAM_OPS * n, F32 * 7 * n


def densify(splats: int):
    return DENSIFY_OPS * splats, F32 * 5 * splats


def total(*parts):
    return (sum(p[0] for p in parts), sum(p[1] for p in parts))


def train_step(n_live: int, coeffs: int, drawn: int, pairs: int,
               records: int, pixels: int, channels: int):
    """(ops, bytes) of one training step: projection, rasterize, loss,
    their backwards, densification statistics and Adam."""
    return total(projection(n_live, coeffs),
                 raster_fwd(pairs, drawn, records, pixels),
                 loss(pixels, channels),
                 loss(pixels, channels, backward=True),
                 raster_bwd(pairs, drawn, records, pixels),
                 projection(n_live, coeffs, backward=True),
                 densify(n_live), adam(n_live, coeffs))


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the slower of its float32
    peak and its memory bandwidth."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
