"""Shared constants between host orchestration and device kernels.

A copy of brush_tpu/constants.py (the port imports nothing of the JAX
package). The CUDA sources under csrc/ repeat the values they need; keep
them in step with this file.

Values mirror reference/crates/brush-render/src/shaders/helpers.wgsl:1-5,166.
"""

# Image tiles are TILE_WIDTH x TILE_WIDTH pixels (helpers.wgsl:1).
TILE_WIDTH = 16
TILE_SIZE = TILE_WIDTH * TILE_WIDTH

# Screen-space covariance dilation added to the diagonal (helpers.wgsl:166).
COV_BLUR = 0.3

# Splats with projected depth <= this are culled (project_forward.wgsl:32).
NEAR_PLANE_Z = 0.01

# Alpha below which a splat does not contribute to a pixel (rasterize.wgsl:85).
ALPHA_EPS = 1.0 / 255.0

# Per-splat alpha is clamped to this maximum (rasterize.wgsl:83).
ALPHA_MAX = 0.999

# Compositing stops once transmittance drops below this (rasterize.wgsl:88).
TRANSMITTANCE_EPS = 1e-4

# SH DC normalization constant (gather_grads.wgsl:15).
SH_C0 = 0.2820947917738781


def sh_coeffs_for_degree(degree: int) -> int:
    """Number of SH bases for a degree (reference: render.rs:40-42)."""
    return (degree + 1) ** 2


def sh_degree_from_coeffs(num_coeffs: int) -> int:
    """Inverse of sh_coeffs_for_degree (reference: render.rs:44-53)."""
    degree = {1: 0, 4: 1, 9: 2, 16: 3, 25: 4}.get(num_coeffs)
    if degree is None:
        raise ValueError(f"Invalid number of SH bases: {num_coeffs}")
    return degree
