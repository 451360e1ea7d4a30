#!/usr/bin/env python3
"""How far brush_tpu's Pallas forward (interpret mode, on the CPU) lies
from the port's plain rasterize_fwd on the raster-cell layouts of
brush_tpu_torch/ops/cuda/testing.hand_cells, and why.

For each layout it prints:
  - the TPU kernel's sigma, a rank-6 polynomial in cell-local coordinates
    (brush_tpu/ops/pallas/rasterize_fwd.py:_pixel_basis_a, _splat_basis),
    emulated in float32 against the kernels' direct sigma (sigma_f32) on
    the pairs that pass the pretest: the largest sigma difference, the
    largest change of alpha it makes, and the pairs whose alpha lands on
    the other side of ALPHA_EPS;
  - rasterize_fwd_pallas(interpret=True) against rasterize_fwd_plain:
    image values beyond 1e-5 and the flip budget of
    tests/test_torch_cuda.close_with_flips (2e-3 of the values), the
    pixels concerned, the largest difference and final_idx mismatches.

    JAX_PLATFORMS=cpu python3 scripts/hand_cells_pallas_gap.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from brush_tpu.ops.pallas.rasterize_fwd import rasterize_fwd_pallas  # noqa: E402
from brush_tpu_torch.ops.cuda import rasterize_fwd as t_raster  # noqa: E402
from brush_tpu_torch.ops.cuda.testing import (  # noqa: E402
    HAND_CELL_CASES, cell_pixel_centres, hand_cells, sigma_f32,
    sigma_max_f32,
)

F32 = np.float32


def polynomial_gap(packed, starts, ends, cells_x, cell):
    """(largest |sigma_poly - sigma|, largest alpha change, pairs across
    ALPHA_EPS) over the pairs that pass the kernels' pretest."""
    f = packed[:5].view(np.float32)
    words = packed[6].view(np.uint32) >> 16
    gw, gh = cell
    worst = worst_alpha = 0.0
    across = 0
    for c, (s, e) in enumerate(zip(starts, ends)):
        px, py = cell_pixel_centres(cell, c, cells_x)
        cx = F32((c % cells_x) * 16 * gw + 8 * gw)
        cy = F32((c // cells_x) * 16 * gh + 8 * gh)
        lx, ly = (px - cx).astype(F32), (py - cy).astype(F32)
        basis = np.stack([lx * lx, ly * ly, lx * ly, lx, ly,
                          np.ones_like(lx)]).astype(F32)
        x, y = (f[0, s:e] - cx).astype(F32), (f[1, s:e] - cy).astype(F32)
        cxx, cxy, cyy = f[2, s:e], f[3, s:e], f[4, s:e]
        coef = np.stack([F32(0.5) * cxx, F32(0.5) * cyy, cxy,
                         -(cxx * x + cxy * y), -(cxy * x + cyy * y),
                         F32(0.5) * (cxx * x * x + cyy * y * y)
                         + cxy * x * y]).astype(F32)
        poly = (coef.T @ basis).astype(F32)
        direct = sigma_f32(*(f[r, s:e, None] for r in range(5)), px[None],
                           py[None])
        passes = (direct >= 0) & (direct <= sigma_max_f32(words[s:e])[:, None])
        o = (words[s:e].astype(F32) * F32(1.0 / 65535.0)).astype(F32)[:, None]
        a_direct = o * np.exp(-np.maximum(direct, 0)).astype(F32)
        a_poly = o * np.exp(-np.maximum(poly, 0)).astype(F32)
        if passes.any():
            worst = max(worst, float(np.abs(poly - direct)[passes].max()))
            worst_alpha = max(worst_alpha, float(
                np.abs(a_poly - a_direct)[passes].max()))
        eps = F32(1.0 / 255.0)
        across += int(((a_direct >= eps) != (a_poly >= eps)).sum())
    return worst, worst_alpha, across


def main():
    for case in HAND_CELL_CASES:
        packed, starts, ends, cells_x, cell = hand_cells(case)
        sig, alpha, across = polynomial_gap(packed, starts, ends, cells_x,
                                            cell)
        img_j, _, fidx_j = rasterize_fwd_pallas(
            jnp.asarray(np.pad(packed.view(np.uint32), ((0, 0), (0, 128)))),
            jnp.asarray(starts), jnp.asarray(ends),
            jnp.arange(len(starts), dtype=jnp.int32), tiles_x=cells_x,
            num_tiles=len(starts), max_isects=packed.shape[1], k_lanes=128,
            interpret=True, scan_passes=3, cell=cell)
        img, _, fidx = t_raster.rasterize_fwd_plain(
            torch.tensor(packed), torch.tensor(starts), torch.tensor(ends),
            cells_x, cell)
        diff = np.abs(img.numpy() - np.asarray(img_j))
        beyond = diff > 1e-5
        print(f"{case:13s} cell {cell}: polynomial sigma off by up to "
              f"{sig:.2e}, alpha by up to {alpha:.2e}, {across} pairs "
              f"across ALPHA_EPS; image values beyond 1e-5 "
              f"{int(beyond.sum())} of {diff.size} (budget "
              f"{max(1, int(2e-3 * diff.size))}) at "
              f"{int(beyond.any(-1).sum())} pixels, largest "
              f"{diff.max():.2e}; final_idx mismatches "
              f"{int((fidx.numpy() != np.asarray(fidx_j)).sum())}")


if __name__ == "__main__":
    main()
