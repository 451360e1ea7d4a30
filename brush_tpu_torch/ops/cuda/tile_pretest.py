"""The exact tile pretest: each splat's ellipse-vs-box test over its
raster-cell bbox on the fixed 8x8 layout of ops/binning.py.

Replaces no TPU kernel (brush_tpu/ops/binning.py:precompute_tile_masks is
plain XLA). The CUDA kernel is brush_tpu_torch/csrc/tile_pretest.cu (one
thread a splat, the tests of its bbox window in registers; its header
gives the design and the bound). ops/binning.precompute_tile_masks
launches it for CUDA tensors; its plain twin,
ops/binning.precompute_tile_masks_plain, runs for CPU tensors, and the
card tests hold the kernel to it bit for bit.

Inputs, n splats in global order: xy (n, 2), conic (n, 3) and opac (n,)
float32; tile_min and tile_max (n, 2) int32; visible (n,) bool; cell =
(gw, gh) tiles a raster cell. Outputs, in binning.TileMasks' order:
counts, mask_lo, mask_hi, pc_pack (n,) int64 and small (n,) bool.
"""

from __future__ import annotations

import torch

from brush_tpu_torch.ops.cuda import build


def _check_inputs(xy, conic, opac, tile_min, tile_max, visible, cell):
    n = xy.shape[0] if xy.dim() == 2 else -1
    build.check_tensors(("xy", xy, (n, 2), torch.float32),
                        ("conic", conic, (n, 3), torch.float32),
                        ("opac", opac, (n,), torch.float32),
                        ("tile_min", tile_min, (n, 2), torch.int32),
                        ("tile_max", tile_max, (n, 2), torch.int32),
                        ("visible", visible, (n,), torch.bool))
    if n >= (1 << 30):
        raise ValueError(f"{n} splats: the kernel indexes fewer than 2^30")
    if len(cell) != 2 or any(int(v) != v or not 1 <= v < (1 << 16)
                             for v in cell):
        raise ValueError(f"cell must be two ints in [1, 2^16), got {cell}")
    if opac.device.type != "cuda":
        raise ValueError(f"tile_pretest: the kernel takes CUDA tensors, got "
                         f"{opac.device} (ops/binning."
                         f"precompute_tile_masks_plain is the CPU's)")


def tile_pretest(xy, conic, opac, tile_min, tile_max, visible, cell=(1, 1)):
    """The pretest's five outputs for CUDA tensors, on the current stream:
    (counts, mask_lo, mask_hi, pc_pack, small)."""
    _check_inputs(xy, conic, opac, tile_min, tile_max, visible, cell)
    xy, conic, opac, tile_min, tile_max, visible = (
        t.contiguous() for t in (xy, conic, opac, tile_min, tile_max,
                                 visible))
    n = opac.shape[0]
    dev = opac.device
    counts, mask_lo, mask_hi, pc_pack = (
        torch.empty((n,), dtype=torch.int64, device=dev) for _ in range(4))
    small = torch.empty((n,), dtype=torch.bool, device=dev)
    build.launch("tile_pretest_launch", dev, xy.data_ptr(), conic.data_ptr(),
                 opac.data_ptr(), tile_min.data_ptr(), tile_max.data_ptr(),
                 visible.data_ptr(), n, int(cell[0]), int(cell[1]),
                 counts.data_ptr(), mask_lo.data_ptr(), mask_hi.data_ptr(),
                 pc_pack.data_ptr(), small.data_ptr())
    return counts, mask_lo, mask_hi, pc_pack, small
