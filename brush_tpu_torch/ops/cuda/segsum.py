"""Segment sum: gradient rows sorted by compact splat id -> per-splat sums.

Replaces brush_tpu/ops/pallas/segsum.py (segment_sum_pallas, :136). The
CUDA kernels are in brush_tpu_torch/csrc/segsum.cu: from 131072 splats, a
block a run of 256 splats whose slots stream through shared memory;
below, the work split by slots, a block a span of 1024 live slots, the
splats that cross spans joined by a second kernel in span order (its
header gives the design, the choice and the bound).
`segment_sum_plain` below is the same function in PyTorch: CPU tensors
take it, and tests and chip_smoke.py hold the kernel to it.

Inputs: rows (GRAD_ROWS, pool) float32 in compact-id order; offsets and
cum (n,) int32, each splat's exclusive and inclusive record-count cumsums
(splat w owns slots [offsets[w], cum[w]), so offsets[w + 1] == cum[w]: the
kernel relies on consecutive splats owning one contiguous range); total
(1,) int32, the live slots. Output: (GRAD_ROWS, n) float32 in compact (depth) order, summing
only the slots below `total`.
"""

from __future__ import annotations

import torch

from brush_tpu_torch.ops.cuda import build
from brush_tpu_torch.ops.cuda.rasterize_bwd import GRAD_ROWS


def slot_owners(cum, total, pool: int) -> torch.Tensor:
    """The compact id owning each of the first `total` slots (int64)."""
    slots = torch.arange(pool, dtype=torch.int64, device=cum.device)
    slots = slots[slots < total.to(torch.int64)]
    return torch.searchsorted(cum.to(torch.int64), slots, right=True)


def segment_sum_plain(rows, offsets, cum, total):
    """PyTorch version of csrc/segsum.cu: each live slot's rows are added
    into its owner's column (index_add_; float32, in slot order on the
    CPU)."""
    n = offsets.shape[0]
    out = torch.zeros((GRAD_ROWS, n), dtype=torch.float32, device=rows.device)
    if n == 0:
        return out
    owner = slot_owners(cum, total, rows.shape[1])
    return out.index_add_(1, owner, rows[:, :owner.shape[0]])


def _check_inputs(rows, offsets, cum, total):
    pool = rows.shape[1] if rows.dim() == 2 else -1
    n = offsets.shape[0]
    build.check_tensors(("rows", rows, (GRAD_ROWS, pool), torch.float32),
                        ("offsets", offsets, (n,), torch.int32),
                        ("cum", cum, (n,), torch.int32),
                        ("total", total, (1,), torch.int32))


def segment_sum(rows, offsets, cum, total):
    """Per-splat sums (GRAD_ROWS, n) on the inputs' device: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    _check_inputs(rows, offsets, cum, total)
    if rows.device.type == "cpu":
        return segment_sum_plain(rows, offsets, cum, total)
    if rows.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {rows.device}")
    rows, offsets, cum, total = (t.contiguous()
                                 for t in (rows, offsets, cum, total))
    n = offsets.shape[0]
    pool = rows.shape[1]
    out = torch.empty((GRAD_ROWS, n), dtype=torch.float32, device=rows.device)
    # Per span of slots: the partial sums of the splats that cross it.
    floats = build.entry("segsum_scratch_floats")(pool)
    scratch = torch.empty((max(1, floats),), dtype=torch.float32,
                          device=rows.device)
    build.launch("segsum_launch", rows.device, rows.data_ptr(), pool,
                 offsets.data_ptr(), cum.data_ptr(), total.data_ptr(), n,
                 out.data_ptr(), scratch.data_ptr())
    return out
