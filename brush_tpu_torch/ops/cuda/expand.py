"""Expansion: depth-ordered splats -> per-intersection (key, record) pool.

Replaces brush_tpu/ops/pallas/expand.py (expand_pallas, :374). The CUDA
kernel is brush_tpu_torch/csrc/expand.cu (a block per 1024 consecutive
slots, its owners staged in shared memory; its header gives the design
and the bound). `expand_plain` below is the same
function in PyTorch: CPU tensors take it, and tests and chip_smoke.py hold
the kernel to it.

Inputs, all in depth-compact order (n splats):
  f5:    (5, n) float32 — x, y, cxx, cxy, cyy;
  u5:    (5, n) int32 u32 bit patterns — colop0, colop1 (packed u16 colour
         and opacity, rasterize_fwd.quantize_*), decode row 0 (tmin_x |
         small << 10 | tmin_y << 11 | bbox_w << 22), mask_lo, mask_hi
         (mask_lo holds the clipped bbox height for bbox splats);
  cum:   (n,) int32 inclusive cumsum of the per-splat record counts;
  total: (1,) int32 live slots, min(cum[-1], pool).
Outputs: keys (pool,) int32 tile ids (num_tiles past `total`) and records
(8, pool) int32 in slot order — the packed layout of rasterize_fwd.py.
"""

from __future__ import annotations

import torch

from brush_tpu_torch.ops.binning import select_bit64
from brush_tpu_torch.ops.cuda import build
from brush_tpu_torch.ops.cuda.rasterize_fwd import PACK_ROWS


def _u(v: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its u32 value in int64 (shifts then stay logical)."""
    return v.to(torch.int64) & 0xFFFFFFFF


def expand_plain(f5, u5, cum, total, tiles_x: int, num_tiles: int,
                 pool: int):
    """PyTorch version of csrc/expand.cu (same outputs, bit for bit)."""
    n = f5.shape[1]
    dev = f5.device
    slots = torch.arange(pool, dtype=torch.int64, device=dev)
    valid = slots < total.to(torch.int64)
    if n == 0:
        w = torch.zeros_like(slots)
    else:
        cum64 = cum.to(torch.int64)
        w = torch.clamp(torch.searchsorted(cum64, slots, right=True),
                        max=n - 1)
        off = torch.where(w > 0, cum64[torch.clamp(w - 1, min=0)], 0)
    keys = torch.full((pool,), num_tiles, dtype=torch.int32, device=dev)
    recs = torch.zeros((PACK_ROWS, pool), dtype=torch.int32, device=dev)
    recs[PACK_ROWS - 1] = n
    if n == 0:
        return keys, recs

    wv = w[valid]
    rank = (slots - off)[valid]
    d0 = _u(u5[2, wv])
    tmin_x = d0 & 0x3FF
    small = ((d0 >> 10) & 1) == 1
    tmin_y = (d0 >> 11) & 0x7FF
    bw = torch.clamp(d0 >> 22, min=1)
    pos = select_bit64(_u(u5[3, wv]), _u(u5[4, wv]), rank)
    dy_b = torch.div(rank, bw, rounding_mode="floor")
    dy = torch.where(small, pos >> 3, dy_b)
    dx = torch.where(small, pos & 7, rank - dy_b * bw)
    keys[valid] = ((tmin_y + dy) * tiles_x + tmin_x + dx).to(torch.int32)
    # + 0.0 turns -0.0 into +0.0, as the TPU kernel's matmul gather does.
    recs[0:5, valid] = (f5[:, wv] + 0.0).view(torch.int32)
    recs[5:7, valid] = u5[0:2, wv]
    recs[7, valid] = wv.to(torch.int32)
    return keys, recs


def _check_inputs(f5, u5, cum, total, pool):
    n = f5.shape[1]
    build.check_tensors(("f5", f5, (5, n), torch.float32),
                        ("u5", u5, (5, n), torch.int32),
                        ("cum", cum, (n,), torch.int32),
                        ("total", total, (1,), torch.int32))
    if not 0 <= pool < (1 << 24):
        raise ValueError(f"pool {pool} outside [0, 2^24)")


def expand(f5, u5, cum, total, tiles_x: int, num_tiles: int, pool: int):
    """Expand on the inputs' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Returns (keys, records)."""
    _check_inputs(f5, u5, cum, total, pool)
    if f5.device.type == "cpu":
        return expand_plain(f5, u5, cum, total, tiles_x, num_tiles, pool)
    if f5.device.type != "cuda":
        raise ValueError(f"expand: unsupported device {f5.device}")
    f5, u5, cum, total = (t.contiguous() for t in (f5, u5, cum, total))
    n = f5.shape[1]
    keys = torch.empty((pool,), dtype=torch.int32, device=f5.device)
    recs = torch.empty((PACK_ROWS, pool), dtype=torch.int32,
                       device=f5.device)
    build.launch("expand_launch", f5.device, f5.data_ptr(), u5.data_ptr(),
                 cum.data_ptr(), total.data_ptr(), n, pool, tiles_x,
                 num_tiles, keys.data_ptr(), recs.data_ptr())
    return keys, recs
