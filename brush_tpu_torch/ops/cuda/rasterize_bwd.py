"""Backward tile rasterizer: per-record gradient rows in tile order.

Replaces brush_tpu/ops/pallas/rasterize_bwd.py (rasterize_bwd_pallas,
:414), its tile mode and its raster-cell mode. The CUDA kernel is
brush_tpu_torch/csrc/rasterize_bwd.cu (one block per tile or cell,
several pixels a thread, a back-to-front sweep, one folded warp butterfly
for the nine pixel sums; its header gives the formulas, the design and
the bound). `rasterize_bwd_plain` below is the same function in PyTorch:
CPU tensors take it, and tests and chip_smoke.py hold the kernel to it.

Inputs are the forward's: the packed pool (8, pool) int32 (rasterize_fwd
layout), the cell ranges starts/ends (C,) int32, the image cotangent
v_out (C, P, 4) float32 (RGBA, the alpha channel included), and the
forward's log_t (C, P) and final_idx (C, P), with P = 256 gw gh pixels a
cell of cell=(gw, gh) tiles in rasterize_fwd.cell_lanes' order (a cell of
(1, 1) is a tile). The output is (GRAD_ROWS, pool) float32 in pool order:
v_x, v_y, v_cxx, v_cxy, v_cyy, v_r, v_g, v_b, v_opacity, each summed over
the P pixels of the record's cell; slots that no sweep reaches are zero.
"""

from __future__ import annotations

import ctypes

import torch

from brush_tpu_torch.constants import ALPHA_EPS, ALPHA_MAX
from brush_tpu_torch.ops.cuda import build
from brush_tpu_torch.ops.cuda.rasterize_fwd import (
    PLAIN_CHUNK, _check_inputs as _check_pool, cell_lanes, cell_pixels,
    check_cell, unpack_record_rows,
)

GRAD_ROWS = 9

# Launches of the CUDA kernel (not of the plain version) in this process.
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _suffix_excl(v: torch.Tensor) -> torch.Tensor:
    """Sum over the later records (dim 1) of each, the record excluded."""
    return torch.flip(torch.cumsum(torch.flip(v, [1]), dim=1), [1]) - v


def rasterize_bwd_plain(packed, starts, ends, tiles_x: int, v_out, log_t,
                        fidx, cell=(1, 1), count_pairs: bool = False):
    """PyTorch version of csrc/rasterize_bwd.cu: one cell at a time, the
    cell's records swept back to front in chunks of (P pixels x
    PLAIN_CHUNK) block math — the per-pixel log T and the colour "behind"
    sums come from suffix cumsums instead of the kernel's running
    subtraction, so the two agree up to float32 summation order.

    Returns grads (GRAD_ROWS, pool); with count_pairs also the (pixel,
    record) pairs the sweep evaluates and how many of them are active.
    """
    dev = packed.device
    pool = packed.shape[1]
    grads = torch.zeros((GRAD_ROWS, pool), dtype=torch.float32, device=dev)
    p = cell_pixels(cell)
    last_f = fidx.amax(dim=1) + 1 if fidx.numel() else fidx.new_zeros(0)
    swept = active = 0
    for t, (s, e, lf) in enumerate(zip(starts.tolist(), ends.tolist(),
                                       last_f.tolist())):
        last = min(e, lf)
        if last <= s:
            continue
        pix_x, pix_y = cell_lanes(tiles_x, cell, t, dev).unbind(dim=1)
        v_rgb = v_out[t, :, :3]
        v_a = v_out[t, :, 3:4]
        lt = log_t[t]
        t_final = torch.exp(lt)[:, None]
        s_behind = torch.zeros(p, dtype=torch.float32, device=dev)
        fi = fidx[t].to(torch.int64)[:, None]
        for be in range(last, s, -PLAIN_CHUNK):
            bs = max(s, be - PLAIN_CHUNK)
            x, y, cxx, cxy, cyy, cr, cg, cb, o = unpack_record_rows(
                packed[:, bs:be])
            dx = x[None, :] - pix_x[:, None]
            dy = y[None, :] - pix_y[:, None]
            sigma = 0.5 * (cxx * dx * dx + cyy * dy * dy) + cxy * dx * dy
            vis = torch.exp(-torch.clamp(sigma, min=0.0))
            alpha = torch.clamp(o * vis, max=ALPHA_MAX)
            idx = torch.arange(bs, be, device=dev)[None, :]
            act = (idx <= fi) & (sigma >= 0.0) & (alpha >= ALPHA_EPS)
            if count_pairs:
                swept += act.numel()
                active += int(act.sum())
            alpha = torch.where(act, alpha, torch.zeros_like(alpha))
            m = torch.log1p(-alpha)
            t_before = torch.exp(lt[:, None] - _suffix_excl(m) - m)
            fac = alpha * t_before
            cw = v_rgb[:, 0:1] * cr + v_rgb[:, 1:2] * cg + v_rgb[:, 2:3] * cb
            contrib = cw * fac
            behind = s_behind[:, None] + _suffix_excl(contrib)
            ra = 1.0 / (1.0 - alpha)
            v_alpha = torch.where(
                act, cw * t_before - behind * ra + t_final * ra * v_a,
                torch.zeros_like(alpha))
            vs = -o * vis * v_alpha
            terms = (vs * (cxx * dx + cxy * dy), vs * (cxy * dx + cyy * dy),
                     0.5 * vs * dx * dx, vs * dx * dy, 0.5 * vs * dy * dy,
                     fac * v_rgb[:, 0:1], fac * v_rgb[:, 1:2],
                     fac * v_rgb[:, 2:3], vis * v_alpha)
            grads[:, bs:be] = torch.stack([g.sum(dim=0) for g in terms])
            lt = lt - m.sum(dim=1)
            s_behind = s_behind + contrib.sum(dim=1)
    if count_pairs:
        return grads, swept, active
    return grads


def _check_inputs(packed, starts, ends, v_out, log_t, fidx, cell):
    _check_pool(packed, starts, ends)
    t = starts.shape[0]
    p = cell_pixels(cell)
    for name, x, shape, dtype in (
            ("v_out", v_out, (t, p, 4), torch.float32),
            ("log_t", log_t, (t, p), torch.float32),
            ("final_idx", fidx, (t, p), torch.int32)):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != packed.device:
            raise ValueError(f"{name} on {x.device}, packed on "
                             f"{packed.device}")


def rasterize_bwd(packed, starts, ends, tiles_x: int, v_out, log_t, fidx,
                  cell=(1, 1)):
    """Per-record gradient rows (GRAD_ROWS, pool) on the inputs' device:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    cell and tiles_x as in rasterize_fwd."""
    gw, gh = check_cell(cell)
    _check_inputs(packed, starts, ends, v_out, log_t, fidx, (gw, gh))
    if packed.device.type == "cpu":
        return rasterize_bwd_plain(packed, starts, ends, tiles_x, v_out,
                                   log_t, fidx, (gw, gh))
    if packed.device.type != "cuda":
        raise ValueError(f"rasterize_bwd: unsupported device {packed.device}")
    global launches
    args = [x.contiguous() for x in (packed, starts, ends, v_out, log_t,
                                     fidx)]
    packed, starts, ends, v_out, log_t, fidx = args
    dev = packed.device
    grads = torch.zeros((GRAD_ROWS, packed.shape[1]), dtype=torch.float32,
                        device=dev)
    # Scratch for the kernel's own cell order (heaviest cells start first),
    # and, for a cell of several tiles, each pixel's transmittance and
    # colour behind between the sweeps of its tile.
    order = torch.empty_like(starts)
    state = torch.empty((2, log_t.numel() if gw * gh > 1 else 1),
                        dtype=torch.float32, device=dev)
    lib = build.load("rasterize_bwd")
    fn = lib.rasterize_bwd_launch
    fn.argtypes = [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                   _P]
    fn.restype = _I
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(packed.data_ptr(), packed.shape[1], starts.data_ptr(),
                ends.data_ptr(), starts.shape[0], tiles_x, gw, gh,
                v_out.data_ptr(), log_t.data_ptr(), fidx.data_ptr(),
                grads.data_ptr(), order.data_ptr(), state.data_ptr(), stream)
    build.check(rc, "rasterize_bwd")
    launches += 1
    return grads
