"""Backward tile rasterizer: per-record gradient rows in tile order.

Replaces brush_tpu/ops/pallas/rasterize_bwd.py (rasterize_bwd_pallas,
:414), its tile mode, its raster-cell mode and its strip mode (tile_base,
as in rasterize_fwd). The CUDA kernel is
brush_tpu_torch/csrc/rasterize_bwd.cu (one block per tile, also per
tile of a raster cell, whose tiles' partial rows a second kernel adds in
tile order; two pixels a thread, per-warp lists of the records that may
reach a warp's pixels, a back-to-front sweep, one folded warp butterfly
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

import torch

from brush_tpu_torch.constants import ALPHA_EPS, ALPHA_MAX
from brush_tpu_torch.ops.cuda import build
from brush_tpu_torch.ops.cuda.rasterize_fwd import (
    PLAIN_CHUNK, SIGMA_MARGIN, _check_inputs as _check_pool, bf16_parts,
    cell_lanes, cell_pixels, check_cell, check_tile_base, scan_batches,
    scan_mode, unpack_record_rows,
)

GRAD_ROWS = 9


def _suffix_excl(v: torch.Tensor) -> torch.Tensor:
    """Sum over the later records (dim 1) of each, the record excluded."""
    return torch.flip(torch.cumsum(torch.flip(v, [1]), dim=1), [1]) - v


def rasterize_bwd_plain(packed, starts, ends, tiles_x: int, v_out, log_t,
                        fidx, cell=(1, 1), tile_base: int = 0,
                        count_pairs: bool = False, reach=None,
                        scan_passes: int = 3, k_lanes: int | None = None):
    """PyTorch version of csrc/rasterize_bwd.cu: one cell at a time, the
    cell's records swept back to front in chunks of (P pixels x
    PLAIN_CHUNK) block math — the per-pixel log T and the colour "behind"
    sums come from suffix cumsums instead of the kernel's running
    subtraction, so the two agree up to float32 summation order. Local
    cell t is the image's cell tile_base + t, as in rasterize_fwd_plain.

    scan_passes < 3 with k_lanes (default 512) a multiple of 128 is the
    TPU kernel's truncated scan (rasterize_fwd.scan_mode): the sweep goes
    back to front over the kernel's batches (rasterize_fwd.scan_batches,
    from the last one the sweep touches down to the one holding the
    cell's start, rasterize_bwd.py:99-117); within a batch log T and the
    colour behind take suffix sums of bf16_parts of m = log1p(-alpha) and
    of contrib = cw fac, each record's T the exact m; and both carry to the
    batch in front by the truncated batch totals, as rasterize_bwd.py:
    345-346 does. Otherwise the scan is exact, as at scan_passes=3.

    Returns grads (GRAD_ROWS, pool); with count_pairs also the (pixel,
    record) pairs the sweep evaluates and how many of them are active;
    with count_pairs and `reach` (ops/cuda/testing.may_reach_f32, the
    kernel's list rule) also reach_pairs: the pairs whose record the
    kernel's per-warp list keeps for the pixel's 16x4 warp patch (j at
    most the patch's largest final_idx, and `reach` true for the patch's
    rectangle), the pairs a sweep of those lists evaluates.
    """
    passes, k_lanes = scan_mode(scan_passes, k_lanes)
    dev = packed.device
    pool = packed.shape[1]
    grads = torch.zeros((GRAD_ROWS, pool), dtype=torch.float32, device=dev)
    p = cell_pixels(cell)
    last_f = fidx.amax(dim=1) + 1 if fidx.numel() else fidx.new_zeros(0)
    swept = active = reach_pairs = 0
    for t, (s, e, lf) in enumerate(zip(starts.tolist(), ends.tolist(),
                                       last_f.tolist())):
        last = min(e, lf)
        if last <= s:
            continue
        pix_x, pix_y = cell_lanes(tiles_x, cell, tile_base + t,
                                  dev).unbind(dim=1)
        if reach is not None:
            # Each pixel's warp patch: 16 wide on its tile's columns, 4
            # high on rows of multiples of 4 in the image; the patch's
            # largest final_idx and its pixel count.
            corner = torch.stack([torch.floor(pix_x / 16.0) * 16.0,
                                  torch.floor(pix_y / 4.0) * 4.0], 1)
            patches, patch_of = torch.unique(corner, dim=0,
                                             return_inverse=True)
            pxa, pya = patches[:, 0] + 0.5, patches[:, 1] + 0.5
            wmax = torch.full((patches.shape[0],), -1, dtype=torch.int64,
                              device=dev).scatter_reduce(
                0, patch_of, fidx[t].to(torch.int64), "amax")
            npix = torch.bincount(patch_of, minlength=patches.shape[0])
        v_rgb = v_out[t, :, :3]
        v_a = v_out[t, :, 3:4]
        lt = log_t[t]
        t_final = torch.exp(lt)[:, None]
        s_behind = torch.zeros(p, dtype=torch.float32, device=dev)
        fi = fidx[t].to(torch.int64)[:, None]
        chunks = (scan_batches(s, last, k_lanes)[::-1] if passes else
                  [(max(s, be - PLAIN_CHUNK), be)
                   for be in range(last, s, -PLAIN_CHUNK)])
        for bs, be in chunks:
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
                if reach is not None:
                    smax = torch.log(255.0 * o) + SIGMA_MARGIN
                    keep = reach(x[:, None], y[:, None], cxx[:, None],
                                 cxy[:, None], cyy[:, None], smax[:, None],
                                 pxa[None], pxa[None] + 15.0, pya[None],
                                 pya[None] + 3.0)
                    keep = keep & (idx[0][:, None] <= wmax[None, :])
                    reach_pairs += int((keep.to(torch.int64)
                                        * npix[None, :]).sum())
            alpha = torch.where(act, alpha, torch.zeros_like(alpha))
            m = torch.log1p(-alpha)
            m_scan = bf16_parts(m, passes) if passes else m
            t_before = torch.exp(lt[:, None] - _suffix_excl(m_scan) - m)
            fac = alpha * t_before
            cw = v_rgb[:, 0:1] * cr + v_rgb[:, 1:2] * cg + v_rgb[:, 2:3] * cb
            contrib = cw * fac
            c_scan = bf16_parts(contrib, passes) if passes else contrib
            behind = s_behind[:, None] + _suffix_excl(c_scan)
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
            lt = lt - m_scan.sum(dim=1)
            s_behind = s_behind + c_scan.sum(dim=1)
    if count_pairs and reach is not None:
        return grads, swept, active, reach_pairs
    if count_pairs:
        return grads, swept, active
    return grads


def _check_inputs(packed, starts, ends, v_out, log_t, fidx, cell):
    _check_pool(packed, starts, ends)
    t = starts.shape[0]
    p = cell_pixels(cell)
    build.check_tensors(("starts", starts, (t,), torch.int32),
                        ("v_out", v_out, (t, p, 4), torch.float32),
                        ("log_t", log_t, (t, p), torch.float32),
                        ("final_idx", fidx, (t, p), torch.int32))


def rasterize_bwd(packed, starts, ends, tiles_x: int, v_out, log_t, fidx,
                  cell=(1, 1), tile_base: int = 0, *, scan_passes: int = 3,
                  k_lanes: int | None = None):
    """Per-record gradient rows (GRAD_ROWS, pool) on the inputs' device:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    cell, tiles_x and tile_base as in rasterize_fwd; scan_passes and
    k_lanes are the TPU kernel's (rasterize_bwd_plain says what they
    compute), the default 3 the exact scan, as rasterize_bwd_pallas's."""
    gw, gh = check_cell(cell)
    tile_base = check_tile_base(tile_base)
    _check_inputs(packed, starts, ends, v_out, log_t, fidx, (gw, gh))
    passes, k_lanes = scan_mode(scan_passes, k_lanes)
    if packed.device.type == "cpu":
        return rasterize_bwd_plain(packed, starts, ends, tiles_x, v_out,
                                   log_t, fidx, (gw, gh), tile_base,
                                   scan_passes=scan_passes, k_lanes=k_lanes)
    if packed.device.type != "cuda":
        raise ValueError(f"rasterize_bwd: unsupported device {packed.device}")
    args = [x.contiguous() for x in (packed, starts, ends, v_out, log_t,
                                     fidx)]
    packed, starts, ends, v_out, log_t, fidx = args
    dev = packed.device
    grads = torch.zeros((GRAD_ROWS, packed.shape[1]), dtype=torch.float32,
                        device=dev)
    # Scratch for the kernel's own cell order (heaviest cells start first),
    # and, for a cell of several tiles, the partial rows of every tile but
    # the first, which a second kernel adds into grads in tile order, and
    # each cell's end of the range swept (an int a cell).
    order = torch.empty_like(starts)
    partial = torch.empty(
        ((gw * gh - 1) * GRAD_ROWS * packed.shape[1] + starts.shape[0]
         if gw * gh > 1 else 1,), dtype=torch.float32, device=dev)
    build.launch("rasterize_bwd_launch", dev, packed.data_ptr(),
                 packed.shape[1], starts.data_ptr(), ends.data_ptr(),
                 starts.shape[0], tile_base, tiles_x, gw, gh, passes, k_lanes,
                 v_out.data_ptr(), log_t.data_ptr(), fidx.data_ptr(),
                 grads.data_ptr(), order.data_ptr(), partial.data_ptr())
    return grads


def kernel_attrs() -> dict:
    """What nvcc made of each instantiation of the CUDA sweep, read on the
    card (cudaFuncGetAttributes): {passes: (registers a thread, local
    memory a thread in bytes, blocks an SM can hold)}; passes 0 is the
    exact scan."""
    return {passes: build.read_attrs("rasterize_bwd_attrs", passes)
            for passes in (0, 1, 2)}
