#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (brush_tpu_torch) runs on an
NVIDIA GPU. Run from the repository root on a machine with one card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero without its
result line; each phase prints its seconds):
  1. build the CUDA kernels from brush_tpu_torch/csrc/ (one nvcc per
     source, in parallel) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card, at
     the entry scene (16384 splats, 256x256) and at the bench scene's
     render inputs: expand byte-equal; rasterize_fwd img and log_t within
     1e-5 with threshold flips counted and bounded (<= 2e-3 of the pixels,
     img and T = exp(log_t) within 0.01 at each) and final_idx equal on
     every other pixel, and a second launch on the same inputs
     bit-equal, here and wherever it is checked below; rasterize_fwd
     also on tile layouts made by hand (a tile deeper than three staging
     batches, a tile whose pixels all cross the
     transmittance threshold in mid-batch before bright records, opacity
     words around 1/255, an empty tile between full ones, an odd number of
     tiles a row); at the entry scene also rasterize_bwd (on the kernel
     forward's log T and final_idx and a seeded image cotangent) with
     every gradient row within 1e-4 of that row's largest value, and
     segment_sum on the re-sorted rows within 1e-5 of each row's largest
     sum; both backward kernels launched
     twice on the same inputs must give the same bits, here and wherever
     they are checked below; the same checks of all four kernels at the
     entry scene in raster cells of (2, 2) and (4, 2) tiles (CHECK_CELLS);
     segment_sum also on a layout made by hand
     (a segment of 100,003 slots, runs of empty splats, n no multiple of
     the kernel's block, `total` cutting a segment and `total` 0);
  3. the render path at full width: render_splats(needs_grad=False) of the
     bench scene (1M random splats, SH degree 1, 1024x1024, pool 2162688),
     with the launch counters reset just before and read just after; then
     the median of 10 CUDA-event-timed renders and the forward kernels'
     times at these inputs; then the same at raster cell CELL (2, 2), its
     kernels held to their plain versions on its inputs, its records
     beside (1, 1)'s and its image held to (1, 1)'s with rasterize_fwd's
     tolerance (the differing pixels counted);
  4. a real model: serve docs/castle_r5_30k.ply through eval_stats at
     800x800 on four cameras of its training orbit, against the same
     views rendered by the port on the CPU (the plain versions);
     rasterize_fwd's check on each of those views and the backward
     kernels' on one (real opacities: saturating pixels, the early-out);
     at each of CHECK_CELLS (800x800 is 50x50 tiles, which (4, 2) does
     not divide) rasterize_fwd's check on view 0 (and at CELL the backward
     kernels'), then eval_stats, launches counted, each image held to the
     (1, 1) one with CELL_IMAGE_TOL (see there why not equal);
  5. the main path of training at full width: SplatTrainer on the bench
     scene against a black ground truth (bench.py:210-231), 6 steps with
     warmup 1 and refine every 3, so refine runs at iterations 1 (through
     the pre-grow path, capacity 1M -> 2M) and 4 (2M -> 4M); all four
     kernels' counters reset just before and read just after; every
     step's CUDA-event time. The pipeline's calls to the four kernels keep
     their arguments on the first step at each capacity; then the train
     step metric: 8 warm steps at the capacity the run ends at; then all
     of it again with SplatTrainer(raster_cell=CELL);
  6. each kernel against its plain version (tolerances as in phase 2) on
     the arguments each training run gave it at the capacity it ends at,
     the real loss cotangent included; the kernels' times, bounds and
     errors in the result come from these arguments;
  7. a real model trains: the castle's SH DC coefficients perturbed by
     0.1 N(0, 1), 12 default SplatTrainer steps on its four clean views;
     the eval PSNR must rise;
  8. "cli", the user's path through brush_tpu_torch.cli at full width in a
     temporary directory: a NeRF-synthetic castle dataset (100 train and
     16 val views, 800x800 RGBA PNG, the orbit of
     scripts/raytrace_scene.py) rendered by the port from the castle, and
     its twin with libpng's adaptive row filters (loaded and timed once,
     images equal); `train` 620 steps (eval every 200 on 4 views,
     checkpoints every 200, refines at 501 and 601, PLY export) with all
     four kernels' counters reset just before and read just after: one
     launch of each a step and of the forward two one an eval render
     (pool-growth retries counted); the kernels' arguments kept on the
     first step and the first after each refine, and each kernel held to
     its plain version on the first and the last of them (tolerances as
     in phase 2); `train --cell 2x2` for CLI_CELL_ITERS steps, every render
     at the cell, launches counted alike, its eval PSNR at 200 within
     CLI_CELL_PSNR_TOL dB of the (1, 1) run's; finite losses,
     eval PSNR at 600 above 200; `eval --ply` and `eval --ckpt` print the
     run's final PSNR digit for digit; `--resume` from 400 runs 401..419;
     the trained castle saved as a checkpoint at step 29800 and resumed
     for 200 steps (the step time at a model's real size); `render` writes
     a non-blank PNG; a 24-view COLMAP castle (RGB on black, the castle's
     90,977 means as points3D, native parser == Python parser) trains 100
     timed steps; `train2d` at 256x256 lowers its loss;
  9. print {"kernels": [...]}: launches from the "cli" train run, the other
     fields from phase 6's (1, 1) arguments, under "cli" the same fields
     on the cli run's last arguments, and for the two rasterizers under
     "cell" those of the training at CELL; the nvidia-smi line; and last
     {"ok": true, "device": {...}}.
The script imports nothing of JAX or of the JAX package.
"""

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32
# outside the tensor cores. The bound of a kernel is the larger of its
# bytes over the memory rate and its operations over the peak rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float32 operations the rasterizers need per (pixel, record) pair. Every
# pair a sweep evaluates: two subtractions, seven multiplies and two adds
# for sigma and two compares (sigma >= 0, and sigma against the largest one
# at which the record's alpha can reach ALPHA_EPS). Only a pair that passes
# needs alpha: max, negate, exp, multiply, min and two compares (its
# log1p/exp/colour work in rasterize_fwd is not counted: the bound stays a
# lower bound).
PAIR_SIGMA_OPS = 13
PAIR_ALPHA_OPS = 7
# rasterize_bwd, for every active pair 45 more: the transmittance before
# the record (a log1p and two exps in the reference's form), a division,
# ~23 multiplies and adds for v_alpha and the nine terms, and the nine
# terms' share of the pixel reduction.
BWD_OPS_PER_ACTIVE = 45
BWD_RTOL = 1e-4   # rasterize_bwd vs plain, per row, relative to the row max
SEG_RTOL = 1e-5   # segment_sum vs plain, likewise
TRAIN_STEPS = 6
METRIC_STEPS = 8     # warm steps at the final capacity, after one more
CASTLE_TRAIN_STEPS = 12
# The "cli" phase: the NeRF-synthetic layout at its published size, the
# 620-step run (refines at 501 and 601) and the COLMAP dataset's views.
CLI_NERF_TRAIN, CLI_NERF_VAL = 100, 16
CLI_ITERS = 620
CLI_COLMAP_VIEWS = 24
CLI_DEVICE = "cuda"   # the CLI's --device
# The trained castle resumed through the CLI at this step, past the last
# refine (TrainConfig.max_refine_step 15000), for this many steps.
CASTLE_RESUME_STEP, CASTLE_RESUME_STEPS = 29800, 200
# Raster cells: the one the bench render, the bench training and `cli train
# --cell` run at, and those the kernels are checked at on the entry scene
# and the castle evaluated at (50x50 tiles: (4, 2) does not divide them).
CELL = (2, 2)
CHECK_CELLS = ((2, 2), (4, 2))
CLI_CELL_ITERS = 220   # `cli train --cell 2x2`: its eval at 200
CLI_CELL_PSNR_TOL = 0.5   # dB from the (1, 1) run's eval at 200

ENTRY = dict(n=16384, lo=-2.0, hi=2.0, z=-6.0, size=256, block=64, pool=None)
BENCH = dict(n=1 << 20, lo=-3.0, hi=3.0, z=-8.0, size=1024, block=512,
             pool=2162688)
CASTLE_PLY = os.path.join(ROOT, "docs", "castle_r5_30k.ply")
CASTLE_SIZE = 800
CASTLE_FOV_X = 0.8575560   # scripts/raytrace_scene.py write_nerf_zip


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds of fn() over reps runs between two CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def make_scene(cfg, device):
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.splats import from_random

    splats = from_random(np.random.default_rng(0), [cfg["lo"]] * 3,
                         [cfg["hi"]] * 3, count=cfg["n"], sh_degree=1,
                         capacity=cfg["n"], device=device)
    cam = Camera(position=[0, 0, cfg["z"]], rotation=[1, 0, 0, 0],
                 fov_x=np.pi / 2, fov_y=np.pi / 2)
    size = (cfg["size"], cfg["size"])
    return splats, camera_params(cam, size, device=device), size


def kernel_inputs(splats, cp, size, pool, cell=(1, 1)):
    """The main path's stages up to each kernel at raster cell `cell`, the
    kernels on the card: the expand arguments, the rasterize_fwd arguments
    (packed, starts, ends, cells_x, cell) and the depth order's offsets."""
    from brush_tpu_torch.ops.cuda.expand import expand
    from brush_tpu_torch.ops.pipeline import depth_order, tile_bins
    from brush_tpu_torch.render import record_inputs

    rec = record_inputs(splats.means, splats.log_scales, splats.quats,
                        splats.sh_coeffs, splats.raw_opacity, cp, size,
                        active=splats.active_mask(), cell=cell)
    d = depth_order(rec.attrs9, rec.decode, rec.depth_key, pool)
    cells_x = -(-size[0] // (16 * cell[0]))
    num_cells = cells_x * -(-size[1] // (16 * cell[1]))
    exp_args = (d.f5, d.u5, d.cum, d.total, cells_x, num_cells, pool)
    packed, starts, ends = tile_bins(*expand(*exp_args), num_cells)
    return dict(exp_args=exp_args,
                r_args=(packed, starts, ends, cells_x, tuple(cell)),
                offsets=d.offsets, raw_total=int(d.raw_total))


def timed(fn):
    """(fn(), the CUDA-event ms of that one call): the plain versions'
    time, taken on the call that the check compares with."""
    import torch

    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def check_expand(exp_args):
    """Kernel vs plain, byte for byte: returns the plain version's ms."""
    import torch
    from brush_tpu_torch.ops.cuda.expand import expand, expand_plain

    keys, recs = expand(*exp_args)
    torch.cuda.synchronize()
    (pk, pr), plain_ms = timed(lambda: expand_plain(*exp_args))
    bad = int((keys != pk).sum()) + int((recs != pr).sum())
    if bad:
        raise AssertionError(f"expand: {bad} words differ from the plain "
                             "version")
    return plain_ms


def raster_diff(out, plain, atol=1e-5):
    """A rasterizer's (img, log_t, final_idx) against the plain version's.
    A pixel whose img or log T differs by more than atol is a flip: one
    record on the other side of the alpha or the transmittance threshold.
    Returns dict(err=largest img or log T difference on the other pixels,
    flips=flipped pixels, flip_err=largest difference at a flipped pixel,
    of img and of T = exp(log T), fidx=final_idx mismatches on the other
    pixels). At a flip T is compared, as the image sees it: the record on
    which a pixel crosses TRANSMITTANCE_EPS moves log T by log(1 - alpha)
    but T by less than the threshold."""
    import torch

    (img, log_t, fidx), (p_img, p_log_t, p_fidx) = out, plain
    d_img = (img - p_img).abs().amax(dim=-1)
    d_lt = (log_t - p_log_t).abs()
    d_t = (log_t.exp() - p_log_t.exp()).abs()
    flipped = (d_img > atol) | (d_lt > atol)
    zero = torch.zeros_like(d_img)
    return dict(
        err=float(torch.where(flipped, zero,
                              torch.maximum(d_img, d_lt)).max()),
        flips=int(flipped.sum()),
        flip_err=float(torch.where(flipped, torch.maximum(d_img, d_t),
                                   zero).max()),
        fidx=int(((fidx != p_fidx) & ~flipped).sum()))


def check_raster(r_args, flip_tol=0.01, max_flip_frac=2e-3):
    """Kernel vs plain, and two launches bit-equal: returns raster_diff's
    dict and pairs=(pixel, record) pairs the sweep evaluates, active=those
    that reach the alpha threshold, plain_ms, out=the kernel's outputs."""
    import torch
    from brush_tpu_torch.ops.cuda.rasterize_fwd import (
        rasterize_fwd, rasterize_fwd_plain,
    )

    img, log_t, fidx = rasterize_fwd(*r_args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((img, log_t, fidx),
                                                 rasterize_fwd(*r_args))):
        raise AssertionError("rasterize_fwd: two launches on the same "
                             "inputs differ")
    (*plain, (pairs, active)), plain_ms = timed(
        lambda: rasterize_fwd_plain(*r_args, count_pairs=True))
    d = raster_diff((img, log_t, fidx), plain)
    limit = max(1, int(max_flip_frac * fidx.numel()))
    if d["flip_err"] > flip_tol or d["flips"] > limit or d["fidx"]:
        raise AssertionError(
            f"rasterize_fwd: max err {d['err']:.3e}, {d['flips']} flipped "
            f"pixels (limit {limit}, largest {d['flip_err']:.3e}), "
            f"{d['fidx']} final_idx mismatches elsewhere")
    return dict(d, pairs=pairs, active=active, plain_ms=plain_ms,
                out=(img, log_t, fidx))


def check_raster_hand():
    """rasterize_fwd against its plain version on the tile layouts of
    ops/cuda/testing.hand_tiles; on the opaque tile the records behind the
    last crossing must change no bit of the output."""
    import torch
    from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd
    from brush_tpu_torch.ops.cuda.testing import (
        HAND_POISON_FROM, HAND_TILE_CASES, hand_tiles,
    )

    t0 = time.perf_counter()
    seen = {}
    for case in HAND_TILE_CASES:
        packed, starts, ends, tiles_x = hand_tiles(case)
        args = (torch.tensor(packed).cuda(), torch.tensor(starts).cuda(),
                torch.tensor(ends).cuda(), tiles_x)
        r = check_raster(args)
        seen[case] = (r["err"], r["flips"])
        if case == "opaque":
            last = int(r["out"][2].max())
            cut = rasterize_fwd(args[0], args[1], torch.full_like(
                args[2], HAND_POISON_FROM), tiles_x)
            if last >= HAND_POISON_FROM - 1 or not all(
                    torch.equal(a, b) for a, b in zip(r["out"], cut)):
                raise AssertionError(
                    f"rasterize_fwd: records behind the crossing (last "
                    f"composited {last}) changed the opaque tile")
    print(f"[hand] rasterize_fwd (max err, flipped pixels) on tile "
          f"layouts {seen}; two launches bit-equal; the opaque tile's "
          f"records behind the crossing change nothing; "
          f"{time.perf_counter() - t0:.1f} s")


def check_bwd(b_args, label):
    """rasterize_bwd vs plain on b_args (packed, starts, ends, tiles_x,
    v_out, log_t, final_idx): returns dict(err=row error, abs=max abs
    error, plain_ms, swept/active=(pixel, record) pairs the sweep
    evaluates / that contribute, grads=the kernel's rows)."""
    import torch
    from brush_tpu_torch.ops.cuda.rasterize_bwd import (
        rasterize_bwd, rasterize_bwd_plain,
    )

    grads = rasterize_bwd(*b_args)
    torch.cuda.synchronize()
    if not torch.equal(grads, rasterize_bwd(*b_args)):
        raise AssertionError(f"[{label}] rasterize_bwd: two launches on "
                             "the same inputs differ")
    (plain, swept, active), plain_ms = timed(
        lambda: rasterize_bwd_plain(*b_args, count_pairs=True))
    err = row_error(grads, plain)
    if not torch.isfinite(grads).all() or err > BWD_RTOL:
        raise AssertionError(f"[{label}] rasterize_bwd: row error "
                             f"{err:.3e} > {BWD_RTOL:.0e}")
    return dict(err=err, abs=float((grads - plain).abs().max()),
                plain_ms=plain_ms, swept=swept, active=active, grads=grads)


def check_segsum(s_args, label):
    """segment_sum vs plain on s_args (rows, offsets, cum, total): returns
    dict(err=row error, abs=max abs error, plain_ms)."""
    import torch
    from brush_tpu_torch.ops.cuda.segsum import (
        segment_sum, segment_sum_plain,
    )

    seg = segment_sum(*s_args)
    torch.cuda.synchronize()
    if not torch.equal(seg, segment_sum(*s_args)):
        raise AssertionError(f"[{label}] segment_sum: two launches on the "
                             "same inputs differ")
    plain, plain_ms = timed(lambda: segment_sum_plain(*s_args))
    err = row_error(seg, plain)
    if err > SEG_RTOL:
        raise AssertionError(f"[{label}] segment_sum: row error "
                             f"{err:.3e} > {SEG_RTOL:.0e}")
    return dict(err=err, abs=float((seg - plain).abs().max()),
                plain_ms=plain_ms)


def check_segsum_hand():
    """segment_sum against its plain version on a layout made by hand,
    which the scenes do not reach: 70,001 splats (no multiple of the
    kernel's 256-splat block) of 0-3 slots each, 800 empty splats in a run
    and 300 at the end, one segment of 100,003 slots, a hundred of 70 and
    one of 600; `total` at the last slot, one slot into the long segment,
    in its middle, and 0. The rows are multiples of 1/16 below 4, so every
    order of summation gives the same float32 and the plain version's
    atomic adds cost it nothing: the two must agree to SEG_RTOL."""
    import torch

    n, pool = 70001, 262144
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(7)
    counts = torch.randint(0, 4, (n,), generator=gen)
    counts[100:900] = 0
    counts[1000] = 100_003
    counts[1500:1600] = 70
    counts[2000] = 600
    counts[n - 300:] = 0
    cum = torch.cumsum(counts, 0)
    raw = int(cum[-1])
    if raw > pool:
        raise AssertionError(f"hand-made layout: {raw} slots > pool {pool}")
    offsets = (cum - counts).to(torch.int32).cuda()
    cum = cum.to(torch.int32).cuda()
    rows = torch.randint(-63, 64, (9, pool), generator=gen).to(
        torch.float32).cuda() / 16.0
    long_lo = int(offsets[1000])
    errs = {}
    for name, value in (("all", raw), ("straddle", long_lo + 1),
                        ("mid", long_lo + 50_001), ("zero", 0)):
        total = torch.tensor([value], dtype=torch.int32, device="cuda")
        s = check_segsum((rows, offsets, cum, total), f"hand {name}")
        errs[name] = s["err"]
    print(f"[hand] segment_sum n={n} pool={pool}, {raw} slots, a segment "
          f"of {int(counts.max())}: row errors at total = all, one slot "
          f"into the long segment, its middle, 0: "
          f"{[errs[k] for k in ('all', 'straddle', 'mid', 'zero')]}; two "
          f"launches bit-equal; {time.perf_counter() - t0:.1f} s")


def check_backward(k, label, seed):
    """rasterize_bwd and segment_sum against their plain versions on the
    kernel forward's log T and final_idx and a seeded image cotangent."""
    import torch
    from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd
    from brush_tpu_torch.ops.pipeline import grad_resort

    packed, starts, ends, cells_x, cell = k["r_args"]
    _, log_t, fidx = rasterize_fwd(*k["r_args"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    v_out = torch.randn((*log_t.shape, 4), generator=gen, device="cuda")
    b_args = (packed, starts, ends, cells_x, v_out, log_t, fidx, cell)
    b = check_bwd(b_args, label)
    total = k["exp_args"][3]
    rows = grad_resort(b["grads"], packed[7], total, pack_grad_sort=False)
    s = check_segsum((rows, k["offsets"], k["exp_args"][2], total), label)
    print(f"[{label}] rasterize_bwd row error {b['err']:.3e} (max abs "
          f"{b['abs']:.3e}), pairs swept {b['swept']}, active "
          f"{b['active']}; segment_sum row error {s['err']:.3e}")
    return b


def row_error(got, want) -> float:
    """Largest |got - want| of each row over that row's largest |want|."""
    scale = want.abs().amax(dim=1).clamp(min=1e-30)
    return float(((got - want).abs().amax(dim=1) / scale).max())


def kernel_phase(cfg, label, backward: bool):
    """Phase 2 at one scene, at the render's pool: expand and
    rasterize_fwd, and with `backward` the backward kernels."""
    t0 = time.perf_counter()
    splats, cp, size = make_scene(cfg, "cuda")
    from brush_tpu_torch.render import pool_size

    k = kernel_inputs(splats, cp, size,
                      pool_size(splats.capacity, size, cfg["pool"],
                                cfg["block"]))
    k["expand_plain_ms"] = check_expand(k["exp_args"])
    r = check_raster(k["r_args"])
    total = int(k["exp_args"][3][0])
    print(f"[{label}] n={cfg['n']} {size[0]}x{size[1]} "
          f"pool={k['exp_args'][6]} records={total}: expand byte-equal; "
          f"rasterize_fwd max err {r['err']:.3e}, flipped pixels "
          f"{r['flips']}, pairs evaluated {r['pairs']}, of them active "
          f"{r['active']}")
    if backward:
        check_backward(k, label, seed=1)
    print(f"[{label}] {time.perf_counter() - t0:.1f} s")
    k["fwd"] = r
    return splats, cp, size, k


def bounds(k, fwd, bwd):
    """Least times (ms) for this run's inputs, with what bounds each:
    expand, rasterize_fwd, rasterize_bwd, segment_sum. fwd and bwd are
    check_raster's and check_bwd's results, whose plain versions counted
    the pairs each sweep evaluates and those that need alpha."""
    f5, u5, cum, total = k["exp_args"][:4]
    pool = k["exp_args"][6]
    n = f5.shape[1]
    live = int(total[0])
    n_cells = k["r_args"][1].shape[0]
    cell = k["r_args"][4]
    px = 256 * cell[0] * cell[1]   # a cell's pixels
    ms = lambda b: b / HBM_BYTES_PER_S * 1e3
    ops = lambda o: o / F32_OPS_PER_S * 1e3
    pick = lambda b, o: (max(ms(b), ops(o)),
                         "operations" if ops(o) >= ms(b) else "bytes")
    exp_b = (20 + 20 + 4) * n + 4 + (4 + 32) * pool
    fwd_b = 28 * live + 8 * n_cells + 24 * px * n_cells
    # bwd: records and cell ranges read, v_out + log T + final_idx read,
    # the (9, pool) gradient rows written once.
    bwd_b = 28 * live + 8 * n_cells + 24 * px * n_cells + 36 * pool
    fwd_o = PAIR_SIGMA_OPS * fwd["pairs"] + PAIR_ALPHA_OPS * fwd["active"]
    bwd_o = PAIR_SIGMA_OPS * bwd["swept"] + (
        PAIR_ALPHA_OPS + BWD_OPS_PER_ACTIVE) * bwd["active"]
    # segsum: the live slots' nine rows, offsets and cum read; (9, n) out.
    seg_b = 36 * live + 8 * n + 4 + 36 * n
    return {"expand": (ms(exp_b), "bytes"),
            "rasterize_fwd": pick(fwd_b, fwd_o),
            "rasterize_bwd": pick(bwd_b, bwd_o),
            "segment_sum": pick(seg_b, 9 * live)}


def forward_times(k, label):
    """The forward kernels' times at a render's inputs (launches after the
    render path's counts were read), beside their plain versions' (the
    call the check compared with) and their bounds."""
    from brush_tpu_torch.ops.cuda.expand import expand
    from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd

    exp_args, r_args = k["exp_args"], k["r_args"]
    e_ms = cuda_ms(lambda: expand(*exp_args), reps=20)
    r_ms = cuda_ms(lambda: rasterize_fwd(*r_args), reps=20)
    # No backward ran on these inputs: its bound is not read.
    bound = bounds(k, k["fwd"], dict(swept=0, active=0))
    print(f"[kernels] {label}: expand {e_ms:.4f} ms (plain "
          f"{k['expand_plain_ms']:.3f}, bound {bound['expand'][0]:.4f} by "
          f"{bound['expand'][1]}); rasterize_fwd {r_ms:.4f} ms (plain "
          f"{k['fwd']['plain_ms']:.3f}, bound "
          f"{bound['rasterize_fwd'][0]:.4f} by "
          f"{bound['rasterize_fwd'][1]})")


def main_path(splats, cp, size, cfg, cell=(1, 1)):
    """Phase 3 (and the cell phase): one counted render of the bench scene
    at raster cell `cell`, then timings. Returns (launch counts, image,
    records, median ms)."""
    import torch
    from brush_tpu_torch.ops.cuda import expand, rasterize_fwd
    from brush_tpu_torch.render import render_splats

    def render():
        return render_splats(
            splats.means, splats.log_scales, splats.quats, splats.sh_coeffs,
            splats.raw_opacity, cp, size, active=splats.active_mask(),
            block_size=cfg["block"], max_isects=cfg["pool"], cell=cell,
            needs_grad=False)

    expand.launches = 0
    rasterize_fwd.launches = 0
    img, aux = render()
    torch.cuda.synchronize()
    counts = {"expand": expand.launches,
              "rasterize_fwd": rasterize_fwd.launches}
    if min(counts.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {counts}")
    dropped = int(aux.num_dropped)
    if dropped != 0:
        raise AssertionError(f"bench render dropped {dropped} records")
    if tuple(img.shape) != (size[1], size[0], 4) \
            or not bool(torch.isfinite(img).all()):
        raise AssertionError("bench render is not a finite (h, w, 4) image")
    for _ in range(2):
        render()
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        render()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    ms = statistics.median(times)
    tag = "main path" if tuple(cell) == (1, 1) else f"cell {cell}"
    print(f"[{tag}] bench render {size[0]}x{size[1]}, {cfg['n']} splats, "
          f"cell {cell}: visible={int(aux.num_visible)} "
          f"records={int(aux.num_isects)} dropped={dropped} launches={counts}")
    print(f"[{tag}] median of 10 renders {ms:.3f} ms "
          f"({size[0] * size[1] / ms / 1e3:.2f} Mpix/s); all ms "
          f"{[round(t, 3) for t in times]}")
    return counts, img, int(aux.num_isects), ms


def image_diff(got, want, atol=1e-5):
    """Two (h, w, C) images: dict(differ=pixels that differ at all,
    flips=pixels that differ by more than atol, err=largest difference
    elsewhere, flip_err=largest difference at a flip, beyond_1e5=pixels
    that differ by more than 1e-5)."""
    import torch

    d = (got - want).abs().amax(dim=-1)
    flipped = d > atol
    zero = torch.zeros_like(d)
    return dict(differ=int((d > 0).sum()), flips=int(flipped.sum()),
                beyond_1e5=int((d > 1e-5).sum()),
                err=float(torch.where(flipped, zero, d).max()),
                flip_err=float(torch.where(flipped, d, zero).max()))


# An image at a raster cell against the (1, 1) image. The per-pixel
# arithmetic is the same at every cell, but the set of records is not: the
# projection's tile bbox is the 3-sigma one (helpers.wgsl:192-202), inside
# which the alpha threshold of an opaque splat (sigma = log(255 o), up to
# 5.54 against 4.5) does not always fall, and a cell bbox is the tile bbox
# rounded out to whole cells, so at a cell a splat reaches pixels up to a
# tile past its tile bbox where its alpha passes 1/255. Where no splat's
# fringe crosses its bbox (the bench scene) the images are equal; where
# many do (the castle's opaque splats) brush_tpu's Pallas pipeline moves
# the same pixels by the same amounts (tests/test_torch_castle.py), and the
# reference's own rule for cell against tile images holds
# (tests/test_pipeline.py:270-272: 2e-3, at most 2e-3 of the values beyond
# it, each within 0.05), counted here by pixel.
CELL_IMAGE_TOL = dict(atol=2e-3, flip_tol=0.05, max_flip_frac=2e-3)
FWD_IMAGE_TOL = dict(atol=1e-5, flip_tol=0.01, max_flip_frac=2e-3)


def check_cell_image(got, want, label, atol, flip_tol, max_flip_frac):
    """An image rendered at a raster cell against the (1, 1) image: within
    atol but for at most max_flip_frac of the pixels, each within
    flip_tol. Returns image_diff's dict."""
    d = image_diff(got, want, atol)
    limit = max(1, int(max_flip_frac * got.shape[0] * got.shape[1]))
    if d["flips"] > limit or d["flip_err"] > flip_tol:
        raise AssertionError(f"[{label}] image differs from the (1, 1) one "
                             f"beyond atol {atol} (limit {limit} pixels, "
                             f"{flip_tol} each): {d}")
    return d


def orbit_camera(azimuth, elevation, radius=3.6, target=(0.0, 0.0, 0.35)):
    """A camera on the castle's training orbit: the NeRF camera-to-world of
    scripts/raytrace_scene.py:orbit_c2w, converted as
    brush_tpu/datasets/nerf.py:camera_from_transform converts a NeRF pose."""
    from brush_tpu_torch.camera import (
        Camera, focal_to_fov, fov_to_focal, rotmat_to_quat,
    )

    target = np.asarray(target, np.float64)
    pos = target + radius * np.array([
        np.cos(elevation) * np.sin(azimuth),
        np.cos(elevation) * np.cos(azimuth),
        np.sin(elevation)])
    fwd = (pos - target) / np.linalg.norm(pos - target)
    right = np.cross([0.0, 0.0, 1.0], fwd)
    right /= np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = (right, np.cross(fwd, right),
                                              fwd, pos)
    m[:, 1] *= -1.0
    m[:, 2] *= -1.0
    rot_x_90 = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
    fov_y = focal_to_fov(fov_to_focal(CASTLE_FOV_X, CASTLE_SIZE),
                         CASTLE_SIZE)
    return Camera(position=rot_x_90 @ m[:3, 3],
                  rotation=rotmat_to_quat(rot_x_90 @ m[:3, :3]),
                  fov_x=CASTLE_FOV_X, fov_y=fov_y)


def castle_phase():
    """Phase 4: eval_stats on the card against the CPU (plain) render.
    Returns the card's splats, the cameras, the views and the pool."""
    import torch
    from brush_tpu_torch.datasets.ply import load_splats_from_ply
    from brush_tpu_torch.eval import eval_stats, eval_view
    from brush_tpu_torch.ops.cuda import expand, rasterize_fwd

    with open(CASTLE_PLY, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    gpu = load_splats_from_ply(data, device="cuda")
    cpu = load_splats_from_ply(data, device="cpu")
    cams = castle_cameras()
    blank = np.zeros((CASTLE_SIZE, CASTLE_SIZE, 3), np.float32)
    gts = [eval_view(cpu, c, blank, keep_image=True).rendered for c in cams]
    t_cpu = time.perf_counter() - t0
    expand.launches = 0
    rasterize_fwd.launches = 0
    t0 = time.perf_counter()
    evals = eval_stats(gpu, list(zip(cams, gts)))
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    counts = (expand.launches, rasterize_fwd.launches)
    psnr = [e.psnr for e in evals]
    ssim = [e.ssim for e in evals]
    print(f"[castle] {gpu.n_live} splats, SH degree 3, {len(cams)} views "
          f"{CASTLE_SIZE}x{CASTLE_SIZE}: PSNR {[round(p, 2) for p in psnr]} "
          f"SSIM {[round(s, 6) for s in ssim]} vs the CPU render; pool "
          f"{evals[-1].pool}; launches expand={counts[0]} "
          f"rasterize_fwd={counts[1]}; host s: cpu {t_cpu:.1f} "
          f"gpu {t_gpu:.1f}")
    if min(counts) < len(cams):
        raise AssertionError(f"castle eval skipped a kernel: {counts}")
    if min(psnr) < 50.0 or min(ssim) < 0.999:
        raise AssertionError("castle views differ from the CPU render")
    gt_mean = [float(np.mean(g)) for g in gts]
    if min(gt_mean) < 0.01:
        raise AssertionError(f"castle views look empty: means {gt_mean}")
    return gpu, cams, gts, evals[-1].pool


def cell_kernel_phase(splats, cp, size, pool):
    """Both rasterizers at each of CHECK_CELLS on a scene (the entry one),
    held to their plain versions with phase 2's tolerances and repeat
    launches bit-equal; expand byte-equal and segment_sum on the re-sorted
    rows as there."""
    t0 = time.perf_counter()
    for cell in CHECK_CELLS:
        label = f"entry cell {cell}"
        k = kernel_inputs(splats, cp, size, pool, cell)
        check_expand(k["exp_args"])
        r = check_raster(k["r_args"])
        print(f"[{label}] {k['r_args'][1].shape[0]} cells of "
              f"{256 * cell[0] * cell[1]} pixels, records "
              f"{int(k['exp_args'][3][0])}: expand byte-equal; rasterize_fwd "
              f"max err {r['err']:.3e}, flipped pixels {r['flips']}, pairs "
              f"evaluated {r['pairs']}, of them active {r['active']}")
        check_backward(k, label, seed=1)
    print(f"[entry cells] {time.perf_counter() - t0:.1f} s")


def castle_cells(splats, cams, gts, pool):
    """The castle at each of CHECK_CELLS: rasterize_fwd held to its plain
    version on view 0's arguments, and at CELL also the backward kernels
    (real opacities: saturating pixels, the early-out, a cell's tiles
    swept in turn); then eval_stats, launches counted, every image held to
    the (1, 1) one with CELL_IMAGE_TOL, the differing pixels counted."""
    import torch
    from brush_tpu_torch.eval import eval_stats
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.render import pool_size

    t0 = time.perf_counter()
    size = (CASTLE_SIZE, CASTLE_SIZE)
    cp = camera_params(cams[0], size, device="cuda")
    pool = pool_size(splats.capacity, size, pool)
    for cell in CHECK_CELLS:
        label = f"castle cell {cell}"
        k = kernel_inputs(splats, cp, size, pool, cell)
        r = check_raster(k["r_args"])
        print(f"[{label}] view 0, {k['r_args'][1].shape[0]} cells, records "
              f"{int(k['exp_args'][3][0])}: rasterize_fwd max err "
              f"{r['err']:.3e}, flipped pixels {r['flips']} (largest img or "
              f"T difference there {r['flip_err']:.3e}), pairs evaluated "
              f"{r['pairs']}, active {r['active']}")
        if cell == CELL:
            check_backward(k, label, seed=2)
    del k, r
    views = list(zip(cams, gts))
    base = eval_stats(splats, views, keep_images=True)
    for cell in CHECK_CELLS:
        reset_launches()
        evals = eval_stats(splats, views, keep_images=True, cell=cell)
        counts = read_launches()
        diffs = [check_cell_image(torch.as_tensor(e.rendered),
                                  torch.as_tensor(b.rendered),
                                  f"castle cell {cell} view {i}",
                                  **CELL_IMAGE_TOL)
                 for i, (e, b) in enumerate(zip(evals, base))]
        print(f"[castle cell {cell}] PSNR "
              f"{[round(e.psnr, 2) for e in evals]} vs the CPU render "
              f"((1, 1): {[round(b.psnr, 2) for b in base]}); against the "
              f"(1, 1) images: pixels that differ "
              f"{[d['differ'] for d in diffs]}, beyond 1e-5 "
              f"{[d['beyond_1e5'] for d in diffs]}, beyond 2e-3 "
              f"{[d['flips'] for d in diffs]} of {CASTLE_SIZE ** 2} (largest "
              f"{max(max(d['err'], d['flip_err']) for d in diffs):.3e}); "
              f"launches {counts}")
        if min(counts["expand"], counts["rasterize_fwd"]) < len(cams):
            raise AssertionError(f"castle cell {cell} skipped a kernel")
    print(f"[castle cells] {time.perf_counter() - t0:.1f} s")


def castle_cameras():
    return [orbit_camera(2 * np.pi * i / 4 + 0.3, 0.55) for i in range(4)]


def castle_kernels(splats, cams, pool):
    """rasterize_fwd's check on every castle view, and the backward
    kernels' on view 0: real opacities saturate pixels, so the forward's
    early-out ends tiles before their last record and each tile's backward
    sweep skips a suffix of records."""
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.render import pool_size

    t0 = time.perf_counter()
    size = (CASTLE_SIZE, CASTLE_SIZE)
    pool = pool_size(splats.capacity, size, pool)
    for view, cam in reversed(list(enumerate(cams))):
        k = kernel_inputs(splats, camera_params(cam, size, device="cuda"),
                          size, pool)
        if k["raw_total"] > pool:
            raise AssertionError(f"castle view {view} dropped records: pool "
                                 f"{pool}, records {k['raw_total']}")
        r = check_raster(k["r_args"])
        live = int(k["exp_args"][3][0])
        print(f"[castle] rasterize_fwd on view {view}: max err "
              f"{r['err']:.3e}, flipped pixels {r['flips']} (largest img or "
              f"T difference there {r['flip_err']:.3e}); the early-out "
              f"leaves {r['pairs']} of the {256 * live} pairs to evaluate, "
              f"{r['active']} active; plain {r['plain_ms']:.0f} ms")
    bwd = check_backward(k, "castle", seed=2)
    n_tiles = k["r_args"][1].shape[0]
    print(f"[castle] backward on view 0: {live} records; the sweep "
          f"evaluates {bwd['swept']} of the {256 * live} pairs a full "
          f"sweep would; {time.perf_counter() - t0:.1f} s "
          f"({n_tiles} tiles)")


def reset_launches():
    from brush_tpu_torch.ops.cuda import (
        expand, rasterize_bwd, rasterize_fwd, segsum,
    )

    for mod in (expand, rasterize_fwd, rasterize_bwd, segsum):
        mod.launches = 0


def read_launches() -> dict:
    from brush_tpu_torch.ops.cuda import (
        expand, rasterize_bwd, rasterize_fwd, segsum,
    )

    return {"expand": expand.launches, "rasterize_fwd": rasterize_fwd.launches,
            "rasterize_bwd": rasterize_bwd.launches,
            "segment_sum": segsum.launches}


KERNEL_WRAPPERS = ("expand", "rasterize_fwd", "rasterize_bwd", "segment_sum")


@contextlib.contextmanager
def kept_kernel_args(armed: list):
    """While armed[0] is true, keep the arguments of the record pipeline's
    calls to the four kernel wrappers (the wrappers still launch and count
    as before). Yields {wrapper name: last arguments}."""
    from brush_tpu_torch.ops import pipeline

    seen = {}
    saved = {name: getattr(pipeline, name) for name in KERNEL_WRAPPERS}

    def keep(name, fn):
        def call(*args):
            if armed[0]:
                seen[name] = args
            return fn(*args)
        return call

    for name, fn in saved.items():
        setattr(pipeline, name, keep(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(pipeline, name, fn)


def timed_steps(trainer, state, batch, steps: int):
    """Run trainer steps; returns (state, [CUDA-event ms], [StepStats],
    {iteration: RefineStats})."""
    import torch

    times, stats, refines = [], [], {}
    for it in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, st = trainer.step(state, batch)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        stats.append(st)
        if trainer.last_refine_stats is not None:
            refines[it] = trainer.last_refine_stats
    return state, times, stats, refines


def train_path(cfg, cell=(1, 1)):
    """Phase 5, the main path: SplatTrainer steps on the bench scene
    against a black ground truth at raster cell `cell`, all four kernels
    counted, and the kernels' arguments kept on the first step at each
    capacity. Then the train step metric at the capacity the run ended
    at. Returns (launches, metric ms, window ms, {capacity: arguments},
    records a step)."""
    import torch
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.config import TrainConfig
    from brush_tpu_torch.train import SceneBatch, SplatTrainer

    t_phase = time.perf_counter()
    splats, _, size = make_scene(cfg, "cuda")
    cam = Camera(position=[0, 0, cfg["z"]], rotation=[1, 0, 0, 0],
                 fov_x=np.pi / 2, fov_y=np.pi / 2)
    batch = SceneBatch(np.zeros((size[1], size[0], 3), np.float32), cam)
    trainer = SplatTrainer(TrainConfig(warmup_steps=1, refine_every=3),
                           raster_cell=cell)
    tag = "train" if tuple(cell) == (1, 1) else f"train cell {cell}"
    state = trainer.init_state(splats)
    torch.cuda.synchronize()
    kept, armed = {}, [False]
    times, stats, refines, caps = [], [], {}, []
    with kept_kernel_args(armed) as seen:
        reset_launches()
        for it in range(TRAIN_STEPS):
            cap = state.splats.capacity
            armed[0] = cap not in kept
            state, t, st, rf = timed_steps(trainer, state, batch, 1)
            if armed[0]:
                kept[cap] = dict(seen)
            times += t
            stats += st
            caps.append(cap)
            if rf:
                refines[it] = rf[0]
        counts = read_launches()
    losses = [float(st.loss) for st in stats]
    dropped = [int(st.num_dropped) for st in stats]
    records = [int(st.num_isects) for st in stats]
    sp = state.splats
    pool = trainer._pool_size(sp.capacity)
    finite = all(bool(torch.isfinite(x).all()) for x in sp.params().values())
    print(f"[{tag}] bench scene {size[0]}x{size[1]}, {cfg['n']} splats, "
          f"{TRAIN_STEPS} steps: step ms {[round(t, 3) for t in times]} "
          f"at capacities {caps}; the whole window {sum(times):.3f} ms")
    print(f"[{tag}] losses {losses}; records {records}; dropped {dropped}; "
          f"launches {counts}")
    print(f"[{tag}] refines {dict((i, r._asdict()) for i, r in refines.items())}; "
          f"n_live {sp.n_live}, capacity {sp.capacity}, pool {pool}; "
          f"kernel arguments kept at capacities {sorted(kept)}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    if min(counts.values()) < 1:
        raise AssertionError(f"training skipped a kernel: {counts}")
    if sorted(refines) != [1, 4]:
        raise AssertionError(f"refine ran at {sorted(refines)}, not [1, 4]")
    if not all(np.isfinite(losses)) or not finite:
        raise AssertionError("training produced a non-finite loss or param")
    if any(dropped):
        raise AssertionError(f"training dropped records: {dropped}")
    if sorted(kept) != sorted(set(caps)) or any(
            set(v) != set(KERNEL_WRAPPERS) for v in kept.values()):
        raise AssertionError("kernel arguments missing for a capacity")

    # The metric: warm steps at the capacity the run ended at. A default
    # config refines only after its 500 warm-up steps, so none of these
    # refines; its pool sizing gives the same pool at this capacity.
    t0 = time.perf_counter()
    timer = SplatTrainer(raster_cell=cell)
    if timer._pool_size(sp.capacity) != pool:
        raise AssertionError("the metric steps would use another pool")
    state, warm, _, rf = timed_steps(timer, state, batch, METRIC_STEPS + 1)
    if rf:
        raise AssertionError("a metric step refined")
    step_ms = statistics.median(warm[1:])
    print(f"[{tag}] metric: capacity {sp.capacity}, pool {pool}: median of "
          f"{METRIC_STEPS} warm steps {step_ms:.3f} ms (after one more "
          f"step); all ms {[round(t, 3) for t in warm]}; "
          f"{time.perf_counter() - t0:.1f} s")
    return counts, step_ms, sum(times), kept, records


def train_kernels(kept, tag="train"):
    """Phase 6 (and the "cli" phase's check): each kernel against its
    plain version on the arguments a training run gave it, kept = {when:
    the four wrappers' arguments} in the run's order; then the times,
    bounds and errors of the last arguments, as the result reports them."""
    import torch
    from brush_tpu_torch.ops.cuda.expand import expand
    from brush_tpu_torch.ops.cuda.rasterize_bwd import rasterize_bwd
    from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd
    from brush_tpu_torch.ops.cuda.segsum import segment_sum, slot_owners

    for when, args in kept.items():
        t0 = time.perf_counter()
        label = f"{tag} {when}"
        k = dict(exp_args=args["expand"], r_args=args["rasterize_fwd"])
        e_plain = check_expand(k["exp_args"])
        r = check_raster(k["r_args"])
        b = check_bwd(args["rasterize_bwd"], label)
        s = check_segsum(args["segment_sum"], label)
        print(f"[{label}] pool {k['exp_args'][6]}, records "
              f"{int(k['exp_args'][3][0])}: expand byte-equal; rasterize_fwd "
              f"max err {r['err']:.3e}, flipped pixels {r['flips']}; "
              f"rasterize_bwd row error {b['err']:.3e} (max abs "
              f"{b['abs']:.3e}), pairs swept {b['swept']}, active "
              f"{b['active']}; segment_sum row error {s['err']:.3e} (max abs "
              f"{s['abs']:.3e}); {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    exp_args, r_args = k["exp_args"], k["r_args"]
    b_args, s_args = args["rasterize_bwd"], args["segment_sum"]
    rows, _, cum, total = s_args
    ids = slot_owners(cum, total, rows.shape[1])
    live_rows = rows[:, :ids.shape[0]].contiguous()
    n = cum.shape[0]
    ms = {"expand": cuda_ms(lambda: expand(*exp_args), reps=20),
          "rasterize_fwd": cuda_ms(lambda: rasterize_fwd(*r_args), reps=20),
          "rasterize_bwd": cuda_ms(lambda: rasterize_bwd(*b_args), reps=10),
          "segment_sum": cuda_ms(lambda: segment_sum(*s_args), reps=20)}
    s_lib = cuda_ms(lambda: torch.zeros((9, n), device=rows.device).index_add_(
        1, ids, live_rows), reps=20)
    print(f"[{tag} kernels] {when}: "
          + "; ".join(f"{name} {t:.4f} ms" for name, t in ms.items())
          + f"; index_add_ {s_lib:.4f} ms; "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(ms=ms, plain={"expand": e_plain,
                              "rasterize_fwd": r["plain_ms"],
                              "rasterize_bwd": b["plain_ms"],
                              "segment_sum": s["plain_ms"]},
                err={"expand": 0.0,
                     "rasterize_fwd": max(r["err"], r["flip_err"]),
                     "rasterize_bwd": b["abs"], "segment_sum": s["abs"]},
                bound=bounds(k, r, b), library=s_lib, when=when)


def castle_training(splats, cams, gts):
    """Phase 6: perturb the castle's SH DC, train on its clean views, and
    check that the eval PSNR rises."""
    import torch
    from brush_tpu_torch.eval import eval_stats
    from brush_tpu_torch.train import SceneBatch, SplatTrainer

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)
    sh = splats.sh_coeffs.clone()
    n = splats.n_live
    sh[:n, 0, :] += 0.1 * torch.randn((n, 3), generator=gen, device="cuda")
    noisy = splats.replace(sh_coeffs=sh)
    views = list(zip(cams, gts))
    before = [e.psnr for e in eval_stats(noisy, views)]
    trainer = SplatTrainer()
    state = trainer.init_state(noisy)
    losses = []
    for it in range(CASTLE_TRAIN_STEPS):
        state, st = trainer.step(state, SceneBatch(gts[it % 4], cams[it % 4]))
        losses.append(st.loss)
    losses = [float(x) for x in losses]
    after = [e.psnr for e in eval_stats(state.splats, views)]
    print(f"[castle train] {CASTLE_TRAIN_STEPS} steps, SH DC + 0.1 N(0,1): "
          f"PSNR before {[round(p, 3) for p in before]} (mean "
          f"{np.mean(before):.3f}), after {[round(p, 3) for p in after]} "
          f"(mean {np.mean(after):.3f}); losses "
          f"{[round(x, 5) for x in losses]}; "
          f"{time.perf_counter() - t0:.1f} s")
    if not np.mean(after) > np.mean(before):
        raise AssertionError("castle training did not raise the PSNR")


@contextlib.contextmanager
def wrapped(module, name: str, before, after):
    """Replace module.name by a wrapper that calls before(*args) and
    after(token, result, *args, **kwargs) around it (token = before's
    result); restored on exit."""
    fn = getattr(module, name)

    def call(*args, **kw):
        token = before(*args)
        out = fn(*args, **kw)
        after(token, out, *args, **kw)
        return out

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, fn)


def spied_renders(module, sink: list, dropped: bool = False):
    """wrapped() around module.render_splats that appends each call's cell
    to sink, as (cell, records dropped) with `dropped` (reading it waits
    for the render)."""
    def after(_, out, *a, cell=(1, 1), **kw):
        cell = tuple(cell)
        sink.append((cell, int(out[1].num_dropped)) if dropped else cell)

    return wrapped(module, "render_splats", lambda *a: None, after)


def host_timed(module, name: str, sink: list):
    """wrapped() that appends each call's host seconds to sink."""
    return wrapped(module, name, lambda *a: time.perf_counter(),
                   lambda t, out, *a, **k: sink.append(
                       time.perf_counter() - t))


def run_cli(argv, log: list) -> str:
    """brush_tpu_torch.cli.main(argv) in this process, its standard output
    captured (and kept in log); on a failure the output's tail is printed
    before the error goes on."""
    import io

    from brush_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["--device", CLI_DEVICE, *argv])
    except BaseException:
        print("\n".join(buf.getvalue().splitlines()[-30:]), file=sys.stderr)
        raise
    text = buf.getvalue()
    log.append((argv, time.perf_counter() - t0, text))
    return text


def castle_images(splats, c2ws, pool, rgb_only: bool):
    """uint8 800x800 images of the castle from NeRF camera-to-worlds,
    rendered by the port on the card (the pool grows until nothing
    drops): RGBA as rendered, or its RGB (on black)."""
    import torch
    from brush_tpu_torch.datasets.nerf import camera_from_transform
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.render import render_splats

    size = (CASTLE_SIZE, CASTLE_SIZE)
    out = []
    for c2w in c2ws:
        cam = camera_from_transform(c2w, CASTLE_FOV_X, *size)
        cp = camera_params(cam, size, device=splats.device)
        for _ in range(4):
            img, aux = render_splats(
                splats.means, splats.log_scales, splats.quats,
                splats.sh_coeffs, splats.raw_opacity, cp, size,
                active=splats.active_mask(), max_isects=pool,
                needs_grad=False)
            if int(aux.num_dropped) == 0:
                break
            pool = 2 * (int(aux.num_isects) + int(aux.num_dropped))
        else:
            raise AssertionError("castle ground truth dropped records")
        if rgb_only:
            img = img[..., :3]
        out.append((img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
    return out


def step_timer(steps: list, before_step=None, after_step=None):
    """wrapped() around SplatTrainer.step: each step is timed between two
    CUDA events and on the host clock, and appended to steps as
    (iteration, host start, start event, stop event, host stop, refine
    stats). before_step(trainer, state) and after_step(trainer, iteration)
    run around it when given."""
    import torch
    from brush_tpu_torch import train

    def before(trainer, state, *_):
        if before_step is not None:
            before_step(trainer, state)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return trainer.iter, time.perf_counter(), ev

    def after(token, out, trainer, *_, **_kw):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        steps.append((*token, ev, time.perf_counter(),
                      trainer.last_refine_stats))
        if after_step is not None:
            after_step(trainer, token[0])

    return wrapped(train.SplatTrainer, "step", before, after)


def event_ms(steps: list) -> list:
    import torch

    torch.cuda.synchronize()
    return [s[2].elapsed_time(s[3]) for s in steps]


def row_filters(data: bytes) -> np.ndarray:
    """How many rows of an 8-bit PNG use each of the five row filters."""
    import zlib

    from brush_tpu_torch.datasets import png

    h = png.read_header(data)
    idat = b"".join(b for k, b in png._chunks(data) if k == b"IDAT")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h.height, -1)
    return np.bincount(rows[:, 0], minlength=5)


def cli_phase(castle, pool):
    """Phase 8: the user's path through brush_tpu_torch.cli at full width,
    in a temporary directory: a NeRF-synthetic castle dataset (100 train
    and 16 val views, 800x800 RGBA PNG) rendered by the port from
    docs/castle_r5_30k.ply, and its twin with libpng's adaptive row
    filters; `cli train` 620 steps with in-training eval, checkpoints,
    refines at 501 and 601 and PLY export, the four kernels counted over
    the run (the eval renders counted apart) and held to their plain
    versions on the run's own arguments; `cli eval` of the export and of
    the final checkpoint; `--resume`; the trained castle resumed at step
    CASTLE_RESUME_STEP for the step time of a model at a real size; `cli
    render`; a 24-view COLMAP castle dataset (RGB on black) with the
    castle's means as its point cloud; `cli train2d`. Returns the
    kernels' launches over the 620-step run and train_kernels' result on
    its arguments."""
    import tempfile
    import zipfile
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from brush_tpu_torch import eval as eval_mod
    from brush_tpu_torch import native
    from brush_tpu_torch import train as train_mod
    from brush_tpu_torch.constants import SH_C0
    from brush_tpu_torch.datasets import load_dataset, png, ply
    from brush_tpu_torch.datasets import testing as dt
    from brush_tpu_torch.datasets.colmap import _read_points3d_bin
    from brush_tpu_torch.native import read_points3d_bin
    from brush_tpu_torch.train import SplatTrainer
    from brush_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(prefix="brush_cli_") as d:
        # The NeRF-synthetic castle: orbit and layout of
        # scripts/raytrace_scene.py write_nerf_zip (train seed 1, val 2).
        t0 = time.perf_counter()
        c2ws = {"train": dt.orbit_views(CLI_NERF_TRAIN, seed=1),
                "val": dt.orbit_views(CLI_NERF_VAL, seed=2)}
        imgs = {s: castle_images(castle, c, pool, rgb_only=False)
                for s, c in c2ws.items()}
        torch.cuda.synchronize()
        t_render = time.perf_counter() - t0
        with ThreadPoolExecutor(8) as ex:
            pngs = {s: list(ex.map(png.encode_png, v))
                    for s, v in imgs.items()}
        nerf_zip = os.path.join(d, "nerf.zip")
        dt.write_nerf_zip(nerf_zip, {s: list(zip(c2ws[s], pngs[s]))
                                     for s in c2ws}, encode=lambda b: b)
        t_write = time.perf_counter() - t0
        flat = pngs["train"] + pngs["val"]
        t0 = time.perf_counter()
        built = native.available()   # g++ at first use, outside the timings
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        for data in flat:
            png.decode_png(data)
        t_decode = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds = load_dataset(nerf_zip)
        t_load = time.perf_counter() - t0
        if (len(ds.train.views), len(ds.eval.views)) != (
                CLI_NERF_TRAIN, CLI_NERF_VAL) or ds.train.views[0].image.shape \
                != (CASTLE_SIZE, CASTLE_SIZE, 4):
            raise AssertionError("the NeRF castle dataset loads wrong")
        print(f"[cli] NeRF castle dataset {CLI_NERF_TRAIN} + {CLI_NERF_VAL} "
              f"views {CASTLE_SIZE}x{CASTLE_SIZE} RGBA: rendered "
              f"{t_render:.2f} s, written {t_write:.2f} s in all "
              f"({os.path.getsize(nerf_zip)} bytes); decode of its "
              f"filter-0 PNGs {len(flat) / t_decode:.1f} views/s (one "
              f"thread); load_dataset {t_load:.2f} s; native library "
              f"{'built' if built else 'unavailable'} in {t_native:.2f} s")

        # Its twin as libpng writes PNGs, each row with its adaptive
        # filter (Average and Paeth rows among them): the decode a user
        # of a real NeRF-synthetic scene waits for.
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            adaptive = {s: list(ex.map(dt.filtered_png, v))
                        for s, v in imgs.items()}
        ad_zip = os.path.join(d, "nerf_adaptive.zip")
        dt.write_nerf_zip(ad_zip, {s: list(zip(c2ws[s], adaptive[s]))
                                   for s in c2ws}, encode=lambda b: b)
        t_make = time.perf_counter() - t0
        kinds = sum(row_filters(b) for v in adaptive.values() for b in v)
        t0 = time.perf_counter()
        one = png.decode_png(adaptive["train"][0])
        t_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds_ad = load_dataset(ad_zip)
        t_load_ad = time.perf_counter() - t0
        if not np.array_equal(one, imgs["train"][0]) or not all(
                np.array_equal(a.image, b.image) for sa, sb in (
                    (ds_ad.train, ds.train), (ds_ad.eval, ds.eval))
                for a, b in zip(sa.views, sb.views)):
            raise AssertionError("the adaptively filtered dataset loads "
                                 "other images")
        del ds, ds_ad
        print(f"[cli] adaptively filtered twin (unfiltered by "
              f"{'native/png.cpp' if native.available() else 'numpy'}): "
              f"rows by filter 0-4 {kinds.tolist()}, made {t_make:.2f} s "
              f"({os.path.getsize(ad_zip)} bytes); one view decodes in "
              f"{t_one:.3f} s (one thread); load_dataset {t_load_ad:.2f} s "
              f"({(CLI_NERF_TRAIN + CLI_NERF_VAL) / t_load_ad:.1f} views/s, "
              f"{os.cpu_count()} threads); images equal to the filter-0 "
              f"dataset's")

        # Training through the CLI: the kernels counted over the run, the
        # eval renders (pool-growth retries included) counted apart, and
        # the kernels' arguments kept on the first step and on the first
        # step after each refine or capacity change.
        ck = os.path.join(d, "ckpt")
        steps, ck_s, ply_s, renders = [], [], [], []
        kept, armed, last = {}, [False], {}

        def arm(trainer, state):
            cap = state.splats.capacity
            armed[0] = not kept or cap != last.get("cap") or last["refined"]
            last["cap"] = cap

        def keep(trainer, it):
            if armed[0]:
                kept[f"step {it}, capacity {last['cap']}"] = dict(seen)
                armed[0] = False
            last["refined"] = trainer.last_refine_stats is not None

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with kept_kernel_args(armed) as seen, \
                step_timer(steps, arm, keep), \
                wrapped(eval_mod, "render_splats", lambda *a: None,
                        lambda t, out, *a, **k: renders.append(
                            int(out[1].num_dropped))), \
                host_timed(checkpoint, "save_checkpoint", ck_s), \
                host_timed(ply, "splats_to_ply", ply_s):
            text = run_cli([
                "train", "--source", nerf_zip, "--iters", str(CLI_ITERS),
                "--sh-degree", "3", "--init-count", "10000",
                "--eval-every", "200", "--eval-views", "4",
                "--log-every", "20", "--checkpoint-dir", ck,
                "--checkpoint-every", "200", "--export",
                os.path.join(ck, "out.ply")], log)
        counts = read_launches()
        peak = torch.cuda.max_memory_allocated()
        ms = event_ms(steps)
        loop_s = steps[-1][4] - steps[0][1]
        rows = read_jsonl(os.path.join(ck, "metrics.jsonl"))
        losses = {r["step"]: r["loss"] for r in rows if "loss" in r}
        psnr = {r["step"]: r["eval_psnr"] for r in rows if "eval_psnr" in r}
        refines = {it: rs for it, _, _, _, _, rs in steps if rs is not None}
        live = {r["step"]: r["splats"] for r in rows if "splats" in r}
        final = text_field(text, r"final eval: PSNR (\S+) SSIM (\S+)")
        cache = text_field(text, r"gt cache: (\d+) hits, (\d+) views, "
                                 r"(\d+) bytes")
        sizes = {n: os.path.getsize(os.path.join(ck, n)) for n in
                 ("ckpt_0000400.npz", "ckpt_final.npz", "out.ply")}
        retries = sum(1 for dropped in renders if dropped)
        evals = 3 * 4 + CLI_NERF_VAL
        print(f"[cli] train {CLI_ITERS} steps: median step "
              f"{statistics.median(ms):.3f} ms (CUDA events), "
              f"{len(steps) / loop_s:.2f} steps/s over the loop (host clock, "
              f"evals and checkpoints in it); peak memory {peak} bytes; gt "
              f"cache {cache[0]} hits, {cache[1]} views, {cache[2]} bytes; "
              f"launches {counts}: {CLI_ITERS} steps + {len(renders)} eval "
              f"renders ({evals} views, {retries} of the renders dropped "
              f"records and were rendered again in a grown pool)")
        print(f"[cli] eval PSNR {psnr}; final eval PSNR {final[0]} SSIM "
              f"{final[1]}; refines {[(i, r._asdict()) for i, r in refines.items()]}"
              f"; splats logged {live.get(500)} at 500, {live.get(520)} at "
              f"520, {live.get(600)} at 600; losses at 0/300/600 "
              f"{losses.get(0)}, {losses.get(300)}, {losses.get(600)}")
        print(f"[cli] checkpoint {sizes['ckpt_final.npz']} bytes, saves "
              f"{[round(s, 3) for s in ck_s]} s; export {sizes['out.ply']} "
              f"bytes in {sum(ply_s):.3f} s")
        if len(steps) != CLI_ITERS or not all(
                np.isfinite(list(losses.values()))) or len(losses) != 31:
            raise AssertionError(f"cli train: {len(steps)} steps, losses "
                                 f"{losses}")
        if sorted(psnr) != [200, 400, 600] or not psnr[600] > psnr[200]:
            raise AssertionError(f"cli train: eval PSNR {psnr}")
        if 501 not in refines or not any(
                r["step"] == 501 and "refine_cloned" in r for r in rows):
            raise AssertionError(f"cli train: refines at {sorted(refines)}")
        if min(counts.values()) < CLI_ITERS:
            raise AssertionError(f"cli train skipped a kernel: {counts}")
        if len(renders) != evals + retries or counts != {
                "expand": CLI_ITERS + len(renders),
                "rasterize_fwd": CLI_ITERS + len(renders),
                "rasterize_bwd": CLI_ITERS, "segment_sum": CLI_ITERS}:
            raise AssertionError(f"cli train: launches {counts} are not "
                                 f"one a step and one an eval render "
                                 f"({len(renders)} renders, dropped "
                                 f"{renders})")
        whens = list(kept)
        if len(whens) < 2 or not whens[0].startswith("step 0,"):
            raise AssertionError(f"kernel arguments kept at {whens}")
        # The plain versions on the first step's arguments and the last
        # kept (the first step after the last refine).
        cli_kernels = train_kernels({w: kept[w] for w in (whens[0],
                                                          whens[-1])}, "cli")
        del kept, seen
        torch.cuda.empty_cache()

        # The same dataset and flags at raster cell 2x2 for CLI_CELL_ITERS
        # steps: every render of the run, training's and the evals', at
        # the cell; launches counted as above; the eval at 200 beside the
        # (1, 1) run's.
        ck2 = os.path.join(d, "ckpt_cell")
        c_renders, t_cells, steps2 = [], [], []
        reset_launches()
        with step_timer(steps2), \
                spied_renders(eval_mod, c_renders, dropped=True), \
                spied_renders(train_mod, t_cells):
            run_cli([
                "train", "--source", nerf_zip, "--iters",
                str(CLI_CELL_ITERS), "--sh-degree", "3", "--init-count",
                "10000", "--eval-every", "200", "--eval-views", "4",
                "--log-every", "20", "--checkpoint-dir", ck2, "--cell",
                f"{CELL[0]}x{CELL[1]}"], log)
        counts2 = read_launches()
        ms2 = event_ms(steps2)
        rows2 = read_jsonl(os.path.join(ck2, "metrics.jsonl"))
        losses2 = {r["step"]: r["loss"] for r in rows2 if "loss" in r}
        psnr2 = {r["step"]: r["eval_psnr"] for r in rows2 if "eval_psnr" in r}
        retries2 = sum(1 for _, dropped in c_renders if dropped)
        cells = {c for c, _ in c_renders} | set(t_cells)
        print(f"[cli cell {CELL}] train {CLI_CELL_ITERS} steps: median step "
              f"{statistics.median(ms2):.3f} ms (CUDA events; the (1, 1) run "
              f"{statistics.median(ms[:CLI_CELL_ITERS]):.3f} over its first "
              f"{CLI_CELL_ITERS}); eval PSNR at 200 {psnr2.get(200)} ((1, 1): "
              f"{psnr[200]}); losses at 0/100/200 {losses2.get(0)}, "
              f"{losses2.get(100)}, {losses2.get(200)} ((1, 1): "
              f"{losses.get(0)}, {losses.get(100)}, {losses.get(200)}); "
              f"launches {counts2}: {CLI_CELL_ITERS} steps + {len(c_renders)} "
              f"eval renders ({retries2} grown); renders at cells {cells}")
        if len(steps2) != CLI_CELL_ITERS or not all(np.isfinite(
                list(losses2.values()))) or len(losses2) != 11:
            raise AssertionError(f"cli train --cell: {len(steps2)} steps, "
                                 f"losses {losses2}")
        if sorted(psnr2) != [200] or not abs(
                psnr2[200] - psnr[200]) <= CLI_CELL_PSNR_TOL:
            raise AssertionError(f"cli train --cell: eval PSNR {psnr2} vs "
                                 f"(1, 1) {psnr[200]}")
        if cells != {CELL} or len(t_cells) != CLI_CELL_ITERS:
            raise AssertionError(f"cli train --cell rendered at {cells}")
        if len(c_renders) != 4 + CLI_NERF_VAL + retries2 or counts2 != {
                "expand": CLI_CELL_ITERS + len(c_renders),
                "rasterize_fwd": CLI_CELL_ITERS + len(c_renders),
                "rasterize_bwd": CLI_CELL_ITERS,
                "segment_sum": CLI_CELL_ITERS}:
            raise AssertionError(f"cli train --cell: launches {counts2}, "
                                 f"{len(c_renders)} eval renders")

        # eval of the export and of the final checkpoint: the same PSNR.
        eval_s = []
        for flag, name in (("--ply", "out.ply"),
                           ("--ckpt", "ckpt_final.npz")):
            eval_s.clear()
            with host_timed(eval_mod, "eval_view", eval_s):
                text = run_cli(["eval", "--source", nerf_zip, flag,
                                os.path.join(ck, name)], log)
            got = text_field(text, r"mean: PSNR (\S+) SSIM (\S+)")
            print(f"[cli] eval {flag}: PSNR {got[0]} SSIM {got[1]}; "
                  f"{statistics.median(eval_s) * 1e3:.2f} ms a view "
                  f"(median of {len(eval_s)}, host clock)")
            if got[0] != final[0]:
                raise AssertionError(f"eval {flag} PSNR {got[0]} != the "
                                     f"training run's {final[0]}")

        # Resume from the checkpoint at 400 and run to 420.
        rs_dir = os.path.join(d, "resumed")
        text = run_cli(["train", "--source", nerf_zip, "--iters", "420",
                        "--log-every", "1", "--checkpoint-dir", rs_dir,
                        "--resume", os.path.join(ck, "ckpt_0000400.npz")],
                       log)
        resumed = {r["step"]: r["loss"] for r in read_jsonl(
            os.path.join(rs_dir, "metrics.jsonl")) if "loss" in r}
        if "at step 401" not in text or sorted(resumed) != list(
                range(401, 420)) or not all(np.isfinite(
                    list(resumed.values()))):
            raise AssertionError(f"resume: steps {sorted(resumed)}")
        print(f"[cli] resume from ckpt_0000400: steps 401..419, losses "
              f"{resumed[401]:.5f} .. {resumed[419]:.5f}")

        # The step of a model at a real size: the trained castle (90,977
        # splats, SH 3), the source of this dataset's images, saved as a
        # checkpoint at CASTLE_RESUME_STEP and resumed through the CLI past
        # the last refine (max_refine_step 15000), as the last steps of a
        # 30,000-step run on it take.
        castle_ck = checkpoint.save_checkpoint(
            os.path.join(d, "castle", "castle"),
            SplatTrainer().init_state(castle), CASTLE_RESUME_STEP)
        c_steps, c_dir = [], os.path.join(d, "castle_run")
        reset_launches()
        with step_timer(c_steps):
            text = run_cli(["train", "--source", nerf_zip, "--iters",
                            str(CASTLE_RESUME_STEP + CASTLE_RESUME_STEPS),
                            "--log-every", "10", "--checkpoint-dir", c_dir,
                            "--resume", castle_ck], log)
        c_counts = read_launches()
        c_ms = event_ms(c_steps)
        c_final = text_field(text, r"final eval: PSNR (\S+) SSIM (\S+)")
        c_losses = [r["loss"] for r in read_jsonl(
            os.path.join(c_dir, "metrics.jsonl")) if "loss" in r]
        print(f"[cli] trained castle ({castle.n_live} splats, capacity "
              f"{castle.capacity}) resumed at {CASTLE_RESUME_STEP}, "
              f"{len(c_steps)} steps: median step {statistics.median(c_ms):.3f}"
              f" ms (CUDA events; the last 100: "
              f"{statistics.median(c_ms[-100:]):.3f} ms), "
              f"{len(c_steps) / (c_steps[-1][4] - c_steps[0][1]):.2f} steps/s"
              f" (host clock); refines {sum(s[5] is not None for s in c_steps)}"
              f"; launches {c_counts}; losses {c_losses[0]:.5f} .. "
              f"{c_losses[-1]:.5f}; final eval PSNR {c_final[0]} SSIM "
              f"{c_final[1]}; {log[-1][1]:.1f} s")
        if len(c_steps) != CASTLE_RESUME_STEPS or not np.isfinite(
                c_losses).all() or any(
                s[5] is not None for s in c_steps) or min(
                c_counts.values()) < CASTLE_RESUME_STEPS:
            raise AssertionError("the resumed castle did not take its "
                                 "steps through the kernels")

        # Render one view of the export.
        r_png = os.path.join(d, "r.png")
        run_cli(["render", "--source", nerf_zip, "--ply",
                 os.path.join(ck, "out.ply"), "--view", "0", "--out", r_png],
                log)
        with open(r_png, "rb") as f:
            rendered = png.decode_png(f.read())
        if rendered.shape != (CASTLE_SIZE, CASTLE_SIZE, 4) or \
                rendered[..., 3].max() == 0 or rendered[..., :3].max() == 0:
            raise AssertionError("render wrote a blank or misshapen PNG")

        # The COLMAP castle: 24 RGB views on black (so the eval reads how
        # well the point cloud fits them), the means as points3D.
        t0 = time.perf_counter()
        n = castle.n_live
        means = castle.means[:n].cpu().numpy()
        colors = (np.clip(0.5 + SH_C0 * castle.sh_coeffs[:n, 0].cpu().numpy(),
                          0, 1) * 255).astype(np.uint8)
        views = dt.orbit_views(CLI_COLMAP_VIEWS, seed=1)
        rgb = castle_images(castle, views, pool, rgb_only=True)
        col_zip = os.path.join(d, "colmap.zip")
        with ThreadPoolExecutor(8) as ex:
            rgb = list(ex.map(png.encode_png, rgb))
        # Poses in the castle's frame (the NeRF loader's), so its means
        # are the point cloud of these views.
        dt.write_colmap_zip(col_zip, [(dt.in_nerf_loader_frame(c), im)
                                      for c, im in zip(views, rgb)],
                            CASTLE_SIZE, means, colors, encode=lambda b: b)
        with zipfile.ZipFile(col_zip) as zf:
            p3d = zf.read("sparse/0/points3D.bin")
        nat, py = read_points3d_bin(p3d), _read_points3d_bin(p3d)
        if not all(np.array_equal(a, b) for a, b in zip(nat, py)):
            raise AssertionError("native points3D parser != Python parser")
        t_colmap = time.perf_counter() - t0
        col_steps = []
        with step_timer(col_steps):
            text = run_cli(["train", "--source", col_zip, "--iters", "100",
                            "--eval-split-every", "8"], log)
        col_ms = event_ms(col_steps)
        col_final = text_field(text, r"final eval: PSNR (\S+) SSIM (\S+)")
        if f"point-cloud init: {n} splats" not in text:
            raise AssertionError("COLMAP run did not init from points3D")
        print(f"[cli] COLMAP castle {CLI_COLMAP_VIEWS} views RGB, {n} "
              f"points (native parser == Python parser), written "
              f"{t_colmap:.2f} s; 100 steps: median step "
              f"{statistics.median(col_ms):.3f} ms (CUDA events); final eval "
              f"PSNR {col_final[0]} SSIM {col_final[1]}; {log[-1][1]:.1f} s")

        # train2d on one train view.
        image = os.path.join(d, "view.png")
        with open(image, "wb") as f:
            f.write(pngs["train"][0])
        text = run_cli(["train2d", "--image", image, "--size", "256",
                        "--iters", "300"], log)
        l2d = [float(x) for x in re.findall(r"loss (\S+)", text)]
        if len(l2d) < 2 or not l2d[-1] < l2d[0]:
            raise AssertionError(f"train2d loss did not fall: {l2d}")
        print(f"[cli] train2d 256x256 300 steps: losses {l2d}; "
              f"{text_field(text, r'(final PSNR .*)')[0]}")
    print(f"[cli] commands' seconds "
          f"{[(a[0], round(s, 1)) for a, s, _ in log]}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts, cli_kernels


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def text_field(text: str, pattern: str) -> tuple:
    """The groups of pattern's first match in a command's output."""
    m = re.search(pattern, text)
    if m is None:
        raise AssertionError(f"no {pattern!r} in the output")
    return m.groups()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from brush_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {len(build.SOURCES)} kernels in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {build.NVCC_FLAGS})")
    smi = smi_line()
    print(f"[device] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    splats, cp, size, k = kernel_phase(ENTRY, "entry", backward=True)
    cell_kernel_phase(splats, cp, size, k["exp_args"][6])
    del splats, k
    check_segsum_hand()
    check_raster_hand()
    splats, cp, size, k = kernel_phase(BENCH, "bench", backward=False)
    render_counts, img_1, records_1, render_ms = main_path(splats, cp, size,
                                                          BENCH)
    forward_times(k, "bench render inputs")

    # The bench render at raster cell CELL: the kernels against their
    # plain versions on its inputs, its records beside (1, 1)'s, its image
    # against (1, 1)'s, the median render, the kernels' times and bounds.
    t_c = time.perf_counter()
    kc = dict(kernel_inputs(splats, cp, size, BENCH["pool"], CELL))
    kc["expand_plain_ms"] = check_expand(kc["exp_args"])
    kc["fwd"] = check_raster(kc["r_args"])
    cell_counts, img_c, records_c, cell_ms = main_path(splats, cp, size,
                                                       BENCH, CELL)
    d = check_cell_image(img_c, img_1, f"bench cell {CELL}",
                         **FWD_IMAGE_TOL)
    print(f"[cell {CELL}] bench render: records {records_c} ((1, 1): "
          f"{records_1}, {records_1 / records_c:.3f}x as many); median "
          f"{cell_ms:.3f} ms ((1, 1): {render_ms:.3f}); rasterize_fwd "
          f"against the plain version: max err {kc['fwd']['err']:.3e}, "
          f"flipped pixels {kc['fwd']['flips']}, pairs evaluated "
          f"{kc['fwd']['pairs']} ((1, 1): {k['fwd']['pairs']}), active "
          f"{kc['fwd']['active']}; the image against (1, 1)'s: pixels that "
          f"differ {d['differ']}, beyond 1e-5 {d['flips']} (largest there "
          f"{d['flip_err']:.3e}), largest elsewhere {d['err']:.3e}; "
          f"{time.perf_counter() - t_c:.1f} s")
    forward_times(kc, f"bench render inputs at cell {CELL}")
    del splats, k, kc, img_1, img_c
    torch.cuda.empty_cache()

    castle, cams, gts, castle_pool = castle_phase()
    castle_kernels(castle, cams, castle_pool)
    castle_cells(castle, cams, gts, castle_pool)
    torch.cuda.empty_cache()

    # Training, at (1, 1) and at CELL; the kernels against their plain
    # versions on the arguments of the capacity each run ends at.
    counts, step_ms, window_ms, kept, records = train_path(BENCH)
    last = max(kept)
    tk = train_kernels({f"capacity {last}": kept[last]})
    del kept
    torch.cuda.empty_cache()
    counts_c, step_ms_c, window_ms_c, kept, records_c = train_path(BENCH,
                                                                   CELL)
    last = max(kept)
    tk_c = train_kernels({f"capacity {last}, cell {CELL}": kept[last]},
                         f"train cell {CELL}")
    print(f"[train cell {CELL}] records a step {records_c} ((1, 1): "
          f"{records}); metric {step_ms_c:.3f} ms ((1, 1): {step_ms:.3f}); "
          f"window {window_ms_c:.3f} ms ((1, 1): {window_ms:.3f})")
    del kept
    torch.cuda.empty_cache()
    castle_training(castle, cams, gts)
    torch.cuda.empty_cache()
    cli_counts, cli_tk = cli_phase(castle, castle_pool)

    def row(name, src, replaces):
        def fields(t):
            return {"max_abs_err": t["err"][name], "ms": t["ms"][name],
                    "plain_ms": t["plain"][name],
                    "bound_ms": t["bound"][name][0],
                    "bound_by": t["bound"][name][1],
                    "library_ms": t["library"] if name == "segment_sum"
                    else None}

        # launches: the "cli" train run's; the other fields: the bench
        # training run's last arguments (phase 6); "cli": the same
        # fields on the cli train run's last arguments.
        out = {"name": name, "route": "cuda",
               "source": f"brush_tpu_torch/csrc/{src}.cu",
               "replaces": replaces, "launches": cli_counts[name],
               **fields(tk),
               "launches_from": f"cli train ({CLI_ITERS} steps and its eval "
                                f"renders)",
               "fields_from": f"bench training arguments, {tk['when']}",
               "cli": {**fields(cli_tk),
                       "from": f"cli train arguments, {cli_tk['when']}"}}
        if name.startswith("rasterize"):
            # "cell": the same fields on the bench training's arguments at
            # raster cell CELL; launches: that run's.
            out["cell"] = {"cell": list(CELL), **fields(tk_c),
                           "launches": counts_c[name],
                           "from": f"bench training arguments, "
                                   f"{tk_c['when']}"}
        return out

    kernels = [
        row("expand", "expand", "brush_tpu/ops/pallas/expand.py:374"),
        row("rasterize_fwd", "rasterize_fwd",
            "brush_tpu/ops/pallas/rasterize_fwd.py:500"),
        row("rasterize_bwd", "rasterize_bwd",
            "brush_tpu/ops/pallas/rasterize_bwd.py:414"),
        row("segment_sum", "segsum", "brush_tpu/ops/pallas/segsum.py:136"),
    ]
    print(f"[summary] render path launches {render_counts}, at cell {CELL} "
          f"{cell_counts}; training path launches {counts}, at cell {CELL} "
          f"{counts_c}; cli train ({CLI_ITERS} steps) launches "
          f"{cli_counts}; bench render {render_ms:.3f} ms, at cell {CELL} "
          f"{cell_ms:.3f}; bench train step {step_ms:.3f} ms (median of "
          f"{METRIC_STEPS} warm steps at the final capacity), at cell {CELL} "
          f"{step_ms_c:.3f}; the {TRAIN_STEPS}-step window {window_ms:.3f} "
          f"ms, at cell {CELL} {window_ms_c:.3f}; total "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
