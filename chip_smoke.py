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
     they are checked below; segment_sum also on a layout made by hand
     (a segment of 100,003 slots, runs of empty splats, n no multiple of
     the kernel's block, `total` cutting a segment and `total` 0);
  3. the render path at full width: render_splats(needs_grad=False) of the
     bench scene (1M random splats, SH degree 1, 1024x1024, pool 2162688),
     with the launch counters reset just before and read just after; then
     the median of 10 CUDA-event-timed renders and the forward kernels'
     times at these inputs;
  4. a real model: serve docs/castle_r5_30k.ply through eval_stats at
     800x800 on four cameras of its training orbit, against the same
     views rendered by the port on the CPU (the plain versions);
     rasterize_fwd's check on each of those views and the backward
     kernels' on one (real opacities: saturating pixels, the early-out);
  5. the main path of training at full width: SplatTrainer on the bench
     scene against a black ground truth (bench.py:210-231), 6 steps with
     warmup 1 and refine every 3, so refine runs at iterations 1 (through
     the pre-grow path, capacity 1M -> 2M) and 4 (2M -> 4M); all four
     kernels' counters reset just before and read just after; every
     step's CUDA-event time. The pipeline's calls to the four kernels keep
     their arguments on the first step at each capacity; then the train
     step metric: 8 warm steps at the capacity the run ends at;
  6. each kernel against its plain version (tolerances as in phase 2) on
     the arguments the training run gave it at each capacity, the real
     loss cotangent included; the kernels' times, bounds and errors in
     the result come from the last capacity's arguments;
  7. a real model trains: the castle's SH DC coefficients perturbed by
     0.1 N(0, 1), 12 default SplatTrainer steps on its four clean views;
     the eval PSNR must rise;
  8. print {"kernels": [...]}, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.
The script imports nothing of JAX or of the JAX package.
"""

import contextlib
import json
import os
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


def kernel_inputs(splats, cp, size, pool):
    """The main path's stages up to each kernel, the kernels on the card:
    the expand arguments, the rasterize_fwd arguments and the depth
    order's offsets."""
    from brush_tpu_torch.ops.cuda.expand import expand
    from brush_tpu_torch.ops.pipeline import depth_order, tile_bins
    from brush_tpu_torch.render import record_inputs

    rec = record_inputs(splats.means, splats.log_scales, splats.quats,
                        splats.sh_coeffs, splats.raw_opacity, cp, size,
                        active=splats.active_mask())
    d = depth_order(rec.attrs9, rec.decode, rec.depth_key, pool)
    tiles_x = -(-size[0] // 16)
    num_tiles = tiles_x * -(-size[1] // 16)
    exp_args = (d.f5, d.u5, d.cum, d.total, tiles_x, num_tiles, pool)
    packed, starts, ends = tile_bins(*expand(*exp_args), num_tiles)
    return dict(exp_args=exp_args, r_args=(packed, starts, ends, tiles_x),
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

    packed, starts, ends, tiles_x = k["r_args"]
    _, log_t, fidx = rasterize_fwd(*k["r_args"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    v_out = torch.randn((starts.shape[0], 256, 4), generator=gen,
                        device="cuda")
    b_args = (packed, starts, ends, tiles_x, v_out, log_t, fidx)
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
    check_expand(k["exp_args"])
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
    n_tiles = k["r_args"][1].shape[0]
    ms = lambda b: b / HBM_BYTES_PER_S * 1e3
    ops = lambda o: o / F32_OPS_PER_S * 1e3
    pick = lambda b, o: (max(ms(b), ops(o)),
                         "operations" if ops(o) >= ms(b) else "bytes")
    exp_b = (20 + 20 + 4) * n + 4 + (4 + 32) * pool
    fwd_b = 28 * live + 8 * n_tiles + 24 * 256 * n_tiles
    # bwd: records and tile ranges read, v_out + log T + final_idx read,
    # the (9, pool) gradient rows written once.
    bwd_b = 28 * live + 8 * n_tiles + 24 * 256 * n_tiles + 36 * pool
    fwd_o = PAIR_SIGMA_OPS * fwd["pairs"] + PAIR_ALPHA_OPS * fwd["active"]
    bwd_o = PAIR_SIGMA_OPS * bwd["swept"] + (
        PAIR_ALPHA_OPS + BWD_OPS_PER_ACTIVE) * bwd["active"]
    # segsum: the live slots' nine rows, offsets and cum read; (9, n) out.
    seg_b = 36 * live + 8 * n + 4 + 36 * n
    return {"expand": (ms(exp_b), "bytes"),
            "rasterize_fwd": pick(fwd_b, fwd_o),
            "rasterize_bwd": pick(bwd_b, bwd_o),
            "segment_sum": pick(seg_b, 9 * live)}


def main_path(splats, cp, size, cfg):
    """Phase 3: one counted render of the bench scene, then timings."""
    import torch
    from brush_tpu_torch.ops.cuda import expand, rasterize_fwd
    from brush_tpu_torch.render import render_splats

    def render():
        return render_splats(
            splats.means, splats.log_scales, splats.quats, splats.sh_coeffs,
            splats.raw_opacity, cp, size, active=splats.active_mask(),
            block_size=cfg["block"], max_isects=cfg["pool"],
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
    print(f"[main path] bench render {size[0]}x{size[1]}, {cfg['n']} splats: "
          f"visible={int(aux.num_visible)} records={int(aux.num_isects)} "
          f"dropped={dropped} launches={counts}")
    print(f"[main path] median of 10 renders {ms:.3f} ms "
          f"({size[0] * size[1] / ms / 1e3:.2f} Mpix/s); all ms "
          f"{[round(t, 3) for t in times]}")
    return counts


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


def train_path(cfg):
    """Phase 5, the main path: SplatTrainer steps on the bench scene
    against a black ground truth, all four kernels counted, and the
    kernels' arguments kept on the first step at each capacity. Then the
    train step metric at the capacity the run ended at."""
    import torch
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.config import TrainConfig
    from brush_tpu_torch.train import SceneBatch, SplatTrainer

    t_phase = time.perf_counter()
    splats, _, size = make_scene(cfg, "cuda")
    cam = Camera(position=[0, 0, cfg["z"]], rotation=[1, 0, 0, 0],
                 fov_x=np.pi / 2, fov_y=np.pi / 2)
    batch = SceneBatch(np.zeros((size[1], size[0], 3), np.float32), cam)
    trainer = SplatTrainer(TrainConfig(warmup_steps=1, refine_every=3))
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
    print(f"[train] bench scene {size[0]}x{size[1]}, {cfg['n']} splats, "
          f"{TRAIN_STEPS} steps: step ms {[round(t, 3) for t in times]} "
          f"at capacities {caps}; the whole window {sum(times):.3f} ms")
    print(f"[train] losses {losses}; records {records}; dropped {dropped}; "
          f"launches {counts}")
    print(f"[train] refines {dict((i, r._asdict()) for i, r in refines.items())}; "
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
    timer = SplatTrainer()
    if timer._pool_size(sp.capacity) != pool:
        raise AssertionError("the metric steps would use another pool")
    state, warm, _, rf = timed_steps(timer, state, batch, METRIC_STEPS + 1)
    if rf:
        raise AssertionError("a metric step refined")
    step_ms = statistics.median(warm[1:])
    print(f"[train] metric: capacity {sp.capacity}, pool {pool}: median of "
          f"{METRIC_STEPS} warm steps {step_ms:.3f} ms (after one more "
          f"step); all ms {[round(t, 3) for t in warm]}; "
          f"{time.perf_counter() - t0:.1f} s")
    return counts, step_ms, sum(times), kept


def train_kernels(kept):
    """Phase 6: each kernel against its plain version on the arguments
    the training run gave it at each capacity; then the times, bounds and
    errors of the last capacity's arguments, as the result reports them."""
    import torch
    from brush_tpu_torch.ops.cuda.expand import expand
    from brush_tpu_torch.ops.cuda.rasterize_bwd import rasterize_bwd
    from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd
    from brush_tpu_torch.ops.cuda.segsum import segment_sum, slot_owners

    for cap in sorted(kept):
        t0 = time.perf_counter()
        args = kept[cap]
        label = f"train {cap}"
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
    s_lib = cuda_ms(lambda: torch.zeros((9, n), device="cuda").index_add_(
        1, ids, live_rows), reps=20)
    print(f"[train kernels] capacity {cap}: "
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
                bound=bounds(k, r, b), library=s_lib)


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

    kernel_phase(ENTRY, "entry", backward=True)
    check_segsum_hand()
    check_raster_hand()
    splats, cp, size, k = kernel_phase(BENCH, "bench", backward=False)
    render_counts = main_path(splats, cp, size, BENCH)

    from brush_tpu_torch.ops.cuda.expand import expand, expand_plain
    from brush_tpu_torch.ops.cuda.rasterize_fwd import (
        rasterize_fwd, rasterize_fwd_plain,
    )

    # The forward kernels' times at the render's inputs; these launches
    # come after the render path's counts were read.
    t_k = time.perf_counter()
    exp_args, r_args = k["exp_args"], k["r_args"]
    e_ms = cuda_ms(lambda: expand(*exp_args), reps=20)
    e_plain = cuda_ms(lambda: expand_plain(*exp_args), reps=3)
    r_ms = cuda_ms(lambda: rasterize_fwd(*r_args), reps=20)
    r_plain = cuda_ms(lambda: rasterize_fwd_plain(*r_args), reps=2)
    # No backward ran on these inputs: its bound is not read.
    bound = bounds(k, k["fwd"], dict(swept=0, active=0))
    print(f"[kernels] bench render inputs: expand {e_ms:.4f} ms (plain "
          f"{e_plain:.3f}, bound {bound['expand'][0]:.4f} by "
          f"{bound['expand'][1]}); rasterize_fwd {r_ms:.4f} ms (plain "
          f"{r_plain:.3f}, bound {bound['rasterize_fwd'][0]:.4f} by "
          f"{bound['rasterize_fwd'][1]}); {time.perf_counter() - t_k:.1f} s")
    del splats, k, exp_args, r_args
    torch.cuda.empty_cache()

    castle, cams, gts, castle_pool = castle_phase()
    castle_kernels(castle, cams, castle_pool)
    torch.cuda.empty_cache()

    counts, step_ms, window_ms, kept = train_path(BENCH)
    tk = train_kernels(kept)
    del kept
    torch.cuda.empty_cache()
    castle_training(castle, cams, gts)

    def row(name, src, replaces):
        return {"name": name, "route": "cuda",
                "source": f"brush_tpu_torch/csrc/{src}.cu",
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": tk["err"][name], "ms": tk["ms"][name],
                "plain_ms": tk["plain"][name],
                "bound_ms": tk["bound"][name][0],
                "bound_by": tk["bound"][name][1],
                "library_ms": tk["library"] if name == "segment_sum" else None}

    kernels = [
        row("expand", "expand", "brush_tpu/ops/pallas/expand.py:374"),
        row("rasterize_fwd", "rasterize_fwd",
            "brush_tpu/ops/pallas/rasterize_fwd.py:500"),
        row("rasterize_bwd", "rasterize_bwd",
            "brush_tpu/ops/pallas/rasterize_bwd.py:414"),
        row("segment_sum", "segsum", "brush_tpu/ops/pallas/segsum.py:136"),
    ]
    print(f"[summary] render path launches {render_counts}; training path "
          f"launches {counts}; bench train step {step_ms:.3f} ms (median of "
          f"{METRIC_STEPS} warm steps at the final capacity), the "
          f"{TRAIN_STEPS}-step window {window_ms:.3f} ms; total "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
