#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (brush_tpu_torch) runs on an
NVIDIA GPU. Run from the repository root on a machine with one card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero without its
result line):
  1. build the CUDA kernels from brush_tpu_torch/csrc/ (one nvcc per
     source, in parallel) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card, at
     the entry scene (16384 splats, 256x256) and the bench scene: expand
     byte-equal; rasterize_fwd img and log_t within 1e-5 with threshold
     flips counted and bounded (<= 2e-3 of the pixels, each <= 0.01) and
     final_idx equal on every other pixel;
  3. the main path at full width: render_splats(needs_grad=False) of the
     bench scene (1M random splats, SH degree 1, 1024x1024, pool 2162688),
     with the launch counters reset just before and read just after; then
     the median of 10 CUDA-event-timed renders and each kernel's time;
  4. a real model: serve docs/castle_r5_30k.ply through eval_stats at
     800x800 on four cameras of its training orbit, against the same
     views rendered by the port on the CPU (the plain versions);
  5. print {"kernels": [...]}, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.
The script imports nothing of JAX or of the JAX package.
"""

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
# Float32 operations per (pixel, record) pair in rasterize_fwd: two
# subtractions, seven multiplies and two adds for sigma, max, negate, exp,
# multiply, min and two compares for alpha (the contributing pairs' extra
# log1p/exp/colour work is not counted: the bound stays a lower bound).
RASTER_OPS_PER_PAIR = 20

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


def kernel_inputs(splats, cp, size, cfg):
    """The main path's stages up to each kernel, the kernels on the card:
    returns the expand inputs and the rasterize_fwd inputs."""
    from brush_tpu_torch.ops.cuda.expand import expand
    from brush_tpu_torch.ops.pipeline import depth_order, tile_bins
    from brush_tpu_torch.render import pool_size, record_inputs

    pool = pool_size(splats.capacity, size, cfg["pool"], cfg["block"])
    rec = record_inputs(splats.means, splats.log_scales, splats.quats,
                        splats.sh_coeffs, splats.raw_opacity, cp, size,
                        active=splats.active_mask())
    f5, u5, cum, total, _ = depth_order(rec.attrs9, rec.decode,
                                        rec.depth_key, pool)
    tiles_x = -(-size[0] // 16)
    num_tiles = tiles_x * -(-size[1] // 16)
    exp_args = (f5, u5, cum, total, tiles_x, num_tiles, pool)
    packed, starts, ends = tile_bins(*expand(*exp_args), num_tiles)
    return exp_args, (packed, starts, ends, tiles_x)


def check_expand(exp_args):
    import torch
    from brush_tpu_torch.ops.cuda.expand import expand, expand_plain

    keys, recs = expand(*exp_args)
    torch.cuda.synchronize()
    pk, pr = expand_plain(*exp_args)
    bad = int((keys != pk).sum()) + int((recs != pr).sum())
    if bad:
        raise AssertionError(f"expand: {bad} words differ from the plain "
                             "version")
    return 0.0


def check_raster(r_args, atol=1e-5, flip_tol=0.01, max_flip_frac=2e-3):
    """Kernel vs plain: returns (max abs error, flipped pixels, pairs)."""
    import torch
    from brush_tpu_torch.ops.cuda.rasterize_fwd import (
        rasterize_fwd, rasterize_fwd_plain,
    )

    img, log_t, fidx = rasterize_fwd(*r_args)
    torch.cuda.synchronize()
    p_img, p_log_t, p_fidx, pairs = rasterize_fwd_plain(*r_args,
                                                        count_pairs=True)
    d_img = (img - p_img).abs().amax(dim=-1)
    d_lt = (log_t - p_log_t).abs()
    err = float(torch.maximum(d_img, d_lt).max())
    flipped = (d_img > atol) | (d_lt > atol)
    n_flip = int(flipped.sum())
    n_fidx = int(((fidx != p_fidx) & ~flipped).sum())
    limit = max(1, int(max_flip_frac * fidx.numel()))
    if err > flip_tol or n_flip > limit or n_fidx:
        raise AssertionError(
            f"rasterize_fwd: max err {err:.3e}, {n_flip} flipped pixels "
            f"(limit {limit}), {n_fidx} final_idx mismatches elsewhere")
    return err, n_flip, pairs


def kernel_phase(cfg, label):
    splats, cp, size = make_scene(cfg, "cuda")
    exp_args, r_args = kernel_inputs(splats, cp, size, cfg)
    check_expand(exp_args)
    err, n_flip, pairs = check_raster(r_args)
    total = int(exp_args[3][0])
    print(f"[{label}] n={cfg['n']} {size[0]}x{size[1]} pool={exp_args[6]} "
          f"records={total}: expand byte-equal; rasterize_fwd max err "
          f"{err:.3e}, flipped pixels {n_flip}, pairs evaluated {pairs}")
    return splats, cp, size, exp_args, r_args, err, pairs


def bounds(exp_args, r_args, pairs):
    """Least times (ms) for this run's inputs: (expand, rasterize_fwd)."""
    f5, u5, cum, total = exp_args[:4]
    pool = exp_args[6]
    n = f5.shape[1]
    exp_bytes = (20 + 20 + 4) * n + 4 + (4 + 32) * pool
    packed, starts, ends, _ = r_args
    n_tiles = starts.shape[0]
    rec_bytes = 28 * int(total[0]) + 8 * n_tiles + 24 * 256 * n_tiles
    exp_ms = exp_bytes / HBM_BYTES_PER_S * 1e3
    r_bytes_ms = rec_bytes / HBM_BYTES_PER_S * 1e3
    r_ops_ms = RASTER_OPS_PER_PAIR * pairs / F32_OPS_PER_S * 1e3
    by = "operations" if r_ops_ms >= r_bytes_ms else "bytes"
    return (exp_ms, "bytes"), (max(r_ops_ms, r_bytes_ms), by)


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
    """Phase 4: eval_stats on the card against the CPU (plain) render."""
    import torch
    from brush_tpu_torch.datasets.ply import load_splats_from_ply
    from brush_tpu_torch.eval import eval_stats, eval_view
    from brush_tpu_torch.ops.cuda import expand, rasterize_fwd

    with open(CASTLE_PLY, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    gpu = load_splats_from_ply(data, device="cuda")
    cpu = load_splats_from_ply(data, device="cpu")
    cams = [orbit_camera(2 * np.pi * i / 4 + 0.3, 0.55) for i in range(4)]
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

    kernel_phase(ENTRY, "entry")
    splats, cp, size, exp_args, r_args, r_err, pairs = kernel_phase(
        BENCH, "bench")
    counts = main_path(splats, cp, size, BENCH)

    from brush_tpu_torch.ops.cuda.expand import expand, expand_plain
    from brush_tpu_torch.ops.cuda.rasterize_fwd import (
        rasterize_fwd, rasterize_fwd_plain,
    )

    # Kernel times at the bench scene's inputs; these launches come after
    # the main path's counts were read.
    e_ms = cuda_ms(lambda: expand(*exp_args), reps=20)
    e_plain = cuda_ms(lambda: expand_plain(*exp_args), reps=3)
    r_ms = cuda_ms(lambda: rasterize_fwd(*r_args), reps=20)
    r_plain = cuda_ms(lambda: rasterize_fwd_plain(*r_args), reps=2)
    print(f"[kernels] expand {e_ms:.4f} ms (plain {e_plain:.3f}); "
          f"rasterize_fwd {r_ms:.4f} ms (plain {r_plain:.3f})")
    (e_bound, e_by), (r_bound, r_by) = bounds(exp_args, r_args, pairs)
    del splats, exp_args, r_args
    torch.cuda.empty_cache()

    castle_phase()

    kernels = [
        {"name": "expand", "route": "cuda",
         "source": "brush_tpu_torch/csrc/expand.cu",
         "replaces": "brush_tpu/ops/pallas/expand.py:374",
         "launches": counts["expand"], "max_abs_err": 0.0,
         "ms": e_ms, "plain_ms": e_plain, "bound_ms": e_bound,
         "bound_by": e_by, "library_ms": None},
        {"name": "rasterize_fwd", "route": "cuda",
         "source": "brush_tpu_torch/csrc/rasterize_fwd.cu",
         "replaces": "brush_tpu/ops/pallas/rasterize_fwd.py:500",
         "launches": counts["rasterize_fwd"], "max_abs_err": r_err,
         "ms": r_ms, "plain_ms": r_plain, "bound_ms": r_bound,
         "bound_by": r_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
