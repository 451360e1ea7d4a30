#!/usr/bin/env python3
"""Variants of the port's rasterize_fwd, rasterize_bwd and segment_sum CUDA
kernels, timed in turns on one NVIDIA GPU within one process.

A variant is the repository's source (brush_tpu_torch/csrc/<kernel>.cu)
with text substitutions applied ("OLD=>NEW": a constant, a line), or
another source file with the same C entry point, such as an earlier
commit's kernel:

    mkdir -p runs/parent
    git show HEAD~1:brush_tpu_torch/csrc/rasterize_fwd.cu \\
        > runs/parent/rasterize_fwd.cu
    python3 scripts/torch_kernel_variants.py --old-dir runs/parent
    python3 scripts/torch_kernel_variants.py --old-dir runs/parent --old-only
    python3 scripts/torch_kernel_variants.py --old-dir runs/other --old-only \
        --cell 2x2
    python3 scripts/torch_kernel_variants.py \\
        --variant "bwd 64-record batches" rasterize_bwd "kBatch = 192;=>kBatch = 64;"

Without --variant the DEFAULT_VARIANTS below run. Inputs: the bench scene
of chip_smoke.py (1M random splats, 1024x1024, pool 2162688) through the
port's own stages: rasterize_fwd on the render's packed pool and on the
same records in a pool of 4194304, the shape a training run reaches;
rasterize_bwd on the forward kernel's log T and final_idx and a seeded
image cotangent; segment_sum on the re-sorted rows of that backward, and
on the same layout padded to 4194304 splats and a pool of 4194304. Every
variant is built by nvcc (registers and shared memory printed), checked
against the repository's kernel on the same inputs (largest error of each
output row over that row's largest value, and whether every bit is equal;
two launches bit-equal) and
timed with CUDA events in two rounds, one variant after the other;
index_add_ is timed beside segment_sum. --timeline also runs the
repository's rasterize_fwd and rasterize_bwd with %globaltimer and %smid
recorded at each block's start and end and prints when tiles start, how
long the heavy ones run and how the records spread over the SMs. --castle
also holds every rasterize_fwd source to the plain version on the four
castle views of chip_smoke.py, whose pixels saturate. --cell GWxGH builds
the inputs at a raster cell (sources before the cell mode take 1x1 only).
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from brush_tpu_torch.ops.cuda import build  # noqa: E402
from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd  # noqa: E402
from brush_tpu_torch.ops.cuda.segsum import slot_owners  # noqa: E402
from brush_tpu_torch.ops.pipeline import grad_resort  # noqa: E402
from brush_tpu_torch.render import pool_size  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "variants")
KERNELS = ("rasterize_fwd", "rasterize_bwd", "segsum")
PAD = ("  __shared__ int s_max[kWarps];",
       "  __shared__ int s_max[kWarps];\n"
       "  __shared__ volatile char s_pad[14000]; s_pad[threadIdx.x] = 0;")
# rasterize_fwd with log T carried as the plain version carries it: a sum of
# log1pf(-alpha), and T = expf(log T) taken whenever it changes.
SUM_OF_LOGS = [
    "  float t_cur = 1.0f;=>  float t_cur = 1.0f, log_t = 0.0f;",
    "t_cur * (1.0f - alpha);=>__fadd_rn(log_t, log1pf(-alpha));",
    "if (after <= kTEps) {=>if (after <= -9.210340371976182f) {",
    "        t_cur = after;\n=>"
    "        log_t = after;\n        t_cur = expf(after);\n",
    "log_t_out[p] = logf(t_cur);=>log_t_out[p] = log_t;",
]
DEFAULT_VARIANTS = [
    ("fwd 1 record a step", "rasterize_fwd", ["kUnroll = 8;=>kUnroll = 1;"]),
    ("fwd 4 records a step", "rasterize_fwd", ["kUnroll = 8;=>kUnroll = 4;"]),
    ("fwd 16 records a step", "rasterize_fwd",
     ["kUnroll = 8;=>kUnroll = 16;"]),
    ("fwd tiles in index order", "rasterize_fwd",
     ["order[blockIdx.x]=>blockIdx.x"]),
    ("fwd pretest off", "rasterize_fwd", ["sigma[u] <= sigma_max;=>true;"]),
    ("fwd 192-record batches", "rasterize_fwd",
     ["kBatch = 384;=>kBatch = 192;"]),
    ("fwd 512-record batches", "rasterize_fwd",
     ["kBatch = 384;=>kBatch = 512;"]),
    ("fwd log T as a sum of log1p", "rasterize_fwd", SUM_OF_LOGS),
    ("bwd 4 pixels a thread, 2 records a step", "rasterize_bwd",
     ["kPix = 2;=>kPix = 4;", "kUnroll = 4;=>kUnroll = 2;"]),
    ("bwd 8 pixels a thread, 1 record a step", "rasterize_bwd",
     ["kPix = 2;=>kPix = 8;", "kUnroll = 4;=>kUnroll = 1;"]),
    ("bwd 1 record a step", "rasterize_bwd", ["kUnroll = 4;=>kUnroll = 1;"]),
    ("bwd tiles in index order", "rasterize_bwd",
     ["order[blockIdx.x]=>blockIdx.x"]),
    ("bwd 128-record batches (8 blocks an SM)", "rasterize_bwd",
     ["kBatch = 192;=>kBatch = 128;"]),
    ("bwd 128-record batches, padded to 5 blocks an SM", "rasterize_bwd",
     ["kBatch = 192;=>kBatch = 128;", "=>".join(PAD)]),
    ("bwd IEEE division", "rasterize_bwd",
     ["__fdividef(1.0f, 1.0f - alpha)=>1.0f / (1.0f - alpha)"]),
    ("seg 256-slot chunks", "segsum", ["kChunk = 512;=>kChunk = 256;"]),
]
TIMELINE_SUBS = [
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long g_timeline[3 * 8192];\n"),
    ("  const int tid = threadIdx.x;\n",
     "  const int tid = threadIdx.x;\n"
     "  unsigned long long tl_t0; unsigned tl_sm;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(tl_t0));\n'
     '  asm volatile("mov.u32 %0, %%smid;" : "=r"(tl_sm));\n'
     "  auto tl_end = [&]() {\n"
     "    unsigned long long t1;\n"
     '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));\n'
     "    if (threadIdx.x == 0 && t < 8192) {\n"
     "      g_timeline[3 * t] = tl_sm; g_timeline[3 * t + 1] = tl_t0;\n"
     "      g_timeline[3 * t + 2] = t1;\n"
     "    }\n"
     "  };\n"),
    ("}\n\n}  // namespace", "  tl_end();\n}\n\n}  // namespace"),
]
TIMELINE_BWD_SUBS = [   # the backward's early return
    ("  if (last <= start) return;",
     "  if (last <= start) { tl_end(); return; }"),
]
P, I = ctypes.c_void_p, ctypes.c_int


def start_build(label, kernel, text):
    """Write text as a source of its own and start nvcc on it. Its C entry
    is "legacy" before the tile order (no scratch argument) and takes
    "cells" since the raster-cell mode (cell_w, cell_h; the backward also a
    state scratch), which run_fwd and run_bwd pass as cell (1, 1)."""
    os.makedirs(OUT, exist_ok=True)
    stem = os.path.join(OUT, "".join(c if c.isalnum() else "_" for c in label))
    with open(stem + ".cu", "w") as f:
        f.write(text)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC,
           "-Xptxas", "-v", "-o", stem + ".so", stem + ".cu"]
    return dict(label=label, kernel=kernel, so=stem + ".so",
                legacy=kernel != "segsum" and "int* order" not in text,
                cells="int cell_w" in text,
                proc=subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))


def substituted(kernel, subs):
    with open(os.path.join(build.CSRC, f"{kernel}.cu")) as f:
        text = f.read()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{kernel}.cu has no {old!r}")
        text = text.replace(old, new, 1)
    return text


def finish_builds(jobs):
    for j in jobs:
        proc = j.pop("proc")
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {j['label']}:\n{log}")
        used = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"[build] {j['label']}: {'; '.join(used)}")
        j["lib"] = ctypes.CDLL(j["so"])
    return jobs


def cell_ints(job, cell):
    """The (cell_w, cell_h) arguments of job's C entry: none before the
    raster-cell mode, which runs cell (1, 1) only."""
    if job["cells"]:
        return list(cell)
    if tuple(cell) != (1, 1):
        raise SystemExit(f"{job['label']} takes no raster cell")
    return []


def run_fwd(job, packed, starts, ends, tiles_x, cell=(1, 1)):
    n_tiles = starts.shape[0]
    px = 256 * cell[0] * cell[1]
    img = torch.empty((n_tiles, px, 4), device="cuda")
    log_t = torch.empty((n_tiles, px), device="cuda")
    fidx = torch.empty((n_tiles, px), dtype=torch.int32, device="cuda")
    args = [packed.data_ptr(), packed.shape[1], starts.data_ptr(),
            ends.data_ptr(), n_tiles, tiles_x]
    cells = cell_ints(job, cell)
    args += cells + [img.data_ptr(), log_t.data_ptr(), fidx.data_ptr()]
    if not job["legacy"]:   # sources before the tile order take no scratch
        order = torch.empty_like(starts)
        args.append(order.data_ptr())
    args.append(torch.cuda.current_stream().cuda_stream)
    fn = job["lib"].rasterize_fwd_launch
    fn.argtypes = ([P, I, P, P, I, I] + [I] * len(cells)
                   + [P] * (len(args) - 6 - len(cells)))
    fn.restype = I
    build.check(fn(*args), job["label"])
    return img, log_t, fidx


def fwd_rows(out):
    """The forward's outputs as rows: r, g, b, a, log T, final_idx (exact
    in float32 below 2^24)."""
    img, log_t, fidx = out
    return torch.cat([img.reshape(-1, 4).T, log_t.reshape(1, -1),
                      fidx.reshape(1, -1).to(torch.float32)])


def run_bwd(job, packed, starts, ends, tiles_x, v_out, log_t, fidx,
            cell=(1, 1)):
    grads = torch.zeros((9, packed.shape[1]), device="cuda")
    args = [packed.data_ptr(), packed.shape[1], starts.data_ptr(),
            ends.data_ptr(), starts.shape[0], tiles_x]
    cells = cell_ints(job, cell)
    args += cells + [v_out.data_ptr(), log_t.data_ptr(), fidx.data_ptr(),
                     grads.data_ptr()]
    if not job["legacy"]:   # sources before the tile order take no scratch
        order = torch.empty_like(starts)
        args.append(order.data_ptr())
    if job["cells"]:        # the state scratch, unread at cell (1, 1)
        state = torch.empty(2 * log_t.numel() if cell[0] * cell[1] > 1
                            else 2, device="cuda")
        args.append(state.data_ptr())
    args.append(torch.cuda.current_stream().cuda_stream)
    fn = job["lib"].rasterize_bwd_launch
    fn.argtypes = ([P, I, P, P, I, I] + [I] * len(cells)
                   + [P] * (len(args) - 6 - len(cells)))
    fn.restype = I
    build.check(fn(*args), job["label"])
    return grads


def run_seg(job, rows, offsets, cum, total):
    n = offsets.shape[0]
    out = torch.empty((9, n), device="cuda")
    fn = job["lib"].segsum_launch
    fn.argtypes = [P, I, P, P, P, I, P, P]
    fn.restype = I
    build.check(fn(rows.data_ptr(), rows.shape[1], offsets.data_ptr(),
                   cum.data_ptr(), total.data_ptr(), n, out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream), job["label"])
    return out


def compare(tag, jobs, run, args, reps, extra=None, rows=lambda out: out):
    """Check every job against the first (the repository's) and time all
    of them in two rounds; extra is (label, fn) timed beside them; rows
    makes one (rows, n) tensor of what run returns."""
    ref = rows(run(jobs[0], *args))
    torch.cuda.synchronize()
    for j in jobs:
        got = rows(run(j, *args))
        same = torch.equal(got, rows(run(j, *args)))
        bits = torch.equal(got.view(torch.int32), ref.view(torch.int32))
        print(f"[{tag}] {j['label']}: row error against the repository's "
              f"{cs.row_error(got, ref):.3e}, bit-equal to it: {bits}; two "
              f"launches bit-equal: {same}")
    for rnd in range(2):
        for j in jobs:
            ms = cs.cuda_ms(lambda: run(j, *args), reps=reps)
            print(f"[{tag}] round {rnd}: {j['label']}: {ms:.4f} ms")
        if extra:
            print(f"[{tag}] round {rnd}: {extra[0]}: "
                  f"{cs.cuda_ms(extra[1], reps=reps):.4f} ms")


def castle_views(fwd_jobs):
    """Every rasterize_fwd job against the plain version on the four castle
    views of chip_smoke.py (a trained model: pixels saturate, the early-out
    ends tiles): the largest error, the flipped pixels and the largest img
    or T difference at one, as chip_smoke.raster_diff counts them."""
    from brush_tpu_torch.datasets.ply import load_splats_from_ply
    from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd_plain
    from brush_tpu_torch.ops.rasterize_reference import camera_params

    with open(cs.CASTLE_PLY, "rb") as f:
        splats = load_splats_from_ply(f.read(), device="cuda")
    size = (cs.CASTLE_SIZE, cs.CASTLE_SIZE)
    for view, cam in enumerate(cs.castle_cameras()):
        cp = camera_params(cam, size, device="cuda")
        pool = pool_size(splats.capacity, size)
        k = cs.kernel_inputs(splats, cp, size, pool)
        while k["raw_total"] > pool:   # as eval_view grows its pool
            pool *= 2
            k = cs.kernel_inputs(splats, cp, size, pool)
        plain = rasterize_fwd_plain(*k["r_args"])
        for j in fwd_jobs:
            d = cs.raster_diff(run_fwd(j, *k["r_args"][:4]), plain)
            print(f"[castle view {view}] {j['label']}: max err "
                  f"{d['err']:.3e}, flipped pixels {d['flips']} (largest "
                  f"img or T difference there {d['flip_err']:.3e}), "
                  f"final_idx mismatches elsewhere {d['fidx']}")


def timeline(kernel, run, k_args):
    """Per-tile start, end and SM of the repository's rasterize_fwd or
    rasterize_bwd; k_args start (packed, starts, ends, ...)."""
    subs = TIMELINE_SUBS + (TIMELINE_BWD_SUBS if kernel == "rasterize_bwd"
                            else [])
    job = finish_builds([start_build(
        f"timeline {kernel}", kernel, substituted(kernel, subs)
        + '\nextern "C" int timeline_read(unsigned long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_timeline, "
        "sizeof(g_timeline));\n}\n")])[0]
    for _ in range(3):
        run(job, *k_args)
    torch.cuda.synchronize()
    buf = np.zeros(3 * 8192, np.uint64)
    fn = job["lib"].timeline_read
    fn.argtypes = [P]
    fn.restype = I
    build.check(fn(buf.ctypes.data), "timeline_read")
    n_tiles = k_args[1].shape[0]
    if n_tiles > 8192:
        raise SystemExit("the timeline buffer holds 8192 tiles")
    sm, t0, t1 = buf.reshape(-1, 3)[:n_tiles].astype(np.int64).T
    records = (k_args[2] - k_args[1]).cpu().numpy()
    heavy = records > 0.75 * records.max()
    first = t0.min()
    dur = (t1 - t0) / 1e3
    n_sm = int(sm.max()) + 1
    per_sm = np.bincount(sm, weights=records, minlength=n_sm)
    ends = np.array([(t1[sm == s].max() - first) / 1e3 if (sm == s).any()
                     else 0.0 for s in range(n_sm)])
    print(f"[timeline] {kernel}: {n_tiles} tiles, "
          f"{int((records > 0).sum())} with "
          f"records (most {records.max()}), {int(heavy.sum())} heavy (over "
          f"3/4 of the most); kernel span {(t1.max() - first) / 1e3:.1f} us")
    print(f"[timeline] heavy tiles start at us min/median/max "
          f"{(t0[heavy] - first).min() / 1e3:.0f}/"
          f"{np.median(t0[heavy] - first) / 1e3:.0f}/"
          f"{(t0[heavy] - first).max() / 1e3:.0f} and run us "
          f"{dur[heavy].min():.0f}/{np.median(dur[heavy]):.0f}/"
          f"{dur[heavy].max():.0f}; us per record "
          f"{np.median(dur[heavy] / records[heavy]):.4f}")
    print(f"[timeline] heavy tiles per SM, count of SMs with 0, 1, ..: "
          f"{np.bincount(np.bincount(sm[heavy], minlength=n_sm)).tolist()}; "
          f"records per SM min/median/max {per_sm.min():.0f}/"
          f"{np.median(per_sm):.0f}/{per_sm.max():.0f}; SMs end at us "
          f"{ends.min():.0f}/{np.median(ends):.0f}/{ends.max():.0f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-dir", help="directory holding other sources "
                    "of these kernels (<kernel>.cu), timed beside them")
    ap.add_argument("--variant", nargs="+", action="append", default=[],
                    metavar="ARG", help="LABEL KERNEL 'OLD=>NEW' ...")
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--castle", action="store_true", help="also hold every "
                    "rasterize_fwd source to the plain version on the four "
                    "castle views")
    ap.add_argument("--old-only", action="store_true", help="without "
                    "--variant, run only the repository's sources and "
                    "--old-dir's (no default variants)")
    ap.add_argument("--cell", default="1x1", help="raster cell GWxGH of the "
                    "inputs (sources before the cell mode run 1x1 only)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    cell = tuple(int(v) for v in opts.cell.lower().split("x"))
    if cell != (1, 1) and opts.timeline:
        raise SystemExit("--timeline times tiles: run it at --cell 1x1")
    variants = [(v[0], v[1], v[2:]) for v in opts.variant] or (
        [] if opts.old_only else DEFAULT_VARIANTS)
    pending = [start_build(f"repository's {k}", k, substituted(k, []))
               for k in KERNELS]
    for k in KERNELS:
        path = os.path.join(opts.old_dir or "", f"{k}.cu")
        if opts.old_dir and os.path.exists(path):
            with open(path) as f:
                pending.append(start_build(f"{opts.old_dir}'s {k}", k,
                                           f.read()))
    for label, kernel, subs in variants:
        if kernel not in KERNELS:
            raise SystemExit(f"unknown kernel {kernel!r}: {KERNELS}")
        pairs = [tuple(s.split("=>", 1)) for s in subs]
        pending.append(start_build(label, kernel, substituted(kernel, pairs)))
    jobs = finish_builds(pending)
    print(f"[device] {cs.smi_line()}")

    splats, cp, size = cs.make_scene(cs.BENCH, "cuda")
    k = cs.kernel_inputs(splats, cp, size, pool_size(
        splats.capacity, size, cs.BENCH["pool"], cs.BENCH["block"]), cell)
    packed, starts, ends, tiles_x, _ = k["r_args"]
    print(f"[inputs] bench render at cell {cell}: {starts.shape[0]} cells, "
          f"{int(k['exp_args'][3][0])} records")
    fwd_jobs = [j for j in jobs if j["kernel"] == "rasterize_fwd"]
    n4 = pool4 = 1 << 22
    packed4 = torch.zeros((8, pool4), dtype=torch.int32, device="cuda")
    packed4[:, :packed.shape[1]] = packed
    for tag, f_args in (
            ("rasterize_fwd, bench render inputs", k["r_args"]),
            (f"rasterize_fwd, the same records in a pool of {pool4}",
             (packed4, starts, ends, tiles_x, cell))):
        compare(tag, fwd_jobs, run_fwd, f_args, reps=20, rows=fwd_rows)
    del packed4
    if opts.castle:
        castle_views(fwd_jobs)
    if opts.timeline:
        timeline("rasterize_fwd", run_fwd, k["r_args"][:4])
    _, log_t, fidx = rasterize_fwd(*k["r_args"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    v_out = torch.randn((*log_t.shape, 4), generator=gen, device="cuda")
    b_args = (packed, starts, ends, tiles_x, v_out, log_t, fidx, cell)
    bwd_jobs = [j for j in jobs if j["kernel"] == "rasterize_bwd"]
    compare("rasterize_bwd, bench render inputs", bwd_jobs, run_bwd, b_args,
            reps=10)
    if opts.timeline:
        timeline("rasterize_bwd", run_bwd, b_args)

    total, cum, offsets = k["exp_args"][3], k["exp_args"][2], k["offsets"]
    rows = grad_resort(run_bwd(bwd_jobs[0], *b_args), packed[7], total,
                       pack_grad_sort=False)
    rows4 = torch.zeros((9, pool4), device="cuda")
    rows4[:, :rows.shape[1]] = rows
    tail = total.expand(n4 - offsets.shape[0])   # padding splats: no slot
    seg_jobs = [j for j in jobs if j["kernel"] == "segsum"]
    for tag, s_args in (
            ("segment_sum, n 1048576, pool 2162688",
             (rows, offsets, cum, total)),
            ("segment_sum, n 4194304, pool 4194304",
             (rows4, torch.cat([offsets, tail]), torch.cat([cum, tail]),
              total))):
        ids = slot_owners(s_args[2], total, s_args[0].shape[1])
        live = s_args[0][:, :ids.shape[0]].contiguous()
        n = s_args[1].shape[0]
        compare(tag, seg_jobs, run_seg, s_args, reps=20, extra=(
            "index_add_", lambda: torch.zeros((9, n), device="cuda")
            .index_add_(1, ids, live)))


if __name__ == "__main__":
    main()
