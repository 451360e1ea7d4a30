#!/usr/bin/env python3
"""Variants of the port's rasterize_bwd and segment_sum CUDA kernels, timed
in turns on one NVIDIA GPU within one process.

A variant is the repository's source (brush_tpu_torch/csrc/<kernel>.cu)
with text substitutions applied ("OLD=>NEW": a constant, a line), or
another source file with the same C entry point, such as an earlier
commit's kernel:

    mkdir -p runs/parent
    git show HEAD~1:brush_tpu_torch/csrc/segsum.cu > runs/parent/segsum.cu
    git show HEAD~1:brush_tpu_torch/csrc/rasterize_bwd.cu \\
        > runs/parent/rasterize_bwd.cu
    python3 scripts/torch_kernel_variants.py --old-dir runs/parent
    python3 scripts/torch_kernel_variants.py \\
        --variant "bwd 64-record batches" rasterize_bwd "kBatch = 192;=>kBatch = 64;"

Without --variant the DEFAULT_VARIANTS below run. Inputs: the bench scene
of chip_smoke.py (1M random splats, 1024x1024, pool 2162688) through the
port's own stages, the forward kernel's log T and final_idx and a seeded
image cotangent; segment_sum on the re-sorted rows of that backward, and
on the same layout padded to 4194304 splats and a pool of 4194304, the
shape a training run reaches. Every variant is built by nvcc (registers
and shared memory printed), checked against the repository's kernel on
the same inputs (largest row error; two launches bit-equal) and timed with
CUDA events in two rounds, one variant after the other; index_add_ is
timed beside segment_sum. --timeline also runs the repository's
rasterize_bwd with %globaltimer and %smid recorded at each block's start
and end and prints when tiles start, how long the heavy ones run and how
the records spread over the SMs.
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
KERNELS = ("rasterize_bwd", "segsum")
PAD = ("  __shared__ int s_max[kWarps];",
       "  __shared__ int s_max[kWarps];\n"
       "  __shared__ volatile char s_pad[14000]; s_pad[threadIdx.x] = 0;")
DEFAULT_VARIANTS = [
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
    ("  const int t = order[blockIdx.x];\n",
     "  const int t = order[blockIdx.x];\n"
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
    ("  if (last <= start) return;", "  if (last <= start) { tl_end(); return; }"),
    ("  }\n}\n\n}  // namespace", "  }\n  tl_end();\n}\n\n}  // namespace"),
]
P, I = ctypes.c_void_p, ctypes.c_int


def start_build(label, kernel, text):
    """Write text as a source of its own and start nvcc on it."""
    os.makedirs(OUT, exist_ok=True)
    stem = os.path.join(OUT, "".join(c if c.isalnum() else "_" for c in label))
    with open(stem + ".cu", "w") as f:
        f.write(text)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           stem + ".so", stem + ".cu"]
    return dict(label=label, kernel=kernel, so=stem + ".so",
                legacy=kernel == "rasterize_bwd" and "int* order" not in text,
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


def run_bwd(job, packed, starts, ends, tiles_x, v_out, log_t, fidx):
    grads = torch.zeros((9, packed.shape[1]), device="cuda")
    args = [packed.data_ptr(), packed.shape[1], starts.data_ptr(),
            ends.data_ptr(), starts.shape[0], tiles_x, v_out.data_ptr(),
            log_t.data_ptr(), fidx.data_ptr(), grads.data_ptr()]
    if not job["legacy"]:   # sources before the tile order take no scratch
        order = torch.empty_like(starts)
        args.append(order.data_ptr())
    args.append(torch.cuda.current_stream().cuda_stream)
    fn = job["lib"].rasterize_bwd_launch
    fn.argtypes = [P, I, P, P, I, I] + [P] * (len(args) - 6)
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


def compare(tag, jobs, run, args, reps, extra=None):
    """Check every job against the first (the repository's) and time all
    of them in two rounds; extra is (label, fn) timed beside them."""
    ref = run(jobs[0], *args)
    torch.cuda.synchronize()
    for j in jobs:
        got = run(j, *args)
        same = torch.equal(got, run(j, *args))
        print(f"[{tag}] {j['label']}: row error against the repository's "
              f"{cs.row_error(got, ref):.3e}; two launches bit-equal: {same}")
    for rnd in range(2):
        for j in jobs:
            ms = cs.cuda_ms(lambda: run(j, *args), reps=reps)
            print(f"[{tag}] round {rnd}: {j['label']}: {ms:.4f} ms")
        if extra:
            print(f"[{tag}] round {rnd}: {extra[0]}: "
                  f"{cs.cuda_ms(extra[1], reps=reps):.4f} ms")


def timeline(b_args):
    """Per-tile start, end and SM of the repository's rasterize_bwd."""
    job = finish_builds([start_build(
        "timeline", "rasterize_bwd", substituted("rasterize_bwd",
                                                 TIMELINE_SUBS)
        + '\nextern "C" int timeline_read(unsigned long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_timeline, "
        "sizeof(g_timeline));\n}\n")])[0]
    for _ in range(3):
        run_bwd(job, *b_args)
    torch.cuda.synchronize()
    buf = np.zeros(3 * 8192, np.uint64)
    fn = job["lib"].timeline_read
    fn.argtypes = [P]
    fn.restype = I
    build.check(fn(buf.ctypes.data), "timeline_read")
    n_tiles = b_args[1].shape[0]
    if n_tiles > 8192:
        raise SystemExit("the timeline buffer holds 8192 tiles")
    sm, t0, t1 = buf.reshape(-1, 3)[:n_tiles].astype(np.int64).T
    records = (b_args[2] - b_args[1]).cpu().numpy()
    heavy = records > 0.75 * records.max()
    first = t0.min()
    dur = (t1 - t0) / 1e3
    n_sm = int(sm.max()) + 1
    per_sm = np.bincount(sm, weights=records, minlength=n_sm)
    ends = np.array([(t1[sm == s].max() - first) / 1e3 if (sm == s).any()
                     else 0.0 for s in range(n_sm)])
    print(f"[timeline] {n_tiles} tiles, {int((records > 0).sum())} with "
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
    ap.add_argument("--old-dir", help="directory holding other "
                    "rasterize_bwd.cu and/or segsum.cu sources")
    ap.add_argument("--variant", nargs="+", action="append", default=[],
                    metavar="ARG", help="LABEL KERNEL 'OLD=>NEW' ...")
    ap.add_argument("--timeline", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    variants = [(v[0], v[1], v[2:]) for v in opts.variant] or DEFAULT_VARIANTS
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
        splats.capacity, size, cs.BENCH["pool"], cs.BENCH["block"]))
    packed, starts, ends, tiles_x = k["r_args"]
    _, log_t, fidx = rasterize_fwd(*k["r_args"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    v_out = torch.randn((starts.shape[0], 256, 4), generator=gen,
                        device="cuda")
    b_args = (packed, starts, ends, tiles_x, v_out, log_t, fidx)
    bwd_jobs = [j for j in jobs if j["kernel"] == "rasterize_bwd"]
    compare("rasterize_bwd, bench render inputs", bwd_jobs, run_bwd, b_args,
            reps=10)
    if opts.timeline:
        timeline(b_args)

    total, cum, offsets = k["exp_args"][3], k["exp_args"][2], k["offsets"]
    rows = grad_resort(run_bwd(bwd_jobs[0], *b_args), packed[7], total,
                       pack_grad_sort=False)
    n4 = pool4 = 1 << 22
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
