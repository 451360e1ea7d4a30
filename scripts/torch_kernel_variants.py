#!/usr/bin/env python3
"""Variants of the port's expand, rasterize_fwd, rasterize_bwd and
segment_sum CUDA kernels, timed in turns on one NVIDIA GPU within one
process.

A variant is the repository's source (brush_tpu_torch/csrc/<kernel>.cu)
with text substitutions applied ("OLD=>NEW": a constant, a line), or
another source file with the same C entries (ops/cuda/build.ENTRIES,
through which every source's library is bound), such as an earlier
commit's kernel:

    mkdir -p runs/parent
    git show HEAD~1:brush_tpu_torch/csrc/rasterize_fwd.cu \\
        > runs/parent/rasterize_fwd.cu
    python3 scripts/torch_kernel_variants.py --old-dir runs/parent
    python3 scripts/torch_kernel_variants.py --old-dir runs/parent --old-only
    python3 scripts/torch_kernel_variants.py --old-dir runs/other --old-only \\
        --cell 2x2 4x2
    python3 scripts/torch_kernel_variants.py \\
        --variant "bwd 64-record batches" rasterize_bwd "kBatch = 192;=>kBatch = 64;"
    git show HEAD~1:brush_tpu_torch/csrc/expand.cu > runs/parent/expand.cu
    python3 scripts/torch_kernel_variants.py --old-dir runs/parent \\
        --kernels expand

Without --variant the DEFAULT_VARIANTS below run; --kernels picks the
kernels (all four by default). Inputs: the bench scene of chip_smoke.py
(1M random splats, 1024x1024, pool 2162688) through the port's own
stages: expand on the render's depth-ordered inputs ("R") and on the same
splats followed by padding rows of count 0 up to 4194304 in a pool of
4194304 ("T", the shape a training run reaches at 4M), each source also
held byte for byte to expand_plain; rasterize_fwd on the render's packed
pool and on the
same records in a pool of 4194304, the shape a training run reaches;
rasterize_bwd on the forward kernel's log T and final_idx and a seeded
image cotangent; segment_sum on the re-sorted rows of that backward, on
the same layout padded to 4194304 splats and a pool of 4194304, on
ops/cuda/testing.hand_small_pool (the CLI's sizes) with seeded rows, and
on the bench layout with every 2, 8, 16, 32 or 64 splats merged into one. Every
variant is built by nvcc (registers and shared memory printed), checked
against the repository's kernel on the same inputs (largest error of each
output row over that row's largest value, and whether every bit is equal;
two launches bit-equal) and
timed in two rounds, the second in the reverse order (A, B, B, A), each
time with CUDA events around 20 launches (the wrapper's time) and around
one replay of a CUDA graph of them (chip_smoke.device_ms, the device's);
index_add_ is timed beside segment_sum. --timeline also runs the
repository's rasterize_fwd and rasterize_bwd with %globaltimer and %smid
recorded at each block's start and end and prints when tiles start, how
long the heavy ones run and how the records spread over the SMs. --castle
also holds every rasterize_fwd source to the plain version on the four
castle views of chip_smoke.py, whose pixels saturate, at each --cell,
and says whether each source's outputs are bit-equal to the
repository's. --cell GWxGH [GWxGH ...] builds the rasterizers' inputs at
each raster cell in turn (expand and segsum run at the first). --bits says whether every
rasterize_fwd source's outputs are bit-equal to the repository's on
ops/cuda/testing.hand_tiles and hand_cells, on chip_smoke.STRIPS strips of
cell rows of the bench inputs at each cell (tile_base, each strip also
held to the frame) and on castle view 0's build_intersections(align=128)
records:

    python3 scripts/torch_kernel_variants.py --old-dir runs/parent \\
        --old-only --kernels rasterize_fwd --cell 1x1 2x2 4x2 --bits --castle
"""

import argparse
import ctypes
import functools
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from brush_tpu_torch.ops.cuda import build  # noqa: E402
from brush_tpu_torch.ops.cuda.rasterize_bwd import rasterize_bwd  # noqa: E402
from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd  # noqa: E402
from brush_tpu_torch.ops.cuda.segsum import slot_owners  # noqa: E402
from brush_tpu_torch.ops.pipeline import grad_resort  # noqa: E402
from brush_tpu_torch.render import pool_size  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "variants")
KERNELS = ("expand", "rasterize_fwd", "rasterize_bwd", "segsum")
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


def expand_bounds(blocks: int) -> str:
    """expand with its occupancy bound at `blocks` an SM."""
    return ("__launch_bounds__(kThreads, 6)\nexpand_kernel(=>"
            f"__launch_bounds__(kThreads, {blocks})\nexpand_kernel(")


# expand in two kernels: the first finds each live block's window ends and
# parks them in the block's own first slot (key and row 7), the second
# reads them there instead of searching.
EXPAND_TWO_PASS = [
    "    const int firsts[2] = {s0, live_end - 1};\n    int ends[2];\n"
    "    block_first_above(cum, n, firsts, ends);\n"
    "=>    const int ends[2] = {keys[s0], recs[(kRows - 1) * P + s0]};\n",
    "__global__ void __launch_bounds__(kThreads, 6)\nexpand_kernel("
    "=>__global__ void __launch_bounds__(kThreads)\n"
    "window_kernel(const int* __restrict__ cum, const int* __restrict__ "
    "total_p, int n, int pool, int* __restrict__ keys, "
    "int* __restrict__ recs) {\n"
    "  const size_t P = static_cast<size_t>(pool);\n"
    "  const int total = n > 0 ? min(*total_p, pool) : 0;\n"
    "  const int s0 = blockIdx.x * kSlots;\n"
    "  if (s0 >= total) return;\n"
    "  const int firsts[2] = {s0, min(s0 + kSlots, total) - 1};\n"
    "  int ends[2];\n"
    "  block_first_above(cum, n, firsts, ends);\n"
    "  if (threadIdx.x == 0) {\n"
    "    keys[s0] = ends[0];\n"
    "    recs[(kRows - 1) * P + s0] = ends[1];\n"
    "  }\n}\n\n"
    "__global__ void __launch_bounds__(kThreads, 6)\nexpand_kernel(",
    "  expand_kernel<<<blocks,=>  window_kernel<<<blocks, kThreads, 0, "
    "static_cast<cudaStream_t>(stream)>>>(cum, total, n, pool, keys, "
    "recs);\n  expand_kernel<<<blocks,",
]
# expand on a persistent grid (the card's SMs times the blocks an SM
# holds), each block searching the next slot block's window and asking L2
# for its first chunk right after it stores the current one.
EXPAND_PIPELINED = [
    "__global__ void __launch_bounds__(kThreads, 6)\nexpand_kernel("
    "=>__device__ void find_window(const int* __restrict__ cum, int n, "
    "int total, int b, int (&ends)[2]) {\n"
    "  const int s0 = b * kSlots;\n"
    "  const int firsts[2] = {s0, min(s0 + kSlots, total) - 1};\n"
    "  block_first_above(cum, n, firsts, ends);\n}\n\n"
    "__device__ void prefetch_window(const float* __restrict__ f5, "
    "const int* __restrict__ u5, const int* __restrict__ cum, size_t N, "
    "int n, const int (&ends)[2]) {\n"
    "  const int w0 = min(ends[0], n - 1);\n"
    "  const int lo = max(w0 - 1, 0);\n"
    "  const int hi = min(min(ends[1], n - 1) + 1, w0 + kChunk);\n"
    "  const int first = lo >> 5, lines = ((hi - 1) >> 5) - first + 2;\n"
    "  for (int i = threadIdx.x; i < 11 * lines; i += kThreads) {\n"
    "    const int row = i / lines;\n"
    "    const size_t idx = static_cast<size_t>(first + i % lines) << 5;\n"
    "    const void* ptr = row == 0 ? static_cast<const void*>(cum + idx)\n"
    "        : row <= 5 ? static_cast<const void*>(f5 + (row - 1) * N + idx)\n"
    "        : static_cast<const void*>(u5 + (row - 6) * N + idx);\n"
    '    asm volatile("prefetch.global.L2 [%0];" ::"l"(ptr));\n'
    "  }\n}\n\n"
    "__global__ void __launch_bounds__(kThreads, 6)\nexpand_kernel(",
    "  for (int b = blockIdx.x; b < blocks; b += gridDim.x) {"
    "=>  int ends[2] = {0, 0};\n"
    "  if (static_cast<int>(blockIdx.x) * kSlots < total)\n"
    "    find_window(cum, n, total, blockIdx.x, ends);\n"
    "  for (int b = blockIdx.x; b < blocks; b += gridDim.x) {",
    "    const int firsts[2] = {s0, live_end - 1};\n    int ends[2];\n"
    "    block_first_above(cum, n, firsts, ends);\n=>",
    "      wa += cnt;\n    }\n=>      wa += cnt;\n    }\n"
    "    const int nb = b + gridDim.x;\n"
    "    if (nb < blocks && nb * kSlots < total) {\n"
    "      find_window(cum, n, total, nb, ends);\n"
    "      prefetch_window(f5, u5, cum, N, n, ends);\n"
    "    }\n",
    "  expand_kernel<<<blocks,=>  static int grid_cap = 0;\n"
    "  if (grid_cap == 0) {\n"
    "    int dev = 0, sms = 0, per_sm = 0;\n"
    "    cudaGetDevice(&dev);\n"
    "    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
    "    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, "
    "expand_kernel, kThreads, 0);\n"
    "    grid_cap = sms * per_sm;\n"
    "  }\n"
    "  expand_kernel<<<min(blocks, grid_cap),",
]
DEFAULT_VARIANTS = [
    ("expand 1024-owner chunks, 5 blocks an SM", "expand",
     ["kChunk = kSlots / 2;=>kChunk = kSlots;", expand_bounds(5)]),
    ("expand 7 blocks an SM", "expand", [expand_bounds(7)]),
    ("expand 128 threads a block, 12 blocks an SM", "expand",
     ["kThreads = 256;=>kThreads = 128;", expand_bounds(12)]),
    ("expand 512 threads a block, 3 blocks an SM", "expand",
     ["kThreads = 256;=>kThreads = 512;", expand_bounds(3)]),
    ("expand persistent grid, 6 blocks an SM", "expand",
     ["expand_kernel<<<blocks,"
      "=>expand_kernel<<<(blocks < 792 ? blocks : 792),"]),
    ("expand streaming stores", "expand",
     ["*reinterpret_cast<int4*>(row + base) = "
      "make_int4(v[0], v[1], v[2], v[3]);"
      "=>__stcs(reinterpret_cast<int4*>(row + base), "
      "make_int4(v[0], v[1], v[2], v[3]));"]),
    ("expand window search in a pass of its own", "expand", EXPAND_TWO_PASS),
    ("expand persistent, next window searched and prefetched into L2 "
     "during the stores", "expand", EXPAND_PIPELINED),
    ("fwd 1 record a step", "rasterize_fwd", ["kUnroll = 8;=>kUnroll = 1;"]),
    ("fwd 4 records a step", "rasterize_fwd", ["kUnroll = 8;=>kUnroll = 4;"]),
    ("fwd 16 records a step", "rasterize_fwd",
     ["kUnroll = 8;=>kUnroll = 16;"]),
    ("fwd tiles in index order", "rasterize_fwd",
     ["order[kCells ? blockIdx.x / tiles_a_cell : blockIdx.x]"
      "=>(kCells ? blockIdx.x / tiles_a_cell : blockIdx.x)"]),
    ("fwd pretest off", "rasterize_fwd", ["sigma[u] <= sigma_max;=>true;"]),
    ("fwd 192-record batches", "rasterize_fwd",
     ["kBatch = 384;=>kBatch = 192;"]),
    ("fwd 512-record batches", "rasterize_fwd",
     ["kBatch = 384;=>kBatch = 512;"]),
    ("fwd log T as a sum of log1p", "rasterize_fwd", SUM_OF_LOGS),
    ("fwd without the per-warp lists (every record in every list)",
     "rasterize_fwd", ["keep = may_reach(ra4.x, ra4.y, ra4.z, ra4.w, "
                       "s_rec[k][4],=>keep = true || may_reach(ra4.x, "
                       "ra4.y, ra4.z, ra4.w, s_rec[k][4],"]),
    ("fwd registers unbounded (2 blocks an SM at cells, 3 at tiles)",
     "rasterize_fwd", ["__launch_bounds__(kThreads, kCells ? 3 : 4)"
                       "=>__launch_bounds__(kThreads)"]),
    ("bwd 4 pixels a thread, 2 records a step", "rasterize_bwd",
     ["kPix = 2;=>kPix = 4;", "kUnroll = 4;=>kUnroll = 2;"]),
    ("bwd 8 pixels a thread, 1 record a step", "rasterize_bwd",
     ["kPix = 2;=>kPix = 8;", "kUnroll = 4;=>kUnroll = 1;"]),
    ("bwd 1 record a step", "rasterize_bwd", ["kUnroll = 4;=>kUnroll = 1;"]),
    ("bwd tiles in index order", "rasterize_bwd",
     ["order[blockIdx.x / tiles_a_cell]=>(blockIdx.x / tiles_a_cell)"]),
    ("bwd without the per-warp lists (every record in every list)",
     "rasterize_bwd", ["keep = may_reach(=>keep = true || may_reach("]),
    ("bwd 128-record batches (8 blocks an SM)", "rasterize_bwd",
     ["kBatch = 192;=>kBatch = 128;"]),
    ("bwd 128-record batches, padded to 5 blocks an SM", "rasterize_bwd",
     ["kBatch = 192;=>kBatch = 128;", "=>".join(PAD)]),
    ("bwd IEEE division", "rasterize_bwd",
     ["__fdividef(1.0f, 1.0f - alpha)=>1.0f / (1.0f - alpha)"]),
    ("seg 512-slot spans", "segsum", ["kSpan = 1024;=>kSpan = 512;"]),
    ("seg zero blocks after the span blocks", "segsum",
     ["bid < 2 * both ? (bid & 1) : span_blocks < zero_blocks;"
      "=>bid >= span_blocks;",
      "bid < 2 * both ? bid >> 1 : bid - both;"
      "=>bid >= span_blocks ? bid - span_blocks : bid;"]),
    ("seg parts over 16 slots summed by a warp (block)", "segsum",
     ["kLong = 64;=>kLong = 16;"]),
    ("seg the span kernel everywhere", "segsum",
     ["kSplatMinSplats = 131072;=>kSplatMinSplats = 1 << 30;"]),
    ("seg the splat kernel everywhere", "segsum",
     ["kSplatMinSplats = 131072;=>kSplatMinSplats = 0;"]),
]
# segment_sum on the bench layout with every k consecutive splats merged
# into one: k times the slots a splat, where csrc/segsum.cu's choice of
# kernel turns.
MERGED_SPLATS = (2, 8, 16, 32, 64)
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
]
# Where each kernel's tile body ends: the timeline's last stamp.
TIMELINE_END = {
    "rasterize_fwd": [("}\n\n}  // namespace",
                       "  tl_end();\n}\n\n}  // namespace")],
    "rasterize_bwd": [("  }\n}\n\n// Cells of several tiles",
                       "  }\n  tl_end();\n}\n\n// Cells of several tiles")],
}
# expand: each slot block's SM and the %globaltimer at its start, after
# the window search, after the window is staged and at its end (a sentinel
# block: its start and end).
EXPAND_TIMELINE_SUBS = [
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long g_timeline[5 * 8192];\n"
     "__device__ __forceinline__ unsigned long long tl_now() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "  return t;\n}\n"
     "__device__ void tl_record(int b, const unsigned long long (&tl)[3]) {\n"
     "  if (threadIdx.x != 0 || b >= 8192) return;\n"
     "  unsigned sm;\n"
     '  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));\n'
     "  g_timeline[5 * b] = sm;\n"
     "  for (int i = 0; i < 3; ++i) g_timeline[5 * b + 1 + i] = tl[i];\n"
     "  g_timeline[5 * b + 4] = tl_now();\n}\n"),
    ("b += gridDim.x) {\n",
     "b += gridDim.x) {\n    unsigned long long tl[3] = {tl_now(), 0, 0};\n"),
    ("    if (s0 >= total) continue;",
     "    if (s0 >= total) { tl_record(b, tl); continue; }"),
    ("    block_first_above(cum, n, firsts, ends);\n",
     "    block_first_above(cum, n, firsts, ends);\n    tl[1] = tl_now();\n"),
    ("      __syncthreads();\n      // Slots in [done, hi_slot)",
     "      __syncthreads();\n      if (!tl[2]) tl[2] = tl_now();\n"
     "      // Slots in [done, hi_slot)"),
    ("      wa += cnt;\n    }\n",
     "      wa += cnt;\n    }\n    tl_record(b, tl);\n"),
]
TIMELINE_BWD_SUBS = [   # the backward's early return
    ("  if (last <= start) return;",
     "  if (last <= start) { tl_end(); return; }"),
]
def same_entries(kernel, text) -> bool:
    """Whether text declares each C entry that ops/cuda/build.ENTRIES
    lists for csrc/<kernel>.cu with as many arguments: a library built
    from it binds through that table."""
    for name, e in build.ENTRIES.items():
        m = re.search(rf"\b{name}\(([^)]*)\)", text)
        if e.source == kernel and (
                not m or len(m.group(1).split(",")) != len(e.args)):
            return False
    return True


def start_build(label, kernel, text, include=None):
    """Write text as a source of its own and start nvcc on it, its headers
    found first in `include` (an --old-dir's own), then in csrc/. The
    source must have the repository's C entries (same_entries): one from
    before the last change of an entry is timed at its own commit."""
    if not same_entries(kernel, text):
        raise SystemExit(f"{label}: its C entries are not those of "
                         f"ops/cuda/build.ENTRIES")
    os.makedirs(OUT, exist_ok=True)
    stem = os.path.join(OUT, "".join(c if c.isalnum() else "_" for c in label))
    with open(stem + ".cu", "w") as f:
        f.write(text)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS,
           *(["-I", include] if include else []), "-I", build.CSRC,
           "-Xptxas", "-v", "-o", stem + ".so", stem + ".cu"]
    return dict(label=label, kernel=kernel, so=stem + ".so",
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
        j["lib"] = build.bind(j["so"], j["kernel"])
    return jobs


EXACT = (0, 512)   # (passes, k_lanes) of the exact scan


def scan_kw(mode) -> dict:
    """(passes, k_lanes) as the wrappers' keywords."""
    return dict(scan_passes=mode[0] or 3, k_lanes=mode[1])


def run_fwd(job, packed, starts, ends, tiles_x, cell=(1, 1), tile_base=0,
            mode=EXACT):
    n_tiles = starts.shape[0]
    px = 256 * cell[0] * cell[1]
    img = torch.empty((n_tiles, px, 4), device="cuda")
    log_t = torch.empty((n_tiles, px), device="cuda")
    fidx = torch.empty((n_tiles, px), dtype=torch.int32, device="cuda")
    order = torch.empty_like(starts)
    build.check(job["lib"].rasterize_fwd_launch(
        packed.data_ptr(), packed.shape[1], starts.data_ptr(),
        ends.data_ptr(), n_tiles, tile_base, tiles_x, *cell, *mode,
        img.data_ptr(), log_t.data_ptr(), fidx.data_ptr(), order.data_ptr(),
        torch.cuda.current_stream().cuda_stream), job["label"])
    return img, log_t, fidx


def fwd_rows(out):
    """The forward's outputs as rows: r, g, b, a, log T, final_idx (exact
    in float32 below 2^24)."""
    img, log_t, fidx = out
    return torch.cat([img.reshape(-1, 4).T, log_t.reshape(1, -1),
                      fidx.reshape(1, -1).to(torch.float32)])


def run_bwd(job, packed, starts, ends, tiles_x, v_out, log_t, fidx,
            cell=(1, 1), mode=EXACT):
    grads = torch.zeros((9, packed.shape[1]), device="cuda")
    order = torch.empty_like(starts)
    tiles = cell[0] * cell[1]
    # Other tiles' partial rows, unread at (1, 1).
    partial = torch.empty(
        (tiles - 1) * 9 * packed.shape[1] + starts.shape[0] if tiles > 1
        else 1, device="cuda")
    build.check(job["lib"].rasterize_bwd_launch(
        packed.data_ptr(), packed.shape[1], starts.data_ptr(),
        ends.data_ptr(), starts.shape[0], 0, tiles_x, *cell, *mode,
        v_out.data_ptr(), log_t.data_ptr(), fidx.data_ptr(), grads.data_ptr(),
        order.data_ptr(), partial.data_ptr(),
        torch.cuda.current_stream().cuda_stream), job["label"])
    return grads


def run_exp(job, f5, u5, cum, total, tiles_x, num_tiles, pool):
    keys = torch.empty((pool,), dtype=torch.int32, device="cuda")
    recs = torch.empty((8, pool), dtype=torch.int32, device="cuda")
    build.check(job["lib"].expand_launch(
        f5.data_ptr(), u5.data_ptr(), cum.data_ptr(), total.data_ptr(),
        f5.shape[1], pool, tiles_x, num_tiles, keys.data_ptr(),
        recs.data_ptr(), torch.cuda.current_stream().cuda_stream),
        job["label"])
    return keys, recs


def exp_rows(out):
    """expand's outputs as rows: the key, then the 8 record rows (int32
    values, exact in float64)."""
    keys, recs = out
    return torch.cat([keys[None], recs]).to(torch.float64)


def run_seg(job, rows, offsets, cum, total):
    n = offsets.shape[0]
    out = torch.empty((9, n), device="cuda")
    # The crossing splats' partials, a span each.
    scratch = torch.empty(
        max(1, job["lib"].segsum_scratch_floats(rows.shape[1])),
        device="cuda")
    build.check(job["lib"].segsum_launch(
        rows.data_ptr(), rows.shape[1], offsets.data_ptr(), cum.data_ptr(),
        total.data_ptr(), n, out.data_ptr(), scratch.data_ptr(),
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
        for j in (jobs if rnd == 0 else jobs[::-1]):
            ms = cs.cuda_ms(lambda: run(j, *args), reps=reps)
            dev = cs.device_ms(lambda: run(j, *args), reps=reps)
            print(f"[{tag}] round {rnd}: {j['label']}: {ms:.4f} ms, device "
                  f"{dev:.4f} ms")
        if extra:
            print(f"[{tag}] round {rnd}: {extra[0]}: "
                  f"{cs.cuda_ms(extra[1], reps=reps):.4f} ms, device "
                  f"{cs.device_ms(extra[1], reps=reps):.4f} ms")


def expand_sources(jobs, exp_args, n4, pool4, timeline=False):
    """Every expand source on the bench render's arguments (R) and on the
    same splats padded with rows of count 0 to n4 in a pool of pool4 (T):
    byte-equal to expand_plain, then the sources timed in turns."""
    from brush_tpu_torch.ops.cuda.expand import expand_plain

    stamped = timeline and build_timeline("timeline expand", "expand",
                                          EXPAND_TIMELINE_SUBS)
    f5, u5, cum, total, tiles_x, num_tiles, pool = exp_args
    pad = n4 - f5.shape[1]
    t_args = (torch.cat([f5, f5.new_zeros((5, pad))], 1),
              torch.cat([u5, u5.new_zeros((5, pad))], 1),
              torch.cat([cum, cum[-1:].expand(pad)]), total, tiles_x,
              num_tiles, pool4)
    for tag, args in ((f"expand R, n {f5.shape[1]}, pool {pool}", exp_args),
                      (f"expand T, n {n4}, pool {pool4}", t_args)):
        want = exp_rows(expand_plain(*args))
        for j in jobs:
            got = exp_rows(run_exp(j, *args))
            print(f"[{tag}] {j['label']}: byte-equal to expand_plain: "
                  f"{torch.equal(got, want)}")
        compare(tag, jobs, run_exp, args, reps=20, rows=exp_rows)
        if timeline:
            expand_timeline(stamped, tag, args)


def bits_equal(tag, jobs, run, args):
    """Whether each job's outputs on args are bit-equal to the first's (the
    repository's source), printed; returns the first job's outputs."""
    ref = run(jobs[0], *args)
    same = {j["label"]: all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(run(j, *args), ref)) for j in jobs[1:]}
    print(f"[bits] {tag}: bit-equal to the repository's: {same}")
    return ref


def castle_views(fwd_jobs, cells):
    """Every rasterize_fwd job against the plain version on the four castle
    views of chip_smoke.py (a trained model: pixels saturate, the early-out
    ends tiles) at each of `cells`: the largest error, the flipped pixels
    and the largest img or T difference at one, as chip_smoke.raster_diff
    counts them, and whether the outputs are bit-equal to the
    repository's."""
    from brush_tpu_torch.datasets.ply import load_splats_from_ply
    from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd_plain
    from brush_tpu_torch.ops.rasterize_reference import camera_params

    with open(cs.CASTLE_PLY, "rb") as f:
        splats = load_splats_from_ply(f.read(), device="cuda")
    size = (cs.CASTLE_SIZE, cs.CASTLE_SIZE)
    for view, cam in enumerate(cs.castle_cameras()):
        cp = camera_params(cam, size, device="cuda")
        for cell in cells:
            pool = pool_size(splats.capacity, size)
            k = cs.kernel_inputs(splats, cp, size, pool, cell)
            while k["raw_total"] > pool:   # as eval_view grows its pool
                pool *= 2
                k = cs.kernel_inputs(splats, cp, size, pool, cell)
            tag = f"castle view {view} at cell {cell[0]}x{cell[1]}"
            plain = rasterize_fwd_plain(*k["r_args"])
            for j in fwd_jobs:
                d = cs.raster_diff(run_fwd(j, *k["r_args"]), plain)
                print(f"[{tag}] {j['label']}: max err {d['err']:.3e}, "
                      f"flipped pixels {d['flips']} (largest img or T "
                      f"difference there {d['flip_err']:.3e}), final_idx "
                      f"mismatches elsewhere {d['fidx']}")
            bits_equal(tag, fwd_jobs, run_fwd, k["r_args"])


def fwd_bits(fwd_jobs, inputs):
    """--bits: every rasterize_fwd source on the layouts of
    ops/cuda/testing.hand_tiles and hand_cells (each at its cell), on
    cs.STRIPS strips of cell rows of the bench render's inputs at each
    cell of `inputs` ({cell: r_args}; the strip's outputs also held to the
    frame's), and on castle view 0's records of build_intersections(
    align=cs.ALIGN_LANES) (the aligned path of make_pallas_rasterizer):
    whether each source's outputs are bit-equal to the repository's."""
    from brush_tpu_torch.datasets.ply import load_splats_from_ply
    from brush_tpu_torch.ops.cuda.rasterize_fwd import pack_isect_splats
    from brush_tpu_torch.ops.cuda.testing import (
        HAND_CELL_CASES, HAND_TILE_CASES, hand_cells, hand_tiles,
    )
    from brush_tpu_torch.ops.rasterize_reference import camera_params

    cuda = lambda a: torch.tensor(a, device="cuda")   # noqa: E731
    for case in HAND_TILE_CASES:
        packed, starts, ends, tiles_x = hand_tiles(case)
        bits_equal(f"hand_tiles {case}", fwd_jobs, run_fwd,
                   (cuda(packed), cuda(starts), cuda(ends), tiles_x))
    for case in HAND_CELL_CASES:
        packed, starts, ends, cells_x, cell = hand_cells(case)
        bits_equal(f"hand_cells {case} at {cell[0]}x{cell[1]}", fwd_jobs,
                   run_fwd, (cuda(packed), cuda(starts), cuda(ends),
                             cells_x, cell))
    for cell, (packed, starts, ends, cells_x, _) in inputs.items():
        frame = run_fwd(fwd_jobs[0], packed, starts, ends, cells_x, cell)
        rows = starts.shape[0] // cells_x
        for i in range(cs.STRIPS):
            a = i * rows // cs.STRIPS * cells_x
            b = (i + 1) * rows // cs.STRIPS * cells_x
            out = bits_equal(
                f"bench strip {i} of {cs.STRIPS} at {cell[0]}x{cell[1]} "
                f"(cells {a}-{b - 1})", fwd_jobs, run_fwd,
                (packed, starts[a:b], ends[a:b], cells_x, cell, a))
            if not all(torch.equal(x, f[a:b]) for x, f in zip(out, frame)):
                raise SystemExit(f"strip {i} at {cell}: not the frame's")
    with open(cs.CASTLE_PLY, "rb") as f:
        castle = load_splats_from_ply(f.read(), device="cuda")
    size = (cs.CASTLE_SIZE, cs.CASTLE_SIZE)
    cp = camera_params(cs.castle_cameras()[0], size, device="cuda")
    castle, _ = cs.pinned_castle(castle, cp)
    proj, opac, attrs = cs.view_inputs(castle, cp, size)
    isect, pool, _, _ = cs.aligned_records(proj, opac, size)
    packed = pack_isect_splats(*(t[isect.order] for t in attrs),
                               isect.isect_gid, pool, cs.ALIGN_LANES)
    bits_equal("castle view 0, aligned records", fwd_jobs, run_fwd,
               (packed, *(t.to(torch.int32) for t in (isect.starts,
                                                       isect.ends)),
                cs.CASTLE_SIZE // 16))


def build_timeline(label, kernel, subs):
    """A source with subs applied and a timeline_read entry that copies
    g_timeline out, built and loaded."""
    return finish_builds([start_build(
        label, kernel, substituted(kernel, subs)
        + '\nextern "C" int timeline_read(unsigned long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_timeline, "
        "sizeof(g_timeline));\n}\n")])[0]


def read_timeline(job, size):
    buf = np.zeros(size, np.uint64)
    fn = job["lib"].timeline_read
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(fn(buf.ctypes.data), "timeline_read")
    return buf


def expand_timeline(job, tag, args):
    """job: the repository's expand with each slot block's phases stamped
    (EXPAND_TIMELINE_SUBS). Prints how long the window search, the staging
    and the stores take, how many blocks an SM runs at once, and when the
    live and the sentinel blocks run."""
    for _ in range(3):
        run_exp(job, *args)
    torch.cuda.synchronize()
    pool, total = args[6], int(args[3][0])
    blocks = -(-pool // 1024)
    if blocks > 8192:
        raise SystemExit("the timeline buffer holds 8192 blocks")
    sm, t0, t1, t2, t3 = read_timeline(job, 5 * 8192).reshape(-1, 5)[
        :blocks].astype(np.int64).T
    live = np.arange(blocks) * 1024 < total
    first = t0.min()
    def us(v):
        return v / 1e3

    def q(v):   # p10/p50/p90
        if not len(v):
            return "-"
        return "/".join(f"{x:.2f}" for x in np.percentile(v, [10, 50, 90]))

    # Blocks of one SM in flight at each block's start.
    conc = [int(((sm == sm[i]) & (t0 <= t0[i]) & (t3 > t0[i])).sum())
            for i in range(blocks)]
    print(f"[timeline] {tag}: {blocks} blocks ({int(live.sum())} live), "
          f"span {us(t3.max() - first):.1f} us; live blocks us p10/p50/p90: "
          f"search {q(us(t1 - t0)[live])}, staging {q(us(t2 - t1)[live])}, "
          f"stores {q(us(t3 - t2)[live])}, whole {q(us(t3 - t0)[live])}; "
          f"sentinel blocks whole {q(us(t3 - t0)[~live])}; "
          f"live blocks end by {us(t3[live].max() - first):.1f} us; blocks "
          f"an SM runs at once p10/p50/p90 {q(np.array(conc))}")


def timeline(kernel, run, k_args):
    """Per-tile start, end and SM of the repository's rasterize_fwd or
    rasterize_bwd; k_args start (packed, starts, ends, ...)."""
    subs = TIMELINE_SUBS + TIMELINE_END[kernel] + (
        TIMELINE_BWD_SUBS if kernel == "rasterize_bwd" else [])
    job = build_timeline(f"timeline {kernel}", kernel, subs)
    for _ in range(3):
        run(job, *k_args)
    torch.cuda.synchronize()
    buf = read_timeline(job, 3 * 8192)
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


def saved_mode(kw) -> tuple:
    """The scan mode (passes, k_lanes) of a wrapper's saved keywords."""
    from brush_tpu_torch.ops.cuda.rasterize_fwd import scan_mode

    return scan_mode(kw.get("scan_passes", 3), kw.get("k_lanes"))


def saved_args(path, jobs):
    """Every rasterize_fwd, rasterize_bwd and segsum job on the arguments
    saved in path (chip_smoke.py --save-kernel-args): checked against the
    repository's and timed in turns, the rasterizers in the run's own scan
    mode and in the exact scan (the backward on the repository's forward
    outputs of that mode where the forward's arguments were saved),
    index_add_ beside segment_sum."""
    saved = torch.load(path, map_location="cuda")
    tag = saved["when"]
    fwd_jobs = [j for j in jobs if j["kernel"] == "rasterize_fwd"]
    bwd_jobs = [j for j in jobs if j["kernel"] == "rasterize_bwd"]
    r_args = saved.get("rasterize_fwd")
    if r_args is not None and len(r_args) > 5:   # a strip: the whole frame
        assert r_args[5] == 0, "a strip's arguments"
        r_args = r_args[:5]
    b_args = saved["rasterize_bwd"]
    if len(b_args) > 8:   # a tile_base: run_bwd takes the whole frame
        assert b_args[8] == 0, "a strip's arguments"
        b_args = b_args[:8]
    own = saved_mode(saved.get("rasterize_bwd kw", {}))
    for mode in dict.fromkeys((own, EXACT)):
        at = f"{tag}, scan {mode}"
        if r_args is not None and fwd_jobs:
            print(f"[{at}] rasterize_fwd: {r_args[1].shape[0]} cells of "
                  f"{r_args[4]}, {int(r_args[2][-1])} records, pool "
                  f"{r_args[0].shape[1]}")
            compare(f"rasterize_fwd, {at}",
                    fwd_jobs, functools.partial(run_fwd, mode=mode), r_args,
                    reps=20,
                    rows=fwd_rows)
        if not bwd_jobs:
            continue
        m_args = b_args
        if mode != own and r_args is not None:
            _, log_t, fidx = rasterize_fwd(*r_args, **scan_kw(mode))
            m_args = (*b_args[:5], log_t, fidx, b_args[7])
        print(f"[{at}] rasterize_bwd: {m_args[1].shape[0]} cells of "
              f"{m_args[7]}, {int(m_args[2][-1])} records, pool "
              f"{m_args[0].shape[1]}")
        compare(f"rasterize_bwd, {at}",
                bwd_jobs, functools.partial(run_bwd, mode=mode), m_args,
                reps=10)
    seg_jobs = [j for j in jobs if j["kernel"] == "segsum"]
    if seg_jobs:
        rows, offsets, cum, total = s_args = saved["segment_sum"]
        ids = slot_owners(cum, total, rows.shape[1])
        live = rows[:, :ids.shape[0]].contiguous()
        n = offsets.shape[0]
        print(f"[{tag}] segment_sum: n {n}, pool {rows.shape[1]}, live "
              f"slots {int(total[0])}, splats with slots "
              f"{int(((cum - offsets) > 0).sum())}")
        compare(f"segment_sum, {tag}", seg_jobs, run_seg, s_args, reps=20,
                extra=("index_add_", lambda: torch.zeros(
                    (9, n), device="cuda").index_add_(1, ids, live)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-dir", nargs="+", default=[], help="directories "
                    "holding other sources of these kernels (<kernel>.cu), "
                    "timed beside them")
    ap.add_argument("--variant", nargs="+", action="append", default=[],
                    metavar="ARG", help="LABEL KERNEL 'OLD=>NEW' ...")
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--castle", action="store_true", help="also hold every "
                    "rasterize_fwd source to the plain version on the four "
                    "castle views")
    ap.add_argument("--old-only", action="store_true", help="without "
                    "--variant, run only the repository's sources and "
                    "--old-dir's (no default variants)")
    ap.add_argument("--cell", nargs="+", default=["1x1"], help="raster "
                    "cells GWxGH of the rasterizers' inputs, each timed in "
                    "turn; expand and segsum take the first")
    ap.add_argument("--bits", action="store_true", help="also say whether "
                    "every rasterize_fwd source's outputs are bit-equal to "
                    "the repository's on the hand-made tile and cell "
                    "layouts, on strips of the bench inputs at each cell "
                    "and on the castle's aligned records")
    ap.add_argument("--args-file", nargs="+", default=[], help="files of "
                    "rasterize_bwd and segment_sum arguments that "
                    "chip_smoke.py --save-kernel-args wrote (a training "
                    "run's last step: T, T at a cell, the CLI's C); every "
                    "rasterize_bwd and segsum source is also timed on them")
    ap.add_argument("--scan", nargs="+", default=["3"], metavar="MODE",
                    help="the rasterizers' scan modes on the bench inputs, "
                    "each timed in turn: 3 the exact scan, P:K the "
                    "truncated scan of P bfloat16 parts over batches of K "
                    "slots; --bits and --castle take the exact scan")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(KERNELS), help="the kernels to build and "
                    "time (default: all)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    cells = [tuple(int(v) for v in c.lower().split("x")) for c in opts.cell]
    modes = [EXACT if m == "3" else tuple(int(v) for v in m.split(":"))
             for m in opts.scan]
    if cells != [(1, 1)] and opts.timeline:
        raise SystemExit("--timeline times tiles: run it at --cell 1x1")
    variants = [(v[0], v[1], v[2:]) for v in opts.variant] or (
        [] if opts.old_only else DEFAULT_VARIANTS)
    variants = [v for v in variants if v[1] in opts.kernels]
    pending = [start_build(f"repository's {k}", k, substituted(k, []))
               for k in opts.kernels]
    for k in opts.kernels:
        for old in opts.old_dir:
            path = os.path.join(old, f"{k}.cu")
            if os.path.exists(path):
                with open(path) as f:
                    pending.append(start_build(f"{old}'s {k}", k, f.read(),
                                               include=old))
    for label, kernel, subs in variants:
        if kernel not in KERNELS:
            raise SystemExit(f"unknown kernel {kernel!r}: {KERNELS}")
        pairs = [tuple(s.split("=>", 1)) for s in subs]
        pending.append(start_build(label, kernel, substituted(kernel, pairs)))
    jobs = finish_builds(pending)
    print(f"[device] {cs.smi_line()}")

    for path in opts.args_file:
        saved_args(path, jobs)
    if opts.args_file and set(opts.kernels) <= {"rasterize_bwd", "segsum"}:
        return

    splats, cp, size = cs.make_scene(cs.BENCH, "cuda")
    pool = pool_size(splats.capacity, size, cs.BENCH["pool"],
                     cs.BENCH["block"])
    n4 = pool4 = 1 << 22
    fwd_jobs = [j for j in jobs if j["kernel"] == "rasterize_fwd"]
    bwd_jobs = [j for j in jobs if j["kernel"] == "rasterize_bwd"]
    inputs = {}
    for cell in cells:
        k = cs.kernel_inputs(splats, cp, size, pool, cell)
        packed, starts, ends, tiles_x, _ = inputs[cell] = k["r_args"]
        print(f"[inputs] bench render at cell {cell}: {starts.shape[0]} "
              f"cells, {int(k['exp_args'][3][0])} records")
        at = f" at cell {cell[0]}x{cell[1]}"
        exp_jobs = [j for j in jobs if j["kernel"] == "expand"]
        if exp_jobs and cell == cells[0]:
            expand_sources(exp_jobs, k["exp_args"], n4, pool4, opts.timeline)
        packed4 = torch.zeros((8, pool4), dtype=torch.int32, device="cuda")
        packed4[:, :packed.shape[1]] = packed
        gen = torch.Generator(device="cuda").manual_seed(1)
        v_out = torch.randn((starts.shape[0], 256 * cell[0] * cell[1], 4),
                            generator=gen, device="cuda")
        for mode in modes:
            sat = at + ("" if mode == EXACT else f", scan {mode}")
            run_f = functools.partial(run_fwd, mode=mode)
            for tag, f_args in (
                    ("rasterize_fwd, bench render inputs" + sat, k["r_args"]),
                    (f"rasterize_fwd, the same records in a pool of {pool4}"
                     + sat, (packed4, starts, ends, tiles_x, cell))):
                if fwd_jobs:
                    compare(tag, fwd_jobs, run_f, f_args, reps=20,
                            rows=fwd_rows)
            _, log_t, fidx = rasterize_fwd(*k["r_args"], **scan_kw(mode))
            b_args = (packed, starts, ends, tiles_x, v_out, log_t, fidx, cell)
            if bwd_jobs:
                compare("rasterize_bwd, bench render inputs" + sat,
                        bwd_jobs, functools.partial(run_bwd, mode=mode),
                        b_args, reps=10)
            if cell == cells[0] and mode == modes[0]:
                first = dict(k=k, b_args=b_args, gen=gen)
        del packed4
        if opts.timeline:
            timeline("rasterize_fwd", run_fwd, k["r_args"][:4])
            _, log_t, fidx = rasterize_fwd(*k["r_args"])
            timeline("rasterize_bwd", run_bwd, (packed, starts, ends, tiles_x,
                                                v_out, log_t, fidx, cell))
    if opts.bits and fwd_jobs:
        fwd_bits(fwd_jobs, inputs)
    if opts.castle:
        castle_views(fwd_jobs, cells)

    k, b_args, gen = first["k"], first["b_args"], first["gen"]
    packed = b_args[0]
    total, cum, offsets = k["exp_args"][3], k["exp_args"][2], k["offsets"]
    rows = grad_resort(rasterize_bwd(*b_args), packed[7], total,
                       pack_grad_sort=False)
    rows4 = torch.zeros((9, pool4), device="cuda")
    rows4[:, :rows.shape[1]] = rows
    tail = total.expand(n4 - offsets.shape[0])   # padding splats: no slot
    seg_jobs = [j for j in jobs if j["kernel"] == "segsum"]
    if not seg_jobs:
        return
    from brush_tpu_torch.ops.cuda.testing import (
        HAND_SMALL_POOL, hand_small_pool,
    )

    small = tuple(torch.tensor(a, device="cuda") for a in hand_small_pool())
    rows_small = torch.randn((9, HAND_SMALL_POOL), device="cuda",
                             generator=gen)
    for tag, s_args in (
            ("segment_sum, n 1048576, pool 2162688",
             (rows, offsets, cum, total)),
            ("segment_sum, n 4194304, pool 4194304",
             (rows4, torch.cat([offsets, tail]), torch.cat([cum, tail]),
              total)),
            (f"segment_sum, the CLI's sizes (hand_small_pool: n 8192, pool "
             f"{HAND_SMALL_POOL})", (rows_small, *small)),
            *((f"segment_sum, the bench layout with every {k} splats "
               f"merged into one (n {offsets.shape[0] // k}, pool "
               f"{rows.shape[1]})",
               (rows, offsets[::k].contiguous(),
                cum[k - 1::k].contiguous(), total))
              for k in MERGED_SPLATS)):
        ids = slot_owners(s_args[2], s_args[3], s_args[0].shape[1])
        live = s_args[0][:, :ids.shape[0]].contiguous()
        n = s_args[1].shape[0]
        compare(tag, seg_jobs, run_seg, s_args, reps=20, extra=(
            "index_add_", lambda: torch.zeros((9, n), device="cuda")
            .index_add_(1, ids, live)))


if __name__ == "__main__":
    main()
