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
     render inputs: the tile pretest's five outputs equal to its plain
     twin's in every bit (and a second launch bit-equal, wherever it is
     checked below: also at CHECK_CELLS, on every castle view and cell,
     the strip phase's frames, the bench render at CELL and every
     training run's kept arguments); expand byte-equal (and a second
     launch bit-equal, wherever it is checked below); rasterize_fwd img
     and log_t within
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
     segment_sum also on layouts made by hand, equal to the plain version
     in every bit on rows of multiples of 1/16 (a segment of 100,003
     slots, runs of empty splats; the CLI's sizes, 8192 splats and about
     120,000 live slots, spans inside one splat and spans holding dozens;
     `total` cutting a segment and `total` 0); rasterize_fwd (the check
     above) and rasterize_bwd also on the
     raster-cell layouts of ops/cuda/testing.hand_cells (records reaching
     one tile of a cell, all four, a single corner pixel; a deep cell; sigma
     at the pretest's edge of a warp's patch; hyperbolic conics; edge cells
     at (4, 2)); expand
     also on the splat layouts of ops/cuda/testing.hand_expand (a bbox
     splat over three kernel blocks, owners of count 0 inside the live
     range and in a run wider than the kernel's owner window, full 64-bit
     masks and rank 63, ranks in the high word, `total` == pool, `total`
     0, n 0, owners starting on block starts, pool % 4 != 0); the tile
     pretest at the benchmark's bicycle size (pretest_phase: the
     bicycle-5m scene's 5,242,880 splats in each of its 8 views, at
     (1, 1) and CELL, bit-equal to its plain twin, timed on two views);
     the SH colour's forward and backward kernels (sh_phase: the bicycle
     draw's 5,242,880 rows and 8,388,608 drawn rows, 16 coefficients)
     bit-equal to their plain twins at the kernels' directions, two
     launches bit-equal, timed against their bound; the render path
     launches the forward once, a training step each once; the
     projection's forward and backward kernels (projection_phase: the
     bicycle draw's 5,242,880 rows and 8,388,608 drawn rows, 43.75 %
     active) bit-equal to project_splats(normalize_quats(quats)) and to
     project_bwd_plain, two launches bit-equal, the autograd Function's
     gradients the kernel's, timed against their bound and the plain
     chain's forward and backward under autograd; held so on every kept
     argument set below (check_projection), launched as the SH pair;
  3. the render path at full width: render_splats(needs_grad=False) of the
     bench scene (1M random splats, SH degree 1, 1024x1024, pool 2162688),
     with the launch counters reset just before and read just after and
     the SH forward held to its twin on that call's arguments; then
     the median of 10 CUDA-event-timed renders and the forward kernels'
     times at these inputs (each kernel timed twice, here and in phases 6
     and 8: its wrapper by cuda_ms and the device by device_ms, the calls
     replayed from a CUDA graph); then the same at raster cell CELL (2, 2),
     its
     kernels held to their plain versions on its inputs, its records
     beside (1, 1)'s and its image held to (1, 1)'s with rasterize_fwd's
     tolerance (the differing pixels counted); then the strip phase: the
     bench render's inputs cut into STRIPS strips of cell rows, as STRIPS
     ranks of the sharded step cut them, at (1, 1) and at CELL: each
     strip's pipeline through the kernels on its own restricted inputs and
     pool, expand byte-equal and both rasterizers held to their plain
     versions on the strip's
     arguments (tolerances as above, repeats bit-equal) and timed beside
     the whole frame's; the strips' img and log T equal to the frame's in
     every bit, the per-splat gradients summed over the strips within
     1e-5 of each row's largest value of the frame's, and one strip at
     tile_base 0 bit-equal to the frame (restriction, binning, kernels);
  4. a real model: serve docs/castle_r5_30k.ply through eval_stats at
     800x800 on four cameras of its training orbit, against the same
     views rendered by the port on the CPU (the plain versions), one
     launch of each forward kernel a view, the last view's SH forward held
     to its twin on its arguments;
     rasterize_fwd's check on each of those views and the backward
     kernels' on one (real opacities: saturating pixels, the early-out);
     at each of CHECK_CELLS (800x800 is 50x50 tiles, which (4, 2) does
     not divide) rasterize_fwd's check on view 0 (and at CELL the backward
     kernels'), then eval_stats, launches counted, each image held to the
     (1, 1) one with CELL_IMAGE_TOL (see there why not equal);
  5. the main path of training at full width: SplatTrainer on the bench
     scene against a black ground truth (bench.py:210-231), 6 steps with
     warmup 1 and refine every 3, so refine runs at iterations 1 (through
     the pre-grow path, capacity 1M -> 2M) and 4 (2M -> 4M); all nine
     kernel wrappers' counters (the five, the SH pair and the projection
     pair) reset just before and read just after (the tile pretest and
     each SH and projection kernel once a step); every step's CUDA-event
     time. The main path's calls to the nine wrappers keep
     their arguments on the first step at each capacity; then the train
     step metric: 8 warm steps at the capacity the run ends at; then all
     of it again with SplatTrainer(raster_cell=CELL); between the two,
     the same 6-step run with parallel.ShardedTrainer at world size 1
     over NCCL (its kernels counted), whose every loss and final parameter
     must equal SplatTrainer's in every bit, and its 8 warm steps at 4M;
  6. each kernel against its plain version (tolerances as in phase 2) on
     the arguments each training run gave it at the capacity it ends at,
     the real loss cotangent included, in the run's own log-T scan
     (scan_passes=2, k_lanes 128: the reference's default); the kernels'
     times, bounds and errors in the result come from these arguments;
     then the scan phase: both rasterizers on the same arguments in the
     exact scan, at k_lanes 512 and on a strip of 512 cells from cell
     1029, held to their plain versions (log T as T, final_idx flips
     counted with the others) and timed in turns, at (1, 1) and at CELL,
     and at scan_passes=2 on every hand layout and scan_edge (its named
     pixels one record from the exact scan's); the kernels line's "scan"
     entries; each instantiation's registers, local (spill) bytes and
     blocks an SM ("[scan attrs]"); truncated against exact device ms,
     in turns, at T, 2x2 T and the strip, and in phases 12 and 13 at B
     and Q ("[scan ratio]"). Wherever two layouts of the same records are held
     bit-equal (strips against the frame, phase 3) both take the exact
     scan: the truncated scan's batches follow each pool's ranges;
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
     nine wrappers' counters reset just before and read just after: one
     launch of each a step and of the forward five (the tile pretest,
     expand, rasterize_fwd, sh_color_fwd, project_fwd) one an eval render
     (pool-growth retries counted); the kernels' arguments kept on the
     first step and the first after each refine, and each kernel held to
     its plain version on the first and the last of them (tolerances as
     in phase 2); `train --cell 2x2` for CLI_CELL_ITERS steps, every render
     at the cell, launches counted alike, its eval PSNR at 200 within
     CLI_CELL_PSNR_TOL dB of the (1, 1) run's; `train --shard` (a world
     of one process over NCCL) for CLI_CELL_ITERS steps, its every logged
     loss equal to the (1, 1) run's; finite losses,
     eval PSNR at 600 above 200; `eval --ply` and `eval --ckpt` print the
     run's final PSNR digit for digit; `--resume` from 400 runs 401..419;
     the trained castle saved as a checkpoint at step 29800 and resumed
     for 200 steps (the step time at a model's real size; the SH pair's
     last calls held to their twins at its 90,977 rows); `render` writes
     a non-blank PNG; a 24-view COLMAP castle (RGB on black, the castle's
     90,977 means as points3D, native parser == Python parser) trains 100
     timed steps; `train2d` at 256x256 lowers its loss, and so does
     `train2d --shard`;
  9. "viewer", the served path on the same datasets (viewer_phase): the
     castle served over HTTP by brush_tpu_torch.viewer, every frame equal
     to the in-process render and launching the tile pretest, expand,
     rasterize_fwd and the SH forward once;
     the /api/frame latency at 800x800 and its split (render, copy +
     composite, PNG encode, the rest), idle and while a TrainWorker trains
     the NeRF castle through the API (pause, eval, export, resume, load of
     the COLMAP twin); `cli view` in a subprocess; `cli train --rerun`
     with a recording stub SDK; profiler.trace around a bench render
     (profiler_check: run after the "quality" phase, the last timed one,
     since a trace slows the process's later launches);
 10. "xla", the XLA backend on the card (xla_phase): the castle on view 0
     with gradients and the bench render through render_splats(
     backend="xla") held to the record pipeline's kernels (images within
     assert_close_quantized's defaults, gradients within the castle
     test's render-grad rule), no kernel launched on the XLA path but
     the tile pretest once a render or step (its binning) and the SH pair
     (its view colours, the same kernels as the pipeline's), both
     paths' times and peak memory; ShardedTrainer(backend="xla") at world
     size 1 over NCCL on the castle's views, its first loss within 1e-3
     relative of the pipeline trainer's;
 11. "aligned", the rasterizers on build_intersections(align=128)'s
     records through make_pallas_rasterizer (aligned_phase): the castle
     on view 0 with gradients held to the XLA rasterizer on the same
     records (image by close_image, gradients by the castle rule), one
     launch each of rasterize_fwd, rasterize_bwd and segment_sum (the
     backward's per-splat sums) and nothing else, a second backward pass
     bit-equal to the first, both rasterizers against their plain
     versions on these records; the bench
     render's aligned records equal to the pipeline's tile by tile, its
     image held to phase 3's, rasterize_fwd timed on both pools in turns;
     the k-NN of the initial scales on the bench's 1M points, and its
     native and card routes at 262,144 points within 1e-6;
 12. "scale", the bicycle-scale step of scripts/torch_probe_5m.py
     (scale_phase): 5,242,880 splats, SH degree 3, 1248x1248, pool
     10,485,760; one probe step (render with gradients, L1, backward,
     Adam) with the counters reset just before and read just after: one
     launch of each kernel, no record dropped, finite loss and parameters;
     all nine kernels against their plain versions on that step's own
     arguments (phase 2's tolerances, repeats bit-equal), timed (wrapper
     and device), with bounds (both rasterizers' reach bounds too) and
     index_add_ beside segment_sum; the median of 8 probe steps on fixed
     parameters and its peak memory; SCALE_TRAIN_STEPS SplatTrainer steps
     (default config) with the pool set to the probe's before the first:
     one launch of each kernel a step, no drop, finite losses and
     parameters, the median step and its peak memory; one [scale] line;
 13. "quality", the port against independent ground truth
     (quality_phase): the ray-traced castle of
     brush_tpu_torch/datasets/raytrace.py (scripts/raytrace_scene.py's
     scene, tracer and NeRF layout: 100 train and 16 val views, 800x800
     RGBA PNG) traced on the card, val views 0 and 1 traced again on the
     card and on the CPU (hit masks equal, RGBA within 1e-6; the dataset's
     u8 pixels at most 1 from the CPU trace's in at most 1e-5 of the
     pixels); the 16-view harvests of docs/castle_r5_30k.ply,
     castle_r5fixed.ply and castle_r5pgs.ply (scripts/torch_harvest.py's
     harvest: eval_view at block 512, no record dropped after pool growth)
     within 0.01 dB and 0.0002 SSIM of the JAX package's 32.404 / 0.9756,
     32.390 / 0.9760, 32.414 / 0.9762; `cli train` to docs/RESULTS.md's
     command (--sh-degree 3 --init-count 32768 --block-size 512) for 3,200
     steps, past the opacity reset at 3001 and the prune at 3101, all 16
     val views evaluated at 1500, 3000 and 3200: finite logged losses,
     finite parameters at 3000 and 3200, no record dropped at any eval,
     eval PSNR at 1500 and 3000 no lower than the JAX run's 30.86 and
     31.28 less 1.5 dB, one launch of each kernel a step and of the
     forward five one an eval render; the nine kernels held to their plain
     versions (phase 2's tolerances, repeats bit-equal) on the arguments
     of step 3002, the first after the reset, and timed there; one
     [quality] line;
 14. print {"kernels": [...]}: launches from the "cli" train run, the other
     fields from phase 6's (1, 1) arguments, under "cli" the same fields
     on the cli run's last arguments, and for the two rasterizers under
     "cell" those of the training at CELL, under "strip" the strip
     phase's per strip (launches: the sharded training's) and under
     "aligned" the aligned phase's, and for expand and rasterize_fwd
     under "viewer" the viewer's frames' launches and under "render"
     phase 3's times at (1, 1) and CELL (also for the tile pretest, whose
     "bicycle" holds pretest_phase's; the SH pair's "bicycle" holds
     sh_phase's); beside each "ms" (the wrapper's,
     what a host-bound step pays) its "device_ms" (the median of
     DEVICE_REPLAYS replays of a CUDA graph of the calls), and beside
     segment_sum's "library_ms" (index_add_) its "library_device_ms",
     and beside rasterize_fwd's "bound_ms" at the bench's render and
     training inputs its "reach_bound_ms" (the same formula over the pairs
     whose record may reach the pixel's warp patch, csrc/reach.cuh's rule:
     the work left to a kernel that culls by it), and beside
     rasterize_bwd's at the training inputs its "reach_bound_ms" (the
     pairs its per-warp lists keep: the 16x4 patch's largest final_idx
     and that rule); under "scale" the same fields on the "scale" phase's
     probe step, launches its; under "quality" the same fields on the
     quality phase's step 3002, launches its cli train run's;
     the nvidia-smi line;
     and last {"ok": true, "device": {...}}.
The script imports nothing of JAX or of the JAX package. With
--save-kernel-args DIR it also saves the backward kernels' arguments of
phase 6's and the cli run's last step into DIR, for
scripts/torch_kernel_variants.py --args-file.
"""

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
# The truncated log-T scan (scan_passes < 3, csrc/scan.cuh) adds, for every
# active pair, SCAN_PART_OPS a bfloat16 part of each scanned term (the
# rounding bias, the add, the mask, the subtraction and the sum), and in
# rasterize_fwd a log1p, an exp and three adds (the running sums and
# T's argument), in rasterize_bwd two scanned terms and three adds.
SCAN_PART_OPS = 5
SCAN_FWD_OPS = 5
SCAN_BWD_OPS = 3
EXACT = dict(scan_passes=3)   # the rasterizers' exact scan, by name
SCAN_LANES = (128, 512)   # the scan phase's k_lanes at (1, 1)
SCAN_STRIP_BASE = 1029    # the scan phase's strip: its first cell,
SCAN_STRIP_CELLS = 512    # and its cells (of the bench's 4096)
# The tile pretest's bytes a splat: 41 read (xy, conic, opacity, the tile
# bbox, visible) and 33 written (counts, mask_lo, mask_hi, pc_pack, small).
PRETEST_BYTES = 41 + 33
PRETEST_SEED = 3200000321   # pretest_phase's draw of the bicycle scene
PRETEST_TIMED_VIEWS = 2     # and its views that are timed
SH_SEED = 3200000323        # sh_phase's draw of the bicycle scene
SH_ROWS = (5_242_880, 8_388_608)   # B, and the densify cell's capacity
SH_BYTES = 12 + 192 + 12    # a splat each way at K = 16 (csrc/sh.cu)
PROJ_SEED = 3200000325      # projection_phase's draw of the bicycle scene
PROJ_ROWS = SH_ROWS
PROJ_DENSIFY_LIVE = 0.4375  # the 8.39M rows' live share (bicycle-densify)
BWD_RTOL = 1e-4   # rasterize_bwd vs plain, per row, relative to the row max
SEG_RTOL = 1e-5   # segment_sum vs plain, likewise
TRAIN_STEPS = 6
TRAIN_BLOCK = 32     # raster_block_size of every bench training run
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
CLI_CELL_ITERS = 220   # `cli train --cell 2x2` and `--shard`: eval at 200
# The strip phase: the bench frame cut into this many strips of cell rows,
# as as many ranks of the sharded step cut it.
STRIPS = 4
CLI_CELL_PSNR_TOL = 0.5   # dB from the (1, 1) run's eval at 200
# The viewer phase: timed /api/frame requests after warm ones; the
# TrainWorker's iterations before its rate is read; `cli train --rerun`.
VIEW_FRAMES, VIEW_WARM = 30, 3
VIEW_TRAIN_ITER = 150
VIEW_RERUN_ITERS = 12
PAGE_SIZE = (512, 384)   # page.html's default frame

# The "xla" phase: the XLA backend (exact binning, the tiled rasterizer,
# plain PyTorch) on the card, held to the record pipeline's kernels.
XLA_BLOCK = 32         # render_splats' default block_size: rounds of 32
XLA_TIMED = 3          # CUDA-event-timed bench renders of each path
XLA_SHARD_STEPS = 6    # ShardedTrainer(backend="xla") steps on the castle
# The "aligned" phase: build_intersections' records aligned to this many
# lanes (brush_tpu's kernel tests' k_lanes) through make_pallas_rasterizer;
# the k-NN's two routes compared at this many points.
ALIGN_LANES = 128
KNN_BOTH_N = 262144
# The "scale" phase: scripts/torch_probe_5m.py's defaults (5.0 M splats,
# 1248x1248) and SplatTrainer steps at its pool.
PROBE_SCRIPT = os.path.join(ROOT, "scripts", "torch_probe_5m.py")
SCALE_MILLIONS, SCALE_SIZE = 5.0, 1248
SCALE_TRAIN_STEPS = 5
# The "quality" phase: the ray-traced castle (brush_tpu_torch/datasets/
# raytrace.py, scripts/raytrace_scene.py's scene) in the NeRF layout at its
# published size; its val views held to the tracer on the CPU; the 16-view
# harvests of the three models the JAX package trained on it (docs/), each
# against the harvest the JAX package recorded (VERDICT.md:14-16 and
# docs/RESULTS.md's round-5 appendix); `cli train` to docs/RESULTS.md's
# command past the first opacity reset (TrainConfig: a refine every 100
# steps from 501, the 30th, at 3001, resets every opacity; the next, at
# 3101, prunes), its evals held to the JAX run r5_castle_fixed's
# (docs/RESULTS.md:30-31) less QUALITY_GAP_DB.
QUALITY_TRAIN, QUALITY_VAL, QUALITY_SIZE = 100, 16, 800
QUALITY_CHECK_VIEWS = (0, 1)   # val views traced again on the CPU
QUALITY_U8_FRAC = 1e-5         # pixels whose u8 values may differ, by 1
QUALITY_ANCHORS = {"castle_r5_30k.ply": (32.404, 0.9756),
                   "castle_r5fixed.ply": (32.390, 0.9760),
                   "castle_r5pgs.ply": (32.414, 0.9762)}
QUALITY_PSNR_TOL, QUALITY_SSIM_TOL = 0.01, 0.0002
QUALITY_ITERS, QUALITY_EVAL_EVERY = 3200, 1500
QUALITY_RESET_STEP = 3001
QUALITY_JAX_PSNR = {1500: 30.86, 3000: 31.28}
QUALITY_GAP_DB = 1.5
# The same run's eval PSNR with the exact scan (scan_passes=3), measured
# on an NVIDIA H100 80GB HBM3 at 700 W before the port took the
# reference's default (PERF.md §6): printed beside this run's, not a gate.
QUALITY_EXACT_PSNR = {1500: 32.862, 3000: 33.767}
HARVEST_SCRIPT = os.path.join(ROOT, "scripts", "torch_harvest.py")
CASTLE_NAMES = ("means", "log_scales", "quats", "sh_coeffs", "raw_opacity")
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
    """Mean milliseconds of fn() over reps runs between two CUDA events:
    the wrapper's time, which is the host's where a call's host work
    (checks, allocations, the ctypes call) outlasts its kernels."""
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


DEVICE_REPLAYS = 7   # device_ms: replays of the graph, the median taken


def device_ms(fn, reps: int, warm: int = 1) -> float:
    """Device milliseconds of one fn() call: reps calls captured in one
    CUDA graph, the graph replayed DEVICE_REPLAYS times, each between two
    CUDA events, and the median of those replays over reps. The kernels' own
    time (with the wrapper's allocations and memsets), none of the host's.
    fn must not wait for the device: every kernel wrapper and index_add_
    qualify (tests/test_torch_cuda.py replays each)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(DEVICE_REPLAYS):
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    del graph
    return statistics.median(times)


_scenes: dict = {}
# --save-kernel-args DIR: where train_kernels saves each run's last
# rasterize_bwd and segment_sum arguments (None: nowhere).
SAVE_ARGS_DIR = None


def make_scene(cfg, device):
    """A scene's splats (seed 0), camera parameters and size. The splats
    of a scene are drawn once, timed (from_random: the draw, the 3-NN
    scales by splats.knn_route()'s route, the upload), and kept on the
    host; each call gets its own copy on the device."""
    import torch
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.splats import from_random, knn_route

    key = (cfg["n"], cfg["lo"], cfg["hi"])
    if key not in _scenes:
        t0 = time.perf_counter()
        drawn = from_random(
            np.random.default_rng(0), [cfg["lo"]] * 3, [cfg["hi"]] * 3,
            count=cfg["n"], sh_degree=1, capacity=cfg["n"], device=device)
        torch.cuda.synchronize()
        print(f"[scene] from_random of {cfg['n']} splats on the card: "
              f"{time.perf_counter() - t0:.3f} s (k-NN route "
              f"{knn_route()})")
        _scenes[key] = drawn.replace(
            **{k: v.cpu() for k, v in drawn.params().items()})
    base = _scenes[key]
    splats = base.replace(
        **{k: v.to(device, copy=True) for k, v in base.params().items()})
    cam = Camera(position=[0, 0, cfg["z"]], rotation=[1, 0, 0, 0],
                 fov_x=np.pi / 2, fov_y=np.pi / 2)
    size = (cfg["size"], cfg["size"])
    return splats, camera_params(cam, size, device=device), size


def kernel_inputs(splats, cp, size, pool, cell=(1, 1)):
    """The main path's stages up to each kernel at raster cell `cell`, the
    kernels on the card: the tile pretest's arguments, the expand
    arguments, the rasterize_fwd arguments (packed, starts, ends, cells_x,
    cell) and the depth order's offsets."""
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
    return dict(pt_args=pretest_args(rec, cell), exp_args=exp_args,
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


def pretest_args(rec, cell):
    """The tile pretest wrapper's arguments in record_inputs' result rec
    (ops/binning.precompute_tile_masks' call): xy, conic, opacity, the
    tile bbox, visible and the cell."""
    p = rec.proj
    return (p.xy.detach(), p.conic.detach(), rec.attrs9[8].detach(),
            p.tile_min, p.tile_max, p.visible, tuple(cell))


def check_pretest(p_args, label):
    """The tile pretest kernel against its plain twin on the wrapper's
    arguments p_args: all five outputs equal in every bit (dtype too), and
    two launches bit-equal. Returns the twin's ms."""
    import torch
    from brush_tpu_torch.ops.binning import precompute_tile_masks_plain
    from brush_tpu_torch.ops.cuda.tile_pretest import tile_pretest
    from brush_tpu_torch.ops.projection import Projection

    got = tile_pretest(*p_args)
    again = tile_pretest(*p_args)
    xy, conic, opac, tile_min, tile_max, visible, cell = p_args
    zeros = torch.zeros_like(opac)
    proj = Projection(xy, zeros, conic, zeros.int(), tile_min, tile_max,
                      visible)
    want, plain_ms = timed(
        lambda: precompute_tile_masks_plain(proj, opac, cell))
    for name, g, a, w in zip(want._fields, got, again, want):
        if not torch.equal(g, a):
            raise AssertionError(f"[{label}] tile_pretest: two launches on "
                                 f"the same inputs differ in {name}")
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(
                f"[{label}] tile_pretest: {name} differs from the plain "
                f"twin's at {int((g != w).sum())} of {g.shape[0]} splats")
    return plain_ms


def pretest_bound(p_args):
    """The tile pretest's least time (ms) and what bounds it: PRETEST_BYTES
    a splat at the memory rate (its few tests a splat are far below the
    float32 rate)."""
    return _bound(PRETEST_BYTES * p_args[2].shape[0], 0)


def pretest_phase(smi: str) -> dict:
    """The tile pretest at the benchmark's bicycle size: the bicycle-5m
    configuration's 5,242,880 splats (SH 3) drawn by
    benchmark/scenes/uniform.py from PRETEST_SEED and projected into each
    of its 1237x822 views; at (1, 1) and CELL the kernel held bit-equal to
    its plain twin (check_pretest); on PRETEST_TIMED_VIEWS the wrapper's
    and the device's ms, the twin's and the bound. Returns {"view v gwxgh":
    those fields}."""
    import torch
    from benchmark.scenes import uniform
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.ops.cuda.tile_pretest import tile_pretest
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.render import detached, project_inputs

    t0 = time.perf_counter()
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "bicycle-5m.json")) as f:
        sc = json.load(f)["scene"]
    p = uniform.params(sc, PRETEST_SEED, "cuda")
    size = (sc["width"], sc["height"])
    poses = uniform.ring_poses(sc["views"], sc["distance"],
                               np.radians(sc["fov_x_deg"]), size)
    out, records = {}, []
    for v, pose in enumerate(poses):
        cam = camera_params(Camera(**pose), size, device="cuda")
        with torch.no_grad():
            proj, _, opac, _ = project_inputs(
                p["means"], p["log_scales"], p["quats"], p["sh_coeffs"],
                p["raw_opacity"], cam, size)
        proj = detached(proj)
        for cell in ((1, 1), CELL):
            args = (proj.xy, proj.conic, opac, proj.tile_min, proj.tile_max,
                    proj.visible, cell)
            label = f"view {v} {cell[0]}x{cell[1]}"
            plain_ms = check_pretest(args, f"pretest {label}")
            records.append(int(tile_pretest(*args)[0].sum()))
            if v < PRETEST_TIMED_VIEWS:
                fn = lambda: tile_pretest(*args)   # noqa: E731
                bound = pretest_bound(args)
                out[label] = {"ms": cuda_ms(fn, reps=50, warm=3),
                              "device_ms": device_ms(fn, reps=50, warm=3),
                              "plain_ms": plain_ms, "bound_ms": bound[0],
                              "bound_by": bound[1]}
    n = p["means"].shape[0]
    del p, proj, opac
    torch.cuda.empty_cache()
    print(f"[pretest] bicycle-5m draw (seed {PRETEST_SEED}), {n} splats, "
          f"{len(poses)} views {size[0]}x{size[1]} at (1, 1) and {CELL}: "
          f"bit-equal to the plain twin in every view; records {records}; "
          + "; ".join(f"{k} {t['ms']:.4f} ms, device {t['device_ms']:.4f} "
                      f"(plain {t['plain_ms']:.3f}, bound "
                      f"{t['bound_ms']:.4f} by {t['bound_by']})"
                      for k, t in out.items())
          + f"; {smi}; {time.perf_counter() - t0:.1f} s")
    return out


def check_expand(exp_args):
    """Kernel vs plain, byte for byte, and two launches bit-equal: returns
    the plain version's ms."""
    import torch
    from brush_tpu_torch.ops.cuda.expand import expand, expand_plain

    keys, recs = expand(*exp_args)
    again = expand(*exp_args)
    torch.cuda.synchronize()
    if not (torch.equal(keys, again[0]) and torch.equal(recs, again[1])):
        raise AssertionError("expand: two launches on the same inputs "
                             "differ")
    (pk, pr), plain_ms = timed(lambda: expand_plain(*exp_args))
    bad = int((keys != pk).sum()) + int((recs != pr).sum())
    if bad:
        raise AssertionError(f"expand: {bad} words differ from the plain "
                             "version")
    return plain_ms


def check_expand_hand():
    """expand against its plain version on the splat layouts of
    ops/cuda/testing.hand_expand (check_expand: byte-equal, repeats
    bit-equal)."""
    import torch
    from brush_tpu_torch.ops.cuda.testing import (
        HAND_EXPAND_CASES, hand_expand,
    )

    t0 = time.perf_counter()
    sizes = {}
    for case in HAND_EXPAND_CASES:
        f5, u5, cum, total, tiles_x, num_tiles, pool = hand_expand(case)
        check_expand((*(torch.tensor(a, device="cuda")
                        for a in (f5, u5, cum, total)),
                      tiles_x, num_tiles, pool))
        sizes[case] = (f5.shape[1], int(total[0]), pool)
    print(f"[hand] expand byte-equal to the plain version, two launches "
          f"bit-equal, on splat layouts (n, total, pool) {sizes}; "
          f"{time.perf_counter() - t0:.1f} s")


def raster_diff(out, plain, atol=1e-5, transmittance=False):
    """A rasterizer's (img, log_t, final_idx) against the plain version's.
    A pixel whose img or log T differs by more than atol is a flip: one
    record on the other side of the alpha or the transmittance threshold.
    With `transmittance` T = exp(log T) stands for log T throughout, and
    a pixel whose final_idx differs is a flip too: in the truncated scan
    the kernel carries T as float32 products record by record, the plain
    version sums log T by torch's scans and reductions, some 1e-5 apart
    on a pixel of hundreds of records, so a crossing within that of
    LOG_T_EPS can fall one record apart, where the record's alpha near
    1/255 moves T (~1e-4) by less than atol.
    Returns dict(err=largest img or log T difference on the other pixels,
    flips=flipped pixels, flip_err=largest difference at a flipped pixel,
    of img and of T = exp(log T), fidx=final_idx mismatches on the other
    pixels). At a flip T is compared, as the image sees it: the record on
    which a pixel crosses TRANSMITTANCE_EPS moves log T by log(1 - alpha)
    but T by less than the threshold."""
    import torch

    (img, log_t, fidx), (p_img, p_log_t, p_fidx) = out, plain
    d_img = (img - p_img).abs().amax(dim=-1)
    d_lt = (log_t.exp() - p_log_t.exp() if transmittance
            else log_t - p_log_t).abs()
    d_t = (log_t.exp() - p_log_t.exp()).abs()
    flipped = (d_img > atol) | (d_lt > atol)
    if transmittance:
        flipped |= fidx != p_fidx
    zero = torch.zeros_like(d_img)
    return dict(
        err=float(torch.where(flipped, zero,
                              torch.maximum(d_img, d_lt)).max()),
        flips=int(flipped.sum()),
        flip_err=float(torch.where(flipped, torch.maximum(d_img, d_t),
                                   zero).max()),
        fidx=int(((fidx != p_fidx) & ~flipped).sum()))


def check_raster(r_args, flip_tol=0.01, max_flip_frac=2e-3, reach=False,
                 kw=None):
    """Kernel vs plain, and two launches bit-equal: returns raster_diff's
    dict and pairs=(pixel, record) pairs the sweep evaluates, active=those
    that reach the alpha threshold, plain_ms, out=the kernel's outputs;
    with `reach` also reach_pairs=those of the pairs whose record may
    reach the pixel's 8x4 warp patch (csrc/reach.cuh's rule, by its host
    twin ops/cuda/testing.may_reach_f32, in a second, untimed plain
    run). kw: the wrapper's keywords (scan_passes, k_lanes; default the
    exact scan); in the truncated scan log T is compared as T (raster_diff's
    `transmittance`)."""
    import torch
    from brush_tpu_torch.ops.cuda.rasterize_fwd import (
        rasterize_fwd, rasterize_fwd_plain,
    )
    from brush_tpu_torch.ops.cuda.testing import may_reach_f32

    kw = kw or {}
    img, log_t, fidx = rasterize_fwd(*r_args, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(
            (img, log_t, fidx), rasterize_fwd(*r_args, **kw))):
        raise AssertionError("rasterize_fwd: two launches on the same "
                             "inputs differ")
    (*plain, (pairs, active)), plain_ms = timed(
        lambda: rasterize_fwd_plain(*r_args, count_pairs=True, **kw))
    d = raster_diff((img, log_t, fidx), plain,
                    transmittance=scan_truncates(kw))
    limit = max(1, int(max_flip_frac * fidx.numel()))
    if d["flip_err"] > flip_tol or d["flips"] > limit or d["fidx"]:
        raise AssertionError(
            f"rasterize_fwd: max err {d['err']:.3e}, {d['flips']} flipped "
            f"pixels (limit {limit}, largest {d['flip_err']:.3e}), "
            f"{d['fidx']} final_idx mismatches elsewhere")
    out = dict(d, pairs=pairs, active=active, plain_ms=plain_ms,
               out=(img, log_t, fidx), kw=kw)
    if reach:
        *_, (_, _, out["reach_pairs"]) = rasterize_fwd_plain(
            *r_args, count_pairs=True, reach=may_reach_f32, **kw)
    return out


def scan_truncates(kw) -> bool:
    """Whether the rasterizers' keywords kw ask for the truncated scan."""
    from brush_tpu_torch.ops.cuda.rasterize_fwd import scan_mode

    kw = kw or {}
    return scan_mode(kw.get("scan_passes", 3), kw.get("k_lanes"))[0] > 0


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


def check_bwd(b_args, label, reach=False, kw=None):
    """rasterize_bwd vs plain on b_args (packed, starts, ends, tiles_x,
    v_out, log_t, final_idx): returns dict(err=row error, abs=max abs
    error, plain_ms, swept/active=(pixel, record) pairs the sweep
    evaluates / that contribute, grads=the kernel's rows); with `reach`
    also reach_pairs=the pairs whose record the kernel's per-warp lists
    keep (the 16x4 patch's largest final_idx and csrc/reach.cuh's rule,
    by its host twin ops/cuda/testing.may_reach_f32, in a second, untimed
    plain run). kw: the wrapper's keywords (scan_passes, k_lanes)."""
    import torch
    from brush_tpu_torch.ops.cuda.rasterize_bwd import (
        rasterize_bwd, rasterize_bwd_plain,
    )
    from brush_tpu_torch.ops.cuda.testing import may_reach_f32

    kw = kw or {}
    grads = rasterize_bwd(*b_args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(grads, rasterize_bwd(*b_args, **kw)):
        raise AssertionError(f"[{label}] rasterize_bwd: two launches on "
                             "the same inputs differ")
    (plain, swept, active), plain_ms = timed(
        lambda: rasterize_bwd_plain(*b_args, count_pairs=True, **kw))
    err = row_error(grads, plain)
    if not torch.isfinite(grads).all() or err > BWD_RTOL:
        raise AssertionError(f"[{label}] rasterize_bwd: row error "
                             f"{err:.3e} > {BWD_RTOL:.0e}")
    out = dict(err=err, abs=float((grads - plain).abs().max()),
               plain_ms=plain_ms, swept=swept, active=active, grads=grads,
               kw=kw)
    if reach:
        *_, out["reach_pairs"] = rasterize_bwd_plain(
            *b_args, count_pairs=True, reach=may_reach_f32, **kw)
    return out


def check_segsum(s_args, label, exact=False):
    """segment_sum vs plain on s_args (rows, offsets, cum, total), with
    `exact` equal in every bit: returns dict(err=row error, abs=max abs
    error, plain_ms)."""
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
    if err > SEG_RTOL or (exact and not torch.equal(seg, plain)):
        raise AssertionError(f"[{label}] segment_sum: row error "
                             f"{err:.3e} (limit {SEG_RTOL:.0e}, exact: "
                             f"{exact})")
    return dict(err=err, abs=float((seg - plain).abs().max()),
                plain_ms=plain_ms)


def check_segsum_hand():
    """segment_sum against its plain version on layouts made by hand,
    which the scenes do not reach: 70,001 splats of 0-3 slots each, 800
    empty splats in a run and 300 at the end, one segment of 100,003
    slots, a hundred of 70 and one of 600 (the span kernel), and the same
    followed by padding splats of count 0 up to 140,000 (the splat
    kernel, csrc/segsum.cu's choice from 131,072 splats); the layouts of
    ops/cuda/testing.hand_segments (700 splats); the CLI's sizes
    (ops/cuda/testing.hand_small_pool: 8192 splats, about 3,000 of 1-40
    slots and every 200th of 2,000-6,000, some 120,000 live slots in a pool
    of 131,072). `total` at the last slot, one slot into the long(est)
    segment, in its middle, and 0. The rows are multiples of 1/16 below 4,
    so every order of summation gives the same float32 and the plain
    version's atomic adds cost it nothing: the two must be equal in every
    bit."""
    import torch
    from brush_tpu_torch.ops.cuda.testing import (
        HAND_LAYOUTS, HAND_POOL, HAND_SMALL_POOL, hand_segments,
        hand_small_pool,
    )

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
    pad = cum[-1:].expand(140_000 - n)
    for n_all in (n, 140_000):
        o, c = torch.cat([offsets, pad])[:n_all], torch.cat([cum, pad])[:n_all]
        for name, value in (("all", raw), ("straddle", long_lo + 1),
                            ("mid", long_lo + 50_001), ("zero", 0)):
            total = torch.tensor([value], dtype=torch.int32, device="cuda")
            s = check_segsum((rows, o, c, total), f"hand n={n_all} {name}",
                             exact=True)
            errs[f"n={n_all} {name}"] = s["err"]
    print(f"[hand] segment_sum n={n} (and padded to 140000) pool={pool}, "
          f"{raw} slots, a segment of {int(counts.max())}: row errors at "
          f"total = all, one slot into the long segment, its middle, 0: "
          f"{errs}; two launches bit-equal; "
          f"{time.perf_counter() - t0:.1f} s")
    for case in HAND_LAYOUTS:
        check_segsum((rows[:, :HAND_POOL], *(
            torch.tensor(a).cuda() for a in hand_segments(case))),
            f"hand {case}", exact=True)
    offsets, cum, total = (torch.tensor(a).cuda() for a in hand_small_pool())
    rows = torch.randint(-63, 64, (9, HAND_SMALL_POOL), generator=gen).to(
        torch.float32).cuda() / 16.0
    w = int(torch.argmax(cum - offsets))
    lo, hi = int(offsets[w]), int(cum[w])
    for name, value in (("all", int(total[0])), ("straddle", lo + 1),
                        ("mid", (lo + hi) // 2), ("zero", 0)):
        check_segsum((rows, offsets, cum, torch.tensor(
            [value], dtype=torch.int32, device="cuda")),
            f"hand small pool {name}", exact=True)
    print(f"[hand] segment_sum on ops/cuda/testing.hand_segments' "
          f"{HAND_LAYOUTS} and at the CLI's sizes: n={cum.shape[0]}, pool "
          f"{HAND_SMALL_POOL}, {int(total[0])} live slots, the longest "
          f"splat {hi - lo}: equal to the plain version in every bit at "
          f"total = all, one slot into the longest splat, its middle, 0; "
          f"two launches bit-equal")


def check_raster_hand_cells():
    """rasterize_fwd against its plain version (check_raster: the flip
    rule, final_idx, two launches bit-equal) on the raster-cell layouts
    of ops/cuda/testing.hand_cells, each at its cell: the layouts the
    kernel's tile cull and per-warp lists must not get wrong."""
    import torch
    from brush_tpu_torch.ops.cuda.testing import HAND_CELL_CASES, hand_cells

    t0 = time.perf_counter()
    seen = {}
    for case in HAND_CELL_CASES:
        packed, starts, ends, cells_x, cell = hand_cells(case)
        r = check_raster((torch.tensor(packed).cuda(),
                          torch.tensor(starts).cuda(),
                          torch.tensor(ends).cuda(), cells_x, cell))
        if not bool((r["out"][2] >= 0).any()):
            raise AssertionError(f"rasterize_fwd: nothing composited on "
                                 f"the hand cell layout {case}")
        seen[f"{case} {cell[0]}x{cell[1]}"] = (r["err"], r["flips"])
    print(f"[hand] rasterize_fwd (max err, flipped pixels) on the "
          f"raster-cell layouts {seen}; two launches bit-equal; "
          f"{time.perf_counter() - t0:.1f} s")


def check_bwd_hand():
    """rasterize_bwd against its plain version (check_bwd: BWD_RTOL, two
    launches bit-equal) on the raster-cell layouts of
    ops/cuda/testing.hand_cells, on the kernel forward's log T and
    final_idx and a seeded image cotangent."""
    import torch
    from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd
    from brush_tpu_torch.ops.cuda.testing import HAND_CELL_CASES, hand_cells

    t0 = time.perf_counter()
    errs = {}
    for case in HAND_CELL_CASES:
        packed, starts, ends, cells_x, cell = hand_cells(case)
        args = (torch.tensor(packed).cuda(), torch.tensor(starts).cuda(),
                torch.tensor(ends).cuda(), cells_x, cell)
        _, log_t, fidx = rasterize_fwd(*args)
        gen = torch.Generator(device="cuda").manual_seed(23)
        v_out = torch.randn((*log_t.shape, 4), generator=gen, device="cuda")
        b = check_bwd((*args[:4], v_out, log_t, fidx, cell),
                      f"hand cells {case}")
        errs[f"{case} {cell[0]}x{cell[1]}"] = b["err"]
    print(f"[hand] rasterize_bwd row errors on the raster-cell layouts "
          f"{errs}; two launches bit-equal; "
          f"{time.perf_counter() - t0:.1f} s")


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


def reach_note(r) -> str:
    """check_raster's or check_bwd's count of the pairs whose record may
    reach the pixel's warp patch, where it counted them."""
    if "reach_pairs" not in r:
        return ""
    return (f", whose record may reach the pixel's warp patch "
            f"{r['reach_pairs']}")


def kernel_phase(cfg, label, backward: bool, reach: bool = False):
    """Phase 2 at one scene, at the render's pool: the tile pretest,
    expand and rasterize_fwd (with `reach`, its pairs that may reach their
    warp patch counted too), and with `backward` the backward kernels."""
    t0 = time.perf_counter()
    splats, cp, size = make_scene(cfg, "cuda")
    from brush_tpu_torch.render import pool_size

    k = kernel_inputs(splats, cp, size,
                      pool_size(splats.capacity, size, cfg["pool"],
                                cfg["block"]))
    k["pretest_plain_ms"] = check_pretest(k["pt_args"], label)
    k["expand_plain_ms"] = check_expand(k["exp_args"])
    r = check_raster(k["r_args"], reach=reach)
    total = int(k["exp_args"][3][0])
    print(f"[{label}] n={cfg['n']} {size[0]}x{size[1]} "
          f"pool={k['exp_args'][6]} records={total}: tile_pretest "
          f"bit-equal to its plain twin; expand byte-equal; "
          f"rasterize_fwd max err {r['err']:.3e}, flipped pixels "
          f"{r['flips']}, pairs evaluated {r['pairs']}, of them active "
          f"{r['active']}" + reach_note(r))
    if backward:
        check_backward(k, label, seed=1)
    print(f"[{label}] {time.perf_counter() - t0:.1f} s")
    k["fwd"] = r
    return splats, cp, size, k


def sh_rows(n: int, seed: int):
    """(means (n, 3), campos, coeffs (n, 16, 3)) on the card: the
    bicycle-5m draw of benchmark/scenes/uniform.py at n = its 5,242,880
    splats, else as many rows drawn in [-14, 14]^3 (the densify scene's
    extent) with normal coefficients; campos: its first view's."""
    import torch
    from benchmark.scenes import uniform
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.ops.rasterize_reference import camera_params

    with open(os.path.join(ROOT, "benchmark", "configs",
                           "bicycle-5m.json")) as f:
        sc = json.load(f)["scene"]
    size = (sc["width"], sc["height"])
    pose = uniform.ring_poses(sc["views"], sc["distance"],
                              np.radians(sc["fov_x_deg"]), size)[0]
    campos = camera_params(Camera(**pose), size, device="cuda").viewmat[:3, 3]
    if n == sc["splats"]:
        p = uniform.params(sc, seed, "cuda")
        return p["means"], campos, p["sh_coeffs"]
    gen = torch.Generator("cuda").manual_seed(seed)
    means = torch.rand((n, 3), generator=gen, device="cuda") * 28.0 - 14.0
    coeffs = torch.randn((n, 16, 3), generator=gen, device="cuda") * 0.3
    return means, campos, coeffs


def same_bits(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def sh_bytes(n: int, kd: int, k: int, backward: bool) -> int:
    """The SH kernels' bytes for n rows of k coefficients, kd of them used
    (csrc/sh.cu): the means and the colour or its gradient, 24 B a row;
    the forward reads the used 12 kd B of a row, the backward writes all
    12 k B. 216 B a row each way at kd = k = 16 (SH_BYTES)."""
    return n * (24 + 12 * (k if backward else kd))


def check_sh(args, label) -> dict:
    """The SH kernels on the arguments kept_kernel_args kept (args: its
    dict; either kernel may be absent) against their plain twins at the
    kernels' directions (ops/sh.view_dirs_plain): the colour and the
    coefficients' gradient equal in every bit, and two launches
    bit-equal. Returns {wrapper name: the twin's ms}."""
    from brush_tpu_torch.ops.cuda import sh
    from brush_tpu_torch.ops.sh import (
        sh_coeffs_grad_plain, sh_to_color, view_dirs_plain,
    )

    plain = {}
    if "sh_color_fwd" in args:
        means, campos, coeffs, degree = args["sh_color_fwd"]
        got = sh.sh_color_fwd(*args["sh_color_fwd"])
        want, plain["sh_color_fwd"] = timed(lambda: sh_to_color(
            degree, view_dirs_plain(means, campos), coeffs))
        if not same_bits(got, want) or not same_bits(
                got, sh.sh_color_fwd(*args["sh_color_fwd"])):
            raise AssertionError(
                f"[{label}] sh_color_fwd: {int((got != want).sum())} of "
                f"{got.numel()} colour values differ from the twin's, or "
                f"two launches differ")
    if "sh_color_bwd" in args:
        means, campos, g, degree, k = args["sh_color_bwd"]
        got = sh.sh_color_bwd(*args["sh_color_bwd"])
        want, plain["sh_color_bwd"] = timed(lambda: sh_coeffs_grad_plain(
            degree, view_dirs_plain(means, campos), g, k))
        if not same_bits(got, want) or not same_bits(
                got, sh.sh_color_bwd(*args["sh_color_bwd"])):
            raise AssertionError(
                f"[{label}] sh_color_bwd: {int((got != want).sum())} of "
                f"{got.numel()} gradient values differ from the twin's, or "
                f"two launches differ")
    return plain


def sh_bounds(args) -> dict:
    """{wrapper name: (least ms, what bounds it)} of the SH kernels in
    args (kept_kernel_args' dict)."""
    from brush_tpu_torch.constants import sh_coeffs_for_degree

    out = {}
    for name, backward in (("sh_color_fwd", False), ("sh_color_bwd", True)):
        if name in args:
            means, degree = args[name][0], args[name][3]
            k = args[name][4] if backward else args[name][2].shape[1]
            out[name] = _bound(sh_bytes(means.shape[0],
                                        sh_coeffs_for_degree(degree), k,
                                        backward), 0)
    return out


def sh_phase(smi: str) -> dict:
    """The SH colour's kernels (ops/cuda/sh.py) at the benchmark's sizes,
    SH_ROWS rows of 16 coefficients from the first bicycle view: each held
    bit-equal to its plain twin at the kernels' directions (ops/sh.py),
    two launches bit-equal, the autograd Function's gradient the backward
    kernel's; the rows where the plain path's directions
    (torch.linalg.vector_norm's) and colours equal the kernels' on the
    card; the wrapper's and the device's ms, the twins' and the bound
    (SH_BYTES a splat).
    Returns {"fwd <n>" / "bwd <n>": those fields}."""
    import torch
    from brush_tpu_torch.ops.cuda import sh
    from brush_tpu_torch.ops.sh import sh_to_color, view_dirs_plain

    t0 = time.perf_counter()
    out = {}
    for n in SH_ROWS:
        means, campos, coeffs = sh_rows(n, SH_SEED)
        gen = torch.Generator("cuda").manual_seed(SH_SEED + 1)
        g = torch.randn((n, 3), generator=gen, device="cuda")
        g[::97] = 0.0
        g[1::89, 1] = -0.0
        plain = check_sh({"sh_color_fwd": (means, campos, coeffs, 3),
                          "sh_color_bwd": (means, campos, g, 3, 16)},
                         f"sh {n}")
        got_b = sh.sh_color_bwd(means, campos, g, 3, 16)
        c = coeffs.detach().requires_grad_(True)
        (auto,) = torch.autograd.grad(sh.sh_color(means, campos, c, 3), c, g)
        if not same_bits(auto, got_b):
            raise AssertionError(f"[sh {n}] the Function's gradient is not "
                                 f"the backward kernel's")
        del auto, c, got_b
        # The plain path's directions and colours (view_colors on the CPU's
        # code, here on the card) against the kernels'.
        dirs = view_dirs_plain(means, campos)
        got = sh.sh_color_fwd(means, campos, coeffs, 3)
        d = means - campos
        pdirs = d / torch.clamp(torch.linalg.vector_norm(
            d, dim=-1, keepdim=True), min=1e-12)
        plain_col = sh_to_color(3, pdirs, coeffs)
        dirs_eq = int((pdirs == dirs).all(1).sum())
        col_eq = int((plain_col == got).all(1).sum())
        col_err = float((plain_col - got).abs().max())
        rel_err = float(((plain_col - got).abs()
                         / plain_col.abs().clamp(min=1e-6)).max())
        del d, pdirs, plain_col, dirs, got
        bound = _bound(SH_BYTES * n, 0)
        fwd = lambda: sh.sh_color_fwd(means, campos, coeffs, 3)  # noqa: E731
        bwd = lambda: sh.sh_color_bwd(means, campos, g, 3, 16)   # noqa: E731
        for tag, fn, plain_ms in (("fwd", fwd, plain["sh_color_fwd"]),
                                  ("bwd", bwd, plain["sh_color_bwd"])):
            out[f"{tag} {n}"] = {
                "ms": cuda_ms(fn, reps=20, warm=3),
                "device_ms": device_ms(fn, reps=20, warm=3),
                "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1]}
        print(f"[sh {n}] rows of 16 coefficients: forward and backward "
              f"bit-equal to the twins, two launches bit-equal, the "
              f"Function's gradient the kernel's; directions equal the "
              f"plain path's at {dirs_eq} of {n} rows, colours at {col_eq} "
              f"(largest diff "
              f"{col_err:.3e}, relative {rel_err:.3e}); "
              + "; ".join(f"{t} {o['ms']:.4f} ms, device "
                          f"{o['device_ms']:.4f} (plain {o['plain_ms']:.3f}, "
                          f"bound {bound[0]:.4f} by {bound[1]}, "
                          f"{100 * bound[0] / o['device_ms']:.1f} % of it)"
                          for t in ("fwd", "bwd")
                          for o in (out[f"{t} {n}"],)))
        del means, campos, coeffs, g
        torch.cuda.empty_cache()
    print(f"[sh] {smi}; {time.perf_counter() - t0:.1f} s")
    return out


def same_field(a, b) -> bool:
    """Two tensors equal in dtype, shape and every bit (floats by their
    int32 views, so -0 is not +0)."""
    import torch

    if a.is_floating_point():
        return same_bits(a, b)
    return a.dtype == b.dtype and torch.equal(a, b)


def proj_bytes(n: int, backward: bool, active: bool) -> int:
    """The projection kernels' bytes for n rows (csrc/projection.cu): 40
    read a row (means, log_scales, quats), 1 more with `active`; forward
    45 written (Projection's seven fields); backward 20 more read (xy's
    and conic's gradients) and 40 written."""
    return n * ((100 if backward else 85) + int(active))


def check_projection(args, label) -> dict:
    """The projection kernels on the arguments kept_kernel_args kept
    (args: its dict; either kernel may be absent) against their twins on
    the card: the forward's seven fields against
    project_splats(normalize_quats(quats)), the backward's three
    gradients against project_bwd_plain, every bit, and two launches
    bit-equal. Returns {wrapper name: the twin's ms (the plain chain's
    forward; project_bwd_plain)}."""
    from brush_tpu_torch.ops.cuda import projection
    from brush_tpu_torch.ops.projection import (
        normalize_quats, project_bwd_plain, project_splats,
    )

    plain = {}
    if "project_fwd" in args:
        a = args["project_fwd"]
        got = projection.project_fwd(*a)
        want, plain["project_fwd"] = timed(lambda: project_splats(
            a[0], a[1], normalize_quats(a[2]), *a[3:7], active=a[7]))
        again = projection.project_fwd(*a)
        bad = [f for f, x, y, z in zip(got._fields, got, want, again)
               if not (same_field(x, y) and same_field(x, z))]
        if bad:
            raise AssertionError(
                f"[{label}] project_fwd: {bad} differ from the plain "
                f"chain's at {a[0].shape[0]} rows, or two launches differ")
    if "project_bwd" in args:
        a = args["project_bwd"]
        got = projection.project_bwd(*a)
        want, plain["project_bwd"] = timed(lambda: project_bwd_plain(*a))
        again = projection.project_bwd(*a)
        bad = [f for f, x, y, z in zip(("means", "log_scales", "quats"),
                                       got, want, again)
               if not (same_bits(x, y) and same_bits(x, z))]
        if bad:
            raise AssertionError(
                f"[{label}] project_bwd: the gradients of {bad} differ "
                f"from project_bwd_plain's at {a[0].shape[0]} rows, or two "
                f"launches differ")
    return plain


def proj_bounds(args) -> dict:
    """{wrapper name: (least ms, what bounds it)} of the projection
    kernels in args (kept_kernel_args' dict)."""
    out = {}
    for name, backward in (("project_fwd", False), ("project_bwd", True)):
        if name in args:
            a = args[name]
            out[name] = _bound(proj_bytes(a[0].shape[0], backward,
                                          a[-1] is not None), 0)
    return out


def proj_rows(n: int, seed: int):
    """The projection's arguments on the card, n rows: the bicycle-5m
    draw of benchmark/scenes/uniform.py (all live) at its 5,242,880
    splats, else n rows drawn in [-14, 14]^3 with bicycle-sized log
    scales and normal quaternions, PROJ_DENSIFY_LIVE of them active; the
    first bicycle view's camera. Returns (args of project_fwd, (g_xy,
    g_conic) normal with zeros of both signs)."""
    import torch
    from benchmark.scenes import uniform
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.ops.rasterize_reference import camera_params

    with open(os.path.join(ROOT, "benchmark", "configs",
                           "bicycle-5m.json")) as f:
        sc = json.load(f)["scene"]
    size = (sc["width"], sc["height"])
    pose = uniform.ring_poses(sc["views"], sc["distance"],
                              np.radians(sc["fov_x_deg"]), size)[0]
    cp = camera_params(Camera(**pose), size, device="cuda")
    gen = torch.Generator("cuda").manual_seed(seed)
    if n == sc["splats"]:
        p = uniform.params(sc, seed, "cuda")
        rows = (p["means"], p["log_scales"], p["quats"], None)
        del p
    else:
        rows = (torch.rand((n, 3), generator=gen, device="cuda") * 28.0
                - 14.0,
                torch.log(torch.rand((n, 3), generator=gen, device="cuda")
                          * 0.02 + 0.0025),
                torch.randn((n, 4), generator=gen, device="cuda"),
                torch.rand(n, generator=gen, device="cuda")
                < PROJ_DENSIFY_LIVE)
    g_xy = torch.randn((n, 2), generator=gen, device="cuda")
    g_conic = torch.randn((n, 3), generator=gen, device="cuda")
    g_xy[::97] = 0.0
    g_conic[1::89, 1] = -0.0
    return (*rows[:3], *cp, size, rows[3]), (g_xy, g_conic)


def projection_phase(smi: str) -> dict:
    """The projection's kernels (ops/cuda/projection.py) at the
    benchmark's sizes, PROJ_ROWS rows (proj_rows): each bit-equal to its
    twin (check_projection), the autograd Function's gradients the
    backward kernel's; the wrapper's and the device's ms, the twins' and
    the plain chain's ms (its forward, and forward with backward under
    autograd, the parent's path), and the bound.
    Returns {"fwd <n>" / "bwd <n>": those fields}."""
    import torch
    from brush_tpu_torch.ops.cuda import projection
    from brush_tpu_torch.ops.projection import normalize_quats, project_splats

    t0 = time.perf_counter()
    out = {}
    for n in PROJ_ROWS:
        args, grads = proj_rows(n, PROJ_SEED)
        active = args[7]
        twin = check_projection({"project_fwd": args,
                                 "project_bwd": (*args[:7], *grads,
                                                 active)}, f"projection {n}")
        got = projection.project_bwd(*args[:7], *grads, active)
        leaves = [a.detach().clone().requires_grad_(True) for a in args[:3]]
        proj = projection.project(*leaves, *args[3:7], active=active)
        torch.autograd.backward([proj.xy, proj.conic], list(grads))
        if not all(same_bits(leaf.grad, g) for leaf, g in zip(leaves, got)):
            raise AssertionError(f"[projection {n}] the Function's "
                                 f"gradients are not the backward kernel's")
        del proj, leaves, got

        def chain(backward):
            leaves = [a.detach().clone().requires_grad_(backward)
                      for a in args[:3]]
            p = project_splats(leaves[0], leaves[1],
                               normalize_quats(leaves[2]), *args[3:7],
                               active=active)
            if backward:
                torch.autograd.backward([p.xy, p.conic], list(grads))
            return p

        fwd = lambda: projection.project_fwd(*args)  # noqa: E731
        bwd = lambda: projection.project_bwd(  # noqa: E731
            *args[:7], *grads, active)
        chain_ms = {"fwd": cuda_ms(lambda: chain(False), reps=5),
                    "bwd": cuda_ms(lambda: chain(True), reps=5)}
        chain_of = {"fwd": "forward",
                    "bwd": "forward and backward under autograd"}
        for tag, fn, backward in (("fwd", fwd, False), ("bwd", bwd, True)):
            bound = _bound(proj_bytes(n, backward, active is not None), 0)
            out[f"{tag} {n}"] = {
                "ms": cuda_ms(fn, reps=20, warm=3),
                "device_ms": device_ms(fn, reps=20, warm=3),
                "plain_ms": twin[f"project_{tag}"],
                "chain_ms": chain_ms[tag],
                "bound_ms": bound[0], "bound_by": bound[1]}
        live = ("all live" if active is None
                else f"{int(active.sum())} active")
        print(f"[projection {n}] rows ({live}): "
              f"forward bit-equal to the plain chain on all seven fields, "
              f"backward to project_bwd_plain, two launches bit-equal, the "
              f"Function's gradients the kernel's; "
              + "; ".join(f"{t} {o['ms']:.4f} ms, device "
                          f"{o['device_ms']:.4f} (twin {o['plain_ms']:.3f}, "
                          f"the plain chain {o['chain_ms']:.3f} "
                          f"{chain_of[t]}, "
                          f"bound {o['bound_ms']:.4f} by {o['bound_by']}, "
                          f"{100 * o['bound_ms'] / o['device_ms']:.1f} % of "
                          f"it)"
                          for t in ("fwd", "bwd")
                          for o in (out[f"{t} {n}"],)))
        del args, grads, active
        torch.cuda.empty_cache()
    print(f"[projection] {smi}; {time.perf_counter() - t0:.1f} s")
    return out


def _bound(nbytes, nops):
    """(least ms, "bytes" or "operations"): the larger of nbytes over the
    memory rate and nops over the float32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / F32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def raster_bounds(live: int, n_cells: int, cell, pool: int, fwd, bwd):
    """The rasterizers' least times (ms) and what bounds each, over `live`
    records in n_cells cells of `cell` and a pool of `pool` slots. fwd and
    bwd are check_raster's and check_bwd's results, whose plain versions
    counted the pairs each sweep evaluates and those that need alpha."""
    px = 256 * cell[0] * cell[1]   # a cell's pixels
    fwd_b = 28 * live + 8 * n_cells + 24 * px * n_cells
    # bwd: records and cell ranges read, v_out + log T + final_idx read,
    # the (9, pool) gradient rows written once.
    bwd_b = 28 * live + 8 * n_cells + 24 * px * n_cells + 36 * pool
    fwd_o = PAIR_SIGMA_OPS * fwd["pairs"] + PAIR_ALPHA_OPS * fwd["active"]
    bwd_o = PAIR_SIGMA_OPS * bwd["swept"] + (
        PAIR_ALPHA_OPS + BWD_OPS_PER_ACTIVE) * bwd["active"]
    # The truncated scan's extra operations per active pair (each side's
    # own mode: check_raster's and check_bwd's keywords).
    fwd_x = scan_ops(fwd.get("kw"), SCAN_FWD_OPS, 1) * fwd["active"]
    bwd_x = scan_ops(bwd.get("kw"), SCAN_BWD_OPS, 2) * bwd["active"]
    fwd_o += fwd_x
    bwd_o += bwd_x
    out = {"rasterize_fwd": _bound(fwd_b, fwd_o),
           "rasterize_bwd": _bound(bwd_b, bwd_o)}
    if "reach_pairs" in fwd:
        # The same formula over the pairs whose record may reach the
        # pixel's warp patch: the work a kernel that culls by reach.cuh's
        # rule must still do (at cells the pairs above count every pair of
        # the cell, also those the culling kernel rightly never evaluates).
        out["rasterize_fwd_reach"] = _bound(
            fwd_b, PAIR_SIGMA_OPS * fwd["reach_pairs"]
            + PAIR_ALPHA_OPS * fwd["active"] + fwd_x)
    if "reach_pairs" in bwd:
        # The backward's: the pairs its per-warp lists keep (the 16x4
        # patch's largest final_idx and reach.cuh's rule).
        out["rasterize_bwd_reach"] = _bound(
            bwd_b, PAIR_SIGMA_OPS * bwd["reach_pairs"] + (
                PAIR_ALPHA_OPS + BWD_OPS_PER_ACTIVE) * bwd["active"] + bwd_x)
    return out


def scan_ops(kw, extra: int, terms: int) -> int:
    """The truncated scan's operations per active pair under the
    rasterizer keywords kw: `terms` scanned terms of scan_passes parts
    each, and `extra`; 0 for the exact scan."""
    if not scan_truncates(kw):
        return 0
    return terms * kw["scan_passes"] * SCAN_PART_OPS + extra


def bounds(k, fwd, bwd):
    """Least times (ms) for this run's inputs, with what bounds each:
    expand, rasterize_fwd, rasterize_bwd, segment_sum (raster_bounds for
    the two rasterizers), and the tile pretest where k has its arguments."""
    import torch

    f5, u5, cum, total = k["exp_args"][:4]
    pool = k["exp_args"][6]
    n = f5.shape[1]
    live = int(total[0])
    # expand reads cum and the ten field words of each splat that owns a
    # live slot (count > 0, first slot below total) and writes the key and
    # 8 record words of every pool slot.
    counts = cum - torch.cat([cum.new_zeros(1), cum[:-1]])
    owners = int(((counts > 0) & (cum - counts < live)).sum())
    exp_b = 44 * owners + 4 + 36 * pool
    # segsum: the live slots' nine rows, offsets and cum read; (9, n) out.
    seg_b = 36 * live + 8 * n + 4 + 36 * n
    return {"expand": _bound(exp_b, 0),
            **raster_bounds(live, k["r_args"][1].shape[0], k["r_args"][4],
                            pool, fwd, bwd),
            "segment_sum": _bound(seg_b, 9 * live),
            **({"tile_pretest": pretest_bound(k["pt_args"])}
               if "pt_args" in k else {})}


def forward_times(k, label):
    """The forward kernels' times at a render's inputs (launches after the
    render path's counts were read), the wrapper's (cuda_ms) and the
    device's (device_ms), beside their plain versions' (the call the check
    compared with) and their bounds. Returns {kernel: those fields}."""
    from brush_tpu_torch.ops.cuda.expand import expand
    from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd
    from brush_tpu_torch.ops.cuda.tile_pretest import tile_pretest

    pt_args, exp_args, r_args = k["pt_args"], k["exp_args"], k["r_args"]
    calls = {"tile_pretest": lambda: tile_pretest(*pt_args),
             "expand": lambda: expand(*exp_args),
             "rasterize_fwd": lambda: rasterize_fwd(*r_args)}
    # No backward ran on these inputs: its bound is not read.
    bound = bounds(k, k["fwd"], dict(swept=0, active=0))
    plain = {"tile_pretest": k["pretest_plain_ms"],
             "expand": k["expand_plain_ms"],
             "rasterize_fwd": k["fwd"]["plain_ms"]}
    out = {name: {"ms": cuda_ms(fn, reps=20),
                  "device_ms": device_ms(fn, reps=20),
                  "plain_ms": plain[name], "bound_ms": bound[name][0],
                  "bound_by": bound[name][1]}
           for name, fn in calls.items()}
    if "rasterize_fwd_reach" in bound:
        out["rasterize_fwd"]["reach_bound_ms"] = \
            bound["rasterize_fwd_reach"][0]
    print(f"[kernels] {label}: " + "; ".join(
        f"{name} {t['ms']:.4f} ms, device {t['device_ms']:.4f} (plain "
        f"{t['plain_ms']:.3f}, bound {t['bound_ms']:.4f} by "
        f"{t['bound_by']}"
        + (f", over the pairs that may reach their warp patch "
           f"{t['reach_bound_ms']:.4f}" if "reach_bound_ms" in t else "")
        + ")" for name, t in out.items()))
    return out


def main_path(splats, cp, size, cfg, cell=(1, 1)):
    """Phase 3 (and the cell phase): one counted render of the bench scene
    at raster cell `cell`, then timings. Returns (launch counts, image,
    records, median ms)."""
    import torch
    from brush_tpu_torch.ops.cuda import build
    from brush_tpu_torch.render import render_splats

    def render():
        return render_splats(
            splats.means, splats.log_scales, splats.quats, splats.sh_coeffs,
            splats.raw_opacity, cp, size, active=splats.active_mask(),
            block_size=cfg["block"], max_isects=cfg["pool"], cell=cell,
            needs_grad=False)

    build.reset_launch_counts()
    with kept_kernel_args([True]) as seen:
        img, aux = render()
    torch.cuda.synchronize()
    counts = build.launch_counts()
    if counts != {"tile_pretest": 1, "expand": 1, "rasterize_fwd": 1,
                  "rasterize_bwd": 0, "segment_sum": 0, "sh_color_fwd": 1,
                  "sh_color_bwd": 0, "project_fwd": 1, "project_bwd": 0}:
        raise AssertionError(f"main path: launches {counts}, not one of "
                             f"each forward kernel")
    tag = "main path" if tuple(cell) == (1, 1) else f"cell {cell}"
    check_sh(seen, f"{tag} render")
    check_projection(seen, f"{tag} render")
    del seen
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
    print(f"[{tag}] bench render {size[0]}x{size[1]}, {cfg['n']} splats, "
          f"cell {cell}: visible={int(aux.num_visible)} "
          f"records={int(aux.num_isects)} dropped={dropped} launches={counts}"
          f"; sh_color_fwd and project_fwd bit-equal to their twins on "
          f"their arguments")
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
    from brush_tpu_torch.ops.cuda import build

    with open(CASTLE_PLY, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    gpu = load_splats_from_ply(data, device="cuda")
    cpu = load_splats_from_ply(data, device="cpu")
    cams = castle_cameras()
    blank = np.zeros((CASTLE_SIZE, CASTLE_SIZE, 3), np.float32)
    gts = [eval_view(cpu, c, blank, keep_image=True).rendered for c in cams]
    t_cpu = time.perf_counter() - t0
    build.reset_launch_counts()
    t0 = time.perf_counter()
    with kept_kernel_args([True]) as seen:
        evals = eval_stats(gpu, list(zip(cams, gts)))
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    n = build.launch_counts()
    counts = (n["expand"], n["rasterize_fwd"], n["tile_pretest"],
              n["sh_color_fwd"], n["project_fwd"])
    check_sh(seen, "castle eval")
    check_projection(seen, "castle eval")
    del seen
    psnr = [e.psnr for e in evals]
    ssim = [e.ssim for e in evals]
    print(f"[castle] {gpu.n_live} splats, SH degree 3, {len(cams)} views "
          f"{CASTLE_SIZE}x{CASTLE_SIZE}: PSNR {[round(p, 2) for p in psnr]} "
          f"SSIM {[round(s, 6) for s in ssim]} vs the CPU render; pool "
          f"{evals[-1].pool}; launches expand={counts[0]} "
          f"rasterize_fwd={counts[1]} tile_pretest={counts[2]} "
          f"sh_color_fwd={counts[3]} sh_color_bwd={n['sh_color_bwd']} "
          f"project_fwd={counts[4]} project_bwd={n['project_bwd']} (the "
          f"last view's sh_color_fwd and project_fwd bit-equal to their "
          f"twins); host s: "
          f"cpu {t_cpu:.1f} gpu {t_gpu:.1f}")
    if min(counts) < len(cams) or len(set(counts)) != 1 \
            or n["sh_color_bwd"] or n["project_bwd"]:
        raise AssertionError(f"castle eval: launches {counts}, not one of "
                             f"each forward kernel a render")
    if min(psnr) < 50.0 or min(ssim) < 0.999:
        raise AssertionError("castle views differ from the CPU render")
    gt_mean = [float(np.mean(g)) for g in gts]
    if min(gt_mean) < 0.01:
        raise AssertionError(f"castle views look empty: means {gt_mean}")
    return gpu, cams, gts, evals[-1].pool


def cell_kernel_phase(splats, cp, size, pool):
    """Both rasterizers at each of CHECK_CELLS on a scene (the entry one),
    held to their plain versions with phase 2's tolerances and repeat
    launches bit-equal; the tile pretest bit-equal to its plain twin,
    expand byte-equal and segment_sum on the re-sorted rows as there."""
    t0 = time.perf_counter()
    for cell in CHECK_CELLS:
        label = f"entry cell {cell}"
        k = kernel_inputs(splats, cp, size, pool, cell)
        check_pretest(k["pt_args"], label)
        check_expand(k["exp_args"])
        r = check_raster(k["r_args"])
        print(f"[{label}] {k['r_args'][1].shape[0]} cells of "
              f"{256 * cell[0] * cell[1]} pixels, records "
              f"{int(k['exp_args'][3][0])}: tile_pretest bit-equal to its "
              f"plain twin; expand byte-equal; rasterize_fwd "
              f"max err {r['err']:.3e}, flipped pixels {r['flips']}, pairs "
              f"evaluated {r['pairs']}, of them active {r['active']}")
        check_backward(k, label, seed=1)
    print(f"[entry cells] {time.perf_counter() - t0:.1f} s")


def castle_cells(splats, cams, gts, pool):
    """The castle at each of CHECK_CELLS: the tile pretest bit-equal to
    its plain twin and rasterize_fwd held to its plain version on view 0's
    arguments, and at CELL also the backward kernels (real opacities:
    saturating pixels, the early-out, a cell's tiles swept in turn); then
    eval_stats, launches counted (one of each forward kernel a render),
    every image held to the (1, 1) one with CELL_IMAGE_TOL, the differing
    pixels counted."""
    import torch
    from brush_tpu_torch.eval import eval_stats
    from brush_tpu_torch.ops.cuda import build
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.render import pool_size

    t0 = time.perf_counter()
    size = (CASTLE_SIZE, CASTLE_SIZE)
    cp = camera_params(cams[0], size, device="cuda")
    pool = pool_size(splats.capacity, size, pool)
    for cell in CHECK_CELLS:
        label = f"castle cell {cell}"
        k = kernel_inputs(splats, cp, size, pool, cell)
        check_pretest(k["pt_args"], label)
        r = check_raster(k["r_args"])
        print(f"[{label}] view 0, {k['r_args'][1].shape[0]} cells, records "
              f"{int(k['exp_args'][3][0])}: tile_pretest bit-equal to its "
              f"plain twin; rasterize_fwd max err "
              f"{r['err']:.3e}, flipped pixels {r['flips']} (largest img or "
              f"T difference there {r['flip_err']:.3e}), pairs evaluated "
              f"{r['pairs']}, active {r['active']}")
        if cell == CELL:
            check_backward(k, label, seed=2)
    del k, r
    views = list(zip(cams, gts))
    base = eval_stats(splats, views, keep_images=True)
    for cell in CHECK_CELLS:
        build.reset_launch_counts()
        evals = eval_stats(splats, views, keep_images=True, cell=cell)
        counts = build.launch_counts()
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
        if min(counts["expand"], counts["rasterize_fwd"]) < len(cams) or \
                counts["tile_pretest"] != counts["expand"] or \
                counts["sh_color_fwd"] != counts["expand"] or \
                counts["project_fwd"] != counts["expand"] or \
                counts["sh_color_bwd"] or counts["project_bwd"]:
            raise AssertionError(f"castle cell {cell}: launches {counts}")
    print(f"[castle cells] {time.perf_counter() - t0:.1f} s")


def castle_cameras():
    return [orbit_camera(2 * np.pi * i / 4 + 0.3, 0.55) for i in range(4)]


def castle_kernels(splats, cams, pool):
    """The tile pretest's and rasterize_fwd's checks on every castle view,
    and the backward kernels' on view 0: real opacities saturate pixels,
    so the forward's
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
        check_pretest(k["pt_args"], f"castle view {view}")
        r = check_raster(k["r_args"])
        live = int(k["exp_args"][3][0])
        print(f"[castle] tile_pretest on view {view} bit-equal to its plain "
              f"twin; rasterize_fwd: max err "
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


@contextlib.contextmanager
def kept_kernel_args(armed: list):
    """While armed[0] is true, keep the arguments of the main path's calls
    to the nine kernel wrappers: the record pipeline's four, ops/binning's
    call of the tile pretest and the SH colour's and the projection's
    autograd Functions' calls of their forward and backward (the wrappers
    still launch and count as before). Yields {wrapper name: last
    arguments, "<wrapper name> kw":
    its last keyword arguments (the rasterizers' scan_passes and
    k_lanes)}."""
    from brush_tpu_torch.ops import pipeline
    from brush_tpu_torch.ops.cuda import build, projection, sh, tile_pretest

    seen = {}
    homes = {name: {"tile_pretest": tile_pretest, "sh_color_fwd": sh,
                    "sh_color_bwd": sh, "project_fwd": projection,
                    "project_bwd": projection}.get(name, pipeline)
             for name in build.KERNELS}
    saved = {name: getattr(homes[name], name) for name in build.KERNELS}

    def keep(name, fn):
        def call(*args, **kw):
            if armed[0]:
                seen[name] = args
                seen[f"{name} kw"] = kw   # the scan mode's keywords
            return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(homes[name], name, keep(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(homes[name], name, fn)


def kept_names(kept: dict) -> list:
    """The wrappers whose arguments kept_kernel_args kept, sorted."""
    return sorted(k for k in kept if not k.endswith(" kw"))


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
    against a black ground truth at raster cell `cell`, all nine kernel
    wrappers counted (the tile pretest and each SH and projection kernel
    once a step),
    and the kernels' arguments
    kept on the first step at each
    capacity. Then the train step metric at the capacity the run ended
    at. Returns (launches, metric ms, window ms, {capacity: arguments},
    records a step, {"losses", "params"} of the run's steps and the state
    they end at)."""
    import torch
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.config import TrainConfig
    from brush_tpu_torch.ops.cuda import build
    from brush_tpu_torch.train import SceneBatch, SplatTrainer

    t_phase = time.perf_counter()
    splats, _, size = make_scene(cfg, "cuda")
    cam = Camera(position=[0, 0, cfg["z"]], rotation=[1, 0, 0, 0],
                 fov_x=np.pi / 2, fov_y=np.pi / 2)
    batch = SceneBatch(np.zeros((size[1], size[0], 3), np.float32), cam)
    trainer = SplatTrainer(TrainConfig(warmup_steps=1, refine_every=3),
                           raster_block_size=TRAIN_BLOCK, raster_cell=cell)
    tag = "train" if tuple(cell) == (1, 1) else f"train cell {cell}"
    state = trainer.init_state(splats)
    torch.cuda.synchronize()
    kept, armed = {}, [False]
    times, stats, refines, caps = [], [], {}, []
    with kept_kernel_args(armed) as seen:
        build.reset_launch_counts()
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
        counts = build.launch_counts()
    losses = [float(st.loss) for st in stats]
    dropped = [int(st.num_dropped) for st in stats]
    records = [int(st.num_isects) for st in stats]
    sp = state.splats
    final = dict(losses=losses, params=sp.params())
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
    if min(counts.values()) < 1 or any(
            counts[name] != TRAIN_STEPS for name in (
                "tile_pretest", "sh_color_fwd", "sh_color_bwd",
                "project_fwd", "project_bwd")):
        raise AssertionError(f"training: launches {counts}")
    if sorted(refines) != [1, 4]:
        raise AssertionError(f"refine ran at {sorted(refines)}, not [1, 4]")
    if not all(np.isfinite(losses)) or not finite:
        raise AssertionError("training produced a non-finite loss or param")
    if any(dropped):
        raise AssertionError(f"training dropped records: {dropped}")
    if sorted(kept) != sorted(set(caps)) or any(
            kept_names(v) != sorted(build.KERNELS) for v in kept.values()):
        raise AssertionError("kernel arguments missing for a capacity")

    # The metric: warm steps at the capacity the run ended at. A default
    # config refines only after its 500 warm-up steps, so none of these
    # refines; its pool sizing gives the same pool at this capacity.
    t0 = time.perf_counter()
    timer = SplatTrainer(raster_block_size=TRAIN_BLOCK, raster_cell=cell)
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
    return counts, step_ms, sum(times), kept, records, final


def train_kernels(kept, tag="train", reach=True):
    """Phase 6 (and the "cli" phase's check): each kernel against its
    plain version on the arguments a training run gave it, kept = {when:
    the nine wrappers' arguments} in the run's order; then the times,
    bounds and errors of the last arguments, as the result reports them."""
    import torch
    from brush_tpu_torch.ops.cuda.expand import expand
    from brush_tpu_torch.ops.cuda.rasterize_bwd import rasterize_bwd
    from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd
    from brush_tpu_torch.ops.cuda.segsum import segment_sum, slot_owners
    from brush_tpu_torch.ops.cuda.projection import project_bwd, project_fwd
    from brush_tpu_torch.ops.cuda.sh import sh_color_bwd, sh_color_fwd
    from brush_tpu_torch.ops.cuda.tile_pretest import tile_pretest

    for when, args in kept.items():
        t0 = time.perf_counter()
        label = f"{tag} {when}"
        k = dict(pt_args=args["tile_pretest"], exp_args=args["expand"],
                 r_args=args["rasterize_fwd"])
        r_kw = args.get("rasterize_fwd kw", {})
        b_kw = args.get("rasterize_bwd kw", {})
        p_plain = check_pretest(k["pt_args"], label)
        e_plain = check_expand(k["exp_args"])
        last = when == list(kept)[-1]
        r = check_raster(k["r_args"], reach=last and reach, kw=r_kw)
        b = check_bwd(args["rasterize_bwd"], label, reach=last and reach,
                      kw=b_kw)
        s = check_segsum(args["segment_sum"], label)
        sh_plain = check_sh(args, label)
        proj_plain = check_projection(args, label)
        print(f"[{label}] pool {k['exp_args'][6]}, records "
              f"{int(k['exp_args'][3][0])}: tile_pretest bit-equal to its "
              f"plain twin; expand byte-equal; rasterize_fwd "
              f"max err {r['err']:.3e}, flipped pixels {r['flips']}, pairs "
              f"evaluated {r['pairs']}, active {r['active']}{reach_note(r)}; "
              f"rasterize_bwd row error {b['err']:.3e} (max abs "
              f"{b['abs']:.3e}), pairs swept {b['swept']}, active "
              f"{b['active']}{reach_note(b)}; segment_sum row error "
              f"{s['err']:.3e} (max abs "
              f"{s['abs']:.3e}); sh_color_fwd and sh_color_bwd "
              f"bit-equal to their twins at "
              f"{args['sh_color_fwd'][0].shape[0]} rows, SH degree "
              f"{args['sh_color_fwd'][3]}; project_fwd and project_bwd "
              f"bit-equal to their twins; "
              f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    pt_args, exp_args, r_args = k["pt_args"], k["exp_args"], k["r_args"]
    sh_f, sh_b = args["sh_color_fwd"], args["sh_color_bwd"]
    pr_f, pr_b = args["project_fwd"], args["project_bwd"]
    b_args, s_args = args["rasterize_bwd"], args["segment_sum"]
    rows, _, cum, total = s_args
    ids = slot_owners(cum, total, rows.shape[1])
    live_rows = rows[:, :ids.shape[0]].contiguous()
    n = cum.shape[0]
    calls = {"expand": (lambda: expand(*exp_args), 20),
             "rasterize_fwd": (lambda: rasterize_fwd(*r_args, **r_kw), 20),
             "rasterize_bwd": (lambda: rasterize_bwd(*b_args, **b_kw), 10),
             "segment_sum": (lambda: segment_sum(*s_args), 20),
             "tile_pretest": (lambda: tile_pretest(*pt_args), 20),
             "sh_color_fwd": (lambda: sh_color_fwd(*sh_f), 20),
             "sh_color_bwd": (lambda: sh_color_bwd(*sh_b), 20),
             "project_fwd": (lambda: project_fwd(*pr_f), 20),
             "project_bwd": (lambda: project_bwd(*pr_b), 20)}
    ms = {name: cuda_ms(fn, reps) for name, (fn, reps) in calls.items()}
    dev = {name: device_ms(fn, reps) for name, (fn, reps) in calls.items()}

    def library():
        return torch.zeros((9, n), device=rows.device).index_add_(
            1, ids, live_rows)

    s_lib, s_lib_dev = cuda_ms(library, 20), device_ms(library, 20)
    if SAVE_ARGS_DIR:
        # The backward kernels' last arguments, for
        # scripts/torch_kernel_variants.py --args-file.
        os.makedirs(SAVE_ARGS_DIR, exist_ok=True)
        name = re.sub(r"[^A-Za-z0-9]+", "_", tag).strip("_")
        torch.save({"when": f"{tag}, {when}", "rasterize_fwd": r_args,
                    "rasterize_fwd kw": r_kw, "rasterize_bwd": b_args,
                    "rasterize_bwd kw": b_kw, "segment_sum": s_args},
                   os.path.join(SAVE_ARGS_DIR, f"{name}.pt"))
    print(f"[{tag} kernels] {when}: "
          + "; ".join(f"{name} {t:.4f} ms, device {dev[name]:.4f}"
                      for name, t in ms.items())
          + f"; index_add_ {s_lib:.4f} ms, device {s_lib_dev:.4f}; "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(ms=ms, device=dev, library_device=s_lib_dev,
                plain={"expand": e_plain, "rasterize_fwd": r["plain_ms"],
                       "rasterize_bwd": b["plain_ms"],
                       "segment_sum": s["plain_ms"], "tile_pretest": p_plain,
                       **sh_plain, **proj_plain},
                err={"expand": 0.0,
                     "rasterize_fwd": max(r["err"], r["flip_err"]),
                     "rasterize_bwd": b["abs"], "segment_sum": s["abs"],
                     "tile_pretest": 0.0, "sh_color_fwd": 0.0,
                     "sh_color_bwd": 0.0, "project_fwd": 0.0,
                     "project_bwd": 0.0},
                bound={**bounds(k, r, b), **sh_bounds(args),
                       **proj_bounds(args)}, library=s_lib,
                when=when,
                scan={"rasterize_fwd": r_kw, "rasterize_bwd": b_kw},
                checks={"rasterize_fwd": {key: v for key, v in r.items()
                                          if key != "out"},
                        "rasterize_bwd": {key: v for key, v in b.items()
                                          if key != "grads"}})


def scan_attrs():
    """Print what nvcc made of every instantiation of both rasterizers
    (registers and local memory a thread, blocks an SM), read on the
    card."""
    from brush_tpu_torch.ops.cuda import rasterize_bwd, rasterize_fwd

    name = {0: "exact", 1: "truncated 1 part", 2: "truncated 2 parts"}
    fwd = [f"{'cells' if cells else 'tiles'} {name[p]} {a[0]} registers, "
           f"{a[1]} local bytes, {a[2]} blocks an SM"
           for (cells, p), a in rasterize_fwd.kernel_attrs().items()]
    bwd = [f"{name[p]} {a[0]} registers, {a[1]} local bytes, {a[2]} blocks "
           f"an SM" for p, a in rasterize_bwd.kernel_attrs().items()]
    print(f"[scan attrs] rasterize_fwd: {'; '.join(fwd)}. rasterize_bwd: "
          f"{'; '.join(bwd)}")


def scan_ratio(r_args, v_out, kw, label):
    """Device ms of both rasterizers in the truncated scan (kw) and in the
    exact scan on the same arguments, in turns (two rounds, the second in
    the reverse order; device_ms), each backward on its own mode's forward
    outputs and the cotangent v_out; prints them and their ratios and
    returns {kernel: (truncated ms, exact ms)}."""
    from brush_tpu_torch.ops.cuda.rasterize_bwd import rasterize_bwd
    from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd

    calls = {}
    for mode, k in (("truncated", kw), ("exact", EXACT)):
        _, log_t, fidx = rasterize_fwd(*r_args, **k)
        b_args = (*r_args[:4], v_out, log_t, fidx, *r_args[4:])
        calls[mode] = {
            "rasterize_fwd": (lambda a=r_args, k=k: rasterize_fwd(*a, **k),
                              20),
            "rasterize_bwd": (lambda a=b_args, k=k: rasterize_bwd(*a, **k),
                              10)}
    ms = {}
    for order in (("truncated", "exact"), ("exact", "truncated")):
        for mode in order:
            for name, (fn, reps) in calls[mode].items():
                ms.setdefault((mode, name), []).append(device_ms(fn, reps))
    out = {name: (statistics.median(ms["truncated", name]),
                  statistics.median(ms["exact", name]))
           for name in ("rasterize_fwd", "rasterize_bwd")}
    print(f"[scan ratio] {label} ({kw}), truncated / exact device ms: "
          + "; ".join(f"{name} {t:.4f} / {e:.4f} = {t / e:.3f}x (rounds "
                      f"{ms['truncated', name]} / {ms['exact', name]})"
                      for name, (t, e) in out.items()))
    return out


def scan_hand():
    """The truncated scan (scan_passes=2) of both rasterizers against their
    plain versions on every hand layout (ops/cuda/testing.hand_tiles and
    scan_edge at k_lanes SCAN_EDGE_LANES, hand_cells at the pipeline's
    scan_lanes): phase 2's tolerances (log T as T), repeats bit-equal, the
    backward on the kernel forward's outputs and a seeded cotangent. On
    scan_edge the kernel's final_idx at the named pixels is the plain
    version's and one record from the exact scan's, each in its
    direction."""
    import torch
    from brush_tpu_torch.ops.cuda.rasterize_fwd import (
        rasterize_fwd, rasterize_fwd_plain,
    )
    from brush_tpu_torch.ops.cuda.testing import (
        HAND_CELL_CASES, HAND_TILE_CASES, SCAN_EDGE_LANES, SCAN_EDGE_PIXELS,
        hand_cells, hand_tiles, scan_edge,
    )
    from brush_tpu_torch.ops.pipeline import scan_lanes

    t0 = time.perf_counter()
    layouts = [(c, hand_tiles(c) + ((1, 1),)) for c in HAND_TILE_CASES]
    layouts.append(("scan_edge", scan_edge() + ((1, 1),)))
    layouts += [(c, hand_cells(c)) for c in HAND_CELL_CASES]
    seen = {}
    for case, (packed, starts, ends, cells_x, cell) in layouts:
        args = (torch.tensor(packed).cuda(), torch.tensor(starts).cuda(),
                torch.tensor(ends).cuda(), cells_x, cell)
        kw = dict(scan_passes=2, k_lanes=SCAN_EDGE_LANES if cell == (1, 1)
                  else scan_lanes(512, cell))
        r = check_raster(args, kw=kw)
        _, log_t, fidx = r["out"]
        gen = torch.Generator(device="cuda").manual_seed(31)
        v_out = torch.randn((*log_t.shape, 4), generator=gen, device="cuda")
        b = check_bwd((*args[:4], v_out, log_t, fidx, cell), f"scan {case}",
                      kw=kw)
        seen[case] = (r["err"], r["flips"], b["err"])
        if case == "scan_edge":
            plain = rasterize_fwd_plain(*args, **kw)[2]
            exact = rasterize_fwd(*args, **EXACT)[2]
            for tile, pixel, sign in SCAN_EDGE_PIXELS:
                if int(fidx[tile, pixel] - exact[tile, pixel]) != sign \
                        or int(plain[tile, pixel]) != int(fidx[tile, pixel]):
                    raise AssertionError(
                        f"[scan] scan_edge tile {tile} pixel {pixel}: "
                        f"final_idx {int(fidx[tile, pixel])}, exact "
                        f"{int(exact[tile, pixel])}")
    print(f"[scan hand] both rasterizers at scan_passes=2 against plain "
          f"(fwd max err, flipped pixels, bwd row error) {seen}; repeats "
          f"bit-equal; scan_edge's named pixels flip against the exact "
          f"scan as on the CPU; {time.perf_counter() - t0:.1f} s")


def scan_configs(args, label):
    """The scan phase's configurations on one training run's last kept
    arguments (args: kept_kernel_args' dict): {tag: (r_args, cotangent,
    kw)}: the exact scan and, at (1, 1), whichever of k_lanes 128 and 512
    is not the run's own mode (train_kernels checked and timed that one),
    and a strip of the frame's cells from SCAN_STRIP_BASE in the run's
    mode."""
    r_args = args["rasterize_fwd"]
    v_out = args["rasterize_bwd"][4]
    own = args.get("rasterize_fwd kw", {})
    out = {f"{label} exact": (r_args, v_out, dict(EXACT))}
    cell = tuple(r_args[4])
    for k in SCAN_LANES if cell == (1, 1) else ():
        if k != own["k_lanes"]:   # the run's own: train_kernels' check
            out[f"{label} k{k}"] = (r_args, v_out,
                                    dict(scan_passes=2, k_lanes=k))
    if cell == (1, 1):
        packed, starts, ends, cells_x = r_args[:4]
        b, n = SCAN_STRIP_BASE, SCAN_STRIP_CELLS
        out[f"{label} strip"] = ((packed, starts[b:b + n], ends[b:b + n],
                                  cells_x, cell, b), v_out[b:b + n],
                                 dict(own))
    return out


def scan_phase(args, label, tk):
    """Both rasterizers in each of scan_configs' modes on a training run's
    own arguments: against their plain versions (phase 2's tolerances,
    log T as T in the truncated scan), repeats bit-equal, the backward on
    the kernel forward's outputs of the same mode; timed in turns (the
    wrapper by cuda_ms, the device by device_ms), with their bounds
    (raster_bounds: the truncated scan's extra operations counted). The
    run's own mode takes train_kernels' fields (tk), and its reach bounds
    the pairs the exact scan's plain versions count here (the sweeps'
    sets differ by the records whose crossing the truncation moves), which
    tk's bounds gain. Returns {tag: {kernel: fields}}."""
    import torch
    from brush_tpu_torch.ops.cuda.rasterize_bwd import rasterize_bwd
    from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd

    t0 = time.perf_counter()
    out, calls = {}, {}
    for tag, (r_args, v_out, kw) in scan_configs(args, label).items():
        exact = kw == EXACT
        r = check_raster(r_args, kw=kw, reach=exact)
        _, log_t, fidx = r["out"]
        packed, starts, ends, cells_x, cell, base = r_args
        b_args = (packed, starts, ends, cells_x, v_out, log_t, fidx, cell,
                  base)
        b = check_bwd(b_args, tag, kw=kw, reach=exact)
        live = int((ends - starts).sum())
        bound = raster_bounds(live, starts.shape[0], cell, packed.shape[1],
                              r, b)
        if exact:
            own = {name: dict(tk["checks"][name],
                              reach_pairs=res["reach_pairs"])
                   for name, res in (("rasterize_fwd", r),
                                     ("rasterize_bwd", b))}
            tk["bound"].update(raster_bounds(
                live, starts.shape[0], cell, packed.shape[1],
                own["rasterize_fwd"], own["rasterize_bwd"]))
            k_own = tk["scan"]["rasterize_fwd"]["k_lanes"]
            out[f"{label} k{k_own}"] = {
                name: dict(tk["scan"][name], ms=tk["ms"][name],
                           device_ms=tk["device"][name],
                           plain_ms=tk["plain"][name],
                           bound_ms=tk["bound"][name][0],
                           bound_by=tk["bound"][name][1],
                           reach_bound_ms=tk["bound"][f"{name}_reach"][0],
                           max_abs_err=tk["err"][name],
                           timed="train_kernels")
                for name in ("rasterize_fwd", "rasterize_bwd")}
        out[tag] = {
            "rasterize_fwd": dict(
                kw, plain_ms=r["plain_ms"], bound_ms=bound["rasterize_fwd"][0],
                bound_by=bound["rasterize_fwd"][1],
                max_abs_err=max(r["err"], r["flip_err"]), flips=r["flips"]),
            "rasterize_bwd": dict(
                kw, plain_ms=b["plain_ms"], bound_ms=bound["rasterize_bwd"][0],
                bound_by=bound["rasterize_bwd"][1], max_abs_err=b["abs"])}
        calls[tag] = {
            "rasterize_fwd": (lambda a=r_args, k=kw: rasterize_fwd(*a, **k),
                              20),
            "rasterize_bwd": (lambda a=b_args, k=kw: rasterize_bwd(*a, **k),
                              10)}
        del r, b
    for _ in range(2):   # in turns, every mode once a round
        for tag, fns in calls.items():
            for name, (fn, reps) in fns.items():
                row = out[tag][name]
                row.setdefault("ms_all", []).append(cuda_ms(fn, reps))
                row.setdefault("device_ms_all", []).append(
                    device_ms(fn, reps))
    for tag, rows in out.items():
        for row in rows.values():
            if "ms_all" in row:
                row["ms"] = statistics.median(row["ms_all"])
                row["device_ms"] = statistics.median(row["device_ms_all"])
        print(f"[scan {tag}] " + "; ".join(
            f"{name} {row['ms']:.4f} ms, device {row['device_ms']:.4f} "
            f"(rounds {row.get('device_ms_all', row.get('timed'))}; plain "
            f"{row['plain_ms']:.1f}, "
            f"bound {row['bound_ms']:.4f} by {row['bound_by']}, max err "
            f"{row['max_abs_err']:.3e})" for name, row in rows.items()))
    own_kw = args.get("rasterize_fwd kw", {})
    if scan_truncates(own_kw):
        scan_ratio(args["rasterize_fwd"], args["rasterize_bwd"][4], own_kw,
                   label)
        for tag, (r_args, v_out, kw) in scan_configs(args, label).items():
            if tag.endswith("strip"):
                scan_ratio(r_args, v_out, kw, tag)
    torch.cuda.empty_cache()
    print(f"[scan] {label}: {time.perf_counter() - t0:.1f} s")
    return out


def strip_phase(splats, cp, size):
    """The strip phase: the bench render's inputs (pool BENCH["pool"]) cut
    into STRIPS strips of cell rows, as STRIPS ranks of the sharded step
    cut them, at (1, 1) and at CELL. Each strip's pipeline runs through the
    kernels on its restricted inputs and its own pool; both rasterizers
    are held to their plain versions on the strip's arguments (phase 2's
    tolerances, repeats bit-equal) and timed. The strips' img and log T
    must equal the whole frame's in every bit, and the per-splat
    gradients of sum(img v) (a seeded v, exact float32 cotangents) summed
    over the strips the frame's within SEG_RTOL of each row's largest
    value. At one strip (tile_base 0) the restriction, the binning and
    both kernels must give the frame's bits. The frame's tile pretest,
    whose masks the strips restrict, is held bit-equal to its plain twin.
    Every call here takes the
    exact scan (EXACT, scan_passes=3): the truncated scan's batches follow
    each pool's own ranges, so a strip's pool and the frame's would part
    by its rounding, not by a fault (scan_phase holds the mode to its
    plain versions on a strip). Returns, for each cell, the per-strip
    records, pools, times, plain times, bounds and errors."""
    import torch
    from brush_tpu_torch.ops.cuda.expand import expand
    from brush_tpu_torch.ops.cuda.rasterize_bwd import rasterize_bwd
    from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd
    from brush_tpu_torch.ops.pipeline import (
        RecordPipeline, depth_order, strip_bins, tile_bins,
    )
    from brush_tpu_torch.parallel.train_step import (
        meta_rows, strip_decode, strip_pool,
    )
    from brush_tpu_torch.render import record_inputs

    pool = BENCH["pool"]
    out = {}
    for cell in ((1, 1), CELL):
        t0 = time.perf_counter()
        tag = f"strips {cell}"
        rec = record_inputs(splats.means, splats.log_scales, splats.quats,
                            splats.sh_coeffs, splats.raw_opacity, cp, size,
                            active=splats.active_mask(), cell=cell)
        # The strips restrict the frame's pretest masks (meta_rows).
        check_pretest(pretest_args(rec, cell), tag)
        a9 = rec.attrs9.detach()
        meta = meta_rows(rec, cell)
        cells_x = -(-size[0] // (16 * cell[0]))
        cells_y = -(-size[1] // (16 * cell[1]))
        num = cells_x * cells_y
        rows = -(-cells_y // STRIPS)
        k = rows * cells_x
        gen = torch.Generator(device="cuda").manual_seed(5)
        v = torch.randn((rows * STRIPS * cells_x, 256 * cell[0] * cell[1], 4),
                        generator=gen, device="cuda")
        v[num:] = 0.0

        def grads(decode, depth_key, pool_, base, k_):
            """The pipeline's gradient of sum(img v) in attrs9, and its
            records."""
            x = a9.clone().requires_grad_(True)
            img, _, total, raw = RecordPipeline.apply(
                x, decode, depth_key, cells_x, num, pool_, False, cell, base,
                k_, EXACT["scan_passes"])
            return torch.autograd.grad(img, x, v[base:base + k_])[0], \
                int(total), int(raw)

        # The whole frame, and the frame as one strip.
        d = depth_order(a9, rec.decode, rec.depth_key, pool)
        keys, recs = expand(d.f5, d.u5, d.cum, d.total, cells_x, num, pool)
        bins = tile_bins(keys, recs, num)
        fwd_f = rasterize_fwd(*bins, cells_x, cell, **EXACT)
        bwd_args = (*bins, cells_x, v[:num], fwd_f[1], fwd_f[2], cell)
        bwd_f = rasterize_bwd(*bwd_args, **EXACT)
        frame_ms = {
            "rasterize_fwd": cuda_ms(lambda: rasterize_fwd(
                *bins, cells_x, cell, **EXACT), reps=10),
            "rasterize_bwd": cuda_ms(lambda: rasterize_bwd(
                *bwd_args, **EXACT), reps=5)}
        g_frame, total_f, _ = grads(rec.decode, rec.depth_key, pool, 0, num)
        dec1, key1 = strip_decode(meta, 0, rows * STRIPS)
        bins1 = strip_bins(keys, recs, num, 0, num)
        fwd1 = rasterize_fwd(*bins1, cells_x, cell, 0, **EXACT)
        one = (torch.equal(dec1, rec.decode)
               and torch.equal(key1, rec.depth_key)
               and all(torch.equal(a, b) for a, b in zip(bins1, bins))
               and all(torch.equal(a, b) for a, b in zip(fwd1, fwd_f))
               and torch.equal(rasterize_bwd(*bins1, cells_x, v[:num],
                                             fwd1[1], fwd1[2], cell, 0,
                                             **EXACT), bwd_f))
        if not one:
            raise AssertionError(f"[{tag}] one strip at tile_base 0 differs "
                                 "from the whole frame")

        per = {f: [] for f in ("records", "pool", "expand_ms", "tile_bins_ms",
                               "fwd", "bwd")}
        g_sum = torch.zeros_like(g_frame)
        same = True
        for s in range(STRIPS):
            base = s * k
            dec, key = strip_decode(meta, s * rows, (s + 1) * rows)
            pool_s = strip_pool(pool, 2.0, STRIPS, BENCH["block"])
            ds = depth_order(a9, dec, key, pool_s)
            exp_args = (ds.f5, ds.u5, ds.cum, ds.total, cells_x, num, pool_s)
            check_expand(exp_args)
            keys_s, recs_s = expand(*exp_args)
            bins_s = strip_bins(keys_s, recs_s, num, base, k)
            r_args = (*bins_s, cells_x, cell, base)
            label = f"{tag} strip {s}"
            r = check_raster(r_args, kw=EXACT)
            img_s, log_t_s, fidx_s = r["out"]
            inside = min(k, num - base)
            same &= (torch.equal(img_s[:inside], fwd_f[0][base:base + inside])
                     and torch.equal(log_t_s[:inside],
                                     fwd_f[1][base:base + inside]))
            b = check_bwd((*bins_s, cells_x, v[base:base + k], log_t_s,
                           fidx_s, cell, base), label, kw=EXACT)
            g, total, raw = grads(dec, key, pool_s, base, k)
            if raw > pool_s:
                raise AssertionError(f"[{label}] {raw} records overflow its "
                                     f"pool {pool_s}")
            g_sum += g
            t = dict(
                expand=cuda_ms(lambda: expand(*exp_args), reps=10),
                tile_bins=cuda_ms(lambda: strip_bins(keys_s, recs_s, num, base,
                                                     k), reps=10),
                fwd=cuda_ms(lambda: rasterize_fwd(*r_args, **EXACT),
                            reps=10),
                bwd=cuda_ms(lambda: rasterize_bwd(
                    *bins_s, cells_x, v[base:base + k], log_t_s, fidx_s,
                    cell, base, **EXACT), reps=5))
            bound = bounds(dict(exp_args=exp_args, r_args=r_args), r, b)
            per["records"].append(total)
            per["pool"].append(pool_s)
            per["expand_ms"].append(t["expand"])
            per["tile_bins_ms"].append(t["tile_bins"])
            for key_, kern, res, err in (
                    ("fwd", "rasterize_fwd", r, max(r["err"], r["flip_err"])),
                    ("bwd", "rasterize_bwd", b, b["abs"])):
                per[key_].append(dict(ms=t[key_], plain_ms=res["plain_ms"],
                                      bound=bound[kern], err=err))
            print(f"[{label}] cells {base}..{base + k - 1}, records {total} "
                  f"of {total_f}, pool {pool_s}: expand {t['expand']:.4f} ms, "
                  f"tile_bins {t['tile_bins']:.4f}, rasterize_fwd "
                  f"{t['fwd']:.4f} (bound {bound['rasterize_fwd'][0]:.4f} by "
                  f"{bound['rasterize_fwd'][1]}; max err {r['err']:.3e}, "
                  f"flipped {r['flips']}), rasterize_bwd {t['bwd']:.4f} "
                  f"(bound {bound['rasterize_bwd'][0]:.4f} by "
                  f"{bound['rasterize_bwd'][1]}; row error {b['err']:.3e})")
        err = row_error(g_sum, g_frame)
        print(f"[{tag}] {STRIPS} strips of {rows} cell rows: records "
              f"{per['records']} (sum {sum(per['records'])}, the frame "
              f"{total_f}); the frame's kernels rasterize_fwd "
              f"{frame_ms['rasterize_fwd']:.4f} ms, rasterize_bwd "
              f"{frame_ms['rasterize_bwd']:.4f} ms; img and log T of the "
              f"strips {'equal' if same else 'DIFFER from'} the frame's in "
              f"every bit; summed gradients' row error {err:.3e}; one strip "
              f"at tile_base 0 bit-equal to the frame; "
              f"{time.perf_counter() - t0:.1f} s")
        if not same:
            raise AssertionError(f"[{tag}] the strips' img or log T differ "
                                 "from the whole frame's")
        if err > SEG_RTOL or sum(per["records"]) != total_f:
            raise AssertionError(f"[{tag}] summed strip gradients: row error "
                                 f"{err:.3e}, records {per['records']}")
        out[cell] = dict(per, frame_ms=frame_ms)
    torch.cuda.empty_cache()
    return out


def sharded_path(cfg, single):
    """Sharded training at world size 1 over NCCL: ShardedTrainer runs
    train_path's bench run (6 steps, refines at 1 and 4, capacity 1M ->
    2M -> 4M) with its kernels counted; each step's loss and the final
    parameters must equal SplatTrainer's (`single`, train_path's) in
    every bit. Then the metric: the median of METRIC_STEPS warm steps at
    the final capacity. Returns (launches, metric ms)."""
    import torch
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.config import TrainConfig
    from brush_tpu_torch.ops.cuda import build
    from brush_tpu_torch.parallel import ShardedTrainer, make_mesh, multihost
    from brush_tpu_torch.parallel.sharding import gather_state
    from brush_tpu_torch.train import SceneBatch

    t_phase = time.perf_counter()
    splats, _, size = make_scene(cfg, "cuda")
    cam = Camera(position=[0, 0, cfg["z"]], rotation=[1, 0, 0, 0],
                 fov_x=np.pi / 2, fov_y=np.pi / 2)
    batch = SceneBatch(np.zeros((size[1], size[0], 3), np.float32), cam)
    with multihost.process_group("cuda"):
        mesh = make_mesh("cuda")
        trainer = ShardedTrainer(mesh, TrainConfig(warmup_steps=1,
                                                   refine_every=3),
                                 raster_block_size=TRAIN_BLOCK)
        state = trainer.init_state(splats)
        del splats
        build.reset_launch_counts()
        state, times, stats, refines = timed_steps(trainer, state, batch,
                                                   TRAIN_STEPS)
        counts = build.launch_counts()
        losses = [float(st.loss) for st in stats]
        whole = gather_state(state, mesh).splats
        differ = [k for k, v in whole.params().items()
                  if not torch.equal(v, single["params"][k])]
        print(f"[sharded] world size {mesh.size} over "
              f"{torch.distributed.get_backend()}, bench scene, "
              f"{TRAIN_STEPS} steps: losses {losses} (SplatTrainer "
              f"{single['losses']}); step ms {[round(t, 3) for t in times]}; "
              f"refines at {sorted(refines)}; capacity {whole.capacity}; "
              f"slack {trainer._slack_q}; launches {counts}; parameters "
              f"{'bit-equal' if not differ else f'DIFFER in {differ}'}")
        if losses != single["losses"] or differ:
            raise AssertionError("sharded training at world size 1 differs "
                                 "from SplatTrainer")
        if min(counts.values()) < TRAIN_STEPS or sorted(refines) != [1, 4] \
                or any(counts[name] != TRAIN_STEPS for name in (
                    "tile_pretest", "sh_color_fwd", "sh_color_bwd",
                    "project_fwd", "project_bwd")):
            raise AssertionError(f"sharded training: launches {counts}, "
                                 f"refines {sorted(refines)}")
        del whole
        pool = trainer._pool_size(state.splats.capacity)
        timer = ShardedTrainer(mesh, raster_block_size=TRAIN_BLOCK)
        if timer._pool_size(state.splats.capacity) != pool:
            raise AssertionError("the sharded metric steps would use "
                                 "another pool")
        state, warm, _, rf = timed_steps(timer, state, batch,
                                         METRIC_STEPS + 1)
        if rf:
            raise AssertionError("a sharded metric step refined")
        step_ms = statistics.median(warm[1:])
        print(f"[sharded] metric: capacity {state.splats.capacity} a rank, "
              f"pool {pool}: median of "
              f"{METRIC_STEPS} warm steps {step_ms:.3f} ms; all ms "
              f"{[round(t, 3) for t in warm]}; phase "
              f"{time.perf_counter() - t_phase:.1f} s")
    return counts, step_ms


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


def cli_phase(castle, pool, d):
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
    castle's means as its point cloud; `cli train2d`. The datasets are
    written into the directory d. Returns the kernels' launches over the
    620-step run, train_kernels' result on its arguments, and for the
    viewer phase the two datasets' paths and the 620-step run's rate over
    its first VIEW_TRAIN_ITER steps."""
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
    from brush_tpu_torch.ops.cuda import build
    from brush_tpu_torch.train import SplatTrainer
    from brush_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    log = []
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
    build.reset_launch_counts()
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
    counts = build.launch_counts()
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
            "rasterize_bwd": CLI_ITERS, "segment_sum": CLI_ITERS,
            "tile_pretest": CLI_ITERS + len(renders),
            "sh_color_fwd": CLI_ITERS + len(renders),
            "sh_color_bwd": CLI_ITERS,
            "project_fwd": CLI_ITERS + len(renders),
            "project_bwd": CLI_ITERS}:
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
    build.reset_launch_counts()
    with step_timer(steps2), \
            spied_renders(eval_mod, c_renders, dropped=True), \
            spied_renders(train_mod, t_cells):
        run_cli([
            "train", "--source", nerf_zip, "--iters",
            str(CLI_CELL_ITERS), "--sh-degree", "3", "--init-count",
            "10000", "--eval-every", "200", "--eval-views", "4",
            "--log-every", "20", "--checkpoint-dir", ck2, "--cell",
            f"{CELL[0]}x{CELL[1]}"], log)
    counts2 = build.launch_counts()
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
            "segment_sum": CLI_CELL_ITERS,
            "tile_pretest": CLI_CELL_ITERS + len(c_renders),
            "sh_color_fwd": CLI_CELL_ITERS + len(c_renders),
            "sh_color_bwd": CLI_CELL_ITERS,
            "project_fwd": CLI_CELL_ITERS + len(c_renders),
            "project_bwd": CLI_CELL_ITERS}:
        raise AssertionError(f"cli train --cell: launches {counts2}, "
                             f"{len(c_renders)} eval renders")

    # The same dataset and flags with --shard for CLI_CELL_ITERS steps:
    # a world of one process over NCCL, made and destroyed by the
    # command; every logged loss must equal the (1, 1) run's.
    t0 = time.perf_counter()
    ck3 = os.path.join(d, "ckpt_shard")
    steps3 = []
    build.reset_launch_counts()
    with step_timer(steps3):
        text = run_cli([
            "train", "--source", nerf_zip, "--iters",
            str(CLI_CELL_ITERS), "--sh-degree", "3", "--init-count",
            "10000", "--eval-every", "200", "--eval-views", "4",
            "--log-every", "20", "--checkpoint-dir", ck3, "--shard"],
            log)
    counts3 = build.launch_counts()
    ms3 = event_ms(steps3)
    rows3 = read_jsonl(os.path.join(ck3, "metrics.jsonl"))
    losses3 = {r["step"]: r["loss"] for r in rows3 if "loss" in r}
    psnr3 = {r["step"]: r["eval_psnr"] for r in rows3
             if "eval_psnr" in r}
    same = {st: losses3.get(st) == losses[st] for st in losses3}
    ranks = text_field(text, r"sharded training over (\d+) ranks")[0]
    print(f"[cli shard] train --shard {CLI_CELL_ITERS} steps over "
          f"{ranks} rank: median step {statistics.median(ms3):.3f} ms "
          f"(CUDA events; train "
          f"{statistics.median(ms[:CLI_CELL_ITERS]):.3f} over its first "
          f"{CLI_CELL_ITERS}); losses equal to the (1, 1) "
          f"run's at {sum(same.values())} of {len(same)} logged steps; "
          f"eval PSNR at 200 {psnr3.get(200)} ((1, 1): {psnr[200]}); "
          f"launches {counts3}; {time.perf_counter() - t0:.1f} s")
    if len(losses3) != 11 or not all(same.values()):
        raise AssertionError(f"cli train --shard losses {losses3} differ "
                             "from cli train's")
    if min(counts3.values()) < CLI_CELL_ITERS or \
            counts3["sh_color_bwd"] != CLI_CELL_ITERS or \
            counts3["sh_color_fwd"] != counts3["tile_pretest"] or \
            counts3["project_bwd"] != CLI_CELL_ITERS or \
            counts3["project_fwd"] != counts3["tile_pretest"]:
        raise AssertionError(f"cli train --shard launches {counts3}")

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
    build.reset_launch_counts()
    with kept_kernel_args([True]) as c_seen, step_timer(c_steps):
        text = run_cli(["train", "--source", nerf_zip, "--iters",
                        str(CASTLE_RESUME_STEP + CASTLE_RESUME_STEPS),
                        "--log-every", "10", "--checkpoint-dir", c_dir,
                        "--resume", castle_ck], log)
    c_counts = build.launch_counts()
    # The SH and projection pairs on their last calls: the final eval's
    # forward, the last step's backward, at the castle's 90,977 rows.
    check_sh(c_seen, "cli castle")
    check_projection(c_seen, "cli castle")
    c_rows = c_seen["sh_color_bwd"][0].shape[0]
    del c_seen
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
          f"; launches {c_counts} (the last SH and projection calls "
          f"bit-equal to their twins at {c_rows} rows); losses "
          f"{c_losses[0]:.5f} .. "
          f"{c_losses[-1]:.5f}; final eval PSNR {c_final[0]} SSIM "
          f"{c_final[1]}; {log[-1][1]:.1f} s")
    if len(c_steps) != CASTLE_RESUME_STEPS or not np.isfinite(
            c_losses).all() or any(
            s[5] is not None for s in c_steps) or min(
            c_counts.values()) < CASTLE_RESUME_STEPS or \
            c_counts["sh_color_bwd"] != c_counts["rasterize_bwd"] or \
            c_counts["sh_color_fwd"] != c_counts["tile_pretest"] or \
            c_counts["project_bwd"] != c_counts["rasterize_bwd"] or \
            c_counts["project_fwd"] != c_counts["tile_pretest"]:
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
    text = run_cli(["train2d", "--image", image, "--size", "256",
                    "--iters", "300", "--shard"], log)
    l2s = [float(x) for x in re.findall(r"loss (\S+)", text)]
    if len(l2s) < 2 or not l2s[-1] < l2s[0]:
        raise AssertionError(f"train2d --shard loss did not fall: {l2s}")
    print(f"[cli] train2d --shard 256x256 300 steps at world size 1: "
          f"losses {l2s} ({'equal to' if l2s == l2d else 'NOT'} "
          f"train2d's); {text_field(text, r'(final PSNR .*)')[0]}")
    print(f"[cli] commands' seconds "
          f"{[(a[0], round(s, 1)) for a, s, _ in log]}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    first = steps[:VIEW_TRAIN_ITER]
    return counts, cli_kernels, dict(
        nerf=nerf_zip, colmap=col_zip,
        rate=len(first) / (first[-1][4] - first[0][1]),
        step_ms=statistics.median(ms[:VIEW_TRAIN_ITER]))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(url: str, body=None, timeout: float = 300.0) -> bytes:
    """GET url, or POST body as JSON; anything but 200 raises."""
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return r.read()


def frame_url(base: str, cam, size) -> str:
    """/api/frame for a camera as page.html asks for one (every float as
    its repr, so the server rebuilds the same camera)."""
    from urllib.parse import urlencode

    q = dict(zip(("px", "py", "pz"), map(float, cam.position)))
    q.update(zip(("qw", "qx", "qy", "qz"), map(float, cam.rotation)))
    q.update(fovx=float(cam.fov_x), fovy=float(cam.fov_y), w=int(size[0]),
             h=int(size[1]))
    return f"{base}/api/frame?{urlencode(q)}"


def viewer_state(base: str) -> dict:
    st = json.loads(http(f"{base}/api/state"))
    if "error" in st:
        raise AssertionError(f"viewer worker failed:\n{st['error']}")
    return st


def viewer_until(base: str, cond, what: str, seconds: float = 180.0) -> dict:
    deadline = time.perf_counter() + seconds
    while True:
        st = viewer_state(base)
        if cond(st):
            return st
        if time.perf_counter() > deadline:
            raise AssertionError(f"viewer: no {what} in {seconds} s: {st}")
        time.sleep(0.05)


def wait_http(base: str, seconds: float, proc=None) -> None:
    deadline = time.perf_counter() + seconds
    while True:
        try:
            http(f"{base}/api/state", timeout=10)
            return
        except OSError:
            if proc is not None and proc.poll() is not None:
                raise AssertionError(f"the viewer exited with {proc.returncode}")
            if time.perf_counter() > deadline:
                raise
            time.sleep(0.1)


def composite_frame(splats, cam, size, block: int):
    """The served frame made in-process: render_splats(needs_grad=False)
    -> pack_rgba_u32 -> RGB + 24 (1 - alpha) over the premultiplied
    colour, truncated to u8. Returns (u8 (h, w, 3), records dropped)."""
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.render import pack_rgba_u32, render_splats

    img, aux = render_splats(
        splats.means, splats.log_scales, splats.quats, splats.sh_coeffs,
        splats.raw_opacity, camera_params(cam, size, device=splats.device),
        size, active=splats.active_mask(), block_size=block,
        needs_grad=False)
    packed = pack_rgba_u32(img).cpu().numpy()
    rgba = packed.view(np.uint8).reshape(size[1], size[0], 4)
    a = rgba[..., 3:4].astype(np.float32) / 255.0
    rgb = np.clip(rgba[..., :3].astype(np.float32) + 24.0 * (1 - a), 0, 255)
    return rgb.astype(np.uint8), int(aux.num_dropped)


@contextlib.contextmanager
def frame_split(sink: list):
    """Splits each RenderService.render_png into stages, appended to sink
    as dicts of ms: "render" (CUDA events from render_splats' call to the
    end of pack_rgba_u32), "render_host" (host clock to the same point,
    after a device synchronize, which the copy to the host that follows
    would wait for anyway), "copy_composite" (the copy and the numpy
    composite) and "encode" (encode_png); "start"/"end" are the host
    clock at render_splats' call and encode_png's return."""
    import torch
    from brush_tpu_torch.viewer import server

    cur = {}

    def render_before(*a):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        cur.update(start=time.perf_counter(), ev0=ev)

    def pack_after(*a, **k):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        torch.cuda.synchronize()
        cur.update(packed=time.perf_counter(), ev1=ev)

    def encode_before(*a):
        cur["encode0"] = time.perf_counter()

    def encode_after(*a, **k):
        if "ev0" not in cur:     # a blank frame: nothing rendered
            return
        end = time.perf_counter()
        sink.append({
            "render": cur["ev0"].elapsed_time(cur["ev1"]),
            "render_host": (cur["packed"] - cur["start"]) * 1e3,
            "copy_composite": (cur["encode0"] - cur["packed"]) * 1e3,
            "encode": (end - cur["encode0"]) * 1e3,
            "start": cur["start"], "end": end})
        cur.clear()

    with wrapped(server, "render_splats", render_before,
                 lambda *a, **k: None), \
            wrapped(server, "pack_rgba_u32", lambda *a: None, pack_after), \
            wrapped(server, "encode_png", encode_before, encode_after):
        yield


def frame_latency(url: str, n: int, warm: int) -> dict:
    """n timed GETs of url after warm ones, each split by frame_split:
    the request's total (host clock round the GET) and its parts; "rest"
    is the total less render_png's own time (HTTP, parsing, the
    camera). Returns lists of ms."""
    for _ in range(warm):
        http(url)
    parts, totals = [], []
    with frame_split(parts):
        for _ in range(n):
            t0 = time.perf_counter()
            http(url)
            totals.append((time.perf_counter() - t0) * 1e3)
    if len(parts) != n:
        raise AssertionError(f"{len(parts)} frames split of {n}")
    out = {k: [p[k] for p in parts]
           for k in ("render", "render_host", "copy_composite", "encode")}
    out["total"] = totals
    out["rest"] = [t - (p["end"] - p["start"]) * 1e3
                   for t, p in zip(totals, parts)]
    return out


def latency_line(lat: dict) -> str:
    q = lambda v, f: float(np.quantile(v, f))
    return (f"total median {q(lat['total'], 0.5):.3f} ms, p90 "
            f"{q(lat['total'], 0.9):.3f}; medians: render "
            f"{q(lat['render'], 0.5):.3f} (CUDA events; host clock "
            f"{q(lat['render_host'], 0.5):.3f}), copy + composite "
            f"{q(lat['copy_composite'], 0.5):.3f}, PNG encode "
            f"{q(lat['encode'], 0.5):.3f}, rest (HTTP, parsing) "
            f"{q(lat['rest'], 0.5):.3f}")


def viewer_phase(data: dict, d: str) -> dict:
    """Phase 9, "viewer": the served path on the card.
    1. make_viewer(ply=the castle, source=the NeRF castle) publishes the
       castle as its stream yields it; a ViewerServer on a free port in a
       thread; /api/frame for the four castle cameras at 800x800 and at
       the page's 512x384, each decoded PNG equal to the frame made
       in-process, each frame one expand and one rasterize_fwd launch
       (no worker running);
    2. the served-path metric: VIEW_FRAMES /api/frame requests at 800x800
       on castle view 0 after VIEW_WARM, split into render, copy +
       composite, PNG encode and the rest;
    3. POST /api/load of the NeRF castle: a TrainWorker from 10,000 random
       splats trains to iter >= VIEW_TRAIN_ITER; its iters/s beside the
       cli run's rate over its first VIEW_TRAIN_ITER steps; the frame
       latency again while it trains; then pause, eval (a finite
       eval_history row), export (the .ply loads with the worker's live
       count), resume (iter advances); /api/views, /api/view_cam,
       /api/view_image, /api/presets; POST /api/load of the COLMAP twin:
       the new worker trains. Any non-200 response or `error` fails;
    4. `python -m brush_tpu_torch.cli view --ply <castle> --source <NeRF
       castle> --port <free>` in a subprocess: its frame of castle view 0
       at 800x800 equals item 1's bytes;
    5. `cli train --rerun` on the NeRF castle (VIEW_RERUN_ITERS steps, one
       eval of 2 views) with a recording stub `rerun` module: the four
       streams arrive; the tile counts sum to num_isects of a render of
       that view at that step in a pool of the heatmap's max_isects; each
       tile's mean depth lies in the depth range of the splats that render
       there (up to the float32 cumsum's rounding, in the JAX package's
       arithmetic).
    Its profiler.trace check is profiler_check, run after every timed
    phase. Returns the launches of item 1's frames."""
    import threading
    import types

    import torch
    from brush_tpu_torch.datasets import png
    from brush_tpu_torch.datasets.ply import (
        load_splats_from_ply, load_splats_from_ply_stream,
    )
    from brush_tpu_torch.ops.cuda import build
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.render import record_inputs, render_splats
    from brush_tpu_torch.utils import rerun_viz
    from brush_tpu_torch.viewer import server as vs

    t_phase = time.perf_counter()
    size = (CASTLE_SIZE, CASTLE_SIZE)
    cams = castle_cameras()

    # 1. Serve the castle.
    with open(CASTLE_PLY, "rb") as f:
        yields = [s.n_live for s in load_splats_from_ply_stream(
            f.read(), device="cpu")]
    published = []
    t0 = time.perf_counter()
    with wrapped(vs.RenderService, "publish",
                 lambda _, s: published.append(s.n_live),
                 lambda *a, **k: None):
        srv = vs.make_viewer(source=data["nerf"], ply=CASTLE_PLY,
                             port=free_port(), device="cuda")
    t_make = time.perf_counter() - t0
    if published != yields or srv.worker is not None:
        raise AssertionError(f"viewer published {published}, the stream "
                             f"yields {yields}")
    castle = srv.render._splats
    block = srv.render.block_size
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    base = f"http://127.0.0.1:{srv.port}"
    served = {}
    counted = {"expand": 0, "rasterize_fwd": 0, "tile_pretest": 0,
               "sh_color_fwd": 0, "project_fwd": 0}
    try:
        wait_http(base, 60)
        drops = []
        for view, cam in enumerate(cams):
            for fs in (size, PAGE_SIZE):
                build.reset_launch_counts()
                body = http(frame_url(base, cam, fs))
                n = build.launch_counts()
                if n != {"expand": 1, "rasterize_fwd": 1,
                         "rasterize_bwd": 0, "segment_sum": 0,
                         "tile_pretest": 1, "sh_color_fwd": 1,
                         "sh_color_bwd": 0, "project_fwd": 1,
                         "project_bwd": 0}:
                    raise AssertionError(f"frame {view} {fs} launched {n}")
                for k in counted:
                    counted[k] += n[k]
                want, dropped = composite_frame(castle, cam, fs, block)
                drops.append(dropped)
                got = png.decode_png(body)
                if not np.array_equal(got, want):
                    raise AssertionError(
                        f"frame {view} {fs} differs from the in-process one "
                        f"at {int((got != want).sum())} values")
                served[view, fs] = body
        print(f"[viewer] {time.perf_counter() - t_phase:.1f} s: castle "
              f"({castle.n_live} splats) published "
              f"{published} (the stream's yields), make_viewer "
              f"{t_make:.2f} s; {len(served)} frames (4 views at {size[0]}x"
              f"{size[1]} and {PAGE_SIZE[0]}x{PAGE_SIZE[1]}) equal to the "
              f"in-process "
              f"frames, each 1 tile_pretest + 1 expand + 1 rasterize_fwd "
              f"launch; records "
              f"dropped in the default pool {drops}")

        # 2. The served-path metric.
        url0 = frame_url(base, cams[0], size)
        idle = frame_latency(url0, VIEW_FRAMES, VIEW_WARM)
        print(f"[viewer] /api/frame {size[0]}x{size[1]} castle view 0, "
              f"{VIEW_FRAMES} "
              f"requests after {VIEW_WARM}, idle: {latency_line(idle)}")

        # 3. Train through the API.
        t0 = time.perf_counter()
        http(f"{base}/api/load", {"path": data["nerf"]})
        st = viewer_until(base, lambda s: s.get("iter", 0) >= VIEW_TRAIN_ITER,
                          f"iter {VIEW_TRAIN_ITER}")
        t_train = time.perf_counter() - t0
        rate = st["iters_per_s"]
        busy = frame_latency(url0, VIEW_FRAMES, VIEW_WARM)
        st_busy = viewer_state(base)
        print(f"[viewer] {time.perf_counter() - t_phase:.1f} s: TrainWorker "
              f"on the NeRF castle: iter {st['iter']} "
              f"after {t_train:.2f} s (load included), {st['splats']} "
              f"splats, loss {st['loss']:.5f}; iters/s {rate:.2f} (its "
              f"25-step window) against cli train's "
              f"{data['rate']:.2f} steps/s over its first {VIEW_TRAIN_ITER} "
              f"(host clock; median step {data['step_ms']:.3f} ms, CUDA "
              f"events); iters/s while the frames below were served "
              f"{st_busy['iters_per_s']:.2f} (iter {st['iter']} -> "
              f"{st_busy['iter']})")
        print(f"[viewer] /api/frame while training: {latency_line(busy)}")
        http(f"{base}/api/control", {"cmd": "pause"})
        viewer_until(base, lambda s: s.get("paused"), "pause")
        paused_at = viewer_state(base)["iter"]
        http(f"{base}/api/control", {"cmd": "eval"})
        hist = viewer_until(base, lambda s: s.get("eval_history"),
                            "eval")["eval_history"]
        if not (len(hist[-1]) == 3 and np.isfinite(hist[-1][1])
                and 0.0 <= hist[-1][2] <= 1.0):
            raise AssertionError(f"eval history {hist}")
        export = os.path.join(d, "viewer_export.ply")
        http(f"{base}/api/control", {"cmd": "export", "path": export})
        st = viewer_until(base, lambda s: s.get("exported") == export,
                          "export")
        with open(export, "rb") as f:
            exported = load_splats_from_ply(f.read(), device="cuda")
        if exported.n_live != st["splats"] or st["iter"] != paused_at:
            raise AssertionError(f"export {exported.n_live} splats, worker "
                                 f"{st['splats']} at {st['iter']}")
        http(f"{base}/api/control", {"cmd": "resume"})
        st = viewer_until(base, lambda s: s["iter"] > paused_at + 5,
                          "steps after resume")
        views = json.loads(http(f"{base}/api/views"))["views"]
        cam3 = json.loads(http(f"{base}/api/view_cam?i=3"))
        thumb = png.decode_png(http(f"{base}/api/view_image?i=0"))
        presets = json.loads(http(f"{base}/api/presets"))["presets"]
        if len(views) != CLI_NERF_TRAIN or cam3["name"] != views[3] or \
                thumb.shape != (160, 160, 3):
            raise AssertionError(f"views {len(views)}, view_cam {cam3}, "
                                 f"thumbnail {thumb.shape}")
        print(f"[viewer] {time.perf_counter() - t_phase:.1f} s: paused at "
              f"{paused_at}; eval {hist[-1]} ([iter, "
              f"PSNR, SSIM] on 8 views); export {exported.n_live} splats; "
              f"resumed to {st['iter']}; {len(views)} views, view_cam 3 "
              f"{cam3['name']}, thumbnail {thumb.shape}, presets "
              f"{len(presets)}")
        t0 = time.perf_counter()
        http(f"{base}/api/load", {"path": data["colmap"]})
        st = viewer_until(base, lambda s: s.get("iter", 0) >= 10,
                          "steps on the COLMAP castle")
        print(f"[viewer] POST /api/load of the COLMAP castle: iter "
              f"{st['iter']} after {time.perf_counter() - t0:.2f} s, "
              f"{st['num_views']} views, {st['splats']} splats (its points), "
              f"loss {st['loss']:.5f}")
    finally:
        srv.shutdown()
        serving.join(timeout=60)
        if srv.worker is not None:
            srv.worker.stop()
            srv.worker.join(timeout=60)
    if serving.is_alive() or (srv.worker is not None
                              and srv.worker.is_alive()):
        raise AssertionError("the viewer's threads did not stop")

    # 4. `cli view` as a user starts it.
    t0 = time.perf_counter()
    port = free_port()
    # At the in-process viewer's block size (RenderService's default): it
    # sets the truncated log-T scan's batches (k_lanes), so frames at
    # another one differ in their last bits.
    proc = subprocess.Popen(
        [sys.executable, "-m", "brush_tpu_torch.cli", "view", "--ply",
         CASTLE_PLY, "--source", data["nerf"], "--port", str(port),
         "--block-size", str(vs.RenderService().block_size)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        base_cli = f"http://127.0.0.1:{port}"
        wait_http(base_cli, 180, proc)
        t_up = time.perf_counter() - t0
        body = http(frame_url(base_cli, cams[0], size))
    finally:
        proc.kill()
        out = proc.communicate(timeout=60)[0].decode(errors="replace")
    if body != served[0, size]:
        print(out[-3000:], file=sys.stderr)
        raise AssertionError("cli view's frame differs from the in-process "
                             "viewer's")
    print(f"[viewer] {time.perf_counter() - t_phase:.1f} s: cli view "
          f"(subprocess): serving after {t_up:.2f} s; its "
          f"castle view 0 frame equals item 1's ({len(body)} bytes)")

    # 5. `cli train --rerun` with a recording stub SDK.
    calls, heat = [], []

    def log(path, entity, **_):
        calls.append((path, entity))

    stub = types.ModuleType("rerun")
    stub.init = stub.set_time_sequence = lambda *a, **k: None
    stub.log = log
    for kind in ("Points3D", "Image", "DepthImage", "Pinhole",
                 "Transform3D", "Scalar"):
        setattr(stub, kind, (lambda k: lambda *a, **kw: (k, a, kw))(kind))

    def before_heat(viz, step, splats, camera, img_size, *a, **k):
        cp = camera_params(camera, img_size, device=splats.device)
        with torch.no_grad():
            _, aux = render_splats(
                splats.means, splats.log_scales, splats.quats,
                splats.sh_coeffs, splats.raw_opacity, cp, img_size,
                active=splats.active_mask(), max_isects=1 << 20,
                needs_grad=False)
            rec = record_inputs(splats.means, splats.log_scales,
                                splats.quats, splats.sh_coeffs,
                                splats.raw_opacity, cp, img_size,
                                active=splats.active_mask())
            depth = rec.proj.depth[rec.producing]
        heat.append((int(aux.num_isects), int(aux.num_dropped),
                     float(depth.min()), float(depth.max())))

    rr_log = []
    saved = sys.modules.get("rerun")
    sys.modules["rerun"] = stub
    try:
        with wrapped(rerun_viz.RerunVisualizer, "log_tile_heatmaps",
                     before_heat, lambda *a, **k: None):
            run_cli(["train", "--source", data["nerf"], "--iters",
                     str(VIEW_RERUN_ITERS), "--eval-every",
                     str(VIEW_RERUN_ITERS - 2), "--eval-views", "2",
                     "--log-every", "5", "--rerun"], rr_log)
    finally:
        if saved is None:
            sys.modules.pop("rerun", None)
        else:
            sys.modules["rerun"] = saved
    paths = [p for p, _ in calls]
    arrays = {p: e[1][0] for p, e in calls if p.startswith("debug/")}
    streams = {"splats": paths.count("world/splats"),
               "dataset views": sum(p.startswith("world/dataset/")
                                    and e[0] == "Pinhole" for p, e in calls),
               "eval": sum(p.startswith("eval/") for p in paths),
               "heatmaps": sum(p.startswith("debug/") for p in paths),
               "scalars": sum(e[0] == "Scalar" for _, e in calls)}
    if streams["splats"] != 1 or streams["dataset views"] != min(
            32, CLI_NERF_TRAIN) or streams["eval"] != 6 or \
            streams["heatmaps"] != 2 or len(heat) != 1:
        raise AssertionError(f"--rerun streams {streams}, heatmaps {heat}")
    counts = arrays["debug/tile_isect_counts"]
    depth = arrays["debug/tile_mean_depth"]
    isects, dropped, lo, hi = heat[0]
    # The mean depth is a float32 cumsum difference (as in the JAX
    # package): a tile's mean is off by up to about one float32 spacing
    # of the whole cumsum.
    slack = 2 * float(np.spacing(np.float32(counts.sum() * hi)))
    inside = depth[counts > 0]
    if counts.sum() != isects or dropped or not (
            (inside >= lo - slack) & (inside <= hi + slack)).all():
        raise AssertionError(
            f"heatmap counts sum {counts.sum()} (render: {isects}, dropped "
            f"{dropped}); mean depths {inside.min()}..{inside.max()} "
            f"against [{lo}, {hi}] +- {slack}")
    print(f"[viewer] {time.perf_counter() - t_phase:.1f} s: cli train "
          f"--rerun {VIEW_RERUN_ITERS} steps: streams "
          f"{streams}; tile counts {counts.shape} sum {int(counts.sum())} = "
          f"the render's records; mean depths {inside.min():.4f}.."
          f"{inside.max():.4f} in [{lo:.4f}, {hi:.4f}] (+- {slack:.2e}); "
          f"{rr_log[-1][1]:.1f} s")

    print(f"[viewer] phase {time.perf_counter() - t_phase:.1f} s")
    return counted


def profiler_check() -> None:
    """The viewer phase's profiler.trace check, run after every timed
    phase: in this process a torch.profiler trace with CUDA activities
    leaves every later kernel launch slower (ROADMAP Queue 3 #17), so
    nothing timed may follow it. profiler.trace around one bench render
    in a span, recorded (profiler.record): the Chrome trace holds the span,
    its child `bench render/record_inputs/tile_pretest` and the expand and
    rasterize_fwd kernels; the span's stage is at least the render's
    CUDA-event time, and the render's stages are its children."""
    import glob

    import torch
    from brush_tpu_torch.render import render_splats
    from brush_tpu_torch.utils import profiler

    splats, cp, bsize = make_scene(BENCH, "cuda")
    go = lambda: render_splats(
        splats.means, splats.log_scales, splats.quats, splats.sh_coeffs,
        splats.raw_opacity, cp, bsize, active=splats.active_mask(),
        block_size=BENCH["block"], max_isects=BENCH["pool"],
        needs_grad=False)
    go()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="brush_trace_") as d:
        tdir = os.path.join(d, "trace")
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with profiler.trace(tdir), profiler.record() as stages:
            with profiler.span("bench render"):
                ev0.record()
                go()
                ev1.record()
        ev_ms = ev0.elapsed_time(ev1)
        span_ms = dict(profiler.chain(stages))["bench render"]
        children = [k for k, _ in stages if k.startswith("bench render/")]
        (tpath,) = glob.glob(os.path.join(tdir, "*.json"))
        with open(tpath) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events]
        kern = {k: [e.get("dur", 0.0) for e in events
                    if e.get("cat") == "kernel" and k in e.get("name", "")]
                for k in ("expand_kernel", "rasterize_fwd_kernel")}
        nested = "bench render/record_inputs/tile_pretest"
        if "bench render" not in names or nested not in names or \
                not all(kern.values()) or span_ms < ev_ms or \
                "bench render/rasterize_fwd" not in children:
            raise AssertionError(f"trace: span {'bench render' in names}, "
                                 f"{nested} {nested in names}, kernels "
                                 f"{kern}; span {span_ms} ms against "
                                 f"render {ev_ms} ms; children {children}")
        print(f"[profiler] profiler.trace of a bench render: {len(events)} "
              f"events ({os.path.getsize(tpath)} bytes), the span and the "
              f"kernels "
              f"{ {k: [round(x, 1) for x in v] for k, v in kern.items()} } "
              f"(us); the span's stage {span_ms:.3f} ms against "
              f"{ev_ms:.3f} ms of CUDA events; its children {children}")
    del splats
    torch.cuda.empty_cache()


def close_quantized(got, want, what: str, atol=2e-4, flip_tol=0.01,
                    max_flip_frac=2e-3):
    """tests/conftest.assert_close_quantized on tensors: within atol but
    for at most max_flip_frac of the values (alpha and transmittance
    threshold flips, counted), each within flip_tol. Returns (largest
    difference, values beyond atol)."""
    d = (got.detach().float() - want.detach().float()).abs()
    big, beyond = float(d.max()), int((d > atol).sum())
    limit = max(1, int(max_flip_frac * d.numel()))
    if big > flip_tol or beyond > limit:
        raise AssertionError(f"{what}: largest difference {big:.3e} "
                             f"(limit {flip_tol}), {beyond} values beyond "
                             f"{atol} (limit {limit})")
    return big, beyond


T_CUT_ALPHA = 1.0 - 2e-4   # a pixel's T reached the 1e-4 early-out


def close_image(got, want, what: str):
    """Two (h, w, 4) renders: close_quantized's defaults, but a pixel where
    either render's transmittance reached the early-out threshold (alpha
    >= T_CUT_ALPHA) may differ by up to 0.05. A flip at that threshold
    keeps or drops a whole record of alpha up to 0.999 behind a T of up to
    0.1 (both paths stop before the record that would take T below 1e-4,
    and compute T in other orders), not a record of alpha 1/255, so it can
    move a value by more than the 0.01 that alpha flips stay within. Such
    pixels are counted: at most 1e-5 of the pixels (at least one).
    Returns (largest difference, values beyond 2e-4, T-cut pixels beyond
    0.01)."""
    d = (got - want).abs().amax(dim=-1)
    cut = (d > 0.01) & (got[..., 3].maximum(want[..., 3]) >= T_CUT_ALPHA)
    n_cut = int(cut.sum())
    limit = max(1, int(1e-5 * d.numel()))
    if n_cut > limit or float(d.max()) > 0.05:
        raise AssertionError(f"{what}: {n_cut} pixels beyond 0.01 at "
                             f"the transmittance cut (limit {limit}), "
                             f"largest difference {float(d.max()):.3e}")
    keep = ~cut
    big, beyond = close_quantized(got[keep], want[keep], what)
    return max(big, float(d.max())), beyond, n_cut


def grad_errors(grads, refs, names, tag: str, gate: bool) -> dict:
    """(largest scaled error, entries beyond 3e-4, entries) of each
    gradient against the reference's (refs, the XLA path's), raising if
    one is not finite or, with gate, beyond tests/test_torch_castle.py's
    render-grad rule: within 3e-4 of the reference's largest |entry| but
    for at most 2e-3 of the entries, each within 0.05."""
    import torch

    out = {}
    for name, a, b in zip(names, grads, refs):
        if not bool(torch.isfinite(a).all() & torch.isfinite(b).all()):
            raise AssertionError(f"{tag} grad {name} not finite")
        scale = float(b.abs().max())
        if scale <= 0:
            raise AssertionError(f"{tag} grad {name} is zero")
        d = (a - b).abs() / scale
        if gate:
            close_quantized(a / scale, b / scale, f"{tag} grad {name}",
                            atol=3e-4, flip_tol=0.05)
        out[name] = (round(float(d.max()), 6), int((d > 3e-4).sum()),
                     d.numel())
    return out


def pinned_castle(splats, cp):
    """The castle with each splat whose view colour leaves [-3.9, 3.9]
    replaced by that colour, clamped, as a DC term alone (the record
    pipeline stores colours as u16 over [-4, 4], the XLA path keeps them;
    tests/test_torch_castle.py pins them so). Returns (splats, pinned)."""
    from brush_tpu_torch.constants import SH_C0
    from brush_tpu_torch.ops.sh import view_colors

    col = view_colors(splats.means, splats.sh_coeffs, cp)
    out = (col.abs() > 3.9).any(dim=1) & splats.active_mask()
    sh = splats.sh_coeffs.clone()
    sh[out] = 0.0
    sh[out, 0] = (col[out].clamp(-3.9, 3.9) - 0.5) / SH_C0
    return splats.replace(sh_coeffs=sh), int(out.sum())


def event_times(fn, reps: int) -> list:
    """CUDA-event ms of reps calls of fn, each synchronized."""
    import torch

    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def peak_mib(fn) -> tuple:
    """(fn(), peak device memory above what was allocated before, MiB)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**20


def xla_phase(gts, castle_pool, bench_img, smi: str) -> dict:
    """Phase 10, "xla": render_splats(backend="xla") and the sharded step's
    XLA path on the card, an exact float32 render built apart from the
    record pipeline (no quantized record, no kernel but the tile pretest
    of its binning and the SH colour's pair), held to the CUDA kernels'
    path. Both paths take their view colours from the same SH kernels
    (render.project_inputs), so this phase does not check the colours
    apart: sh_phase and every check of kept arguments (check_sh) hold
    those kernels to their plain twins. Every XLA run resets the launch
    counts before it and must have launched the tile pretest and the SH
    and projection forwards once a render or step, their backwards once a
    step or render with gradients, and no other kernel it counts.
    1. the castle at 800x800 on view 0 with gradients of a seeded image
       cotangent, its out-of-range view colours pinned (pinned_castle):
       the XLA image within assert_close_quantized's defaults of the
       pipeline's; each of the five parameter gradients of the pipeline
       with float32 gradient records (pack_grad_sort=False), scaled by the
       XLA one's largest entry, within tests/test_torch_castle.py's
       render-grad rule (3e-4, at most 2e-3 of the entries beyond, each
       within 0.05), and the default bf16 pairs' errors reported; each
       path's peak memory;
    2. the bench scene (1M splats, 1024x1024, pool BENCH["pool"]):
       render_splats(backend="xla", needs_grad=False) against phase 3's
       image, within assert_close_quantized's defaults, the same record
       count; the median of XLA_TIMED CUDA-event times of each path (the
       pipeline as phase 3 renders) and each path's peak memory;
    3. ShardedTrainer(backend="xla") at world size 1 over NCCL,
       XLA_SHARD_STEPS steps on the castle's four views: every loss finite,
       the first within 1e-3 relative of the pipeline ShardedTrainer's on
       the same batch; step times and peak memory.
    Returns the numbers for the summary."""
    import torch
    from brush_tpu_torch.datasets.ply import load_splats_from_ply
    from brush_tpu_torch.ops.binning import build_intersections
    from brush_tpu_torch.ops.cuda import build
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.parallel import ShardedTrainer, make_mesh, multihost
    from brush_tpu_torch.render import (
        detached, project_inputs, render_splats,
    )
    from brush_tpu_torch.train import SceneBatch
    from brush_tpu_torch.utils import profiler

    t_phase = time.perf_counter()
    res = {}

    # 1. The castle, view 0, with gradients.
    with open(CASTLE_PLY, "rb") as f:
        castle = load_splats_from_ply(f.read(), device="cuda")
    cams = castle_cameras()
    size = (CASTLE_SIZE, CASTLE_SIZE)
    cp = camera_params(cams[0], size, device="cuda")
    castle, pinned = pinned_castle(castle, cp)
    gen = torch.Generator(device="cuda").manual_seed(5)
    cot = torch.randn((CASTLE_SIZE, CASTLE_SIZE, 4), generator=gen,
                      device="cuda")
    got = {}
    # The pipeline with float32 gradient records (the gate) and with its
    # default bf16 pairs for the conic and colour cotangents (reported).
    for label, kw in (("pipeline", dict(backend="pallas",
                                        pack_grad_sort=False)),
                      ("pipeline bf16", dict(backend="pallas")),
                      ("xla", dict(backend="xla"))):
        params = [getattr(castle, k).clone().requires_grad_(True)
                  for k in CASTLE_NAMES]

        def fwd_bwd():
            img, aux = render_splats(*params, cp, size,
                                     active=castle.active_mask(),
                                     max_isects=castle_pool, **kw)
            (img * cot).sum().backward()
            return img.detach(), aux

        build.reset_launch_counts()
        (img, aux), mib = peak_mib(fwd_bwd)
        counts = build.launch_counts()
        got[label] = (img, [p.grad for p in params], aux, counts, mib)
        if int(aux.num_dropped):
            raise AssertionError(f"[xla] castle {label} dropped records")
    img_p, g_p, aux_p, counts_p, mib_p = got["pipeline"]
    img_x, g_x, aux_x, counts_x, mib_x = got["xla"]
    if counts_x != xla_launches(1, True) or min(counts_p.values()) < 1:
        raise AssertionError(f"[xla] castle launches: xla {counts_x}, "
                             f"pipeline {counts_p}")
    img_err = close_image(img_p, img_x, "[xla] castle image")

    grad_err = grad_errors(g_p, g_x, CASTLE_NAMES, "[xla] castle", gate=True)
    bf16_err = grad_errors(got["pipeline bf16"][1], g_x, CASTLE_NAMES,
                           "[xla] castle", gate=False)
    print(f"[xla] castle view 0 {CASTLE_SIZE}x{CASTLE_SIZE} with gradients "
          f"({pinned} view colours pinned): records xla "
          f"{int(aux_x.num_isects)}, pipeline {int(aux_p.num_isects)}; "
          f"image against the pipeline: largest {img_err[0]:.3e}, "
          f"{img_err[1]} values beyond 2e-4 elsewhere, {img_err[2]} pixels "
          f"beyond 0.01 at the transmittance cut; gradients against the XLA "
          f"ones (largest scaled error, entries beyond 3e-4, entries): "
          f"float32 records {grad_err}, bf16 pairs (the default, not "
          f"gated) {bf16_err}; launches xla {counts_x}, pipeline "
          f"{counts_p}; peak memory xla {mib_x:.1f} MiB, pipeline "
          f"{mib_p:.1f} MiB; {smi}")
    res["castle_peak_mib"] = (mib_x, mib_p)
    del got, g_p, g_x, img_p, img_x

    # 2. The bench scene, inference.
    splats, bcp, bsize = make_scene(BENCH, "cuda")

    def render(backend):
        return render_splats(
            splats.means, splats.log_scales, splats.quats, splats.sh_coeffs,
            splats.raw_opacity, bcp, bsize, active=splats.active_mask(),
            block_size=BENCH["block"] if backend == "pallas" else XLA_BLOCK,
            max_isects=BENCH["pool"], needs_grad=False, backend=backend)

    build.reset_launch_counts()
    (img_x, aux_x), mib_x = peak_mib(lambda: render("xla"))
    counts_x = build.launch_counts()
    (img_p, aux_p), mib_p = peak_mib(lambda: render("pallas"))
    if counts_x != xla_launches(1, False):
        raise AssertionError(f"[xla] bench launches {counts_x}")
    if int(aux_x.num_dropped) or int(aux_x.num_isects) != int(
            aux_p.num_isects):
        raise AssertionError(f"[xla] bench records {int(aux_x.num_isects)} "
                             f"(dropped {int(aux_x.num_dropped)}) against "
                             f"the pipeline's {int(aux_p.num_isects)}")
    img_err = close_image(img_x, bench_img.to("cuda"),
                          "[xla] bench image against phase 3's")
    if not torch.equal(img_p.cpu(), bench_img):
        raise AssertionError("[xla] the pipeline's bench render is not "
                             "phase 3's")
    times = {"pallas": [], "xla": []}
    for _ in range(XLA_TIMED):       # in turns, one of each
        for backend in times:
            times[backend] += event_times(lambda: render(backend), 1)
    ms = {k: statistics.median(v) for k, v in times.items()}
    with profiler.record() as stages:
        render("xla")
    # The round count: the longest tile range over the rounds' width.
    proj, _, opac, _ = project_inputs(
        splats.means, splats.log_scales, splats.quats, splats.sh_coeffs,
        splats.raw_opacity, bcp, bsize, active=splats.active_mask())
    isect = build_intersections(detached(proj), opac.detach(),
                                (-(-bsize[0] // 16), -(-bsize[1] // 16)),
                                BENCH["pool"])
    longest = int((isect.ends - isect.starts).max())
    del proj, opac, isect
    print(f"[xla] bench {bsize[0]}x{bsize[1]}, {BENCH['n']} splats, no "
          f"gradients: records {int(aux_x.num_isects)} (pipeline "
          f"{int(aux_p.num_isects)}); image against phase 3's: largest "
          f"{img_err[0]:.3e}, {img_err[1]} values beyond 2e-4 elsewhere, "
          f"{img_err[2]} pixels beyond 0.01 at the transmittance cut; "
          f"median of "
          f"{XLA_TIMED} renders xla {ms['xla']:.3f} ms (block {XLA_BLOCK}), "
          f"pipeline {ms['pallas']:.3f} ms; all ms "
          f"{ {k: [round(t, 3) for t in v] for k, v in times.items()} }; "
          f"peak memory xla {mib_x:.1f} MiB, pipeline {mib_p:.1f} MiB; "
          f"launches xla {counts_x}; {smi}")
    print(f"[xla] bench XLA render stages (ms) "
          f"{[(k, round(v, 3)) for k, v in profiler.chain(stages)]}; "
          f"longest tile range "
          f"{longest} records, {-(-longest // XLA_BLOCK)} rounds of "
          f"{XLA_BLOCK}")
    res.update(bench_ms=ms, bench_peak_mib=(mib_x, mib_p))
    del splats, img_x, img_p

    # 3. The sharded step's XLA path, world size 1.
    batches = [SceneBatch(gts[i % len(gts)], cams[i % len(cams)])
               for i in range(XLA_SHARD_STEPS)]
    with multihost.process_group("cuda"):
        mesh = make_mesh("cuda")
        pipe = ShardedTrainer(mesh)
        _, st = pipe.step(pipe.init_state(castle), batches[0])
        loss_p = float(st.loss)
        del pipe, st
        trainer = ShardedTrainer(mesh, backend="xla")
        state = trainer.init_state(castle)
        del castle
        losses, step_ms = [], []
        build.reset_launch_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            state, st = trainer.step(state, b)
            stop.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(stop))
            losses.append(float(st.loss))
        counts = build.launch_counts()
        mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        group = torch.distributed.get_backend()
        del state
    rel = abs(losses[0] - loss_p) / abs(loss_p)
    print(f"[xla] ShardedTrainer(backend=\"xla\") at world size 1 over "
          f"{group}, castle ({XLA_SHARD_STEPS} steps on its "
          f"{len(cams)} views): losses {losses}; the first against the "
          f"pipeline ShardedTrainer's {loss_p} (relative {rel:.3e}); step ms "
          f"{[round(t, 3) for t in step_ms]} (median "
          f"{statistics.median(step_ms[1:]):.3f} after the first); peak "
          f"memory {mib:.1f} MiB; launches {counts}; {smi}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not all(np.isfinite(losses)) or rel > 1e-3 or \
            counts != xla_launches(XLA_SHARD_STEPS, True):
        raise AssertionError("[xla] sharded XLA steps: a loss not finite, "
                             "the first too far from the pipeline's, or a "
                             "kernel but the tile pretest's one a step "
                             "launched")
    res.update(shard_ms=statistics.median(step_ms[1:]), shard_peak_mib=mib,
               seconds=time.perf_counter() - t_phase)
    return res


def xla_launches(n: int, backward: bool) -> dict:
    """The launches of n renders or steps of the XLA backend: its binning
    (ops/binning.build_intersections) runs the tile pretest kernel once,
    project_inputs the projection's and the SH colour's forward once each
    (and their backward once each where a gradient flows), and no other
    kernel runs."""
    from brush_tpu_torch.ops.cuda import build

    return {name: n if name in ("tile_pretest", "sh_color_fwd",
                                "project_fwd") or (
        backward and name in ("sh_color_bwd", "project_bwd")) else 0
            for name in build.KERNELS}


def aligned_pool(records: int, num_tiles: int) -> int:
    """A pool that drops none of `records` aligned to ALIGN_LANES: each
    tile's range pads to a multiple of ALIGN_LANES (at most ALIGN_LANES - 1
    slots a tile), the sum rounded up to ALIGN_LANES."""
    k = ALIGN_LANES
    return -(-(records + num_tiles * (k - 1)) // k) * k


def aligned_records(proj, opac, size):
    """build_intersections(align=ALIGN_LANES) of a view in aligned_pool
    of its records (the tile pretest's counts of its visible splats):
    every record kept, every range starting on a multiple of
    ALIGN_LANES. Returns (isect, pool, records, median CUDA-event ms of 3
    aligned builds)."""
    import torch
    from brush_tpu_torch.ops.binning import (
        build_intersections, precompute_tile_masks,
    )

    tiles = (-(-size[0] // 16), -(-size[1] // 16))
    counts = precompute_tile_masks(proj, opac).counts
    records = int(torch.where(proj.visible, counts, 0).sum())
    pool = aligned_pool(records, tiles[0] * tiles[1])

    def build():
        return build_intersections(proj, opac, tiles, pool,
                                   align=ALIGN_LANES)

    isect = build()
    ms = statistics.median(event_times(build, 3))
    held = int((isect.ends - isect.starts).sum())
    if int(isect.num_dropped) or held != records or bool(
            (isect.starts % ALIGN_LANES).any()):
        raise AssertionError(f"[aligned] the aligned layout holds {held} of "
                             f"{records} records (dropped "
                             f"{int(isect.num_dropped)}) or a range is not "
                             f"aligned")
    return isect, pool, records, ms


def same_records(packed_a, starts_a, ends_a, packed_p, starts_p, ends_p):
    """Do two pools hold the same records (rows 0-6, bit for bit) in each
    tile, in the same order? Row 7 differs by design (global ids against
    compact ones)."""
    import torch

    lens = (ends_a - starts_a).to(torch.int64)
    if not torch.equal(lens, (ends_p - starts_p).to(torch.int64)):
        return False
    tiles = torch.arange(lens.shape[0], device=lens.device)
    tile_of = torch.repeat_interleave(tiles, lens)
    first = torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    within = torch.arange(tile_of.shape[0], device=lens.device) - first
    pos_a = starts_a.to(torch.int64)[tile_of] + within
    pos_p = starts_p.to(torch.int64)[tile_of] + within
    return torch.equal(packed_a[:7, pos_a], packed_p[:7, pos_p])


def view_inputs(splats, cp, size):
    """A view's projection, opacity and the rasterizers' per-splat inputs
    [xy, conic, colour, opacity] in global order, without gradients."""
    import torch
    from brush_tpu_torch.render import project_inputs

    with torch.no_grad():
        proj, color, opac, xy = project_inputs(
            splats.means, splats.log_scales, splats.quats, splats.sh_coeffs,
            splats.raw_opacity, cp, size, active=splats.active_mask())
    return proj, opac, [xy, proj.conic, color, opac]


def aligned_phase(bench_img, bench_records: int, bench_fwd: dict,
                  smi: str) -> dict:
    """Phase 11, "aligned": the two rasterizers on the records of
    build_intersections(align=ALIGN_LANES), packed by pack_isect_splats
    (padding slots, the pool's ALIGN_LANES slack lanes, global ids in row
    7), through make_pallas_rasterizer; and the k-NN of the initial scales.
    1. the castle on view 0 at 800x800 with gradients of a seeded tile
       cotangent, its out-of-range view colours pinned (pinned_castle):
       one launch each of rasterize_fwd, rasterize_bwd and segment_sum
       (the backward's per-splat sums, aligned_splat_sums), no expand; a
       second backward pass giving the same gradient bits; the image
       within close_image of the XLA rasterizer's
       (ops/rasterize_tiled.make_rasterizer) on the same records, the four
       gradients within the "xla" phase's castle rule of its; both kernels
       against their plain versions on these records (phase 2's
       tolerances, repeats bit-equal); their times and bounds;
    2. the bench scene (1M splats, 1024x1024) without gradients, in a pool
       of aligned_pool(its records): its records those of the record
       pipeline tile by tile (rows 0-6 bit for bit), its image within
       close_image of phase 3's, one rasterize_fwd launch; rasterize_fwd's
       time on the aligned pool beside the pipeline's, in turns, and
       build_intersections' time;
    3. the k-NN: native.knn_distances on the bench scene's 1M-point draw,
       and both routes (the KD-tree, the brute force on the card) at
       KNN_BOTH_N points, equal within 1e-6 relative.
    Returns the numbers for the summary and the result line."""
    import torch
    from brush_tpu_torch import native
    from brush_tpu_torch.datasets.ply import load_splats_from_ply
    from brush_tpu_torch.ops.cuda import build
    from brush_tpu_torch.ops.cuda.rasterize_bwd import rasterize_bwd
    from brush_tpu_torch.ops.cuda.rasterize_fwd import (
        pack_isect_splats, rasterize_fwd,
    )
    from brush_tpu_torch.ops.pipeline import make_pallas_rasterizer
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.ops.rasterize_tiled import make_rasterizer
    from brush_tpu_torch.render import assemble_image
    from brush_tpu_torch.splats import knn_mean_distance, knn_route

    t_phase = time.perf_counter()
    res = {}
    names = ("xy", "conic", "color", "opac")
    one_each = {"expand": 0, "rasterize_fwd": 1, "rasterize_bwd": 1,
                "segment_sum": 1, "tile_pretest": 0, "sh_color_fwd": 0,
                "sh_color_bwd": 0, "project_fwd": 0, "project_bwd": 0}

    # 1. The castle, view 0, with gradients.
    t0 = time.perf_counter()
    with open(CASTLE_PLY, "rb") as f:
        castle = load_splats_from_ply(f.read(), device="cuda")
    size = (CASTLE_SIZE, CASTLE_SIZE)
    cp = camera_params(castle_cameras()[0], size, device="cuda")
    castle, pinned = pinned_castle(castle, cp)
    proj, opac, attrs = view_inputs(castle, cp, size)
    isect, pool, records, bin_ms = aligned_records(proj, opac, size)
    leaves = [t[isect.order] for t in attrs]
    del castle, proj, opac, attrs
    tiles_x = CASTLE_SIZE // 16
    num_tiles = tiles_x * tiles_x
    tile_ids = torch.arange(num_tiles, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    cot = torch.randn((num_tiles, 256, 4), generator=gen, device="cuda")

    def fwd_bwd(raster):
        params = [t.clone().requires_grad_(True) for t in leaves]
        img = raster(*params, isect.isect_gid, isect.starts, isect.ends,
                     tile_ids)
        (img * cot).sum().backward()
        return img.detach(), [p.grad for p in params]

    build.reset_launch_counts()
    img_a, g_a = fwd_bwd(make_pallas_rasterizer(tiles_x, num_tiles, pool,
                                                ALIGN_LANES))
    torch.cuda.synchronize()
    counts = build.launch_counts()
    build.reset_launch_counts()
    img_x, g_x = fwd_bwd(make_rasterizer(tiles_x, num_tiles, pool,
                                         XLA_BLOCK))
    torch.cuda.synchronize()
    counts_x = build.launch_counts()
    if counts != one_each or any(counts_x.values()):
        raise AssertionError(f"[aligned] castle launches {counts} (want "
                             f"{one_each}), XLA rasterizer {counts_x}")
    # The backward's per-splat sums run in a fixed order (segment_sum):
    # a second pass gives the same bits.
    _, g_again = fwd_bwd(make_pallas_rasterizer(tiles_x, num_tiles, pool,
                                                ALIGN_LANES))
    if not all(torch.equal(a, b) for a, b in zip(g_a, g_again)):
        raise AssertionError("[aligned] two backward passes of "
                             "make_pallas_rasterizer differ")
    del g_again
    img_err = close_image(img_a, img_x, "[aligned] castle image")
    grad_err = grad_errors(g_a, g_x, names, "[aligned] castle", gate=True)

    # The kernels on these records against their plain versions, in the
    # rasterizer's modes: the forward's truncated scan (scan_passes=2,
    # k_lanes ALIGN_LANES), the backward's exact one (raster_vjp.py
    # :467-470, 491-494).
    packed = pack_isect_splats(*leaves, isect.isect_gid, pool, ALIGN_LANES)
    starts, ends = (t.to(torch.int32) for t in (isect.starts, isect.ends))
    r_args = (packed, starts, ends, tiles_x, (1, 1))
    r_kw = dict(scan_passes=2, k_lanes=ALIGN_LANES)
    b_kw = dict(scan_passes=3, k_lanes=ALIGN_LANES)
    fwd = check_raster(r_args, kw=r_kw)
    if not torch.equal(fwd["out"][0], img_a):
        raise AssertionError("[aligned] make_pallas_rasterizer's image is "
                             "not rasterize_fwd's on its pool")
    b_args = (packed, starts, ends, tiles_x, cot, fwd["out"][1],
              fwd["out"][2], (1, 1))
    bwd = check_bwd(b_args, "aligned castle", kw=b_kw)
    fwd_ms = cuda_ms(lambda: rasterize_fwd(*r_args, **r_kw), reps=20)
    bwd_ms = cuda_ms(lambda: rasterize_bwd(*b_args, **b_kw), reps=20)
    bound = raster_bounds(records, num_tiles, (1, 1), packed.shape[1], fwd,
                          bwd)
    castle_row = {
        "rasterize_fwd": dict(ms=fwd_ms, plain_ms=fwd["plain_ms"],
                              max_abs_err=fwd["err"], launches=1,
                              bound_ms=bound["rasterize_fwd"][0],
                              bound_by=bound["rasterize_fwd"][1]),
        "rasterize_bwd": dict(ms=bwd_ms, plain_ms=bwd["plain_ms"],
                              max_abs_err=bwd["abs"], launches=1,
                              bound_ms=bound["rasterize_bwd"][0],
                              bound_by=bound["rasterize_bwd"][1])}
    print(f"[aligned] castle view 0 {CASTLE_SIZE}x{CASTLE_SIZE} with "
          f"gradients ({pinned} view colours pinned): {records} records in "
          f"a pool of {pool} + {ALIGN_LANES} (build_intersections "
          f"{bin_ms:.3f} ms); launches {counts}; image against the XLA "
          f"rasterizer's on the same records: largest {img_err[0]:.3e}, "
          f"{img_err[1]} values beyond 2e-4 elsewhere, {img_err[2]} pixels "
          f"beyond 0.01 at the transmittance cut; gradients against its "
          f"(largest scaled error, entries beyond 3e-4, entries) "
          f"{grad_err}; a second backward pass bit-equal; rasterize_fwd "
          f"against plain: max err "
          f"{fwd['err']:.3e}, {fwd['flips']} flipped pixels; rasterize_bwd "
          f"row error {bwd['err']:.3e} (max abs {bwd['abs']:.3e}); repeats "
          f"bit-equal; ms fwd {fwd_ms:.4f} (plain {fwd['plain_ms']:.1f}, "
          f"bound {bound['rasterize_fwd'][0]:.4f} by "
          f"{bound['rasterize_fwd'][1]}), bwd {bwd_ms:.4f} (plain "
          f"{bwd['plain_ms']:.1f}, bound {bound['rasterize_bwd'][0]:.4f} by "
          f"{bound['rasterize_bwd'][1]}); {smi}; "
          f"{time.perf_counter() - t0:.1f} s")
    del leaves, img_a, img_x, g_a, g_x, fwd, bwd, packed, r_args, b_args
    torch.cuda.empty_cache()

    # 2. The bench scene, no gradients.
    t0 = time.perf_counter()
    splats, bcp, bsize = make_scene(BENCH, "cuda")
    proj, opac, attrs = view_inputs(splats, bcp, bsize)
    isect, pool, b_records, b_bin_ms = aligned_records(proj, opac, bsize)
    if b_records != bench_records:
        raise AssertionError(f"[aligned] bench records {b_records}, the "
                             f"pipeline's {bench_records}")
    leaves = [t[isect.order] for t in attrs]
    del proj, opac, attrs
    tiles_x = bsize[0] // 16
    num_tiles = tiles_x * (bsize[1] // 16)
    raster = make_pallas_rasterizer(tiles_x, num_tiles, pool, ALIGN_LANES)
    tile_ids = torch.arange(num_tiles, device="cuda")
    build.reset_launch_counts()
    img_tiles = raster(*leaves, isect.isect_gid, isect.starts, isect.ends,
                       tile_ids)
    torch.cuda.synchronize()
    b_counts = build.launch_counts()
    if b_counts != dict(one_each, rasterize_bwd=0, segment_sum=0):
        raise AssertionError(f"[aligned] bench launches {b_counts}")
    img = assemble_image(img_tiles, bsize, tiles_x, bsize[1] // 16)
    want = bench_img.to("cuda")
    b_img_err = close_image(img, want, "[aligned] bench image against "
                            "phase 3's")
    img_equal = torch.equal(img, want)
    packed = pack_isect_splats(*leaves, isect.isect_gid, pool, ALIGN_LANES)
    starts, ends = (t.to(torch.int32) for t in (isect.starts, isect.ends))
    k = kernel_inputs(splats, bcp, bsize, BENCH["pool"])
    if not same_records(packed, starts, ends, *k["r_args"][:3]):
        raise AssertionError("[aligned] the bench's aligned records are not "
                             "the record pipeline's")
    r_a = (packed, starts, ends, tiles_x, (1, 1))
    times = {"aligned": [], "pipeline": []}
    for _ in range(3):      # in turns
        times["aligned"].append(cuda_ms(lambda: rasterize_fwd(*r_a),
                                        reps=10))
        times["pipeline"].append(cuda_ms(
            lambda: rasterize_fwd(*k["r_args"]), reps=10))
    b_ms = {key: statistics.median(v) for key, v in times.items()}
    # The same records in each tile: the pairs phase 3's plain version
    # counted on the pipeline's pool are these records' pairs.
    b_bound = raster_bounds(b_records, num_tiles, (1, 1), packed.shape[1],
                            bench_fwd, dict(swept=0, active=0))
    bench_row = dict(ms=b_ms["aligned"], pipeline_ms=b_ms["pipeline"],
                     launches=1, bound_ms=b_bound["rasterize_fwd"][0],
                     bound_by=b_bound["rasterize_fwd"][1],
                     build_intersections_ms=b_bin_ms)
    print(f"[aligned] bench {bsize[0]}x{bsize[1]}, {BENCH['n']} splats, no "
          f"gradients: {b_records} records (the pipeline's, tile by tile, "
          f"bit for bit) in a pool of {pool} + {ALIGN_LANES}, dropped "
          f"{int(isect.num_dropped)}; launches {b_counts}; image against "
          f"phase 3's: largest {b_img_err[0]:.3e}, bit-equal {img_equal}; "
          f"rasterize_fwd median of 3 x 10 launches aligned "
          f"{b_ms['aligned']:.4f} ms, pipeline {b_ms['pipeline']:.4f} ms "
          f"(all {times}), bound {b_bound['rasterize_fwd'][0]:.4f} by "
          f"{b_bound['rasterize_fwd'][1]}; build_intersections(align="
          f"{ALIGN_LANES}) {b_bin_ms:.3f} ms; {smi}; "
          f"{time.perf_counter() - t0:.1f} s")
    del splats, leaves, img_tiles, img, packed, k, isect
    torch.cuda.empty_cache()

    # 3. The k-NN of the initial scales (from_random's first draw).
    t0 = time.perf_counter()
    if knn_route() != "native":
        raise AssertionError("[aligned] no native k-NN: g++ did not build "
                             "the native library")
    pts = np.random.default_rng(0).uniform(
        np.asarray([BENCH["lo"]] * 3, np.float32),
        np.asarray([BENCH["hi"]] * 3, np.float32),
        size=(BENCH["n"], 3)).astype(np.float32)
    t1 = time.perf_counter()
    native.knn_distances(pts, 3)
    knn_1m = time.perf_counter() - t1
    few = pts[:KNN_BOTH_N]
    t1 = time.perf_counter()
    kd = native.knn_distances(few, 3)
    knn_kd = time.perf_counter() - t1
    t1 = time.perf_counter()
    brute = knn_mean_distance(torch.from_numpy(few).cuda(), 3).cpu().numpy()
    knn_brute = time.perf_counter() - t1
    rel = float(np.max(np.abs(kd - brute) / np.abs(brute)))
    print(f"[aligned] k-NN (k 3) host s: native KD-tree on the bench "
          f"scene's {BENCH['n']} points {knn_1m:.3f}; at {KNN_BOTH_N} "
          f"points KD-tree {knn_kd:.3f}, brute force on the card "
          f"{knn_brute:.3f}, largest relative difference {rel:.3e}; {smi}; "
          f"{time.perf_counter() - t0:.1f} s")
    if rel > 1e-6:
        raise AssertionError(f"[aligned] k-NN routes differ by {rel:.3e}")
    res.update(
        kernels={"rasterize_fwd": {"castle": castle_row["rasterize_fwd"],
                                   "bench": bench_row},
                 "rasterize_bwd": {"castle": castle_row["rasterize_bwd"]}},
        castle_records=records, bench_records=b_records, bench_ms=b_ms,
        knn_s=dict(native_1m=knn_1m, native=knn_kd, brute=knn_brute),
        seconds=time.perf_counter() - t_phase)
    print(f"[aligned] phase {res['seconds']:.1f} s")
    return res


def load_script(path: str):
    """A script of scripts/ as a module: scripts/torch_probe_5m.py (its
    scene, step and trainer runs), scripts/torch_harvest.py (harvest)."""
    import importlib.util

    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def scale_phase(smi: str) -> dict:
    """Phase 12, "scale": the bicycle-scale probe step and SplatTrainer
    steps at scripts/torch_probe_5m.py's defaults (see the module
    docstring). Returns the kernels' fields (train_kernels on the probe
    step's arguments), launches, the medians and peaks."""
    import torch
    from brush_tpu_torch.ops.cuda import build

    probe = load_script(PROBE_SCRIPT)
    t_phase = time.perf_counter()
    n = probe.splat_count(SCALE_MILLIONS)
    size = (SCALE_SIZE, SCALE_SIZE)
    pool = probe.probe_pool(n)
    t0 = time.perf_counter()
    splats, cam, cp, gt = probe.make_scene(n, SCALE_SIZE, "cuda")
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    params = splats.params()
    opt = probe.init_adam(params)
    torch.cuda.empty_cache()

    def step():
        return probe.probe_step(params, opt, cp, size, gt, pool)

    armed = [True]
    with kept_kernel_args(armed) as seen:
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        new_params, _, loss, records, dropped = step()
        torch.cuda.synchronize()
        counts = build.launch_counts()
        kept = dict(seen)
    loss, records, dropped = float(loss), int(records), int(dropped)
    finite = all(bool(torch.isfinite(v).all()) for v in new_params.values())
    del new_params
    if counts != {name: 1 for name in build.KERNELS}:
        raise AssertionError(f"[scale] probe step launches {counts}")
    if dropped or not (finite and np.isfinite(loss)):
        raise AssertionError(f"[scale] probe step dropped {dropped} "
                             f"records (loss {loss}, finite parameters "
                             f"{finite})")
    probe_all = probe.fixed_step_ms(step)
    probe_ms = statistics.median(probe_all)
    probe_peak = torch.cuda.max_memory_allocated() / 2**20
    del params, opt
    torch.cuda.empty_cache()
    # No reach counts here: at 8.5M records the truncated scan's plain
    # versions take over a minute a run, and the reach bound of these
    # arguments stands in PERF.md (counted on the exact scan).
    tk = train_kernels({"probe step": kept}, "scale", reach=False)
    scan_ratio(kept["rasterize_fwd"], kept["rasterize_bwd"][4],
               kept["rasterize_fwd kw"], "B (the probe step's arguments)")
    del kept
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    gt_np = np.zeros((SCALE_SIZE, SCALE_SIZE, 3), np.float32)
    run = probe.trainer_run(splats, cam, gt_np, SCALE_TRAIN_STEPS, pool=pool)
    probe.check_trainer_run(run)
    train_ms = statistics.median(run["ms"][1:])
    train_peak = torch.cuda.max_memory_allocated() / 2**20
    del run["state"], splats
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[scale] n={n} SH 3 {size[0]}x{size[1]} pool={pool}: scene "
          f"{scene_s:.1f} s; probe step launches {counts}, records "
          f"{records}, dropped {dropped}, loss {loss:.6f}; median of "
          f"{len(probe_all)} probe steps on fixed parameters "
          f"{probe_ms:.3f} ms (all {[round(t, 3) for t in probe_all]}), "
          f"peak {probe_peak:.1f} MiB; kernels on the probe step's "
          f"arguments (wrapper / device ms, plain ms, bound ms): "
          + "; ".join(
              f"{k} {tk['ms'][k]:.4f} / {tk['device'][k]:.4f}, plain "
              f"{tk['plain'][k]:.1f}, bound {tk['bound'][k][0]:.4f} by "
              f"{tk['bound'][k][1]}"
              + (f", reach bound {tk['bound'][k + '_reach'][0]:.4f}"
                 if k + "_reach" in tk["bound"] else "")
              for k in build.KERNELS)
          + f", index_add_ {tk['library']:.4f} / "
          f"{tk['library_device']:.4f}; SplatTrainer ({SCALE_TRAIN_STEPS} "
          f"steps at pool {pool}) step ms "
          f"{[round(t, 3) for t in run['ms']]}, median after the first "
          f"{train_ms:.3f}, records {run['records']}, dropped "
          f"{run['dropped']}, launches a step {run['launches'][0]}, peak "
          f"{train_peak:.1f} MiB; {smi}; phase {seconds:.1f} s")
    return dict(kernels=tk, launches=counts, records=records,
                probe_ms=probe_ms, probe_peak_mib=probe_peak,
                train_ms=train_ms, train_peak_mib=train_peak,
                train_launches=run["launches"], seconds=seconds)


def quality_trace(d: str) -> dict:
    """The quality phase's dataset: the ray-traced castle written by
    raytrace.write_nerf_scene on the card into d; val views
    QUALITY_CHECK_VIEWS traced again on the card and on the CPU (float64
    both): hit masks equal and RGBA within 1e-6; the dataset's u8 pixels
    against the CPU trace's quantization, at most 1 apart in at most
    QUALITY_U8_FRAC of the pixels. Returns the path, the loaded dataset
    and the seconds."""
    import torch
    from brush_tpu_torch.datasets import load_dataset
    from brush_tpu_torch.datasets import raytrace as rt
    from brush_tpu_torch.datasets import testing as dt

    scene = rt.build_scene()
    src = os.path.join(d, "castle_raytraced.zip")
    size = QUALITY_SIZE
    secs = rt.write_nerf_scene(src, scene, QUALITY_TRAIN, QUALITY_VAL, size,
                               device="cuda")
    t0 = time.perf_counter()
    ds = load_dataset(src)
    load_s = time.perf_counter() - t0
    if (len(ds.train.views), len(ds.eval.views)) != (
            QUALITY_TRAIN, QUALITY_VAL):
        raise AssertionError("the ray-traced castle loads wrong")
    val = dt.orbit_views(QUALITY_VAL, seed=2)
    checks = []
    for i in QUALITY_CHECK_VIEWS:
        t0 = time.perf_counter()
        cpu = rt.render_view(scene, val[i], size, size, CASTLE_FOV_X,
                             device="cpu")
        cpu_s = time.perf_counter() - t0
        gpu = rt.render_view(scene, val[i], size, size, CASTLE_FOV_X,
                             device="cuda").cpu()
        err = float((gpu - cpu).abs().max())
        masks = torch.equal(gpu[..., 3], cpu[..., 3])
        got = np.rint(ds.eval.views[i].image * 255.0).astype(np.int16)
        want = rt.quantize_u8(cpu).numpy().astype(np.int16)
        du8 = np.abs(got - want)
        px = int((du8.max(axis=-1) > 0).sum())
        checks.append(dict(view=i, err=err, u8_max=int(du8.max()),
                           u8_pixels=px, cpu_s=cpu_s,
                           hit=float(cpu[..., 3].mean())))
        if not masks or err > 1e-6:
            raise AssertionError(f"[quality] val view {i}: the card's trace "
                                 f"against the CPU's: hit masks equal "
                                 f"{masks}, RGBA max err {err:.3e}")
        if du8.max() > 1 or px > QUALITY_U8_FRAC * size * size:
            raise AssertionError(f"[quality] val view {i}: dataset u8 "
                                 f"pixels against the CPU trace: {px} "
                                 f"differ, by up to {int(du8.max())}")
    print(f"[quality] ray-traced castle {QUALITY_TRAIN} + {QUALITY_VAL} "
          f"views {size}x{size}: traced on the card in "
          f"{secs['trace_s']:.2f} s, PNG encode and zip "
          f"{secs['encode_s']:.2f} s ({os.path.getsize(src)} bytes), "
          f"load_dataset {load_s:.2f} s; against the CPU tracer: "
          + "; ".join(f"val {c['view']} RGBA max err {c['err']:.3e}, hit "
                      f"masks equal ({c['hit']:.4f} hit), u8 pixels "
                      f"differing {c['u8_pixels']} (by up to "
                      f"{c['u8_max']}), CPU trace {c['cpu_s']:.2f} s"
                      for c in checks))
    return dict(src=src, ds=ds, trace_s=secs["trace_s"],
                encode_s=secs["encode_s"], checks=checks)


def quality_harvests(ds) -> dict:
    """The 16-view harvest of each model of QUALITY_ANCHORS on ds's val
    views (scripts/torch_harvest.py's harvest: eval_view at block 512, the
    pool grown until nothing drops), its means within QUALITY_PSNR_TOL and
    QUALITY_SSIM_TOL of the JAX package's recorded harvest, no record
    dropped."""
    import torch
    from brush_tpu_torch.datasets.ply import load_splats_from_ply

    harvest = load_script(HARVEST_SCRIPT).harvest
    views = [(v.camera, v.image) for v in ds.eval.views]
    out = {}
    for name, (psnr_want, ssim_want) in QUALITY_ANCHORS.items():
        t0 = time.perf_counter()
        with open(os.path.join(ROOT, "docs", name), "rb") as f:
            splats = load_splats_from_ply(f.read(), device="cuda")
        evals, _ = harvest(splats, views, keep=0)
        torch.cuda.synchronize()
        psnr = float(np.mean([e.psnr for e in evals]))
        ssim = float(np.mean([e.ssim for e in evals]))
        dropped = sum(e.dropped for e in evals)
        out[name] = dict(psnr=psnr, ssim=ssim, splats=splats.n_live,
                         dropped=dropped,
                         pool=max(e.pool or 0 for e in evals) or "default",
                         views=[round(e.psnr, 3) for e in evals],
                         seconds=time.perf_counter() - t0)
        print(f"[quality] harvest {name} ({splats.n_live} splats, "
              f"{len(evals)} val views): MEAN PSNR {psnr:.3f} SSIM "
              f"{ssim:.4f} (JAX package {psnr_want:.3f} / {ssim_want:.4f}: "
              f"{psnr - psnr_want:+.4f} dB, {ssim - ssim_want:+.5f}); per "
              f"view {out[name]['views']}; dropped {dropped}, pool "
              f"{out[name]['pool']}; {out[name]['seconds']:.1f} s")
        if dropped or len(evals) != QUALITY_VAL:
            raise AssertionError(f"[quality] harvest {name}: {dropped} "
                                 f"records dropped over {len(evals)} views")
        if not (abs(psnr - psnr_want) <= QUALITY_PSNR_TOL
                and abs(ssim - ssim_want) <= QUALITY_SSIM_TOL):
            raise AssertionError(f"[quality] harvest {name}: PSNR {psnr:.4f}"
                                 f" SSIM {ssim:.5f} against {psnr_want} / "
                                 f"{ssim_want}")
        del splats
    return out


def quality_phase(smi: str) -> dict:
    """Phase 13, "quality" (see the module docstring): the ray-traced
    castle traced on the card and held to the CPU tracer, the three
    harvests against their JAX anchors, and `cli train` for QUALITY_ITERS
    steps to docs/RESULTS.md's command, evaluated on all val views every
    QUALITY_EVAL_EVERY steps and at the end, its kernels counted and held
    to their plain versions on the first step after the opacity reset.
    Returns that check's fields (train_kernels), the launches, the evals
    and the seconds."""
    import torch
    from brush_tpu_torch import eval as eval_mod
    from brush_tpu_torch.ops.cuda import build
    from brush_tpu_torch.utils.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="brush_quality_") as d:
        tr = quality_trace(d)
        harvests = quality_harvests(tr["ds"])
        del tr["ds"]
        torch.cuda.empty_cache()

        ck = os.path.join(d, "ckpt")
        last_eval = max(QUALITY_JAX_PSNR)   # also checkpointed
        log, steps, renders, evals = [], [], [], []
        armed, kept = [False], {}
        after_reset = QUALITY_RESET_STEP + 1

        def arm(trainer, state):
            armed[0] = trainer.iter == after_reset

        def keep(trainer, it):
            if armed[0]:
                kept.update(seen)
                armed[0] = False

        build.reset_launch_counts()
        t_train = time.perf_counter()
        with kept_kernel_args(armed) as seen, \
                step_timer(steps, arm, keep), \
                wrapped(eval_mod, "render_splats", lambda *a: None,
                        lambda t, out, *a, **k: renders.append(
                            int(out[1].num_dropped))), \
                wrapped(eval_mod, "eval_view", lambda *a: None,
                        lambda t, out, *a, **k: evals.append(out.dropped)):
            text = run_cli([
                "train", "--source", tr["src"], "--iters",
                str(QUALITY_ITERS), "--sh-degree", "3", "--init-count",
                "32768", "--block-size", "512", "--eval-every",
                str(QUALITY_EVAL_EVERY), "--checkpoint-dir", ck,
                "--checkpoint-every", str(last_eval)], log)
        train_s = time.perf_counter() - t_train
        counts = build.launch_counts()
        ms = event_ms(steps)
        rows = read_jsonl(os.path.join(ck, "metrics.jsonl"))
        final = [float(v) for v in text_field(
            text, r"final eval: PSNR (\S+) SSIM (\S+)")]
        finite = {}
        for tag, name in ((last_eval, f"ckpt_{last_eval:07d}.npz"),
                          (QUALITY_ITERS, "ckpt_final.npz")):
            state, _, _, _ = load_checkpoint(os.path.join(ck, name), "cuda")
            finite[tag] = all(bool(torch.isfinite(v).all())
                              for v in state.splats.params().values())
            del state
    losses = {r["step"]: r["loss"] for r in rows if "loss" in r}
    psnr = {r["step"]: r["eval_psnr"] for r in rows if "eval_psnr" in r}
    ssim = {r["step"]: r["eval_ssim"] for r in rows if "eval_ssim" in r}
    live = {r["step"]: r["splats"] for r in rows if "splats" in r}
    refines = {r["step"]: {k[7:]: v for k, v in r.items()
                           if k.startswith("refine_")}
               for r in rows if "refine_cloned" in r}
    psnr[QUALITY_ITERS], ssim[QUALITY_ITERS] = final
    n_evals = QUALITY_VAL * (len(psnr))
    retries = sum(1 for x in renders if x)
    step_ms = statistics.median(ms)
    around = {s: round(losses[s], 5) for s in sorted(losses)
              if QUALITY_RESET_STEP - 31 <= s <= QUALITY_RESET_STEP + 39
              or QUALITY_RESET_STEP + 89 <= s <= QUALITY_RESET_STEP + 129}
    prune = refines.get(QUALITY_RESET_STEP + 100, {})
    print(f"[quality] cli train {QUALITY_ITERS} steps (--sh-degree 3 "
          f"--init-count 32768 --block-size 512, eval of all "
          f"{QUALITY_VAL} val views every {QUALITY_EVAL_EVERY} and at the "
          f"end): eval PSNR {psnr}, SSIM {ssim} (JAX r5_castle_fixed "
          f"{QUALITY_JAX_PSNR}; the exact scan's {QUALITY_EXACT_PSNR}); "
          f"live splats {live.get(last_eval)} at "
          f"{last_eval}, {live.get(QUALITY_RESET_STEP + 109)} after the "
          f"prune at {QUALITY_RESET_STEP + 100} ({prune}), "
          f"{live.get(QUALITY_ITERS - 10)} at {QUALITY_ITERS - 10}; refine "
          f"at {QUALITY_RESET_STEP} (the reset) "
          f"{refines.get(QUALITY_RESET_STEP)}; losses around the reset "
          f"{around}; median step {step_ms:.3f} ms (CUDA events), "
          f"{len(steps) / train_s:.2f} steps/s over the command (host "
          f"clock, evals and checkpoints in it); launches {counts} ("
          f"{len(renders)} eval renders, {retries} retried in a grown "
          f"pool); parameters finite at {last_eval} and {QUALITY_ITERS}: "
          f"{finite}")
    bad = [s for s, x in losses.items() if not np.isfinite(x)]
    if len(steps) != QUALITY_ITERS or len(losses) != QUALITY_ITERS // 10 \
            or bad:
        raise AssertionError(f"[quality] cli train: {len(steps)} steps, "
                             f"{len(losses)} logged losses, non-finite at "
                             f"{bad[:10]}")
    if not all(finite.values()):
        raise AssertionError(f"[quality] non-finite parameters: {finite}")
    if sorted(psnr) != [*sorted(QUALITY_JAX_PSNR), QUALITY_ITERS] \
            or not np.isfinite(psnr[QUALITY_ITERS]) or any(
            not psnr[s] >= p - QUALITY_GAP_DB
            for s, p in QUALITY_JAX_PSNR.items()):
        raise AssertionError(f"[quality] eval PSNR {psnr} against the JAX "
                             f"run's {QUALITY_JAX_PSNR} less "
                             f"{QUALITY_GAP_DB} dB")
    if len(evals) != n_evals or any(evals):
        raise AssertionError(f"[quality] {len(evals)} eval views (want "
                             f"{n_evals}), dropped after pool growth "
                             f"{[x for x in evals if x]}")
    if QUALITY_RESET_STEP not in refines:
        raise AssertionError(f"[quality] no refine at {QUALITY_RESET_STEP}: "
                             f"{sorted(refines)}")
    if counts != {"expand": QUALITY_ITERS + len(renders),
                  "rasterize_fwd": QUALITY_ITERS + len(renders),
                  "rasterize_bwd": QUALITY_ITERS,
                  "segment_sum": QUALITY_ITERS,
                  "tile_pretest": QUALITY_ITERS + len(renders),
                  "sh_color_fwd": QUALITY_ITERS + len(renders),
                  "sh_color_bwd": QUALITY_ITERS,
                  "project_fwd": QUALITY_ITERS + len(renders),
                  "project_bwd": QUALITY_ITERS}:
        raise AssertionError(f"[quality] launches {counts}: not one a step "
                             f"and one an eval render ({len(renders)})")
    if kept_names(kept) != sorted(build.KERNELS):
        raise AssertionError(f"[quality] kept {sorted(kept)} at "
                             f"{after_reset}")
    tk = train_kernels({f"step {after_reset}, the first after the "
                        f"reset": kept}, "quality")
    scan_ratio(kept["rasterize_fwd"], kept["rasterize_bwd"][4],
               kept["rasterize_fwd kw"], f"Q (step {after_reset})")
    del kept, seen
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[quality] phase {seconds:.1f} s (trace {tr['trace_s']:.2f} s, "
          f"train command {train_s:.1f} s); {smi}")
    return dict(kernels=tk, launches=counts, harvests=harvests, psnr=psnr,
                ssim=ssim, step_ms=step_ms, trace_s=tr["trace_s"],
                seconds=seconds)


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
    import argparse

    import torch

    global SAVE_ARGS_DIR
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save-kernel-args", metavar="DIR", help="save the "
                    "bench training's, the training at CELL's and the cli "
                    "run's last rasterize_bwd and segment_sum arguments "
                    "into DIR (for scripts/torch_kernel_variants.py "
                    "--args-file)")
    SAVE_ARGS_DIR = ap.parse_args().save_kernel_args
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
    check_raster_hand_cells()
    check_bwd_hand()
    check_expand_hand()
    pretest = pretest_phase(smi)
    torch.cuda.empty_cache()
    sh_times = sh_phase(smi)
    torch.cuda.empty_cache()
    proj_times = projection_phase(smi)
    splats, cp, size, k = kernel_phase(BENCH, "bench", backward=False,
                                       reach=True)
    render_counts, img_1, records_1, render_ms = main_path(splats, cp, size,
                                                          BENCH)
    render_times = {(1, 1): forward_times(k, "bench render inputs")}

    # The bench render at raster cell CELL: the kernels against their
    # plain versions on its inputs, its records beside (1, 1)'s, its image
    # against (1, 1)'s, the median render, the kernels' times and bounds.
    t_c = time.perf_counter()
    kc = dict(kernel_inputs(splats, cp, size, BENCH["pool"], CELL))
    kc["pretest_plain_ms"] = check_pretest(kc["pt_args"],
                                           f"bench cell {CELL}")
    kc["expand_plain_ms"] = check_expand(kc["exp_args"])
    kc["fwd"] = check_raster(kc["r_args"], reach=True)
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
          f"{kc['fwd']['active']}{reach_note(kc['fwd'])}; the image against "
          f"(1, 1)'s: pixels that "
          f"differ {d['differ']}, beyond 1e-5 {d['flips']} (largest there "
          f"{d['flip_err']:.3e}), largest elsewhere {d['err']:.3e}; "
          f"{time.perf_counter() - t_c:.1f} s")
    render_times[CELL] = forward_times(
        kc, f"bench render inputs at cell {CELL}")
    bench_img = img_1.cpu()      # phase 3's image, for "xla", "aligned"
    bench_fwd = {key: k["fwd"][key] for key in ("pairs", "active")}
    del k, kc, img_1, img_c
    torch.cuda.empty_cache()
    strips = strip_phase(splats, cp, size)
    del splats
    torch.cuda.empty_cache()

    castle, cams, gts, castle_pool = castle_phase()
    castle_kernels(castle, cams, castle_pool)
    castle_cells(castle, cams, gts, castle_pool)
    torch.cuda.empty_cache()

    # Training, at (1, 1) and at CELL; the kernels against their plain
    # versions on the arguments of the capacity each run ends at.
    counts, step_ms, window_ms, kept, records, final = train_path(BENCH)
    last = max(kept)
    tk = train_kernels({f"capacity {last}": kept[last]}, reach=False)
    scan = scan_phase(kept[last], "T", tk)
    scan_attrs()
    scan_hand()
    del kept
    torch.cuda.empty_cache()
    shard_counts, shard_ms = sharded_path(BENCH, final)
    del final
    torch.cuda.empty_cache()
    counts_c, step_ms_c, window_ms_c, kept, records_c, _ = train_path(
        BENCH, CELL)
    last = max(kept)
    tk_c = train_kernels({f"capacity {last}, cell {CELL}": kept[last]},
                         f"train cell {CELL}", reach=False)
    scan.update(scan_phase(kept[last], f"{CELL[0]}x{CELL[1]} T", tk_c))
    print(f"[train cell {CELL}] records a step {records_c} ((1, 1): "
          f"{records}); metric {step_ms_c:.3f} ms ((1, 1): {step_ms:.3f}); "
          f"window {window_ms_c:.3f} ms ((1, 1): {window_ms:.3f})")
    del kept
    torch.cuda.empty_cache()
    castle_training(castle, cams, gts)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="brush_cli_") as d:
        cli_counts, cli_tk, cli_data = cli_phase(castle, castle_pool, d)
        del castle
        torch.cuda.empty_cache()
        view_counts = viewer_phase(cli_data, d)
    torch.cuda.empty_cache()
    xla = xla_phase(gts, castle_pool, bench_img, smi)
    torch.cuda.empty_cache()
    aligned = aligned_phase(bench_img, records_1, bench_fwd, smi)
    torch.cuda.empty_cache()
    scale = scale_phase(smi)
    torch.cuda.empty_cache()
    quality = quality_phase(smi)
    profiler_check()

    def row(name, src, replaces):
        def fields(t):
            lib = name == "segment_sum"
            return {"max_abs_err": t["err"][name], "ms": t["ms"][name],
                    "device_ms": t["device"][name],
                    "plain_ms": t["plain"][name],
                    "bound_ms": t["bound"][name][0],
                    "bound_by": t["bound"][name][1],
                    "library_ms": t["library"] if lib else None,
                    "library_device_ms": t["library_device"] if lib
                    else None,
                    **({"reach_bound_ms": t["bound"][f"{name}_reach"][0]}
                       if f"{name}_reach" in t["bound"] else {})}

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
        if name in render_times[CELL]:
            # "render": the same fields on the bench render's inputs, at
            # (1, 1) and at CELL ("ms" the wrapper's, "device_ms" the
            # device's).
            out["render"] = {f"{c[0]}x{c[1]}": render_times[c][name]
                             for c in ((1, 1), CELL)}
        # "scale": the same fields on the "scale" phase's probe step
        # (launches: that step's).
        out["scale"] = {
            **fields(scale["kernels"]), "launches": scale["launches"][name],
            "from": f"scale phase: scripts/torch_probe_5m.py's step, "
                    f"{SCALE_MILLIONS} M splats, SH 3, "
                    f"{SCALE_SIZE}x{SCALE_SIZE}"}
        # "quality": the same fields on the quality phase's arguments of
        # the first step after the opacity reset; launches: its cli train
        # run's, its eval renders included.
        out["quality"] = {
            **fields(quality["kernels"]),
            "launches": quality["launches"][name],
            "from": f"quality phase: cli train on the ray-traced castle "
                    f"({QUALITY_ITERS} steps and its eval renders), "
                    f"arguments of {quality['kernels']['when']}"}
        if name == "tile_pretest":
            # "bicycle": the same fields on the bicycle-5m draw's views
            # (pretest_phase).
            out["bicycle"] = {**pretest, "from": f"pretest phase: the "
                              f"bicycle-5m configuration's scene, seed "
                              f"{PRETEST_SEED}"}
        if name.startswith("project"):
            # "bicycle": projection_phase's fields at PROJ_ROWS rows.
            tag = name[-3:]
            out["bicycle"] = {
                **{f"{n}": proj_times[f"{tag} {n}"] for n in PROJ_ROWS},
                "from": f"projection phase: the bicycle-5m configuration's "
                        f"draw, seed {PROJ_SEED}, and {PROJ_ROWS[1]} drawn "
                        f"rows, {PROJ_DENSIFY_LIVE:.2%} active"}
        if name.startswith("sh_color"):
            # "bicycle": sh_phase's fields at SH_ROWS rows of 16.
            tag = name[-3:]
            out["bicycle"] = {
                **{f"{n}": sh_times[f"{tag} {n}"] for n in SH_ROWS},
                "from": f"sh phase: the bicycle-5m configuration's draw, "
                        f"seed {SH_SEED}, and {SH_ROWS[1]} drawn rows"}
        if name in view_counts:
            out["viewer"] = {
                "launches": view_counts[name],
                "from": f"the viewer phase's 8 /api/frame requests (4 castle "
                        f"views at {CASTLE_SIZE}x{CASTLE_SIZE} and "
                        f"{PAGE_SIZE[0]}x{PAGE_SIZE[1]}), no worker running"}
        if name in aligned["kernels"]:
            # "aligned": the "aligned" phase's fields on the records of
            # build_intersections(align=ALIGN_LANES), launches its calls'.
            out["aligned"] = {
                "align": ALIGN_LANES, **aligned["kernels"][name],
                "from": "make_pallas_rasterizer: castle view 0 with "
                        "gradients; bench render inputs, no gradients"}
        if name.startswith("rasterize"):
            # "scan": the truncated log-T scan (scan_passes=2) beside the
            # exact one, on the bench training's last arguments (T), at
            # CELL (its own k_lanes) and on a strip of T's cells; the
            # fields as above, each timed in turns in the scan phase.
            out["scan"] = {
                tag: {key: v for key, v in rows[name].items()
                      if not key.endswith("_all")}
                for tag, rows in scan.items()}
            # "cell": the same fields on the bench training's arguments at
            # raster cell CELL; launches: that run's.
            out["cell"] = {"cell": list(CELL), **fields(tk_c),
                           "launches": counts_c[name],
                           "from": f"bench training arguments, "
                                   f"{tk_c['when']}"}
            # "strip": per strip of STRIPS, the strip phase's fields on
            # the bench render's inputs at (1, 1) and at CELL; launches:
            # the sharded bench training's (one strip a step).
            key = "fwd" if name == "rasterize_fwd" else "bwd"
            out["strip"] = {
                "strips": STRIPS, "launches": shard_counts[name],
                "launches_from": f"sharded bench training, world size 1, "
                                 f"{TRAIN_STEPS} steps",
                **{tag: {"cell": list(c),
                         "records": strips[c]["records"],
                         "pool": strips[c]["pool"],
                         "ms": [x["ms"] for x in strips[c][key]],
                         "frame_ms": strips[c]["frame_ms"][name],
                         "plain_ms": [x["plain_ms"] for x in strips[c][key]],
                         "bound_ms": [x["bound"][0] for x in strips[c][key]],
                         "bound_by": [x["bound"][1] for x in strips[c][key]],
                         "max_abs_err": [x["err"] for x in strips[c][key]]}
                   for tag, c in (("tiles", (1, 1)), ("cells", CELL))},
                "from": "bench render inputs, a strip's own arguments"}
        return out

    kernels = [
        row("expand", "expand", "brush_tpu/ops/pallas/expand.py:374"),
        row("rasterize_fwd", "rasterize_fwd",
            "brush_tpu/ops/pallas/rasterize_fwd.py:500"),
        row("rasterize_bwd", "rasterize_bwd",
            "brush_tpu/ops/pallas/rasterize_bwd.py:414"),
        row("segment_sum", "segsum", "brush_tpu/ops/pallas/segsum.py:136"),
        row("tile_pretest", "tile_pretest",
            "none (brush_tpu/ops/binning.py:186, plain XLA)"),
        row("sh_color_fwd", "sh", "none (brush_tpu/ops/sh.py, plain XLA)"),
        row("sh_color_bwd", "sh", "none (brush_tpu/ops/sh.py, plain XLA)"),
        row("project_fwd", "projection",
            "none (brush_tpu/ops/projection.py, plain XLA)"),
        row("project_bwd", "projection",
            "none (brush_tpu/ops/projection.py, plain XLA)"),
    ]
    print(f"[summary] render path launches {render_counts}, at cell {CELL} "
          f"{cell_counts}; training path launches {counts}, at cell {CELL} "
          f"{counts_c}; cli train ({CLI_ITERS} steps) launches "
          f"{cli_counts}; sharded training (world size 1) launches "
          f"{shard_counts}; viewer frames launches {view_counts}; bench "
          f"render {render_ms:.3f} ms, at cell {CELL} "
          f"{cell_ms:.3f}; bench train step {step_ms:.3f} ms (median of "
          f"{METRIC_STEPS} warm steps at the final capacity), at cell {CELL} "
          f"{step_ms_c:.3f}, sharded at world size 1 {shard_ms:.3f}; the "
          f"{TRAIN_STEPS}-step window {window_ms:.3f} "
          f"ms, at cell {CELL} {window_ms_c:.3f}; XLA backend (no "
          f"kernel but the tile pretest, the SH and the projection pairs): "
          f"bench render "
          f"{xla['bench_ms']['xla']:.3f} ms against "
          f"the pipeline's {xla['bench_ms']['pallas']:.3f}, peak "
          f"{xla['bench_peak_mib'][0]:.1f} MiB against "
          f"{xla['bench_peak_mib'][1]:.1f}, sharded castle step "
          f"{xla['shard_ms']:.3f} ms, phase {xla['seconds']:.1f} s; "
          f"aligned records: bench rasterize_fwd "
          f"{aligned['bench_ms']['aligned']:.4f} ms against the pipeline's "
          f"{aligned['bench_ms']['pipeline']:.4f}, k-NN of 1M points "
          f"{aligned['knn_s']['native_1m']:.3f} s, phase "
          f"{aligned['seconds']:.1f} s; scale ({SCALE_MILLIONS} M splats, "
          f"SH 3, {SCALE_SIZE}x{SCALE_SIZE}): probe step "
          f"{scale['probe_ms']:.3f} ms, peak {scale['probe_peak_mib']:.1f} "
          f"MiB, SplatTrainer step {scale['train_ms']:.3f} ms, peak "
          f"{scale['train_peak_mib']:.1f} MiB, phase "
          f"{scale['seconds']:.1f} s; quality (ray-traced castle): "
          f"harvests " + ", ".join(
              f"{n} {h['psnr']:.3f} / {h['ssim']:.4f}"
              for n, h in quality["harvests"].items())
          + f", cli train eval PSNR {quality['psnr']}, step "
          f"{quality['step_ms']:.3f} ms, phase {quality['seconds']:.1f} s; "
          f"total "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
