#!/usr/bin/env python3
"""Scaling of the sharded train step over ranks, the port's counterpart of
scripts/scaling_bench.py (BASELINE.md: >= 80 % efficiency at N >= 2 hosts).

Measures the sharded step of brush_tpu_torch/parallel/ (multihost.initialize,
make_mesh, make_sharded_train_step, shard_state) at world sizes 1, 2, 4, ...
and prints one line a world size: ms a step (the median of --steps steps,
each on the host's clock around work that ends in a read of the loss, the
slowest rank's), it/s and the efficiency against world size 1. Then it
projects the step to n_dev in {1, 2, 4, 8, 16} ranks at strip-pool slack
{2.0, 1.3, 1.0} (project_efficiency, the JAX script's, copied) from stage
buckets measured at world size 1 by the port's stage marks
(utils/profiler.mark), medians of --steps steps:
  proj      record_inputs, and its backward through projection and SH
            ("autograd rest");
  sort_rep  depth_order, and the backward's inverse permutation
            ("to_global");
  pool      expand, tile_bins, rasterize_fwd; rasterize_bwd, grad_resort,
            segment_sum.
The other stages (strip_inputs, assemble, the loss, densify_stats, adam)
are printed beside the buckets and left out of the projection, as the JAX
script leaves them out.

Where it runs:
  - on the card (the default): world size 1 over NCCL, the buckets timed
    by CUDA events (profiler.record). A card is one rank: no larger world
    is measured on one card, and none is faked;
  - under torchrun (its environment set): world sizes 1, 2, 4, ... up to
    torchrun's, each a process group of the first ranks (the full world on
    torchrun's own, the smaller ones at MASTER_PORT + the world size);
  - --cpu N: world sizes 1, 2, 4, ... up to N, in N gloo processes on the
    CPU (this script, started once a rank, one thread each). It checks the
    plumbing only: its ms and buckets are the host's clock
    (profiler.record(host=True)), no device's.

The scene, seeds and config are the JAX script's: from_random(rng(0)), SH
degree 1, in [-3, 3]^3; the camera at z = -8 with a 90 degree field of
view; a uniform ground truth from rng(1); TrainConfig(warmup_steps=0);
block_size 512. Every world size draws its scene anew from rng(0) (the JAX
script draws each size's from where the last one left the generator), so
every world size trains the same model.

    python3 scripts/torch_scaling_bench.py [--cpu N] [--splats M]
        [--size S] [--steps K] [--link-gbps G]
"""

import argparse
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brush_tpu_torch.camera import Camera  # noqa: E402
from brush_tpu_torch.config import TrainConfig  # noqa: E402
from brush_tpu_torch.ops.rasterize_reference import camera_params  # noqa: E402
from brush_tpu_torch.parallel import (  # noqa: E402
    make_mesh, make_sharded_train_step, multihost,
)
from brush_tpu_torch.parallel.sharding import (  # noqa: E402
    all_gather_rows, shard_state,
)
from brush_tpu_torch.splats import from_random  # noqa: E402
from brush_tpu_torch.train import SplatTrainer  # noqa: E402
from brush_tpu_torch.utils import profiler  # noqa: E402

# NVLink 4: 450 GB/s in each direction per H100 (NVIDIA's H100 data sheet,
# 900 GB/s both ways). No machine has measured it for this repository.
NVLINK_GBPS = 450.0
BLOCK = 512
PROJECTED_DEVICES = (1, 2, 4, 8, 16)
PROJECTED_SLACKS = (2.0, 1.3, 1.0)
# The stage marks of the sharded step in each bucket, forward and backward.
BUCKETS = {
    "fwd": {"proj": ("record_inputs",), "sort_rep": ("depth_order",),
            "pool": ("expand", "tile_bins", "rasterize_fwd")},
    "bwd": {"proj": ("autograd rest",), "sort_rep": ("to_global",),
            "pool": ("rasterize_bwd", "grad_resort", "segment_sum")},
}


def project_efficiency(stages_ms: dict, n_dev: int, slack: float,
                       n_splats: int = 1 << 20,
                       ici_gbps: float = NVLINK_GBPS):
    """Analytic N-device projection from measured single-device stage
    buckets (scripts/scaling_bench.py's, the same arithmetic).

    The sharded step's stages scale three ways (parallel/train_step.py):
      - row-sharded (projection, SH, pretest): / n_dev;
      - replicated N-scale (the depth sort and its preparation; the
        backward's inversion to global order): unchanged;
      - pool-scale (expand, tile sort, both rasterizers, grad re-sort,
        segment_sum): x slack / n_dev, each rank's pool holding its
        strip's records with `slack` over-provision, never more than the
        frame's pool;
    plus the link's collectives: the attribute and metadata all-gather (15
    rows of n_splats x 4 B in) and the cotangent reduce-scatter (9 rows),
    at ici_gbps a direction.

    stages_ms: {"fwd": {...}, "bwd": {...}} with the keys proj, sort_rep
    and pool, or one flat dict taken as the forward. Returns {n_dev, t_ms,
    ici_ms, speedup, efficiency} against the one-device bucket sum."""
    def split(d):
        return d.get("proj", 0.0), d.get("sort_rep", 0.0), d.get("pool", 0.0)

    dirs = stages_ms if "fwd" in stages_ms else {"fwd": stages_ms}
    t1 = sum(sum(split(d)) for d in dirs.values())
    ici_ms = 0.0
    if n_dev > 1:
        rows = 15 + (9 if "bwd" in dirs else 0)
        ici_ms = rows * n_splats * 4 * (n_dev - 1) / n_dev / (
            ici_gbps * 1e9) * 1e3
    t_n = ici_ms
    for d in dirs.values():
        proj, rep, pool = split(d)
        t_n += proj / n_dev + rep + pool * min(1.0, slack / n_dev)
    return {
        "n_dev": n_dev,
        "t_ms": round(t_n, 2),
        "ici_ms": round(ici_ms, 2),
        "speedup": round(t1 / t_n, 2) if t_n else None,
        "efficiency": round(t1 / t_n / n_dev, 3) if t_n else None,
    }


def world_sizes(most: int) -> list:
    """1, 2, 4, ... up to `most`."""
    sizes, n = [], 1
    while n <= most:
        sizes.append(n)
        n *= 2
    return sizes


def bucket_ms(stages: dict) -> tuple:
    """Stage medians {name: ms} -> ({"fwd": {...}, "bwd": {...}} buckets,
    {name: ms} of the stages outside them)."""
    buckets = {d: {b: sum(stages.get(s, 0.0) for s in names)
                   for b, names in parts.items()}
               for d, parts in BUCKETS.items()}
    inside = {s for parts in BUCKETS.values() for names in parts.values()
              for s in names}
    return buckets, {k: v for k, v in stages.items() if k not in inside}


def run_world(n: int, rank: int, init: str, device: str, args) -> dict:
    """The sharded step at world size n as rank `rank` (joining the group
    at `init`): a warm step, then args.steps timed steps; at world size 1
    also args.steps recorded steps for the stage medians. Returns (on
    every rank) {"ms": the slowest rank's median, "stages": {name: ms} or
    None}."""
    multihost.initialize(init, n, rank, device=device)
    try:
        mesh = make_mesh(device)
        size = (args.size, args.size)
        config = TrainConfig(warmup_steps=0)
        cam = Camera(position=[0, 0, -8.0], rotation=[1, 0, 0, 0],
                     fov_x=np.pi / 2, fov_y=np.pi / 2)
        cp = camera_params(cam, size, device=mesh.device)
        gt = torch.as_tensor(np.random.default_rng(1).uniform(
            0, 1, size=(args.size, args.size, 3)).astype(np.float32),
            device=mesh.device)
        splats = from_random(np.random.default_rng(0), [-3] * 3, [3] * 3,
                             count=args.splats, sh_degree=1,
                             capacity=args.splats, device="cpu")
        step_fn = make_sharded_train_step(
            mesh, config, args.splats, size, 3, splats.sh_count,
            block_size=BLOCK)
        state = shard_state(SplatTrainer(config).init_state(splats), mesh)
        del splats

        def run(s, i):
            s, stats = step_fn(s, gt, cp.viewmat, cp.focal, cp.pixel_center,
                               config.lr_mean_at(i), i)
            float(stats.loss)   # waits for the step
            return s

        state = run(state, 0)
        times = []
        for i in range(args.steps):
            t0 = time.perf_counter()
            state = run(state, i + 1)
            times.append((time.perf_counter() - t0) * 1e3)
        mine = torch.tensor([statistics.median(times)], dtype=torch.float64,
                            device=mesh.device)
        ms = float(all_gather_rows(mine, mesh).max())
        stages = None
        if n == 1:
            seen: dict = {}
            for i in range(args.steps):
                with profiler.record(host=mesh.device.type != "cuda") as st:
                    state = run(state, args.steps + 1 + i)
                for name, t in st:
                    seen.setdefault(name, []).append(t)
            stages = {k: statistics.median(v) for k, v in seen.items()}
        return {"ms": ms, "stages": stages}
    finally:
        torch.distributed.destroy_process_group()


def report(results: dict, args, device: str, out=sys.stdout):
    """The lines a world size, the buckets and the projection."""
    on = ("the host's clock on the CPU (gloo; plumbing only, not a device "
          "time)" if device == "cpu" else torch.cuda.get_device_name(0))
    rate1 = 1e3 / results[1]["ms"]
    for n, r in sorted(results.items()):
        rate = 1e3 / r["ms"]
        eff = rate / (n * rate1) * 100.0
        print(f"world size {n:2d}  {r['ms']:10.3f} ms/step  {rate:8.2f} it/s"
              f"  scaling efficiency {eff:5.1f}%  ({on})", file=out,
              flush=True)
    buckets, other = bucket_ms(results[1]["stages"])
    total = sum(sum(b.values()) for b in buckets.values())
    clock = ("host ms, profiler.record(host=True)" if device == "cpu"
             else "device stream ms, CUDA events")
    print(f"\nstage buckets at world size 1 ({args.splats} splats, "
          f"{args.size}^2; {clock}; medians of {args.steps} steps): "
          + "; ".join(f"{d} " + ", ".join(f"{b} {v:.3f}" for b, v in
                                          parts.items())
                      for d, parts in buckets.items())
          + f"; sum {total:.3f}; outside the buckets "
          + ", ".join(f"{k} {v:.3f}" for k, v in other.items()),
          file=out, flush=True)
    print(f"analytic projection from these buckets (link {args.link_gbps} "
          f"GB/s a direction; the default is NVLink 4's per H100, NVIDIA's "
          f"data sheet):", file=out, flush=True)
    for nd in PROJECTED_DEVICES:
        for slack in PROJECTED_SLACKS:
            p = project_efficiency(buckets, nd, slack, args.splats,
                                   args.link_gbps)
            print(f"  n_dev={nd:2d} slack={slack}: {p['t_ms']:7.2f} ms "
                  f"(link {p['ici_ms']:5.2f}) speedup {p['speedup']:5.2f} "
                  f"efficiency {p['efficiency']:.0%}", file=out, flush=True)


def rank_main(rank: int, most: int, inits, device: str, args) -> dict:
    """Every world size of `most` ranks this rank belongs to; `inits(n)`
    is the group's init URL at world size n. Returns the results (rank
    0's are whole)."""
    if device == "cpu":
        torch.set_num_threads(1)
    results = {}
    for n in world_sizes(most):
        if rank < n:
            results[n] = run_world(n, rank, inits(n), device, args)
    return results


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="world sizes up to N in N gloo processes on the "
                         "CPU (plumbing only)")
    ap.add_argument("--splats", type=int, default=1 << 17)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--link-gbps", type=float, default=NVLINK_GBPS,
                    help="the interconnect's GB/s a direction in the "
                         "projection (default: NVLink 4 per H100)")
    ap.add_argument("--store", help="a directory for the --cpu ranks' file "
                                    "stores (default: a temporary one)")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if args.rank is not None:
        # One gloo rank of --cpu N, started by the parent below.
        results = rank_main(
            args.rank, args.cpu,
            lambda n: "file://" + os.path.join(args.store, f"store_{n}"),
            "cpu", args)
        if args.rank == 0:
            report(results, args, "cpu")
        return 0
    if args.cpu:
        with tempfile.TemporaryDirectory(prefix="brush_scaling_") as tmp:
            store = args.store or tmp
            base = [sys.executable, os.path.abspath(__file__),
                    "--cpu", str(args.cpu), "--splats", str(args.splats),
                    "--size", str(args.size), "--steps", str(args.steps),
                    "--link-gbps", str(args.link_gbps), "--store", store]
            env = dict(os.environ, OMP_NUM_THREADS="1")
            procs = [subprocess.Popen(base + ["--rank", str(r)], env=env,
                                      stdout=subprocess.PIPE if r else None,
                                      stderr=subprocess.STDOUT if r
                                      else None, text=True)
                     for r in range(args.cpu)]
            logs = [p.communicate()[0] for p in procs]
            bad = [(r, p.returncode, log) for r, (p, log) in
                   enumerate(zip(procs, logs)) if p.returncode]
            for r, rc, log in bad:
                print(f"rank {r} exited {rc}:\n{(log or '')[-4000:]}",
                      file=sys.stderr)
            return 1 if bad else 0
    if all(v in os.environ for v in multihost.TORCHRUN_VARS):
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        addr, port = os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])
        results = rank_main(
            rank, world, lambda n: (None if n == world
                                    else f"{addr}:{port + n}"),
            "cuda", args)
    else:
        if not torch.cuda.is_available():
            print("torch_scaling_bench: no CUDA device (--cpu N runs the "
                  "plumbing on the CPU)", file=sys.stderr)
            return 1
        with tempfile.TemporaryDirectory(prefix="brush_scaling_") as tmp:
            rank = 0
            results = rank_main(0, 1, lambda n: "file://" + os.path.join(
                tmp, f"store_{n}"), "cuda", args)
    if rank == 0:
        report(results, args, "cuda")
        print(smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
