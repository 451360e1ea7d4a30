#!/usr/bin/env python3
"""Where the time of one inference render and of one training step goes,
on an NVIDIA GPU.

Drives the bench scene of chip_smoke.py (1M random splats, SH degree 1,
1024x1024, black ground truth) through the port's own entry points with
their stage marks recorded (brush_tpu_torch/utils/profiler.py) and prints:
  - each stage's median over 10 render_splats(needs_grad=False) calls
    (pool 2162688) after 2 warm-ups, and over 8 SplatTrainer steps (the
    default config: no refine) after one more, at capacity 1M and at the
    4M that chip_smoke.py's training run ends at; and both again at raster
    cell CELL (2, 2) (render_splats(cell=), SplatTrainer(raster_cell=));
    and the 4M steps again through parallel.ShardedTrainer at world size
    1 over NCCL (the column "sharded at 4194304");
  - that training run (warmup 1, refine every 3) step by step: the
    capacity, the step's ms and its refine's ms;
  - a torch.profiler table of device time by kernel over 5 renders, and
    over 3 trainer steps at capacity 4M, with the device's busy share of
    each window;
  - the same for the step of chip_smoke.py's "cli" training run: the
    CLI's random init (10,000 splats, SH degree 3, capacity 16384, seed
    42) in the camera bounds of the NeRF castle's 100 training views
    (brush_tpu_torch/datasets/testing.py's orbit), block 512, an 800x800
    RGBA ground truth, the views in turn; stage medians over 8 steps after
    12 (the intersection pool has grown by then) and a profile of 5;
  - the same for a model at a real size: the trained castle
    (docs/castle_r5_30k.ply, 90,977 splats, SH degree 3) on those views,
    the column "castle step".
A stage's time is the stream time between its mark and the one before:
its kernels and the host's gaps between their launches, so the stages of
a step sum to the whole step. The full profiler tables are written to
OUT_DIR/torch_{render,train,cli,castle}_profile.txt (default runs/).

    python3 scripts/torch_render_profile.py [OUT_DIR]
"""

import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from brush_tpu_torch.camera import Camera  # noqa: E402
from brush_tpu_torch.config import TrainConfig  # noqa: E402
from brush_tpu_torch.ops.rasterize_reference import camera_params  # noqa: E402
from brush_tpu_torch.parallel import (  # noqa: E402
    ShardedTrainer, make_mesh, multihost,
)
from brush_tpu_torch.parallel.sharding import shard_state  # noqa: E402
from brush_tpu_torch.render import render_splats  # noqa: E402
from brush_tpu_torch.splats import from_random  # noqa: E402
from brush_tpu_torch.train import SceneBatch, SplatTrainer  # noqa: E402
from brush_tpu_torch.utils import profiler  # noqa: E402

N, SIZE, POOL, BLOCK = 1 << 20, 1024, 2162688, 512
GROWTH_STEPS = 6
CELL = (2, 2)


def stage_medians(fn, reps: int, warm: int) -> dict:
    """{stage: median ms} over reps recorded calls of fn, after warm."""
    for _ in range(warm):
        fn()
    runs = []
    for _ in range(reps):
        with profiler.record() as stages:
            fn()
        runs.append(stages)
    names = [name for name, _ in runs[0]]
    if any([name for name, _ in r] != names for r in runs):
        raise RuntimeError("the stages differ between calls")
    return {name: statistics.median(r[i][1] for r in runs)
            for i, name in enumerate(names)}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_render_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    splats = from_random(np.random.default_rng(0), [-3] * 3, [3] * 3,
                         count=N, sh_degree=1, capacity=N, device="cuda")
    cam = Camera(position=[0, 0, -8.0], rotation=[1, 0, 0, 0],
                 fov_x=np.pi / 2, fov_y=np.pi / 2)
    size = (SIZE, SIZE)
    cp = camera_params(cam, size, device="cuda")
    batch = SceneBatch(np.zeros((SIZE, SIZE, 3), np.float32), cam)

    def render(cell=(1, 1)):
        return render_splats(
            splats.means, splats.log_scales, splats.quats, splats.sh_coeffs,
            splats.raw_opacity, cp, size, active=splats.active_mask(),
            block_size=BLOCK, max_isects=POOL, cell=cell, needs_grad=False)

    def train_steps(state, cell=(1, 1)):
        """A default trainer (no refine) stepping on from state."""
        trainer = SplatTrainer(raster_cell=cell)
        box = [state]

        def step():
            box[0], _ = trainer.step(box[0], batch)
        return step

    cell_tag = f"cell {CELL[0]}x{CELL[1]}"
    columns = {"render": stage_medians(render, 10, 2),
               f"render {cell_tag}": stage_medians(lambda: render(CELL), 10,
                                                   2)}
    step = train_steps(SplatTrainer().init_state(splats))
    columns[f"train at {N}"] = stage_medians(step, 8, 1)
    del step
    state = growth_run(splats, batch)
    cap = state.splats.capacity
    step = train_steps(state, CELL)
    columns[f"{cap} {cell_tag}"] = stage_medians(step, 8, 1)
    step = train_steps(state)
    columns[f"train at {cap}"] = stage_medians(step, 8, 1)
    with multihost.process_group("cuda"):
        sharded = ShardedTrainer(make_mesh("cuda"))
        box = [shard_state(state, sharded.mesh)]

        def shard_step():
            box[0], _ = sharded.step(box[0], batch)
        columns[f"sharded at {cap}"] = stage_medians(shard_step, 8, 1)
        del box
    print_columns(columns)

    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "runs")
    os.makedirs(out, exist_ok=True)
    profile(render, 5, "render", os.path.join(out,
                                              "torch_render_profile.txt"))
    profile(step, 3, f"train step at {cap}",
            os.path.join(out, "torch_train_profile.txt"))
    del step, state
    torch.cuda.empty_cache()
    step = cli_steps()
    columns = {"cli step": stage_medians(step, 8, 12)}
    profile(step, 5, "cli step", os.path.join(out, "torch_cli_profile.txt"))
    del step
    torch.cuda.empty_cache()
    from brush_tpu_torch.datasets.ply import load_splats_from_ply

    with open(os.path.join(ROOT, "docs", "castle_r5_30k.ply"), "rb") as f:
        step = cli_steps(load_splats_from_ply(f.read(), device="cuda"))
    columns["castle step"] = stage_medians(step, 8, 12)
    print_columns(columns)
    profile(step, 5, "castle step",
            os.path.join(out, "torch_castle_profile.txt"))
    return 0


def cli_steps(splats=None):
    """A step function of the cli phase's training run (see the module's
    docstring), or of `splats` on its views: each call one SplatTrainer
    step on the next view."""
    from brush_tpu_torch.datasets import testing
    from brush_tpu_torch.datasets.nerf import camera_from_transform
    from brush_tpu_torch.datasets.scene import Scene, SceneView

    size = 800
    cams = [camera_from_transform(c, testing.CASTLE_FOV_X, size, size)
            for c in testing.orbit_views(100, seed=1)]
    scene = Scene([SceneView(f"r_{i}", c, None) for i, c in enumerate(cams)])
    _, extent = scene.bounds(0.0, 0.0)
    ext = float(np.linalg.norm(extent))
    c2, e2 = scene.bounds(ext * 0.25, ext)
    if splats is None:
        splats = from_random(np.random.default_rng(42), c2 - e2, c2 + e2,
                             count=10000, sh_degree=3, device="cuda")
    gts = [np.random.default_rng(i).random((size, size, 4), np.float32)
           for i in range(8)]
    trainer = SplatTrainer(raster_block_size=512)
    box = [trainer.init_state(splats), 0]

    def step():
        i = box[1] % len(gts)
        box[0], _ = trainer.step(box[0], SceneBatch(gts[i], cams[i],
                                                    scene.extent_max()))
        box[1] += 1
    return step


def print_columns(columns: dict):
    """One row per stage (in the order the stages first appear), one
    column per table, and each column's sum."""
    names = []
    for col in columns.values():
        names += [n for n in col if n not in names]
    print("[stages] " + f"{'stage':16s}" + "".join(
        f"{c:>20s}" for c in columns))
    for name in names + ["sum"]:
        cells = []
        for col in columns.values():
            v = sum(col.values()) if name == "sum" else col.get(name)
            cells.append(f"{v:20.3f}" if v is not None else f"{'-':>20s}")
        print(f"[stages] {name:16s}" + "".join(cells))


def growth_run(splats, batch):
    """chip_smoke.py's training run (warmup 1, refine every 3): each
    step's capacity, ms and refine ms, and the peak memory. Returns the
    final state."""
    trainer = SplatTrainer(TrainConfig(warmup_steps=1, refine_every=3))
    state = trainer.init_state(splats)
    for it in range(GROWTH_STEPS):
        cap = state.splats.capacity
        with profiler.record() as stages:
            state, _ = trainer.step(state, batch)
        ms = dict(stages)
        refine = f", refine {ms['refine']:.3f} ms" if "refine" in ms else ""
        print(f"[growth] step {it} capacity {cap} -> "
              f"{state.splats.capacity}: {sum(ms.values()):.3f} ms{refine}; "
              f"peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return state


def profile(fn, reps: int, what: str, path: str):
    """torch.profiler over reps calls of fn: wall time, device busy share,
    the top kernels by device time; the full table goes to path."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # Device-side events only (the aten:: host ops carry their kernels'
    # time as well, which would count it twice).
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sorted((d for d in dev if d[1] > 0), key=lambda d: -d[1])
    busy = sum(d[1] for d in dev)
    print(f"[profile] {reps} x {what}: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%)")
    for key, ms, count in dev[:15]:
        print(f"[profile] {ms / reps:9.3f} ms/{what}  x{count // reps:<4d} "
              f"{key[:90]}")
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))


if __name__ == "__main__":
    sys.exit(main())
