#!/usr/bin/env python3
"""Bicycle-scale probe on an NVIDIA GPU: forward, backward and Adam of
5.24M splats at SH degree 3 on one card, the port's counterpart of
scripts/probe_5m.py (BASELINE.md's "bicycle full-res, ~5M splats, one
host"), step for step; then the training step at that scale.

The scene (make_scene): from_random(rng(0)) in [-4, 4]^3, every splat
live, SH degree 3 (48 coefficients a splat), every log scale log(0.01) so
that the record count stays bicycle-like, the camera at (0, 0, -10) with
a 90 degree field of view, a black ground truth; the pool 2n rounded up to
1024 (probe_pool). The step (probe_step): render_splats(block_size=512)
with gradients, L1 on RGB, backward, Adam with the probe's learning rates
(LRS). The script prints the memory budget, the first step (seconds,
loss, records, drops), the median of 8 steps on FIXED parameters (each
between two CUDA events, ended by a synchronise; scripts/probe_5m.py's
method), and the peak of torch.cuda.max_memory_allocated().

Then the main path at this scale (trainer_run): a SplatTrainer with the
default TrainConfig (no refine in its first 500 steps) from its own
default pool, up to DEFAULT_POOL_STEPS steps, showing where the pool's
doubling on drops ends (ROADMAP Queue 3 #15: at 2^24, which expand
refuses); and one whose pool is set to the probe's before its first step,
TRAINER_STEPS steps: each step's launches of the four kernels, records,
drops (none allowed), loss, the median step, the stage medians and the
peak memory. Last the card's name and power limit.

    python3 scripts/torch_probe_5m.py [n_millions=5.0] [img_size=1248]

It needs a CUDA device and exits non-zero without one. The scene, the
step and the budget take a device, so tests run them on the CPU at a
small size.
"""

import contextlib
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brush_tpu_torch.camera import Camera  # noqa: E402
from brush_tpu_torch.ops.cuda import (  # noqa: E402
    expand, rasterize_bwd, rasterize_fwd, segsum,
)
from brush_tpu_torch.ops.rasterize_reference import camera_params  # noqa: E402
from brush_tpu_torch.optim import adam_step, init_adam  # noqa: E402
from brush_tpu_torch.render import render_splats  # noqa: E402
from brush_tpu_torch.splats import from_random  # noqa: E402
from brush_tpu_torch.train import SceneBatch, SplatTrainer  # noqa: E402
from brush_tpu_torch.utils import profiler  # noqa: E402

# scripts/probe_5m.py:73-74.
LRS = {"means": 1.6e-4, "raw_opacity": 5e-2, "sh_coeffs": 4e-3,
       "quats": 2e-3, "log_scales": 1e-2}
BLOCK = 512
LOG_SCALE = float(np.log(0.01))
FIXED_STEPS = 8
DEFAULT_POOL_STEPS = 4
TRAINER_STEPS = 5
KERNELS = {"expand": expand, "rasterize_fwd": rasterize_fwd,
           "rasterize_bwd": rasterize_bwd, "segment_sum": segsum}


def splat_count(n_millions: float) -> int:
    return int(n_millions * (1 << 20))


def probe_pool(n: int) -> int:
    """scripts/probe_5m.py's pool: 2n rounded up to 1024."""
    return -(-2 * n // 1024) * 1024


def budget_gb(n: int, max_isects: int) -> tuple:
    """scripts/probe_5m.py's budget in GiB: parameters, gradients and both
    Adam moments (59 float32 a splat, four times), and the pool's records,
    keys, sorted copies and gradient rows (about 56 words a slot)."""
    return n * 59 * 4 * 4 / 2**30, max_isects * 56 * 4 / 2**30


def make_scene(n: int, size: int, device):
    """(splats, camera, camera parameters, black (size, size, 3) ground
    truth) on `device`."""
    splats = from_random(np.random.default_rng(0), [-4] * 3, [4] * 3,
                         count=n, sh_degree=3, capacity=n, device=device)
    splats = splats.replace(
        log_scales=torch.full_like(splats.log_scales, LOG_SCALE))
    cam = Camera(position=[0, 0, -10.0], rotation=[1, 0, 0, 0],
                 fov_x=np.pi / 2, fov_y=np.pi / 2)
    cp = camera_params(cam, (size, size), device=device)
    gt = torch.zeros((size, size, 3), dtype=torch.float32, device=device)
    return splats, cam, cp, gt


def probe_step(params: dict, opt, cp, img_size, gt, max_isects: int):
    """scripts/probe_5m.py's train_step: render with gradients, L1 on RGB
    against gt, backward, Adam. Returns (params, opt, loss, num_isects,
    num_dropped), the inputs untouched."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    img, aux = render_splats(
        leaves["means"], leaves["log_scales"], leaves["quats"],
        leaves["sh_coeffs"], leaves["raw_opacity"], cp, img_size,
        block_size=BLOCK, max_isects=max_isects)
    loss = torch.mean(torch.abs(img[..., :3] - gt))
    loss.backward()
    new_params, new_opt = adam_step(
        params, {k: v.grad for k, v in leaves.items()}, opt, LRS)
    return (new_params, new_opt, loss.detach(), aux.num_isects,
            aux.num_dropped)


def reset_launches():
    for mod in KERNELS.values():
        mod.launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}


def event_ms(fn):
    """(fn(), the CUDA-event ms around it, ended by a synchronise)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def fixed_step_ms(step, reps: int = FIXED_STEPS) -> list:
    """The ms of `reps` calls of step() on the same inputs."""
    return [event_ms(step)[1] for _ in range(reps)]


def fresh(splats):
    """A copy of the splats' tensors, so that a run leaves them as they
    were."""
    return splats.replace(**{k: v.clone() for k, v in
                             splats.params().items()})


def trainer_run(splats, cam, gt_np, steps: int, pool=None,
                stages: bool = False) -> dict:
    """SplatTrainer (default config) steps on one view from the splats,
    with its pool set to `pool` before the first step (None: its own
    default). Each step's CUDA-event ms, launches of the four kernels, the
    pool it used, records, drops and loss; a step that raises ends the run
    and is recorded under "error". With `stages` each step's stage marks
    too (profiler.record). Returns those lists and the trainer's last
    state. Needs the card (CUDA events)."""
    trainer = SplatTrainer()
    if pool is not None:
        trainer._isect_pool = pool
    state = trainer.init_state(fresh(splats))
    batch = SceneBatch(gt_np, cam)
    out = dict(ms=[], launches=[], pools=[], records=[], dropped=[],
               losses=[], stages=[], error=None)
    for _ in range(steps):
        reset_launches()
        try:
            with (profiler.record() if stages
                  else contextlib.nullcontext([])) as marks:
                (state, st), ms = event_ms(
                    lambda: trainer.step(state, batch))
        except ValueError as e:
            out["pools"].append(trainer._isect_pool)
            out["error"] = str(e)
            break
        out["ms"].append(ms)
        out["launches"].append(read_launches())
        out["pools"].append(trainer._isect_pool)
        out["records"].append(int(st.num_isects))
        out["dropped"].append(int(st.num_dropped))
        out["losses"].append(float(st.loss))
        out["stages"].append(profiler.chain(marks))
    out["state"] = state
    return out


def check_trainer_run(run: dict):
    """The pool-set run's gates: every step one launch of each kernel, no
    record dropped, finite losses and parameters."""
    one = {name: 1 for name in KERNELS}
    if run["error"] or any(c != one for c in run["launches"]):
        raise AssertionError(f"trainer steps: launches {run['launches']}, "
                             f"error {run['error']}")
    if any(run["dropped"]):
        raise AssertionError(f"trainer steps dropped records: "
                             f"{run['dropped']}")
    finite = all(bool(torch.isfinite(v).all())
                 for v in run["state"].splats.params().values())
    if not (finite and all(math.isfinite(x) for x in run["losses"])):
        raise AssertionError("trainer steps: a non-finite loss or param")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def mib(nbytes: int) -> float:
    return nbytes / 2**20


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_m = float(argv[0]) if len(argv) > 0 else 5.0
    size = int(argv[1]) if len(argv) > 1 else 1248
    if not torch.cuda.is_available():
        print("torch_probe_5m: no CUDA device", file=sys.stderr)
        return 1
    n = splat_count(n_m)
    img_size = (size, size)
    max_isects = probe_pool(n)
    print(f"n={n/1e6:.1f}M ({n}) sh=3 img={size}^2 "
          f"pool={max_isects/1e6:.1f}M ({max_isects})", flush=True)
    param_gb, pool_gb = budget_gb(n, max_isects)
    print(f"budget: params+opt+grads {param_gb:.2f} GB, pool ~{pool_gb:.2f} "
          f"GB", flush=True)

    t0 = time.perf_counter()
    splats, cam, cp, gt = make_scene(n, size, "cuda")
    torch.cuda.synchronize()
    print(f"scene: {time.perf_counter() - t0:.1f} s", flush=True)
    params = splats.params()
    opt = init_adam(params)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    _, _, loss, ni, nd = probe_step(params, opt, cp, img_size, gt,
                                    max_isects)
    loss = float(loss)
    first_s = time.perf_counter() - t0
    print(f"first step {first_s:.1f}s loss={loss:.4f} isects={int(ni)} "
          f"dropped={int(nd)} launches={read_launches()}", flush=True)
    times = fixed_step_ms(lambda: probe_step(params, opt, cp, img_size, gt,
                                             max_isects))
    dt = statistics.median(times)
    peak = mib(torch.cuda.max_memory_allocated())
    print(f"train step median {dt:.3f} ms ({1e3 / dt:.2f} it/s) at "
          f"{n/1e6:.1f}M splats (fixed parameters, CUDA events; all ms "
          f"{[round(t, 3) for t in times]}); peak allocated {peak:.1f} MiB",
          flush=True)
    del params, opt
    torch.cuda.empty_cache()

    gt_np = np.zeros((size, size, 3), np.float32)
    run = trainer_run(splats, cam, gt_np, DEFAULT_POOL_STEPS)
    print(f"SplatTrainer from its default pool: pools {run['pools']}, "
          f"records {run['records']}, dropped {run['dropped']}, error "
          f"{run['error']}", flush=True)
    del run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = trainer_run(splats, cam, gt_np, TRAINER_STEPS, pool=max_isects,
                      stages=True)
    check_trainer_run(run)
    step_ms = statistics.median(run["ms"][1:])
    print(f"SplatTrainer at pool {max_isects}: step ms "
          f"{[round(t, 3) for t in run['ms']]}, median after the first "
          f"{step_ms:.3f}; records {run['records']}; dropped "
          f"{run['dropped']}; losses {run['losses']}; launches a step "
          f"{run['launches'][0]}; peak allocated "
          f"{mib(torch.cuda.max_memory_allocated()):.1f} MiB", flush=True)
    marks: dict = {}
    for step_marks in run["stages"][1:]:
        for name, ms in step_marks:
            marks.setdefault(name, []).append(ms)
    print("SplatTrainer stage medians after the first step (stream ms "
          "between stage marks, utils/profiler.py): " + ", ".join(
              f"{name} {statistics.median(v):.3f}"
              for name, v in marks.items()), flush=True)
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
