"""One rank of the port's sharded tests (tests/test_torch_sharded.py): a
gloo process that imports neither JAX nor brush_tpu.

    python tests/torch_sharded_worker.py SPEC.json RANK

SPEC.json: {"store": file-store path, "world": ranks, "out": directory,
"jobs": [...]}; each job writes <out>/<name>_rank<RANK>.npz (or, for
"cli", what the CLI writes). Jobs:
  step        one make_sharded_train_step (`backend`) at step index
              `step` on a scene (inputs npz: the splat leaves, n_live, gt,
              camera); with "single" also SplatTrainer's step there, in
              this process;
  trainer     ShardedTrainer for `steps` steps; rank 0 also SplatTrainer;
  collectives GatherColumns and GatherStrips, forward and backward;
  multihost   process_view_slice and is_coordinator;
  cli         brush_tpu_torch.cli.main(argv) on the initialized group.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from brush_tpu_torch.camera import Camera  # noqa: E402
from brush_tpu_torch.config import TrainConfig  # noqa: E402
from brush_tpu_torch.convert import splats_from_numpy  # noqa: E402
from brush_tpu_torch.ops.rasterize_reference import (  # noqa: E402
    camera_params,
)
from brush_tpu_torch.parallel import (  # noqa: E402
    ShardedTrainer, make_mesh, make_sharded_train_step, multihost,
)
from brush_tpu_torch.parallel.sharding import (  # noqa: E402
    GatherColumns, GatherStrips, gather_state, shard_state,
)
from brush_tpu_torch.train import SceneBatch, SplatTrainer  # noqa: E402

PARAMS = ("means", "sh_coeffs", "quats", "raw_opacity", "log_scales")


def scene(job):
    with np.load(job["inputs"]) as z:
        d = {k: z[k] for k in z.files}
    splats = splats_from_numpy({k: d[k] for k in PARAMS}, int(d["n_live"]),
                               device="cpu")
    cam = Camera(position=d["position"], rotation=d["rotation"],
                 fov_x=float(d["fov"]), fov_y=float(d["fov"]))
    return splats, d["gt"], cam, TrainConfig(**job["config"])


def state_arrays(prefix, state, stats=None):
    out = {f"{prefix}{k}": v.numpy() for k, v in state.splats.params().items()}
    out[f"{prefix}grad_2d_accum"] = state.grad_2d_accum.numpy()
    out[f"{prefix}xy_grad_counts"] = state.xy_grad_counts.numpy()
    if stats is not None:
        for f in stats._fields:
            out[f"{prefix}{f}"] = np.asarray(float(getattr(stats, f)))
    return out


def run_step(job, mesh):
    splats, gt, cam, cfg = scene(job)
    size = tuple(job["img_size"])
    cp = camera_params(cam, size, device="cpu")
    single = SplatTrainer(cfg, raster_block_size=job["block_size"],
                          raster_cell=tuple(job["cell"]))
    # Beside SplatTrainer, its pool; else the reference's default.
    pool = single._pool_size(splats.capacity) if job["single"] else None
    step = make_sharded_train_step(
        mesh, cfg, splats.capacity, size, gt.shape[2], splats.sh_count,
        max_isects=pool, block_size=job["block_size"],
        backend=job["backend"], cell=tuple(job["cell"]))
    state = shard_state(SplatTrainer(cfg).init_state(splats), mesh)
    state, stats = step(state, torch.tensor(gt), cp.viewmat, cp.focal,
                        cp.pixel_center, cfg.lr_mean_at(job["step"]),
                        job["step"])
    out = state_arrays("", state, stats)
    if job["single"]:
        single.iter = job["step"]
        s1, st1 = single.step(single.init_state(splats), SceneBatch(gt, cam))
        out.update(state_arrays("single_", s1, st1))
    return out


def run_trainer(job, mesh):
    splats, gt, cam, cfg = scene(job)
    batch = SceneBatch(gt, cam)
    out = {}
    runs = [("", ShardedTrainer(mesh, cfg, raster_block_size=16))]
    if mesh.rank == 0:
        runs.append(("single_", SplatTrainer(cfg, raster_block_size=16)))
    for prefix, trainer in runs:
        state = trainer.init_state(splats)
        losses, refines = [], []
        for it in range(job["steps"]):
            state, st = trainer.step(state, batch)
            losses.append(float(st.loss))
            if trainer.last_refine_stats is not None:
                refines.append((it, trainer.last_refine_stats.n_live))
        if prefix == "":
            state = gather_state(state, mesh)
        out.update(state_arrays(prefix, state))
        out[f"{prefix}losses"] = np.asarray(losses)
        out[f"{prefix}refines"] = np.asarray(refines)
        out[f"{prefix}n_live"] = np.asarray(state.splats.n_live)
    return out


def run_collectives(mesh):
    """Each rank's (3, 4) columns hold rank + column / 10; the loss
    sum(w * gathered) has the same w on every rank, so GatherColumns'
    backward must give each rank the sum over ranks of its columns of w,
    and GatherStrips' backward this rank's own strip of w, once."""
    r, n = mesh.rank, mesh.size
    x = (r + torch.arange(12.0).reshape(3, 4) / 10).requires_grad_(True)
    w = torch.arange(3.0 * 4 * n).reshape(3, 4 * n)
    (GatherColumns.apply(x, mesh) * w).sum().backward()
    strip = (r + torch.arange(6.0).reshape(2, 3)).requires_grad_(True)
    ws = torch.arange(2.0 * 3 * n).reshape(2 * n, 3)
    gathered = GatherStrips.apply(strip, mesh)
    (gathered * ws).sum().backward()
    return dict(columns_grad=x.grad.numpy(), strips=gathered.detach().numpy(),
                strips_grad=strip.grad.numpy())


def main():
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    multihost.initialize(f"file://{spec['store']}", spec["world"], rank,
                         device="cpu")
    mesh = make_mesh("cpu")
    for job in spec["jobs"]:
        kind = job["kind"]
        if kind == "cli":
            from brush_tpu_torch import cli

            cli.main(job["argv"])
            continue
        if kind == "step":
            out = run_step(job, mesh)
        elif kind == "trainer":
            out = run_trainer(job, mesh)
        elif kind == "collectives":
            out = run_collectives(mesh)
        elif kind == "multihost":
            view = multihost.process_view_slice(job["views"])
            out = dict(view=np.asarray([view.start, view.stop]),
                       coordinator=np.asarray(multihost.is_coordinator()))
        np.savez(os.path.join(spec["out"], f"{job['name']}_rank{rank}.npz"),
                 **out)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "brush_tpu"))
    if bad:
        raise SystemExit(f"the worker imported {bad}")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
