"""The port's sharded training (brush_tpu_torch/parallel/) against
brush_tpu.parallel and against the port's single-device trainer.

The port runs in gloo processes (tests/torch_sharded_worker.py, one a
rank, one thread each, a file store under tmp_path so that parallel
workers never race for a port), which import neither JAX nor brush_tpu
and write npz files that this process compares. The reference's sharded
step runs here on four of the conftest's virtual CPU devices with
backend="pallas_interpret" (and "xla" for the port's XLA path), on the
scenes of tests/test_sharded.py, each computed once for the module.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brush_tpu.camera import Camera as JCamera
from brush_tpu.config import TrainConfig as JTrainConfig
from brush_tpu.ops.rasterize_reference import camera_params as j_cp
from brush_tpu.parallel import make_mesh as j_make_mesh
from brush_tpu.parallel import make_sharded_train_step as j_sharded_step
from brush_tpu.parallel.sharding import shard_state as j_shard_state
from brush_tpu.splats import from_random as j_from_random
from brush_tpu.train import SplatTrainer as JSplatTrainer

from brush_tpu_torch import cli
from brush_tpu_torch.parallel import make_mesh, multihost
from test_torch_cli import TRAIN, nerf_zip, read_metrics  # noqa: F401
from torch_threads import pin_threads

pin_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_sharded_worker.py")
PARAMS = ("means", "sh_coeffs", "quats", "raw_opacity", "log_scales")
FOV = 1.0
CAM = dict(position=[0, 0, -6.0], rotation=[1, 0, 0, 0])

# The scenes of tests/test_sharded.py: (seed, bounds, count, SH degree,
# image, cell). "uneven": 4x3 tiles on 4 ranks, one row a strip, the last
# strip past the image; "imbalanced": every splat in the top-left corner,
# so one strip holds nearly every record; "cells": 5x3 tiles, 3x2 cells
# of (2, 2) on 4 ranks, two strips past the image.
SCENES = {
    "uneven": (2, ([-2] * 3, [2] * 3), 64, 1, (64, 48), (1, 1)),
    "imbalanced": (5, ([-2.0, -2.0, 0], [-1.2, -1.2, 0.5]), 64, 0, (64, 64),
                   (1, 1)),
    "cells": (4, ([-2] * 3, [2] * 3), 64, 1, (80, 48), (2, 2)),
}
# The compared steps: every scene on the strip pipeline (brush_tpu's
# "pallas_interpret"), and the "uneven" scene on the XLA path (replicated
# binning, the tiled rasterizer; brush_tpu's "xla").
CASES = {**{n: (n, "pallas") for n in SCENES}, "uneven_xla": ("uneven",
                                                              "xla")}
# The step index of the compared step: past the warm-up, so that the
# screen-space gradient norms accumulate (at index 0 they are gated off),
# and no refine boundary (index 1 is one), which would zero them.
STEP = 2
WORLD = 4
# Bounds against the reference's sharded step: those of
# tests/test_sharded.py:137-146 (uneven, imbalanced) and :278-290 (cells).
TOLS = {"uneven": (1e-5, 1e-4, 5e-4), "imbalanced": (1e-5, 1e-4, 5e-4),
        "cells": (1e-4, 5e-4, 1e-3), "uneven_xla": (1e-5, 1e-4, 5e-4)}


def write_scene(path, seed, bounds, count, degree, size):
    """The scene as the reference's test makes it (splats, then the gt
    from the same generator): saved for the workers; returns the JAX
    splats and the gt."""
    rng = np.random.default_rng(seed)
    js = j_from_random(rng, *bounds, count=count, sh_degree=degree)
    gt = rng.uniform(0, 1, size=(size[1], size[0], 3)).astype(np.float32)
    np.savez(path, gt=gt, n_live=int(js.n_live), fov=FOV,
             position=np.asarray(CAM["position"]),
             rotation=np.asarray(CAM["rotation"]),
             **{k: np.asarray(v) for k, v in js.params().items()})
    return js, gt


def run_ranks(tmp, world, jobs, timeout=600):
    """Run the jobs on `world` gloo ranks; returns {name: [rank npz]}."""
    out = tmp / "out"
    out.mkdir(exist_ok=True)
    spec = tmp / "spec.json"
    spec.write_text(json.dumps(dict(store=str(tmp / "store"), world=world,
                                    out=str(out), jobs=jobs)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env.update(OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(spec), str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    return {j["name"]: [dict(np.load(out / f"{j['name']}_rank{r}.npz"))
                        for r in range(world)]
            for j in jobs if j["kind"] != "cli"}, logs


def rows(parts, key):
    """The ranks' row blocks of one leaf, in rank order."""
    return np.concatenate([p[key] for p in parts])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded step on 4 devices for each case, and the
    scenes' input files."""
    tmp = tmp_path_factory.mktemp("scenes")
    mesh = j_make_mesh(jax.devices()[:WORLD])
    cfg = JTrainConfig(warmup_steps=0)
    out = {}
    for name, (scene, backend) in CASES.items():
        seed, bounds, count, degree, size, cell = SCENES[scene]
        path = str(tmp / f"{scene}.npz")
        js, gt = write_scene(path, seed, bounds, count, degree, size)
        cp = j_cp(JCamera(**CAM, fov_x=FOV, fov_y=FOV), size)
        step = j_sharded_step(mesh, cfg, js.capacity, size, 3,
                              js.sh_coeffs.shape[1], block_size=128,
                              backend="pallas_interpret"
                              if backend == "pallas" else backend,
                              cell=cell)
        state = j_shard_state(JSplatTrainer(cfg).init_state(js), mesh)
        state, stats = step(state, jnp.asarray(gt), cp.viewmat, cp.focal,
                            cp.pixel_center,
                            jnp.float32(cfg.lr_mean_at(STEP)),
                            jnp.int32(STEP))
        out[name] = dict(
            inputs=path, stats={f: int(getattr(stats, f)) for f in (
                "num_visible", "num_isects", "num_dropped",
                "max_strip_isects")} | {"loss": float(stats.loss)},
            params={k: np.asarray(v) for k, v in
                    state.splats.params().items()},
            accum=np.asarray(state.grad_2d_accum),
            counts=np.asarray(state.xy_grad_counts))
    return out


def step_job(name, inputs, single=False):
    scene, backend = CASES[name]
    _, _, _, _, size, cell = SCENES[scene]
    return dict(kind="step", name=name, inputs=inputs, img_size=list(size),
                cell=list(cell), block_size=128, single=single,
                backend=backend, step=STEP, config=dict(warmup_steps=0))


@pytest.fixture(scope="module")
def port_world4(reference, tmp_path_factory):
    """The port's sharded step on 4 gloo ranks for each scene."""
    tmp = tmp_path_factory.mktemp("world4")
    got, _ = run_ranks(tmp, WORLD, [step_job(n, reference[n]["inputs"])
                                    for n in CASES])
    return got


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_reference(name, reference, port_world4):
    """Four ranks against the reference's four devices: loss, the stats
    (summed over ranks, and the largest strip; on the XLA path the
    frame's), the parameters after Adam and the screen-space gradient
    accumulation. Adam's step does not see
    a gradient's scale; the accumulation does. The reference's sharded
    gradients are WORLD times the single-device ones (its image gather's
    transpose sums the ranks' cotangents of one replicated loss; ROADMAP
    Queue 3, test_reference_sharded_gradient_is_world_times_too_large):
    the port's image gather gives each rank its own strip of the
    cotangent once, so its accumulation is the reference's over WORLD."""
    ref, parts = reference[name], port_world4[name]
    loss_tol, accum_tol, param_tol = TOLS[name]
    # A gradient WORLD times too large would miss the bound fivefold.
    assert (WORLD - 1) * np.abs(ref["accum"]).max() / WORLD > 5 * accum_tol
    for p in parts:   # every rank computes the same loss and stats
        assert abs(float(p["loss"]) - ref["stats"]["loss"]) < loss_tol
        for f in ("num_visible", "num_isects", "num_dropped",
                  "max_strip_isects"):
            assert int(p[f]) == ref["stats"][f], f
    assert ref["stats"]["num_isects"] > 0
    np.testing.assert_allclose(rows(parts, "grad_2d_accum"),
                               ref["accum"] / WORLD, atol=accum_tol)
    np.testing.assert_array_equal(rows(parts, "xy_grad_counts"),
                                  ref["counts"])
    for k in PARAMS:
        np.testing.assert_allclose(rows(parts, k), ref["params"][k],
                                   atol=param_tol, err_msg=k)


def test_reference_sharded_gradient_is_world_times_too_large(
        reference, port_world4):
    """The reference's fault, pinned: on the "uneven" scene its sharded
    step accumulates WORLD times the screen-space gradient norms of its
    own single-device trainer at the same step, on its Pallas and its XLA
    paths alike (every gradient is WORLD times too large; Adam hides it),
    while the port's four ranks accumulate the single-device norms within
    1e-4."""
    seed, bounds, count, degree, size, _ = SCENES["uneven"]
    rng = np.random.default_rng(seed)
    js = j_from_random(rng, *bounds, count=count, sh_degree=degree)
    gt = rng.uniform(0, 1, size=(size[1], size[0], 3)).astype(np.float32)
    from brush_tpu.train import SceneBatch as JSceneBatch

    trainer = JSplatTrainer(JTrainConfig(warmup_steps=0),
                            raster_block_size=16)
    trainer.iter = STEP
    state, _ = trainer.step(trainer.init_state(js), JSceneBatch(
        gt, JCamera(**CAM, fov_x=FOV, fov_y=FOV)))
    single = np.asarray(state.grad_2d_accum)
    seen = single > 1e-4
    assert seen.sum() > 10
    np.testing.assert_allclose(
        reference["uneven"]["accum"][seen] / single[seen], WORLD, rtol=1e-2)
    mesh = j_make_mesh(jax.devices()[:WORLD])
    step = j_sharded_step(mesh, JTrainConfig(warmup_steps=0), js.capacity,
                          size, 3, js.sh_coeffs.shape[1], block_size=16,
                          backend="xla")
    cp = j_cp(JCamera(**CAM, fov_x=FOV, fov_y=FOV), size)
    xla, _ = step(j_shard_state(trainer.init_state(js), mesh),
                  jnp.asarray(gt), cp.viewmat, cp.focal, cp.pixel_center,
                  jnp.float32(0.0), jnp.int32(STEP))
    np.testing.assert_allclose(np.asarray(xla.grad_2d_accum)[seen]
                               / single[seen], WORLD, rtol=1e-2)
    np.testing.assert_allclose(rows(port_world4["uneven"], "grad_2d_accum"),
                               single, atol=1e-4)


def test_imbalanced_scene_loads_one_strip(reference):
    """The imbalanced scene is what its name says: one strip holds more
    than half of the frame's records."""
    s = reference["imbalanced"]["stats"]
    assert s["max_strip_isects"] > 0.5 * s["num_isects"]


def test_world1_step_is_single_device(reference, tmp_path):
    """At world size 1 the strip is the frame, the mask restriction the
    identity and every collective a copy: the sharded step's loss, stats,
    parameters and statistics equal SplatTrainer's in every bit."""
    got, _ = run_ranks(tmp_path, 1, [
        step_job(n, reference[n]["inputs"], single=True)
        for n in ("uneven", "cells")])
    for name, (p,) in got.items():
        for k in (*PARAMS, "grad_2d_accum", "xy_grad_counts", "loss",
                  "num_visible", "num_isects", "num_dropped",
                  "max_strip_isects"):
            np.testing.assert_array_equal(p[k], p[f"single_{k}"],
                                          err_msg=f"{name} {k}")


@pytest.fixture(scope="module")
def port_world2(nerf_zip, tmp_path_factory):  # noqa: F811
    """Two gloo ranks: the collectives, the multihost helpers,
    ShardedTrainer through refines beside SplatTrainer, and `cli train
    --shard`."""
    tmp = tmp_path_factory.mktemp("world2")
    rng = np.random.default_rng(7)
    js = j_from_random(rng, [-2] * 3, [2] * 3, count=40, sh_degree=1)
    gt = rng.uniform(0, 1, size=(32, 48, 3)).astype(np.float32)
    inputs = str(tmp / "trainer.npz")
    np.savez(inputs, gt=gt, n_live=int(js.n_live), fov=FOV,
             position=np.asarray(CAM["position"]),
             rotation=np.asarray(CAM["rotation"]),
             **{k: np.asarray(v) for k, v in js.params().items()})
    ck = tmp / "cli"
    got, _ = run_ranks(tmp, 2, [
        dict(kind="collectives", name="collectives"),
        dict(kind="multihost", name="multihost", views=7),
        dict(kind="trainer", name="trainer", inputs=inputs, steps=26,
             # tests/test_sharded.py:185-196: every seen splat densifies,
             # refines at 9, 17 and 25 (an opacity reset among them) and
             # the capacity grows.
             config=dict(warmup_steps=2, refine_every=8, max_refine_step=100,
                         reset_alpha_every_refine=3,
                         densify_grad_thresh=0.0)),
        dict(kind="cli", argv=["--device", "cpu", "train", "--source",
                               nerf_zip, *TRAIN, "--shard",
                               "--checkpoint-dir", str(ck)])])
    got["cli"] = str(ck)
    return got


def test_collectives_and_their_transposes(port_world2):
    """GatherColumns: columns in rank order; backward = the sum over ranks
    of each rank's columns of the cotangent. GatherStrips: strips in rank
    order; backward = this rank's strip of the cotangent, not twice it."""
    parts = port_world2["collectives"]
    w = np.arange(24.0).reshape(3, 8)
    ws = np.arange(12.0).reshape(4, 3)
    want = np.concatenate([r + np.arange(6.0).reshape(2, 3)
                           for r in range(2)])
    for r, p in enumerate(parts):
        np.testing.assert_array_equal(p["columns_grad"],
                                      2 * w[:, 4 * r:4 * r + 4])
        np.testing.assert_array_equal(p["strips"], want)
        np.testing.assert_array_equal(p["strips_grad"], ws[2 * r:2 * r + 2])


def test_multihost_helpers_by_rank(port_world2):
    """process_view_slice and is_coordinator by rank: 7 views over 2 ranks
    are [0, 4) and [4, 7); outside a process group, all views and rank 0."""
    parts = port_world2["multihost"]
    assert [p["view"].tolist() for p in parts] == [[0, 4], [4, 7]]
    assert [bool(p["coordinator"]) for p in parts] == [True, False]
    assert multihost.process_view_slice(7) == range(0, 7)
    assert multihost.is_coordinator()


def test_sharded_trainer_matches_single_device(port_world2):
    """ShardedTrainer on 2 ranks for 26 steps through three refines
    (clone, split, prune, an opacity reset, Adam surgery, capacity growth)
    against SplatTrainer, with tests/test_sharded.py:177-242's rules: each
    loss within 2e-5, the same live counts at each refine, the same
    capacity; the final parameters' bulk (95 %) within 1e-4 and every
    element within 0.1 (the two sum gradients in different orders)."""
    p = port_world2["trainer"][0]
    np.testing.assert_allclose(p["losses"], p["single_losses"], atol=2e-5)
    assert len(p["refines"]) >= 2
    np.testing.assert_array_equal(p["refines"], p["single_refines"])
    n = int(p["n_live"])
    assert n == int(p["single_n_live"])
    assert p["means"].shape == p["single_means"].shape
    for k in PARAMS:
        diff = np.abs(p[k][:n] - p[f"single_{k}"][:n])
        assert np.quantile(diff, 0.95) < 1e-4, k
        assert diff.max() < 0.1, k
    # The other rank holds the same gathered model.
    for k in PARAMS:
        np.testing.assert_array_equal(port_world2["trainer"][1][k], p[k])


def losses_of(ck_dir):
    return [(r["step"], r["loss"]) for r in read_metrics(ck_dir)
            if "loss" in r]


@pytest.fixture(scope="module")
def cli_single(nerf_zip, tmp_path_factory):  # noqa: F811
    ck = tmp_path_factory.mktemp("cli_single")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["--device", "cpu", "train", "--source", nerf_zip, *TRAIN,
                  "--checkpoint-dir", str(ck)])
    return losses_of(str(ck)), sorted(os.listdir(ck))


def test_cli_train_shard_world1_equals_train(
        nerf_zip, cli_single, tmp_path):  # noqa: F811
    """`cli train --shard` without torchrun: a world of one process on a
    file store, made and destroyed by the command; its per-step losses
    equal `cli train`'s in every bit, and it checkpoints what `cli train`
    does."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", "cpu", "train", "--source", nerf_zip, *TRAIN,
                  "--shard", "--checkpoint-dir", str(tmp_path)])
    assert "sharded training over 1 ranks" in buf.getvalue()
    assert not torch.distributed.is_initialized()
    losses, files = cli_single
    assert losses_of(str(tmp_path)) == losses
    assert len(losses) == 4
    assert sorted(os.listdir(tmp_path)) == files


def test_cli_train_shard_composes_with_cell(nerf_zip, tmp_path):  # noqa: F811
    """`--shard --cell 2x2` at world size 1: every step and eval at the
    cell, the losses equal to `--cell 2x2`'s in every bit."""
    out = []
    for flags in ([], ["--shard"]):
        ck = tmp_path / f"ck{len(out)}"
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["--device", "cpu", "train", "--source", nerf_zip,
                      *TRAIN, "--cell", "2x2", "--eval-every", "2",
                      "--checkpoint-dir", str(ck), *flags])
        out.append([(r["step"], r.get("loss"), r.get("eval_psnr"))
                    for r in read_metrics(str(ck))])
    assert len(out[0]) == 5 and out[1] == out[0]


def test_cli_train_shard_world2_matches_train(port_world2, cli_single):
    """`cli train --shard` on 2 ranks: rank 0 logs each step's loss within
    1e-5 of `cli train`'s and writes the checkpoints; rank 1 writes
    nothing."""
    losses, files = cli_single
    got = losses_of(port_world2["cli"])
    assert [s for s, _ in got] == [s for s, _ in losses] == [0, 1, 2, 3]
    for (_, a), (_, b) in zip(got, losses):
        assert abs(a - b) <= 1e-5, (a, b)
    assert sorted(os.listdir(port_world2["cli"])) == files


def test_train2d_shard_runs_at_world1(tmp_path, capsys):
    """`train2d --shard` at world size 1 prints train2d's losses."""
    from brush_tpu_torch.datasets import testing as dt
    from test_torch_cli import tiny_images

    image = tmp_path / "target.png"
    image.write_bytes(dt.filtered_png(tiny_images(1, 3, size=24)[0]))
    argv = ["--device", "cpu", "train2d", "--image", str(image), "--iters",
            "4", "--log-every", "1", "--init-count", "16", "--block-size",
            "32"]
    cli.main(argv)
    plain = capsys.readouterr().out
    cli.main(argv + ["--shard"])
    sharded = capsys.readouterr().out
    loss = lambda text: [ln.split("loss ")[1].split()[0]
                         for ln in text.splitlines() if " loss " in ln]
    assert len(loss(plain)) == 4 and loss(sharded) == loss(plain)
    assert "final PSNR" in sharded


def test_sharded_step_checks_its_arguments():
    """The capacity must split over the ranks; the backend is render's:
    "pallas" and "auto" the strip pipeline, bit-equal, and "xla" the
    replicated binning and tiled rasterizer (the CUDA refusal is gone), at
    world size 1 the XLA render's records and a loss within the u16
    quantization of the pipeline's; an unknown backend raises."""
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.config import TrainConfig
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.parallel import make_sharded_train_step
    from brush_tpu_torch.parallel.sharding import Mesh
    from brush_tpu_torch.render import render_splats
    from brush_tpu_torch.splats import from_random
    from brush_tpu_torch.train import SplatTrainer

    two = Mesh(2, 0, torch.device("cpu"))
    cfg = TrainConfig(warmup_steps=0)
    with pytest.raises(ValueError, match="backend"):
        make_sharded_train_step(two, cfg, 256, (32, 32), 3, 4,
                                backend="pallas_interpret")
    with pytest.raises(ValueError, match="divisible"):
        make_sharded_train_step(two, cfg, 255, (32, 32), 3, 4)

    sp = from_random(np.random.default_rng(3), [-2] * 3, [2] * 3, count=48,
                     sh_degree=1, capacity=64, device="cpu")
    cam = Camera(**CAM, fov_x=FOV, fov_y=FOV)
    cp = camera_params(cam, (48, 32), device="cpu")
    gt = torch.tensor(np.random.default_rng(4).uniform(
        0, 1, (32, 48, 3)).astype(np.float32))
    stats = {}
    with multihost.process_group("cpu"):
        mesh = make_mesh("cpu")
        for backend in ("auto", "pallas", "xla"):
            step = make_sharded_train_step(mesh, cfg, 64, (48, 32), 3, 4,
                                           backend=backend)
            _, stats[backend] = step(SplatTrainer(cfg).init_state(sp), gt,
                                     cp.viewmat, cp.focal, cp.pixel_center,
                                     1e-4, 2)
    _, aux = render_splats(sp.means, sp.log_scales, sp.quats, sp.sh_coeffs,
                           sp.raw_opacity, cp, (48, 32),
                           active=sp.active_mask(), backend="xla",
                           needs_grad=False)
    for f in stats["xla"]._fields:
        assert torch.equal(getattr(stats["auto"], f),
                           getattr(stats["pallas"], f)), f
    x = stats["xla"]
    for f in ("num_visible", "num_isects", "num_dropped"):
        assert int(getattr(x, f)) == int(getattr(aux, f)), f
    assert int(x.max_strip_isects) == int(aux.num_isects) > 0
    assert abs(float(x.loss) - float(stats["pallas"].loss)) < 1e-4


def test_make_mesh_checks_its_group():
    """make_mesh needs an initialized group whose backend carries the
    device's tensors; inside one it is (size, rank, device)."""
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh("cpu")
    with multihost.process_group("cpu") as dev:
        assert dev == torch.device("cpu")
        mesh = make_mesh("cpu")
        assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
        assert multihost.backend_for("cuda") == "nccl"
    assert not torch.distributed.is_initialized()
