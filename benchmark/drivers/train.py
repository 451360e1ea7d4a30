"""Entry kind `train`: the program's SplatTrainer.step, as the CLI drives it.

Set-up builds the scene from the seed (configs/<config>.json "scene",
made by scenes/<kind>.py), one SplatTrainer and one TrainState, resumes the
trainer at the workload's `start_iter`, and drives that state through
`check_steps` steps on distinct views: they warm up every shape, build
the kernels, and are what the reference follows. The window then goes
on from the same state with the same trainer, view after view in the
seed's order, until `seconds` have passed; `train_step_ms` is the window
over the steps it completed (refines and first uploads included).

After the window (peak memory read, the program's state freed), the
reference (reference/splat.py) runs the check steps again from the
scene the seed gives and the numbers compared are:

- loss_gap: the largest relative gap of a check step's loss;
- grad_norm_gap: the first step's gradient as Adam got it (its first
  moment after one step over 1 - beta1), by the worst leaf: the gap of
  the two norms over the larger of the reference's norm of that leaf and
  of the median leaf;
- change_norm_gap: the parameters' change over the check steps, the
  same way, over the leaves whose reference gradient reaches a
  thousandth of the median leaf's (the others move by round-off only).

With --trace 1 the window records the program's stage marks, and
`trace_steps` steps after it run under torch.profiler; the counts of
their work (counts/work.py, pairs from reference/splat.py) come from the
state at the trace's start.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.counts import work
from benchmark.reference import compare, splat as ref


def scene_module(cfg: dict):
    """scenes/<kind>.py of the configuration's scene: params(), views()."""
    kind = cfg["scene"]["kind"]
    return harness.load_module(os.path.join(harness.HERE, "scenes",
                                            kind + ".py"),
                               "bench_scene_" + kind)


def scene_extent(poses) -> float:
    """The largest half extent of the cameras' positions: the mean
    learning rate's scale, as the program's dataset loader gives it."""
    pos = np.stack([np.asarray(p["position"], np.float64) for p in poses])
    return float(np.max((pos.max(0) - pos.min(0)) / 2.0))


def scan_of(cfg: dict) -> tuple:
    """(passes, lanes) of the configuration's log-T scan for the
    reference; passes 3 is the exact scan."""
    return int(cfg["scan_passes"]), int(cfg["scan_lanes"])


def view_order(seed: int, views: int) -> list:
    return [int(i) for i in np.random.default_rng(seed).permutation(views)]


def drive(ctx: harness.Context) -> harness.Outcome:
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.config import TrainConfig
    from brush_tpu_torch.splats import Splats
    from brush_tpu_torch.train import SceneBatch, SplatTrainer
    from brush_tpu_torch.utils import profiler

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    recipe = cfg["recipe"]
    scene = scene_module(cfg)
    p = scene.params(cfg["scene"], ctx.seed, dev)
    splats = Splats(n_live=p["means"].shape[0], **p)
    del p
    harness.phase(ctx, f"{splats.n_live} splats on the device")
    poses, gts, size = scene.views(cfg["scene"], ctx.seed, dev)
    harness.phase(ctx, f"{len(gts)} views made")
    extent = scene_extent(poses)
    batches = [SceneBatch(gt_image=g, camera=Camera(
        position=p["position"], rotation=p["rotation"], fov_x=p["fov_x"],
        fov_y=p["fov_y"]), scene_extent=extent) for p, g in zip(poses, gts)]
    trainer = SplatTrainer(TrainConfig(**recipe),
                           raster_block_size=cfg["block_size"])
    if cfg.get("pool"):
        trainer._isect_pool = int(cfg["pool"])
    trainer.iter = start_iter = int(wl["start_iter"])
    state = trainer.init_state(splats)
    del splats
    order = view_order(ctx.seed, len(batches))
    n_check = int(wl["check_steps"])
    step = _step_fn(trainer, ctx.faults)

    # The check steps: the window's own call on distinct views.
    losses, grad1 = [], None
    for j in range(n_check):
        state, stats = step(state, batches[order[j]])
        losses.append(stats.loss)
        if j == 0:
            b1 = 0.9
            grad1 = {k: (v.detach() / (1 - b1)).cpu()
                     for k, v in state.opt.m.items()}
    losses = [float(v) for v in losses]
    after = {k: v.detach().cpu() for k, v in state.splats.params().items()}
    live = state.splats.n_live
    harness.sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    harness.phase(ctx, f"{n_check} check steps: set-up done; the last "
                  f"{int(stats.num_isects)} records, "
                  f"{int(stats.num_dropped)} dropped")

    # The window.
    k = n_check
    record = (profiler.record(host=dev.type != "cuda") if ctx.trace
              else harness.no_marks())
    with record as stages:
        t = time.perf_counter()
        steps = 0
        marks = []
        while True:
            state, _ = step(state, batches[order[k % len(order)]])
            k += 1
            steps += 1
            now = time.perf_counter() - t
            if now >= len(marks) + 1:
                marks.append(steps)
            if now >= ctx.seconds:
                break
        harness.sync(dev)
        window = time.perf_counter() - t
    step_s = window / steps
    harness.phase(ctx, f"window: {steps} steps, {trainer.iter} the next "
                  f"iteration, {state.splats.n_live} splats live; steps "
                  f"enqueued by each second: {marks}")
    peak = harness.peak_bytes(dev)

    run = {"steps": harness.split_steps(stages, "step end") if ctx.trace
           else [], "unit_s": step_s}
    busy = win = breakdown = None
    if ctx.trace:
        traced_views = []

        def one():
            nonlocal state, k
            traced_views.append(order[k % len(order)])
            with torch.profiler.record_function("SplatTrainer.step"):
                state, _ = step(state, batches[order[k % len(order)]])
            k += 1

        at_trace = {kk: v.detach() for kk, v in state.splats.params().items()}
        live_trace = state.splats.n_live
        tr = harness.traced(one, int(wl["trace_steps"]), dev)
        busy, win, breakdown = tr["busy_s"], tr["window_s"], tr["breakdown"]
        run.update(busy_s=busy, window_s=win, kernel_s={
            "rasterize_fwd": harness.kernel_seconds(
                tr, ("rasterize_fwd_kernel",), lead="tile_order_kernel"),
            "rasterize_bwd": harness.kernel_seconds(
                tr, ("rasterize_bwd_kernel", "cell_sum_kernel"),
                lead="tile_order_kernel")})
    del state, trainer, step, batches
    harness.free(dev)

    if ctx.trace:
        run["work"] = _work(at_trace, live_trace, traced_views, poses, gts,
                            size, dev)
        del at_trace
        harness.free(dev)

    harness.phase(ctx, "program freed")
    out = reference_steps(cfg, ctx.seed, dev, order[:n_check], start_iter,
                          extent, (poses, gts, size))
    harness.phase(ctx, "reference done")
    nums = compare.train_numbers(losses, grad1, after, live, out)
    checks = {k: (v, float(wl["limits"][k])) for k, v in nums.items()}
    run["diagnostics"] = compare.diff_numbers(grad1, after, out)
    if "control" in ctx.faults:
        # Calibration only: the reference at TF32 in the program's place.
        ctl = reference_steps(cfg, ctx.seed, dev, order[:n_check],
                              start_iter, extent, (poses, gts, size),
                              tf32=True)
        run["control"] = {**compare.train_numbers(
            ctl["losses"], ctl["grad1"], ctl["after"],
            ctl["p0"]["means"].shape[0], out),
            **compare.diff_numbers(ctl["grad1"], ctl["after"], out)}
    e2e = {"train_step_ms": 1e3 * step_s, "setup_s": setup_s,
           "peak_mem_gib": peak / 2 ** 30}
    return harness.Outcome(e2e=e2e, run=run, checks=checks,
                           attempted=n_check + steps, failed=0,
                           memory_peak_bytes=peak, busy_s=busy,
                           window_s=win, breakdown=breakdown)


def _swapped(trainer, name: str, stand_in):
    """trainer.step with the program's train module's `name` swapped for
    `stand_in` while the step runs."""
    import brush_tpu_torch.train as tr

    def step(state, batch):
        full = getattr(tr, name)
        setattr(tr, name, stand_in(full))
        try:
            return trainer.step(state, batch)
        finally:
            setattr(tr, name, full)
    return step


def _step_fn(trainer, faults: tuple):
    """trainer.step, or (tests and calibration only) the step with a fault
    planted: one that returns its state unchanged, one whose loss leaves
    out half of the image's rows, or one that renders with the exact
    log-T scan in place of the configured truncated one."""
    if "state_unchanged" in faults:
        def unchanged(state, batch):
            _, stats = trainer.step(state, batch)
            return state, stats
        return unchanged
    if "half_batch" in faults:
        def half(full):
            def loss(img, gt, channels, cfg, ssim):
                h = img.shape[0] // 2
                return full(img[:h], gt[:h], channels, cfg, ssim)
            return loss
        return _swapped(trainer, "image_loss", half)
    if "exact_scan" in faults:
        def exact(full):
            return lambda *a, **k: full(*a, **k, scan_passes=3)
        return _swapped(trainer, "render_splats", exact)
    return trainer.step


def _work(params, n_live, traced_views, poses, gts, size, dev) -> dict:
    """The counts (ops, bytes) a traced step needs on average: the
    rasterizers' and the whole step's."""
    active = torch.arange(params["means"].shape[0], device=dev) < n_live
    coeffs = params["sh_coeffs"].shape[1]
    fwd = [0, 0]
    bwd = [0, 0]
    unit = [0, 0]
    pixels = size[0] * size[1]
    for v in traced_views:
        cam = ref.make_cam(poses[v], size, dev)
        with torch.no_grad():
            s = ref.project(params, cam, active)
            rec = ref.records(s, size)
            _, pairs, hits = ref.render((s.xy, s.conic, s.color, s.opac),
                                        rec, size, count=True)
        drawn = int(s.visible.sum())
        ch = gts[v].shape[-1]
        for acc, w in ((fwd, work.raster_fwd(pairs, drawn, hits, pixels)),
                       (bwd, work.raster_bwd(pairs, drawn, hits, pixels)),
                       (unit, work.train_step(n_live, coeffs, drawn, pairs,
                                              hits, pixels, ch))):
            acc[0] += w[0]
            acc[1] += w[1]
    m = len(traced_views)
    avg = lambda a: (a[0] / m, a[1] / m)
    # The rasterizers' device time is the trace's sum over all its steps.
    return {"rasterize_fwd": tuple(fwd), "rasterize_bwd": tuple(bwd),
            "unit": avg(unit)}


def reference_steps(cfg, seed, dev, views, start_iter, extent, scene,
                    tf32: bool = False) -> dict:
    """The reference's losses, first gradients and parameters after the
    check steps on `views` of scene = (poses, gts, size), from the
    parameters the seed gives (`tf32`: the control, TF32 on)."""
    recipe = cfg["recipe"]
    poses, gts, size = scene
    params = scene_module(cfg).params(cfg["scene"], seed, dev)
    n = params["means"].shape[0]
    active = torch.ones(n, dtype=torch.bool, device=dev)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    p0 = {k: v.detach().cpu() for k, v in params.items()}
    losses, grad1 = [], None
    with ref.precision(tf32):
        for j, view in enumerate(views):
            it = start_iter + j
            cam = ref.make_cam(poses[view], size, dev)
            gt = torch.as_tensor(gts[view], device=dev)
            loss, grads = ref.step_grads(params, active, cam, gt,
                                         recipe["ssim_weight"],
                                         scan_of(cfg))
            losses.append(float(loss))
            if j == 0:
                grad1 = {k: g.cpu() for k, g in grads.items()}
            lr_mean = recipe_lr_mean(recipe, it) * extent
            lrs = ref.group_lrs(params["sh_coeffs"].shape[1], lr_mean, dev,
                                **{k: recipe[kk] for k, kk in (
                                    ("lr_dc", "lr_coeffs_dc"),
                                    ("sh_scale", "lr_coeffs_sh_scale"),
                                    ("lr_opac", "lr_opac"),
                                    ("lr_scale", "lr_scale"),
                                    ("lr_rot", "lr_rotation"))})
            params, m, v2 = ref.adam(params, grads, m, v2, j + 1, lrs,
                                     eps=recipe["adam_eps"])
            del grads, gt
    return {"losses": losses, "grad1": grad1, "p0": p0,
            "after": {k: v.cpu() for k, v in params.items()}}


def recipe_lr_mean(recipe: dict, it: int) -> float:
    decay = recipe["lr_mean_decay_target"] ** (
        1.0 / recipe["lr_mean_decay_steps"])
    return recipe["lr_mean"] * decay ** it
