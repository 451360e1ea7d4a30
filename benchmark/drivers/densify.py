"""Entry kind `densify`: SplatTrainer.step across a refine, as the CLI
drives it, in a padded capacity.

Set-up builds the scene from the seed (configs/<config>.json "scene", made
by scenes/<kind>.py: the live rows and the resumed densification
statistics), pads the live rows to the scene's capacity with the
program's padding fills (`splats.from_dense`), makes one SplatTrainer
and one TrainState, resumes the trainer at the workload's `start_iter`
with the drawn statistics on the state, and drives it through
`check_steps` steps on distinct views. The refine that falls among them
(iteration % refine_every == 1) acts on the drawn statistics plus the
check steps' own. The window then goes on from that state with the same
trainer, as drivers/train.py's does: `train_step_ms` is the window over
the steps it completed, the refines that fall in it included (they act on
the statistics the window's own steps gathered from zero).

After the window (peak memory read, the program's state freed), the
reference (reference/densify.py, the steps by reference/splat.py) runs
the check steps again from the scene the seed gives, with the split
draws the trainer's generator makes (its seed, (capacity, 3) each) cut to
the live rows, and the numbers compared are:

- loss_gap, grad_norm_gap: as drivers/train.py's (the first step's
  gradient over the live rows, by the worst leaf);
- change_norm_gap: the parameters after the check steps less those of the
  rows they came from (reference/densify.refine's origin), row for row
  over the live rows, by the worst leaf whose gradient moves (as
  drivers/train.py's);
- moment_gap: Adam's first and second moments after the check steps, the
  same way, by the worst leaf of either;
- accum_gap: the densification statistics' gradient sums after the
  check steps (the refine restarts them, so they hold the last check
  step's screen-space gradient norms), the norm of the difference over
  the reference's norm, over the live rows;
- count_gap: how many live rows hold another count than the reference's
  (the last check step: one for each splat that emitted a record);
- live_gap: how far the program's live count is from the reference's
  (either way). Where it is not 0 the rows cannot be compared, and the
  five row numbers are infinite.

With --trace 1 the window records the program's stage marks, spans and
counters (the refine's among them), and `trace_steps` steps after it run
under torch.profiler for the device's busy share, the rasterizers' kernel
time and the work counts (`kernel_s`, `work`), as drivers/train.py's.
"""

from __future__ import annotations

import statistics as stats_
import time

import torch

from benchmark import harness
from benchmark.drivers import train as base
from benchmark.reference import compare, densify as dref, splat as ref

REFINE_KEYS = ("densify_grad_thresh", "densify_size_thresh",
               "cull_alpha_thresh", "cull_scale_thresh", "reset_alpha_value",
               "reset_alpha_every_refine", "refine_every")


def scene_of(cfg: dict) -> dict:
    """The scene's parameters with the recipe's thresholds it keeps clear
    of."""
    r = cfg["recipe"]
    return dict(cfg["scene"], size_thresh=r["densify_size_thresh"],
                grad_thresh=r["densify_grad_thresh"])


def split_draws(seed: int, capacity: int, dev):
    """The two (capacity, 3) standard normal draws of the trainer's first
    refine: its generator, seeded with the recipe's seed, on the state's
    device."""
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    return (torch.randn((capacity, 3), generator=g, device=dev),
            torch.randn((capacity, 3), generator=g, device=dev))


def refine_due(recipe: dict, it: int) -> bool:
    """The trainer's cadence: after the step at iteration `it`."""
    every = recipe["refine_every"]
    return (recipe["warmup_steps"] <= it < recipe["max_refine_step"]
            and it % every == 1 % every)


def drive(ctx: harness.Context) -> harness.Outcome:
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.config import TrainConfig
    from brush_tpu_torch.splats import from_dense, round_up_capacity
    from brush_tpu_torch.train import SceneBatch, SplatTrainer
    from brush_tpu_torch.utils import profiler

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    recipe = cfg["recipe"]
    sc = scene_of(cfg)
    scene = base.scene_module(cfg)
    p = scene.params(sc, ctx.seed, dev)
    n = p["means"].shape[0]
    cap = int(sc["capacity"])
    if cap != round_up_capacity(2 * n):
        raise SystemExit(f"capacity {cap} is not the trainer's "
                         f"round_up_capacity(2 x {n})")
    accum, counts = scene.statistics(sc, ctx.seed, p["means"])
    splats = from_dense(**p, capacity=cap, device=dev)
    del p
    harness.phase(ctx, f"{n} live splats in {cap} rows on the device")
    poses, gts, size = scene.views(sc, ctx.seed, dev)
    harness.phase(ctx, f"{len(gts)} views made")
    extent = base.scene_extent(poses)
    batches = [SceneBatch(gt_image=g, camera=Camera(
        position=q["position"], rotation=q["rotation"], fov_x=q["fov_x"],
        fov_y=q["fov_y"]), scene_extent=extent) for q, g in zip(poses, gts)]
    trainer = SplatTrainer(TrainConfig(**recipe),
                           raster_block_size=cfg["block_size"])
    if cfg.get("pool"):
        trainer._isect_pool = int(cfg["pool"])
    trainer.iter = start_iter = int(wl["start_iter"])
    state = trainer.init_state(splats)
    del splats
    state.grad_2d_accum[:n] = accum
    state.xy_grad_counts[:n] = counts
    del accum, counts
    order = base.view_order(ctx.seed, len(batches))
    n_check = int(wl["check_steps"])
    step = base._step_fn(trainer, ctx.faults)
    refines = []

    def note_refine(it):
        if trainer.last_refine_stats is not None:
            refines.append((it, trainer.last_refine_stats))

    # The check steps: the window's own call on distinct views.
    losses, grad1 = [], None
    for j in range(n_check):
        state, st = step(state, batches[order[j]])
        note_refine(start_iter + j)
        losses.append(st.loss)
        if j == 0:
            b1 = 0.9
            grad1 = {k: (v.detach() / (1 - b1)).cpu()
                     for k, v in state.opt.m.items()}
    losses = [float(v) for v in losses]
    live = state.splats.n_live
    after = {k: v[:live].detach().cpu()
             for k, v in state.splats.params().items()}
    moments = [{k: x[:live].detach().cpu() for k, x in d.items()}
               for d in (state.opt.m, state.opt.v)]
    gathered = (state.grad_2d_accum[:live].detach().cpu(),
                state.xy_grad_counts[:live].detach().cpu())
    check_refines = list(refines)
    harness.sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    harness.phase(ctx, f"{n_check} check steps: set-up done; refines "
                  f"{_shares(check_refines, n)}; {live} live in "
                  f"{state.splats.capacity} rows; the last "
                  f"{int(st.num_isects)} records, {int(st.num_dropped)} "
                  f"dropped")

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
            note_refine(trainer.iter - 1)
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
    window_refines = refines[len(check_refines):]
    harness.phase(ctx, f"window: {steps} steps, {trainer.iter} the next "
                  f"iteration, {state.splats.n_live} live in "
                  f"{state.splats.capacity} rows; refines "
                  f"{_shares(window_refines, live)}; steps enqueued by "
                  f"each second: {marks}")
    peak = harness.peak_bytes(dev)

    run = {"steps": harness.split_steps(stages, "step end") if ctx.trace
           else [], "unit_s": step_s,
           "refines": {"check": [tuple(r) for _, r in check_refines],
                       "window": [tuple(r) for _, r in window_refines]}}
    busy = win = breakdown = None
    if ctx.trace:
        traced_views = []

        def one():
            nonlocal state, k
            traced_views.append(order[k % len(order)])
            with torch.profiler.record_function("SplatTrainer.step"):
                state, _ = step(state, batches[order[k % len(order)]])
            k += 1

        at_trace = {kk: v.detach()
                    for kk, v in state.splats.params().items()}
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
        run["work"] = base._work(at_trace, live_trace, traced_views, poses,
                                 gts, size, dev)
        del at_trace
        harness.free(dev)
    harness.phase(ctx, "program freed")

    noise = [d[:n] for d in split_draws(recipe["seed"], cap, dev)]
    out = reference_steps(cfg, ctx.seed, dev, order[:n_check], start_iter,
                          extent, (poses, gts, size), noise)
    harness.phase(ctx, f"reference done; refines {out['refines']}")
    nums = numbers(losses, grad1, after, moments, gathered, live, out)
    checks = {kk: (v, float(wl["limits"][kk])) for kk, v in nums.items()}
    run["diagnostics"] = out["near"]
    if "control" in ctx.faults:
        # Calibration only: the reference at TF32 in the program's place.
        ctl = reference_steps(cfg, ctx.seed, dev, order[:n_check],
                              start_iter, extent, (poses, gts, size), noise,
                              tf32=True)
        run["control"] = numbers(ctl["losses"], ctl["grad1"], ctl["after"],
                                 ctl["moments"], (ctl["accum"],
                                                  ctl["counts"]),
                                 ctl["after"]["means"].shape[0], out)
    e2e = {"train_step_ms": 1e3 * step_s, "setup_s": setup_s,
           "peak_mem_gib": peak / 2 ** 30}
    return harness.Outcome(e2e=e2e, run=run, checks=checks,
                           attempted=n_check + steps, failed=0,
                           memory_peak_bytes=peak, busy_s=busy,
                           window_s=win, breakdown=breakdown)


def _shares(refines: list, live: int) -> list:
    """Each refine's iteration and its clones, splits and prunes as % of
    the live rows before it."""
    out = []
    for it, r in refines:
        pct = lambda x: round(100.0 * x / max(live, 1), 4)
        out.append({"iter": it, "cloned": r.num_cloned, "split": r.num_split,
                    "pruned": r.num_pruned_alpha + r.num_pruned_scale,
                    "live": r.n_live, "densified_pct":
                    pct(r.num_cloned + r.num_split),
                    "pruned_pct": pct(r.num_pruned_alpha
                                      + r.num_pruned_scale)})
        live = r.n_live
    return out


def reference_steps(cfg, seed, dev, views, start_iter, extent, scene, noise,
                    tf32: bool = False) -> dict:
    """The reference's losses, first gradients, and parameters, moments
    and densification statistics after the check steps on `views` of
    scene = (poses, gts, size), from the live rows and statistics the
    seed gives, refining where the trainer's cadence does (`noise`: the
    two split draws' live rows; `tf32`: the control, TF32 on)."""
    recipe = cfg["recipe"]
    rc = {kk: recipe[kk] for kk in REFINE_KEYS}
    poses, gts, size = scene
    sc = scene_of(cfg)
    mod = base.scene_module(cfg)
    params = mod.params(sc, seed, dev)
    accum, counts = mod.statistics(sc, seed, params["means"])
    m = {kk: torch.zeros_like(v) for kk, v in params.items()}
    v2 = {kk: torch.zeros_like(v) for kk, v in params.items()}
    p0 = {kk: v.detach().cpu() for kk, v in params.items()}
    origin = torch.arange(params["means"].shape[0], device=dev)
    losses, grad1, refines, near = [], None, [], {}
    with ref.precision(tf32):
        for j, view in enumerate(views):
            it = start_iter + j
            cam = ref.make_cam(poses[view], size, dev)
            gt = torch.as_tensor(gts[view], device=dev)
            loss, grads, xy_grad, producing = dref.step_grads(
                params, cam, gt, recipe["ssim_weight"], base.scan_of(cfg))
            losses.append(float(loss))
            if j == 0:
                grad1 = {kk: g.cpu() for kk, g in grads.items()}
            if it > recipe["warmup_steps"]:
                accum, counts = dref.add_statistics(accum, counts, xy_grad,
                                                    producing, size)
            lr_mean = base.recipe_lr_mean(recipe, it) * extent
            lrs = ref.group_lrs(params["sh_coeffs"].shape[1], lr_mean, dev,
                                **{kk: recipe[r] for kk, r in (
                                    ("lr_dc", "lr_coeffs_dc"),
                                    ("sh_scale", "lr_coeffs_sh_scale"),
                                    ("lr_opac", "lr_opac"),
                                    ("lr_scale", "lr_scale"),
                                    ("lr_rot", "lr_rotation"))})
            post, m, v2 = ref.adam(params, grads, m, v2, j + 1, lrs,
                                   eps=recipe["adam_eps"])
            del grads, gt, xy_grad
            if refine_due(recipe, it):
                near = nearest(accum, counts, rc["densify_grad_thresh"])
                params, m, v2, st, src = dref.refine(
                    post, params, m, v2, accum, counts, noise[0], noise[1],
                    rc, dref.resets(it, rc))
                origin = origin[src]
                refines.append({"iter": it, **st})
                accum = torch.zeros_like(params["raw_opacity"])
                counts = torch.zeros(accum.shape, dtype=torch.int32,
                                     device=dev)
                noise = None    # a second refine would need the next draws
            else:
                params = post
    origin = origin.cpu()
    return {"losses": losses, "grad1": grad1, "p0": p0,
            "base": {kk: v[origin] for kk, v in p0.items()},
            "after": {kk: v.cpu() for kk, v in params.items()},
            "moments": [{kk: x.cpu() for kk, x in d.items()}
                        for d in (m, v2)],
            "accum": accum.cpu(), "counts": counts.cpu(),
            "refines": refines, "near": near}


def nearest(accum, counts, thresh: float) -> dict:
    """How near the refine's averages come to the threshold: the least
    |average / threshold - 1| and the rows within 1e-3 of it."""
    rel = (dref.averages(accum, counts) / thresh - 1.0).abs()
    return {"least_rel_to_thresh": float(rel.min()),
            "rows_within_1e-3": int((rel < 1e-3).sum())}


def numbers(losses, grad1, after, moments, gathered, live: int,
            ref_out: dict) -> dict:
    """The compared numbers (the module docstring); `gathered`: the
    (sums, counts) of the densification statistics over the live rows."""
    rows = ref_out["after"]["means"].shape[0]
    n0 = ref_out["p0"]["means"].shape[0]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, ref_out["losses"]))
    g_ref = compare._norms(ref_out["grad1"], n0)
    grad_gap = compare.norm_gap(compare._norms(grad1, n0), g_ref, ref.LEAVES)
    out = {"loss_gap": float(loss_gap), "grad_norm_gap": float(grad_gap),
           "live_gap": float(abs(live - rows))}
    if live != rows:
        out.update(change_norm_gap=float("inf"), moment_gap=float("inf"),
                   accum_gap=float("inf"), count_gap=float("inf"))
        return out
    med = stats_.median(g_ref.values())
    moving = [kk for kk in ref.LEAVES if g_ref[kk] >= compare.STILL * med]
    d_prog = {kk: after[kk][:rows] - ref_out["base"][kk] for kk in ref.LEAVES}
    d_ref = {kk: ref_out["after"][kk] - ref_out["base"][kk]
             for kk in ref.LEAVES}
    out["change_norm_gap"] = float(compare.norm_gap(
        compare._norms(d_prog, rows), compare._norms(d_ref, rows), moving))
    out["moment_gap"] = float(max(
        compare.norm_gap(compare._norms(p, rows), compare._norms(r, rows),
                         ref.LEAVES)
        for p, r in zip(moments, ref_out["moments"])))
    accum, counts = gathered
    want = ref_out["accum"].double()
    out["accum_gap"] = float(
        torch.linalg.vector_norm(accum[:rows].double() - want)
        / max(float(torch.linalg.vector_norm(want)), 1e-30))
    out["count_gap"] = float((counts[:rows] != ref_out["counts"]).sum())
    return out
