"""The port's densification statistics and refine against the benchmark's
plain reference (benchmark/reference/densify.py), on seeded random splats
in a padded capacity at a small frame (CPU tensors): make_refine_fn's live
rows, counts and moments case by case with the same split draws; the
statistics after two steps against the reference's screen-space
gradients; and a SplatTrainer run across a shrink and a grow, its live
rows after each refine against the reference's."""

import math

import pytest
import torch

from benchmark import harness
from benchmark.drivers import densify as drv
from benchmark.reference import compare, densify as dref, splat as ref
from benchmark.scenes import uniform
from brush_tpu_torch import optim, train
from brush_tpu_torch.camera import Camera
from brush_tpu_torch.config import TrainConfig
from brush_tpu_torch.splats import from_dense
from torch_threads import pin_threads

pin_threads()

CAP, LIVE = 1024, 480
THRESH = {k: getattr(TrainConfig(), k) for k in drv.REFINE_KEYS}
SIZE = (48, 40)


def leaves(n, seed, scale=0.01, opacity=(0.05, 0.25)):
    return uniform.splats(n, seed, "cpu", extent=1.5, scale=scale,
                          spread=2.0, opacity=opacity, sh_coeffs=4)


def refine_case(case: str, seed: int = 11):
    """Live rows, their pre-step copies, moments and statistics for one
    case; every average, largest scale and opacity at least 5 % from its
    threshold."""
    g = torch.Generator().manual_seed(seed)
    post = leaves(LIVE, seed)
    u = torch.rand((LIVE, 4), generator=g)
    dens = u[:, 0] < 0.15
    # Largest scales: 2x under or 2x over densify_size_thresh.
    small = {"clone": torch.ones(LIVE, dtype=torch.bool),
             "split": torch.zeros(LIVE, dtype=torch.bool)}.get(
        case, u[:, 1] < 0.4)
    size = math.log(THRESH["densify_size_thresh"]) + torch.where(
        small, -math.log(2.0), math.log(2.0))
    post["log_scales"] = (size[:, None] - 0.3 * torch.rand(
        (LIVE, 3), generator=g)).contiguous()
    if case == "prune_opacity":
        low = u[:, 2] < 0.1
        post["raw_opacity"] = torch.where(low, -6.0, post["raw_opacity"])
    if case == "prune_scale":
        huge = (u[:, 2] < 0.05) & ~dens
        post["log_scales"][huge, 0] = math.log(
            2 * THRESH["cull_scale_thresh"])
        # Splits of a splat 1.2x over the cull scale: both halves kept.
        over = (u[:, 2] > 0.95) & dens & ~small
        post["log_scales"][over, 1] = math.log(
            1.2 * 1.6 * THRESH["cull_scale_thresh"])
    pre = {k: v + 0.01 * torch.randn(v.shape, generator=g)
           for k, v in post.items()}
    counts = torch.randint(1, 6, (LIVE,), generator=g, dtype=torch.int32)
    rel = torch.where(dens, 1.5 + u[:, 3], 0.1 + 0.8 * u[:, 3])
    accum = THRESH["densify_grad_thresh"] * rel * counts.to(torch.float32)
    m = {k: torch.randn(v.shape, generator=g) for k, v in post.items()}
    v = {k: torch.rand(v.shape, generator=g) for k, v in post.items()}
    return post, pre, m, v, accum, counts


def padded_state(post, m, v, accum, counts):
    sp = from_dense(**post, capacity=CAP, device="cpu")
    pad = lambda x: torch.cat([x, torch.zeros((CAP - LIVE,) + x.shape[1:],
                                              dtype=x.dtype)])
    return train.TrainState(
        splats=sp, opt=optim.AdamState(
            m={k: pad(x) for k, x in m.items()},
            v={k: pad(x) for k, x in v.items()}, count=7),
        grad_2d_accum=pad(accum), xy_grad_counts=pad(counts))


@pytest.mark.parametrize("case, reset", [
    ("clone", False), ("split", False), ("both", False),
    ("prune_opacity", False), ("prune_scale", False), ("both", True)])
def test_refine_matches_the_plain_reference(case, reset):
    """make_refine_fn (keep_opt_state_on_refine on, the default) on a
    480-live, 1024-row state against dref.refine on the live rows, with the
    same split draws: the counts exactly, the rows and moments within
    1e-6 relative."""
    post, pre, m, v, accum, counts = refine_case(case)
    g = torch.Generator().manual_seed(5)
    noise, noise2 = (torch.randn((CAP, 3), generator=g) for _ in range(2))
    state = padded_state(post, m, v, accum, counts)
    pre_sp = from_dense(**pre, capacity=CAP, device="cpu")
    ts, tstats = train.make_refine_fn(TrainConfig(), CAP, reset)(
        state, pre_sp, noise=noise, noise2=noise2)
    out, rm, rv, st, _ = dref.refine(post, pre, m, v, accum, counts,
                                     noise[:LIVE], noise2[:LIVE], THRESH,
                                     reset)
    assert tstats.n_live == st["live"] == ts.splats.n_live
    assert (tstats.num_cloned, tstats.num_split, tstats.num_pruned_alpha,
            tstats.num_pruned_scale) == (st["cloned"], st["split"],
                                         st["pruned_alpha"],
                                         st["pruned_scale"])
    want = {"clone": (True, False), "split": (False, True)}.get(
        case, (True, True))
    assert (st["cloned"] > 0, st["split"] > 0) == want
    if case.startswith("prune"):
        assert st[{"prune_opacity": "pruned_alpha",
                   "prune_scale": "pruned_scale"}[case]] > 0
    n = st["live"]
    close = lambda a, b, what: torch.testing.assert_close(
        a[:n], b, rtol=1e-6, atol=1e-7, msg=what)
    for k in ref.LEAVES:
        close(ts.splats.params()[k], out[k], k)
        close(ts.opt.m[k], rm[k], f"m[{k}]")
        close(ts.opt.v[k], rv[k], f"v[{k}]")
    if reset:
        assert torch.all(torch.sigmoid(out["raw_opacity"]) < 0.0041)


def program_step(trainer, state, pose, gt):
    cam = Camera(position=pose["position"], rotation=pose["rotation"],
                 fov_x=pose["fov_x"], fov_y=pose["fov_y"])
    return trainer.step(state, train.SceneBatch(gt, cam, scene_extent=1.0))


def reference_step(params, m, v, count, pose, gt, it, cfg: TrainConfig):
    """One reference step: (loss, xy gradient, producing, params, m, v)."""
    cam = ref.make_cam(pose, SIZE, "cpu")
    loss, grads, xy, prod = dref.step_grads(params, cam, torch.as_tensor(gt),
                                            cfg.ssim_weight, (2, 128))
    lrs = ref.group_lrs(params["sh_coeffs"].shape[1], cfg.lr_mean_at(it),
                        "cpu")
    params, m, v = ref.adam(params, grads, m, v, count, lrs, eps=cfg.adam_eps)
    return loss, xy, prod, params, m, v


def views(seed, n=4):
    poses = uniform.ring_poses(n, 3.0, 1.2, SIZE)
    return poses, [uniform.colour_field(SIZE, seed, i, "cpu")
                   for i in range(n)]


def test_statistics_after_two_steps_match_the_reference():
    """Two SplatTrainer steps past warmup from zero statistics: each live
    row's gradient sum against the reference's screen-space gradient
    norms (the records carry colour and opacity as u16, so within 2e-3 of
    the largest), its count exactly, the padding rows untouched."""
    p = leaves(LIVE, 21)
    poses, gts = views(21)
    cfg = TrainConfig()
    trainer = train.SplatTrainer(cfg, raster_block_size=128)
    trainer.iter = 1010
    state = trainer.init_state(from_dense(**p, capacity=CAP, device="cpu"))
    params, m, v = dict(p), *({k: torch.zeros_like(x) for k, x in p.items()}
                              for _ in range(2))
    accum = torch.zeros(LIVE)
    counts = torch.zeros(LIVE, dtype=torch.int32)
    for j in range(2):
        state, _ = program_step(trainer, state, poses[j], gts[j])
        _, xy, prod, params, m, v = reference_step(params, m, v, j + 1,
                                                   poses[j], gts[j],
                                                   1010 + j, cfg)
        accum, counts = dref.add_statistics(accum, counts, xy, prod, SIZE)
    assert trainer.last_refine_stats is None
    got = state.grad_2d_accum
    assert float(accum.max()) > 0 and counts.max() == 2
    torch.testing.assert_close(got[:LIVE], accum, rtol=0,
                               atol=2e-3 * float(accum.max()))
    assert torch.equal(state.xy_grad_counts[:LIVE], counts)
    assert not got[LIVE:].any() and not state.xy_grad_counts[LIVE:].any()


def drawn_statistics(n, share, seed, thresh, steps=100):
    """Sums and counts as if `steps` steps had been seen: a share of rows
    at 1.5-2.5x the threshold, the rest at 0.05-0.5x."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 2), generator=g)
    rel = torch.where(u[:, 0] < share, 1.5 + u[:, 1], 0.05 + 0.45 * u[:, 1])
    return (thresh * rel * steps).to(torch.float32), torch.full(
        (n,), steps, dtype=torch.int32)


def test_trainer_across_shrink_and_grow_matches_the_reference():
    """SplatTrainer refining after every step from 3600 live rows in 8192,
    55 % of them under the cull opacity, with drawn statistics added
    before each step (the scene's way): the refine after iteration 0
    prunes those rows and shrinks the capacity to 4096, the one after 1
    densifies a quarter of the rows and grows it to 8192 again. After each
    refine the first n_live rows and moments against the reference's,
    which ran the same steps and refines on the live rows alone, by the
    bicycle-densify cell's numbers and limits; no average within 1e-3 of
    the threshold; the padding rows hold the padding fills."""
    limits = harness.load_json("workloads", "bicycle-densify.json")["limits"]
    live0, cap0 = 3600, 8192
    p = leaves(live0, 31, scale=0.06)
    low = torch.rand(live0, generator=torch.Generator().manual_seed(32)) < 0.55
    p["raw_opacity"] = torch.where(low, math.log(0.002 / 0.998),
                                   p["raw_opacity"])
    poses, gts = views(31)
    cfg = TrainConfig(warmup_steps=0, refine_every=1,
                      densify_grad_thresh=2e-3)
    rc = {k: getattr(cfg, k) for k in drv.REFINE_KEYS}
    trainer = train.SplatTrainer(cfg, raster_block_size=128)
    # Adam's moments resumed warm (count 100, v 1e-8): from zero moments
    # a first step moves every element by +-lr, its sign rounding's where
    # the gradient is all but zero, and one such flip among a few thousand
    # rows (not 3.67M) moves a leaf's norm gap past the cell's limit.
    state = trainer.init_state(from_dense(**p, capacity=cap0, device="cpu"))
    m = {k: torch.zeros_like(x) for k, x in p.items()}
    v = {k: torch.full_like(x, 1e-8) for k, x in p.items()}
    state.opt = optim.AdamState(
        m=dict(state.opt.m), v={k: torch.cat([x, torch.zeros(
            (cap0 - live0,) + x.shape[1:])]) for k, x in v.items()},
        count=100)
    gen = torch.Generator().manual_seed(cfg.seed)
    params = dict(p)
    base = {k: x.clone() for k, x in p.items()}
    caps = []
    for it in range(2):
        cap, n = state.splats.capacity, state.splats.n_live
        accum, counts = drawn_statistics(n, 0.04 if it == 0 else 0.25, it,
                                         cfg.densify_grad_thresh)
        state.grad_2d_accum[:n] += accum
        state.xy_grad_counts[:n] += counts
        state, _ = program_step(trainer, state, poses[it], gts[it])
        _, xy, prod, post, m, v = reference_step(params, m, v, it + 101,
                                                 poses[it], gts[it], it, cfg)
        if it > 0:
            accum, counts = dref.add_statistics(accum, counts, xy, prod,
                                                SIZE)
        near = drv.nearest(accum, counts, cfg.densify_grad_thresh)
        assert near["least_rel_to_thresh"] > 1e-3, near
        noise = [torch.randn((cap, 3), generator=gen)[:n] for _ in range(2)]
        params, m, v, st, src = dref.refine(post, params, m, v, accum,
                                            counts, *noise, rc, False)
        base = {k: x[src] for k, x in base.items()}
        live = state.splats.n_live
        assert live == st["live"] == trainer.last_refine_stats.n_live
        assert st["cloned"] + st["split"] > 0
        caps.append(state.splats.capacity)
        got = {k: x[:live] for k, x in state.splats.params().items()}
        moved = lambda d: compare._norms(
            {k: d[k] - base[k] for k in ref.LEAVES}, live)
        assert compare.norm_gap(moved(got), moved(params),
                                ref.LEAVES) <= limits["change_norm_gap"]
        for prog, want in ((state.opt.m, m), (state.opt.v, v)):
            assert compare.norm_gap(compare._norms(prog, live),
                                    compare._norms(want, live),
                                    ref.LEAVES) <= limits["moment_gap"]
        assert torch.all(state.splats.raw_opacity[live:]
                         == train.PADDING_RAW_OPACITY)
        assert not state.opt.m["means"][live:].any()
        assert not state.grad_2d_accum.any()
    assert caps == [cap0 // 2, cap0]
