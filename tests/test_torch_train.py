"""The port's training path against brush_tpu: SSIM and its gradient,
Adam, refine, and SplatTrainer steps, on numpy-seeded inputs (CPU
tensors, so the render runs through the plain versions of the kernels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brush_tpu.config as jconfig
import brush_tpu.optim as joptim
import brush_tpu.train as jtrain
from brush_tpu.camera import Camera as JCamera
from brush_tpu.splats import Splats as JSplats
from brush_tpu.splats import from_random as j_from_random
from brush_tpu.ssim import Ssim as JSsim

from brush_tpu_torch import optim, train
from brush_tpu_torch.camera import Camera
from brush_tpu_torch.config import TrainConfig
from brush_tpu_torch.convert import PARAM_NAMES, splats_from_numpy
from brush_tpu_torch.splats import PADDING_RAW_OPACITY, Splats
from brush_tpu_torch.ssim import Ssim
from test_e2e_train import make_gt_scene, orbit_camera, render_gt
from torch_threads import pin_threads

pin_threads()

T = lambda a: torch.tensor(np.asarray(a))
N = lambda t: t.detach().numpy()


def test_ssim_value_and_grad_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (1, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    b[0, :6, :6] = 0.0  # a flat region: the variance clamp ties at zero
    a[0, :6, :6] = 0.0
    j = JSsim(11, 3)
    val_j, g_j = jax.value_and_grad(j.ssim)(jnp.asarray(a), jnp.asarray(b))
    x = torch.tensor(a, requires_grad=True)
    val = Ssim(11, 3).ssim(x, torch.tensor(b))
    val.backward()
    assert abs(float(val.detach()) - float(val_j)) < 1e-6
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(N(x.grad), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())


def test_adam_matches_reference_with_sh_learning_rates():
    rng = np.random.default_rng(1)
    shapes = {"means": (50, 3), "sh_coeffs": (50, 4, 3), "quats": (50, 4),
              "raw_opacity": (50,), "log_scales": (50, 3)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    sh_scale = np.array([1.0, 0.05, 0.05, 0.05], np.float32).reshape(1, 4, 1)
    lrs_j = {"means": 1.6e-4, "sh_coeffs": 4e-3 * jnp.asarray(sh_scale),
             "quats": 2e-3, "raw_opacity": 5e-2, "log_scales": 1e-2}
    lrs_t = dict(lrs_j, sh_coeffs=4e-3 * torch.tensor(sh_scale))
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    p_t = {k: T(v) for k, v in params.items()}
    s_j, s_t = joptim.init_adam(p_j), optim.init_adam(p_t)
    for it in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        p_j, s_j = joptim.adam_step(p_j, {k: jnp.asarray(g) for k, g in
                                          grads.items()}, s_j, lrs_j)
        p_t, s_t = optim.adam_step(p_t, {k: T(g) for k, g in grads.items()},
                                   s_t, lrs_t)
        assert s_t.count == int(s_j.count) == it + 1
    for k in shapes:
        np.testing.assert_allclose(N(p_t[k]), np.asarray(p_j[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(N(s_t.m[k]), np.asarray(s_j.m[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(N(s_t.v[k]), np.asarray(s_j.v[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)


def refine_inputs(cap=96, n_live=64, seed=2):
    """A post-step state and its pre-step splats: splats that clone (small,
    high gradient), split (large, high gradient), prune on opacity or scale,
    and padding rows; moments and step count as a trainer leaves them."""
    rng = np.random.default_rng(seed)
    n = n_live
    quats = rng.normal(size=(cap, 4)) * rng.uniform(0.5, 2.0, (cap, 1))
    post = {
        "means": rng.normal(size=(cap, 3)),
        "sh_coeffs": rng.normal(size=(cap, 4, 3)),
        "quats": quats,
        "raw_opacity": rng.normal(0.0, 2.0, cap),
        "log_scales": rng.uniform(-7.0, 0.5, (cap, 3)),
    }
    post["raw_opacity"][:6] = -7.0         # below the cull alpha
    post["log_scales"][6:10, 1] = 2.0      # above the cull scale
    post["log_scales"][10:24] = rng.uniform(-7.0, -5.5, (14, 3))  # clones
    post = {k: v.astype(np.float32) for k, v in post.items()}
    pre = {k: (v + rng.normal(0, 0.01, v.shape)).astype(np.float32)
           for k, v in post.items()}
    for d in (post, pre):
        d["means"][n:] = 0.0
        d["sh_coeffs"][n:] = 0.0
        d["quats"][n:] = [1.0, 0.0, 0.0, 0.0]
        d["raw_opacity"][n:] = PADDING_RAW_OPACITY
        d["log_scales"][n:] = -10.0
    accum = np.where(np.arange(cap) < n, rng.uniform(0, 8e-4, cap),
                     0.0).astype(np.float32)
    counts = np.where(np.arange(cap) < n, rng.integers(0, 5, cap),
                      0).astype(np.int32)
    m = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in post.items()}
    v = {k: rng.uniform(0, 1, v.shape).astype(np.float32)
         for k, v in post.items()}
    return post, pre, accum, counts, m, v


@pytest.mark.parametrize("do_reset", [False, True])
@pytest.mark.parametrize("keep_opt", [True, False])
@pytest.mark.parametrize("faithful", [False, True])
def test_refine_matches_reference(do_reset, keep_opt, faithful):
    """make_refine_fn against the JAX package's on the same state, with the
    split noise JAX draws from its key injected into the port's."""
    cap, n_live = 96, 64
    post, pre, accum, counts, m, v = refine_inputs(cap, n_live)
    kw = dict(keep_opt_state_on_refine=keep_opt, faithful_split_bug=faithful)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (cap, 3)))
    noise2 = np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                          (cap, 3)))

    jstate = jtrain.TrainState(
        splats=JSplats(n_live=jnp.int32(n_live),
                       **{k: jnp.asarray(x) for k, x in post.items()}),
        opt=joptim.AdamState(m={k: jnp.asarray(x) for k, x in m.items()},
                             v={k: jnp.asarray(x) for k, x in v.items()},
                             count=jnp.int32(9)),
        grad_2d_accum=jnp.asarray(accum), xy_grad_counts=jnp.asarray(counts))
    jpre = JSplats(n_live=jnp.int32(n_live),
                   **{k: jnp.asarray(x) for k, x in pre.items()})
    js, jstats = jax.jit(jtrain.make_refine_fn(
        jconfig.TrainConfig(**kw), cap, do_reset))(jstate, jpre, key)

    tstate = train.TrainState(
        splats=Splats(n_live=n_live, **{k: T(x) for k, x in post.items()}),
        opt=optim.AdamState(m={k: T(x) for k, x in m.items()},
                            v={k: T(x) for k, x in v.items()}, count=9),
        grad_2d_accum=T(accum), xy_grad_counts=T(counts))
    tpre = Splats(n_live=n_live, **{k: T(x) for k, x in pre.items()})
    ts, tstats = train.make_refine_fn(TrainConfig(**kw), cap, do_reset)(
        tstate, tpre, noise=T(noise), noise2=T(noise2))

    assert tuple(tstats) == tuple(int(x) for x in jstats)
    assert tstats.num_cloned > 0 and tstats.num_split > 0
    assert tstats.num_pruned_alpha > 0 and tstats.num_pruned_scale > 0
    assert ts.splats.n_live == int(js.splats.n_live) == tstats.n_live
    # Float32 ulps: quat_rotate and the log/exp/sigmoid round as XLA's do
    # to within a few units in the last place.
    close = lambda a, b, what: np.testing.assert_allclose(
        N(a), np.asarray(b), rtol=2e-6, atol=1e-7, err_msg=what)
    for k in PARAM_NAMES:
        close(getattr(ts.splats, k), getattr(js.splats, k), k)
        close(ts.opt.m[k], js.opt.m[k], f"m[{k}]")
        close(ts.opt.v[k], js.opt.v[k], f"v[{k}]")
    assert ts.opt.count == int(js.opt.count)
    assert not ts.grad_2d_accum.any() and not ts.xy_grad_counts.any()


def gt_views(size=48, n_views=4):
    """make_gt_scene's splats rendered by the JAX oracle from an orbit."""
    gt = make_gt_scene()
    cams = [orbit_camera(2 * np.pi * i / n_views) for i in range(n_views)]
    return [(c, render_gt(gt, c, size)[..., :3].copy()) for c in cams]


def as_port_camera(c: JCamera) -> Camera:
    return Camera(position=c.position, rotation=c.rotation, fov_x=c.fov_x,
                  fov_y=c.fov_y)


def steps_match_reference(steps, **knobs):
    """`steps` SplatTrainer steps (five in the measurements below; no
    refine: warmup is 500) from the same init on the same views. The JAX trainer renders through its XLA path
    on the CPU, which does not quantize colour and opacity to u16 as the
    record pipeline does, so the two differ by the quantization's effect,
    not bit for bit. The loss (0.8 L1 - 0.2 SSIM, about -0.01 to -0.06
    here, so a relative bound means little near its zero) differed by at
    most 2.5e-6 over the five steps; the bound is 1e-5. Adam divides each
    gradient by its own running RMS, so a parameter whose gradient is near
    zero can step either way on a difference that small: 99 % of each
    parameter's entries must agree within 2 % of how far the reference
    moved them (measured <= 0.9 %, the quaternions), and none by more than
    that distance (measured 29 % for one quaternion entry, <= 0.7 % for
    every other parameter). `knobs` go to both trainers."""
    views = gt_views()
    js = j_from_random(np.random.default_rng(1), [-1.5] * 3, [1.5] * 3,
                       count=200, sh_degree=1)
    params = {k: np.asarray(x) for k, x in js.params().items()}
    ts = splats_from_numpy(params, int(js.n_live), device="cpu")

    jt = jtrain.SplatTrainer(**knobs)
    tt = train.SplatTrainer(**knobs)
    jstate, tstate = jt.init_state(js), tt.init_state(ts)
    for it in range(steps):
        cam, img = views[it % len(views)]
        jstate, jst = jt.step(jstate, jtrain.SceneBatch(img, cam))
        tstate, tst = tt.step(tstate, train.SceneBatch(img,
                                                       as_port_camera(cam)))
        lj, lt = float(jst.loss), float(tst.loss)
        assert abs(lt - lj) <= 1e-5, (it, lt, lj)
        assert int(tst.num_dropped) == 0
        assert int(tst.num_visible) == int(jst.num_visible)
    assert tt.iter == steps and tstate.opt.count == steps
    for k in PARAM_NAMES:
        a = N(getattr(tstate.splats, k))
        b = np.asarray(getattr(jstate.splats, k))
        moved = np.abs(b - params[k]).max()
        assert moved > 0, k
        d = np.abs(a - b)
        assert np.quantile(d, 0.99) <= 0.02 * moved, k
        assert d.max() <= moved, k
    np.testing.assert_array_equal(N(tstate.xy_grad_counts),
                                  np.asarray(jstate.xy_grad_counts))


def test_trainer_steps_match_reference():
    steps_match_reference(5)


def test_trainer_knobs_match_reference(monkeypatch):
    """raster_block_size and pack_grad_sort reach render_splats, and three
    steps with pack_grad_sort=False (the gradient rows ride the re-sort in
    full float32) match the JAX trainer with the same setting, at the
    bounds of steps_match_reference."""
    seen = []
    render = train.render_splats

    def spy(*args, **kwargs):
        seen.append((kwargs["block_size"], kwargs["pack_grad_sort"]))
        return render(*args, **kwargs)

    monkeypatch.setattr(train, "render_splats", spy)
    steps_match_reference(3, raster_block_size=64, pack_grad_sort=False)
    assert seen == [(64, False)] * 3
    assert train.SplatTrainer().raster_block_size == 32
    assert train.SplatTrainer().pack_grad_sort is True


def test_trainer_refine_grows_capacity_and_stays_consistent():
    """A port-only run with chip_smoke.py's bench config (warmup 1, refine
    every 3) that refines at iterations 1 and 4: the first goes through the
    pre-grow path (capacity == live count) with no statistics yet (the
    gate opens after warmup), the second densifies. Every array stays
    finite, sized to the capacity, and inert past n_live."""
    views = gt_views(size=32)
    js = j_from_random(np.random.default_rng(3), [-1.5] * 3, [1.5] * 3,
                       count=128, sh_degree=1, capacity=128)
    ts = splats_from_numpy({k: np.asarray(x) for k, x in js.params().items()},
                           128, device="cpu")
    cfg = TrainConfig(warmup_steps=1, refine_every=3,
                      densify_grad_thresh=1e-6)
    tt = train.SplatTrainer(cfg)
    state = tt.init_state(ts)
    refines = []
    for it in range(6):
        cam, img = views[it % len(views)]
        state, st = tt.step(state, train.SceneBatch(img, as_port_camera(cam)))
        assert np.isfinite(float(st.loss))
        if tt.last_refine_stats is not None:
            refines.append((it, tt.last_refine_stats))
    assert [it for it, _ in refines] == [1, 4]
    first, second = refines[0][1], refines[1][1]
    assert first.num_cloned + first.num_split == 0
    assert second.num_cloned + second.num_split > 0
    sp = state.splats
    cap, n = sp.capacity, sp.n_live
    assert cap > 128 and 0 < n <= cap and 2 * n <= cap
    for k, x in sp.params().items():
        assert x.shape[0] == cap and torch.isfinite(x).all(), k
        assert state.opt.m[k].shape == x.shape == state.opt.v[k].shape, k
    assert torch.all(sp.raw_opacity[n:] == PADDING_RAW_OPACITY)
    assert torch.all(sp.log_scales[n:] == -10.0)
    assert torch.all(sp.quats[n:] == torch.tensor([1.0, 0.0, 0.0, 0.0]))
    assert not sp.means[n:].any() and not sp.sh_coeffs[n:].any()
    assert state.grad_2d_accum.shape == (cap,)
    assert state.xy_grad_counts.shape == (cap,)


def test_trainer_doubles_the_pool_after_an_overflow():
    """A step that drops records doubles the pool for the next one
    (train.py:179-193 of the reference); a drop at an already-doubled pool
    size is not answered twice."""
    views = gt_views(size=48)
    js = j_from_random(np.random.default_rng(4), [-1.5] * 3, [1.5] * 3,
                       count=600, sh_degree=0)
    ts = splats_from_numpy({k: np.asarray(x) for k, x in js.params().items()},
                           600, device="cpu")
    tt = train.SplatTrainer()
    state = tt.init_state(ts)
    tt._isect_pool = 512
    cam, img = views[0]
    batch = train.SceneBatch(img, as_port_camera(cam))
    state, st = tt.step(state, batch)
    assert int(st.num_dropped) > 0 and tt._isect_pool == 512
    state, st2 = tt.step(state, batch)
    assert tt.total_dropped_records == int(st.num_dropped)
    assert tt._isect_pool == 1024
    tt.step(state, batch)
    assert tt._isect_pool == (2048 if int(st2.num_dropped) else 1024)


def test_grow_then_shrink_keeps_the_live_rows():
    post, _, accum, counts, m, v = refine_inputs(cap=96, n_live=64)
    state = train.TrainState(
        splats=Splats(n_live=64, **{k: T(x) for k, x in post.items()}),
        opt=optim.AdamState(m={k: T(x) for k, x in m.items()},
                            v={k: T(x) for k, x in v.items()}, count=3),
        grad_2d_accum=T(accum), xy_grad_counts=T(counts))
    tt = train.SplatTrainer()
    grown = tt._grow(state, 1000)
    sp = grown.splats
    assert sp.capacity == 1024 and sp.n_live == 64
    assert torch.all(sp.raw_opacity[96:] == PADDING_RAW_OPACITY)
    assert torch.all(sp.log_scales[96:] == -10.0)
    assert torch.all(sp.quats[96:] == torch.tensor([1.0, 0.0, 0.0, 0.0]))
    assert not grown.opt.m["means"][96:].any()
    assert grown.xy_grad_counts.dtype == torch.int32
    shrunk = tt._shrink(grown, 300)
    assert shrunk.splats.capacity == 512
    for k in PARAM_NAMES:
        assert torch.equal(getattr(shrunk.splats, k)[:96], T(post[k]))
        assert torch.equal(shrunk.opt.v[k][:96], T(v[k]))
    assert tt._shrink(grown, 1024) is grown
