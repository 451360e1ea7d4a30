"""The port's scale harnesses against the JAX repo's: scripts/torch_probe_5m.py
against scripts/probe_5m.py and scripts/torch_scaling_bench.py against
scripts/scaling_bench.py, on the CPU at small sizes.

- The probe step (scene, render with gradients, L1, backward, Adam) at
  2048 splats, SH degree 3, 64x64 and the probe's pool 2n, against the
  same composition in brush_tpu (render_splats(backend="pallas"), the
  Pallas kernels in interpret mode; brush_tpu.optim.adam_step), both from
  the same numpy draws. Tolerances: the loss within 2e-4, the image bound
  of assert_close_quantized's default (a mean of |img| moves no more);
  records and drops equal; the gradients (Adam's first moments over 1 -
  beta1) by tests/test_torch_render_grads.py's "bf16_pairs" rule, the
  reference's default packing (3e-4 of each leaf's largest, flips up to
  6e-3 in at most 5e-3 of the entries); the updated parameters within
  1e-6 wherever the two gradients agree in sign (one Adam step from zero
  moments moves each entry by lr sign(g)), and where they do not, both
  gradients within 3e-4 of the leaf's largest of zero.
- The probe's memory budget, equal to scripts/probe_5m.py's own lines.
- The default pool's ceiling at the probe's scale (ROADMAP Queue 3 #15),
  in both packages' pool arithmetic.
- project_efficiency equal to the JAX script's on a grid of inputs.
- The harness at --cpu 2 (gloo processes, a file store under tmp_path, as
  tests/test_torch_sharded.py runs its ranks): two world sizes and the
  projection.
"""

import ast
import functools
import importlib.util
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brush_tpu.camera import Camera as JCamera
from brush_tpu.ops.pallas.expand import expand_pallas as j_expand_pallas
from brush_tpu.ops.rasterize_reference import camera_params as j_cp
from brush_tpu.optim import adam_step as j_adam_step
from brush_tpu.optim import init_adam as j_init_adam
from brush_tpu.render import render_splats as j_render
from brush_tpu.splats import from_random as j_from_random
from brush_tpu.train import SplatTrainer as JSplatTrainer
from conftest import assert_close_quantized

from brush_tpu_torch.ops.cuda.expand import expand
from brush_tpu_torch.render import pool_size
from brush_tpu_torch.train import SplatTrainer, StepStats
from brush_tpu_torch.utils import profiler
from test_torch_cuda import TRAIN_STAGES
from torch_threads import pin_threads

pin_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SIZE = 2048, 64
# The probe scene's records on its first step (5,242,880 splats at
# 1248x1248), as scripts/torch_probe_5m.py counts them on an NVIDIA H100
# 80GB HBM3 (PERF.md §4, "bicycle").
SCALE_RECORDS = 8_524_747


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


probe = load("scripts/torch_probe_5m.py", "torch_probe_5m")
bench = load("scripts/torch_scaling_bench.py", "torch_scaling_bench")


@functools.cache
def reference():
    """brush_tpu's probe step on the small scene: (params, loss, records,
    dropped, new params, first moments), numpy."""
    pool = probe.probe_pool(N)
    js = j_from_random(np.random.default_rng(0), [-4] * 3, [4] * 3,
                       count=N, sh_degree=3, capacity=N)
    js = js.replace(log_scales=jnp.full_like(js.log_scales, np.log(0.01)))
    cam = JCamera(position=[0, 0, -10.0], rotation=[1, 0, 0, 0],
                  fov_x=np.pi / 2, fov_y=np.pi / 2)
    cp = j_cp(cam, (SIZE, SIZE))
    gt = jnp.zeros((SIZE, SIZE, 3), jnp.float32)

    def loss_fn(p):
        img, aux = j_render(p["means"], p["log_scales"], p["quats"],
                            p["sh_coeffs"], p["raw_opacity"], cp,
                            (SIZE, SIZE), block_size=512, max_isects=pool,
                            backend="pallas")
        return jnp.mean(jnp.abs(img[..., :3] - gt)), aux

    params = js.params()
    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    new, opt = j_adam_step(params, grads, j_init_adam(params), probe.LRS)
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}
    return (as_np(params), float(loss), int(aux.num_isects),
            int(aux.num_dropped), as_np(new), as_np(opt.m))


def test_probe_step_matches_reference():
    params_j, loss_j, records_j, dropped_j, new_j, m_j = reference()
    splats, _, cp, gt = probe.make_scene(N, SIZE, "cpu")
    params = splats.params()
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), params_j[k], err_msg=k)
    new, opt, loss, records, dropped = probe.probe_step(
        params, probe.init_adam(params), cp, (SIZE, SIZE), gt,
        probe.probe_pool(N))
    assert (int(records), int(dropped)) == (records_j, dropped_j)
    assert records_j > N and dropped_j == 0
    assert abs(float(loss) - loss_j) <= 2e-4 and loss_j > 0
    beta1 = 0.9
    for k in params:
        g_j = m_j[k] / (1 - beta1)
        g = opt.m[k].numpy() / (1 - beta1)
        scale = np.abs(g_j).max()
        if scale == 0:
            # Isotropic scales: the rotation moves nothing.
            assert k == "quats" and not g.any()
            np.testing.assert_array_equal(new[k].numpy(), new_j[k])
            continue
        assert_close_quantized(g / scale, g_j / scale, atol=3e-4,
                               flip_tol=6e-3, max_flip_frac=5e-3, err_msg=k)
        same = np.sign(g) == np.sign(g_j)
        np.testing.assert_allclose(new[k].numpy()[same], new_j[k][same],
                                   rtol=0, atol=1e-6, err_msg=k)
        assert (np.maximum(np.abs(g), np.abs(g_j))[~same]
                <= 3e-4 * scale).all(), k


def probe_budget_lines():
    """scripts/probe_5m.py's pool and budget assignments (in main), as
    (name, expression) source pairs."""
    with open(os.path.join(ROOT, "scripts", "probe_5m.py")) as f:
        tree = ast.parse(f.read())
    main = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    return [(node.targets[0].id, ast.unparse(node.value))
            for node in main.body if isinstance(node, ast.Assign)
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id in ("max_isects", "param_gb", "pool_gb")]


@pytest.mark.parametrize("n_m", [5.0, 1.0, 0.25, 2.7, 7.3])
def test_probe_budget_matches_reference(n_m):
    lines = probe_budget_lines()
    assert [name for name, _ in lines] == ["max_isects", "param_gb",
                                           "pool_gb"]
    n = probe.splat_count(n_m)
    assert n == int(n_m * (1 << 20))
    env = {"n": n}
    for name, expr in lines:
        env[name] = eval(expr, {}, env)
    assert probe.probe_pool(n) == env["max_isects"]
    assert probe.budget_gb(n, env["max_isects"]) == (env["param_gb"],
                                                     env["pool_gb"])
    if n_m == 5.0:
        assert (n, env["max_isects"]) == (5_242_880, 10_485_760)


def test_default_pool_reaches_the_expand_ceiling_like_the_reference():
    """ROADMAP Queue 3 #15, pinned: a SplatTrainer at the probe's scale
    starts its pool at min(16 x capacity, 2^22) = 4,194,304 and doubles it
    after each step that drops records; 8,524,747 records overflow
    8,388,608 too, so the third step asks for 2^24, which expand refuses
    (the port's wrapper and brush_tpu's expand_pallas alike:
    brush_tpu/ops/pallas/expand.py:395). The reference's trainer
    (brush_tpu/train.py:183-188, :248-251) gives the same pools; the
    probe's pool 2n holds every record."""
    cap = probe.splat_count(5.0)
    trainer = SplatTrainer()
    pools = [trainer._pool_size(cap)]
    while pools[-1] < SCALE_RECORDS:
        n_int = lambda v: torch.tensor(v, dtype=torch.int32)
        trainer._note_drops(StepStats(
            loss=torch.tensor(0.0), num_visible=n_int(cap),
            num_isects=n_int(pools[-1]),
            num_dropped=n_int(SCALE_RECORDS - pools[-1]),
            max_strip_isects=n_int(pools[-1])), pools[-1])
        trainer._respond_to_drops()
        pools.append(trainer._pool_size(cap))
    assert pools == [1 << 22, 1 << 23, 1 << 24]
    assert pool_size(cap, (1248, 1248), pools[-1]) == 1 << 24
    one = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"2\^24"):
        expand(torch.zeros((5, 1)), torch.zeros((5, 1), dtype=torch.int32),
               one, one, 1, 1, pools[-1])

    ref = JSplatTrainer()
    j_pools = [ref._pool_size(cap)]
    while j_pools[-1] < SCALE_RECORDS:
        # brush_tpu/train.py:183-188: any dropped record doubles the pool
        # the step used.
        ref._isect_pool = ref._pool_size(cap) * 2
        j_pools.append(ref._pool_size(cap))
    assert j_pools == pools
    with pytest.raises(AssertionError, match="offset sentinel"):
        j_expand_pallas(jnp.zeros((1, 1), jnp.bfloat16),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,),
                                                              jnp.int32),
                        1, 1, 1, j_pools[-1])
    assert probe.probe_pool(cap) >= SCALE_RECORDS


def test_project_efficiency_matches_reference():
    j_project = load("scripts/scaling_bench.py",
                     "scaling_bench").project_efficiency
    buckets = [
        {"proj": 7.1, "sort_rep": 6.6, "pool": 40.9},
        {"fwd": {"proj": 7.1, "sort_rep": 6.6, "pool": 40.9},
         "bwd": {"proj": 1.0, "sort_rep": 5.5, "pool": 45.9}},
        {"fwd": {"proj": 48.6, "sort_rep": 3.16, "pool": 1.1},
         "bwd": {"proj": 12.5, "sort_rep": 0.35, "pool": 3.8}},
        {"fwd": {"pool": 3.0}, "bwd": {}},
        {"proj": 0.0, "sort_rep": 0.0, "pool": 0.0},
    ]
    for stages in buckets:
        for n_dev in (1, 2, 3, 4, 8, 16):
            for slack in (2.0, 1.3, 1.0, 0.5):
                for n_splats in (1 << 17, 1 << 20, 5_242_880):
                    for gbps in (90.0, bench.NVLINK_GBPS):
                        args = (stages, n_dev, slack, n_splats, gbps)
                        assert bench.project_efficiency(*args) == \
                            j_project(*args), args
    assert bench.project_efficiency(buckets[1], 4, 1.3) == j_project(
        buckets[1], 4, 1.3, ici_gbps=bench.NVLINK_GBPS)


def test_host_clock_records_every_stage_of_a_cpu_step():
    """profiler.record(host=True), which the harness's CPU ranks read: a
    CPU SplatTrainer step's marks, every stage once in order, by the host
    clock; record() without it still needs CUDA."""
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.splats import from_random
    from brush_tpu_torch.train import SceneBatch

    sp = from_random(np.random.default_rng(0), [-1] * 3, [1] * 3, count=256,
                     sh_degree=1, device="cpu")
    trainer = SplatTrainer()
    state = trainer.init_state(sp)
    batch = SceneBatch(np.zeros((48, 64, 3), np.float32),
                       Camera(position=[0, 0, -5.0], rotation=[1, 0, 0, 0],
                              fov_x=1.0, fov_y=1.0))
    with profiler.record(host=True) as entries:
        trainer.step(state, batch)
    stages = profiler.chain(entries)
    assert [name for name, _ in stages] == TRAIN_STAGES
    assert all(ms >= 0.0 for _, ms in stages) and profiler._marks is None
    buckets, other = bench.bucket_ms(dict(stages))
    assert set(other) == {"upload", "assemble", "loss", "loss backward",
                          "densify_stats", "adam", "step end"}
    assert all(v > 0 for parts in buckets.values() for v in parts.values())


def test_scaling_bench_two_cpu_ranks(tmp_path):
    """The harness at --cpu 2 on a tiny scene: a line for world sizes 1
    and 2 (the second's efficiency against the first's), the buckets
    and the projection's 15 lines, each at n_dev 1 fully efficient."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env.update(OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "torch_scaling_bench.py"),
         "--cpu", "2", "--splats", "256", "--size", "64", "--steps", "2",
         "--store", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    worlds = re.findall(r"world size +(\d+) +([\d.]+) ms/step +([\d.]+) it/s"
                        r" +scaling efficiency +([\d.]+)%", out.stdout)
    assert [int(w[0]) for w in worlds] == [1, 2]
    assert float(worlds[0][3]) == 100.0 and float(worlds[1][1]) > 0
    assert "plumbing only" in out.stdout
    assert "stage buckets at world size 1" in out.stdout
    proj = re.findall(r"n_dev= *(\d+) slack=([\d.]+): +([\d.]+) ms .* "
                      r"efficiency (\d+)%", out.stdout)
    assert len(proj) == 15
    assert all(int(p[3]) == 100 for p in proj if p[0] == "1")
