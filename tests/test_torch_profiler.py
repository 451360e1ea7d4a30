"""The port's profiler hooks (brush_tpu_torch/utils/profiler.py): a Chrome
trace of a render holding its spans, nested; the stages, children and
counters a recorded CPU training step yields; a step outside record()
making no event, range or autograd node and computing the recorded
step's bits; and the benchmark's readers of the new entries."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.render import pool_size, render_splats
from brush_tpu_torch.splats import from_random
from brush_tpu_torch.train import SceneBatch, SplatTrainer
from brush_tpu_torch.utils import profiler
from test_torch_cuda import TRAIN_STAGES
from torch_threads import pin_threads

pin_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD_INPUTS_PARTS = ["record_inputs/project", "record_inputs/sh",
                       "record_inputs/tile_pretest", "record_inputs/pack"]
BACKWARD_PARTS = ["backward/sh", "backward/project"]
COUNTERS = ["#live", "#capacity", "#rows", "#visible", "#records",
            "#pool_slots"]
REFINE_PARTS = ["refine/select", "refine/compact", "refine/moments",
                "refine/resize"]
REFINE_COUNTERS = ["#cloned", "#split", "#pruned"]
CAM = dict(position=[0, 0, -5.0], rotation=[1, 0, 0, 0], fov_x=1.0,
           fov_y=1.0)


def trainer_and_state(count: int = 256):
    sp = from_random(np.random.default_rng(0), [-1] * 3, [1] * 3,
                     count=count, sh_degree=1, device="cpu")
    trainer = SplatTrainer()
    return trainer, trainer.init_state(sp)


def batch():
    gt = np.random.default_rng(1).uniform(0, 1, (48, 64, 3))
    return SceneBatch(gt.astype(np.float32), Camera(**CAM))


def test_trace_writes_a_chrome_trace_of_a_render(tmp_path):
    """trace(dir) around a render on the CPU writes one Chrome trace that
    holds the span and the render's operators; neither trace nor span
    turns recording on."""
    sp = from_random(np.random.default_rng(0), [-1] * 3, [1] * 3, count=64,
                     sh_degree=0, device="cpu")
    cam = camera_params(Camera(position=[0, 0, -4.0], rotation=[1, 0, 0, 0],
                               fov_x=0.8, fov_y=0.8), (32, 32), device="cpu")
    with profiler.trace(str(tmp_path / "trace")):
        with profiler.span("frame"):
            img, _ = render_splats(sp.means, sp.log_scales, sp.quats,
                                   sp.sh_coeffs, sp.raw_opacity, cam,
                                   (32, 32), active=sp.active_mask(),
                                   needs_grad=False)
        assert profiler._marks is None
    files = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "frame" in names and "aten::sort" in names
    assert "frame/record_inputs/tile_pretest" in names
    assert img.shape == (32, 32, 4)


def test_trace_nests_the_pretest_range_in_record_inputs(tmp_path):
    """A training step under profiler.trace, nothing recorded: the trace
    holds the stage range `record_inputs` and, inside its interval, the
    child range `record_inputs/tile_pretest` with aten ops inside it."""
    trainer, state = trainer_and_state()
    with profiler.trace(str(tmp_path)):
        trainer.step(state, batch())
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]

    def one(name):
        (e,) = [e for e in events if e.get("name") == name]
        return e["ts"], e["ts"] + e["dur"]

    parent, child = one("record_inputs"), one("record_inputs/tile_pretest")
    assert parent[0] <= child[0] < child[1] <= parent[1]
    inside = [e["name"] for e in events
              if e.get("name", "").startswith("aten::")
              and child[0] <= e["ts"] and e["ts"] + e["dur"] <= child[1]]
    assert inside, "no aten op inside the pretest's range"
    for stage in ("upload", "depth_order", "expand", "tile_bins",
                  "rasterize_fwd", "assemble", "loss", "densify_stats",
                  "adam"):
        one(stage)


def test_spans_nest_without_moving_the_chain(monkeypatch):
    """By a host clock that ticks 1 s a read: a child is timed from its own
    start to its own end and is entered as <parent>/<child>; the stage
    after it still counts from the previous stage's end; counters keep
    their values; outside record() a span is the shared no-op."""
    ticks = iter(range(100))
    monkeypatch.setattr(profiler.time, "perf_counter", lambda: next(ticks))
    with profiler.record(host=True) as stages:          # start: tick 0
        with profiler.span("a"):
            with profiler.span("b"):                    # ticks 1, 2
                pass
            with profiler.span("c"):                    # ticks 3, 6
                with profiler.span("d"):                # ticks 4, 5
                    pass
        profiler.count("n", 7)                          # a ends: tick 7
        profiler.count("t", torch.tensor(5, dtype=torch.int32))
        profiler.mark("e")                              # tick 8
    assert stages == [("a/b", 1e3), ("a/c/d", 1e3), ("a/c", 3e3),
                      ("a", 7e3), ("#n", 7), ("#t", 5), ("e", 1e3)]
    assert profiler.chain(stages) == [("a", 7e3), ("e", 1e3)]
    assert profiler.span("off") is profiler._OFF
    assert profiler.grad_span("off") is profiler._NO_GRAD_SPAN


def test_recorded_cpu_step_holds_children_and_counters():
    """One recorded CPU SplatTrainer step: the chain exactly as the stages
    were marked before (TRAIN_STAGES), the four children of record_inputs
    before it and summing to at most it, the two backward children after
    to_global and summing to at most autograd rest, and the four counters
    equal to the step's own numbers and pool."""
    trainer, state = trainer_and_state()
    b = batch()
    with profiler.record(host=True) as stages:
        _, stats = trainer.step(state, b)
    names = [name for name, _ in stages]
    assert [name for name, _ in profiler.chain(stages)] == TRAIN_STAGES
    assert sorted(n for n in names if "/" in n) == sorted(
        RECORD_INPUTS_PARTS + BACKWARD_PARTS)
    assert sorted(n for n in names if n[0] == "#") == sorted(COUNTERS)
    at = {name: i for i, name in enumerate(names)}
    assert [at[n] for n in RECORD_INPUTS_PARTS] == sorted(
        at[n] for n in RECORD_INPUTS_PARTS)
    assert max(at[n] for n in RECORD_INPUTS_PARTS) < at["record_inputs"]
    for n in BACKWARD_PARTS:
        assert at["to_global"] < at[n] < at["autograd rest"]
    v = dict(stages)
    assert all(v[n] >= 0.0 for n in RECORD_INPUTS_PARTS + BACKWARD_PARTS)
    assert sum(v[n] for n in RECORD_INPUTS_PARTS) <= v["record_inputs"]
    assert sum(v[n] for n in BACKWARD_PARTS) <= v["autograd rest"]
    assert v["#rows"] == v["#capacity"] == state.splats.capacity
    assert v["#live"] == state.splats.n_live
    assert v["#visible"] == int(stats.num_visible)
    assert v["#records"] == int(stats.num_isects)
    h, w = b.gt_image.shape[:2]
    assert v["#pool_slots"] == pool_size(
        state.splats.capacity, (w, h),
        trainer._pool_size(state.splats.capacity),
        trainer.raster_block_size)
    assert profiler._marks is None


def refining_trainer(count: int = 256):
    """A trainer that refines after odd iterations (warmup 0, every 2),
    with a threshold low enough that some rows densify."""
    from brush_tpu_torch.config import TrainConfig

    sp = from_random(np.random.default_rng(0), [-1] * 3, [1] * 3,
                     count=count, sh_degree=1, device="cpu")
    trainer = SplatTrainer(TrainConfig(warmup_steps=0, refine_every=2,
                                       densify_grad_thresh=1e-6))
    trainer.iter = 1
    return trainer, trainer.init_state(sp)


def test_recorded_refine_holds_its_children_and_counters():
    """A recorded CPU step that refines: the stage `refine` after `adam`,
    its four children before it and summing to at most it, and the
    counters #cloned, #split and #pruned equal to the refine's own
    numbers beside #live and #capacity of the rows the step ran over; the
    next step, which does not refine, has no refine entry and only the
    per-step counters."""
    trainer, state = refining_trainer()
    b = batch()
    with profiler.record(host=True) as stages:
        new_state, _ = trainer.step(state, b)
    names = [name for name, _ in stages]
    chain = [name for name, _ in profiler.chain(stages)]
    assert chain == TRAIN_STAGES[:-1] + ["refine", "step end"]
    # The capacity equals the live count, so `refine/resize` comes twice:
    # the pre-grow and the grow or shrink after the refine.
    assert sorted(n for n in names if n.startswith("refine/")) == sorted(
        REFINE_PARTS + ["refine/resize"])
    at = {name: i for i, name in enumerate(names)}
    assert max(at[n] for n in REFINE_PARTS) < at["refine"]
    assert at["adam"] < min(at[n] for n in REFINE_PARTS)
    assert sorted(n for n in names if n[0] == "#") == sorted(
        COUNTERS + REFINE_COUNTERS)
    v = dict(stages)
    assert sum(ms for n, ms in stages if n in REFINE_PARTS) <= v["refine"]
    rs = trainer.last_refine_stats
    assert rs.num_cloned + rs.num_split > 0
    assert (v["#cloned"], v["#split"], v["#pruned"]) == (
        rs.num_cloned, rs.num_split,
        rs.num_pruned_alpha + rs.num_pruned_scale)
    assert (v["#live"], v["#capacity"]) == (256, 256)

    with profiler.record(host=True) as stages:
        trainer.step(new_state, b)
    names = [name for name, _ in stages]
    assert trainer.last_refine_stats is None
    assert not [n for n in names if n.startswith("refine")]
    assert sorted(n for n in names if n[0] == "#") == sorted(COUNTERS)
    v = dict(stages)
    assert (v["#live"], v["#capacity"]) == (
        new_state.splats.n_live, new_state.splats.capacity)


def test_unrecorded_step_makes_no_event_range_or_node(monkeypatch):
    """Outside record(), with CUDA events, record_function ranges and the
    grad spans' autograd Function made to raise, a step runs; its loss and
    new parameters are bit-equal to a recorded step's from the same
    state."""
    plain_trainer, plain_state = trainer_and_state()
    rec_trainer, rec_state = trainer_and_state()
    b = batch()
    with profiler.record(host=True) as stages:
        rec_state, rec_stats = rec_trainer.step(rec_state, b)
    assert "backward/sh" in dict(stages)

    def refuse(*a, **k):
        raise AssertionError("made outside record()")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiler._GradMark, "apply", refuse)
    plain_state, plain_stats = plain_trainer.step(plain_state, b)
    assert torch.equal(plain_stats.loss, rec_stats.loss)
    for k, p in plain_state.splats.params().items():
        assert torch.equal(p, rec_state.splats.params()[k]), k
    assert torch.equal(plain_state.grad_2d_accum, rec_state.grad_2d_accum)


@pytest.mark.parametrize("metric, entries", [
    ("project_ms.train", ["record_inputs/project"]),
    ("sh_ms.train", ["record_inputs/sh"]),
    ("tile_pretest_ms.train", ["record_inputs/tile_pretest"]),
    ("pack_ms.train", ["record_inputs/pack"]),
    ("sh_bwd_ms.train", ["backward/sh"]),
    ("project_bwd_ms.train", ["backward/project"]),
    ("visible_share.train", ["#visible", "#rows"]),
    ("pool_use.train", ["#records", "#pool_slots"]),
])
def test_benchmark_reader_reads_two_recorded_steps(metric, entries):
    """benchmark/metrics/<metric>.py on two recorded CPU steps, cut at
    `step end` by harness.split_steps: a span's mean ms a step, a share's
    100 sum / sum; None on a run without entries."""
    from benchmark import harness

    trainer, state = trainer_and_state()
    b = batch()
    with profiler.record(host=True) as stages:
        for _ in range(2):
            state, _ = trainer.step(state, b)
    steps = harness.split_steps(stages, "step end")
    mod = harness.load_module(
        os.path.join(ROOT, "benchmark", "metrics", metric + ".py"),
        "test_metric_" + metric.replace(".", "_"))
    got = mod.read({"steps": steps})
    if len(entries) == 1:
        want = sum(s[entries[0]] for s in steps) / 2
    else:
        want = 100.0 * (sum(s[entries[0]] for s in steps)
                        / sum(s[entries[1]] for s in steps))
    assert got == pytest.approx(want) and got > 0
    assert mod.read({}) is None and mod.read({"steps": [{"loss": 1.0}]}) \
        is None


@pytest.mark.parametrize("metric, entry", [
    ("refine_ms.densify", "refine"),
    ("refine_compact_ms.densify", "refine/compact"),
    ("refine_moments_ms.densify", "refine/moments"),
    ("live_share.densify", None),
])
def test_benchmark_refine_reader_reads_recorded_steps(metric, entry):
    """benchmark/metrics/<metric>.py on three recorded CPU steps of which
    the first and the third refine: a refine span's ms over the steps that
    hold it, the live share 100 sum #live / sum #capacity over all three;
    None on a run without entries."""
    from benchmark import harness

    trainer, state = refining_trainer()
    b = batch()
    with profiler.record(host=True) as stages:
        for _ in range(3):
            state, _ = trainer.step(state, b)
    steps = harness.split_steps(stages, "step end")
    mod = harness.load_module(
        os.path.join(ROOT, "benchmark", "metrics", metric + ".py"),
        "test_metric_" + metric.replace(".", "_"))
    got = mod.read({"steps": steps})
    if entry is None:
        want = 100.0 * (sum(s["#live"] for s in steps)
                        / sum(s["#capacity"] for s in steps))
        assert want < 100.0
    else:
        assert [entry in s for s in steps] == [True, False, True]
        want = (steps[0][entry] + steps[2][entry]) / 2
    assert got == pytest.approx(want) and got > 0
    assert mod.read({}) is None and mod.read({"steps": [{"loss": 1.0}]}) \
        is None
