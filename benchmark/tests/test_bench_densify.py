"""The bicycle-densify cell on the CPU at a tiny size: the run is correct
with the refine inside its check steps, each fault planted under the timed
path (a step that returns its state unchanged, a loss over half of the
rows) makes it incorrect, the TF32 control fails one of its numbers, and
its new readers find nothing in a run without their entries."""

import os
import time

import pytest

from conftest import tiny

from benchmark import harness

CELL = "bicycle-densify"
READERS = ("refine_ms.densify", "refine_compact_ms.densify",
           "refine_moments_ms.densify", "live_share.densify")


def tiny_densify():
    """conftest's tiny cut with the capacity the trainer's rule gives, and
    the gradient threshold raised by the frame's cut: a screen-space
    gradient in half-image units reads larger by the factor the frame
    shrinks, so the check's refine is again decided by the drawn
    statistics."""
    wl, cfg = tiny(CELL)
    full = harness.load_json("configs", wl["config"] + ".json")["scene"]
    cfg["scene"].update(splats=7000, capacity=16384)
    cfg["recipe"]["densify_grad_thresh"] *= (full["height"]
                                             / cfg["scene"]["height"])
    return wl, cfg


def run(faults=(), trace=False, seed=3000000019):
    wl, cfg = tiny_densify()
    return harness.run_cell(CELL, seed, 0.3, trace, time.perf_counter(),
                            device="cpu", workload=wl, config=cfg,
                            faults=tuple(faults))


def test_densify_cell_is_correct_and_refines_in_its_check():
    out = run(trace=True)
    assert harness.verdict(out.checks), out.checks
    assert set(out.checks) == {"loss_gap", "grad_norm_gap",
                               "change_norm_gap", "moment_gap", "live_gap",
                               "accum_gap", "count_gap"}
    (cloned, split, pruned_a, pruned_s, live), = out.run["refines"]["check"]
    assert cloned > 0 and split > 0 and pruned_a > 0 and live > 7000
    assert set(out.run["diagnostics"]) == {"least_rel_to_thresh",
                                           "rows_within_1e-3"}
    steps = out.run["steps"]
    assert steps and all(s["#capacity"] == 16384 for s in steps)
    for name in READERS[-1:]:
        mod = harness.load_module(os.path.join(harness.HERE, "metrics",
                                               name + ".py"), "m")
        assert 0 < mod.read(out.run) < 100


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_densify_fault_is_not_correct(fault):
    out = run(faults=(fault,))
    assert not harness.verdict(out.checks), out.checks


def test_densify_control_is_not_correct():
    out = run(faults=("control",), seed=3000000023)
    ctl = out.run["control"]
    assert any(ctl[k] > lim for k, (_, lim) in out.checks.items()), (
        ctl, out.checks)


@pytest.mark.parametrize("name", READERS)
def test_densify_readers_find_nothing_without_entries(name):
    mod = harness.load_module(os.path.join(harness.HERE, "metrics",
                                           name + ".py"), "m")
    assert mod.read({}) is None
    assert mod.read({"steps": [{"adam": 1.0, "#rows": 4}]}) is None


def test_capacity_off_the_trainers_rule_is_refused():
    wl, cfg = tiny_densify()
    cfg["scene"]["capacity"] = 8192
    with pytest.raises(SystemExit, match="round_up_capacity"):
        harness.run_cell(CELL, 1, 0.1, False, time.perf_counter(),
                         device="cpu", workload=wl, config=cfg)

