"""Whole runs on the CPU at tiny sizes: no card means no result; the
harness drives every cell with its reference; each fault a cell can have,
planted underneath the timed path, makes `correct` false."""

import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, run_tiny

CELLS = ("bicycle-train",)


def run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bicycle-train",
         "--seed", "3000000021", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = run_py(ROOT, env)
    assert r.returncode != 0
    assert "correct" not in r.stdout and "no chip" in r.stderr


def test_benchmark_alone_is_not_enough(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ has no program:
    the run fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run_py(tmp_path)
    assert r.returncode != 0 and "correct" not in r.stdout


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell, capsys):
    rc, res = run_tiny(cell, trace=1, capsys=capsys)
    assert rc == 0 and res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell, fault", [
    ("bicycle-train", "state_unchanged"), ("bicycle-train", "half_batch")])
def test_fault_is_not_correct(cell, fault, capsys):
    rc, res = run_tiny(cell, faults=(fault,), capsys=capsys)
    assert rc == 0 and res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in TF32 (reference/splat.py precision), put in the
    program's place, fails one of the cell's numbers."""
    import time

    from benchmark import harness
    from conftest import tiny

    wl, cfg = tiny(cell)
    out = harness.run_cell(cell, 3000000023, 0.3, False, time.perf_counter(),
                           device="cpu", workload=wl, config=cfg,
                           faults=("control",))
    ctl = out.run["control"]
    assert any(ctl[k] > lim for k, (_, lim) in out.checks.items()), (
        ctl, out.checks)
