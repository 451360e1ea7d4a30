"""Tiny cells for the benchmark's CPU tests: the shipped configurations
and workloads with their scale cut to what a CPU run holds."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def tiny(cell: str):
    wl = harness.load_json("workloads", cell + ".json")
    cfg = harness.load_json("configs", wl["config"] + ".json")
    cfg["scene"].update(splats=2000, width=48, height=40, views=4)
    cfg["pool"] = 8192
    return wl, cfg


def run_tiny(cell: str, faults=(), trace: int = 0, capsys=None):
    """harness.main on the CPU for the tiny cell: (rc, result dict)."""
    import json

    wl, cfg = tiny(cell)
    rc = harness.main(["--workload", cell, "--seed", "3000000019",
                       "--seconds", "0.3", "--trace", str(trace)],
                      require_chip=False, device="cpu", workload=wl,
                      config=cfg, faults=tuple(faults))
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.fixture
def cuda():
    """Skips here without a card (decided in the test, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
