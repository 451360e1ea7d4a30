"""The numbers that decide `correct`, from the program's outputs and the
reference's. Gaps of norms are taken by the worst leaf, each measured
against the larger of the reference's norm of that leaf and of the
median leaf's, since some leaves' gradients are all but zero."""

from __future__ import annotations

import statistics

import torch

from benchmark.reference.splat import LEAVES

# Leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone and are left out of the change.
STILL = 1e-3


def _norms(d: dict, rows: int) -> dict:
    return {k: float(torch.linalg.vector_norm(d[k][:rows].double()))
            for k in LEAVES}


def norm_gap(prog: dict, ref: dict, leaves) -> float:
    """max over leaves of |prog - ref| / max(ref, median of ref)."""
    med = statistics.median(ref[k] for k in LEAVES)
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                for k in leaves), default=0.0)


def train_numbers(losses, grad1, after, live: int, ref: dict) -> dict:
    """loss_gap, grad_norm_gap, change_norm_gap (see drivers/train.py)."""
    rows = ref["p0"]["means"].shape[0]
    if live != rows:
        # A step that lost or added live rows cannot be compared row by
        # row: that is a fault of the run.
        return {"loss_gap": float("inf"), "grad_norm_gap": float("inf"),
                "change_norm_gap": float("inf")}
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, ref["losses"]))
    g_ref = _norms(ref["grad1"], rows)
    grad_gap = norm_gap(_norms(grad1, rows), g_ref, LEAVES)
    med = statistics.median(g_ref.values())
    moving = [k for k in LEAVES if g_ref[k] >= STILL * med]
    d_prog = {k: after[k][:rows] - ref["p0"][k] for k in LEAVES}
    d_ref = {k: ref["after"][k] - ref["p0"][k] for k in LEAVES}
    change_gap = norm_gap(_norms(d_prog, rows), _norms(d_ref, rows), moving)
    return {"loss_gap": float(loss_gap), "grad_norm_gap": float(grad_gap),
            "change_norm_gap": float(change_gap)}


def diff_numbers(grad1, after, ref: dict) -> dict:
    """Diagnostics beside the compared numbers: by the worst moving leaf,
    the norm of the difference over the reference's norm, of the first
    gradient and of the change."""
    rows = ref["p0"]["means"].shape[0]
    g_ref = _norms(ref["grad1"], rows)
    med = statistics.median(g_ref.values())
    out = {}
    for name, a, b in (
            ("grad_diff", {k: grad1[k][:rows] for k in LEAVES},
             ref["grad1"]),
            ("change_diff", {k: after[k][:rows] - ref["p0"][k]
                             for k in LEAVES},
             {k: ref["after"][k] - ref["p0"][k] for k in LEAVES})):
        out[name] = max(
            float(torch.linalg.vector_norm((a[k] - b[k]).double())
                  / max(float(torch.linalg.vector_norm(b[k].double())),
                        1e-30))
            for k in LEAVES if g_ref[k] >= STILL * med)
    # Each leaf's gaps of norms, for the look at which leaf reads worst.
    g_prog = _norms(grad1, rows)
    d_prog = _norms({k: after[k][:rows] - ref["p0"][k] for k in LEAVES},
                    rows)
    d_ref = _norms({k: ref["after"][k] - ref["p0"][k] for k in LEAVES}, rows)
    dmed = statistics.median(d_ref.values())
    for k in LEAVES:
        out[f"grad_gap.{k}"] = abs(g_prog[k] - g_ref[k]) / max(g_ref[k], med)
        out[f"change_gap.{k}"] = abs(d_prog[k] - d_ref[k]) / max(d_ref[k],
                                                                 dmed)
    return out
