#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, on the chip.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control <n> ...] [--fault <name> --fault-seeds
        <n> ...]

For each seed, one short run of the cell in this process (the window of
`seconds`, then the reference), printing the numbers compared; for the
--control seeds also the control's numbers (the reference computed with
TF32 on, put in the program's place); for each --fault, the numbers of
runs with that fault planted (drivers/train.py: state_unchanged,
half_batch, exact_scan). One JSON line a reading,
and a summary: the largest program reading and the least control and
fault readings of each number.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    why = harness.chip_ok(1)
    if why:
        print(f"calibrate: {why}", file=sys.stderr)
        return 2
    readings = {}

    def note(kind, seed, nums, extra=None):
        line = {"kind": kind, "seed": seed, **nums, **(extra or {})}
        print(json.dumps(line), flush=True)
        for k, v in nums.items():
            readings.setdefault(kind, {}).setdefault(k, []).append(v)

    runs = [(s, ("control",) if s in args.control else ())
            for s in args.seeds]
    runs += [(s, (f,)) for f in args.fault for s in args.fault_seeds]
    for seed, faults in runs:
        t = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, False, t,
                               faults=faults)
        nums = {k: v for k, (v, _) in out.checks.items()}
        kind = faults[0] if faults and faults[0] != "control" else "program"
        nums.update(out.run.get("diagnostics", {}))
        note(kind, seed, nums, {"e2e": out.e2e,
                                "secs": time.perf_counter() - t})
        if "control" in out.run:
            note("control", seed, out.run["control"])
    summary = {}
    for kind, nums in readings.items():
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(v) for k, v in nums.items()}
    print("SUMMARY " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
