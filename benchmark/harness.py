"""The benchmark's harness: one cell, one seed, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything of a cell is found by name, so a later change adds a cell, a
configuration, an entry kind or a per-layer metric by adding files:

  BENCHMARK.json            the cells, their metrics and bounds
  workloads/<cell>.json     the configuration, the entry kind (a driver)
                            and the traffic's parameters
  configs/<config>.json     the scene, its source and cuts, the recipe
  drivers/<kind>.py         drive(ctx) -> Outcome for one entry kind
  metrics/<metric>.py       read(run) -> value or None, one per-layer metric

A run sets up the cell (its scene from the seed, the program's objects,
the shapes of its traffic), measures for `seconds`, and then checks what
the window's path produced against the plain reference (reference/). It
prints, as the last line of standard output, the JSON result; with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read from stage marks over the window and a torch.profiler trace
of a few steps after it. The numbers compared for `correct` go, each with
its limit, to the result's last key and to the last lines of standard
error.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "brush_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module of the benchmark by file path (metric names hold dots)."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Context:
    """What a driver gets: its cell, the run's arguments and device."""

    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device
    t0: float               # process start, time.perf_counter()
    faults: tuple = ()      # names of faults planted (tests only)


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""

    e2e: dict               # end-to-end metric -> value
    run: dict               # what the per-layer readers read
    checks: dict            # compared number -> (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None


def phase(ctx: Context, what: str) -> None:
    """A line on standard error: the seconds since the process started."""
    print(f"[{time.perf_counter() - ctx.t0:8.3f} s] {what}", file=sys.stderr,
          flush=True)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(device) -> int:
    import torch

    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


# ---------------------------------------------------------------------- #
# Stage marks and the device trace


class no_marks:
    """Stands in for profiler.record() in a run that records no marks."""

    def __enter__(self):
        return []

    def __exit__(self, *exc):
        return False


def split_steps(stages: list, last: str) -> list:
    """The marks of a window, (name, ms) in order, cut into one dict per
    step at each `last` mark (a stage seen twice in a step adds up)."""
    steps, cur = [], {}
    for name, ms in stages:
        cur[name] = cur.get(name, 0.0) + ms
        if name == last:
            steps.append(cur)
            cur = {}
    return steps


def traced(fn, units: int, device) -> dict:
    """Run fn() `units` times under torch.profiler and read the trace:
    device seconds by kernel name, the busy seconds (the union of the
    device's operation intervals), the window's seconds by the host's
    clock, and the breakdown (the longest device operations, and the
    idle gaps by what the host was doing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(units):
            fn()
        sync(device)
        window_s = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    del prof
    return read_trace(events, window_s)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(events: list, window_s: float) -> dict:
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                  and e.get("ph") == "X"), key=lambda e: e["ts"])
    cpu = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation",
                                                 "cuda_runtime")
           and e.get("ph") == "X"]
    kernels: dict = {}
    ordered = []
    for e in dev:
        kernels[e["name"]] = kernels.get(e["name"], 0.0) + e["dur"] * 1e-6
        ordered.append((e["name"], e["ts"], e["dur"]))
    busy = 0.0
    gaps = []
    end = None
    for _, ts, dur in ordered:
        if end is None or ts > end:
            if end is not None:
                gaps.append((end, ts))
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    busy *= 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    idle: dict = {}
    cpu.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in cpu]
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        mid = 0.5 * (g0 + g1)
        name = "host: none"
        # The innermost host event over the gap's middle: the latest to
        # start of those that cover it.
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if cpu[j]["ts"] + cpu[j]["dur"] >= mid:
                name = cpu[j]["name"]
                break
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-6
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"kernels": kernels, "ordered": ordered, "busy_s": busy,
            "window_s": window_s,
            "breakdown": {"device_ops": [list(kv) for kv in top],
                          "idle_gaps": [list(kv) for kv in gaps_top]}}


def kernel_seconds(trace: dict, names: tuple, lead: str | None = None):
    """Device seconds of the kernels whose names hold one of `names`;
    with `lead`, also each kernel holding `lead` that runs right before
    one of them (a launcher's helper kernel). None if none ran."""
    total, found = 0.0, False
    prev = None
    for name, _, dur in trace["ordered"]:
        if any(n in name for n in names):
            found = True
            total += dur * 1e-6
            if lead and prev is not None and lead in prev[0]:
                total += prev[2] * 1e-6
        prev = (name, 0, dur)
    return total if found else None


# ---------------------------------------------------------------------- #
# A run


def chip_ok(chips: int) -> str | None:
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return (f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {chips}")
    return None


def cell(name: str) -> dict:
    for w in spec()["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def per_layer(name: str, run: dict) -> dict:
    """The cell's per-layer metrics that its readers find."""
    out = {}
    for m in spec()["per_layer"]:
        if "workloads" in m and name not in m["workloads"]:
            continue
        mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                          "bench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end(name: str, e2e: dict) -> dict:
    out = {}
    for m in spec()["end_to_end"]:
        if "workloads" in m and name not in m["workloads"]:
            continue
        out[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, t0: float,
             device=None, workload: dict | None = None,
             config: dict | None = None, faults: tuple = ()):
    """Drive one cell once; the driver's Outcome."""
    import torch

    wl = workload or load_json("workloads", name + ".json")
    cfg = config or load_json("configs", wl["config"] + ".json")
    dev = torch.device(device or "cuda")
    driver = load_module(os.path.join(HERE, "drivers", wl["kind"] + ".py"),
                         "bench_driver_" + wl["kind"])
    ctx = Context(name, wl, cfg, int(seed), float(seconds), bool(trace), dev,
                  t0, tuple(faults))
    return driver.drive(ctx)


def verdict(checks: dict) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def device_info(device, peak: int, out: Outcome, trace: bool) -> dict:
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        info["busy_s"] = out.busy_s or 0.0
        info["window_s"] = out.window_s or 0.0
    return info


def main(argv=None, t0: float | None = None, require_chip: bool = True,
         device=None, workload: dict | None = None,
         config: dict | None = None, faults: tuple = ()) -> int:
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    entry = (cell(args.workload) if workload is None
             else {"name": args.workload, "chips": 1})
    if require_chip:
        why = chip_ok(int(entry["chips"]))
        if why:
            print(f"benchmark: no chip for {args.workload}: {why}",
                  file=sys.stderr)
            return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t0, device=device, workload=workload, config=config,
                   faults=faults)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    import torch

    dev = torch.device(device or "cuda")
    correct = verdict(out.checks)
    if workload is None:
        metrics = (per_layer(args.workload, out.run) if args.trace
                   else end_to_end(args.workload, out.e2e))
    else:
        metrics = {k: {"value": v, "unit": ""} for k, v in out.e2e.items()}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics,
              "device": device_info(dev, out.memory_peak_bytes, out,
                                    bool(args.trace))}
    if args.trace and out.breakdown:
        result["breakdown"] = out.breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    for k, (v, lim) in out.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def stage_ms(run: dict, names) -> float | None:
    """A stage metric: the named marks' stream ms summed over the window's
    steps, over their number; None without marks."""
    steps = run.get("steps")
    if not steps:
        return None
    if not any(n in s for s in steps for n in names):
        return None
    return sum(s.get(n, 0.0) for s in steps for n in names) / len(steps)


def roofline(run: dict, kernel: str) -> float | None:
    """A kernel's share of its roofline, %: the least time of the traced
    steps' work over its device time in the trace."""
    t = run.get("kernel_s", {}).get(kernel)
    work = run.get("work", {}).get(kernel)
    if not t or not work:
        return None
    from benchmark.counts import work as w

    return 100.0 * w.least_seconds(*work) / t


def mfu(run: dict) -> float | None:
    """The whole step's share of the chip's peak, %: the least time of a
    step's work over the step's time in the window."""
    work = run.get("work", {}).get("unit")
    unit_s = run.get("unit_s")
    if not work or not unit_s:
        return None
    from benchmark.counts import work as w

    return 100.0 * w.least_seconds(*work) / unit_s


def idle_share(run: dict) -> float | None:
    busy, window = run.get("busy_s"), run.get("window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
