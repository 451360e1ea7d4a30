"""Profiling hooks (port of brush_tpu/utils/profiler.py; reference: tracing
spans + tracy + the sync-span crate), and stage marks.

- `trace(dir)`: a torch.profiler trace of the enclosed work (CPU activity,
  and CUDA activity where a card is present), written into `dir` as a
  Chrome trace (.json) when the block exits.
- `span(name, *tensors)`: a named scope in that trace
  (torch.profiler.record_function; the reference's trace_span!). In sync
  mode (`set_sync_mode(True)`) it also waits, at scope close, for the
  devices of the CUDA tensors it was given and records the wall seconds,
  as the sync-span crate does (sync-span/src/lib.rs:29-42); `timings()`
  gives their means. Nothing in the port calls `span`: it is for callers.

Stage marks: where the time of a render or a training step goes. The
render, the record pipeline and the trainer call `mark(name)` where each
of their stages ends. Inside `record()` on a CUDA device a mark records a
CUDA event on the current stream, so a stage's time is the stream time
between its mark and the one before it: its kernels and the host's gaps
between their launches. Outside `record()` a mark is one read of a
global. `record(host=True)` times the marks by the host's clock instead,
for work on CPU tensors (done when each call returns): what a CPU run of a
harness reads, never a device's time.

The backward's marks fire on the autograd engine's thread. Its work goes
to the same stream while the main thread waits in backward(), so the
marks stay in stream order.

    with profiler.record() as stages:
        trainer.step(state, batch)
    # stages: [("upload", ms), ("record_inputs", ms), ...]
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch

_marks: list | None = None
_host_clock = {"enabled": False}   # marks read time.perf_counter()
_sync = {"enabled": False}
_timings: dict[str, list] = {}
_trace_ids = itertools.count()


def set_sync_mode(enabled: bool) -> None:
    """(reference: the sync-span global toggle, lib.rs:45-49)."""
    _sync["enabled"] = bool(enabled)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block; on exit its Chrome trace is written
    to log_dir/trace_<pid>_<n>.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{next(_trace_ids)}.json"))


@contextlib.contextmanager
def span(name: str, *sync_tensors):
    """Named profiler scope; in sync mode also records the wall seconds to
    the end of the work queued on the given CUDA tensors' devices (CPU
    tensors are ready when the scope closes)."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if _sync["enabled"]:
        for dev in {t.device for t in sync_tensors
                    if isinstance(t, torch.Tensor) and t.is_cuda}:
            torch.cuda.synchronize(dev)
        _timings.setdefault(name, []).append(time.perf_counter() - t0)


def timings() -> dict[str, float]:
    """Mean seconds per span recorded while sync mode was on."""
    return {k: sum(v) / len(v) for k, v in _timings.items() if v}


def reset_timings() -> None:
    _timings.clear()


def mark(name: str) -> None:
    """End the stage `name` here (a no-op outside record())."""
    if _marks is not None:
        if _host_clock["enabled"]:
            _marks.append((name, time.perf_counter()))
            return
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        _marks.append((name, event))


@contextlib.contextmanager
def record(host: bool = False):
    """Time the marked stages of the enclosed work on the current CUDA
    device. Yields a list that, when the block exits (after a device
    synchronize), holds (name, ms) for each mark in order: the time since
    the previous mark, the first one's since the block was entered. With
    host=True the same by the host's clock, on any machine (CPU work)."""
    global _marks
    if not host and not torch.cuda.is_available():
        raise RuntimeError("profiler.record() needs a CUDA device")
    if _marks is not None:
        raise RuntimeError("profiler.record() is already open")
    stages: list = []
    if host:
        start = time.perf_counter()
    else:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    _host_clock["enabled"] = host
    _marks = []
    try:
        yield stages
    finally:
        marks, _marks = _marks, None
        _host_clock["enabled"] = False
        prev = start
        if not host:
            torch.cuda.synchronize()
        for name, at in marks:
            stages.append((name, (at - prev) * 1e3 if host
                           else prev.elapsed_time(at)))
            prev = at
