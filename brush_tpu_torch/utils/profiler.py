"""Profiling hooks (port of brush_tpu/utils/profiler.py; reference: tracing
spans + tracy): a torch.profiler trace, and the stages, spans and counters
of a recorded window.

- `trace(dir)`: a torch.profiler trace of the enclosed work (CPU activity,
  and CUDA activity where a card is present), written into `dir` as a
  Chrome trace (.json) when the block exits.

Recording: where the time of a render or a training step goes, on the
stream. Inside `with record() as stages:` on a CUDA device the program's
spans, marks and counters are timed by CUDA events on the current
stream; `stages` ends up holding (name, value) entries in the order they
closed:

- **The chain.** `with span(name):` that no other span encloses is a
  stage; so is `mark(name)`, the end-only form for points where no block
  exists (the backward's marks, `autograd rest`, `step end`). A stage's
  value is the stream ms from the previous stage's end (the first one's
  from the block's start) to its own end: its kernels and the host's
  gaps between their launches. The chain's entries sum to the recorded
  work.
- **Children.** A span inside another span is entered as
  `<parent>/<child>`, its ms from its own start to its own end. It never
  moves the chain, so no stage changes by its presence.
  `grad_span(name)` times a stretch of the backward between two autograd
  nodes put in place while recording (`inputs()` before the forward
  code, `outputs()` after it): entered as `name` (say `backward/sh`),
  timed from the first of them to run to the other.
- **Counters.** `count(name, value)` enters `#<name>`: a host int, or a
  device scalar the code computes anyway. The device scalars become host
  ints in one copy after the block's closing synchronize, so a counter
  costs the window no sync.

`record(host=True)` times the same by the host's clock, for work on CPU
tensors (done when each call returns): what a CPU run of a harness reads,
never a device's time. `chain(stages)` keeps the stages alone.

Whenever a torch profiler is active, recording or not, a span is also a
`torch.profiler.record_function` range under its entry's name, so a
trace holds the program's stages on the kernels' clock. Outside `record()`
with no profiler active a span, a mark or a counter is a read of a global
(a span also reads torch's profiler flag): no event, range or autograd
node is made.

The backward's marks and grad spans fire on the autograd engine's
thread. Its work goes to the same stream while the main thread waits in
backward(), so they stay in stream order.

    with profiler.record() as stages:
        trainer.step(state, batch)
    # stages: [("upload", ms), ("record_inputs/project", ms), ...,
    #          ("record_inputs", ms), ..., ("#visible", n), ...]
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch

# The open recording's entries: (name, at) a stage, (name, start, end) a
# child, ("#name", value) a counter. None outside record().
_marks: list | None = None
_host_clock = {"enabled": False}   # entries read time.perf_counter()
_spans = threading.local()         # .open: the thread's open span names
_trace_ids = itertools.count()


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


def _now():
    """A point on the recording's clock: the host's, or a CUDA event on
    the current stream."""
    if _host_clock["enabled"]:
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def mark(name: str) -> None:
    """End the stage `name` here (a no-op outside record())."""
    if _marks is not None:
        _marks.append((name, _now()))


def count(name: str, value) -> None:
    """Enter the counter `#name` (a no-op outside record()): a host int or
    a device scalar already computed."""
    if _marks is not None:
        _marks.append(("#" + name, value))


class _Span:
    __slots__ = ("name", "entry", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        open_ = getattr(_spans, "open", None)
        if open_ is None:
            open_ = _spans.open = []
        self.entry = (f"{open_[-1]}/{self.name}" if open_ else self.name)
        open_.append(self.entry)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.entry)
            self.range.__enter__()
        self.start = _now() if _marks is not None and len(open_) > 1 \
            else None
        return self

    def __exit__(self, *exc):
        _spans.open.pop()
        if _marks is not None:
            if self.start is not None:
                _marks.append((self.entry, self.start, _now()))
            elif not _spans.open:
                mark(self.entry)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """The block as a stage of the chain, or, inside another span, as its
    child `<parent>/<name>` (see the module docstring)."""
    if _marks is None and not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


class _GradMark(torch.autograd.Function):
    """Identity; its backward marks one end of a grad span."""

    @staticmethod
    def forward(ctx, gspan, at_end, *xs):
        ctx.gspan, ctx.at_end = gspan, at_end
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *grads):
        ctx.gspan.reached(ctx.at_end)
        return (None, None, *grads)


class _GradSpan:
    def __init__(self, name: str):
        self.name = name
        self.start = None

    def _wrap(self, at_end: bool, xs):
        out = _GradMark.apply(self, at_end, *xs)
        return out[0] if len(xs) == 1 else out

    def inputs(self, *xs):
        """The forward code's inputs: the backward stretch ends when their
        gradients are complete."""
        return self._wrap(True, xs)

    def outputs(self, *xs):
        """The forward code's outputs: the stretch starts when their
        gradients are."""
        return self._wrap(False, xs)

    def reached(self, at_end: bool):
        if _marks is None:
            return
        if not at_end:
            self.start = _now()
        elif self.start is not None:
            _marks.append((self.name, self.start, _now()))


class _NoGradSpan:
    @staticmethod
    def inputs(*xs):
        return xs[0] if len(xs) == 1 else xs

    outputs = inputs


_NO_GRAD_SPAN = _NoGradSpan()


def grad_span(name: str):
    """A span of the backward, entered as `name`: pass the forward code's
    differentiable inputs through `.inputs()` and its outputs through
    `.outputs()`. Outside record() (or without grad) both hand their
    arguments back untouched and add nothing to the graph."""
    if _marks is None or not torch.is_grad_enabled():
        return _NO_GRAD_SPAN
    return _GradSpan(name)


def chain(stages: list) -> list:
    """The stages of record()'s entries, without children or counters."""
    return [(name, v) for name, v in stages
            if "/" not in name and not name.startswith("#")]


def _host_ints(values: list) -> list:
    """Host ints of device scalars, in one copy."""
    if not values:
        return []
    dev = values[0].device
    return torch.stack([v.detach().reshape(()).to(dev, torch.int64)
                        for v in values]).tolist()


@contextlib.contextmanager
def record(host: bool = False):
    """Time the stages, spans and counters of the enclosed work on the
    current CUDA device. Yields a list that, when the block exits (after a
    device synchronize), holds their (name, value) entries in order (the
    module docstring). With host=True the same by the host's clock, on
    any machine (CPU work)."""
    global _marks
    if not host and not torch.cuda.is_available():
        raise RuntimeError("profiler.record() needs a CUDA device")
    if _marks is not None:
        raise RuntimeError("profiler.record() is already open")
    stages: list = []
    _host_clock["enabled"] = host
    start = _now()
    _marks = []
    try:
        yield stages
    finally:
        marks, _marks = _marks, None
        _host_clock["enabled"] = False
        if not host:
            torch.cuda.synchronize()
        ms = ((lambda a, b: (b - a) * 1e3) if host
              else (lambda a, b: a.elapsed_time(b)))
        counted = iter(_host_ints([e[1] for e in marks if e[0][0] == "#"
                                   and isinstance(e[1], torch.Tensor)]))
        prev = start
        for e in marks:
            if e[0][0] == "#":
                value = e[1]
                stages.append((e[0], next(counted)
                               if isinstance(value, torch.Tensor)
                               else int(value)))
            elif len(e) == 3:
                stages.append((e[0], ms(e[1], e[2])))
            else:
                stages.append((e[0], ms(prev, e[1])))
                prev = e[1]
