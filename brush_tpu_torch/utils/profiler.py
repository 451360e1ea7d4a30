"""Stage marks: where the time of a render or a training step goes.

The port's counterpart of the JAX package's sync-mode spans
(brush_tpu/utils/profiler.py). The render, the record pipeline and the
trainer call `mark(name)` where each of their stages ends. Inside
`record()` on a CUDA device a mark records a CUDA event on the current
stream, so a stage's time is the stream time between its mark and the
one before it: its kernels and the host's gaps between their launches.
Outside `record()` a mark is one read of a global.

The backward's marks fire on the autograd engine's thread. Its work goes
to the same stream while the main thread waits in backward(), so the
marks stay in stream order.

    with profiler.record() as stages:
        trainer.step(state, batch)
    # stages: [("upload", ms), ("record_inputs", ms), ...]
"""

from __future__ import annotations

import contextlib

import torch

_marks: list | None = None


def mark(name: str) -> None:
    """End the stage `name` here (a no-op outside record())."""
    if _marks is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        _marks.append((name, event))


@contextlib.contextmanager
def record():
    """Time the marked stages of the enclosed work on the current CUDA
    device. Yields a list that, when the block exits (after a device
    synchronize), holds (name, ms) for each mark in order: the time since
    the previous mark, the first one's since the block was entered."""
    global _marks
    if not torch.cuda.is_available():
        raise RuntimeError("profiler.record() needs a CUDA device")
    if _marks is not None:
        raise RuntimeError("profiler.record() is already open")
    stages: list = []
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    _marks = []
    try:
        yield stages
    finally:
        marks, _marks = _marks, None
        torch.cuda.synchronize()
        prev = start
        for name, event in marks:
            stages.append((name, prev.elapsed_time(event)))
            prev = event
