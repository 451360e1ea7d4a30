"""The whole training step's share of the chip's peak, %: counts/work.py's
least time of a step over the window's step time."""

from benchmark.harness import mfu


def read(run):
    return mfu(run)
