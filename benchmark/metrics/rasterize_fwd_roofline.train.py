"""rasterize_fwd's share of its roofline in the training step, %:
counts/work.py's least time of the traced steps' pairs over the kernel's
device time."""

from benchmark.harness import roofline


def read(run):
    return roofline(run, "rasterize_fwd")
