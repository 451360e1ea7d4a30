"""rasterize_fwd's share of its roofline in the served frame, %:
counts/work.py's least time of the traced frames' pairs over the
kernel's device time."""

from benchmark.harness import roofline


def read(run):
    return roofline(run, "rasterize_fwd")
