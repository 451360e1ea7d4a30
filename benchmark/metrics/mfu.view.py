"""The served frame's share of the chip's peak, %: the least time of a
frame's device work (projection, SH, the rasterizer) over the window's
time a frame."""

from benchmark.harness import mfu


def read(run):
    return mfu(run)
