"""The render's backward outside the record pipeline (SH and projection), ms a
step: the mark `autograd rest`."""

from benchmark.harness import stage_ms


def read(run):
    return stage_ms(run, ["autograd rest"])
