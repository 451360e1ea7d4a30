"""optim.adam_step, ms a step: the mark `adam`."""

from benchmark.harness import stage_ms


def read(run):
    return stage_ms(run, ["adam"])
