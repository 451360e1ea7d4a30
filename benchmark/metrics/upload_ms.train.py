"""Ground-truth upload (datasets: the trainer's device cache), ms a step: the
stream time of the mark `upload`."""

from benchmark.harness import stage_ms


def read(run):
    return stage_ms(run, ["upload"])
