"""The SH colour's backward, ms a step: the grad span `backward/sh`."""

from benchmark.harness import stage_ms


def read(run):
    return stage_ms(run, ["backward/sh"])
