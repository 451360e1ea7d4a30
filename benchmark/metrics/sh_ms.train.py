"""The SH colour inside render.record_inputs (view_colors), ms a step: the span
`record_inputs/sh`."""

from benchmark.harness import stage_ms


def read(run):
    return stage_ms(run, ["record_inputs/sh"])
