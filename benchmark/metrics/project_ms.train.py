"""The projection inside render.record_inputs (normalize_quats,
project_splats), ms a step: the span `record_inputs/project`."""

from benchmark.harness import stage_ms


def read(run):
    return stage_ms(run, ["record_inputs/project"])
