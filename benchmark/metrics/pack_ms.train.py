"""The rest of render.record_inputs after the pretest (the depth key, the
attrs9 stack, the decode rows), ms a step: the span `record_inputs/pack`."""

from benchmark.harness import stage_ms


def read(run):
    return stage_ms(run, ["record_inputs/pack"])
