"""render.record_inputs (projection, SH colour, the tile pretest, the decode
rows), ms a step: the mark `record_inputs`."""

from benchmark.harness import stage_ms


def read(run):
    return stage_ms(run, ["record_inputs"])
