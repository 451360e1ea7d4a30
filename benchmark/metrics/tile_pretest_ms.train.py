"""The exact tile pretest inside render.record_inputs
(ops/binning.precompute_tile_masks), ms a step: the span
`record_inputs/tile_pretest`."""

from benchmark.harness import stage_ms


def read(run):
    return stage_ms(run, ["record_inputs/tile_pretest"])
