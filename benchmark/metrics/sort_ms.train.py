"""ops.pipeline's sorts and gathers (depth_order, tile_bins, grad_resort,
to_global), ms a step."""

from benchmark.harness import stage_ms


def read(run):
    return stage_ms(run, ["depth_order", "tile_bins", "grad_resort",
                         "to_global"])
