"""The render of a served frame (render_splats with needs_grad=False:
record_inputs with its children, depth_order, expand, tile_bins,
rasterize_fwd, assemble), ms a frame."""

from benchmark.harness import stage_ms

RENDER = ["record_inputs", "depth_order", "expand", "tile_bins",
          "rasterize_fwd", "assemble"]


def read(run):
    return stage_ms(run, RENDER)
