"""A served frame's time outside the render, ms a frame: the marks
`request` (the request's way from the client to render_png) and `frame`
(the RGBA8 pack, the host copy, the composite, the PNG encoder and the
answer's way back), the frame's round trip less its render stages."""

from benchmark.harness import stage_ms


def read(run):
    return stage_ms(run, ["request", "frame"])
