"""The port's profiler hooks (brush_tpu_torch/utils/profiler.py), modelled
on tests/test_aux.py's sync-span test: sync-mode span timings, a Chrome
trace of a render holding its span, and the stage marks left off by both."""

import glob
import json

import numpy as np
import torch

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.render import render_splats
from brush_tpu_torch.splats import from_random
from brush_tpu_torch.utils import profiler
from torch_threads import pin_threads

pin_threads()


def test_sync_spans_record_timings():
    profiler.reset_timings()
    profiler.set_sync_mode(True)
    try:
        x = torch.ones((128, 128))
        with profiler.span("matmul", x):
            y = x @ x
        with profiler.span("matmul", y):
            y = y @ y
    finally:
        profiler.set_sync_mode(False)
    with profiler.span("off", y):   # outside sync mode: no timing
        y = y + 1
    t = profiler.timings()
    assert set(t) == {"matmul"} and t["matmul"] > 0
    profiler.reset_timings()
    assert profiler.timings() == {}


def test_trace_writes_a_chrome_trace_of_a_render(tmp_path):
    """trace(dir) around a render on the CPU writes one Chrome trace that
    holds the span and the render's operators; neither trace nor span
    turns the stage marks on."""
    sp = from_random(np.random.default_rng(0), [-1] * 3, [1] * 3, count=64,
                     sh_degree=0, device="cpu")
    cam = camera_params(Camera(position=[0, 0, -4.0], rotation=[1, 0, 0, 0],
                               fov_x=0.8, fov_y=0.8), (32, 32), device="cpu")
    with profiler.trace(str(tmp_path / "trace")):
        with profiler.span("frame", sp.means):
            img, _ = render_splats(sp.means, sp.log_scales, sp.quats,
                                   sp.sh_coeffs, sp.raw_opacity, cam,
                                   (32, 32), active=sp.active_mask(),
                                   needs_grad=False)
        assert profiler._marks is None
    files = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "frame" in names and "aten::sort" in names
    assert img.shape == (32, 32, 4)
