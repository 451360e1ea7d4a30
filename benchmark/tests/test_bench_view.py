"""The view cell (drivers/view.py) on the CPU at tiny sizes: it runs with
`correct` true; each fault planted under the served path makes it false;
the control separates from the program; reference/frame.py's decoder and
composite agree with the viewer's encoder and composite; the poses reach
the endpoint digit for digit."""

import math
import os
import subprocess
import sys
import time
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest

from conftest import ROOT, run_tiny, tiny

from benchmark import harness
from benchmark.drivers import view
from benchmark.reference import frame
from benchmark.scenes import uniform

CELL = "bicycle-view"


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "3000000021", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert "correct" not in r.stdout and "no chip" in r.stderr


def test_view_cell_runs_and_is_correct(capsys):
    rc, res = run_tiny(CELL, trace=1, capsys=capsys)
    assert rc == 0 and res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"level_gap", "off_share"}
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", ["stale", "pose_off", "pool_small",
                                   "altered"])
def test_view_fault_is_not_correct(fault, capsys):
    rc, res = run_tiny(CELL, faults=(fault,), capsys=capsys)
    assert rc == 0 and res["correct"] is False, res["checks"]


def test_view_control_separates():
    """The reference in TF32 in the program's place: at 320 x 212 it reads
    pixels off where the program reads none (on the chip, at the cell's
    size, it fails off_share's limit: PERF.md)."""
    wl, cfg = tiny(CELL)
    cfg["scene"].update(width=320, height=212, splats=8000)
    out = harness.run_cell(CELL, 3000000023, 0.3, False, time.perf_counter(),
                           device="cpu", workload=wl, config=cfg,
                           faults=("control",))
    ctl = out.run["control"]
    assert ctl["off_share"] > max(10 * out.checks["off_share"][0], 1e-4), (
        ctl, out.checks)


def test_view_readers_of_a_traced_run():
    """The per-layer readers find the render's stages, the host's part and
    the pool's counters in a traced run's marks (the device's readers
    need a card's trace)."""
    wl, cfg = tiny(CELL)
    out = harness.run_cell(CELL, 3000000027, 0.3, True, time.perf_counter(),
                           device="cpu", workload=wl, config=cfg)
    got = harness.per_layer(CELL, out.run)
    assert got["render_ms.view"]["value"] > 0
    assert got["outside_render_ms.view"]["value"] > 0
    assert 0 < got["pool_use.view"]["value"] <= 100
    assert len(out.run["steps"]) >= out.attempted


def test_orbit_poses_are_the_ring_and_reach_the_endpoint_exactly():
    cfg = harness.load_json("configs", "bicycle-5m.json")
    sc = cfg["scene"]
    size = (sc["width"], sc["height"])
    ring = uniform.ring_poses(8, sc["distance"], np.radians(sc["fov_x_deg"]),
                              size)
    for i, p in enumerate(ring):
        o = view.orbit_pose(45.0 * i, sc, size)
        np.testing.assert_allclose(o["position"], p["position"], atol=1e-12)
        np.testing.assert_allclose(o["rotation"], p["rotation"], atol=1e-12)
        assert abs(o["fov_y"] - p["fov_y"]) < 1e-12
    pose = view.orbit_pose(3000000019 * math.pi, sc, size)
    q = parse_qs(urlparse(view.query(pose, size)).query)
    got = [float(q[k][0]) for k in ("px", "py", "pz", "qw", "qx", "qy",
                                    "qz", "fovx", "fovy")]
    assert got == [*pose["position"], *pose["rotation"], pose["fov_x"],
                   pose["fov_y"]]
    assert (int(q["w"][0]), int(q["h"][0])) == size


def _image(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("shape", [(7, 5), (9, 13, 3), (6, 11, 4)])
def test_decoder_reads_the_viewer_encoder(shape):
    from brush_tpu_torch.datasets.png import encode_png

    img = _image(shape)
    got = frame.decode_png(encode_png(img))
    assert np.array_equal(got.reshape(img.shape), img)


@pytest.mark.parametrize("kinds", [0, 1, 2, 3, 4, None])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_decoder_reads_every_row_filter(kinds, channels):
    from brush_tpu_torch.datasets.testing import filtered_png

    img = _image((12, 17, channels), seed=channels)
    if channels == 1:
        img = img[..., 0]
    rows = None if kinds is None else [kinds] * 12
    got = frame.decode_png(filtered_png(img, rows))
    assert np.array_equal(got.reshape(img.shape), img)


def test_decoder_refuses_what_is_not_a_frame():
    from brush_tpu_torch.datasets.png import encode_png

    data = bytearray(encode_png(_image((4, 4, 3))))
    with pytest.raises(ValueError):
        frame.decode_png(b"not a png at all, not a png at all")
    data[40] ^= 0xFF   # inside IDAT: the CRC no longer holds
    with pytest.raises(ValueError):
        frame.decode_png(bytes(data))


def test_composite_is_the_viewers():
    """reference/frame.composite of a float RGBA render equals what
    RenderService.render_png serves for it, values on the floor's edges
    included."""
    import torch

    import brush_tpu_torch.viewer.server as vsrv
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.splats import from_random

    g = torch.Generator().manual_seed(7)
    h, w = 24, 32
    img = torch.rand((h, w, 4), generator=g)
    img[..., :3] *= img[..., 3:]
    img[0, :8] = torch.tensor([k / 255.0 for k in range(8 * 4)]).reshape(8, 4)
    img[1, :4, :] = torch.tensor([-0.5, 1.5, 1.0, 0.0])

    def fixed(full):
        def render(*a, **k):
            _, aux = full(*a, **k)
            return img.clone(), aux
        return render

    svc = vsrv.RenderService(block_size=32)
    svc.publish(from_random(np.random.default_rng(0), [-1] * 3, [1] * 3,
                            count=8, sh_degree=0, device="cpu"))
    cam = Camera(position=[0, 0, -4.0], rotation=[1, 0, 0, 0], fov_x=0.8,
                 fov_y=0.6)
    with view.patched(vsrv, "render_splats", fixed):
        served = frame.decode_png(svc.render_png(cam, (w, h)))
    assert np.array_equal(served, frame.composite(img.numpy()))
