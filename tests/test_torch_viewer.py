"""The port's viewer (brush_tpu_torch/viewer/) against brush_tpu's: every
endpoint and control over real HTTP against a live training thread on the
CPU (the five tests of tests/test_viewer.py), frames within one u8 level
of brush_tpu's RenderService, `cli view` in a subprocess, the page byte-
equal to the reference's, and the progressive .ply load."""

import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from brush_tpu.camera import Camera as JCamera
from brush_tpu.splats import from_random as j_from_random
from brush_tpu.viewer.server import RenderService as JRenderService

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.config import TrainConfig
from brush_tpu_torch.convert import splats_from_numpy
from brush_tpu_torch.datasets.ply import load_splats_from_ply, splats_to_ply
from brush_tpu_torch.datasets.png import decode_png
from brush_tpu_torch.datasets.scene import Dataset, Scene, SceneView
from brush_tpu_torch.splats import from_dense, from_random
from brush_tpu_torch.viewer import server as viewer_server
from brush_tpu_torch.viewer.server import (
    RenderService, TrainWorker, ViewerServer,
)
from torch_threads import pin_threads

pin_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME_CAM = dict(position=[0.0, 0.0, -4.0], rotation=[1, 0, 0, 0],
                 fov_x=0.8, fov_y=0.8)
FRAME_QUERY = ("/api/frame?px=0&py=0&pz=-4&qw=1&qx=0&qy=0&qz=0"
               "&fovx=0.8&fovy=0.8&w=64&h=48")


def free_port() -> int:
    """A port no one listens on: xdist runs test files side by side, so
    no fixed port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(port: int, path: str = "/api/state", seconds: float = 60.0):
    deadline = time.time() + seconds
    while True:
        try:
            return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                          timeout=5).read()
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.1)


def _tiny_dataset(n_views=3, size=32):
    rng = np.random.default_rng(0)
    views = []
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views
        cam = Camera(
            position=[4 * np.sin(theta), 0.0, -4 * np.cos(theta)],
            rotation=[np.cos(theta / 2), 0, -np.sin(theta / 2), 0],
            fov_x=0.8, fov_y=0.8,
        )
        img = rng.uniform(0, 1, size=(size, size, 3)).astype(np.float32)
        views.append(SceneView(name=f"v{i}", camera=cam, image=img))
    return Dataset(train=Scene(views=views), eval=None)


def _random_splats(seed, count):
    rng = np.random.default_rng(seed)
    return from_random(rng, [-1, -1, -1], [1, 1, 1], count=count,
                       sh_degree=0, device="cpu")


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    ds = _tiny_dataset()
    render = RenderService(block_size=16)
    export = str(tmp_path_factory.mktemp("viewer") / "viewer_test.ply")
    worker = TrainWorker(ds, _random_splats(1, 64),
                         TrainConfig(warmup_steps=0), render, block_size=16,
                         export_path=export)
    worker.start()
    srv = ViewerServer(render, dataset=ds, worker=worker, port=free_port())
    srv.export = export
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    wait_for(srv.port)
    yield srv
    srv.shutdown()
    serving.join(timeout=30)
    # No training thread outlives this file in its xdist worker.
    for w in {worker, srv.worker}:
        if w is not None:
            w.stop()
            w.join(timeout=60)
            assert not w.is_alive()
    assert not serving.is_alive()


def _get(srv, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                  timeout=180).read()


def _post(srv, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(obj).encode(),
        method="POST")
    return urllib.request.urlopen(req, timeout=180).read()


def _state(srv):
    return json.loads(_get(srv, "/api/state"))


def _until(srv, cond, tries=300):
    for _ in range(tries):
        st = _state(srv)
        if cond(st):
            return st
        time.sleep(0.1)
    return _state(srv)


def test_page_and_state(server):
    assert b"brush_tpu viewer" in _get(server, "/")
    st = _state(server)
    assert st["training"] and st["num_views"] == 3
    st = _until(server, lambda s: s.get("iter", 0) > 2, tries=900)
    assert st["iter"] > 2 and "error" not in st
    assert np.isfinite(st["loss"]) and st["iters_per_s"] > 0


def test_frame_and_views(server):
    png = _get(server, FRAME_QUERY)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert decode_png(png).shape == (48, 64, 3)
    views = json.loads(_get(server, "/api/views"))
    assert views["views"] == ["v0", "v1", "v2"]
    cam = json.loads(_get(server, "/api/view_cam?i=1"))
    assert len(cam["position"]) == 3 and len(cam["rotation"]) == 4
    assert cam["name"] == "v1"
    thumb = _get(server, "/api/view_image?i=0")
    assert thumb[:8] == b"\x89PNG\r\n\x1a\n"


def test_eval_history_and_presets(server):
    _post(server, "/api/control", {"cmd": "eval"})
    hist = _until(server, lambda s: s.get("eval_history")).get(
        "eval_history", [])
    assert hist and len(hist[0]) == 3  # [iter, psnr, ssim] rows for the plots
    assert np.isfinite(hist[0][1]) and 0.0 <= hist[0][2] <= 1.0

    presets = json.loads(_get(server, "/api/presets"))
    assert isinstance(presets["presets"], list)


def test_load_new_dataset(server):
    created = {}

    def factory(path):
        ds = _tiny_dataset(n_views=5)
        worker = TrainWorker(ds, _random_splats(2, 32),
                             TrainConfig(warmup_steps=0), server.render,
                             block_size=16)
        created["path"] = path
        return ds, worker

    old = server.worker
    server.session_factory = factory
    _post(server, "/api/load", {"path": "fake://five-views"})
    assert created["path"] == "fake://five-views"
    assert not old.is_alive()     # stopped and joined before the swap
    assert _state(server)["num_views"] == 5
    st = _until(server, lambda s: s.get("iter", 0) > 1, tries=200)
    assert st["iter"] > 1


def test_controls(server):
    _post(server, "/api/control", {"cmd": "pause"})
    assert _until(server, lambda s: s.get("paused"))["paused"]

    _post(server, "/api/control", {"cmd": "export", "path": server.export})
    _post(server, "/api/control", {"cmd": "resume"})
    st = _until(server, lambda s: s.get("exported") and not s.get("paused"),
                tries=100)
    assert not st["paused"]
    with open(server.export, "rb") as f:
        sp = load_splats_from_ply(f.read(), device="cpu")
    assert sp.n_live > 0


def _decoded(png: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def test_frame_within_one_level_of_reference():
    """The same model (carried across as numpy) through brush_tpu's
    RenderService (its XLA path on the CPU) and the port's: the decoded RGB
    within one u8 level at every pixel. pack_rgba_u32 truncates, so the
    port's u16 colour quantization (<= 6e-5) can move a value across a
    level."""
    rng = np.random.default_rng(3)
    js = j_from_random(rng, [-1, -1, -1], [1, 1, 1], count=200, sh_degree=1)
    ts = splats_from_numpy({k: np.asarray(v) for k, v in js.params().items()},
                           int(js.n_live), device="cpu")
    want_r, got_r = JRenderService(block_size=16), RenderService(block_size=16)
    want_r.publish(js)
    got_r.publish(ts)
    size = (56, 40)   # partial tiles: the crop of the tile grid
    want = _decoded(want_r.render_png(JCamera(**FRAME_CAM), size))
    got = decode_png(got_r.render_png(Camera(**FRAME_CAM), size))
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape == (size[1], size[0], 3)
    assert diff.max() <= 1, (
        f"max {diff.max()} levels; {np.mean(diff > 0):.4%} of the values "
        f"differ")
    assert want.std() > 5.0   # the frame is not blank


def test_blank_frame_before_publish():
    png = RenderService().render_png(Camera(**FRAME_CAM), (24, 16))
    assert np.array_equal(decode_png(png), np.zeros((16, 24, 4), np.uint8))


def test_view_image_without_pillow_raises(monkeypatch):
    srv = ViewerServer(RenderService(), dataset=_tiny_dataset())
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        srv._view_image({"i": ["0"]})


def test_page_is_the_reference_page():
    def read(*parts):
        with open(os.path.join(ROOT, *parts), "rb") as f:
            return f.read()

    assert read("brush_tpu_torch", "viewer", "page.html") == read(
        "brush_tpu", "viewer", "page.html")


def test_ply_loads_progressively(tmp_path, monkeypatch):
    """make_viewer publishes a .ply as it parses, every 50,000 vertices
    (a last part shorter than that joins the one before, as in the JAX
    package), and starts no worker without a dataset."""
    n = 100_000
    rng = np.random.default_rng(4)
    path = tmp_path / "big.ply"
    path.write_bytes(splats_to_ply(from_dense(
        rng.normal(size=(n, 3)), rng.normal(size=(n, 1, 3)),
        np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)), rng.normal(size=n),
        np.full((n, 3), -3.0), device="cpu")))
    seen = []

    class Counted(RenderService):
        def publish(self, splats):
            seen.append(splats.n_live)
            super().publish(splats)

    monkeypatch.setattr(viewer_server, "RenderService", Counted)
    srv = viewer_server.make_viewer(ply=str(path), port=free_port(),
                                    device="cpu")
    assert seen == [50_000, n]
    assert srv.worker is None and srv.dataset is None


def test_cli_view_serves_the_in_process_frame(tmp_path):
    """`cli --device cpu view --ply ... --no-train` as a user starts it:
    its frame equals RenderService's byte for byte."""
    splats = _random_splats(5, 128)
    ply = tmp_path / "tiny.ply"
    ply.write_bytes(splats_to_ply(splats))
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "brush_tpu_torch.cli", "--device", "cpu",
         "view", "--ply", str(ply), "--no-train", "--port", str(port)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        wait_for(port, seconds=120)
        got = urllib.request.urlopen(
            f"http://127.0.0.1:{port}{FRAME_QUERY}", timeout=120).read()
        st = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/state", timeout=30).read())
    finally:
        proc.kill()
        out = proc.communicate(timeout=30)[0].decode()
    render = RenderService(block_size=512)
    render.publish(load_splats_from_ply(ply.read_bytes(), device="cpu"))
    want = render.render_png(Camera(**FRAME_CAM), (64, 48))
    assert got == want, out
    assert st["ready"] and not st["training"]

