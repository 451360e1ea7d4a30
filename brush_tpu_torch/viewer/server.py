"""HTTP viewer server + background training worker (port of
brush_tpu/viewer/server.py).

Architecture mirrors the reference viewer's message-passing design
(reference: brush-viewer/src/viewer.rs:177-211 spawns the train task and
talks to it over channels; train_loop.rs:25-28 defines TrainMessage
{Paused, Eval}): here the browser is the UI thread, `TrainWorker` is the
train task, and a queue.Queue carries the control messages. The interactive
render path is the reference's `render_u32_buffer=true` mode
(panels/scene.rs:113, rasterize.wgsl:106-109): frames are packed RGBA8
words via render.pack_rgba_u32, composited on the host and shipped as PNG
by the port's own encoder (datasets/png.py), so no Pillow is needed to
serve frames.

Threads: each request runs on its own thread (ThreadingHTTPServer) and
renders on the published splats' device while the worker thread trains on
it; both use the device's default stream, so their kernels run in turn.

Endpoints:
  GET  /                   viewer page
  GET  /api/state          stats JSON (iter, loss, splats, iters/s, eval)
  GET  /api/frame?...      orbit render (PNG)
  GET  /api/views          dataset browser listing
  GET  /api/view_image?i=  ground-truth image (PNG, downscaled; Pillow)
  GET  /api/view_cam?i=    camera pose of a dataset view
  GET  /api/presets        dataset zips found on this machine
  POST /api/control        {"cmd": "pause"|"resume"|"eval"|"export", ...}
  POST /api/load           {"path": ...}: a new dataset and training worker
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.datasets.png import encode_png
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.render import pack_rgba_u32, render_splats


class RenderService:
    """Renders the current splat model for arbitrary cameras.

    Thread-safe: the worker publishes a Splats whose tensors nothing
    writes afterwards; each request renders it on its device.
    """

    def __init__(self, block_size: int = 256, cell=(1, 1)):
        self._splats = None
        self._lock = threading.Lock()
        self.block_size = block_size
        self.cell = tuple(cell)

    def publish(self, splats):
        # Request threads render the published tensors while the worker
        # goes on training. That is sound only while the trainer never
        # writes a published tensor in place: Adam returns new tensors
        # (optim.adam_step) and the refine builds new rows. Keep it so.
        with self._lock:
            self._splats = splats

    @property
    def ready(self) -> bool:
        return self._splats is not None

    def render_png(self, camera, img_size) -> bytes:
        with self._lock:
            s = self._splats
        if s is None:
            return encode_png(np.zeros((img_size[1], img_size[0], 4),
                                       np.uint8))
        cp = camera_params(camera, img_size, device=s.device)
        img, _ = render_splats(
            s.means, s.log_scales, s.quats, s.sh_coeffs, s.raw_opacity,
            cp, img_size, active=s.active_mask(), block_size=self.block_size,
            cell=self.cell, needs_grad=False,
        )
        # The reference's display path: RGBA8 packed into u32 words, one
        # copy to the host.
        packed = pack_rgba_u32(img).cpu().numpy()
        rgba = packed.view(np.uint8).reshape(packed.shape[0], packed.shape[1], 4)
        # Composite over the viewer's dark background for display. The
        # rasterizer output is alpha-PREMULTIPLIED (rgb = sum a_i T_i c_i),
        # so over-compositing is rgb + bg*(1-a) — multiplying by a again
        # would square the alpha weighting and darken every semi-
        # transparent region.
        a = rgba[..., 3:4].astype(np.float32) / 255.0
        bg = 24.0
        rgb = np.clip(
            rgba[..., :3].astype(np.float32) + bg * (1 - a), 0, 255
        ).astype(np.uint8)
        return encode_png(rgb)


class TrainWorker(threading.Thread):
    """Background training loop with a control-message queue.

    Mirrors train_loop.rs:96-172: poll control messages, otherwise step.
    Trains on the device of the splats it is given.
    """

    def __init__(self, dataset, splats, config, render: RenderService,
                 block_size: int = 256, export_path: str = "export.ply"):
        super().__init__(daemon=True)
        self.dataset = dataset
        self.config = config
        self.render = render
        self.block_size = block_size
        self.export_path = export_path
        self.control: queue.Queue = queue.Queue()
        self.stats: dict = {"iter": 0, "paused": False}
        self._stats_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._splats0 = splats

    def put_stats(self, **kw):
        with self._stats_lock:
            self.stats.update(kw)

    def get_stats(self) -> dict:
        with self._stats_lock:
            return dict(self.stats)

    def stop(self):
        self._stop_evt.set()

    def run(self):
        from brush_tpu_torch.datasets.loader import SceneLoader
        from brush_tpu_torch.train import SplatTrainer

        trainer = SplatTrainer(self.config, raster_block_size=self.block_size,
                               raster_cell=self.render.cell)
        state = trainer.init_state(self._splats0)
        self.render.publish(state.splats)
        loader = SceneLoader(self.dataset.train, seed=self.config.seed)
        paused = False
        window: list = []
        try:
            while not self._stop_evt.is_set():
                try:
                    msg = self.control.get_nowait()
                except queue.Empty:
                    msg = None
                try:
                    if msg is not None:
                        state = self._handle(msg, trainer, state)
                        paused = self.get_stats().get("paused", False)
                        continue
                    if paused:
                        time.sleep(0.05)
                        paused = self.get_stats().get("paused", False)
                        continue

                    batch = loader.next_batch()
                    t0 = time.time()
                    state, stats = trainer.step(state, batch)
                    # Read the step's stats inside the window: that waits
                    # for its work on a card, whose launches alone return
                    # early and would overstate the rate.
                    done = dict(
                        iter=trainer.iter,
                        loss=float(stats.loss),
                        splats=int(state.splats.n_live),
                        num_visible=int(stats.num_visible),
                        num_isects=int(stats.num_isects),
                        num_dropped=int(stats.num_dropped),
                    )
                    window.append(time.time() - t0)
                    window[:] = window[-25:]  # stats.rs:120 25-sample window
                    self.render.publish(state.splats)
                    self.put_stats(
                        **done,
                        iters_per_s=len(window) / max(sum(window), 1e-9),
                    )
                except Exception:
                    # Surface the failure instead of dying silently: the
                    # daemon thread keeps serving /api/state with an error
                    # field so the browser shows training stopped.
                    import traceback

                    self.put_stats(error=traceback.format_exc(), paused=True)
                    paused = True
        finally:
            loader.close()

    def _handle(self, msg, trainer, state):
        cmd = msg.get("cmd")
        if cmd == "pause":
            self.put_stats(paused=True)
        elif cmd == "resume":
            self.put_stats(paused=False)
        elif cmd == "eval":
            from brush_tpu_torch.eval import eval_stats

            scene = self.dataset.eval or self.dataset.train
            views = [(v.camera, v.image) for v in scene.views[:8]]
            evals = eval_stats(state.splats, views, block_size=self.block_size,
                               cell=self.render.cell)
            psnr = float(np.mean([e.psnr for e in evals]))
            # PSNR history feeds the stats panel's plot (stats.rs:120-160).
            ssim = float(np.mean([e.ssim for e in evals]))
            hist = self.get_stats().get("eval_history", []) + [
                [trainer.iter, round(psnr, 3), round(ssim, 4)]
            ]
            self.put_stats(
                eval_psnr=psnr,
                eval_ssim=ssim,
                eval_history=hist[-200:],
            )
        elif cmd == "export":
            from brush_tpu_torch.datasets.ply import splats_to_ply

            path = msg.get("path") or self.export_path
            with open(path, "wb") as f:
                f.write(splats_to_ply(state.splats))
            self.put_stats(exported=path)
        return state


class ViewerServer:
    def __init__(self, render: RenderService, dataset=None,
                 worker: TrainWorker | None = None, port: int = 8642,
                 session_factory=None, preset_dirs=("data", ".")):
        self.render = render
        self.dataset = dataset
        self.worker = worker
        self.port = port
        # session_factory(path) -> (dataset, worker): enables loading a new
        # dataset from the browser (the reference's LoadData panel).
        self.session_factory = session_factory
        self.preset_dirs = preset_dirs
        self._httpd: ThreadingHTTPServer | None = None
        # Guards worker/dataset swaps against concurrent request threads
        # (ThreadingHTTPServer serves each request on its own thread).
        self._session_lock = threading.Lock()

    def _presets(self) -> dict:
        """Dataset zips discoverable on this machine (Presets panel)."""
        found = []
        for d in self.preset_dirs:
            p = Path(d)
            if p.is_dir():
                found += sorted(str(f) for f in p.glob("*.zip"))
        return {"presets": found}

    def load_source(self, path: str) -> None:
        if self.session_factory is None:
            raise RuntimeError("viewer started without a session factory")
        with self._session_lock:
            if self.worker is not None:
                self.worker.stop()
                self.worker.join(timeout=30)
                if self.worker.is_alive():
                    # Still inside a long step or a kernel build: starting
                    # a second worker would race two trainers on the same
                    # RenderService and device. Refuse instead.
                    raise RuntimeError(
                        "previous training worker has not stopped yet "
                        "(likely mid-step); retry in a moment"
                    )
            self.dataset, self.worker = self.session_factory(path)
            if self.worker is not None:
                self.worker.start()

    # ------------------------------------------------------------------ #

    def _page(self) -> bytes:
        return (Path(__file__).parent / "page.html").read_bytes()

    def _state_json(self) -> dict:
        st = self.worker.get_stats() if self.worker else {}
        st["training"] = self.worker is not None
        st["ready"] = self.render.ready
        if self.dataset is not None:
            st["num_views"] = len(self.dataset.train.views)
            center, extent = self.dataset.train.bounds(0.0, 0.0)
            st["focus"] = [float(v) for v in center]
            st["extent"] = float(np.linalg.norm(extent)) or 1.0
        else:
            st.setdefault("focus", [0.0, 0.0, 0.0])
            st.setdefault("extent", 2.0)
        return st

    def _frame(self, q) -> bytes:
        g = lambda k, d: float(q.get(k, [d])[0])
        w = int(g("w", 512))
        h = int(g("h", 384))
        cam = Camera(
            position=[g("px", 0), g("py", 0), g("pz", -4)],
            rotation=[g("qw", 1), g("qx", 0), g("qy", 0), g("qz", 0)],
            fov_x=g("fovx", 1.0), fov_y=g("fovy", 0.8),
        )
        return self.render.render_png(cam, (w, h))

    def _views(self) -> dict:
        views = self.dataset.train.views if self.dataset else []
        return {"views": [v.name for v in views]}

    def _view_image(self, q) -> bytes:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("/api/view_image makes its thumbnails with "
                              "Pillow, which is not installed") from e

        i = int(q.get("i", [0])[0])
        img = self.dataset.train.views[i].image
        u8 = np.clip(img[..., :3] * 255, 0, 255).astype(np.uint8)
        pil = Image.fromarray(u8, "RGB")
        pil.thumbnail((160, 160))
        buf = io.BytesIO()
        pil.save(buf, format="PNG")
        return buf.getvalue()

    def _view_cam(self, q) -> dict:
        i = int(q.get("i", [0])[0])
        cam = self.dataset.train.views[i].camera
        return {
            "position": [float(v) for v in cam.position],
            "rotation": [float(v) for v in cam.rotation],
            "fov_x": float(cam.fov_x), "fov_y": float(cam.fov_y),
            "name": self.dataset.train.views[i].name,
        }

    # ------------------------------------------------------------------ #

    def make_handler(server):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                try:
                    if u.path == "/":
                        self._send(200, server._page(), "text/html")
                    elif u.path == "/api/state":
                        self._send(200, json.dumps(server._state_json()).encode(),
                                   "application/json")
                    elif u.path == "/api/frame":
                        self._send(200, server._frame(q), "image/png")
                    elif u.path == "/api/views":
                        self._send(200, json.dumps(server._views()).encode(),
                                   "application/json")
                    elif u.path == "/api/view_image":
                        self._send(200, server._view_image(q), "image/png")
                    elif u.path == "/api/view_cam":
                        self._send(200, json.dumps(server._view_cam(q)).encode(),
                                   "application/json")
                    elif u.path == "/api/presets":
                        self._send(200, json.dumps(server._presets()).encode(),
                                   "application/json")
                    else:
                        self._send(404, b"not found", "text/plain")
                except Exception as e:  # surface errors to the browser
                    self._send(500, str(e).encode(), "text/plain")

            def do_POST(self):
                u = urlparse(self.path)
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    msg = json.loads(self.rfile.read(n) or b"{}")
                    if u.path == "/api/control" and server.worker:
                        server.worker.control.put(msg)
                        self._send(200, b'{"ok": true}', "application/json")
                    elif u.path == "/api/load":
                        server.load_source(msg["path"])
                        self._send(200, b'{"ok": true}', "application/json")
                    else:
                        self._send(404, b"not found", "text/plain")
                except Exception as e:
                    self._send(500, str(e).encode(), "text/plain")

        return Handler

    def serve_forever(self):
        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port),
                                          self.make_handler())
        print(f"viewer: http://127.0.0.1:{self.port}/", flush=True)
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._httpd.server_close()
            if self.worker:
                self.worker.stop()

    def shutdown(self):
        if self._httpd:
            self._httpd.shutdown()


def make_viewer(source=None, ply=None, train=True, port=8642,
                config=None, sh_degree=3, init_count=10000,
                block_size=256, max_resolution=None, eval_split_every=None,
                cell=(1, 1), device="cuda") -> ViewerServer:
    """The viewer of a .ply, or of a dataset trained live on `device`: the
    render service (the .ply published as it loads), the dataset and the
    training worker (started), ready to serve."""
    from brush_tpu_torch.config import TrainConfig
    from brush_tpu_torch.datasets import load_dataset, load_initial_splats
    from brush_tpu_torch.datasets.loading import LoadDatasetArgs
    from brush_tpu_torch.device import resolve_device
    from brush_tpu_torch.splats import from_random

    dev = resolve_device(device)
    render = RenderService(block_size=block_size, cell=cell)

    def session_factory(src):
        """(dataset, unstarted worker) for a dataset source path."""
        dataset = load_dataset(src, LoadDatasetArgs(
            max_resolution=max_resolution, eval_split_every=eval_split_every))
        if not train:
            return dataset, None
        cfg = config or TrainConfig()
        splats = load_initial_splats(src, sh_degree=sh_degree, device=dev)
        if splats is None:
            center, extent = dataset.train.bounds(0.0, 0.0)
            bext = float(np.linalg.norm(extent))
            c2, e2 = dataset.train.bounds(bext * 0.25, bext)
            rng = np.random.default_rng(cfg.seed)
            splats = from_random(rng, c2 - e2, c2 + e2, count=init_count,
                                 sh_degree=sh_degree, device=dev)
        worker = TrainWorker(dataset, splats, cfg, render,
                             block_size=block_size)
        return dataset, worker

    dataset = None
    worker = None
    if ply:
        from brush_tpu_torch.datasets.ply import load_splats_from_ply_stream

        with open(ply, "rb") as f:
            # Progressive display during large loads (splat_import.rs:261-280:
            # the reference emits partial splats every 50k vertices).
            for partial in load_splats_from_ply_stream(f.read(), device=dev):
                render.publish(partial)
    if source:
        if ply:
            dataset = load_dataset(source, LoadDatasetArgs(
                max_resolution=max_resolution,
                eval_split_every=eval_split_every))
        else:
            dataset, worker = session_factory(source)
            if worker is not None:
                worker.start()

    return ViewerServer(render, dataset=dataset, worker=worker, port=port,
                        session_factory=session_factory)


def run_viewer(**kw):
    """Start the viewer (make_viewer's arguments) and serve until
    interrupted: view a .ply, or load a dataset and train live."""
    make_viewer(**kw).serve_forever()
