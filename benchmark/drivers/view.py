"""Entry kind `view`: the viewer's `/api/frame`, as a browser drives it.

Set-up builds the scene from the seed (configs/<config>.json "scene",
made by scenes/<kind>.py, as drivers/train.py makes it) as one Splats,
publishes it to a RenderService with the configuration's block (512,
`cli view`'s default) and serves it with the ViewerServer's own request
handler on a free localhost port, in a thread, as `ViewerServer.
serve_forever` does. The viewer sizes its own record pool: the
configuration's `pool` is the trainer's and is not passed.

One client (http.client) in this thread asks for frames in a closed
loop, the next request when the last PNG has arrived: `/api/frame` at the
scene's frame (w x h), fov_x the scene's and fov_y to match, the camera
on the ring at the scene's distance looking at the origin, the pose
exactly as the endpoint takes it (position and quaternion, every digit).
Each frame's azimuth is `azimuth_step_deg` past the last, from an
azimuth the seed draws: the golden angle, so every frame is a new pose
and any run of frames covers the ring evenly, whatever the seed and
however many frames a window holds. Its first `warmup_frames` frames
build every kernel and are set-up; the window then runs frames for
`seconds`.

- frame_ms, frame_p90_ms: the median and the 90th percentile of the
  window's round trips, from the request sent to the PNG's last byte
  read (a new connection each, as the server answers in HTTP/1.0);
- attempted: the requests sent in the window; failed: an answer other
  than 200, or a PNG whose header is not w x h, 8-bit RGB.

`correct`: the window's first and last frames and `sampled_frames` more
drawn from the seed (each the first sent at or after a share of the
window the seed draws) are kept as served. After the window (peak memory
read), the program renders each of their poses once more in this
process, through `render_png` with a pool that holds every record (the
frame's count and an eighth), and reads the records its own pool drops
there: `diagnostics`, printed and not compared. With the program freed,
reference/frame.py decodes the kept PNGs, and reference/splat.py renders
each pose on the device in blocks with the configuration's scan; its
composite (reference/frame.composite) is what the served frame is held
to: level_gap and off_share, each the worst over the kept frames.

With --trace 1 the window records the program's stage marks and
counters: the client marks `frame` after each answer, and the server's
thread `request` as `render_png` starts, so a frame's stages are the
request's way in, the render's stages and `frame` (the pack, the host
copy, the composite, the encoder and the way out). `trace_frames` frames
after it run under torch.profiler; their work (counts/work.py, pairs from
reference/splat.py) is counted from the reference's render of their
poses.

Faults (tests and calibration only), planted under the served path:
stale (each request answered with the previous request's frame),
pose_off (the served camera turned `pose_off_deg` further along the
orbit), pool_small (each frame rendered again in a pool of half its
records), altered (one pixel of each frame changed by 128 levels as it is
encoded); `control` puts the reference computed with TF32 on in the
program's place and keeps its numbers in run["control"].
"""

from __future__ import annotations

import contextlib
import http.client
import math
import statistics
import threading
import time
import zlib

import numpy as np
import torch

from benchmark import harness
from benchmark.counts import work
from benchmark.drivers import train as base
from benchmark.reference import frame, splat as ref

RGB = 2   # the PNG colour type of an RGB frame


def orbit_pose(deg: float, sc: dict, size) -> dict:
    """The camera at azimuth `deg` on the scene's ring, looking at the
    origin (scenes/uniform.ring_poses's convention), square pixels."""
    w, h = size
    th = math.radians(deg)
    fov_x = math.radians(sc["fov_x_deg"])
    d = float(sc["distance"])
    return {"position": [d * math.sin(th), 0.0, -d * math.cos(th)],
            "rotation": [math.cos(th / 2), 0.0, -math.sin(th / 2), 0.0],
            "fov_x": fov_x,
            "fov_y": 2 * math.atan(math.tan(0.5 * fov_x) * h / w)}


def query(pose: dict, size) -> str:
    px, py, pz = pose["position"]
    qw, qx, qy, qz = pose["rotation"]
    parts = dict(px=px, py=py, pz=pz, qw=qw, qx=qx, qy=qy, qz=qz,
                 fovx=pose["fov_x"], fovy=pose["fov_y"])
    args = "&".join(f"{k}={float(v)!r}" for k, v in parts.items())
    return f"/api/frame?{args}&w={int(size[0])}&h={int(size[1])}"


def fetch(port: int, path: str):
    """(status, body, seconds) of one GET, from the request sent to the
    body's last byte read."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t = time.perf_counter()
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, body, time.perf_counter() - t
    finally:
        conn.close()


def frame_ok(status: int, body: bytes, size) -> bool:
    return status == 200 and frame.header(body) == (
        int(size[0]), int(size[1]), 8, RGB, 0)


@contextlib.contextmanager
def patched(module, name: str, make):
    """module.<name> replaced by make(original) inside the block."""
    full = getattr(module, name)
    setattr(module, name, make(full))
    try:
        yield
    finally:
        setattr(module, name, full)


def serve(service):
    """(httpd, thread): the ViewerServer's request handler on a free
    localhost port, served in a thread; request threads are joined when
    the server closes."""
    from http.server import ThreadingHTTPServer

    from brush_tpu_torch.viewer.server import ViewerServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                ViewerServer(service).make_handler())
    httpd.daemon_threads = False
    thread = threading.Thread(target=httpd.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    return httpd, thread


def _faulted(service, faults: tuple, sc: dict, wl: dict):
    """The service's render_png with the `request` mark first, under the
    planted faults pose_off and stale."""
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.utils import profiler

    full = service.render_png
    prev = {}

    def render(camera, size):
        profiler.mark("request")
        if "pose_off" in faults:
            x, _, z = (float(v) for v in camera.position)
            p = orbit_pose(math.degrees(math.atan2(x, -z))
                           + float(wl["pose_off_deg"]), sc, size)
            camera = Camera(position=p["position"], rotation=p["rotation"],
                            fov_x=p["fov_x"], fov_y=p["fov_y"])
        out = full(camera, size)
        if "stale" in faults:
            out, prev["png"] = prev.get("png", out), out
        return out
    return render


def _pool_small(full):
    def render(*a, **k):
        _, aux = full(*a, **k)
        return full(*a, **k, max_isects=max(int(aux.num_isects) // 2, 1))
    return render


def _altered(full):
    def encode(img):
        img = np.array(img)
        img[img.shape[0] // 2, img.shape[1] // 2, 0] ^= 0x80
        return full(img)
    return encode


def drive(ctx: harness.Context) -> harness.Outcome:
    import brush_tpu_torch.viewer.server as vsrv
    from brush_tpu_torch.splats import Splats

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    sc = cfg["scene"]
    size = (int(sc["width"]), int(sc["height"]))
    scene = base.scene_module(cfg)
    p = scene.params(sc, ctx.seed, dev)
    splats = Splats(n_live=p["means"].shape[0], **p)
    del p
    harness.phase(ctx, f"{splats.n_live} splats on the device")
    service = vsrv.RenderService(block_size=int(cfg["block_size"]))
    service.publish(splats)
    service.render_png = _faulted(service, ctx.faults, sc, wl)
    httpd, thread = serve(service)
    port = httpd.server_address[1]
    rng = np.random.default_rng(ctx.seed)
    start = float(rng.uniform(0.0, 360.0))
    draws = sorted(float(u) for u in rng.uniform(
        0.05, 0.95, int(wl["sampled_frames"])))
    step = float(wl["azimuth_step_deg"])
    warm = int(wl["warmup_frames"])
    pose_at = lambda k: orbit_pose(start + step * k, sc, size)
    stack = contextlib.ExitStack()
    if "pool_small" in ctx.faults:
        stack.enter_context(patched(vsrv, "render_splats", _pool_small))
    if "altered" in ctx.faults:
        stack.enter_context(patched(vsrv, "encode_png", _altered))
    try:
        with stack:
            out = _run(ctx, port, pose_at, warm, draws, size, dev)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    peak = harness.peak_bytes(dev)
    out["diagnostics"] = _served_pools(service, vsrv, out["kept"], size)
    del service, splats
    harness.free(dev)
    harness.phase(ctx, "program freed")
    return _finish(ctx, out, peak, size, dev)


def _run(ctx, port, pose_at, warm, draws, size, dev) -> dict:
    """Warm-up, the window and the traced frames: what the client saw."""
    from brush_tpu_torch.utils import profiler

    failed = 0
    for k in range(-warm, 0):
        status, body, _ = fetch(port, query(pose_at(k), size))
        failed += not frame_ok(status, body, size)
    if failed:
        raise RuntimeError(f"{failed} of {warm} warm-up frames failed")
    harness.sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    harness.phase(ctx, f"{warm} warm-up frames: set-up done")

    record = (profiler.record(host=dev.type != "cuda") if ctx.trace
              else harness.no_marks())
    kept, rtts = {}, []
    k = 0
    with record as stages:
        t = time.perf_counter()
        while True:
            sent = time.perf_counter() - t
            pose = pose_at(k)
            status, body, dt = fetch(port, query(pose, size))
            profiler.mark("frame")
            rtts.append(dt)
            failed += not frame_ok(status, body, size)
            if k == 0:
                kept["first"] = (pose, body)
            for j, u in enumerate(draws):
                if f"drawn{j}" not in kept and sent >= u * ctx.seconds:
                    kept[f"drawn{j}"] = (pose, body)
            last = (pose, body)
            k += 1
            if time.perf_counter() - t >= ctx.seconds:
                break
        window = time.perf_counter() - t
    for j in range(len(draws)):
        kept.setdefault(f"drawn{j}", last)
    kept["last"] = last
    ms = sorted(1e3 * v for v in rtts)
    p90 = float(np.percentile(ms, 90))
    harness.phase(ctx, f"window: {k} frames in {window:.3f} s; round trip "
                  f"median {statistics.median(ms):.3f} ms, p90 {p90:.3f} "
                  f"ms over {len(ms)} samples ({sum(v > p90 for v in ms)} "
                  f"beyond it), least {ms[0]:.3f}, most {ms[-1]:.3f}; "
                  f"{failed} failed")
    harness.phase(ctx, "round trips, ms, in order: " + " ".join(
        f"{1e3 * v:.2f}" for v in rtts))
    run = {"steps": harness.split_steps(stages, "frame") if ctx.trace
           else [], "unit_s": window / k}
    traced = []
    if ctx.trace:
        n = k

        def one():
            nonlocal n
            pose = pose_at(n)
            traced.append(pose)
            with torch.profiler.record_function("frame"):
                fetch(port, query(pose, size))
            n += 1

        tr = harness.traced(one, int(ctx.workload["trace_frames"]), dev)
        run.update(busy_s=tr["busy_s"], window_s=tr["window_s"],
                   breakdown=tr["breakdown"], kernel_s={
                       "rasterize_fwd": harness.kernel_seconds(
                           tr, ("rasterize_fwd_kernel",),
                           lead="tile_order_kernel")})
    return {"setup_s": setup_s, "rtts": ms, "p90": p90, "frames": k,
            "failed": failed, "kept": kept, "run": run, "traced": traced}


def _served_pools(service, vsrv, kept: dict, size) -> dict:
    """At each kept pose, the records the served path's pool drops and
    the frame served from a pool that holds them all (the frame's count
    and an eighth, rounded as the program rounds a pool)."""
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.render import pool_size

    seen = {}

    def capture(full):
        def render(*a, **k):
            img, aux = full(*a, **k)
            seen["aux"], seen["n"] = aux, a[0].shape[0]
            return img, aux
        return render

    out = {}
    for name, (pose, _) in kept.items():
        cam = Camera(position=pose["position"], rotation=pose["rotation"],
                     fov_x=pose["fov_x"], fov_y=pose["fov_y"])
        with patched(vsrv, "render_splats", capture):
            vsrv.RenderService.render_png(service, cam, size)
        aux, n = seen["aux"], seen["n"]
        dropped = int(aux.num_dropped)
        raw = int(aux.num_isects) + dropped
        pool = pool_size(n, size, None, service.block_size)
        ample = pool_size(n, size, raw + raw // 8, service.block_size)

        def wide(full):
            return lambda *a, **k: full(*a, **k, max_isects=ample)
        with patched(vsrv, "render_splats", wide):
            png = vsrv.RenderService.render_png(service, cam, size)
        out[name] = {"records": raw, "pool": pool, "dropped": dropped,
                     "ample_pool": ample, "ample_png": png}
    return out


def reference_frames(cfg, seed, dev, poses, tf32: bool = False) -> list:
    """The reference's composite (uint8 (h, w, 3)) of each pose, from the
    parameters the seed gives."""
    sc = cfg["scene"]
    size = (int(sc["width"]), int(sc["height"]))
    params = base.scene_module(cfg).params(sc, seed, dev)
    active = torch.ones(params["means"].shape[0], dtype=torch.bool,
                        device=dev)
    out = []
    with ref.precision(tf32):
        for pose in poses:
            img = ref.render_image(params, active, ref.make_cam(pose, size,
                                                                dev),
                                   scan=base.scan_of(cfg))
            out.append(frame.composite(img.cpu().numpy()))
            del img
    return out


def _decode(body: bytes) -> np.ndarray:
    """The served frame, or an empty array where it does not decode."""
    try:
        return frame.decode_png(body)
    except (ValueError, zlib.error):
        return np.zeros((0, 0, 3), np.uint8)


def worst(pairs) -> dict:
    """The worst of each number over (served, reference) pairs."""
    nums = [frame.numbers(s, r) for s, r in pairs]
    return {k: max(n[k] for n in nums) for k in nums[0]}


def _finish(ctx, out, peak, size, dev) -> harness.Outcome:
    cfg, wl = ctx.config, ctx.workload
    run = out["run"]
    kept = out["kept"]
    names = list(kept)
    poses = [kept[n][0] for n in names]
    if ctx.trace:
        run["work"] = _work(cfg, ctx.seed, dev, out["traced"], size)
        harness.free(dev)
    refs = reference_frames(cfg, ctx.seed, dev, poses)
    harness.phase(ctx, "reference done")
    served = [_decode(kept[n][1]) for n in names]
    nums = worst(zip(served, refs))
    diag = out["diagnostics"]
    ample = worst((_decode(diag[n]["ample_png"]), r)
                  for n, r in zip(names, refs))
    run["diagnostics"] = {
        "dropped": [diag[n]["dropped"] for n in names],
        "records": [diag[n]["records"] for n in names],
        "pool": diag[names[0]]["pool"],
        "ample_level_gap": ample["level_gap"],
        "ample_off_share": ample["off_share"]}
    for n in names:
        d = diag[n]
        harness.phase(ctx, f"{n} frame: {d['records']} records, "
                      f"{d['dropped']} dropped from the served pool of "
                      f"{d['pool']}")
    harness.phase(ctx, "the same poses served from a pool that holds every "
                  f"record: level_gap {ample['level_gap']!r}, off_share "
                  f"{ample['off_share']!r}")
    if "control" in ctx.faults:
        ctl = reference_frames(cfg, ctx.seed, dev, poses, tf32=True)
        run["control"] = worst(zip(ctl, refs))
    checks = {k: (v, float(wl["limits"][k])) for k, v in nums.items()}
    ms = out["rtts"]
    e2e = {"frame_ms": statistics.median(ms), "frame_p90_ms": out["p90"],
           "setup_s": out["setup_s"], "peak_mem_gib": peak / 2 ** 30}
    return harness.Outcome(e2e=e2e, run=run, checks=checks,
                           attempted=out["frames"], failed=out["failed"],
                           memory_peak_bytes=peak,
                           busy_s=run.get("busy_s"),
                           window_s=run.get("window_s"),
                           breakdown=run.get("breakdown"))


def _work(cfg, seed, dev, traced, size) -> dict:
    """The counts (ops, bytes) of the traced frames: rasterize_fwd's
    summed over them (its device time is the trace's sum), and a frame's
    on average (projection, SH and the rasterizer)."""
    sc = cfg["scene"]
    params = base.scene_module(cfg).params(sc, seed, dev)
    n = params["means"].shape[0]
    coeffs = params["sh_coeffs"].shape[1]
    active = torch.ones(n, dtype=torch.bool, device=dev)
    fwd, unit = [0, 0], [0, 0]
    pixels = size[0] * size[1]
    for pose in traced:
        cam = ref.make_cam(pose, size, dev)
        with torch.no_grad():
            s = ref.project(params, cam, active)
            rec = ref.records(s, size)
            _, pairs, hits = ref.render((s.xy, s.conic, s.color, s.opac),
                                        rec, size, count=True)
        r = work.raster_fwd(pairs, int(s.visible.sum()), hits, pixels)
        u = work.total(work.projection(n, coeffs), r)
        for acc, w in ((fwd, r), (unit, u)):
            acc[0] += w[0]
            acc[1] += w[1]
        del s, rec
    m = max(len(traced), 1)
    return {"rasterize_fwd": tuple(fwd), "unit": (unit[0] / m, unit[1] / m)}
