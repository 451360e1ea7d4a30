"""Independent ground truth: a ray tracer of solid boxes and spheres.

The port's copy of scripts/raytrace_scene.py (numpy, outside the port):
the "block castle" scene (coloured boxes, sphere caps and a checkered
base plate), traced with a directional light, hard shadows and
Blinn-Phong speculars. It shares no code and no rendering model with the
splat renderer, so a splat model can only match its images by learning
the scene. The scene is built with the same numpy draws as the script's;
the tracer runs as float64 torch ops on an explicit device (the card by
default, the CPU when asked), with the script's arithmetic, its 1e-5 hit
epsilon and its first-index rule where several primitives tie.

The writers emit the script's two layouts through the port's own writers
(datasets/testing.py) and PNG encoder: a NeRF-synthetic zip (train orbit
seed 1, val seed 2, RGBA) and a COLMAP zip (seed 1, RGB composited on
white, 12,000 surface points). The script writes its COLMAP images as
JPEG (quality 96, Pillow); these are PNGs named r_i.png.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from brush_tpu_torch.datasets import png
from brush_tpu_torch.datasets import testing as dt
from brush_tpu_torch.device import resolve_device

HIT_EPS = 1e-5        # a hit nearer than this is no hit (self-intersection)
SHADOW_OFFSET = 1e-4  # shadow rays start this far toward the light
SPEC_POWER = 32
DIFFUSE = 0.85
CHECKER_FREQ = 3.33   # base plate checker squares a world unit
COLMAP_POINTS = 12000
_F64 = torch.float64


def build_scene(seed: int = 7) -> dict:
    """The castle's primitives as float64 numpy arrays, drawn from
    default_rng(seed) in scripts/raytrace_scene.py:build_scene's order."""
    rng = np.random.default_rng(seed)
    boxes = []     # (lo(3), hi(3), color(3), gloss)
    spheres = []   # (center(3), radius, color(3), gloss)

    def add_box(cx, cy, w, d, h, z0, color, gloss=0.0):
        boxes.append((np.array([cx - w / 2, cy - d / 2, z0]),
                      np.array([cx + w / 2, cy + d / 2, z0 + h]),
                      np.asarray(color, np.float64), gloss))

    # Base plate (checkered at shade time).
    add_box(0, 0, 2.4, 2.4, 0.12, -0.12, [0.55, 0.55, 0.52])
    palette = [
        [0.85, 0.12, 0.10], [0.95, 0.80, 0.10], [0.10, 0.55, 0.85],
        [0.12, 0.70, 0.25], [0.90, 0.45, 0.10], [0.60, 0.15, 0.70],
        [0.90, 0.90, 0.88], [0.20, 0.20, 0.25],
    ]
    # Corner towers with sphere caps.
    for sx in (-0.8, 0.8):
        for sy in (-0.8, 0.8):
            h = 0.55 + 0.25 * rng.random()
            c = palette[rng.integers(len(palette))]
            add_box(sx, sy, 0.34, 0.34, h, 0.0, c)
            spheres.append((np.array([sx, sy, h + 0.14]), 0.17,
                            np.asarray(palette[rng.integers(len(palette))]),
                            0.6))
    # Walls.
    for (cx, cy, w, d) in [(0, -0.8, 1.25, 0.2), (0, 0.8, 1.25, 0.2),
                           (-0.8, 0, 0.2, 1.25), (0.8, 0, 0.2, 1.25)]:
        add_box(cx, cy, w, d, 0.34, 0.0, palette[rng.integers(len(palette))])
    # Stepped central keep and its ball.
    for i, s in enumerate([0.62, 0.46, 0.30]):
        add_box(0, 0, s, s, 0.28, 0.28 * i,
                palette[(2 * i + 1) % len(palette)], gloss=0.25 * i)
    spheres.append((np.array([0.0, 0.0, 0.98]), 0.15, [0.95, 0.85, 0.15], 0.8))
    # Bricks in the courtyard.
    for _ in range(10):
        cx, cy = rng.uniform(-0.55, 0.55, 2)
        add_box(cx, cy, 0.16, 0.10, 0.10, 0.0,
                palette[rng.integers(len(palette))])

    light = np.array([0.45, -0.35, 0.82])
    return {
        "box_lo": np.stack([b[0] for b in boxes]),
        "box_hi": np.stack([b[1] for b in boxes]),
        "box_col": np.stack([b[2] for b in boxes]),
        "box_gloss": np.array([b[3] for b in boxes]),
        "sph_c": np.stack([s[0] for s in spheres]),
        "sph_r": np.array([s[1] for s in spheres]),
        "sph_col": np.stack([np.asarray(s[2], np.float64) for s in spheres]),
        "sph_gloss": np.array([s[3] for s in spheres]),
        "light_dir": light / np.linalg.norm(light),
        "ambient": 0.30,
    }


def scene_tensors(scene: dict, device) -> dict:
    """The scene's arrays as float64 tensors on `device` (the ambient term
    stays a float)."""
    return {k: v if np.isscalar(v) else torch.as_tensor(v, dtype=_F64,
                                                         device=device)
            for k, v in scene.items()}


def hit_boxes(o, d, lo, hi):
    """Slab test of rays o, d (R, 3) against boxes lo, hi (B, 3): the
    entry distance (R, B), inf where the ray misses or starts inside, and
    the axis of the entry slab (R, B)."""
    inv = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    tmin = torch.minimum(t0, t1)
    t_near = tmin.amax(dim=2)
    t_far = torch.maximum(t0, t1).amin(dim=2)
    hit = (t_near <= t_far) & (t_far > HIT_EPS) & (t_near > HIT_EPS)
    return torch.where(hit, t_near, torch.inf), tmin.argmax(dim=2)


def hit_spheres(o, d, c, r):
    """Nearest distance past HIT_EPS of rays o, d (R, 3) to spheres c (S,
    3), r (S,): (R, S), inf where the ray misses."""
    oc = o[:, None] - c[None]
    b = (oc * d[:, None]).sum(dim=2)
    disc = b * b - ((oc * oc).sum(dim=2) - r[None] ** 2)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = -b - sq, -b + sq
    t = torch.where(t0 > HIT_EPS, t0,
                    torch.where(t1 > HIT_EPS, t1, torch.inf))
    return torch.where(disc >= 0.0, t, torch.inf)


def trace(sc: dict, o, d):
    """Closest hit of rays o, d (R, 3) in the scene of scene_tensors:
    (t, point, normal, albedo, gloss, hit mask). Ties go to the first
    primitive, boxes before spheres, as numpy's argmin takes them."""
    tb, axis_b = hit_boxes(o, d, sc["box_lo"], sc["box_hi"])
    ts = hit_spheres(o, d, sc["sph_c"], sc["sph_r"])
    tall = torch.cat([tb, ts], dim=1)
    idx = tall.argmin(dim=1)
    t = tall.gather(1, idx[:, None])[:, 0]
    hit = torch.isfinite(t)
    p = o + d * torch.where(hit, t, 0.0)[:, None]

    nb = sc["box_lo"].shape[0]
    is_box = idx < nb
    bi = idx.clamp(max=nb - 1)
    ax = axis_b.gather(1, bi[:, None])
    box_n = torch.zeros_like(p).scatter_(1, ax, -torch.sign(d.gather(1, ax)))
    checker = torch.remainder(torch.floor(p[:, 0] * CHECKER_FREQ)
                              + torch.floor(p[:, 1] * CHECKER_FREQ), 2)
    box_col = sc["box_col"][bi]
    # The base plate (box 0) is checkered.
    box_col = torch.where((bi == 0)[:, None],
                          box_col * (0.65 + 0.45 * checker)[:, None], box_col)
    si = (idx - nb).clamp(min=0)
    sph_n = (p - sc["sph_c"][si]) / sc["sph_r"][si][:, None]
    normal = torch.where(is_box[:, None], box_n, sph_n)
    albedo = torch.where(is_box[:, None], box_col, sc["sph_col"][si])
    gloss = torch.where(is_box, sc["box_gloss"][bi], sc["sph_gloss"][si])
    return t, p, normal, albedo, gloss, hit


def occluded(sc: dict, p):
    """Whether the shadow ray from each point p (R, 3) toward the light
    hits anything."""
    ld = sc["light_dir"]
    o = p + ld * SHADOW_OFFSET
    d = ld.expand_as(o)
    tb, _ = hit_boxes(o, d, sc["box_lo"], sc["box_hi"])
    ts = hit_spheres(o, d, sc["sph_c"], sc["sph_r"])
    return torch.isfinite(torch.cat([tb, ts], dim=1).amin(dim=1))


def render_view(scene: dict, c2w, w: int, h: int, fov_x: float,
                device="cuda", chunk: int = 1 << 18) -> torch.Tensor:
    """(h, w, 4) float32 RGBA image on `device`; c2w is NeRF/OpenGL
    convention (looking along -z, y up). A ray that hits nothing is
    exactly (0, 0, 0, 0); a hit has alpha 1. chunk rays are traced at a
    time (the result does not depend on it)."""
    dev = resolve_device(device)
    sc = scene_tensors(scene, dev)
    focal = 0.5 * w / np.tan(0.5 * fov_x)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=_F64, device=dev) + 0.5,
                            torch.arange(w, dtype=_F64, device=dev) + 0.5,
                            indexing="ij")
    dirs = torch.stack([(xs - w / 2) / focal, -(ys - h / 2) / focal,
                        -torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    c2w = torch.as_tensor(np.asarray(c2w), dtype=_F64, device=dev)
    dirs = dirs @ c2w[:3, :3].T
    dirs = dirs / torch.linalg.norm(dirs, dim=1, keepdim=True)
    origin = c2w[:3, 3].expand_as(dirs)

    out = torch.zeros((dirs.shape[0], 4), dtype=torch.float32, device=dev)
    ld = sc["light_dir"]
    for s in range(0, dirs.shape[0], chunk):
        o, d = origin[s:s + chunk], dirs[s:s + chunk]
        _, p, n, alb, gl, hit = trace(sc, o, d)
        shadow = occluded(sc, p)
        lam = torch.where(shadow, 0.0, torch.clamp((n * ld).sum(dim=1),
                                                   min=0.0))
        # Blinn-Phong specular: the view dependence SH degrees > 0 learn.
        hvec = ld - d
        hvec = hvec / torch.clamp(torch.linalg.norm(hvec, dim=1,
                                                    keepdim=True), min=1e-9)
        spec = torch.clamp((n * hvec).sum(dim=1), min=0.0) ** SPEC_POWER
        spec = torch.where(shadow, 0.0, spec) * gl
        rgb = alb * (sc["ambient"] + DIFFUSE * lam)[:, None] + spec[:, None]
        # A missed ray must be exactly (0, 0, 0, 0): its shading is of an
        # arbitrary primitive, and a grey background under alpha 0 is
        # something a premultiplied splat renderer cannot reproduce.
        rgb = torch.where(hit[:, None], rgb, 0.0)
        out[s:s + chunk, :3] = torch.clamp(rgb, 0.0, 1.0)
        out[s:s + chunk, 3] = hit
    return out.reshape(h, w, 4)


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """A float32 image in [0, 1] as the dataset's uint8 pixels:
    clip(img * 255, 0, 255), truncated (scripts/raytrace_scene.py:
    _png_bytes)."""
    return (img.float() * 255.0).clamp(0.0, 255.0).to(torch.uint8)


def on_white(img: torch.Tensor) -> torch.Tensor:
    """RGB of an RGBA image composited on white, as a photograph is
    (scripts/raytrace_scene.py:write_colmap_zip)."""
    a = img[..., 3:]
    return img[..., :3] * a + (1.0 - a)


def surface_points(scene: dict, n: int, seed: int = 3):
    """n (point, colour) samples on the primitives' surfaces, a stand-in
    for a sparse SfM cloud, with default_rng(seed)'s draws in
    scripts/raytrace_scene.py:_surface_points' order: (n, 3) float64
    points and (n, 3) float64 colours."""
    rng = np.random.default_rng(seed)
    pts, cols = [], []
    nb = len(scene["box_lo"])
    for _ in range(n):
        if rng.random() < 0.75:
            i = rng.integers(nb)
            lo, hi = scene["box_lo"][i], scene["box_hi"][i]
            p = rng.uniform(lo, hi)
            ax = rng.integers(3)
            p[ax] = lo[ax] if rng.random() < 0.5 else hi[ax]
            c = scene["box_col"][i]
        else:
            i = rng.integers(len(scene["sph_r"]))
            v = rng.normal(size=3)
            v /= np.linalg.norm(v)
            p = scene["sph_c"][i] + scene["sph_r"][i] * v
            c = scene["sph_col"][i]
        pts.append(p)
        cols.append(c)
    return np.asarray(pts), np.asarray(cols)


def trace_views(scene: dict, c2ws, size: int, fov_x: float, device,
                white: bool = False) -> list:
    """uint8 images of a size x size camera at each c2w, traced on
    `device` and copied to the host once: RGBA, or with `white` RGB
    composited on white."""
    out = []
    for c2w in c2ws:
        img = render_view(scene, c2w, size, size, fov_x, device=device)
        out.append(quantize_u8(on_white(img) if white else img))
    return list(torch.stack(out).cpu().numpy()) if out else []


def _encode_all(images: list) -> list:
    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(png.encode_png, images))


def write_nerf_scene(path, scene: dict, n_train: int, n_val: int, size: int,
                     fov_x: float = dt.CASTLE_FOV_X, device="cuda") -> dict:
    """A NeRF-synthetic zip of the scene at `path` (scripts/raytrace_
    scene.py:write_nerf_zip's layout: train orbit seed 1, val seed 2,
    size x size RGBA PNGs, transforms_{train,val}.json). Every view is
    traced on `device`, then encoded on the host. Returns the seconds
    {"trace_s", "encode_s"}."""
    c2ws = {"train": dt.orbit_views(n_train, seed=1),
            "val": dt.orbit_views(n_val, seed=2)}
    t0 = time.perf_counter()
    imgs = {s: trace_views(scene, c, size, fov_x, device)
            for s, c in c2ws.items()}
    t1 = time.perf_counter()
    pngs = {s: _encode_all(v) for s, v in imgs.items()}
    dt.write_nerf_zip(path, {s: list(zip(c2ws[s], pngs[s])) for s in c2ws},
                      fov_x=fov_x, encode=lambda b: b)
    return {"trace_s": t1 - t0, "encode_s": time.perf_counter() - t1}


def write_colmap_scene(path, scene: dict, n_views: int, size: int,
                       fov_x: float = dt.CASTLE_FOV_X,
                       n_points: int = COLMAP_POINTS, device="cuda") -> dict:
    """A binary COLMAP zip of the scene at `path` (scripts/raytrace_
    scene.py:write_colmap_zip's layout): one PINHOLE camera, n_views poses
    on the orbit of seed 1, their RGB images composited on white as PNGs
    images/r_i.png (the script writes JPEGs), and n_points surface points
    (seed 3) as points3D. Returns the seconds {"trace_s", "encode_s"}."""
    views = dt.orbit_views(n_views, seed=1)
    t0 = time.perf_counter()
    imgs = trace_views(scene, views, size, fov_x, device, white=True)
    t1 = time.perf_counter()
    pngs = _encode_all(imgs)
    pts, cols = surface_points(scene, n_points)
    colors = np.clip(cols * 255, 0, 255).astype(np.uint8)
    dt.write_colmap_zip(path, list(zip(views, pngs)), size, pts, colors,
                        fov_x=fov_x, encode=lambda b: b)
    return {"trace_s": t1 - t0, "encode_s": time.perf_counter() - t1}
