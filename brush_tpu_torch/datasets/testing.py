"""Dataset writers shared by the tests and chip_smoke.py.

They write the two layouts the loaders read, from posed images the caller
makes: a NeRF-synthetic zip (transforms_{train,val}.json and RGBA PNGs)
and a COLMAP zip (cameras, images and points3D, binary or text, and PNGs).
Cameras come from the orbit of scripts/raytrace_scene.py (orbit_c2w and
_views), the orbit the castle model in docs/ was trained on, and COLMAP
poses are written as its write_colmap_zip writes them. Also PNGs with
chosen row filters, which `png.encode_png` (filter 0 only) does not make.
"""

from __future__ import annotations

import io
import json
import struct
import zipfile

import numpy as np

from brush_tpu_torch.datasets import nerf, png

CASTLE_FOV_X = 0.8575560   # scripts/raytrace_scene.py write_nerf_zip


def orbit_c2w(azimuth, elevation, radius=3.6, target=(0.0, 0.0, 0.35)):
    """NeRF-convention camera-to-world on an orbit, looking at target
    (scripts/raytrace_scene.py:orbit_c2w)."""
    target = np.asarray(target, np.float64)
    pos = target + radius * np.array([
        np.cos(elevation) * np.sin(azimuth),
        np.cos(elevation) * np.cos(azimuth),
        np.sin(elevation),
    ])
    fwd = (pos - target) / np.linalg.norm(pos - target)
    right = np.cross([0.0, 0.0, 1.0], fwd)
    right /= np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = (right, np.cross(fwd, right),
                                              fwd, pos)
    return m


def orbit_views(n: int, seed: int, elev_range=(0.25, 1.0), **orbit):
    """n camera-to-world matrices around the orbit, with the draws of
    scripts/raytrace_scene.py:_views for `seed`."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        az = 2 * np.pi * (i / n) + rng.uniform(0, 0.05)
        el = rng.uniform(*elev_range)
        out.append(orbit_c2w(az, el, **orbit))
    return out


def in_nerf_loader_frame(c2w: np.ndarray) -> np.ndarray:
    """A NeRF camera-to-world moved into the world frame the NeRF loader
    gives its cameras (+90 degrees about X, nerf.camera_from_transform):
    written as a COLMAP pose, it loads as the camera the NeRF loader makes
    of `c2w`, so a model trained on a NeRF scene (the castle) is also the
    point cloud of its COLMAP twin."""
    m = np.eye(4)
    m[:3, :3] = nerf._ROT_X_90
    return m @ np.asarray(c2w, np.float64)


def write_nerf_zip(dest, splits: dict, fov_x: float = CASTLE_FOV_X,
                   prefix: str = "", encode=png.encode_png) -> None:
    """A NeRF-synthetic zip at `dest` (a path or a binary file object).

    splits: {"train": [(c2w 4x4, image), ...], "val": [...]}; each image is
    written to {prefix}{split}/r_{i}.png as encode(image) (a uint8 array by
    default), each split's frames to {prefix}transforms_{split}.json."""
    with zipfile.ZipFile(dest, "w", zipfile.ZIP_STORED) as zf:
        for split, views in splits.items():
            frames = []
            for i, (c2w, img) in enumerate(views):
                name = f"{split}/r_{i}"
                zf.writestr(f"{prefix}{name}.png", encode(img))
                frames.append({"file_path": f"./{name}",
                               "transform_matrix": np.asarray(c2w).tolist()})
            zf.writestr(f"{prefix}transforms_{split}.json",
                        json.dumps({"camera_angle_x": fov_x,
                                    "frames": frames}))


def colmap_qvec(r: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix as scripts/raytrace_scene.py:
    _rotmat_to_qvec computes it."""
    w = np.sqrt(max(0.0, 1.0 + r[0, 0] + r[1, 1] + r[2, 2])) / 2.0
    if w < 1e-8:
        i = int(np.argmax([r[0, 0], r[1, 1], r[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1e-12, 1.0 + r[i, i] - r[j, j] - r[k, k])) * 2.0
        q = np.zeros(4)
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = s / 4.0
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
        return q
    return np.array([w, (r[2, 1] - r[1, 2]) / (4 * w),
                     (r[0, 2] - r[2, 0]) / (4 * w),
                     (r[1, 0] - r[0, 1]) / (4 * w)])


POINT3D_BIN = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                        ("error", "<f8"), ("track", "<u8")])


def write_colmap_zip(dest, views, size, points, colors,
                     fov_x: float = CASTLE_FOV_X, binary: bool = True,
                     prefix: str = "", encode=png.encode_png) -> None:
    """A COLMAP zip at `dest` (a path or a binary file object), every name
    under `prefix`: one PINHOLE camera of `size` x `size` pixels; one image
    per (c2w, image) of `views`, written to images/r_{i}.png as
    encode(image), its world-to-camera pose as
    scripts/raytrace_scene.py:write_colmap_zip writes it; the point cloud
    `points` (n, 3) with uint8 `colors` (n, 3) and empty tracks; the model
    files binary or text."""
    focal = 0.5 * size / np.tan(0.5 * fov_x)
    params = (focal, focal, size / 2, size / 2)
    flip = np.diag([1.0, -1.0, -1.0])
    poses = []
    for c2w, _img in views:
        r_w2c = flip @ np.asarray(c2w)[:3, :3].T
        poses.append((colmap_qvec(r_w2c), -r_w2c @ np.asarray(c2w)[:3, 3]))
    points = np.asarray(points, np.float64)
    colors = np.asarray(colors, np.uint8)
    if binary:
        cams = struct.pack("<QiiQQ", 1, 1, 1, size, size)
        cams += struct.pack("<dddd", *params)
        imgs = struct.pack("<Q", len(poses))
        for i, (q, t) in enumerate(poses):
            imgs += struct.pack("<i4d3di", i + 1, *q, *t, 1)
            imgs += f"r_{i}.png".encode() + b"\x00" + struct.pack("<Q", 0)
        rec = np.zeros(len(points), POINT3D_BIN)
        rec["id"] = np.arange(1, len(points) + 1)
        rec["xyz"], rec["rgb"], rec["error"] = points, colors, 0.5
        p3d = struct.pack("<Q", len(points)) + rec.tobytes()
        ext = "bin"
    else:
        cams = ("# camera\n1 PINHOLE %d %d " % (size, size)
                + " ".join(repr(float(v)) for v in params) + "\n").encode()
        lines = ["# image"]
        for i, (q, t) in enumerate(poses):
            lines.append(" ".join(
                [str(i + 1)] + [repr(float(v)) for v in (*q, *t)]
                + ["1", f"r_{i}.png"]))
            lines.append("")
        imgs = ("\n".join(lines) + "\n").encode()
        p3d = "".join(
            f"{j + 1} {p[0]!r} {p[1]!r} {p[2]!r} {c[0]} {c[1]} {c[2]} 0.5\n"
            for j, (p, c) in enumerate(zip(points.tolist(),
                                           colors.tolist()))).encode()
        ext = "txt"
    with zipfile.ZipFile(dest, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(f"{prefix}sparse/0/cameras.{ext}", cams)
        zf.writestr(f"{prefix}sparse/0/images.{ext}", imgs)
        zf.writestr(f"{prefix}sparse/0/points3D.{ext}", p3d)
        for i, (_c2w, img) in enumerate(views):
            zf.writestr(f"{prefix}images/r_{i}.png", encode(img))


def _residuals(image: np.ndarray) -> np.ndarray:
    """(5, H, W * C) uint8: the image's rows filtered with each PNG filter
    (0 none, 1 Sub, 2 Up, 3 Average, 4 Paeth), against the unfiltered
    image, so this is numpy over whole rows."""
    img = np.asarray(image, np.uint8)
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * bpp).astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    pa, pb = np.abs(up - upleft), np.abs(left - upleft)
    pc = np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    return ((x - pred) & 255).astype(np.uint8)


def filter_rows(image: np.ndarray, kinds, residuals=None) -> bytes:
    """The scanlines of a uint8 (H, W[, C]) image, row r filtered with PNG
    filter kinds[r], each row prefixed by its filter byte."""
    res = _residuals(image) if residuals is None else residuals
    h = res.shape[1]
    kinds = np.asarray(kinds, np.int64)
    rows = np.empty((h, 1 + res.shape[2]), np.uint8)
    rows[:, 0] = kinds
    rows[:, 1:] = res[kinds, np.arange(h)]
    return rows.tobytes()


def adaptive_kinds(image: np.ndarray, residuals=None) -> np.ndarray:
    """Per row, the filter whose output has the least sum of absolute
    values as signed bytes (libpng's adaptive heuristic; ties go to the
    lower filter)."""
    res = _residuals(image) if residuals is None else residuals
    cost = np.abs(res.view(np.int8).astype(np.int32)).sum(axis=2)
    return np.argmin(cost, axis=0)


def filtered_png(image: np.ndarray, kinds=None) -> bytes:
    """An 8-bit PNG of a uint8 (H, W[, 2|3|4]) image (grey, grey + alpha,
    RGB, RGBA) with row filters `kinds` (default: adaptive_kinds)."""
    img = np.asarray(image, np.uint8)
    channels = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    res = _residuals(img)
    if kinds is None:
        kinds = adaptive_kinds(img, res)
    return png.png_bytes(img.shape[1], img.shape[0], ctype,
                         filter_rows(img, kinds, res))
