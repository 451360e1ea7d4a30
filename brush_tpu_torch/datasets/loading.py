"""Dataset loading from zip archives or directories, with format detection
(port of brush_tpu/datasets/loading.py).

Mirrors reference/brush-dataset/src/formats/mod.rs:16-27 (try nerf-synthetic
first, fall back to COLMAP) and zip.rs's base-path discovery (a dataset may
live under an arbitrary prefix inside the archive). Directories are also
supported (the reference notes it only requires zips for wasm file-picker
reasons, zip.rs:1-5).

Image decoding runs on a thread pool (reference decodes views on parallel
threads, lib.rs:99-124). 8-bit PNGs decode with the port's own codec
(datasets/png.py), so a host without Pillow reads NeRF-synthetic scenes;
every other image, and every image that `max_resolution` resizes, goes to
Pillow, as in the reference. Where the native library cannot be built
(no g++) but Pillow imports, 8-bit PNGs go to Pillow too: its C decoder
beats the codec's numpy unfilter ~100x (`png_route`). Which decoder runs
is set by what is installed, the file's header and the arguments, never
by a retry after a failure.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import os
import posixpath
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from brush_tpu_torch import native
from brush_tpu_torch.camera import (
    Camera, focal_to_fov, quat_to_rotmat, rotmat_to_quat,
)
from brush_tpu_torch.datasets import colmap as colmap_mod
from brush_tpu_torch.datasets import nerf as nerf_mod
from brush_tpu_torch.datasets import png
from brush_tpu_torch.datasets.scene import (
    Dataset,
    Scene,
    SceneView,
    clamp_img_to_max_size,
    image_to_array,
)


@dataclasses.dataclass
class LoadDatasetArgs:
    """(reference: brush-dataset/src/lib.rs:20-24)."""

    max_frames: int | None = None
    max_resolution: int | None = None
    eval_split_every: int | None = None
    # Replicate the reference's literal NeRF split (see _nerf_split).
    faithful_nerf_split: bool = False


class FileSource:
    """Uniform view over a zip archive, a directory, or raw zip bytes."""

    def __init__(self, source):
        if isinstance(source, (bytes, bytearray)):
            self._zip = zipfile.ZipFile(io.BytesIO(bytes(source)))
            self._names = [n for n in self._zip.namelist() if not n.endswith("/")]
            self._dir = None
        elif os.path.isdir(source):
            self._zip = None
            self._dir = str(source)
            self._names = []
            for root, _dirs, files in os.walk(self._dir):
                for fn in files:
                    rel = os.path.relpath(os.path.join(root, fn), self._dir)
                    self._names.append(rel.replace(os.sep, "/"))
        else:
            self._zip = zipfile.ZipFile(source)
            self._names = [n for n in self._zip.namelist() if not n.endswith("/")]
            self._dir = None

    def names(self) -> list[str]:
        return self._names

    def read(self, path: str) -> bytes:
        if self._zip is not None:
            return self._zip.read(path)
        with open(os.path.join(self._dir, path), "rb") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        return path in self._names

    def find_base_path(self, search_path: str) -> str | None:
        """Prefix under which `search_path` lives (zip.rs:83-93)."""
        for name in self._names:
            norm = posixpath.normpath(name)
            if norm == search_path or norm.endswith("/" + search_path):
                return norm[: -len(search_path)].rstrip("/")
        return None


def _image_format(img_bytes: bytes, header) -> str:
    """A name for an image's format, for the error without Pillow."""
    if header is not None:
        return (f"PNG ({header.bit_depth}-bit, colour type "
                f"{header.color_type}, interlace {header.interlace})")
    for magic, name in ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"),
                        (b"BM", "BMP"), (b"RIFF", "WebP"),
                        (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF")):
        if img_bytes.startswith(magic):
            return name
    return f"unknown (first bytes {img_bytes[:8]!r})"


@functools.cache
def png_route() -> str:
    """Who decodes an 8-bit PNG that needs no resize, chosen once a process
    by what is installed: "native" (png.decode_png, the rows unfiltered by
    the native library) where it builds; else "pillow" where Pillow
    imports; else "numpy" (png.decode_png with its numpy unfilter). The
    three give the same bytes; "numpy" is the slow one (101.68 s for 116
    adaptively filtered 800x800 views in 8 threads, where the other two
    take about a second)."""
    if native.available():
        return "native"
    try:
        from PIL import Image  # noqa: F401
    except ImportError:
        return "numpy"
    return "pillow"


def _decode_image(img_bytes: bytes, max_resolution: int | None) -> np.ndarray:
    """(H, W, 3|4) float32 in [0, 1], RGBA iff the image has alpha.

    An 8-bit PNG that needs no resize is read by png.decode_png, whose
    arrays are byte-equal to Pillow's, unless png_route() is "pillow"; the
    rest is read by Pillow as in the reference
    (brush_tpu/datasets/loading.py:89-95)."""
    header = png.read_header(img_bytes)
    if png.decodable(header) and png_route() != "pillow" and (
            max_resolution is None
            or max(header.width, header.height) <= max_resolution):
        return png.decode_png(img_bytes).astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError as e:
        need = ("an image resized by max_resolution" if png.decodable(header)
                else f"a {_image_format(img_bytes, header)} image")
        raise ImportError(f"decoding {need} needs Pillow, which is not "
                          "installed") from e
    img = Image.open(io.BytesIO(img_bytes))
    if max_resolution is not None:
        img = clamp_img_to_max_size(img, max_resolution)
    return image_to_array(img)


def _join(base: str, rel: str) -> str:
    return posixpath.normpath(posixpath.join(base, rel) if base else rel)


# ----------------------------- NeRF synthetic ----------------------------- #

def _nerf_view_loader(src: FileSource, base: str, name: str,
                      args: LoadDatasetArgs):
    """(load_fn, frames) for one transforms file, or None if absent."""
    path = _join(base, name)
    if not src.exists(path):
        return None
    fov_x, frames = nerf_mod.parse_transforms(src.read(path))
    if args.max_frames is not None:
        frames = frames[: args.max_frames]

    def load(frame):
        file_path, transform = frame
        img_path = _join(base, file_path + ".png")
        img = _decode_image(src.read(img_path), args.max_resolution)
        h, w = img.shape[:2]
        cam = nerf_mod.camera_from_transform(transform, fov_x, w, h)
        return SceneView(name=img_path, camera=cam, image=img)

    return load, frames


def _load_nerf_views(src: FileSource, base: str, name: str, args: LoadDatasetArgs):
    lf = _nerf_view_loader(src, base, name, args)
    if lf is None:
        return None
    load, frames = lf
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 8) as pool:
        return list(pool.map(load, frames))


def _nerf_split(train_all, val_views, args: LoadDatasetArgs) -> Dataset:
    """Reference bug, fixed by default: nerf_synthetic.rs:118-126 carves
    every Nth TRAIN view into eval only when a val split ALSO exists — the
    opposite of its own comment ("Include extra eval images only when the
    dataset doesn't have them") and of what eval needs. Under the literal
    behavior a dataset WITHOUT transforms_val.json gets no eval views at
    all (metrics silently never run), while one WITH a val split loses
    every Nth training view into an eval set it already has. Default:
    follow the comment's intent — carve exactly when val is missing;
    LoadDatasetArgs.faithful_nerf_split=True restores the literal
    reference behavior (for byte-level parity runs)."""
    train_views, eval_views = [], []
    for i, view in enumerate(train_all):
        if args.faithful_nerf_split:
            carve = val_views is not None
        else:
            carve = val_views is None
        if (
            args.eval_split_every is not None
            and i % args.eval_split_every == 0
            and carve
        ):
            eval_views.append(view)
        else:
            train_views.append(view)
    if val_views:
        eval_views.extend(val_views)
    return Dataset.from_views(train_views, eval_views)


def load_nerf_synthetic(src: FileSource, args: LoadDatasetArgs) -> Dataset:
    base = src.find_base_path("transforms_train.json")
    if base is None:
        raise FileNotFoundError("No transforms file found")
    train_all = _load_nerf_views(src, base, "transforms_train.json", args)
    val_views = _load_nerf_views(src, base, "transforms_val.json", args)
    return _nerf_split(train_all, val_views, args)


# -------------------------------- COLMAP --------------------------------- #

def _find_colmap(src: FileSource):
    base = src.find_base_path("sparse/0/cameras.bin")
    if base is not None:
        return True, base
    base = src.find_base_path("sparse/0/cameras.txt")
    if base is not None:
        return False, base
    raise FileNotFoundError("No COLMAP data found (either text or binary)")


def _colmap_view_loader(src: FileSource, args: LoadDatasetArgs):
    """(load_fn, infos) over the sorted COLMAP image registry."""
    is_binary, base = _find_colmap(src)
    ext = "bin" if is_binary else "txt"
    cams = colmap_mod.read_cameras(
        src.read(_join(base, f"sparse/0/cameras.{ext}")), is_binary
    )
    imgs = colmap_mod.read_images(
        src.read(_join(base, f"sparse/0/images.{ext}")), is_binary
    )

    # Sorted by image id for consistency (formats/colmap.rs:57-61).
    infos = sorted(imgs.values(), key=lambda im: im.id)
    if args.max_frames is not None:
        infos = infos[: args.max_frames]

    def load(info):
        cam_data = cams[info.camera_id]
        fx, fy = cam_data.focal()
        fov_x = focal_to_fov(fx, int(cam_data.width))
        fov_y = focal_to_fov(fy, int(cam_data.height))
        cx, cy = cam_data.principal_point()
        center_uv = np.array([cx / cam_data.width, cy / cam_data.height])

        img_path = _join(base, f"images/{info.name}")
        img = _decode_image(src.read(img_path), args.max_resolution)

        # COLMAP stores world-to-camera; invert (formats/colmap.rs:92-96).
        r_wc = colmap_quat_to_rotmat(info.qvec)
        position = -r_wc.T @ info.tvec
        rotation = rotmat_to_quat(r_wc.T)
        cam = Camera(
            position=position, rotation=rotation,
            fov_x=fov_x, fov_y=fov_y, center_uv=center_uv,
        )
        return SceneView(name=img_path, camera=cam, image=img)

    return load, infos


def _colmap_split(views, args: LoadDatasetArgs) -> Dataset:
    train_views, eval_views = [], []
    for i, view in enumerate(views):
        if args.eval_split_every is not None and i % args.eval_split_every == 0:
            eval_views.append(view)
        else:
            train_views.append(view)
    return Dataset.from_views(train_views, eval_views)


def load_colmap(src: FileSource, args: LoadDatasetArgs) -> Dataset:
    load, infos = _colmap_view_loader(src, args)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 8) as pool:
        views = list(pool.map(load, infos))
    return _colmap_split(views, args)


def colmap_quat_to_rotmat(qvec) -> np.ndarray:
    q = np.asarray(qvec, np.float64)
    q = q / np.linalg.norm(q)
    return quat_to_rotmat(q)


def load_colmap_points(src: FileSource):
    """Initial point cloud (formats/colmap.rs:140-180)."""
    is_binary, base = _find_colmap(src)
    ext = "bin" if is_binary else "txt"
    path = _join(base, f"sparse/0/points3D.{ext}")
    return colmap_mod.read_points3d(src.read(path), is_binary)


# ------------------------------ entry points ------------------------------ #

def load_dataset(source, args: LoadDatasetArgs | None = None) -> Dataset:
    """Try nerf-synthetic, fall back to COLMAP (formats/mod.rs:16-27)."""
    args = args or LoadDatasetArgs()
    src = source if isinstance(source, FileSource) else FileSource(source)
    # Fall back to COLMAP only when there is no transforms file AT ALL: a
    # FileNotFoundError raised mid-load (a missing/misnamed image on a
    # directory source) must propagate — swallowing it would surface as
    # "No COLMAP data found", pointing at entirely the wrong problem.
    if src.find_base_path("transforms_train.json") is not None:
        return load_nerf_synthetic(src, args)
    return load_colmap(src, args)


def load_dataset_stream(source, args: LoadDatasetArgs | None = None,
                        every: int = 4):
    """Progressive loading: yields a growing Dataset as views decode.

    The reference streams progressively-growing Dataset messages to the
    viewer while images decode in parallel threads (formats/mod.rs:16,
    stream_fut_parallel lib.rs:99-124): consumers (the live viewer) can
    start training on a partial scene. Every view lands on its FINAL split
    side from the first yield (a future eval view is never exposed as
    train); the final yield equals load_dataset(...).
    """
    args = args or LoadDatasetArgs()
    src = source if isinstance(source, FileSource) else FileSource(source)

    fmt = "nerf"
    base = src.find_base_path("transforms_train.json")
    if base is not None:
        lf = _nerf_view_loader(src, base, "transforms_train.json", args)
        load, items = lf
        # The carve rule needs val-split existence up front so streamed
        # views land on their FINAL side — an eval view must never be
        # trained on during the progressive phase.
        has_val = (
            _nerf_view_loader(src, base, "transforms_val.json", args)
            is not None
        )
        carve = (has_val if args.faithful_nerf_split else not has_val)
    else:
        fmt = "colmap"
        load, items = _colmap_view_loader(src, args)
        carve = True

    def is_eval(i):
        return (args.eval_split_every is not None
                and i % args.eval_split_every == 0 and carve)

    views = []          # final-split train views
    stream_eval = []    # final-split eval views, in arrival order
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 8) as pool:
        for i, view in enumerate(pool.map(load, items)):
            (stream_eval if is_eval(i) else views).append(view)
            done = i + 1
            if done % every == 0 and done < len(items):
                yield Dataset(
                    train=Scene(views=list(views)),
                    eval=Scene(views=list(stream_eval)) if stream_eval else None,
                )

    if fmt == "nerf":
        val_views = _load_nerf_views(src, base, "transforms_val.json", args)
        if val_views:
            stream_eval.extend(val_views)
    yield Dataset.from_views(views, stream_eval)


def load_initial_splats(source, sh_degree: int = 3,
                        capacity: int | None = None, device="cuda"):
    """init.ply > COLMAP points3D > None (formats/mod.rs:38-60), as Splats
    on `device`."""
    from brush_tpu_torch.datasets.ply import load_splats_from_ply
    from brush_tpu_torch.splats import from_point_cloud

    src = source if isinstance(source, FileSource) else FileSource(source)
    # Same base-path discovery as every other lookup: init.ply usually
    # sits under the archive's single top-level folder, not at the root.
    ply_base = src.find_base_path("init.ply")
    if ply_base is not None:
        return load_splats_from_ply(
            src.read(_join(ply_base, "init.ply")), capacity=capacity,
            device=device,
        )
    try:
        positions, colors = load_colmap_points(src)
    except FileNotFoundError:
        return None
    return from_point_cloud(positions, colors, sh_degree, capacity=capacity,
                            device=device)
