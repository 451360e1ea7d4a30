"""COLMAP sparse-model parser: cameras / images / points3D, binary and text
(a numpy copy of brush_tpu/datasets/colmap.py).

Python port of the standalone reference parser (reference:
colmap-reader/src/lib.rs), same 11 camera models and the same
focal / principal-point parameter index tables (lib.rs:88-134).
A C++ fast path for points3D.bin lives in brush_tpu_torch/native.
"""

from __future__ import annotations

import dataclasses
import io
import struct

import numpy as np

# model_id -> (name, num_params, focal_y_idx, pp_x_idx, pp_y_idx).
# focal x is always params[0] (lib.rs:88-107).
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3, 0, 1, 2),
    1: ("PINHOLE", 4, 1, 2, 3),
    2: ("SIMPLE_RADIAL", 4, 0, 1, 2),
    3: ("RADIAL", 5, 0, 1, 2),
    4: ("OPENCV", 8, 1, 2, 3),
    5: ("OPENCV_FISHEYE", 8, 1, 2, 3),
    6: ("FULL_OPENCV", 12, 1, 2, 3),
    7: ("FOV", 5, 1, 2, 3),
    8: ("SIMPLE_RADIAL_FISHEYE", 4, 0, 1, 2),
    9: ("RADIAL_FISHEYE", 5, 0, 1, 2),
    10: ("THIN_PRISM_FISHEYE", 12, 1, 2, 3),
}
MODEL_IDS = {name: mid for mid, (name, *_rest) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model_id: int
    width: int
    height: int
    params: np.ndarray

    def focal(self) -> tuple[float, float]:
        _, _, fy_idx, _, _ = CAMERA_MODELS[self.model_id]
        return float(self.params[0]), float(self.params[fy_idx])

    def principal_point(self) -> tuple[float, float]:
        _, _, _, px_idx, py_idx = CAMERA_MODELS[self.model_id]
        return float(self.params[px_idx]), float(self.params[py_idx])


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray   # (4,) (w, x, y, z), world-to-camera rotation
    tvec: np.ndarray   # (3,) world-to-camera translation
    camera_id: int
    name: str


@dataclasses.dataclass
class ColmapPoint3D:
    xyz: np.ndarray
    rgb: np.ndarray


def _native():
    """The native points3D parser, or None when it cannot be built (no
    compiler): the Python parser then reads the file."""
    from brush_tpu_torch import native

    return native if native.available() else None


def read_cameras(data: bytes, binary: bool) -> dict[int, ColmapCamera]:
    if binary:
        return _read_cameras_bin(data)
    return _read_cameras_text(data)


def read_images(data: bytes, binary: bool) -> dict[int, ColmapImage]:
    if binary:
        return _read_images_bin(data)
    return _read_images_text(data)


def read_points3d(data: bytes, binary: bool) -> tuple[np.ndarray, np.ndarray]:
    """Returns (positions (N,3) f32, colors (N,3) f32 in [0,1])."""
    nat = _native()
    if binary and nat is not None:
        return nat.read_points3d_bin(data)
    if binary:
        return _read_points3d_bin(data)
    return _read_points3d_text(data)


# --------------------------- binary readers --------------------------- #

def _read_cameras_bin(data: bytes) -> dict[int, ColmapCamera]:
    f = io.BytesIO(data)
    (num,) = struct.unpack("<Q", f.read(8))
    cams = {}
    for _ in range(num):
        cam_id, model_id = struct.unpack("<ii", f.read(8))
        width, height = struct.unpack("<QQ", f.read(16))
        if model_id not in CAMERA_MODELS:
            raise ValueError(f"Invalid camera model id {model_id}")
        n_params = CAMERA_MODELS[model_id][1]
        params = np.frombuffer(f.read(8 * n_params), dtype="<f8")
        cams[cam_id] = ColmapCamera(cam_id, model_id, width, height, params)
    return cams


def _read_images_bin(data: bytes) -> dict[int, ColmapImage]:
    f = io.BytesIO(data)
    (num,) = struct.unpack("<Q", f.read(8))
    images = {}
    for _ in range(num):
        (img_id,) = struct.unpack("<i", f.read(4))
        qvec = np.frombuffer(f.read(32), dtype="<f8")  # (w, x, y, z)
        tvec = np.frombuffer(f.read(24), dtype="<f8")
        (camera_id,) = struct.unpack("<i", f.read(4))
        name_bytes = bytearray()
        while True:
            c = f.read(1)
            if c == b"\x00" or c == b"":
                break
            name_bytes += c
        (num_points,) = struct.unpack("<Q", f.read(8))
        f.seek(num_points * 24, 1)  # skip (x, y, point3d_id) tracks
        images[img_id] = ColmapImage(
            id=img_id, qvec=qvec.copy(), tvec=tvec.copy(),
            camera_id=camera_id, name=name_bytes.decode("utf-8"),
        )
    return images


def _read_points3d_bin(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    f = io.BytesIO(data)
    (num,) = struct.unpack("<Q", f.read(8))
    positions = np.empty((num, 3), np.float32)
    colors = np.empty((num, 3), np.float32)
    for i in range(num):
        f.seek(8, 1)  # point id
        positions[i] = np.frombuffer(f.read(24), dtype="<f8")
        colors[i] = np.frombuffer(f.read(3), dtype=np.uint8)
        f.seek(8, 1)  # reprojection error
        (track_len,) = struct.unpack("<Q", f.read(8))
        f.seek(track_len * 8, 1)
    colors /= 255.0
    return positions, colors


# ---------------------------- text readers ---------------------------- #

def _data_lines(data: bytes):
    for line in data.decode("utf-8").splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            yield line


def _read_cameras_text(data: bytes) -> dict[int, ColmapCamera]:
    cams = {}
    for line in _data_lines(data):
        parts = line.split()
        cam_id = int(parts[0])
        model_id = MODEL_IDS[parts[1]]
        width, height = int(parts[2]), int(parts[3])
        params = np.array([float(p) for p in parts[4:]], np.float64)
        if len(params) != CAMERA_MODELS[model_id][1]:
            raise ValueError("Invalid number of camera parameters")
        cams[cam_id] = ColmapCamera(cam_id, model_id, width, height, params)
    return cams


def _read_images_text(data: bytes) -> dict[int, ColmapImage]:
    images = {}
    # Two lines per image: pose line, then the 2D-point track line. The
    # track line is EMPTY for images with zero observations (a real COLMAP
    # output), so blank lines must be kept for the pairing to hold —
    # _data_lines (which drops them) would shift every later image onto a
    # track line and corrupt or crash the parse. Only comments are
    # filtered; a trailing blank line (file ends with a newline) is fine
    # because pose lines sit at even indices.
    lines = [
        ln.strip() for ln in data.decode("utf-8").splitlines()
        if not ln.lstrip().startswith("#")
    ]
    while lines and not lines[-1]:
        lines.pop()
    for pose_line in lines[0::2]:
        parts = pose_line.split()
        img_id = int(parts[0])
        qvec = np.array([float(v) for v in parts[1:5]])
        tvec = np.array([float(v) for v in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        images[img_id] = ColmapImage(
            id=img_id, qvec=qvec, tvec=tvec, camera_id=camera_id, name=name
        )
    return images


def _read_points3d_text(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    positions, colors = [], []
    for line in _data_lines(data):
        parts = line.split()
        positions.append([float(v) for v in parts[1:4]])
        colors.append([float(v) / 255.0 for v in parts[4:7]])
    return (
        np.asarray(positions, np.float32).reshape(-1, 3),
        np.asarray(colors, np.float32).reshape(-1, 3),
    )
