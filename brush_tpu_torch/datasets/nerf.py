"""NeRF-synthetic (transforms_*.json) parsing (a numpy copy of
brush_tpu/datasets/nerf.py).

Mirrors reference/brush-dataset/src/formats/nerf_synthetic.rs, including the
exact basis change (nerf_synthetic.rs:56-66): the camera-to-world matrix has
its Y and Z axes negated (OpenGL -> OpenCV-style) and is then premultiplied
by a +90deg rotation about X to land in the renderer's right-handed, y-down
world frame.
"""

from __future__ import annotations

import json

import numpy as np

from brush_tpu_torch.camera import Camera, focal_to_fov, fov_to_focal, rotmat_to_quat

_ROT_X_90 = np.array(
    [
        [1.0, 0.0, 0.0],
        [0.0, 0.0, -1.0],
        [0.0, 1.0, 0.0],
    ]
)


def camera_from_transform(transform: np.ndarray, fov_x: float, img_w: int, img_h: int) -> Camera:
    """Camera from a NeRF c2w `transform_matrix` (nerf_synthetic.rs:55-88)."""
    m = np.asarray(transform, dtype=np.float64).copy()
    m[:, 1] *= -1.0  # y axis
    m[:, 2] *= -1.0  # z axis
    rot = _ROT_X_90 @ m[:3, :3]
    pos = _ROT_X_90 @ m[:3, 3]
    fov_y = focal_to_fov(fov_to_focal(fov_x, img_w), img_h)
    return Camera(
        position=pos,
        rotation=rotmat_to_quat(rot),
        fov_x=fov_x,
        fov_y=fov_y,
        center_uv=np.array([0.5, 0.5]),
    )


def parse_transforms(data: bytes):
    """Returns (camera_angle_x, [(file_path, transform 4x4), ...])."""
    scene = json.loads(data.decode("utf-8"))
    fov_x = float(scene["camera_angle_x"])
    frames = [
        (frame["file_path"], np.asarray(frame["transform_matrix"], np.float64))
        for frame in scene["frames"]
    ]
    return fov_x, frames
