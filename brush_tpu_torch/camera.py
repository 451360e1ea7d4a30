"""Camera model (a numpy copy of brush_tpu/camera.py).

Mirrors the reference camera semantics (reference: brush-render/src/camera.rs):
a position + rotation quaternion + per-axis field of view + principal point
expressed in UV ([0,1]) coordinates. The world-to-view matrix is the inverse
of the rigid local-to-world transform (camera.rs:42-48).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def quat_to_rotmat(quat_wxyz) -> np.ndarray:
    """Rotation matrix from a (w, x, y, z) quaternion.

    Matches helpers.wgsl:74-109 (which stores w in the .x field); returns the
    standard matrix R such that p_rot = R @ p.
    """
    w, x, y, z = (float(v) for v in quat_wxyz)
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return np.array(
        [
            [1.0 - 2.0 * (y2 + z2), 2.0 * (xy - wz), 2.0 * (xz + wy)],
            [2.0 * (xy + wz), 1.0 - 2.0 * (x2 + z2), 2.0 * (yz - wx)],
            [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (x2 + y2)],
        ],
        dtype=np.float64,
    )


def rotmat_to_quat(rot: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternion from a rotation matrix (Shepperd's method)."""
    m = np.asarray(rot, dtype=np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0.0:
        s = np.sqrt(tr + 1.0) * 2.0
        q = np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        )
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        q = np.array(
            [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
        )
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        q = np.array(
            [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
        )
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        q = np.array(
            [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
        )
    return q / np.linalg.norm(q)


def fov_to_focal(fov_rad: float, pixels: int) -> float:
    """Field of view to focal length in pixels (camera.rs:51-53)."""
    return 0.5 * float(pixels) / np.tan(fov_rad * 0.5)


def focal_to_fov(focal: float, pixels: int) -> float:
    """Focal length in pixels to field of view (camera.rs:56-58)."""
    return 2.0 * np.arctan(float(pixels) / (2.0 * focal))


@dataclasses.dataclass
class Camera:
    """A pinhole camera.

    Attributes:
      position: (3,) camera position in world space.
      rotation: (4,) (w, x, y, z) quaternion, camera-to-world rotation.
      fov_x, fov_y: fields of view in radians.
      center_uv: (2,) principal point as a fraction of image size.
    """

    position: np.ndarray
    rotation: np.ndarray
    fov_x: float
    fov_y: float
    center_uv: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.5, 0.5])
    )

    def __post_init__(self):
        self.position = np.asarray(self.position, dtype=np.float64)
        self.rotation = np.asarray(self.rotation, dtype=np.float64)
        self.center_uv = np.asarray(self.center_uv, dtype=np.float64)

    def focal(self, img_size) -> np.ndarray:
        """(fx, fy) focal lengths in pixels; img_size is (w, h)."""
        return np.array(
            [
                fov_to_focal(self.fov_x, int(img_size[0])),
                fov_to_focal(self.fov_y, int(img_size[1])),
            ]
        )

    def center(self, img_size) -> np.ndarray:
        """Principal point (cx, cy) in pixels; img_size is (w, h)."""
        return self.center_uv * np.asarray(img_size, dtype=np.float64)

    def local_to_world(self) -> np.ndarray:
        """4x4 camera-to-world rigid transform (camera.rs:42-44)."""
        m = np.eye(4)
        m[:3, :3] = quat_to_rotmat(self.rotation)
        m[:3, 3] = self.position
        return m

    def world_to_local(self) -> np.ndarray:
        """4x4 world-to-view matrix (camera.rs:46-48).

        For a rigid [R|p] this is [R^T | -R^T p]. Note: the reference reads
        the translation column of this matrix as the "camera position" when
        computing SH view directions (project_visible.wgsl:232); we replicate
        that convention in the renderer for output parity.
        """
        r = quat_to_rotmat(self.rotation)
        m = np.eye(4)
        m[:3, :3] = r.T
        m[:3, 3] = -r.T @ self.position
        return m
