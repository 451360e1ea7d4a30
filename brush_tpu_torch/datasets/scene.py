"""Scene containers (a numpy copy of brush_tpu/datasets/scene.py;
reference: brush-train/src/scene.rs)."""

from __future__ import annotations

import dataclasses

import numpy as np

from brush_tpu_torch.camera import Camera, quat_to_rotmat


@dataclasses.dataclass
class SceneView:
    """One posed image. `image` is (H, W, 3|4) float32 in [0, 1]."""

    name: str
    camera: Camera
    image: np.ndarray


@dataclasses.dataclass
class Scene:
    """A multi-view scene (scene.rs:20-25)."""

    views: list

    def bounds(self, cam_near: float = 0.0, cam_far: float = 0.0):
        """Bounding box of camera positions +near/far probes (scene.rs:42-56).

        For each view two points are taken: position + rot*Z*near and
        position + rot*Z*far. Returns (center, half_extent).
        """
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for view in self.views:
            cam = view.camera
            z = quat_to_rotmat(cam.rotation) @ np.array([0.0, 0.0, 1.0])
            for d in (cam_near, cam_far):
                p = cam.position + z * d
                lo = np.minimum(lo, p)
                hi = np.maximum(hi, p)
        center = (hi + lo) / 2.0
        extent = (hi - lo) / 2.0
        return center, extent

    def extent_max(self) -> float:
        """Scene extent used to scale the mean LR (scene_loader.rs:22)."""
        _, extent = self.bounds(0.0, 0.0)
        return float(np.max(extent))


@dataclasses.dataclass
class Dataset:
    """Train + optional eval split (brush-dataset/src/lib.rs:31-55)."""

    train: Scene
    eval: Scene | None = None

    @staticmethod
    def from_views(train_views: list, eval_views: list) -> "Dataset":
        return Dataset(
            train=Scene(train_views),
            eval=Scene(eval_views) if eval_views else None,
        )


def has_alpha(img) -> bool:
    """Whether a PIL image carries alpha: an alpha band or a `tRNS`
    transparency (brush-train/src/image.rs:8-18)."""
    return img.mode in ("RGBA", "LA", "PA") or "transparency" in getattr(
        img, "info", {})


def image_to_array(img) -> np.ndarray:
    """PIL image -> float32 [0,1] array, RGBA iff the source has alpha
    (reference: brush-train/src/image.rs:8-18)."""
    img = img.convert("RGBA" if has_alpha(img) else "RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def clamp_img_to_max_size(img, max_size: int):
    """Aspect-preserving downscale of a PIL image
    (brush-dataset/src/lib.rs:57-69)."""
    from PIL import Image

    w, h = img.size
    if w <= max_size and h <= max_size:
        return img
    aspect = w / h
    if w > h:
        new_w, new_h = max_size, int(max_size / aspect)
    else:
        new_w, new_h = int(max_size * aspect), max_size
    return img.resize((new_w, new_h), Image.LANCZOS)
