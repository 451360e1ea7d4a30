"""Rerun visual-debugging streams (port of brush_tpu/utils/rerun_viz.py;
reference: brush-viewer/src/panels/rerun.rs).

Four streams, each an optional stream behind the rerun SDK (when the import
fails every method is a no-op), under the JAX package's entity paths and
with its SDK calls:

- the splat cloud with SH-DC colours and opacity (rerun.rs:54-121);
- the dataset cameras as pinhole frusta and their images (rerun.rs:123-161);
- eval renders and each view's PSNR (rerun.rs:163-196);
- per-tile intersection-count and mean-depth heatmaps (rerun.rs:198-229).

Scalars (losses, LRs, counts) go through MetricsLogger; this module carries
the visual streams. Arrays reach the SDK as numpy, computed on the host in
the JAX package's float32 arithmetic. Tests inject a stub `rerun` module.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from brush_tpu_torch.constants import SH_C0, TILE_WIDTH


def _try_import_rerun():
    try:
        import rerun  # noqa: F401 — optional, injected as a stub in tests

        return sys.modules["rerun"]
    except Exception:
        return None


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class RerunVisualizer:
    """Streams splats / cameras / renders / heatmaps to rerun when available.

    Every method is safe to call unconditionally; with no SDK this is a
    no-op shell (mirrors VisualizeTools' optional recording stream).
    """

    def __init__(self, app_id: str = "brush_tpu_torch"):
        self.rr = _try_import_rerun()
        if self.rr is not None:
            try:
                self.rr.init(app_id, spawn=False)
            except Exception:
                self.rr = None

    @property
    def active(self) -> bool:
        return self.rr is not None

    def _time(self, step: int) -> None:
        try:
            self.rr.set_time_sequence("step", step)
        except Exception:
            pass

    # ---- splat cloud (rerun.rs:54-121) ---- #

    def log_splats(self, step: int, splats, max_points: int = 200_000) -> None:
        if not self.active:
            return
        self._time(step)
        n = int(splats.n_live)
        rows = slice(0, n)
        if n > max_points:
            rows = torch.from_numpy(
                np.linspace(0, n - 1, max_points).astype(np.int64)
            ).to(splats.device)
        means = _host(splats.means[rows])
        # SH DC -> rgb (the reference logs base color), sigmoid opacity as A.
        dc = _host(splats.sh_coeffs[rows, 0, :])
        rgb = np.clip(dc * SH_C0 + 0.5, 0.0, 1.0)
        opac = 1.0 / (1.0 + np.exp(-_host(splats.raw_opacity[rows])))
        colors = np.concatenate([rgb, opac[:, None]], axis=1)
        radii = np.exp(_host(splats.log_scales[rows])).mean(axis=1)
        self.rr.log(
            "world/splats",
            self.rr.Points3D(means, colors=colors, radii=radii),
        )

    # ---- dataset cameras (rerun.rs:123-161) ---- #

    def log_dataset(self, scene, max_views: int = 32) -> None:
        if not self.active:
            return
        from brush_tpu_torch.camera import quat_to_rotmat

        for i, view in enumerate(scene.views[:max_views]):
            cam = view.camera
            h, w = view.image.shape[:2]
            base = f"world/dataset/{i}"
            self.rr.log(
                base,
                self.rr.Transform3D(
                    translation=np.asarray(cam.position, np.float32),
                    mat3x3=quat_to_rotmat(np.asarray(cam.rotation)),
                ),
            )
            self.rr.log(
                f"{base}/image",
                self.rr.Pinhole(
                    focal_length=float(w / (2.0 * np.tan(cam.fov_x / 2.0))),
                    width=w, height=h,
                ),
            )
            self.rr.log(
                f"{base}/image",
                self.rr.Image((view.image[..., :3] * 255).astype(np.uint8)),
            )

    # ---- eval renders (rerun.rs:163-196) ---- #

    def log_eval(self, step: int, idx: int, rendered, gt, psnr: float) -> None:
        if not self.active:
            return
        self._time(step)
        base = f"eval/view_{idx}"
        self.rr.log(f"{base}/render",
                    self.rr.Image((np.clip(_host(rendered)[..., :3], 0, 1)
                                   * 255).astype(np.uint8)))
        self.rr.log(f"{base}/gt",
                    self.rr.Image((np.clip(_host(gt)[..., :3], 0, 1)
                                   * 255).astype(np.uint8)))
        try:
            self.rr.log(f"{base}/psnr", self.rr.Scalar(float(psnr)))
        except Exception:
            pass

    # ---- tile heatmaps (rerun.rs:198-229) ---- #

    def log_tile_heatmaps(self, step: int, splats, camera, img_size,
                          max_isects: int = 1 << 20) -> None:
        """Per-tile intersection counts and mean depth as (tiles_y,
        tiles_x) images, recomputed through the XLA backend's binning
        (ops/binning.build_intersections, unaligned, the pool exactly
        max_isects) at debug cadence, as brush_tpu/utils/rerun_viz.py:
        144-183 does; the mean depth is a float32 cumsum difference on the
        host, in the same order. The reference reads tile_bins and
        final_index back from its RenderAux instead.
        """
        if not self.active:
            return
        from brush_tpu_torch.ops.binning import build_intersections
        from brush_tpu_torch.ops.rasterize_reference import camera_params
        from brush_tpu_torch.render import detached, project_inputs

        self._time(step)
        tiles_x = -(-int(img_size[0]) // TILE_WIDTH)
        tiles_y = -(-int(img_size[1]) // TILE_WIDTH)
        with torch.no_grad():
            cp = camera_params(camera, img_size, device=splats.device)
            proj, _, opac, _ = project_inputs(
                splats.means, splats.log_scales, splats.quats,
                splats.sh_coeffs, splats.raw_opacity, cp, img_size,
                active=splats.active_mask())
            isect = build_intersections(detached(proj), opac,
                                        (tiles_x, tiles_y), max_isects)
            depth_c = _host(proj.depth[isect.order])
            gid = _host(isect.isect_gid)
            starts = _host(isect.starts)
            ends = _host(isect.ends)
        counts = (ends - starts).reshape(tiles_y, tiles_x)
        # Mean depth of each tile's splats: the records of tile t are
        # [starts[t], ends[t]) in tile order.
        num = int(isect.num_isects)
        cum = np.concatenate([[0.0], np.cumsum(
            depth_c[np.clip(gid[:num], 0, len(depth_c) - 1)]
        )])
        s = np.clip(starts, 0, num)
        e = np.clip(ends, 0, num)
        with np.errstate(invalid="ignore"):
            depth_tiles = np.where(
                e > s, (cum[e] - cum[s]) / np.maximum(e - s, 1), 0.0
            ).reshape(tiles_y, tiles_x)
        self.rr.log("debug/tile_isect_counts",
                    self.rr.DepthImage(counts.astype(np.float32)))
        self.rr.log("debug/tile_mean_depth",
                    self.rr.DepthImage(depth_tiles.astype(np.float32)))
