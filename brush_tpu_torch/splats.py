"""Gaussian splat parameter model (port of brush_tpu/splats.py).

Same fields and padding as the reference: tensors are allocated at a
padded *capacity* C with an explicit live count, padding entries are inert
(opacity sigmoid(-12), scale exp(-10), identity rotation) and masked out
of every pipeline stage via `active_mask`. The live count is a Python int:
PyTorch runs eagerly, so nothing needs it as a device scalar.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from brush_tpu_torch import native
from brush_tpu_torch.constants import SH_C0, sh_coeffs_for_degree
from brush_tpu_torch.device import resolve_device


def inverse_sigmoid(x: float) -> float:
    """(gaussian_splats.rs:36-38)."""
    return float(np.log(x / (1.0 - x)))


# Raw opacity assigned to padding slots: sigmoid(-12) ~ 6e-6, far below the
# 1/255 contribution threshold even before masking.
PADDING_RAW_OPACITY = -12.0


def round_up_capacity(n: int, minimum: int = 256) -> int:
    """Bucket a live count into a capacity: next power of two (>= minimum)."""
    cap = max(int(minimum), 1)
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass
class Splats:
    """Padded splat parameters (capacity C, first n_live entries are real).

    means: (C, 3); sh_coeffs: (C, K, 3); quats: (C, 4) wxyz;
    raw_opacity: (C,); log_scales: (C, 3); all float32 on one device.
    """

    means: torch.Tensor
    sh_coeffs: torch.Tensor
    quats: torch.Tensor
    raw_opacity: torch.Tensor
    log_scales: torch.Tensor
    n_live: int

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def sh_count(self) -> int:
        return self.sh_coeffs.shape[1]

    @property
    def device(self) -> torch.device:
        return self.means.device

    def active_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.n_live

    def num_splats(self) -> int:
        return self.n_live

    def params(self) -> dict:
        """The trainable leaves (everything except n_live)."""
        return {
            "means": self.means,
            "sh_coeffs": self.sh_coeffs,
            "quats": self.quats,
            "raw_opacity": self.raw_opacity,
            "log_scales": self.log_scales,
        }

    def replace(self, **kw) -> "Splats":
        return dataclasses.replace(self, **kw)

    def with_params(self, params: dict) -> "Splats":
        return dataclasses.replace(self, **params)

    def opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.raw_opacity)

    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)


def _pad_to_capacity(arrs: dict, n: int, capacity: int) -> dict:
    def pad(x, fill):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        out[:n] = x
        return out

    quats = pad(arrs["quats"], 0.0)
    quats[n:, 0] = 1.0
    return {
        "means": pad(arrs["means"], 0.0),
        "sh_coeffs": pad(arrs["sh_coeffs"], 0.0),
        "quats": quats,
        "raw_opacity": pad(arrs["raw_opacity"], PADDING_RAW_OPACITY),
        "log_scales": pad(arrs["log_scales"], -10.0),
    }


def from_dense(means, sh_coeffs, quats, raw_opacity, log_scales,
               capacity: int | None = None, device="cuda") -> Splats:
    """Build padded Splats from dense (n, ...) arrays or tensors."""
    dev = resolve_device(device)
    n = means.shape[0]
    cap = capacity if capacity is not None else round_up_capacity(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < live count {n}")
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    arrs = {
        "means": f32(means),
        "sh_coeffs": f32(sh_coeffs),
        "quats": f32(quats),
        "raw_opacity": f32(raw_opacity),
        "log_scales": f32(log_scales),
    }
    return Splats(n_live=int(n), **_pad_to_capacity(arrs, n, cap))


def from_safetensors(path_or_file, capacity: int | None = None,
                     device="cuda") -> Splats:
    """Load a splat model from a safetensors file.

    Mirrors the reference's test-data loader (gaussian_splats.rs:208-223):
    tensors `means` (n,3), `scales` = log scales (n,3), `coeffs` (n,c,3),
    `quats` (n,4) wxyz, `opacities` = raw pre-sigmoid (n,). The
    `safetensors` package is imported here, at the call: a host without it
    runs everything else.
    """
    from safetensors import safe_open

    with safe_open(path_or_file, framework="np") as f:
        t = {k: f.get_tensor(k) for k in f.keys()}
    return from_dense(
        t["means"], t["coeffs"], t["quats"], t["opacities"], t["scales"],
        capacity=capacity, device=device,
    )


def knn_mean_distance(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """sqrt(sum of the k nearest squared distances) / k, self included.

    Reference: gaussian_splats.rs:108-120 (a KD-tree query that counts the
    point itself among its k neighbours). Runs on the tensor's device as a
    chunked brute force: each chunk of rows gets its squared distances to
    every point summed from per-axis differences (the |a|^2 + |b|^2 - 2a.b
    form cancels to noise for near neighbours far from the origin), then
    `topk` takes the k smallest.
    """
    n = points.shape[0]
    k = max(1, min(k, n))
    p = points.to(torch.float32)
    budget = (1 << 28) if p.is_cuda else (1 << 22)   # d2 elements per chunk
    chunk = max(1, min(n, budget // max(n, 1)))
    out = torch.empty(n, dtype=torch.float32, device=p.device)
    cols = p.T.contiguous()
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        d2 = (p[s:e, 0, None] - cols[0]).square_()
        for c in (1, 2):
            d2 += (p[s:e, c, None] - cols[c]).square_()
        best = torch.topk(d2, k, dim=1, largest=False).values
        out[s:e] = torch.sqrt(best.sum(dim=1)) / k
    return out


@functools.cache
def knn_route() -> str:
    """Who computes the initial scales' k-NN, chosen once a process by
    what builds: "native" (native.knn_distances, the KD-tree, O(n log n))
    where g++ builds the native library, else "device"
    (knn_mean_distance, the brute force on the points' device, O(n^2)).
    Both are exact and agree to float32 rounding."""
    return "native" if native.available() else "device"


def knn_extents(positions: np.ndarray, device, k: int = 3) -> torch.Tensor:
    """The k-NN extents (knn_mean_distance's function, k clamped to
    [1, n]) of float32 points (n, 3) on `device`, by knn_route()."""
    k = max(1, min(k, positions.shape[0]))
    if knn_route() == "native":
        return torch.as_tensor(native.knn_distances(positions, k),
                               device=device)
    return knn_mean_distance(torch.as_tensor(positions, device=device), k)


def from_point_cloud(positions, colors, sh_degree: int,
                     capacity: int | None = None, device="cuda") -> Splats:
    """Init from a point cloud (reference: gaussian_splats.rs:71-136).

    DC SH = (rgb - 0.5) / SH_C0, higher orders zero; rotation identity;
    opacity sigmoid^-1(0.1); isotropic log-scale from 3-NN mean distance
    (knn_extents).
    """
    dev = resolve_device(device)
    positions = np.asarray(positions, np.float32)
    pos = torch.as_tensor(positions, device=dev)
    n = pos.shape[0]
    sh = torch.zeros((n, sh_coeffs_for_degree(sh_degree), 3),
                     dtype=torch.float32, device=dev)
    col = torch.as_tensor(np.asarray(colors, np.float32), device=dev)
    sh[:, 0, :] = (col - 0.5) / SH_C0
    quats = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    quats[:, 0] = 1.0
    raw_opac = torch.full((n,), inverse_sigmoid(0.1), dtype=torch.float32,
                          device=dev)
    extents = knn_extents(positions, dev, 3)
    log_scales = torch.log(torch.clamp(extents, min=1e-7))[:, None]
    return from_dense(pos, sh, quats, raw_opac, log_scales.repeat(1, 3),
                      capacity, device=dev)


def from_random(rng: np.random.Generator, bounds_min, bounds_max,
                count: int = 10000, sh_degree: int = 0,
                capacity: int | None = None, device="cuda") -> Splats:
    """Random-in-bbox init (reference: gaussian_splats.rs:41-69).

    Makes the same numpy draws as brush_tpu.splats.from_random, so one
    seed gives both packages the same positions and colours.
    """
    lo = np.asarray(bounds_min, np.float32)
    hi = np.asarray(bounds_max, np.float32)
    positions = rng.uniform(lo, hi, size=(count, 3)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, size=(count, 3)).astype(np.float32)
    return from_point_cloud(positions, colors, sh_degree, capacity,
                            device=device)

