"""Uniform random scenes, made on the device from the seed.

After scripts/torch_probe_5m.py's make_scene (commit 89934ad9): n splats
uniform in [-extent, extent]^3, the DC term of their SH from a uniform
colour and the higher orders zero; cameras at a distance on a ring about
the origin. Where the probe gives every splat the identity rotation, one
isotropic scale and opacity 0.1, each splat here has its own, as a
trained capture has them: a rotation uniform over the unit quaternions,
three log scales uniform over [log(scale / spread), log(scale * spread)]
and an opacity uniform over the configuration's range. One
torch.Generator on the card draws all of it in a few large calls, so a
seed gives the same splats on every run.

The ground truth: `views` cameras on a ring at the configuration's
distance, looking at the origin, each with its own smooth colour field
drawn from the seed (a grey base plus 32 gaussian blobs of random
colour, centre and width), so every pixel has a residual and the loss
and every gradient are real; a black image would only push the
opacities down.

A scene module gives `params(scene, seed, device)`, the (n, ...) float32
parameters keyed as the trainer's leaves, and `views(scene, seed,
device)`, the cameras, the ground-truth images and the frame (w, h);
drivers/train.py finds it by the configuration's scene `kind`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.2820947917738781


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def splats(n: int, seed: int, device, extent: float = 4.0,
           scale: float = 0.01, spread: float = 2.0,
           opacity=(0.05, 0.25), sh_coeffs: int = 16) -> dict:
    """The (n, ...) float32 parameters, keyed as the trainer's leaves."""
    g = generator(seed, device)
    u = torch.rand((n, 10), generator=g, device=device)
    means = (u[:, :3] * (2 * extent) - extent).contiguous()
    sh = torch.zeros((n, sh_coeffs, 3), device=device)
    sh[:, 0] = (u[:, 3:6] - 0.5) / SH_C0
    log_scales = (math.log(scale)
                  + (2 * u[:, 6:9] - 1) * math.log(spread)).contiguous()
    lo, hi = opacity
    o = lo + (hi - lo) * u[:, 9]
    quats = torch.randn((n, 4), generator=g, device=device)
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    return {"means": means, "sh_coeffs": sh, "quats": quats,
            "raw_opacity": torch.log(o / (1 - o)), "log_scales": log_scales}


def ring_poses(views: int, distance: float, fov_x: float, size) -> list:
    """Cameras at angles 2 pi i / views on a ring about the y axis,
    looking at the origin, square pixels over the frame size (w, h)."""
    w, h = size
    fov_y = 2 * math.atan(math.tan(0.5 * fov_x) * h / w)
    out = []
    for i in range(views):
        th = 2 * math.pi * i / views
        out.append({"position": np.array([distance * math.sin(th), 0.0,
                                          -distance * math.cos(th)]),
                    "rotation": np.array([math.cos(th / 2), 0.0,
                                          -math.sin(th / 2), 0.0]),
                    "fov_x": fov_x, "fov_y": fov_y})
    return out


def colour_field(size, seed: int, view: int, device,
                 blobs: int = 32) -> np.ndarray:
    """(h, w, 3) float32 host image in [0, 1] for one view."""
    w, h = size
    g = generator(seed * 1009 + view + 1, device)
    p = torch.rand((blobs, 7), generator=g, device=device)
    ax = (torch.arange(w, device=device) + 0.5) / w
    ay = (torch.arange(h, device=device) + 0.5) / w
    yy, xx = torch.meshgrid(ay, ax, indexing="ij")
    img = torch.full((h, w, 3), 0.35, device=device)
    for cx, cy, wd, r, gr, b, amp in p.tolist():
        width = 0.03 + 0.25 * wd
        blob = torch.exp(-((xx - cx) ** 2 + (yy - cy * h / w) ** 2)
                         / (2 * width * width))
        img += (amp - 0.5) * blob[..., None] * torch.tensor(
            [r, gr, b], device=device)
    return img.clamp(0.0, 1.0).cpu().numpy()


def params(sc: dict, seed: int, device) -> dict:
    return splats(sc["splats"], seed, device, extent=sc["extent"],
                  scale=sc["scale"], spread=sc["scale_spread"],
                  opacity=tuple(sc["opacity"]),
                  sh_coeffs=(sc["sh_degree"] + 1) ** 2)


def views(sc: dict, seed: int, device):
    """(poses, host ground-truth images, frame (w, h))."""
    size = (int(sc["width"]), int(sc["height"]))
    poses = ring_poses(sc["views"], sc["distance"],
                       math.radians(sc["fov_x_deg"]), size)
    gts = [colour_field(size, seed, v, device) for v in range(sc["views"])]
    return poses, gts, size
