"""Scenes in mid-densification, made on the device from the seed.

The live rows come from scenes/uniform.py's `splats`, the cameras and the
smooth colour fields from its `views`, with the changes that a capture in
the middle of its densification phase shows and a converged one does not:

- clearance: the cameras stand in empty space. A row whose centre lies
  within `clearance` of a ring camera is pushed away from it by
  `clearance` along the line through both, so no splat sits on a lens;
- sizes: each row's three log scales (uniform's, within a factor
  `scale_spread` of `scale`) are shifted together by its own log size,
  uniform over a factor `size_spread` either way, so that both small
  splats (largest scale under the trainer's `densify_size_thresh`, which
  clone) and large ones (which split) are common. A row whose largest
  scale lies within a factor exp(`size_gap`) of that threshold is moved
  out to the edge of that band, so that the two Adam steps before the
  check's refine (at most lr_scale = 0.01 each in log scale) cannot carry
  it across;
- colours: each row is grey, dark or bright (`grey_levels`, half each),
  so that its contrast with the texture below is the same in every
  channel;
- transparent rows: a share `prune_share` of the rows takes an opacity
  uniform over `prune_opacity`, under the trainer's `cull_alpha_thresh`
  by more than two Adam steps move it (lr_opac = 0.05 each in logit), so
  the check's refine prunes them;
- fading rows: a share `fade_share` takes an opacity uniform over
  `fade_opacity`, over the threshold by more than two Adam steps move it,
  so the check's refine keeps them; the window's steps drive the ones the
  views do not need under it, so the window's refine prunes those;
- the ground truth: each view's smooth colour field plus a grey mosaic,
  cells of `texture_px` pixels with a value uniform over
  [-`texture`, `texture`] added to all three channels, clamped to [0, 1]:
  a photograph's fine luminance texture (the bicycle's grass, gravel and
  spokes), without which no splat's screen-space gradient reaches the
  threshold and the window's own refine densifies nothing;
- the resumed statistics: `statistics()` draws the screen-space gradient
  sums and counts the trainer holds at `start_iter`, the refine before
  it `counted_steps` steps back. A row's count is a binomial draw over
  those steps, each seeing the row with the share of the ring's views
  whose frustum holds its centre, at least `min_share` (the capture's
  other views see what the ring misses), times one less `miss_share`;
  its average gradient is log-uniform over `big_grad` times the
  threshold for a share `big_share` of the rows and over `small_grad`
  times it for the rest. The gaps on both sides of the threshold are
  wide enough that the two check steps' own gradients cannot carry an
  average to it, so float32 rounding of those gradients cannot decide
  which rows densify.

Each draw comes from a generator of its own, seeded from the seed, so a
seed gives the same scene on every run. A scene module gives `params`
(the live (n, ...) float32 parameters keyed as the trainer's leaves),
`statistics` (the live rows' gradient sums, float32, and counts, int32)
and `views`, as uniform.py does.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import splat as ref
from benchmark.scenes import uniform


def _generator(seed: int, salt: int, device) -> torch.Generator:
    return uniform.generator(int(seed) * 7919 + salt, device)


def _poses(sc: dict) -> list:
    size = (int(sc["width"]), int(sc["height"]))
    return uniform.ring_poses(sc["views"], sc["distance"],
                              math.radians(sc["fov_x_deg"]), size)


def _logit(o):
    return torch.log(o / (1 - o))


def params(sc: dict, seed: int, device) -> dict:
    n = int(sc["splats"])
    p = uniform.splats(n, seed, device, extent=sc["extent"],
                       scale=sc["scale"], spread=sc["scale_spread"],
                       opacity=tuple(sc["opacity"]),
                       sh_coeffs=(sc["sh_degree"] + 1) ** 2)
    means = p["means"]
    for pose in _poses(sc):
        eye = torch.as_tensor(pose["position"], dtype=torch.float32,
                              device=device)
        off = means - eye
        dist = torch.linalg.vector_norm(off, dim=1, keepdim=True)
        push = sc["clearance"] / dist.clamp(min=1e-6)
        means = torch.where(dist < sc["clearance"], means + off * push, means)
    g = _generator(seed, 1, device)
    u = torch.rand((n, 5), generator=g, device=device)
    size = (2 * u[:, 0] - 1) * math.log(sc["size_spread"])
    log_scales = p["log_scales"] + size[:, None]
    off = log_scales.amax(dim=1) - math.log(sc["size_thresh"])
    gap = sc["size_gap"]
    edge = torch.where(off >= 0, gap, -gap)
    log_scales = log_scales + torch.where(off.abs() < gap, edge - off,
                                          0.0)[:, None]
    dark, bright = sc["grey_levels"]
    grey = torch.where(u[:, 3] < 0.5, dark, bright)
    sh = p["sh_coeffs"]
    sh[:, 0] = ((grey - 0.5) / uniform.SH_C0)[:, None]

    def between(lo_hi, r):
        lo, hi = lo_hi
        return _logit(lo + (hi - lo) * r)

    fade = sc["prune_share"] + sc["fade_share"]
    raw = torch.where(u[:, 1] < sc["prune_share"],
                      between(sc["prune_opacity"], u[:, 2]),
                      torch.where(u[:, 1] < fade,
                                  between(sc["fade_opacity"], u[:, 2]),
                                  p["raw_opacity"]))
    return dict(p, means=means.contiguous(),
                log_scales=log_scales.contiguous(), raw_opacity=raw,
                sh_coeffs=sh)


def views(sc: dict, seed: int, device):
    """(poses, host ground-truth images, frame (w, h)): uniform.py's
    views with the grey mosaic added."""
    poses, gts, size = uniform.views(sc, seed, device)
    w, h = size
    px = int(sc["texture_px"])
    g = _generator(seed, 3, device)
    out = []
    for img in gts:
        cells = torch.rand(((h + px - 1) // px, (w + px - 1) // px),
                           generator=g, device=device)
        cells = (2 * cells - 1) * sc["texture"]
        mosaic = cells.repeat_interleave(px, 0).repeat_interleave(px, 1)
        img = torch.as_tensor(img, device=device) + mosaic[:h, :w, None]
        out.append(img.clamp(0.0, 1.0).cpu().numpy())
    return poses, out, size


def view_share(means: torch.Tensor, sc: dict) -> torch.Tensor:
    """(n,) the share of the ring's views whose frustum holds each centre
    (in front of the near plane, inside the field of view)."""
    poses = _poses(sc)
    seen = torch.zeros(means.shape[0], device=means.device)
    for pose in poses:
        # Camera-to-world rotation: its columns are the camera's axes.
        rot = torch.as_tensor(ref.rotmat_np(pose["rotation"]),
                              dtype=torch.float32, device=means.device)
        pv = (means - torch.as_tensor(pose["position"], dtype=torch.float32,
                                      device=means.device)) @ rot
        z_ = pv[:, 2]
        seen += ((z_ > 0.01)
                 & (pv[:, 0].abs() <= z_ * math.tan(0.5 * pose["fov_x"]))
                 & (pv[:, 1].abs() <= z_ * math.tan(0.5 * pose["fov_y"])))
    return seen / len(poses)


def statistics(sc: dict, seed: int, means: torch.Tensor):
    """(grad_2d_accum, xy_grad_counts) of the live rows at `means`."""
    n, device = means.shape[0], means.device
    share = view_share(means, sc).clamp(min=sc["min_share"])
    g = _generator(seed, 2, device)
    steps = float(sc["counted_steps"])
    counts = torch.binomial(torch.full((n,), steps, device=device),
                            share * (1.0 - sc["miss_share"]),
                            generator=g).to(torch.int32)
    u = torch.rand((n, 2), generator=g, device=device)

    def log_uniform(lo, hi, r):
        return math.log(lo) + (math.log(hi) - math.log(lo)) * r

    big = u[:, 0] < sc["big_share"]
    rel = torch.where(big, log_uniform(*sc["big_grad"], u[:, 1]),
                      log_uniform(*sc["small_grad"], u[:, 1])).exp()
    avg = sc["grad_thresh"] * rel
    return avg * counts.to(torch.float32), counts
