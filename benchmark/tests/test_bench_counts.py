"""counts/: the contributing-pair count of the reference's renderer
against a brute force, and shares that cannot pass 100 %."""

import math

import numpy as np
import torch

from benchmark import harness
from benchmark.counts import work
from benchmark.reference import splat as ref
from benchmark.scenes import uniform


def scene(n=40, size=40, seed=5):
    g = torch.Generator().manual_seed(seed)
    p = {
        "means": torch.rand((n, 3), generator=g) * 2 - 1,
        "sh_coeffs": torch.randn((n, 16, 3), generator=g) * 0.3,
        "quats": torch.randn((n, 4), generator=g),
        "raw_opacity": torch.randn((n,), generator=g) * 2,
        "log_scales": torch.rand((n, 3), generator=g) * 1.5 - 3.0,
    }
    pose = uniform.ring_poses(1, 3.0, 1.2, (size, size))[0]
    return p, ref.make_cam(pose, (size, size), "cpu")


def brute_force_pairs(p, cam):
    """Per pixel, every splat whose tile bbox holds the pixel's tile, in
    depth order, one at a time: a pair contributes where alpha reaches
    1/255 and the transmittance after it stays above 1e-4."""
    with torch.no_grad():
        s = ref.project(p, cam, torch.ones(p["means"].shape[0], dtype=bool))
    w, h = cam.size
    order = sorted(torch.nonzero(s.visible)[:, 0].tolist(),
                   key=lambda i: (float(s.depth[i]), i))
    pairs = 0
    for y in range(h):
        for x in range(w):
            tx, ty = x // 16, y // 16
            t = 1.0
            for i in order:
                if not (s.tmin[i, 0] <= tx < s.tmax[i, 0]
                        and s.tmin[i, 1] <= ty < s.tmax[i, 1]):
                    continue
                dx = float(s.xy[i, 0]) - (x + 0.5)
                dy = float(s.xy[i, 1]) - (y + 0.5)
                a, b, c = (float(v) for v in s.conic[i])
                sig = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
                if sig < 0:
                    continue
                alpha = min(0.999, float(s.opac[i]) * math.exp(-sig))
                if alpha < 1 / 255:
                    continue
                if t * (1 - alpha) <= 1e-4:
                    break
                t *= 1 - alpha
                pairs += 1
    return pairs


def test_pair_count_matches_brute_force():
    p, cam = scene()
    active = torch.ones(p["means"].shape[0], dtype=bool)
    _, pairs, hits = ref.render_image(p, active, cam, count=True)
    assert pairs == brute_force_pairs(p, cam)
    assert 0 < hits <= pairs


def test_hand_layout_one_splat():
    """One round splat of opacity 1 in the middle of a 32 x 32 frame:
    the pairs are the pixels within sigma <= ln(255), by hand."""
    p = {"means": torch.zeros((1, 3)), "sh_coeffs": torch.zeros((1, 1, 3)),
         "quats": torch.tensor([[1.0, 0, 0, 0]]),
         "raw_opacity": torch.tensor([20.0]),
         "log_scales": torch.full((1, 3), math.log(0.05))}
    pose = {"position": np.array([0.0, 0, -2]),
            "rotation": np.array([1.0, 0, 0, 0]), "fov_x": 1.0, "fov_y": 1.0}
    cam = ref.make_cam(pose, (32, 32), "cpu")
    _, pairs, hits = ref.render_image(p, torch.ones(1, dtype=bool), cam,
                                      count=True)
    with torch.no_grad():
        s = ref.project(p, cam, torch.ones(1, dtype=bool))
    ys, xs = np.mgrid[0:32, 0:32] + 0.5
    dx, dy = float(s.xy[0, 0]) - xs, float(s.xy[0, 1]) - ys
    a, b, c = (float(v) for v in s.conic[0])
    sig = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    inside = (xs // 16 >= int(s.tmin[0, 0])) & (xs // 16 < int(s.tmax[0, 0])) \
        & (ys // 16 >= int(s.tmin[0, 1])) & (ys // 16 < int(s.tmax[0, 1]))
    want = int(((np.minimum(0.999, np.exp(-sig)) >= 1 / 255) & inside).sum())
    assert pairs == want and hits == 4

    # Shares: at the least time a kernel reads 100 %, never more at any
    # longer time; the whole step's least time bounds the rasterizer's.
    fwd = work.raster_fwd(pairs, 1, hits, 32 * 32)
    least = work.least_seconds(*fwd)
    for t, share in ((least, 100.0), (2 * least, 50.0)):
        run = {"kernel_s": {"rasterize_fwd": t},
               "work": {"rasterize_fwd": fwd}}
        assert math.isclose(harness.roofline(run, "rasterize_fwd"), share)
    step = work.train_step(1, 1, 1, pairs, hits, 32 * 32, 3)
    assert work.least_seconds(*step) >= least


def test_least_time_is_the_slower_bound():
    assert work.least_seconds(67e12, 0) == 1.0
    assert work.least_seconds(0, 3.35e12) == 1.0
    ops, nbytes = work.train_step(1000, 16, 900, 5000, 800, 4096, 3)
    assert ops > 0 and nbytes > work.adam(1000, 16)[1]
