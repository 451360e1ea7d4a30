"""The projection's backward twin (ops/projection.project_bwd_plain, the
plain version of csrc/projection.cu's backward) against autograd through
normalize_quats + project_splats, on the hand-made cases of
ops/cuda/testing.hand_projection; and the CPU's path, which launches
nothing.

In float64 the twin is autograd's chain rule to rounding. In float32 it
sums in its own order, so it is held to float64 autograd instead: per
gradient, its largest error over the largest entry at most twice float32
autograd's plus 4 float32 ulps.
"""

import numpy as np
import pytest
import torch

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.constants import NEAR_PLANE_Z
from brush_tpu_torch.ops.cuda import build
from brush_tpu_torch.ops.cuda.testing import (
    HAND_PROJECTION_CASES, hand_projection,
)
from brush_tpu_torch.ops.projection import (
    normalize_quats, project_bwd_plain, project_splats, quat_norm_plain,
)
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.render import project_inputs
from torch_threads import pin_threads

pin_threads()

LEAVES = ("means", "log_scales", "quats")
ULP = 2.0 ** -23


def case_tensors(case, dtype=torch.float32):
    """hand_projection(case) as CPU tensors, floats in dtype."""
    a = hand_projection(case)
    t = {k: torch.tensor(v).to(dtype) for k, v in a.items()
         if k not in ("active", "img_size", "special")}
    t["active"] = (None if a["active"] is None
                   else torch.tensor(a["active"]))
    return t, a["img_size"], a["special"]


def forward(t, img_size, leaves):
    return project_splats(leaves[0], leaves[1], normalize_quats(leaves[2]),
                          t["viewmat"], t["focal"], t["pixel_center"],
                          img_size, active=t["active"])


def autograd_grads(case, dtype):
    """(means, log_scales, quats) gradients by autograd through
    normalize_quats + project_splats in dtype."""
    t, img_size, _ = case_tensors(case, dtype)
    leaves = [t[k].clone().requires_grad_(True) for k in LEAVES]
    p = forward(t, img_size, leaves)
    torch.autograd.backward([p.xy, p.conic], [t["g_xy"], t["g_conic"]])
    return [x.grad for x in leaves]


def twin_grads(case, dtype):
    t, img_size, _ = case_tensors(case, dtype)
    return project_bwd_plain(t["means"], t["log_scales"], t["quats"],
                             t["viewmat"], t["focal"], t["pixel_center"],
                             img_size, t["g_xy"], t["g_conic"], t["active"])


@pytest.mark.parametrize("case", HAND_PROJECTION_CASES)
def test_hand_projection_reaches_its_case(case):
    """Each case's hand-made rows are what it says, in float32 on the
    CPU's plain path."""
    t, img_size, sp = case_tensors(case)
    p = forward(t, img_size, [t[k] for k in LEAVES])
    depth, vis = p.depth[sp], p.visible[sp]
    front = depth > NEAR_PLANE_Z
    if case == "thin":
        assert bool(vis.all())
        assert bool((t["log_scales"][sp, 1:] == -12.0).all())
    elif case == "behind":
        assert int((~front).sum()) >= 40 and int(front.sum()) >= 4
        near = depth[:8]
        assert int((near <= NEAR_PLANE_Z).sum()) == 4
        assert bool(((near - NEAR_PLANE_Z).abs() <= 0.0101).all())
    elif case == "det_zero":
        # In front, inside the frame, and culled: by det == 0 alone.
        assert bool(front.all()) and not bool(vis.any())
        c = p.xy[sp]
        assert bool(((c >= 0) & (c <= 64)).all())
    elif case == "inactive":
        act = t["active"]
        assert 60 <= int((~act).sum()) <= 140
        assert not bool(p.visible[~act].any())
    elif case == "off_frame":
        lim = 1.3 * 0.5 * torch.tensor([64.0, 48.0]) / t["focal"]
        v = torch.stack([t["viewmat"][i, :3] @ t["means"][sp].T
                         + t["viewmat"][i, 3] for i in range(3)], dim=-1)
        beyond = (v[:, :2] / v[:, 2:3]).abs() > lim
        assert int(beyond.any(1).sum()) >= 20
        assert int(((~vis) & front).sum()) >= 20
    elif case == "quat_norms":
        norm = quat_norm_plain(t["quats"][sp])
        assert int((norm < 1e-12).sum()) >= 6 and int((norm == 0).sum()) >= 6
        assert float(norm.max()) > 1e5
    elif case == "culled_xy":
        assert not bool(vis.any())
        assert int((~front).sum()) >= 20 and int((~t["active"]).sum()) >= 20
        assert float(t["g_xy"][sp].abs().max()) > 100.0


@pytest.mark.parametrize("case", HAND_PROJECTION_CASES)
def test_project_bwd_plain_is_autograds_chain_rule(case):
    """In float64 the twin's gradients are autograd's to rounding (relative
    1e-9 of each gradient's largest entry), rows culled by autograd's
    masks included. det_zero's hand-made rows are left out: their 2D det
    cancels 16 digits in float64 too (the float32 test holds them)."""
    rows = slice(None)
    if case == "det_zero":
        rows = slice(hand_projection(case)["special"].size, None)
    for want, got in zip(autograd_grads(case, torch.float64),
                         twin_grads(case, torch.float64)):
        want, got = want[rows], got[rows]
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= 1e-9 * scale


@pytest.mark.parametrize("case", HAND_PROJECTION_CASES)
def test_project_bwd_plain_as_accurate_as_autograd(case):
    """In float32, against float64 autograd: per gradient, the twin's
    largest error over the largest entry is at most twice float32
    autograd's plus 4 ulps; its gradients are finite where autograd's
    are, and zero on the rows autograd's masks zero."""
    ref = autograd_grads(case, torch.float64)
    auto = autograd_grads(case, torch.float32)
    twin = twin_grads(case, torch.float32)
    for name, r, a, w in zip(LEAVES, ref, auto, twin):
        scale = float(r.abs().max())
        err_a = float((a.double() - r).abs().max()) / scale
        err_t = float((w.double() - r).abs().max()) / scale
        assert err_t <= 2.0 * err_a + 4.0 * ULP, (name, err_t, err_a)
        assert bool((torch.isfinite(w) | ~torch.isfinite(a)).all()), name
        assert bool((w[a == 0] == 0).all()) or name == "means", name


def test_quat_norm_plain_within_an_ulp_of_vector_norm():
    """quat_norm_plain sums the squares in the order of the card's
    vector_norm; the CPU's may take another, an ulp apart at most."""
    q = torch.tensor(np.random.default_rng(5).normal(size=(4096, 4)),
                     dtype=torch.float32)
    got = quat_norm_plain(q)
    want = torch.linalg.vector_norm(q, dim=-1)
    assert float(((got - want).abs() / want).max()) <= ULP


def test_project_inputs_on_cpu_launches_nothing():
    """CPU tensors take the plain projection under autograd: no kernel is
    launched forward or backward, and the gradients are autograd's."""
    t, img_size, _ = case_tensors("inactive")
    n = t["means"].shape[0]
    cam = camera_params(Camera(position=[0.3, -0.2, -6.0],
                               rotation=[1.0, 0.0, 0.0, 0.0], fov_x=1.4,
                               fov_y=1.2), img_size, device="cpu")
    leaves = [t[k].clone().requires_grad_(True) for k in LEAVES]
    coeffs = torch.zeros((n, 4, 3))
    before = build.launch_counts()
    proj, _, _, xy = project_inputs(*leaves, coeffs, torch.zeros(n), cam,
                                    img_size, active=t["active"])
    torch.autograd.backward([xy, proj.conic], [t["g_xy"], t["g_conic"]])
    assert build.launch_counts() == before
    want = project_splats(*[x.detach().clone().requires_grad_(True)
                            for x in leaves[:2]],
                          normalize_quats(leaves[2].detach()), cam.viewmat,
                          cam.focal, cam.pixel_center, img_size,
                          active=t["active"])
    assert torch.equal(proj.conic.detach(), want.conic.detach())
    assert all(x.grad is not None and bool(torch.isfinite(x.grad).all())
               for x in leaves)
