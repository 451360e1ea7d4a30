"""The plain reference against the program's CPU path at a tiny size (the
image and every leaf's gradient of one render through the loss, and the
record count), and its truncated log-T scan against a plain loop."""

import pytest
import torch

from benchmark.reference import splat as ref
from benchmark.scenes import uniform
from test_bench_counts import scene

SCAN = (2, 512)


def program_render(p, pose, size):
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.render import render_splats

    cam = Camera(position=pose["position"], rotation=pose["rotation"],
                 fov_x=pose["fov_x"], fov_y=pose["fov_y"])
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    img, aux = render_splats(leaves["means"], leaves["log_scales"],
                             leaves["quats"], leaves["sh_coeffs"],
                             leaves["raw_opacity"],
                             camera_params(cam, size, device="cpu"), size,
                             block_size=512)
    return img, leaves, aux


def test_reference_matches_the_program_on_the_cpu():
    p, _ = scene(n=60, size=48)
    size = (48, 40)
    pose = uniform.ring_poses(1, 3.0, 1.2, (48, 48))[0]   # fov_y 1.2 too
    gt = torch.rand((40, 48, 3), generator=torch.Generator().manual_seed(1))
    img, leaves, aux = program_render(p, pose, size)
    loss = ref.image_loss(img, gt)
    loss.backward()
    cam = ref.make_cam(pose, size, "cpu")
    active = torch.ones(60, dtype=torch.bool)
    want = ref.render_image(p, active, cam, scan=SCAN)
    ref_loss, grads = ref.step_grads(p, active, cam, gt, scan=SCAN)
    # The records carry colour and opacity as u16 (steps 1.2e-4, 1.5e-5).
    assert torch.allclose(img, want, atol=2e-4)
    assert abs(float(loss) - float(ref_loss)) < 1e-5
    for k in ref.LEAVES:
        g, r = leaves[k].grad, grads[k]
        scale = max(float(r.abs().max()), 1e-6)
        assert float((g - r).abs().max()) < 2e-3 * scale, k
    # The tile test keeps the records the program keeps.
    with torch.no_grad():
        rec = ref.records(ref.project(p, cam, active), size)
    assert int(rec.count.sum()) == int(aux.num_isects)


def loop_log_t(lom, first, scan):
    """One pixel's log T after each record, record by record: the batches
    of `lanes` slots from `first` rounded down to 128, the cut terms
    summed inside a batch, the exact sum carried from batch to batch."""
    passes, lanes = scan
    base = first // 128 * 128
    out, carry, exact, cut = [], 0.0, 0.0, 0.0
    for j, term in enumerate(lom.tolist()):
        if j > 0 and (first + j - base) % lanes == 0:
            carry, exact, cut = carry + exact, 0.0, 0.0
        rest = term
        for _ in range(passes):
            part = float(torch.tensor(rest, dtype=torch.float64).to(
                torch.bfloat16))
            rest -= part
            cut += part
        exact += term
        out.append(carry + cut)
    return torch.tensor(out, dtype=torch.float64)


@pytest.mark.parametrize("first", [0, 300, 1000])
def test_truncated_scan_batches(first):
    """log_t_after against a plain loop over 1,400 terms starting at
    slots 0, 300 (its first batch cut at 512) and 1000 (base 896), in
    float64 so that only the cut terms part the scan from the exact sum."""
    g = torch.Generator().manual_seed(first)
    alpha = torch.rand((1, 1, 1400), generator=g, dtype=torch.float64) * 0.05
    lom = torch.log1p(-alpha)
    got = ref.log_t_after(lom, torch.tensor([first]), 1400, SCAN)[0, 0]
    want = loop_log_t(lom[0, 0], first, SCAN)
    assert torch.allclose(got, want, rtol=0, atol=1e-12)
    exact = torch.cumsum(lom[0, 0], 0)
    assert float((got - exact).abs().max()) > 1e-8
    assert torch.equal(ref.log_t_after(lom, torch.tensor([first]), 1400,
                                       (3, 512)), exact[None, None])
