"""The port's inference render against brush_tpu.render.render_splats.

Scenes come from the JAX package's own from_random (numpy seeds) and are
carried into the port with convert.splats_from_numpy, so both sides render
the same leaves. The port runs on CPU tensors, i.e. through the plain
versions of its CUDA kernels.
"""

import numpy as np
import pytest
import torch

from conftest import assert_close_quantized

from brush_tpu.camera import Camera as JCamera
from brush_tpu.ops.rasterize_reference import camera_params as j_cp
from brush_tpu.render import pack_rgba_u32 as j_pack_rgba
from brush_tpu.render import render_splats as j_render
from brush_tpu.splats import from_random as j_from_random

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.convert import splats_from_numpy
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.render import default_max_isects, pack_rgba_u32
from brush_tpu_torch.render import render_splats
from torch_threads import pin_threads

pin_threads()

CAM = dict(position=[0, 0, -6.0], rotation=[1, 0, 0, 0], fov_x=np.pi / 2,
           fov_y=np.pi / 2)


def both(n, img_size, backend, seed=0, max_isects=None, block_size=64):
    js = j_from_random(np.random.default_rng(seed), [-2] * 3, [2] * 3,
                       count=n, sh_degree=1)
    img_j, aux_j = j_render(
        js.means, js.log_scales, js.quats, js.sh_coeffs, js.raw_opacity,
        j_cp(JCamera(**CAM), img_size), img_size, active=js.active_mask(),
        block_size=block_size, backend=backend, needs_grad=False,
        scan_passes=3, max_isects=max_isects)
    ts = splats_from_numpy({k: np.asarray(v) for k, v in js.params().items()},
                           int(js.n_live), device="cpu")
    img_t, aux_t = render_splats(
        ts.means, ts.log_scales, ts.quats, ts.sh_coeffs, ts.raw_opacity,
        camera_params(Camera(**CAM), img_size, device="cpu"), img_size,
        active=ts.active_mask(), block_size=block_size, needs_grad=False,
        max_isects=max_isects)
    return (np.asarray(img_j), aux_j), (img_t.numpy(), aux_t)


def _aux_equal(aux_j, aux_t):
    for f in ("num_visible", "num_isects", "num_dropped"):
        assert int(getattr(aux_j, f)) == int(getattr(aux_t, f)), f
    np.testing.assert_array_equal(np.asarray(aux_j.visible),
                                  aux_t.visible.numpy())
    np.testing.assert_array_equal(np.asarray(aux_j.producing),
                                  aux_t.producing.numpy())


def test_render_matches_pallas_pipeline():
    """512 splats at 64x48 against the record pipeline in interpret mode:
    same quantization, so only float32 rounding and rare threshold flips
    separate the two."""
    (img_j, aux_j), (img_t, aux_t) = both(512, (64, 48), "pallas")
    assert img_t.shape == (48, 64, 4)
    assert_close_quantized(img_t, img_j, atol=1e-5, err_msg="vs pallas")
    _aux_equal(aux_j, aux_t)


def test_render_entry_scene_matches_xla():
    """The __graft_entry__ scene (16384 splats, 256x256, block_size 64)
    against the reference's unquantized XLA path: the u16 colour/opacity
    quantization bound plus counted flips (assert_close_quantized
    defaults)."""
    (img_j, aux_j), (img_t, aux_t) = both(16384, (256, 256), "xla")
    assert np.isfinite(img_t).all()
    assert_close_quantized(img_t, img_j, err_msg="entry scene vs xla")
    _aux_equal(aux_j, aux_t)


def test_render_pool_overflow_counts_drops_like_reference():
    (img_j, aux_j), (img_t, aux_t) = both(512, (64, 48), "pallas",
                                          max_isects=300)
    assert int(aux_t.num_dropped) > 0
    _aux_equal(aux_j, aux_t)
    assert_close_quantized(img_t, img_j, atol=1e-5, err_msg="overflow")


def test_default_max_isects_matches_reference():
    from brush_tpu.render import default_max_isects as j_default

    for n, size in [(1, (16, 16)), (32, (640, 480)), (16384, (256, 256)),
                    (1 << 20, (1024, 1024)), (3 << 20, (4096, 4096))]:
        assert default_max_isects(n, size) == j_default(n, size)


def test_pack_rgba_u32_matches_reference():
    img = np.random.default_rng(0).uniform(-0.2, 1.2, (5, 7, 4)).astype(
        np.float32)
    got = pack_rgba_u32(torch.tensor(img)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(j_pack_rgba(img)))


def _scene():
    from brush_tpu_torch.splats import from_random

    ts = from_random(np.random.default_rng(0), [-2] * 3, [2] * 3, count=64,
                     device="cpu")
    return ts, camera_params(Camera(**CAM), (32, 32), device="cpu")


def test_render_refuses_gradients_and_cells():
    """Cells other than (1, 1) render, with and without gradients, the
    image of the tile path (within tests/test_torch_cells.py's SELF_ATOL)
    and fewer records; a cell that is no pair of positive ints raises; the
    inference pipeline refuses inputs that require grad; the default
    differentiable render lets a gradient flow to every parameter."""
    ts, cp = _scene()
    args = (ts.means, ts.log_scales, ts.quats, ts.sh_coeffs, ts.raw_opacity,
            cp, (32, 32))
    img_1, aux_1 = render_splats(*args, needs_grad=False)
    for needs_grad in (True, False):
        img, aux = render_splats(*args, cell=(2, 2), needs_grad=needs_grad)
        assert_close_quantized(img.detach().numpy(), img_1.numpy(),
                               atol=1e-6, flip_tol=0.05, err_msg="cell")
        assert 0 < int(aux.num_isects) < int(aux_1.num_isects)
    for bad in ((0, 1), (2, -1)):
        with pytest.raises(ValueError, match="cell"):
            render_splats(*args, cell=bad)
    means = ts.means.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="inference-only"):
        render_splats(means, *args[1:], needs_grad=False)
    params = [a.clone().requires_grad_(True) for a in args[:5]]
    img, aux = render_splats(*params, cp, (32, 32))
    assert int(aux.num_isects) > 0
    (img ** 2).sum().backward()
    for p in params:
        assert p.grad is not None and torch.isfinite(p.grad).all()
    # from_random makes isotropic splats, whose covariance no rotation
    # changes: the quaternions' gradient is zero, the rest is not.
    for p in params[:2] + params[3:]:
        assert p.grad.abs().max() > 0


def test_render_backend_arguments(monkeypatch):
    """backend selects the path, on CPU and CUDA tensors alike. "pallas"
    and "auto" run the record pipeline through the kernel wrappers (here
    their plain versions) and give the same bits, with gradients too;
    bwd_tiles_per_step changes nothing; the default is scan_passes=2, as
    in the reference, and differs from the exact scan_passes=3. "xla"
    runs the XLA backend (exact binning and the tiled rasterizer): float32
    colours and opacities where the pipeline's are u16, so its image is
    within the quantization bound of the pipeline's but not equal to it.
    Neither path
    falls back to the other: each gives the same bits with the other's
    entry point made to raise. An unknown backend raises."""
    import brush_tpu_torch.render as render_mod
    from brush_tpu_torch.ops import rasterize_tiled

    ts, cp = _scene()
    args = (ts.means, ts.log_scales, ts.quats, ts.sh_coeffs, ts.raw_opacity,
            cp, (32, 32))

    def grads(**kw):
        params = [a.clone().requires_grad_(True) for a in args[:5]]
        img, _ = render_splats(*params, *args[5:], **kw)
        (img ** 2).sum().backward()
        return [img.detach()] + [p.grad for p in params]

    def raises(*a, **kw):
        raise AssertionError("the other backend's path ran")

    want = grads()
    for kw in (dict(backend="pallas"), dict(backend="auto", scan_passes=2),
               dict(backend="pallas", bwd_tiles_per_step=4)):
        for a, b in zip(grads(**kw), want):
            assert torch.equal(a, b), kw
    exact = grads(scan_passes=3)
    assert not all(torch.equal(a, b) for a, b in zip(exact, want))
    xla = grads(backend="xla")
    assert not torch.equal(xla[0], want[0])
    assert_close_quantized(xla[0].numpy(), want[0].numpy(),
                           err_msg="xla against the record pipeline")
    with monkeypatch.context() as m:
        m.setattr(render_mod.RecordPipeline, "apply", raises)
        m.setattr(render_mod, "infer_pipeline", raises)
        for a, b in zip(grads(backend="xla", bwd_tiles_per_step=4), xla):
            assert torch.equal(a, b)
    with monkeypatch.context() as m:
        m.setattr(rasterize_tiled, "make_rasterizer", raises)
        for a, b in zip(grads(backend="auto"), want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="backend"):
        render_splats(*args, backend="mosaic")


def test_render_empty_and_behind_camera_is_finite():
    ts, cp = _scene()
    means = ts.means + torch.tensor([0.0, 0.0, -20.0])
    img, aux = render_splats(means, ts.log_scales, ts.quats, ts.sh_coeffs,
                             ts.raw_opacity, cp, (32, 32), needs_grad=False)
    assert torch.all(img == 0) and int(aux.num_visible) == 0
    assert int(aux.num_isects) == 0
