"""The port's differentiable render against jax.grad through
brush_tpu.render.render_splats(backend="pallas") in interpret mode.

Both sides render the same numpy-seeded scene (100 splats, SH degree 1,
64x48) with a seeded image cotangent; the port runs on CPU tensors, i.e.
through the plain versions of its four kernels. Gradients of all five
parameters and of xy_dummy are compared after scaling each by its largest
reference value, with the rule of tests/test_pipeline.py:76-87: the bulk
within 3e-4, a counted few threshold flips beyond it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close_quantized

from brush_tpu.camera import Camera as JCamera
from brush_tpu.ops.rasterize_reference import camera_params as j_cp
from brush_tpu.render import render_splats as j_render

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.render import render_splats
from test_torch_cuda import CAM, make_scene
from torch_threads import pin_threads

pin_threads()

NAMES = ["means", "log_scales", "quats", "sh_coeffs", "raw_opacity"]
SIZE = (64, 48)

# (scene size, seed, pool, pack_grad_sort, bulk tolerance, flip bound)
CASES = {
    # Exact float32 cotangents through the grad re-sort.
    "f32": (100, 3, None, False, 3e-4, 0.05),
    # The reference's default: conic and colour cotangents ride the re-sort
    # as bf16 pairs. Both sides round the same per-record values, but a
    # per-record value within float32 rounding of a bf16 tie rounds apart
    # (2^-8 relative on that record); 6e-3 is the reference's own packing
    # envelope (tests/test_pipeline.py:220-224).
    "bf16_pairs": (100, 3, None, True, 3e-4, 6e-3),
    # A pool too small for the frame: records past it are dropped, and a
    # splat straddling the cut keeps only its live records' gradients.
    "dropped": (300, 4, 512, False, 3e-4, 0.05),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_grads_match_pallas_pipeline(case):
    n, seed, pool, pack, atol, flip_tol = CASES[case]
    sc = make_scene(n, seed=seed, scale_hi=0.5, sh_degree=1)
    v = np.random.default_rng(seed + 100).normal(
        size=(SIZE[1], SIZE[0], 4)).astype(np.float32)
    xy0 = np.zeros((n, 2), np.float32)
    cpj = j_cp(JCamera(**CAM), SIZE)

    def f(means, log_scales, quats, sh, opac, xy_dummy):
        img, aux = j_render(means, log_scales, quats, sh, opac, cpj, SIZE,
                            xy_dummy=xy_dummy, backend="pallas",
                            scan_passes=3, pack_grad_sort=pack,
                            max_isects=pool)
        return jnp.sum(img * v), aux

    (_, aux_j), g_j = jax.value_and_grad(f, argnums=tuple(range(6)),
                                         has_aux=True)(
        *(jnp.asarray(sc[k]) for k in NAMES), jnp.asarray(xy0))

    params = [torch.tensor(sc[k], requires_grad=True) for k in NAMES]
    xy_dummy = torch.tensor(xy0, requires_grad=True)
    img, aux = render_splats(*params, camera_params(Camera(**CAM), SIZE,
                                                    device="cpu"),
                             SIZE, xy_dummy=xy_dummy, pack_grad_sort=pack,
                             max_isects=pool)
    (img * torch.tensor(v)).sum().backward()

    assert int(aux.num_dropped) == int(aux_j.num_dropped)
    assert (int(aux.num_dropped) > 0) == (case == "dropped")
    np.testing.assert_array_equal(aux.order.numpy(), np.asarray(aux_j.order))
    for name, want, got in zip(NAMES + ["xy_dummy"], g_j,
                               params + [xy_dummy]):
        want, got = np.asarray(want), got.grad.numpy()
        assert np.isfinite(got).all(), name
        scale = np.abs(want).max()
        assert scale > 0, name
        assert_close_quantized(got / scale, want / scale, atol=atol,
                               flip_tol=flip_tol, max_flip_frac=5e-3,
                               err_msg=f"{case}: {name}")


def test_padding_and_culled_splats_get_exact_zero_grads():
    """Padding rows and splats behind the camera go through the
    projection's guarded branches (z_safe, cov2d_safe); nothing infinite
    may reach the backward of the branch torch.where did not select, so
    their gradients are exactly zero and every gradient is finite
    (tests/test_pipeline.py::test_pipeline_padding_rows_get_zero_grads)."""
    from brush_tpu_torch.splats import from_dense

    sc = make_scene(64, seed=5)
    sc["means"][:8, 2] = -9.0  # behind the camera at z = -6
    ts = from_dense(sc["means"], sc["sh_coeffs"], sc["quats"],
                    sc["raw_opacity"], sc["log_scales"], capacity=128,
                    device="cpu")
    params = [getattr(ts, k).clone().requires_grad_(True) for k in NAMES]
    xy_dummy = torch.zeros((128, 2), requires_grad=True)
    img, aux = render_splats(*params, camera_params(Camera(**CAM), (32, 32),
                                                    device="cpu"),
                             (32, 32), xy_dummy=xy_dummy,
                             active=ts.active_mask())
    assert not bool(aux.visible[:8].any()) and int(aux.num_isects) > 0
    (img ** 2).sum().backward()
    for p in params + [xy_dummy]:
        g = p.grad.reshape(128, -1)
        assert torch.isfinite(g).all()
        assert not g[64:].any() and not g[:8].any()
        assert g[8:64].abs().max() > 0


def test_only_attrs9_carries_gradients():
    """The tile pretest, the depth key and the decode rows are built from
    detached tensors (render.py:275-277, :168 of the reference): autograd
    records none of the pretest's (8, 8, N) float work, and only attrs9
    leads back to the parameters."""
    from brush_tpu_torch.render import record_inputs

    sc = make_scene(64, seed=6)
    params = [torch.tensor(sc[k], requires_grad=True) for k in NAMES]
    rec = record_inputs(*params, camera_params(Camera(**CAM), (32, 32),
                                               device="cpu"), (32, 32))
    assert rec.attrs9.requires_grad
    assert not any(t.requires_grad for t in rec.proj)
    assert not rec.decode.requires_grad and not rec.depth_key.requires_grad
