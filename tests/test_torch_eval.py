"""The port's SSIM and PSNR/SSIM evaluation against brush_tpu's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brush_tpu.camera import Camera as JCamera
from brush_tpu.eval import eval_stats as j_eval_stats
from brush_tpu.eval import psnr_from_mse as j_psnr
from brush_tpu.splats import from_random as j_from_random
from brush_tpu.ssim import Ssim as JSsim
from brush_tpu.ssim import gaussian_window as j_gaussian_window

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.convert import splats_from_numpy
from brush_tpu_torch.eval import eval_stats, eval_view, psnr_from_mse
from brush_tpu_torch.ssim import Ssim, gaussian_window
from torch_threads import pin_threads

pin_threads()


@pytest.mark.parametrize("window,shape", [(11, (2, 20, 24, 3)),
                                          (7, (1, 9, 13, 3))])
def test_ssim_matches_reference(window, shape):
    rng = np.random.default_rng(window)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    want = float(JSsim(window, 3).ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(Ssim(window, 3).ssim(torch.tensor(a), torch.tensor(b)))
    assert abs(got - want) < 1e-5
    # Identical images score 1 everywhere, the zero-padded border too.
    same = float(Ssim(window, 3).ssim(torch.tensor(a), torch.tensor(a)))
    assert same == pytest.approx(1.0, abs=1e-5)
    np.testing.assert_array_equal(gaussian_window(window, 1.5),
                                  j_gaussian_window(window, 1.5))


def test_psnr_matches_reference():
    for mse in (1e-6, 0.01, 0.3):
        assert float(psnr_from_mse(torch.tensor(mse))) == pytest.approx(
            float(j_psnr(jnp.float32(mse))), abs=1e-4)


def _views(seed=0, n=2, size=(48, 40)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kw = dict(position=[0.2 * i, -0.1, -6.0], rotation=[1, 0, 0, 0],
                  fov_x=1.3, fov_y=1.1)
        gt = rng.uniform(0, 1, (size[1], size[0], 3)).astype(np.float32)
        out.append((kw, gt))
    return out


def test_eval_stats_matches_reference():
    js = j_from_random(np.random.default_rng(1), [-2] * 3, [2] * 3,
                       count=400, sh_degree=1)
    ts = splats_from_numpy({k: np.asarray(v) for k, v in js.params().items()},
                           int(js.n_live), device="cpu")
    views = _views()
    # The reference's eval on CPU takes its XLA path (unquantized); the
    # port's record pipeline quantizes colour to ~1.2e-4 steps, which
    # moves PSNR/SSIM of a render against noise by far less than 1e-4.
    want = j_eval_stats(js, [(JCamera(**kw), gt) for kw, gt in views],
                        block_size=64)
    got = eval_stats(ts, [(Camera(**kw), gt) for kw, gt in views],
                     block_size=64, keep_images=True)
    for g, w in zip(got, want):
        assert abs(g.psnr - w.psnr) < 1e-4
        assert abs(g.ssim - w.ssim) < 1e-4
        assert g.rendered.shape == (40, 48, 3)


def test_eval_view_grows_the_pool_until_nothing_drops():
    js = j_from_random(np.random.default_rng(2), [-2] * 3, [2] * 3,
                       count=300, sh_degree=0)
    ts = splats_from_numpy({k: np.asarray(v) for k, v in js.params().items()},
                           int(js.n_live), device="cpu")
    kw, gt = _views(n=1, size=(64, 64))[0]
    small = eval_view(ts, Camera(**kw), gt, pool=512)
    assert small.pool > 512
    full = eval_view(ts, Camera(**kw), gt)
    assert abs(small.psnr - full.psnr) < 1e-5
