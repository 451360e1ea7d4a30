"""The port's checkpoints against brush_tpu's: each package loads the
other's, the .npz name is normalised, the step and config ride the JSON
sidecar, and the JAX package's `rng_key` is skipped with a warning."""

import json
import logging

import jax
import numpy as np
import pytest
import torch

from brush_tpu.config import TrainConfig as JConfig
from brush_tpu.splats import from_random as j_from_random
from brush_tpu.train import SplatTrainer as JTrainer
from brush_tpu.utils.checkpoint import load_checkpoint as j_load
from brush_tpu.utils.checkpoint import save_checkpoint as j_save

from brush_tpu_torch.config import TrainConfig
from brush_tpu_torch.convert import PARAM_NAMES, splats_from_numpy
from brush_tpu_torch.train import SplatTrainer
from brush_tpu_torch.utils.checkpoint import (
    GENERATOR_KEY, load_checkpoint, save_checkpoint,
)
from torch_threads import pin_threads

pin_threads()


def port_state(seed=0, n=50, cap=128):
    """A port TrainState with seeded moments and accumulators."""
    js = j_from_random(np.random.default_rng(seed), [-1] * 3, [1] * 3,
                       count=n, sh_degree=1, capacity=cap)
    params = {k: np.asarray(v) for k, v in js.params().items()}
    state = SplatTrainer().init_state(
        splats_from_numpy(params, n, device="cpu"))
    gen = torch.Generator().manual_seed(seed)
    for k in PARAM_NAMES:
        state.opt.m[k] = torch.randn(state.opt.m[k].shape, generator=gen)
        state.opt.v[k] = torch.rand(state.opt.v[k].shape, generator=gen)
    state.opt.count = 17
    state.grad_2d_accum = torch.rand(cap, generator=gen)
    state.xy_grad_counts = torch.randint(0, 9, (cap,), generator=gen,
                                         dtype=torch.int32)
    return state


def assert_states_equal(t, j):
    """A port TrainState against a JAX one, array for array."""
    assert t.splats.n_live == int(j.splats.n_live)
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(t.splats, k).numpy(),
                                      np.asarray(getattr(j.splats, k)), k)
        np.testing.assert_array_equal(t.opt.m[k].numpy(),
                                      np.asarray(j.opt.m[k]), k)
        np.testing.assert_array_equal(t.opt.v[k].numpy(),
                                      np.asarray(j.opt.v[k]), k)
    assert t.opt.count == int(j.opt.count)
    for k in ("grad_2d_accum", "xy_grad_counts"):
        a, b = getattr(t, k).numpy(), np.asarray(getattr(j, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, k)


def test_port_checkpoint_loads_in_reference(tmp_path):
    state = port_state()
    gen = torch.Generator().manual_seed(5)
    path = save_checkpoint(str(tmp_path / "c.npz"), state, 123, gen,
                           TrainConfig(refine_every=7))
    jstate, step, key, config = j_load(path)
    assert_states_equal(state, jstate)
    assert step == 123 and key is None
    assert config == JConfig(refine_every=7).__dict__


def test_reference_checkpoint_loads_in_port(tmp_path, caplog):
    js = j_from_random(np.random.default_rng(1), [-1] * 3, [1] * 3,
                       count=40, sh_degree=2, capacity=64)
    jt = JTrainer(JConfig(seed=3))
    jstate = jt.init_state(js)
    path = str(tmp_path / "ref.npz")
    j_save(path, jstate, 77, jax.random.PRNGKey(9), JConfig(seed=3))
    with caplog.at_level(logging.WARNING):
        state, step, gen_state, config = load_checkpoint(path, device="cpu")
    assert "rng_key" in caplog.text
    assert gen_state is None and step == 77
    assert config == TrainConfig(seed=3).__dict__
    assert_states_equal(state, jstate)
    assert state.splats.capacity == 64


def test_npz_suffix_sidecar_and_generator(tmp_path):
    """Saving to a name without .npz writes name.npz and name.npz.json,
    and loading by either name finds both; the refine noise generator's
    state comes back and continues its stream."""
    state = port_state(seed=2)
    gen = torch.Generator().manual_seed(11)
    torch.randn(5, generator=gen)
    path = save_checkpoint(str(tmp_path / "ckpt_1"), state, 9, gen)
    assert path.endswith("ckpt_1.npz")
    assert (tmp_path / "ckpt_1.npz").exists()
    meta = json.loads((tmp_path / "ckpt_1.npz.json").read_text())
    assert meta == {"step": 9, "format_version": 1}
    want = torch.randn(4, generator=gen)
    for name in ("ckpt_1", "ckpt_1.npz"):
        loaded, step, gen_state, config = load_checkpoint(
            str(tmp_path / name), device="cpu")
        assert step == 9 and config is None
        g2 = torch.Generator()
        g2.set_state(gen_state)
        torch.testing.assert_close(torch.randn(4, generator=g2), want,
                                   rtol=0, atol=0)
        for k in PARAM_NAMES:
            assert torch.equal(getattr(loaded.splats, k),
                               getattr(state.splats, k))
    assert GENERATOR_KEY in np.load(path).files
    # No sidecar: step 0 and no config.
    (tmp_path / "ckpt_1.npz.json").unlink()
    _, step, _, config = load_checkpoint(path, device="cpu")
    assert step == 0 and config is None


def test_load_checkpoint_on_missing_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    path = save_checkpoint(str(tmp_path / "c"), port_state(), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        load_checkpoint(path)
