"""Checkpoint / resume (port of brush_tpu/utils/checkpoint.py).

A checkpoint carries the full training state: splat parameters, Adam
moments, densification accumulators, the step and the refine noise's
generator, as one .npz of host arrays plus a JSON sidecar (step, config).
The keys and the sidecar are the JAX package's, so a checkpoint written by
either package loads in the other, with one exception: the JAX package
stores its jax.random key under `rng_key`, which the port cannot use (its
refine noise comes from a torch.Generator, stored under
`torch_generator_state`). A JAX checkpoint's `rng_key` is skipped with a
warning, and the refine noise then starts from the config's seed.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os

import numpy as np
import torch

from brush_tpu_torch.device import resolve_device
from brush_tpu_torch.optim import AdamState
from brush_tpu_torch.splats import Splats
from brush_tpu_torch.train import TrainState

_PARAM_KEYS = ["means", "sh_coeffs", "quats", "raw_opacity", "log_scales"]
GENERATOR_KEY = "torch_generator_state"

_log = logging.getLogger(__name__)


def _npz_path(path) -> str:
    """np.savez appends ".npz" when it is missing; the sidecar and the
    loader follow the same name (checkpoint.py:48-49,61-62)."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, state: TrainState, step: int,
                    generator: torch.Generator | None = None,
                    config=None) -> str:
    """Write `state` at `step` to path (.npz appended when missing) and its
    sidecar path + ".json"; returns the .npz path."""
    path = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    host = lambda t: t.detach().cpu().numpy()
    arrays = {}
    for k in _PARAM_KEYS:
        arrays[f"param/{k}"] = host(getattr(state.splats, k))
        arrays[f"adam_m/{k}"] = host(state.opt.m[k])
        arrays[f"adam_v/{k}"] = host(state.opt.v[k])
    arrays["adam_count"] = np.asarray(state.opt.count, np.int32)
    arrays["n_live"] = np.asarray(state.splats.n_live, np.int32)
    arrays["grad_2d_accum"] = host(state.grad_2d_accum)
    arrays["xy_grad_counts"] = host(state.xy_grad_counts)
    if generator is not None:
        arrays[GENERATOR_KEY] = generator.get_state().numpy()
    np.savez(path, **arrays)

    meta = {"step": int(step), "format_version": 1}
    if config is not None:
        meta["config"] = dataclasses.asdict(config)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_checkpoint(path: str, device="cuda"):
    """Returns (TrainState on `device`, step, generator state or None,
    config dict or None). The generator state is the uint8 tensor of
    torch.Generator.get_state(), for a generator on `device`'s type."""
    dev = resolve_device(device)
    path = _npz_path(path)
    with np.load(path) as z:
        t = lambda key: torch.as_tensor(z[key], device=dev)
        splats = Splats(n_live=int(z["n_live"]),
                        **{k: t(f"param/{k}") for k in _PARAM_KEYS})
        opt = AdamState(m={k: t(f"adam_m/{k}") for k in _PARAM_KEYS},
                        v={k: t(f"adam_v/{k}") for k in _PARAM_KEYS},
                        count=int(z["adam_count"]))
        state = TrainState(splats=splats, opt=opt,
                           grad_2d_accum=t("grad_2d_accum"),
                           xy_grad_counts=t("xy_grad_counts"))
        generator_state = None
        if GENERATOR_KEY in z:
            generator_state = torch.as_tensor(z[GENERATOR_KEY])
        if "rng_key" in z:
            _log.warning(
                "%s holds a jax.random key (rng_key), which the port cannot "
                "use; the refine noise starts from the config's seed", path)
    step, config = 0, None
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
        step = meta.get("step", 0)
        config = meta.get("config")
    return state, step, generator_state, config
