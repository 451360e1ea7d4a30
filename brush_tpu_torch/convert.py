"""Carry a model across from brush_tpu's leaves as numpy arrays.

The JAX package's Splats holds `params()` (means, sh_coeffs, quats,
raw_opacity, log_scales) plus a scalar `n_live`. Converted to numpy by the
caller, they become the port's Splats here unchanged: same capacity, same
padding rows, same live count.
"""

from __future__ import annotations

import numpy as np
import torch

from brush_tpu_torch.device import resolve_device
from brush_tpu_torch.splats import Splats

PARAM_NAMES = ("means", "sh_coeffs", "quats", "raw_opacity", "log_scales")


def splats_from_numpy(params: dict[str, np.ndarray], n_live: int,
                      device="cuda") -> Splats:
    """Port Splats from the reference's parameter leaves as numpy arrays."""
    dev = resolve_device(device)
    missing = [k for k in PARAM_NAMES if k not in params]
    if missing:
        raise ValueError(f"missing splat parameters: {missing}")
    t = {k: torch.tensor(np.asarray(params[k], np.float32), device=dev)
         for k in PARAM_NAMES}
    cap = t["means"].shape[0]
    if not 0 <= int(n_live) <= cap:
        raise ValueError(f"n_live {n_live} outside [0, capacity {cap}]")
    return Splats(n_live=int(n_live), **t)
