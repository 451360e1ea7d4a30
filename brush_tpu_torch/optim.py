"""Adam with per-group learning rates and refinement state surgery (port of
brush_tpu/optim.py).

The reference drives five separate Adam steps with distinct learning
rates per parameter group (train.rs:318-359). Here Adam is a plain
function over dicts of tensors, so refinement can permute, append and zero
moment rows alongside the splats; torch.optim.Adam keeps its state per
parameter object and takes one learning rate per group, while the SH
learning rate is a per-coefficient scale (train.rs:334-348: lr/20 on the
higher orders). Bias correction matches the reference's: float32
1 - beta ** count.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AdamState:
    m: dict      # first moments, same keys and shapes as the params
    v: dict      # second moments
    count: int   # steps taken


def init_adam(params: dict) -> AdamState:
    return AdamState(
        m={k: torch.zeros_like(p) for k, p in params.items()},
        v={k: torch.zeros_like(p) for k, p in params.items()},
        count=0,
    )


@torch.no_grad()
def adam_step(params: dict, grads: dict, state: AdamState, lrs: dict,
              beta1: float = 0.9, beta2: float = 0.999,
              eps: float = 1e-15) -> tuple[dict, AdamState]:
    """One Adam step; returns new tensors and leaves the inputs as they
    were. `lrs` maps each key to a float or a tensor that broadcasts
    against the param (the SH coefficients' per-coefficient scale)."""
    count = state.count + 1
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    b1c = float(1.0 - f32(beta1) ** f32(count))
    b2c = float(1.0 - f32(beta2) ** f32(count))

    new_params, new_m, new_v = {}, {}, {}
    for key, p in params.items():
        g = grads[key]
        m = beta1 * state.m[key] + (1.0 - beta1) * g
        v = beta2 * state.v[key] + (1.0 - beta2) * g * g
        m_hat = m / b1c
        v_hat = v / b2c
        new_params[key] = p - lrs[key] * m_hat / (torch.sqrt(v_hat) + eps)
        new_m[key] = m
        new_v[key] = v
    return new_params, AdamState(m=new_m, v=new_v, count=count)
