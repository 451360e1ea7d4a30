"""Training configuration (a copy of brush_tpu/config.py, which imports
nothing of JAX; the port keeps its own).

Field-for-field mirror of the reference defaults (reference:
brush-train/src/train.rs:20-87 TrainConfig, plus the viewer's LR schedule
setup, brush-viewer/src/panels/load_data.rs:52-70). These are the 3DGS-paper
values; the PSNR targets depend on them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainConfig:
    # Steps before refinement starts (train.rs:22-23).
    warmup_steps: int = 500
    # Refinement cadence (train.rs:26-27).
    refine_every: int = 100
    # Refinement stops after this step (train.rs:29-30).
    max_refine_step: int = 15000
    # Opacity value assigned at alpha reset (train.rs:32-33).
    reset_alpha_value: float = 0.004
    # Cull below this opacity (train.rs:36-37).
    cull_alpha_thresh: float = 0.005
    # Cull above this world-space scale (train.rs:40-41).
    cull_scale_thresh: float = 5.0
    # Alpha reset cadence, in refine steps (train.rs:44-45).
    reset_alpha_every_refine: int = 30
    # Densify when avg screen-space grad norm exceeds this (train.rs:49-50).
    densify_grad_thresh: float = 2e-4
    # Below this size clone, else split (train.rs:53-54).
    densify_size_thresh: float = 0.005
    # Loss = l1 * (1 - w) - ssim * w (train.rs:56-57).
    ssim_weight: float = 0.2
    ssim_window_size: int = 11
    # Scale the mean LR by the scene extent (train.rs:62-63).
    scale_mean_lr_by_extent: bool = True

    # Mean LR schedule: lr_max * decay^step (load_data.rs:54-55:
    # lr_max=1.6e-4, decay=(1e-2)^(1/30000)).
    lr_mean: float = 1.6e-4
    lr_mean_decay_target: float = 1e-2
    lr_mean_decay_steps: int = 30_000

    # Per-group LRs (train.rs:69-84).
    lr_coeffs_dc: float = 4e-3
    lr_coeffs_sh_scale: float = 20.0   # higher SH orders use lr/this
    lr_opac: float = 5e-2
    lr_scale: float = 1e-2
    lr_rotation: float = 2e-3

    # Adam epsilon (train.rs:184: AdamConfig epsilon 1e-15).
    adam_eps: float = 1e-15

    seed: int = 42

    # --- Additions of the JAX package (not in the reference) ---
    # Keep Adam moments across refines via state surgery instead of the
    # reference's full optimizer reset (train.rs:567-568, marked TODO there).
    keep_opt_state_on_refine: bool = True
    # Replicate the reference's *actual* split behavior: its in-place
    # modifications of split originals are applied to clones that are then
    # discarded (train.rs:482-489,501-508 vs :520), so originals keep their
    # mean/scale and only an offset smaller copy is appended. False applies
    # the intended semantics (offset original, shrink both halves).
    faithful_split_bug: bool = False
    # Shrink the padded splat capacity when the live count falls far below
    # it (e.g. after the mass-prune that follows every opacity reset: every
    # per-splat stage runs over the whole capacity). Shrinks only at refine
    # boundaries and only when capacity > shrink_factor * live, so
    # grow/shrink cannot oscillate between adjacent refines.
    shrink_capacity_on_refine: bool = True
    shrink_factor: int = 4

    def lr_mean_at(self, step: int) -> float:
        decay = self.lr_mean_decay_target ** (1.0 / self.lr_mean_decay_steps)
        return self.lr_mean * (decay ** step)
