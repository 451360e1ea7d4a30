"""Training loop: loss, per-group Adam, densification statistics, refinement
(port of brush_tpu/train.py; reference: brush-train/src/train.rs).

  step   = render -> L1 + SSIM loss -> backward -> per-group Adam with
           distinct LRs -> screen-space-gradient accumulation
           (train.rs:211-393)
  refine = clone small / split large high-gradient splats, prune transparent
           or oversized ones, periodic opacity reset (train.rs:395-578)

As in the JAX package: splats live in a padded capacity-C buffer and refine
compacts candidates with a stable sort over 2C rows; Adam moments survive a
refine by state surgery (TrainConfig.keep_opt_state_on_refine); capacity
grows in x2 buckets when a refine could overflow it and shrinks after a
mass prune. PyTorch runs eagerly, so there is nothing to compile: the step
is a function of the state, not a cached executable.

The step itself never waits on the device. The intersection-pool overflow
check of the reference (one step late, train.py:179-193) reads the dropped
count through a non-blocking copy and a CUDA event, and acts on it at the
first step that finds the event complete. Refine boundaries read the live
count and the pool pressure from the device, as the reference's do.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple

import numpy as np
import torch

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.config import TrainConfig
from brush_tpu_torch.device import full_f32
from brush_tpu_torch.ops.projection import quat_to_rotmat
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.optim import AdamState, adam_step, init_adam
from brush_tpu_torch.render import render_splats
from brush_tpu_torch.splats import (
    PADDING_RAW_OPACITY, Splats, inverse_sigmoid, round_up_capacity,
)
from brush_tpu_torch.ssim import Ssim
from brush_tpu_torch.utils.profiler import mark, span

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class SceneBatch:
    """One training view (the reference asserts batch size 1, train.rs:217)."""

    gt_image: np.ndarray       # (H, W, 3|4) float32 in [0, 1]
    camera: Camera
    scene_extent: float = 1.0


@dataclasses.dataclass
class TrainState:
    splats: Splats
    opt: AdamState
    grad_2d_accum: torch.Tensor   # (C,) f32
    xy_grad_counts: torch.Tensor  # (C,) i32


class StepStats(NamedTuple):
    """Device scalars of one step (reading one waits for the step)."""

    loss: torch.Tensor
    num_visible: torch.Tensor
    num_isects: torch.Tensor
    num_dropped: torch.Tensor  # records lost to intersection-pool overflow
    # The largest record count of one strip, unclamped (the sharded step's
    # max over ranks; one device is one strip: num_isects). It drives
    # parallel.ShardedTrainer's adaptive strip-pool slack.
    max_strip_isects: torch.Tensor | int = 0


class RefineStats(NamedTuple):
    num_cloned: int
    num_split: int
    num_pruned_alpha: int
    num_pruned_scale: int
    n_live: int


def quat_rotate(quats: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Rotate vectors into the splat frame: R(q) @ v, q normalized first
    (the stored quats drift off unit norm under Adam). The reference's
    hand-expanded version (train.rs:140-177) is not a rotation; like the
    JAX package, this uses the intended one."""
    quats = quats / torch.clamp(
        torch.linalg.vector_norm(quats, dim=-1, keepdim=True), min=1e-12)
    return torch.sum(quat_to_rotmat(quats) * vecs[:, None, :], dim=-1)


class SplatTrainer:
    """Host-side orchestration of the step and the refine cadence,
    mirroring the reference's train_loop
    (brush-viewer/src/train_loop.rs:102-172). Runs on the device of the
    state's splats. raster_block_size, raster_cell and pack_grad_sort are
    render_splats' block_size, cell and pack_grad_sort, defaults as the JAX
    trainer's (brush_tpu/train.py:118-125): the pool rounds to
    lcm(max(128, block), 512), raster cells are single tiles, and the
    backward's conic and colour cotangents ride the grad re-sort as bf16
    pairs. Unlike the JAX trainer on the CPU, whose XLA render ignores the
    cell, every render here honours raster_cell."""

    def __init__(self, config: TrainConfig | None = None,
                 raster_block_size: int = 32, raster_cell=(1, 1),
                 pack_grad_sort: bool = True):
        self.config = config or TrainConfig()
        self.iter = 0
        self.raster_block_size = raster_block_size
        self.raster_cell = tuple(raster_cell)
        self.pack_grad_sort = pack_grad_sort
        # Adaptive intersection-pool size: start modest and grow on
        # pressure (checked at refine boundaries) or overflow.
        self._isect_pool = None
        self._ssim = Ssim(self.config.ssim_window_size, 3)
        self._generator: torch.Generator | None = None
        self.last_refine_stats = None
        # (iter, pool, dropped count on the host, event) of steps not yet
        # acted on.
        self._pending_drops: list = []
        self.total_dropped_records = 0
        # Device ground-truth cache keyed by the view's host array identity
        # (the host ref is kept so the id stays valid); LRU on a byte budget.
        self._gt_cache: dict[int, tuple] = {}
        self._gt_cache_bytes = 0
        self.gt_cache_byte_budget = 2 << 30
        self.gt_cache_hits = 0

    # ------------------------------------------------------------------ #

    def init_state(self, splats: Splats) -> TrainState:
        cap = splats.capacity
        return TrainState(
            splats=splats,
            opt=init_adam(splats.params()),
            grad_2d_accum=torch.zeros(cap, dtype=torch.float32,
                                      device=splats.device),
            xy_grad_counts=torch.zeros(cap, dtype=torch.int32,
                                       device=splats.device),
        )

    def step(self, state: TrainState,
             batch: SceneBatch) -> tuple[TrainState, StepStats]:
        cfg = self.config
        with span("upload"):
            img = np.asarray(batch.gt_image, np.float32)
            h, w, channels = img.shape
            img_size = (w, h)

            lr_mean = cfg.lr_mean_at(self.iter)
            if cfg.scale_mean_lr_by_extent:
                lr_mean *= batch.scene_extent

            self._respond_to_drops()
            dev = state.splats.device
            cam = camera_params(batch.camera, img_size, device=dev)
            pool = self._pool_size(state.splats.capacity)
            gt = self._gt_on_device(batch, img, dev)

        pre_splats = state.splats
        state, stats = self._train_step(state, gt, cam, lr_mean, self.iter,
                                        img_size, channels, pool)

        do_refine = (
            self.iter < cfg.max_refine_step
            and self.iter >= cfg.warmup_steps
            # The reference cadence (iter % every == 1), with
            # refine_every=1 meaning every step.
            and self.iter % cfg.refine_every == 1 % cfg.refine_every
        )
        self.last_refine_stats = None
        if do_refine:
            # Host sync point: also grow the pool before records drop.
            if int(stats.num_isects) > 0.85 * pool:
                self._isect_pool = pool * 2
            state, self.last_refine_stats = self._refine(state, pre_splats)
            mark("refine")

        self._note_drops(stats, pool)
        mark("step end")
        self.iter += 1
        return state, stats

    # ------------------------------------------------------------------ #

    def _pool_size(self, capacity: int) -> int:
        if self._isect_pool is None:
            self._isect_pool = min(max(capacity * 16, 1 << 16), 1 << 22)
        return self._isect_pool

    def _note_drops(self, stats: StepStats, pool: int):
        host, event = copy_to_host(torch.stack([
            torch.as_tensor(v).to(torch.int64).reshape(())
            for v in (stats.num_dropped, stats.num_isects,
                      stats.max_strip_isects)]))
        self._pending_drops.append((self.iter, pool, host, event))

    def _respond_to_drops(self, wait: bool = False):
        """The reference's overflow response (train.py:179-193): any
        dropped record doubles the pool. Acts on each earlier step once its
        copy has landed, without waiting for it unless `wait`; a drop at a
        pool smaller than the current one was answered already. Each
        step's counts also go to _observe_strips."""
        waiting = []
        for it, pool, host, event in self._pending_drops:
            if event is not None and not event.query():
                if not wait:
                    waiting.append((it, pool, host, event))
                    continue
                event.synchronize()
            dropped, isects, strip_isects = (int(v) for v in host)
            self._observe_strips(isects, strip_isects)
            if dropped > 0:
                self.total_dropped_records += dropped
                if pool >= self._isect_pool:
                    self._isect_pool = pool * 2
                    _log.warning(
                        "intersection pool overflowed: %d records dropped "
                        "at iter %d; growing pool %d -> %d", dropped, it,
                        pool, self._isect_pool)
        self._pending_drops = waiting

    def _observe_strips(self, num_isects: int, max_strip_isects: int):
        """A step's record count and its largest strip's, once on the
        host (parallel.ShardedTrainer sizes its strip pools from them)."""

    def _gt_on_device(self, batch: SceneBatch, img: np.ndarray,
                      dev: torch.device) -> torch.Tensor:
        key = id(batch.gt_image)
        cached = self._gt_cache.get(key)
        if cached is None:
            entry_bytes = img.nbytes
            while (self._gt_cache and self._gt_cache_bytes + entry_bytes
                   > self.gt_cache_byte_budget):
                old = self._gt_cache.pop(next(iter(self._gt_cache)))
                self._gt_cache_bytes -= old[2]
            cached = (batch.gt_image, torch.as_tensor(img, device=dev),
                      entry_bytes)
            self._gt_cache_bytes += entry_bytes
        else:
            self.gt_cache_hits += 1
            self._gt_cache.pop(key)   # refresh the LRU position
        self._gt_cache[key] = cached
        return cached[1]

    def _train_step(self, state: TrainState, gt, cam, lr_mean: float,
                    step: int, img_size, channels: int, pool: int):
        splats = state.splats
        params, xy_dummy = trainable(splats)
        with full_f32():
            img, aux = render_splats(
                params["means"], params["log_scales"], params["quats"],
                params["sh_coeffs"], params["raw_opacity"], cam, img_size,
                xy_dummy=xy_dummy, active=splats.active_mask(),
                block_size=self.raster_block_size, max_isects=pool,
                cell=self.raster_cell, pack_grad_sort=self.pack_grad_sort)
            with span("loss"):
                loss = image_loss(img, gt, channels, self.config,
                                  self._ssim)
            loss.backward()
            mark("autograd rest")
        new_state = update_state(self.config, state, params, xy_dummy,
                                 aux.producing, step, img_size, lr_mean)
        return new_state, StepStats(
            loss=loss.detach(), num_visible=aux.num_visible,
            num_isects=aux.num_isects, num_dropped=aux.num_dropped,
            max_strip_isects=aux.num_isects)  # one device is one strip

    # ------------------------------------------------------------------ #

    def _refine(self, state: TrainState, pre_splats: Splats):
        cfg = self.config
        cap = state.splats.capacity
        # Pre-grow when clones + splits could exceed capacity: the
        # compaction would truncate appended rows past it.
        n_before = state.splats.n_live
        if 2 * n_before > cap:
            state = self._grow(state, 2 * n_before)
            cap = state.splats.capacity
            pre_splats = self._grow_splats(pre_splats, cap)
        refine_idx = self.iter // cfg.refine_every
        # refine_idx > 0: with warmup <= 1 the first refine would land on
        # refine_idx 0 and reset every opacity at the start of training.
        do_reset = (refine_idx % cfg.reset_alpha_every_refine) == 0 \
            and refine_idx > 0
        if self._generator is None:
            # The split noise's generator, on the state's device.
            self._generator = torch.Generator(device=state.splats.device)
            self._generator.manual_seed(cfg.seed)
        refine_fn = make_refine_fn(cfg, cap, bool(do_reset))
        state, stats = refine_fn(state, pre_splats, generator=self._generator)
        n_live = stats.n_live
        if 2 * n_live > cap:
            state = self._grow(state, max(2 * n_live, cap * 2))
        elif (cfg.shrink_capacity_on_refine
              and cap > cfg.shrink_factor * max(n_live, 1)):
            # Compaction puts live rows first, so shrinking is a slice.
            state = self._shrink(state, 2 * n_live)
        return state, stats

    def _shrink(self, state: TrainState, new_cap: int) -> TrainState:
        new_cap = round_up_capacity(new_cap)
        if new_cap >= state.splats.capacity:
            return state
        return map_rows(state, lambda x: x[:new_cap])

    @staticmethod
    def _pad(x: torch.Tensor, pad: int, fill=0.0) -> torch.Tensor:
        tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail])

    def _grow_splats(self, sp: Splats, new_cap: int) -> Splats:
        """Pad a bare Splats to new_cap with the padding rows' fills."""
        pad = new_cap - sp.capacity
        if pad <= 0:
            return sp
        quats = self._pad(sp.quats, pad)
        quats[sp.capacity:, 0] = 1.0
        return Splats(
            means=self._pad(sp.means, pad),
            sh_coeffs=self._pad(sp.sh_coeffs, pad),
            quats=quats,
            raw_opacity=self._pad(sp.raw_opacity, pad, PADDING_RAW_OPACITY),
            log_scales=self._pad(sp.log_scales, pad, -10.0),
            n_live=sp.n_live,
        )

    def _grow(self, state: TrainState, new_cap: int) -> TrainState:
        new_cap = round_up_capacity(new_cap)
        pad = new_cap - state.splats.capacity
        if pad <= 0:
            return state
        opt = AdamState(
            m={k: self._pad(v, pad) for k, v in state.opt.m.items()},
            v={k: self._pad(v, pad) for k, v in state.opt.v.items()},
            count=state.opt.count)
        return TrainState(
            splats=self._grow_splats(state.splats, new_cap), opt=opt,
            grad_2d_accum=self._pad(state.grad_2d_accum, pad),
            xy_grad_counts=self._pad(state.xy_grad_counts, pad, 0))


def map_rows(obj, fn):
    """A Splats or TrainState with fn applied to each of its (C, ...)
    tensors; n_live and the Adam count are kept."""
    if isinstance(obj, Splats):
        return Splats(n_live=obj.n_live,
                      **{k: fn(v) for k, v in obj.params().items()})
    return TrainState(
        splats=map_rows(obj.splats, fn),
        opt=AdamState(m={k: fn(v) for k, v in obj.opt.m.items()},
                      v={k: fn(v) for k, v in obj.opt.v.items()},
                      count=obj.opt.count),
        grad_2d_accum=fn(obj.grad_2d_accum),
        xy_grad_counts=fn(obj.xy_grad_counts))


def copy_to_host(t: torch.Tensor):
    """(host tensor, event): a CUDA tensor's copy into pinned memory,
    started without waiting, and the event after which it has landed
    (None, and the tensor itself, on the CPU)."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def trainable(splats: Splats):
    """The step's leaves: detached copies of the parameters that require
    grad, and the zero (rows, 2) xy_dummy whose gradient is the
    screen-space gradient densification reads (render.py:22-25)."""
    params = {k: v.detach().requires_grad_(True)
              for k, v in splats.params().items()}
    xy_dummy = torch.zeros((splats.capacity, 2), dtype=torch.float32,
                           device=splats.device, requires_grad=True)
    return params, xy_dummy


def image_loss(img, gt, channels: int, cfg: TrainConfig, ssim: Ssim):
    """L1 + SSIM (train.rs:243-262): (1 - w) L1 - w SSIM on RGB."""
    pred = img if channels == 4 else img[..., :3]
    l1 = torch.mean(torch.abs(pred - gt))
    if cfg.ssim_weight > 0.0:
        ssim_val = ssim.ssim(img[None, ..., :3], gt[None, ..., :3])
        return l1 * (1.0 - cfg.ssim_weight) - ssim_val * cfg.ssim_weight
    return l1


@torch.no_grad()
def update_state(cfg: TrainConfig, state: TrainState, params: dict,
                 xy_dummy, producing, step: int, img_size,
                 lr_mean: float) -> TrainState:
    """After the backward: the densification statistics and the Adam
    step over the rows of `state` (all of them, or one rank's block)."""
    w, h = img_size
    splats = state.splats
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in params.items()}
    # Densification statistics (train.rs:284-316): screen-space gradient
    # norms in half-image units, gated past warmup.
    gate = 1.0 if step > cfg.warmup_steps else 0.0
    with span("densify_stats"):
        xy_g = xy_dummy.grad
        xys_scaled = torch.stack([xy_g[:, 0] * (w / 2.0),
                                  xy_g[:, 1] * (h / 2.0)], dim=1)
        norms = torch.sqrt(torch.sum(xys_scaled ** 2, dim=1))
        grad_accum = state.grad_2d_accum + gate * norms
        counts = (state.xy_grad_counts
                  + int(gate) * producing.to(torch.int32))

    with span("adam"):
        # Per-coefficient SH learning rates: orders > 0 at lr/20
        # (train.rs:334-348).
        sh_scale = torch.full((1, splats.sh_count, 1),
                              1.0 / cfg.lr_coeffs_sh_scale,
                              device=splats.device)
        sh_scale[:, 0] = 1.0
        lrs = {
            "means": lr_mean,
            "raw_opacity": cfg.lr_opac,
            "sh_coeffs": cfg.lr_coeffs_dc * sh_scale,
            "quats": cfg.lr_rotation,
            "log_scales": cfg.lr_scale,
        }
        new_params, opt = adam_step(
            {k: p.detach() for k, p in params.items()}, grads, state.opt,
            lrs, eps=cfg.adam_eps)
    return TrainState(splats=splats.with_params(new_params), opt=opt,
                      grad_2d_accum=grad_accum, xy_grad_counts=counts)


def make_refine_fn(cfg: TrainConfig, capacity: int, do_reset: bool):
    """The refine computation (train.py:459-597) as a function
    refine_fn(state, pre, generator=None, noise=None, noise2=None) ->
    (state, RefineStats).

    `pre` holds the splats before the step's Adam update. The split offsets
    are 0.5 * N(0, 1) * scale in the splat frame: `noise` (for the
    appended halves) and `noise2` (for the originals, unless
    cfg.faithful_split_bug) are (capacity, 3) standard normal draws, taken
    from `generator` when not given (a test passes the draws the JAX
    package makes from its key).
    """

    @torch.no_grad()
    def refine_fn(state: TrainState, pre: Splats, generator=None,
                  noise=None, noise2=None):
        post = state.splats
        dev = post.device
        draw = lambda: torch.randn((capacity, 3), generator=generator,
                                   device=dev)
        alive = post.active_mask()

        counts = torch.clamp(state.xy_grad_counts, min=1).to(torch.float32)
        grads_avg = state.grad_2d_accum / counts
        big = grads_avg >= cfg.densify_grad_thresh

        scales_post = post.scales()
        max_scale = torch.amax(scales_post, dim=1)
        small = max_scale < cfg.densify_size_thresh

        clone_mask = small & big & alive
        split_mask = ~small & big & alive
        append_mask = clone_mask | split_mask

        # Split offset samples (train.rs:494-516): Normal(0, 0.5) in the
        # splat frame scaled by the post-step scale, rotated by the
        # post-step quaternion.
        noise = draw() if noise is None else noise
        offset = quat_rotate(post.quats, 0.5 * noise * scales_post)
        split_log_scales = torch.log(torch.clamp(scales_post / 1.6,
                                                 min=1e-30))

        cm = clone_mask[:, None]
        app_means = torch.where(cm, pre.means, pre.means + offset)
        app_quats = torch.where(cm, pre.quats, post.quats)
        app_sh = torch.where(clone_mask[:, None, None], pre.sh_coeffs,
                             post.sh_coeffs)
        app_opac = torch.where(clone_mask, pre.raw_opacity, post.raw_opacity)
        app_logs = torch.where(cm, pre.log_scales, split_log_scales)

        if cfg.faithful_split_bug:
            # The reference's in-place split modifications target clones
            # that are then discarded (train.rs:482-520): originals keep
            # their post-step mean and scale.
            orig_means = post.means
            orig_logs = post.log_scales
        else:
            sm = split_mask[:, None]
            noise2 = draw() if noise2 is None else noise2
            offset2 = quat_rotate(post.quats, 0.5 * noise2 * scales_post)
            orig_means = torch.where(sm, pre.means - offset2, post.means)
            orig_logs = torch.where(sm, split_log_scales, post.log_scales)

        # Combined candidate set: C originals then C append slots.
        comb = {
            "means": torch.cat([orig_means, app_means]),
            "quats": torch.cat([post.quats, app_quats]),
            "sh_coeffs": torch.cat([post.sh_coeffs, app_sh]),
            "raw_opacity": torch.cat([post.raw_opacity, app_opac]),
            "log_scales": torch.cat([orig_logs, app_logs]),
        }
        valid = torch.cat([alive, append_mask])

        # Prune (train.rs:543-557) on the combined set.
        opac_all = torch.sigmoid(comb["raw_opacity"])
        scale_all = torch.amax(torch.exp(comb["log_scales"]), dim=1)
        prune_alpha = opac_all < cfg.cull_alpha_thresh
        prune_scale = scale_all > cfg.cull_scale_thresh
        keep = valid & ~prune_alpha & ~prune_scale

        # Stable compaction: kept rows first, original order preserved.
        perm = torch.sort((~keep).to(torch.int32), stable=True).indices
        perm = perm[:capacity]
        counted = torch.stack([
            clone_mask.sum(), split_mask.sum(), (valid & prune_alpha).sum(),
            (valid & ~prune_alpha & prune_scale).sum(), keep.sum(),
        ]).tolist()
        n_live = min(counted[4], capacity)
        row_live = torch.arange(capacity, device=dev) < n_live

        def take(x, fill=0.0):
            out = x[perm]
            shape = (-1,) + (1,) * (out.dim() - 1)
            return torch.where(row_live.reshape(shape), out,
                               torch.full((), fill, dtype=out.dtype,
                                          device=dev))

        new_opac = take(comb["raw_opacity"], PADDING_RAW_OPACITY)
        if do_reset:
            # Opacity reset (train.rs:205-209,559-562).
            new_opac = torch.where(
                row_live, torch.full((), inverse_sigmoid(
                    cfg.reset_alpha_value), device=dev), new_opac)

        new_quats = take(comb["quats"])
        new_quats[:, 0] = torch.where(row_live, new_quats[:, 0],
                                      torch.ones((), device=dev))
        splats = Splats(
            means=take(comb["means"]),
            sh_coeffs=take(comb["sh_coeffs"]),
            quats=new_quats,
            raw_opacity=new_opac,
            log_scales=take(comb["log_scales"], -10.0),
            n_live=n_live,
        )

        # Optimizer state surgery: appended rows (perm >= C) start with
        # zero moments; survivors keep theirs.
        if cfg.keep_opt_state_on_refine:
            is_new = (perm >= capacity) | ~row_live

            def fix(x):
                padded = torch.cat([x, torch.zeros_like(x)])[perm]
                shape = (-1,) + (1,) * (x.dim() - 1)
                return torch.where(is_new.reshape(shape),
                                   torch.zeros((), device=dev), padded)

            opt = AdamState(m={k: fix(v) for k, v in state.opt.m.items()},
                            v={k: fix(v) for k, v in state.opt.v.items()},
                            count=state.opt.count)
        else:
            opt = init_adam(splats.params())

        stats = RefineStats(num_cloned=counted[0], num_split=counted[1],
                            num_pruned_alpha=counted[2],
                            num_pruned_scale=counted[3], n_live=n_live)
        new_state = TrainState(
            splats=splats, opt=opt,
            grad_2d_accum=torch.zeros(capacity, dtype=torch.float32,
                                      device=dev),
            xy_grad_counts=torch.zeros(capacity, dtype=torch.int32,
                                       device=dev))
        return new_state, stats

    return refine_fn
