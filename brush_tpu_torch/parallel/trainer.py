"""The trainer over a process group (port of brush_tpu/parallel/trainer.py).

ShardedTrainer is SplatTrainer with its step, refine and pool sizing
taken over, so the host-side logic (LR schedule, refine cadence, gt cache,
pool growth on pressure and drops) is the base class's:

- step: parallel.train_step.make_sharded_train_step on this rank's block
  of rows (row-sharded projection, strip-local record pipeline);
- refine: every rank gathers all rows (sharding.gather_state) and runs the
  base refine, train.make_refine_fn with a generator seeded alike on every
  rank, then keeps its own rows. So the result is the single-device
  refine's, as in the reference, and capacity growth and shrink inside it
  are the base's followed by the re-sharding;
- the pool: sized from the whole model's capacity, as the base sizes it.

Adaptive strip-pool slack (trainer.py:73-114, same constants and the same
retune points: refine boundaries and steps that found a drop) reads each
step's peak strip share from the base trainer's copy of its counts, one
step late and without waiting on the device, except at a retune point;
absent drops it sees every step's share by each retune point, as the
reference does. The peak share is the lifetime peak, as the reference
keeps it, so the pools are its.
"""

from __future__ import annotations

from brush_tpu_torch.config import TrainConfig
from brush_tpu_torch.parallel.sharding import (
    Mesh, gather_state, shard_state,
)
from brush_tpu_torch.parallel.train_step import make_sharded_train_step
from brush_tpu_torch.splats import Splats
from brush_tpu_torch.train import SplatTrainer, TrainState


class ShardedTrainer(SplatTrainer):
    """SplatTrainer over the ranks of `mesh` (sharding.make_mesh): each
    rank runs it on the same batches and holds its block of the rows.

    backend: as make_sharded_train_step's ("xla": the replicated
    binning and the tiled rasterizer, on any device).
    """

    SLACK_START = 2.0   # the starting, and largest, strip-pool slack
    SLACK_STEP = 0.25   # quantization of the adaptive slack
    SLACK_MIN = 1.25    # never a strip pool below 1.25x its ideal share
    SLACK_MARGIN = 1.3  # headroom over the measured peak strip share

    def __init__(self, mesh: Mesh, config: TrainConfig | None = None,
                 raster_block_size: int = 128, backend: str = "auto",
                 raster_cell=(1, 1), pack_grad_sort: bool = True):
        super().__init__(config, raster_block_size=raster_block_size,
                         raster_cell=raster_cell,
                         pack_grad_sort=pack_grad_sort)
        self.mesh = mesh
        self.backend = backend
        self._slack_q = self.SLACK_START  # the slack the steps use
        self._peak_strip_frac = 0.0
        self._step_fn = None
        self._step_key = None

    def init_state(self, splats: Splats) -> TrainState:
        """The whole model's state, cut to this rank's rows."""
        return shard_state(super().init_state(splats), self.mesh)

    def _pool_size(self, capacity: int) -> int:
        # capacity: this rank's rows; the pool follows the whole model's.
        return super()._pool_size(capacity * self.mesh.size)

    def step(self, state, batch):
        dropped = self.total_dropped_records
        state, stats = super().step(state, batch)
        # Retune where the reference does: at a refine boundary (the base
        # step has waited on the device there) and after a drop, on the
        # shares of every step so far.
        if (self.last_refine_stats is not None
                or self.total_dropped_records > dropped):
            self._respond_to_drops(wait=True)
            self._retune_slack()
        return state, stats

    def _observe_strips(self, num_isects: int, max_strip_isects: int):
        """Fold a step's peak strip share (largest strip record count x
        ranks / records) into the lifetime peak."""
        frac = max_strip_isects * self.mesh.size / max(num_isects, 1)
        self._peak_strip_frac = max(self._peak_strip_frac, frac)

    def _retune_slack(self):
        """Re-quantize the slack from the peak strip share: it may shrink
        toward the measured imbalance or grow back up to SLACK_START;
        records beyond that still grow the whole pool through the base
        trainer's response to drops."""
        if self._peak_strip_frac <= 0.0:
            return
        q = self.SLACK_STEP
        target = -(-self._peak_strip_frac * self.SLACK_MARGIN // q) * q
        self._slack_q = min(max(target, self.SLACK_MIN), self.SLACK_START)

    def _train_step(self, state: TrainState, gt, cam, lr_mean: float,
                    step: int, img_size, channels: int, pool: int):
        sp = state.splats
        key = (sp.capacity, tuple(img_size), channels, sp.sh_count, pool,
               self._slack_q)
        if key != self._step_key:
            self._step_fn = make_sharded_train_step(
                self.mesh, self.config, sp.capacity * self.mesh.size,
                img_size, channels, sp.sh_count, max_isects=pool,
                block_size=self.raster_block_size, backend=self.backend,
                strip_pool_slack=self._slack_q, cell=self.raster_cell,
                pack_grad_sort=self.pack_grad_sort)
            self._step_key = key
        return self._step_fn(state, gt, cam.viewmat, cam.focal,
                             cam.pixel_center, lr_mean, step)

    def _refine(self, state: TrainState, pre_splats: Splats):
        full, stats = super()._refine(gather_state(state, self.mesh),
                                      gather_state(pre_splats, self.mesh))
        return shard_state(full, self.mesh), stats
