"""Training sharded over ranks with torch.distributed (port of
brush_tpu/parallel/; the reference is single-GPU, SURVEY.md §2.3)."""

from brush_tpu_torch.parallel.sharding import make_mesh  # noqa: F401
from brush_tpu_torch.parallel.train_step import (  # noqa: F401
    make_sharded_train_step,
)
from brush_tpu_torch.parallel.trainer import ShardedTrainer  # noqa: F401
