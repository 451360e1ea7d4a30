"""Dataset ingestion (port of brush_tpu/datasets/; reference: brush-dataset
+ colmap-reader crates).

COLMAP (binary + text) and NeRF-synthetic (transforms_*.json) loading from
zip archives or directories, PLY splat import/export, scene containers, and
a prefetching random-batch loader.
"""

from brush_tpu_torch.datasets.scene import Dataset, Scene, SceneView  # noqa: F401
from brush_tpu_torch.datasets.loading import (  # noqa: F401
    load_dataset,
    load_initial_splats,
)
