"""brush_tpu_torch — the PyTorch + CUDA port of brush_tpu for NVIDIA Hopper.

The package mirrors brush_tpu's layout module for module. Plain tensor
code is PyTorch; every Pallas TPU kernel on a ported path is a CUDA C++
kernel under csrc/, built at first use (ops/cuda/build.py), with a plain
PyTorch version beside it that CPU tensors take.

Ported: the render and evaluation path (slice 1) — projection, SH
colour, tile masks, the record pipeline with the expand and rasterize_fwd
kernels, SSIM/PSNR evaluation and PLY import — training (slice 2): the
differentiable record pipeline with the rasterize_bwd and segment_sum
kernels, the L1 + SSIM loss, per-group Adam and SplatTrainer with refine —
and the user's path (slice 5): the datasets (NeRF-synthetic and COLMAP
from zips or directories, with a PNG codec of its own so no Pillow is
needed for 8-bit PNGs), the random-view loader, checkpoints that load in
either package, PLY export, safetensors import, the native points3D
parser and PNG unfilter, the metrics log and the cli (train, eval, render,
train2d) — raster cells (slice 6): cell=(gw, gh) on every render, the
trainer, the evaluation and `train --cell` — sharded training (slice 7):
parallel/ over torch.distributed, the strip mode of both rasterizers,
`train --shard` and `train2d --shard` — and the viewer and the debug
streams (slice 8): viewer/ (the HTTP viewer with its training worker) and
`cli view`, utils/rerun_viz.py and `train --rerun`, and the profiler's
trace and span. The port now does all that brush_tpu does.

The package imports torch and numpy only: never jax, never brush_tpu.
Loaders and constructors default to device="cuda" and raise when CUDA is
absent; tests pass device="cpu".
"""

__version__ = "0.1.0"

from brush_tpu_torch.camera import Camera  # noqa: F401
from brush_tpu_torch.splats import Splats  # noqa: F401
