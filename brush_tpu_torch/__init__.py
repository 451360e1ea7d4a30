"""brush_tpu_torch — the PyTorch + CUDA port of brush_tpu for NVIDIA Hopper.

The package mirrors brush_tpu's layout module for module. Plain tensor
code is PyTorch; every Pallas TPU kernel on a ported path is a CUDA C++
kernel under csrc/, built at first use (ops/cuda/build.py), with a plain
PyTorch version beside it that CPU tensors take.

Ported so far: the render and evaluation path (slice 1) — projection, SH
colour, tile masks, the record pipeline with the expand and rasterize_fwd
kernels, SSIM/PSNR evaluation and PLY import — training (slice 2): the
differentiable record pipeline with the rasterize_bwd and segment_sum
kernels, the L1 + SSIM loss, per-group Adam and SplatTrainer with refine —
and the user's path (slice 5): the datasets (NeRF-synthetic and COLMAP
from zips or directories, with a PNG codec of its own so no Pillow is
needed for 8-bit PNGs), the random-view loader, checkpoints that load in
either package, PLY export, safetensors import, the native points3D
parser and PNG unfilter, the metrics log and the cli (train, eval, render,
train2d).

The package imports torch and numpy only: never jax, never brush_tpu.
Loaders and constructors default to device="cuda" and raise when CUDA is
absent; tests pass device="cpu".
"""

__version__ = "0.1.0"

from brush_tpu_torch.camera import Camera  # noqa: F401
from brush_tpu_torch.splats import Splats  # noqa: F401
