#!/usr/bin/env python3
"""Whether a profiler trace slows the training steps that follow it in the
same process (ROADMAP Queue 3 #17).

Writes the ray-traced castle (datasets/raytrace.py, NeRF layout, N_TRAIN +
2 views at 800x800) into a temporary directory, then in one process: `cli
train` for STEPS steps (docs/RESULTS.md's flags), the median step between
two CUDA events over all but the first 50; then, unless --no-trace,
utils/profiler.trace around one render of the trained model's first view;
then the same `cli train` again. The user's step on this scene is bound by
the host's kernel launches, so whatever CUPTI leaves attached after a trace
shows in the second median. Prints both medians and the card's name and
power limit.

    python3 scripts/torch_trace_overhead.py [--steps 400] [--no-trace]
"""

import argparse
import contextlib
import io
import os
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brush_tpu_torch import cli, train  # noqa: E402
from brush_tpu_torch.datasets import load_dataset  # noqa: E402
from brush_tpu_torch.datasets import raytrace  # noqa: E402
from brush_tpu_torch.datasets.ply import load_splats_from_ply  # noqa: E402
from brush_tpu_torch.ops.rasterize_reference import camera_params  # noqa: E402
from brush_tpu_torch.render import render_splats  # noqa: E402
from brush_tpu_torch.utils import profiler  # noqa: E402

N_TRAIN, SKIP = 20, 50


def train_median(src: str, steps: int, export: str) -> float:
    """Median CUDA-event ms of the steps of one in-process `cli train`,
    its first SKIP steps left out; the model is exported to `export`."""
    events = []
    step = train.SplatTrainer.step

    def timed(self, *args, **kwargs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = step(self, *args, **kwargs)
        ev[1].record()
        events.append(ev)
        return out

    train.SplatTrainer.step = timed
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["--device", "cuda", "train", "--source", src,
                      "--iters", str(steps), "--sh-degree", "3",
                      "--init-count", "32768", "--block-size", "512",
                      "--export", export])
    finally:
        train.SplatTrainer.step = step
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events[SKIP:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--no-trace", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_trace_overhead: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="brush_trace_overhead_") as d:
        src = os.path.join(d, "castle.zip")
        raytrace.write_nerf_scene(src, raytrace.build_scene(), N_TRAIN, 2,
                                  800)
        ply = os.path.join(d, "model.ply")
        before = train_median(src, args.steps, ply)
        if not args.no_trace:
            with open(ply, "rb") as f:
                splats = load_splats_from_ply(f.read())
            view = load_dataset(src).train.views[0]
            size = (view.image.shape[1], view.image.shape[0])
            cp = camera_params(view.camera, size, device="cuda")
            with profiler.trace(os.path.join(d, "trace")):
                render_splats(splats.means, splats.log_scales, splats.quats,
                              splats.sh_coeffs, splats.raw_opacity, cp, size,
                              active=splats.active_mask(), needs_grad=False)
                torch.cuda.synchronize()
        after = train_median(src, args.steps, ply)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    what = "no trace" if args.no_trace else "a profiler.trace"
    print(f"median step over {args.steps - SKIP} steps: before "
          f"{before:.3f} ms, after {what} {after:.3f} ms "
          f"({after / before:.3f}x); {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
