#!/usr/bin/env python3
"""Harvest a trained model on a dataset's held-out views: the port's
counterpart of scripts/harvest_run.py and scripts/render_compare.py in one
script.

The model is a .ply or a checkpoint (.npz; its splats are also written
as PREFIX.ply). Every held-out view (the dataset's eval split, else its
train views) goes through eval_view at block size 512, the intersection
pool growing until no record drops; the script prints each view's PSNR
and SSIM and then "MEAN over N views: PSNR x.xxx SSIM x.xxxx" as
harvest_run.py does, and writes PREFIX_views.png: for the first
GRID_VIEWS views a row of render | ground truth | 4x the absolute error,
box-filtered by the integer factor that brings a row nearest to
ROW_HEIGHT pixels (a PNG by the port's encoder, so no Pillow is needed).
It exits non-zero if a view still dropped records after the pool's
growth.

    python3 scripts/torch_harvest.py DATASET MODEL.ply|CKPT.npz PREFIX \\
        [--device cuda] [--eval-split-every N]
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brush_tpu_torch.datasets import load_dataset  # noqa: E402
from brush_tpu_torch.datasets.loading import LoadDatasetArgs  # noqa: E402
from brush_tpu_torch.datasets.ply import (  # noqa: E402
    load_splats_from_ply, splats_to_ply,
)
from brush_tpu_torch.datasets.png import encode_png  # noqa: E402
from brush_tpu_torch.eval import eval_view  # noqa: E402
from brush_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402

BLOCK = 512   # scripts/harvest_run.py's eval block size
GRID_VIEWS, ROW_HEIGHT = 3, 280   # its grid: 3 views, rows of 280 pixels


def load_model(path: str, device):
    """(splats on device, checkpoint step or None) of a .ply or .npz."""
    if path.endswith(".ply"):
        with open(path, "rb") as f:
            return load_splats_from_ply(f.read(), device=device), None
    state, step, _, _ = load_checkpoint(path, device)
    return state.splats, step


def harvest(splats, views, block_size: int = BLOCK, keep: int = GRID_VIEWS):
    """eval_view of each (camera, gt image) in views, the pool carried
    from view to view as eval_stats carries it; returns the EvalViews and,
    for the first `keep` views, the float rows render | gt | 4x abs
    error."""
    evals, rows, pool = [], [], None
    for i, (cam, gt) in enumerate(views):
        ev = eval_view(splats, cam, gt, block_size=block_size,
                       keep_image=i < keep, pool=pool)
        pool = ev.pool if pool is None else max(pool, ev.pool)
        evals.append(ev)
        if i < keep:
            rgb = np.asarray(gt[..., :3], np.float32)
            err = np.abs(ev.rendered - rgb).mean(-1, keepdims=True)
            rows.append(np.concatenate(
                [np.clip(ev.rendered, 0, 1), rgb,
                 np.repeat(np.clip(err * 4, 0, 1), 3, -1)], axis=1))
    return evals, rows


def grid_image(rows) -> np.ndarray:
    """The rows stacked into one uint8 RGB image, box-filtered by the
    integer factor that brings a row nearest to ROW_HEIGHT pixels."""
    grid = np.concatenate(rows, axis=0)
    k = max(1, round(rows[0].shape[0] / ROW_HEIGHT))
    h, w = (grid.shape[0] // k) * k, (grid.shape[1] // k) * k
    grid = grid[:h, :w].reshape(h // k, k, w // k, k, 3).mean(axis=(1, 3))
    return (grid * 255).astype(np.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset")
    ap.add_argument("model", help=".ply or checkpoint .npz")
    ap.add_argument("prefix", help="writes PREFIX_views.png (and "
                    "PREFIX.ply from a checkpoint)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eval-split-every", type=int, default=None)
    args = ap.parse_args(argv)

    splats, step = load_model(args.model, args.device)
    print(f"model {args.model}: {splats.n_live} splats"
          + ("" if step is None else f", checkpoint step {step}"),
          flush=True)
    if step is not None:
        with open(f"{args.prefix}.ply", "wb") as f:
            f.write(splats_to_ply(splats))
        print(f"wrote {args.prefix}.ply", flush=True)
    ds = load_dataset(args.dataset,
                      LoadDatasetArgs(eval_split_every=args.eval_split_every))
    scene = ds.eval or ds.train
    t0 = time.perf_counter()
    evals, rows = harvest(splats, [(v.camera, v.image) for v in scene.views])
    for i, ev in enumerate(evals):
        print(f"view {i}: PSNR {ev.psnr:.3f} SSIM {ev.ssim:.4f}"
              + (f" ({ev.dropped} records DROPPED)" if ev.dropped else ""),
              flush=True)
    print(f"MEAN over {len(evals)} views: PSNR "
          f"{np.mean([e.psnr for e in evals]):.3f} SSIM "
          f"{np.mean([e.ssim for e in evals]):.4f}", flush=True)
    print(f"eval {time.perf_counter() - t0:.1f} s, final pool "
          f"{max(e.pool or 0 for e in evals) or 'default'}", flush=True)
    if rows:
        with open(f"{args.prefix}_views.png", "wb") as f:
            f.write(encode_png(grid_image(rows)))
        print(f"wrote {args.prefix}_views.png", flush=True)
    dropped = sum(e.dropped for e in evals)
    if dropped:
        print(f"{dropped} records dropped after pool growth: the scores "
              f"are of truncated renders", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
