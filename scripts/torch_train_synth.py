#!/usr/bin/env python3
"""Train on a dataset with densification on and gate on the eval PSNR: the
port's counterpart of scripts/train_synth_tpu.py.

Random init of INIT_COUNT splats in the camera bounds (the CLI's rule),
padded to CAPACITY, the default TrainConfig, SplatTrainer with block size
BLOCK and a first intersection pool of 2^20, SceneLoader batches; every
100 steps a progress line (loss, live splats, steps/s), every EVAL_EVERY
steps the mean PSNR and SSIM over the held-out views (eval_stats), and at
the end the line "FINAL: PSNR p SSIM s splats n r it/s (t s train)". With
--min-psnr it exits non-zero when the final PSNR is below that value or
not finite.

    python3 scripts/torch_train_synth.py SOURCE [ITERS=1500] \\
        [CAPACITY=16384] [INIT_COUNT=2000] [EVAL_EVERY=500] [SH_DEGREE=1] \\
        [BLOCK=512] [--device cuda] [--min-psnr P]
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brush_tpu_torch.config import TrainConfig  # noqa: E402
from brush_tpu_torch.datasets import load_dataset  # noqa: E402
from brush_tpu_torch.datasets.loader import SceneLoader  # noqa: E402
from brush_tpu_torch.datasets.loading import LoadDatasetArgs  # noqa: E402
from brush_tpu_torch.eval import eval_stats  # noqa: E402
from brush_tpu_torch.splats import from_random  # noqa: E402
from brush_tpu_torch.train import SplatTrainer  # noqa: E402

FIRST_POOL = 1 << 20   # scripts/train_synth_tpu.py's trainer._isect_pool


def mean_eval(splats, views, block: int):
    evals = eval_stats(splats, views, block_size=block)
    return (float(np.mean([e.psnr for e in evals])),
            float(np.mean([e.ssim for e in evals])))


def train(source, iters=1500, capacity=16384, init_count=2000,
          eval_every=500, sh_degree=1, block=512, device="cuda") -> dict:
    """The run; returns {"psnr", "ssim", "splats", "it_s", "train_s",
    "evals": [(step, psnr, ssim)], "losses": {step: loss}}."""
    ds = load_dataset(source, LoadDatasetArgs(eval_split_every=8))
    print(f"{len(ds.train.views)} train / {len(ds.eval.views)} eval views, "
          f"{ds.train.views[0].image.shape}", flush=True)
    views = [(v.camera, v.image) for v in ds.eval.views]

    config = TrainConfig()
    _, extent = ds.train.bounds(0.0, 0.0)
    bext = float(np.linalg.norm(extent))
    c2, e2 = ds.train.bounds(bext * 0.25, bext)
    rng = np.random.default_rng(config.seed)
    splats = from_random(rng, c2 - e2, c2 + e2, count=init_count,
                         sh_degree=sh_degree, capacity=capacity,
                         device=device)
    trainer = SplatTrainer(config, raster_block_size=block)
    trainer._isect_pool = FIRST_POOL
    state = trainer.init_state(splats)
    loader = SceneLoader(ds.train, seed=config.seed)

    out = {"evals": [], "losses": {}}
    t_start = time.perf_counter()
    t0 = None
    try:
        for step in range(iters):
            state, stats = trainer.step(state, loader.next_batch())
            if step == 0:
                float(stats.loss)
                print(f"first step: {time.perf_counter() - t_start:.1f} s",
                      flush=True)
                t0 = time.perf_counter()
            if step % 100 == 0 and step > 0:
                loss = float(stats.loss)
                out["losses"][step] = loss
                print(f"step {step:5d} loss {loss:.5f} splats "
                      f"{state.splats.n_live} "
                      f"({step / (time.perf_counter() - t0):.2f} it/s)",
                      flush=True)
            if eval_every and step > 0 and step % eval_every == 0:
                psnr, ssim = mean_eval(state.splats, views, block)
                out["evals"].append((step, psnr, ssim))
                print(f"  eval PSNR {psnr:.2f} SSIM {ssim:.4f}", flush=True)
    finally:
        loader.close()

    psnr, ssim = mean_eval(state.splats, views, block)
    dt = time.perf_counter() - t0
    out.update(psnr=psnr, ssim=ssim, splats=state.splats.n_live,
               it_s=(iters - 1) / dt, train_s=dt)
    print(f"FINAL: PSNR {psnr:.2f} SSIM {ssim:.4f} splats "
          f"{state.splats.n_live} {out['it_s']:.2f} it/s ({dt:.0f}s train)",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source")
    for name, default in (("iters", 1500), ("capacity", 16384),
                          ("init_count", 2000), ("eval_every", 500),
                          ("sh_degree", 1), ("block", 512)):
        ap.add_argument(name, nargs="?", type=int, default=default)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--min-psnr", type=float, default=None)
    args = ap.parse_args(argv)
    out = train(args.source, args.iters, args.capacity, args.init_count,
                args.eval_every, args.sh_degree, args.block, args.device)
    if args.min_psnr is not None and not out["psnr"] >= args.min_psnr:
        print(f"FINAL PSNR {out['psnr']} below {args.min_psnr}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
