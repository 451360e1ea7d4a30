"""Command-line entry points: train / eval / render / view / train2d (port
of brush_tpu/cli.py). Usage:

    python -m brush_tpu_torch.cli train --source lego.zip --iters 30000 \
        --eval-split-every 8 --checkpoint-dir ckpts --export out.ply
    python -m brush_tpu_torch.cli render --ply out.ply --source lego.zip \
        --out r.png
    python -m brush_tpu_torch.cli eval --ply out.ply --source lego.zip
    python -m brush_tpu_torch.cli view --source lego.zip   # then a browser
    python -m brush_tpu_torch.cli --device cpu train2d --image photo.png

The flags and defaults are the JAX CLI's; its global `--platform` is
`--device` here (default cuda; without a card that raises, and
`--device cpu` runs the plain versions of the kernels). `train --cell
GWxGH` rasterizes in raster cells of GW x GH tiles, in training and in
its evals. `train --shard` and `train2d --shard` train over the ranks of
a process group (parallel/): torchrun's world, each rank on
cuda:LOCAL_RANK, where torchrun starts the command

    torchrun --nproc_per_node=N -m brush_tpu_torch.cli train --shard ...

and else a world of one process on the asked device. Every rank steps;
rank 0 alone prints, logs metrics, evaluates, checkpoints and exports,
from the state gathered over the ranks. `train --rerun` streams the
dataset cameras and, at each in-training eval, the splats, the eval
renders and the tile heatmaps to rerun where its SDK imports
(utils/rerun_viz.py). `view` serves the live viewer (viewer/): a .ply, or
a dataset trained in a background thread, on --device.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np


def _parse_cell(spec: str) -> tuple:
    """'2x2' -> (2, 2); raster-cell grouping spec (see render_splats)."""
    gw, gh = (int(v) for v in spec.lower().split("x"))
    return (gw, gh)


def _add_dataset_args(p):
    p.add_argument("--source", required=True, help="dataset zip or directory")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--max-resolution", type=int, default=None,
                   help="downscale larger images (Pillow's LANCZOS; needs "
                        "Pillow)")
    p.add_argument("--eval-split-every", type=int, default=None)


def _load(args, verbose: bool = True):
    from brush_tpu_torch.datasets import load_dataset
    from brush_tpu_torch.datasets.loading import LoadDatasetArgs

    ds = load_dataset(
        args.source,
        LoadDatasetArgs(
            max_frames=args.max_frames,
            max_resolution=args.max_resolution,
            eval_split_every=args.eval_split_every,
        ),
    )
    if verbose:
        print(f"dataset: {len(ds.train.views)} train views"
              + (f", {len(ds.eval.views)} eval views" if ds.eval else ""))
    return ds


@contextlib.contextmanager
def _ranks(args):
    """(mesh or None, this rank's device, whether this rank is rank 0) of
    a train command: with --shard the ranks of the process group
    (parallel.multihost.process_group), else one device."""
    if not args.shard:
        yield None, args.device, True
        return
    from brush_tpu_torch.parallel import make_mesh, multihost

    with multihost.process_group(args.device) as dev:
        mesh = make_mesh(dev)
        if mesh.rank == 0:
            print(f"sharded training over {mesh.size} ranks")
        yield mesh, dev, mesh.rank == 0


def cmd_train(args):
    with _ranks(args) as (mesh, dev, coord):
        _train(args, mesh, dev, coord)


def _train(args, mesh, dev, coord: bool):
    import torch

    from brush_tpu_torch.config import TrainConfig
    from brush_tpu_torch.datasets import load_initial_splats
    from brush_tpu_torch.datasets.loader import SceneLoader
    from brush_tpu_torch.datasets.ply import splats_to_ply
    from brush_tpu_torch.eval import eval_stats
    from brush_tpu_torch.splats import from_random
    from brush_tpu_torch.train import SplatTrainer
    from brush_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    from brush_tpu_torch.utils.metrics import MetricsLogger

    log = print if coord else (lambda *a, **k: None)
    ds = _load(args, coord)
    config = TrainConfig(
        densify_grad_thresh=args.densify_grad_thresh,
        refine_every=args.refine_every,
        faithful_split_bug=args.faithful_reference_refine,
        keep_opt_state_on_refine=not args.faithful_reference_refine,
    )

    splats = load_initial_splats(args.source, sh_degree=args.sh_degree,
                                 device=dev)
    if splats is None:
        # Random init inside camera bounds (train_loop.rs:80-92).
        center, extent = ds.train.bounds(0.0, 0.0)
        bounds_extent = float(np.linalg.norm(extent))
        c2, e2 = ds.train.bounds(bounds_extent * 0.25, bounds_extent)
        rng = np.random.default_rng(config.seed)
        splats = from_random(
            rng, c2 - e2, c2 + e2, count=args.init_count,
            sh_degree=args.sh_degree, device=dev,
        )
        log(f"random init: {splats.n_live} splats in camera bounds")
    else:
        log(f"point-cloud init: {splats.n_live} splats")

    kw = dict(raster_block_size=args.block_size,
              raster_cell=_parse_cell(args.cell),
              pack_grad_sort=args.pack_grad_sort)
    if mesh is None:
        trainer = SplatTrainer(config, **kw)
        whole = lambda st: st
    else:
        from brush_tpu_torch.parallel import ShardedTrainer
        from brush_tpu_torch.parallel.sharding import (
            gather_state, shard_state,
        )

        trainer = ShardedTrainer(mesh, config, **kw)
        whole = lambda st: gather_state(st, mesh)
    state = trainer.init_state(splats)
    start_step = 0
    if args.resume:
        state, start_step, gen_state, _ = load_checkpoint(args.resume, dev)
        if mesh is not None:
            state = shard_state(state, mesh)
        if gen_state is not None:
            trainer._generator = torch.Generator(device=dev)
            trainer._generator.set_state(gen_state)
        trainer.iter = start_step
        log(f"resumed from {args.resume} at step {start_step}")

    loader = SceneLoader(ds.train, seed=config.seed)
    metrics = MetricsLogger(
        jsonl_path=os.path.join(args.checkpoint_dir, "metrics.jsonl")
        if args.checkpoint_dir and coord else None,
        use_rerun=args.rerun and coord,
    )
    viz = None
    if args.rerun and coord:
        from brush_tpu_torch.utils.rerun_viz import RerunVisualizer

        viz = RerunVisualizer()
        if viz.active:
            viz.log_dataset(ds.train)

    try:
        for step in range(start_step, args.iters):
            batch = loader.next_batch()
            state, stats = trainer.step(state, batch)

            if coord and step % args.log_every == 0:
                metrics.log(
                    step,
                    loss=float(stats.loss),
                    num_visible=int(stats.num_visible),
                    num_isects=int(stats.num_isects),
                    num_dropped=int(stats.num_dropped),
                    splats=int(state.splats.n_live),
                    iters_per_s=metrics.iters_per_sec(),
                    lr_mean=config.lr_mean_at(step) * batch.scene_extent,
                )
            if coord and trainer.last_refine_stats is not None:
                rs = trainer.last_refine_stats
                metrics.log(
                    step,
                    refine_cloned=int(rs.num_cloned),
                    refine_split=int(rs.num_split),
                    refine_pruned_alpha=int(rs.num_pruned_alpha),
                    refine_pruned_scale=int(rs.num_pruned_scale),
                )

            if args.eval_every and ds.eval and step > 0 and step % args.eval_every == 0:
                # 0 = the full held-out set (the default); a positive
                # value evaluates a fixed prefix of it.
                k = args.eval_views if args.eval_views > 0 else None
                views = [(v.camera, v.image) for v in ds.eval.views[:k]]
                splats_w = whole(state).splats
                if coord:
                    show = viz is not None and viz.active
                    evals = eval_stats(splats_w, views,
                                       block_size=args.block_size,
                                       keep_images=show,
                                       cell=trainer.raster_cell)
                    psnr = float(np.mean([e.psnr for e in evals]))
                    ssim = float(np.mean([e.ssim for e in evals]))
                    metrics.log(step, eval_psnr=psnr, eval_ssim=ssim)
                    if show:
                        viz.log_splats(step, splats_w)
                        for i, ((c, gt), ev) in enumerate(zip(views, evals)):
                            viz.log_eval(step, i, ev.rendered, gt, ev.psnr)
                        c0, gt0 = views[0]
                        viz.log_tile_heatmaps(
                            step, splats_w, c0,
                            (gt0.shape[1], gt0.shape[0]),
                        )

            if args.checkpoint_dir and step > 0 and step % args.checkpoint_every == 0:
                path = os.path.join(args.checkpoint_dir, f"ckpt_{step:07d}.npz")
                state_w = whole(state)
                if coord:
                    save_checkpoint(path, state_w, trainer.iter,
                                    trainer._generator, config)
                    print(f"checkpointed {path}")
    finally:
        loader.close()
    log(f"gt cache: {trainer.gt_cache_hits} hits, "
        f"{len(trainer._gt_cache)} views, {trainer._gt_cache_bytes} bytes")

    state = whole(state)
    if not coord:
        return
    if ds.eval:
        views = [(v.camera, v.image) for v in ds.eval.views]
        evals = eval_stats(state.splats, views, block_size=args.block_size,
                           cell=trainer.raster_cell)
        print(f"final eval: PSNR {np.mean([e.psnr for e in evals]):.3f} "
              f"SSIM {np.mean([e.ssim for e in evals]):.4f}")

    if args.checkpoint_dir:
        path = os.path.join(args.checkpoint_dir, "ckpt_final.npz")
        save_checkpoint(path, state, trainer.iter, trainer._generator, config)
        print(f"saved {path}")
    if args.export:
        with open(args.export, "wb") as f:
            f.write(splats_to_ply(state.splats))
        print(f"exported {args.export} ({state.splats.n_live} splats)")
    metrics.close()


def _load_splats_for_inference(args):
    from brush_tpu_torch.datasets.ply import load_splats_from_ply
    from brush_tpu_torch.utils.checkpoint import load_checkpoint

    if args.ply:
        with open(args.ply, "rb") as f:
            return load_splats_from_ply(f.read(), device=args.device)
    state, _, _, _ = load_checkpoint(args.ckpt, args.device)
    return state.splats


def cmd_eval(args):
    from brush_tpu_torch.eval import eval_stats

    ds = _load(args)
    scene = ds.eval or ds.train
    splats = _load_splats_for_inference(args)
    views = [(v.camera, v.image) for v in scene.views]
    evals = eval_stats(splats, views, block_size=args.block_size)
    for i, e in enumerate(evals):
        print(f"view {i:3d}: PSNR {e.psnr:.3f}  SSIM {e.ssim:.4f}")
    print(f"mean: PSNR {np.mean([e.psnr for e in evals]):.3f} "
          f"SSIM {np.mean([e.ssim for e in evals]):.4f}")


def _write_rgba_png(path: str, img) -> None:
    """A float (H, W, 4) image in [0, 1] as an 8-bit RGBA PNG."""
    from brush_tpu_torch.datasets.png import encode_png

    rgba = np.clip(img.detach().cpu().numpy() * 255, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(rgba))


def cmd_render(args):
    from brush_tpu_torch.ops.rasterize_reference import camera_params
    from brush_tpu_torch.render import render_splats

    ds = _load(args)
    scene = ds.train
    splats = _load_splats_for_inference(args)
    view = scene.views[args.view]
    h, w = view.image.shape[:2]
    cam = camera_params(view.camera, (w, h), device=splats.device)
    t0 = time.time()
    # One-shot render: grow the intersection pool until nothing drops
    # (close-up cameras can cover far more tiles/splat than the default).
    max_isects = None
    for _ in range(4):
        img, aux = render_splats(
            splats.means, splats.log_scales, splats.quats, splats.sh_coeffs,
            splats.raw_opacity, cam, (w, h), active=splats.active_mask(),
            block_size=args.block_size, max_isects=max_isects,
            needs_grad=False,
        )
        dropped = int(aux.num_dropped)
        if dropped == 0:
            break
        max_isects = 2 * (int(aux.num_isects) + dropped)
        print(f"pool overflow ({dropped} records dropped) — retrying with "
              f"max_isects={max_isects}")
    if dropped > 0:
        print(f"WARNING: {dropped} records still dropped after pool growth; "
              "the output image is TRUNCATED (far geometry missing)")
    print(f"rendered {w}x{h} in {time.time()-t0:.2f}s "
          f"(visible={int(aux.num_visible)}, isects={int(aux.num_isects)})")
    _write_rgba_png(args.out, img)
    print(f"wrote {args.out}")


def train2d_target(data: bytes, size: int | None) -> np.ndarray:
    """train2d's target from an image file's bytes: its RGB as float32 in
    [0, 1], resized to (size, size) by Pillow's `Image.resize` as in the
    reference (brush_tpu/cli.py:277-280). Only the resize needs Pillow."""
    from brush_tpu_torch.datasets.loading import _decode_image

    target = np.ascontiguousarray(_decode_image(data, None)[..., :3])
    if not size:
        return target
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("train2d --size resizes with Pillow, which is not "
                          "installed") from e
    u8 = np.round(target * 255.0).astype(np.uint8)
    return np.asarray(Image.fromarray(u8, "RGB").resize((size, size)),
                      np.float32) / 255.0


def cmd_train2d(args):
    """Fit gaussians to one image with a fixed camera (reference: the
    train-2d toy crate, train-2d/src/main.rs:36-92,185-222)."""
    with _ranks(args) as (mesh, dev, coord):
        _train2d(args, mesh, dev, coord)


def _train2d(args, mesh, dev, coord: bool):
    from brush_tpu_torch.camera import Camera, focal_to_fov
    from brush_tpu_torch.config import TrainConfig
    from brush_tpu_torch.eval import eval_view
    from brush_tpu_torch.splats import from_random
    from brush_tpu_torch.train import SceneBatch, SplatTrainer

    with open(args.image, "rb") as f:
        target = train2d_target(f.read(), args.size)
    h, w = target.shape[:2]

    # train-2d/main.rs:219-222: warmup 100, refine forever, no alpha reset.
    config = TrainConfig(
        warmup_steps=100, max_refine_step=10**9,
        reset_alpha_every_refine=10**9, refine_every=args.refine_every,
        lr_mean=1.5e-4, lr_mean_decay_target=1.0,
        scale_mean_lr_by_extent=False,
    )
    fov = focal_to_fov(float(max(w, h)), max(w, h))
    cam = Camera(position=[0, 0, -8.0], rotation=[1, 0, 0, 0],
                 fov_x=fov, fov_y=fov)
    rng = np.random.default_rng(config.seed)
    splats = from_random(rng, [-2.5, -2.5, -2.5], [2.5, 2.5, 2.5],
                         count=args.init_count, sh_degree=0, device=dev)
    if mesh is None:
        trainer = SplatTrainer(config, raster_block_size=args.block_size)
    else:
        from brush_tpu_torch.parallel import ShardedTrainer

        trainer = ShardedTrainer(mesh, config,
                                 raster_block_size=args.block_size)
    state = trainer.init_state(splats)
    batch = SceneBatch(gt_image=target, camera=cam, scene_extent=1.0)

    t0 = time.time()
    for step in range(args.iters):
        state, stats = trainer.step(state, batch)
        if coord and step % args.log_every == 0:
            print(f"step {step:5d} loss {float(stats.loss):.5f} "
                  f"splats {state.splats.n_live} "
                  f"({(step + 1) / (time.time() - t0):.1f} it/s)")

    if mesh is not None:
        from brush_tpu_torch.parallel.sharding import gather_state

        state = gather_state(state, mesh)
    if not coord:
        return
    ev = eval_view(state.splats, cam, target, block_size=args.block_size)
    print(f"final PSNR {ev.psnr:.2f} SSIM {ev.ssim:.4f} "
          f"splats {state.splats.n_live}")
    if args.out:
        from brush_tpu_torch.ops.rasterize_reference import camera_params
        from brush_tpu_torch.render import render_splats

        s = state.splats
        cp = camera_params(cam, (w, h), device=s.device)
        img_r, _ = render_splats(
            s.means, s.log_scales, s.quats, s.sh_coeffs, s.raw_opacity,
            cp, (w, h), active=s.active_mask(), block_size=args.block_size,
            needs_grad=False,
        )
        _write_rgba_png(args.out, img_r)
        print(f"wrote {args.out}")


def cmd_view(args):
    from brush_tpu_torch.viewer import run_viewer

    run_viewer(
        source=args.source, ply=args.ply, train=not args.no_train,
        port=args.port, sh_degree=args.sh_degree,
        init_count=args.init_count, block_size=args.block_size,
        max_resolution=args.max_resolution,
        eval_split_every=args.eval_split_every,
        cell=_parse_cell(args.cell), device=args.device,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="brush_tpu_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain "
                         "versions of the kernels)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a splat model on a dataset")
    _add_dataset_args(t)
    t.add_argument("--iters", type=int, default=30000)
    t.add_argument("--sh-degree", type=int, default=3)
    t.add_argument("--init-count", type=int, default=10000)
    t.add_argument("--block-size", type=int, default=512)
    t.add_argument("--cell", default="1x1",
                   help="raster-cell grouping GWxGH, e.g. 2x2: one record "
                        "per splat per cell of tiles")
    t.add_argument("--densify-grad-thresh", type=float, default=2e-4)
    t.add_argument("--refine-every", type=int, default=100)
    t.add_argument("--faithful-reference-refine", action="store_true",
                   help="replicate the reference's refine quirks exactly")
    t.add_argument("--pack-grad-sort", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="backward grad re-sort carries conic/color "
                        "cotangents as bf16 pairs (7 instead of 10 "
                        "pool-scale payload rows); --no-pack-grad-sort "
                        "keeps exact f32 cotangents")
    t.add_argument("--shard", action="store_true",
                   help="shard training over the ranks of a process group "
                        "(torchrun's, else one process)")
    t.add_argument("--eval-every", type=int, default=0)
    t.add_argument("--eval-views", type=int, default=0,
                   help="views per in-training eval (0 = all)")
    t.add_argument("--log-every", type=int, default=10)
    t.add_argument("--checkpoint-dir", default=None)
    t.add_argument("--checkpoint-every", type=int, default=5000)
    t.add_argument("--resume", default=None)
    t.add_argument("--export", default=None, help="write a .ply at the end")
    t.add_argument("--rerun", action="store_true",
                   help="stream scalars, splats, eval renders and tile "
                        "heatmaps to rerun (where its SDK imports)")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="PSNR/SSIM of a model on a dataset")
    _add_dataset_args(e)
    e.add_argument("--ply", default=None)
    e.add_argument("--ckpt", default=None)
    e.add_argument("--block-size", type=int, default=512)
    e.set_defaults(fn=cmd_eval)

    r = sub.add_parser("render", help="render one dataset view to a PNG")
    _add_dataset_args(r)
    r.add_argument("--ply", default=None)
    r.add_argument("--ckpt", default=None)
    r.add_argument("--view", type=int, default=0)
    r.add_argument("--out", default="render.png")
    r.add_argument("--block-size", type=int, default=512)
    r.set_defaults(fn=cmd_render)

    v = sub.add_parser("view", help="live web viewer (optionally training)")
    v.add_argument("--source", default=None, help="dataset zip or directory")
    v.add_argument("--ply", default=None, help="view an exported .ply")
    v.add_argument("--no-train", action="store_true")
    v.add_argument("--port", type=int, default=8642)
    v.add_argument("--sh-degree", type=int, default=3)
    v.add_argument("--init-count", type=int, default=10000)
    v.add_argument("--block-size", type=int, default=512)
    v.add_argument("--cell", default="1x1",
                   help="raster-cell grouping GWxGH of every render")
    v.add_argument("--max-resolution", type=int, default=None)
    v.add_argument("--eval-split-every", type=int, default=None)
    v.set_defaults(fn=cmd_view)

    t2 = sub.add_parser("train2d", help="toy: fit gaussians to one image")
    t2.add_argument("--image", required=True)
    t2.add_argument("--size", type=int, default=None, help="resize square")
    t2.add_argument("--iters", type=int, default=2000)
    t2.add_argument("--init-count", type=int, default=32)
    t2.add_argument("--refine-every", type=int, default=150)
    t2.add_argument("--block-size", type=int, default=64)
    t2.add_argument("--log-every", type=int, default=50)
    t2.add_argument("--out", default=None, help="write final render PNG")
    t2.add_argument("--shard", action="store_true",
                    help="shard training over the ranks of a process group "
                         "(torchrun's, else one process)")
    t2.set_defaults(fn=cmd_train2d)

    args = ap.parse_args(argv)
    from brush_tpu_torch.device import resolve_device

    args.device = resolve_device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
