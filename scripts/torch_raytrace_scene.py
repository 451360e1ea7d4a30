#!/usr/bin/env python3
"""Write the ray-traced castle as a dataset: the port's counterpart of
scripts/raytrace_scene.py, with its arguments.

The scene and the tracer are brush_tpu_torch/datasets/raytrace.py (float64
torch on --device, the card by default). Without --colmap: a NeRF-synthetic
zip, N_TRAIN views on the orbit of seed 1 and N_VAL of seed 2, SIZE x SIZE
RGBA PNGs. With --colmap: a binary COLMAP zip of N_TRAIN views composited
on white (PNG, where the JAX script writes JPEG) and 12,000 surface points;
N_VAL is ignored, as the JAX script ignores it. Prints the seconds of the
trace and of the PNG encode.

    python3 scripts/torch_raytrace_scene.py OUT.zip [N_TRAIN=100] [N_VAL=16] \\
        [SIZE=800] [--colmap] [--device cuda]
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brush_tpu_torch.datasets import raytrace  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="castle.zip")
    ap.add_argument("n_train", nargs="?", type=int, default=100)
    ap.add_argument("n_val", nargs="?", type=int, default=16)
    ap.add_argument("size", nargs="?", type=int, default=800)
    ap.add_argument("--colmap", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    scene = raytrace.build_scene()
    if args.colmap:
        secs = raytrace.write_colmap_scene(args.out, scene, args.n_train,
                                           args.size, device=args.device)
        what = f"COLMAP, {args.n_train} views"
    else:
        secs = raytrace.write_nerf_scene(args.out, scene, args.n_train,
                                         args.n_val, args.size,
                                         device=args.device)
        what = f"NeRF, {args.n_train} + {args.n_val} views"
    print(f"wrote {args.out} ({what}, {args.size}x{args.size}, "
          f"{os.path.getsize(args.out)} bytes): trace {secs['trace_s']:.2f} "
          f"s on {args.device}, PNG encode {secs['encode_s']:.2f} s, all "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
