#!/usr/bin/env python3
"""Where the time of one inference render goes, on an NVIDIA GPU.

Renders the bench scene of chip_smoke.py (1M random splats, SH degree 1,
1024x1024, pool 2162688) with brush_tpu_torch and prints:
  - the median over 10 runs of each pipeline stage, timed with CUDA events
    around the stage (record inputs, depth order, expand, tile sort +
    bins, rasterize_fwd, image assembly);
  - a torch.profiler table of device time by kernel over 5 renders, and the
    device's busy share of that window.
The full profiler table is written to OUT_DIR/torch_render_profile.txt
(default runs/).

    python3 scripts/torch_render_profile.py [OUT_DIR]
"""

import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from brush_tpu_torch.camera import Camera  # noqa: E402
from brush_tpu_torch.ops.cuda.expand import expand  # noqa: E402
from brush_tpu_torch.ops.cuda.rasterize_fwd import rasterize_fwd  # noqa: E402
from brush_tpu_torch.ops.pipeline import depth_order, tile_bins  # noqa: E402
from brush_tpu_torch.ops.rasterize_reference import camera_params  # noqa: E402
from brush_tpu_torch.render import (  # noqa: E402
    assemble_image, pool_size, record_inputs, render_splats,
)
from brush_tpu_torch.splats import from_random  # noqa: E402

N, SIZE, POOL, BLOCK = 1 << 20, 1024, 2162688, 512


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_render_profile: no CUDA device", file=sys.stderr)
        return 1
    splats = from_random(np.random.default_rng(0), [-3] * 3, [3] * 3,
                         count=N, sh_degree=1, capacity=N, device="cuda")
    cam = Camera(position=[0, 0, -8.0], rotation=[1, 0, 0, 0],
                 fov_x=np.pi / 2, fov_y=np.pi / 2)
    size = (SIZE, SIZE)
    cp = camera_params(cam, size, device="cuda")
    pool = pool_size(N, size, POOL, BLOCK)
    tiles = SIZE // 16
    args = (splats.means, splats.log_scales, splats.quats, splats.sh_coeffs,
            splats.raw_opacity, cp, size)

    def stages():
        rec = record_inputs(*args, active=splats.active_mask())
        yield "record_inputs"
        f5, u5, cum, total, _ = depth_order(rec.attrs9, rec.decode,
                                            rec.depth_key, pool)
        yield "depth_order"
        keys, recs = expand(f5, u5, cum, total, tiles, tiles * tiles, pool)
        yield "expand"
        packed, starts, ends = tile_bins(keys, recs, tiles * tiles)
        yield "tile_bins"
        img, _, _ = rasterize_fwd(packed, starts, ends, tiles)
        yield "rasterize_fwd"
        assemble_image(img, size, tiles, tiles)
        yield "assemble"

    times = {}
    for rep in range(12):
        ev = [torch.cuda.Event(enable_timing=True)]
        names = []
        ev[0].record()
        for name in stages():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev.append(e)
            names.append(name)
        torch.cuda.synchronize()
        if rep >= 2:
            for i, name in enumerate(names):
                times.setdefault(name, []).append(
                    ev[i].elapsed_time(ev[i + 1]))
    total = 0.0
    for name, ts in times.items():
        med = statistics.median(ts)
        total += med
        print(f"[stage] {name:14s} {med:8.3f} ms")
    print(f"[stage] {'sum':14s} {total:8.3f} ms")

    def render():
        return render_splats(*args, active=splats.active_mask(),
                             block_size=BLOCK, max_isects=POOL,
                             needs_grad=False)

    render()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # Device-side events only (the aten:: host ops carry their kernels'
    # time as well, which would count it twice).
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sorted((d for d in dev if d[1] > 0), key=lambda d: -d[1])
    busy = sum(d[1] for d in dev)
    print(f"[profile] 5 renders: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%)")
    for key, ms, count in dev[:15]:
        print(f"[profile] {ms / 5:9.3f} ms/render  x{count // 5:<4d} "
              f"{key[:90]}")
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "runs")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "torch_render_profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
