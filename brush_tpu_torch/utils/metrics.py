"""Training metrics / observability (a copy of brush_tpu/utils/metrics.py,
which imports nothing of JAX).

Metric names follow the reference's rerun stream (SURVEY.md §5.5,
brush-viewer/src/panels/rerun.rs): losses, PSNR/SSIM, per-group LRs, splat
counts, num_visible / num_intersections, refine stats. Sinks: console,
JSONL file, and the rerun SDK when it is importable (it is optional and not
baked into this image).
"""

from __future__ import annotations

import json
import sys
import time


class MetricsLogger:
    def __init__(self, jsonl_path: str | None = None, use_rerun: bool = False,
                 console_every: int = 50):
        if jsonl_path:
            import os

            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self.console_every = console_every
        self._t0 = time.time()
        self._last_console = 0
        self._window: list[tuple[float, int]] = []  # (time, step)
        self._rerun = None
        if use_rerun:
            try:
                import rerun as rr  # optional dependency

                rr.init("brush_tpu_torch", spawn=False)
                self._rerun = rr
            except Exception:
                print("rerun SDK unavailable; skipping", file=sys.stderr)

    def log(self, step: int, **scalars) -> None:
        now = time.time()
        self._window.append((now, step))
        self._window = self._window[-25:]  # 25-sample window (stats.rs:95)

        rec = {"step": step, "t": round(now - self._t0, 3), **{
            k: (float(v) if hasattr(v, "item") or isinstance(v, float) else v)
            for k, v in scalars.items()
        }}
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._rerun is not None:
            self._rerun.set_time_sequence("step", step)
            for k, v in scalars.items():
                try:
                    self._rerun.log(k, self._rerun.Scalar(float(v)))
                except Exception:
                    pass
        if step - self._last_console >= self.console_every:
            self._last_console = step
            print(f"[{rec['t']:9.1f}s] step {step}  " + "  ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k not in ("step", "t")
            ))

    def iters_per_sec(self) -> float:
        """Moving-window rate (reference: stats.rs iters/s, 25 samples)."""
        if len(self._window) < 2:
            return 0.0
        (t0, s0), (t1, s1) = self._window[0], self._window[-1]
        return (s1 - s0) / max(t1 - t0, 1e-9)

    def close(self) -> None:
        if self._file:
            self._file.close()
