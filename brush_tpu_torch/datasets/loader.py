"""Infinite random-view batch loader with background prefetch (port of
brush_tpu/datasets/loader.py).

Mirrors reference/brush-dataset/src/scene_loader.rs: uniform random view per
step, a bounded prefetch queue of 5 batches, and the scene extent attached
to every batch for LR scaling. Each batch holds the view's own image
array, never a copy: the trainer keeps one device copy of each ground
truth, keyed by the array's identity (train.SplatTrainer._gt_on_device).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from brush_tpu_torch.datasets.scene import Scene
from brush_tpu_torch.train import SceneBatch

PREFETCH = 5  # scene_loader.rs:19


class SceneLoader:
    def __init__(self, scene: Scene, seed: int = 42, prefetch: int = PREFETCH):
        if not scene.views:
            # rng.integers(0) would kill the daemon thread silently and the
            # first next_batch() would then block forever.
            raise ValueError(
                "SceneLoader: scene has no views (did eval_split_every "
                "move every view into the eval split?)"
            )
        self.scene = scene
        self.extent = scene.extent_max()
        self._rng = np.random.default_rng(seed)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            idx = int(self._rng.integers(len(self.scene.views)))
            view = self.scene.views[idx]
            batch = SceneBatch(
                gt_image=view.image, camera=view.camera, scene_extent=self.extent
            )
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.25)
                    break
                except queue.Full:
                    continue

    def next_batch(self) -> SceneBatch:
        return self._queue.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
