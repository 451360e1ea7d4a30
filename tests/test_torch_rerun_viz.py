"""The port's rerun streams (brush_tpu_torch/utils/rerun_viz.py) against
brush_tpu's, through a recording stub `rerun` module (the SDK is optional
and not installed): the four streams reach the sink, the visualizer is
inert without the SDK, every array equals the JAX package's on the same
model and scene, the tile heatmaps from the port's record pipeline equal
those from brush_tpu's build_intersections, and `cli train --rerun`
streams all four without changing a loss."""

import contextlib
import io
import json
import os
import sys
import types

import numpy as np
import pytest

from brush_tpu.camera import Camera as JCamera
from brush_tpu.datasets.scene import Scene as JScene
from brush_tpu.datasets.scene import SceneView as JSceneView
from brush_tpu.splats import from_random as j_from_random

from brush_tpu_torch import cli
from brush_tpu_torch.camera import Camera
from brush_tpu_torch.convert import splats_from_numpy
from brush_tpu_torch.datasets import testing as dt
from brush_tpu_torch.datasets.scene import Scene, SceneView
from torch_threads import pin_threads

pin_threads()

KINDS = ("Points3D", "Image", "DepthImage", "Pinhole", "Transform3D",
         "Scalar")
CAM = dict(position=[0, 0, -3.0], rotation=[1, 0, 0, 0], fov_x=1.0,
           fov_y=0.8)


class _Recorder:
    """The rerun SDK's surface as the visualizers use it; log() keeps each
    call's path, entity kind, arguments and keyword arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name in KINDS:
            return lambda *a, **k: (name, a, k)
        if name in ("init", "set_time_sequence"):
            return lambda *a, **k: None
        if name == "log":
            return lambda path, entity, **k: self.calls.append(
                (path, *entity))
        raise AttributeError(name)

    def take(self):
        out, self.calls = self.calls, []
        return out


@pytest.fixture
def stub_rerun(monkeypatch):
    rec = _Recorder()
    mod = types.ModuleType("rerun")
    mod.__getattr__ = rec.__getattr__
    monkeypatch.setitem(sys.modules, "rerun", mod)
    yield rec


def _visualizers():
    from brush_tpu.utils.rerun_viz import RerunVisualizer as JViz
    from brush_tpu_torch.utils.rerun_viz import RerunVisualizer

    return JViz(), RerunVisualizer()


def _models(count=64, sh_degree=1, seed=0):
    js = j_from_random(np.random.default_rng(seed), [-1, -1, -1], [1, 1, 1],
                       count=count, sh_degree=sh_degree)
    ts = splats_from_numpy({k: np.asarray(v) for k, v in js.params().items()},
                           int(js.n_live), device="cpu")
    return js, ts


def _assert_same_calls(got, want, rtol=0.0, atol=1e-6):
    """Same paths and kinds in the same order; every array and number of
    the calls within atol (+ rtol relative)."""
    assert [c[:2] for c in got] == [c[:2] for c in want]
    for (path, _, a_got, k_got), (_, _, a_want, k_want) in zip(got, want):
        assert sorted(k_got) == sorted(k_want), path
        pairs = list(zip(a_got, a_want)) + [(k_got[k], k_want[k])
                                            for k in k_want]
        for g, w in pairs:
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, path
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=path)


def test_streams_reach_the_sink(stub_rerun):
    from brush_tpu_torch.utils.rerun_viz import RerunVisualizer

    viz = RerunVisualizer()
    assert viz.active
    _, splats = _models(count=32)
    viz.log_splats(5, splats)
    cam = Camera(position=[0, 0, -5.0], rotation=[1, 0, 0, 0], fov_x=1.0,
                 fov_y=1.0)
    img = np.random.default_rng(0).uniform(0, 1, (32, 48, 3)).astype(
        np.float32)
    viz.log_dataset(Scene(views=[SceneView(camera=cam, image=img,
                                           name="v0")]))
    viz.log_eval(5, 0, img, img, psnr=31.4)
    viz.log_tile_heatmaps(5, splats, cam, (48, 32), max_isects=4096)

    kinds = {c[1] for c in stub_rerun.calls}
    paths = {c[0] for c in stub_rerun.calls}
    assert {"Points3D", "Pinhole", "Transform3D", "Image", "DepthImage",
            "Scalar"} <= kinds
    assert any(p.startswith("eval/") for p in paths)
    assert {"debug/tile_isect_counts", "debug/tile_mean_depth"} <= paths


def test_inactive_without_sdk(monkeypatch):
    monkeypatch.setitem(sys.modules, "rerun", None)
    from brush_tpu_torch.utils.rerun_viz import RerunVisualizer

    viz = RerunVisualizer()
    assert not viz.active
    # Every stream is a safe no-op.
    _, splats = _models(count=8)
    viz.log_splats(0, splats)
    viz.log_eval(0, 0, np.zeros((8, 8, 3)), np.zeros((8, 8, 3)), 0.0)
    viz.log_tile_heatmaps(0, splats, Camera(**CAM), (16, 16))
    viz.log_dataset(Scene(views=[]))


@pytest.mark.parametrize("max_points", [200_000, 20])
def test_log_splats_matches_reference(stub_rerun, max_points):
    """Points, SH-DC colours with sigmoid opacity, and mean-scale radii;
    max_points=20 subsamples the 64 live splats by linspace."""
    jviz, viz = _visualizers()
    js, ts = _models(count=64)
    jviz.log_splats(3, js, max_points=max_points)
    want = stub_rerun.take()
    viz.log_splats(3, ts, max_points=max_points)
    got = stub_rerun.take()
    assert len(got[0][2][0]) == min(max_points, 64)
    _assert_same_calls(got, want)


def test_log_dataset_and_eval_match_reference(stub_rerun):
    jviz, viz = _visualizers()
    rng = np.random.default_rng(1)
    poses = [([0.5, -0.2, -4.0], [0.9, 0.1, -0.3, 0.2]),
             ([-1.0, 0.3, -3.0], [1.0, 0.0, 0.0, 0.0])]
    imgs = [rng.uniform(0, 1, (24, 40, 3)).astype(np.float32)
            for _ in poses]
    jviz.log_dataset(JScene(views=[
        JSceneView(name=f"v{i}", camera=JCamera(position=p, rotation=q,
                                                fov_x=0.9, fov_y=0.6),
                   image=im) for i, ((p, q), im) in enumerate(zip(poses,
                                                                  imgs))]))
    want = stub_rerun.take()
    viz.log_dataset(Scene(views=[
        SceneView(name=f"v{i}", camera=Camera(position=p, rotation=q,
                                              fov_x=0.9, fov_y=0.6),
                  image=im) for i, ((p, q), im) in enumerate(zip(poses,
                                                                 imgs))]))
    got = stub_rerun.take()
    assert [c[1] for c in got] == ["Transform3D", "Pinhole", "Image"] * 2
    _assert_same_calls(got, want)

    import torch

    rendered = rng.uniform(-0.2, 1.2, (24, 40, 3)).astype(np.float32)
    jviz.log_eval(7, 1, rendered, imgs[0], psnr=21.5)
    want = stub_rerun.take()
    viz.log_eval(7, 1, torch.from_numpy(rendered), imgs[0], psnr=21.5)
    got = stub_rerun.take()
    assert [c[0] for c in got] == ["eval/view_1/render", "eval/view_1/gt",
                                   "eval/view_1/psnr"]
    _assert_same_calls(got, want)


@pytest.mark.parametrize("size, max_isects", [
    ((48, 32), 4096), ((40, 24), 4096), ((48, 32), 100)],
    ids=["whole-tiles", "partial-tiles", "pool-overflow"])
def test_tile_heatmaps_match_reference(stub_rerun, size, max_isects):
    """The port's heatmaps (its record pipeline at cell (1, 1)) against
    brush_tpu's (build_intersections): counts equal, mean depth within
    1e-5 relative; a pool smaller than the records drops the same ones."""
    jviz, viz = _visualizers()
    js, ts = _models(count=64)
    jviz.log_tile_heatmaps(4, js, JCamera(**CAM), size, max_isects=max_isects)
    want = dict((c[0], c[2][0]) for c in stub_rerun.take())
    viz.log_tile_heatmaps(4, ts, Camera(**CAM), size, max_isects=max_isects)
    got = dict((c[0], c[2][0]) for c in stub_rerun.take())
    tiles = (-(-size[1] // 16), -(-size[0] // 16))
    counts = got["debug/tile_isect_counts"]
    assert counts.shape == tiles and counts.dtype == np.float32
    np.testing.assert_array_equal(counts, want["debug/tile_isect_counts"])
    if max_isects == 100:   # the scene has more records: the pool is full
        assert counts.sum() == max_isects
    np.testing.assert_allclose(got["debug/tile_mean_depth"],
                               want["debug/tile_mean_depth"], rtol=1e-5,
                               atol=0)
    assert (got["debug/tile_mean_depth"][counts > 0] > 0).all()


def _tiny_nerf_zip(path):
    rng = np.random.default_rng(0)
    img = lambda: rng.integers(0, 256, (32, 32, 4), np.uint8)
    dt.write_nerf_zip(path, {
        "train": [(c, img()) for c in dt.orbit_views(6, seed=1)],
        "val": [(c, img()) for c in dt.orbit_views(2, seed=2)]})


def test_cli_train_rerun_streams_without_changing_losses(stub_rerun,
                                                          tmp_path):
    """`cli train --rerun --eval-every 2` on a tiny NeRF zip: the dataset
    cameras at start, then at each eval the splats, every eval view's
    render, gt and PSNR, and the heatmaps of the first; the scalars through
    MetricsLogger; every loss equal to the run without --rerun."""
    data = str(tmp_path / "tiny.zip")
    _tiny_nerf_zip(data)
    losses = {}
    for rerun in (False, True):
        ck = tmp_path / f"ck_{rerun}"
        argv = ["--device", "cpu", "train", "--source", data, "--iters", "4",
                "--init-count", "64", "--sh-degree", "1", "--block-size",
                "32", "--log-every", "1", "--eval-every", "2",
                "--checkpoint-dir", str(ck)] + (["--rerun"] if rerun else [])
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv)
        with open(os.path.join(ck, "metrics.jsonl")) as f:
            losses[rerun] = [r["loss"] for r in map(json.loads, f)
                             if "loss" in r]
    assert len(losses[True]) == 4 and losses[True] == losses[False]
    paths = [c[0] for c in stub_rerun.calls]
    kinds = {c[1] for c in stub_rerun.calls}
    assert {"Transform3D", "Pinhole", "Points3D", "Image", "DepthImage",
            "Scalar"} <= kinds
    assert sum(p.startswith("world/dataset/") and p.endswith("/image")
               and k == "Pinhole" for p, k, *_ in stub_rerun.calls) == 6
    assert paths.count("world/splats") == 1          # the eval at step 2
    assert {"eval/view_0/render", "eval/view_1/gt", "eval/view_1/psnr",
            "debug/tile_isect_counts", "debug/tile_mean_depth",
            "loss"} <= set(paths)
    heat = [c[2][0] for c in stub_rerun.calls
            if c[0] == "debug/tile_isect_counts"]
    assert len(heat) == 1 and heat[0].shape == (2, 2) and heat[0].sum() > 0
