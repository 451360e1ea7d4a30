"""The port's CLI against brush_tpu's: `train` on the same tiny NeRF zip
gives the same per-step losses and close final parameters; `eval`,
`render`, `train2d` and `--resume` run on the CPU (`train --cell` runs:
tests/test_torch_cells.py; `train --shard` and `train2d --shard`:
tests/test_torch_sharded.py; `view`: tests/test_torch_viewer.py; `train
--rerun`: tests/test_torch_rerun_viz.py); the new modules import neither
JAX nor brush_tpu."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from brush_tpu import cli as j_cli
from brush_tpu.datasets import load_dataset as j_load_dataset
from brush_tpu.splats import from_random as j_from_random
from brush_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint

from brush_tpu_torch import cli
from brush_tpu_torch.datasets import png
from brush_tpu_torch.datasets import testing as dt
from brush_tpu_torch.utils.checkpoint import load_checkpoint
from torch_threads import pin_threads

pin_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = ("means", "sh_coeffs", "quats", "raw_opacity", "log_scales")
TRAIN = ["--iters", "4", "--init-count", "64", "--sh-degree", "1",
         "--block-size", "32", "--log-every", "1", "--checkpoint-every",
         "2"]


def tiny_images(n, seed, size=32):
    """Smooth RGBA images with a transparent border."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = []
    for _ in range(n):
        chans = [0.5 + 0.4 * np.sin(rng.uniform(2, 6) * xx
                                    + rng.uniform(2, 6) * yy
                                    + rng.uniform(0, 6)) for _ in range(3)]
        alpha = ((np.abs(xx - 0.5) < 0.35) & (np.abs(yy - 0.5) < 0.35))
        img = np.stack(chans + [alpha.astype(float)], -1)
        out.append(np.clip(img * 255, 0, 255).astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def nerf_zip(tmp_path_factory):
    """8 train and 2 val views at 32x32 on the castle's orbit."""
    path = str(tmp_path_factory.mktemp("data") / "tiny.zip")
    splits = {"train": list(zip(dt.orbit_views(8, seed=1),
                                tiny_images(8, 1))),
              "val": list(zip(dt.orbit_views(2, seed=2), tiny_images(2, 2)))}
    dt.write_nerf_zip(path, splits)
    return path


def read_metrics(ckpt_dir):
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def port_run(nerf_zip, tmp_path_factory):
    """The port's `cli train` on the tiny zip, stdout kept."""
    out = tmp_path_factory.mktemp("port")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", "cpu", "train", "--source", nerf_zip, *TRAIN,
                  "--eval-every", "2", "--checkpoint-dir", str(out),
                  "--export", str(out / "out.ply")])
    return str(out), buf.getvalue()


def final_psnr(text, prefix):
    m = re.search(prefix + r" PSNR (\S+) SSIM (\S+)", text)
    assert m, text
    return m.groups()


def test_cli_train_matches_reference(nerf_zip, port_run, tmp_path):
    """Same zip, same flags: the random init makes the same numpy draws and
    the loader the same view order, so every step's loss agrees within
    1e-5 and the final parameters within the bounds of
    tests/test_torch_train.py's trainer parity (99 % of each parameter's
    entries within 2 % of how far the reference moved them, none by more
    than that distance); below the 500 warm-up steps no refine runs."""
    port_dir, _ = port_run
    jdir = tmp_path / "jax"
    j_cli.main(["--platform", "cpu", "train", "--source", nerf_zip, *TRAIN,
                "--checkpoint-dir", str(jdir)])
    t_log = [r for r in read_metrics(port_dir) if "loss" in r]
    j_log = [r for r in read_metrics(str(jdir)) if "loss" in r]
    assert [r["step"] for r in t_log] == [r["step"] for r in j_log] == [
        0, 1, 2, 3]
    for t, j in zip(t_log, j_log):
        assert abs(t["loss"] - j["loss"]) <= 1e-5, (t, j)
        for k in ("num_visible", "splats", "num_dropped"):
            assert t[k] == j[k], k
        assert t["lr_mean"] == pytest.approx(j["lr_mean"], rel=1e-12)

    tstate, tstep, _, tcfg = load_checkpoint(
        os.path.join(port_dir, "ckpt_final.npz"), device="cpu")
    jstate, jstep, _, jcfg = j_load_checkpoint(
        str(jdir / "ckpt_final.npz"))
    assert tstep == jstep == 4 and tcfg == jcfg
    # The init, as both CLIs make it (cli.py:72-82).
    ds = j_load_dataset(nerf_zip)
    _, extent = ds.train.bounds(0.0, 0.0)
    ext = float(np.linalg.norm(extent))
    c2, e2 = ds.train.bounds(ext * 0.25, ext)
    init = j_from_random(np.random.default_rng(42), c2 - e2, c2 + e2,
                         count=64, sh_degree=1)
    for k in PARAMS:
        a = getattr(tstate.splats, k).numpy()
        b = np.asarray(getattr(jstate.splats, k))
        moved = np.abs(b - np.asarray(getattr(init, k))).max()
        assert moved > 0, k
        d = np.abs(a - b)
        assert np.quantile(d, 0.99) <= 0.02 * moved, k
        assert d.max() <= moved, k


def test_cli_eval_render_resume_on_cpu(nerf_zip, port_run, tmp_path,
                                       capsys):
    """`eval --ply` and `eval --ckpt` print the training run's final PSNR
    and SSIM to every printed digit (the export keeps every live row
    exactly); `render` writes a non-blank PNG; `--resume` continues from
    the saved iteration."""
    port_dir, text = port_run
    assert "random init: 64 splats" in text
    losses = [r["loss"] for r in read_metrics(port_dir) if "loss" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert any("eval_psnr" in r for r in read_metrics(port_dir))
    want = final_psnr(text, "final eval:")
    for flag, name in (("--ply", "out.ply"), ("--ckpt", "ckpt_final.npz")):
        cli.main(["--device", "cpu", "eval", "--source", nerf_zip, flag,
                  os.path.join(port_dir, name)])
        assert final_psnr(capsys.readouterr().out, "mean:") == want, flag

    out = str(tmp_path / "r.png")
    cli.main(["--device", "cpu", "render", "--source", nerf_zip, "--ply",
              os.path.join(port_dir, "out.ply"), "--view", "1", "--out",
              out])
    with open(out, "rb") as f:
        img = png.decode_png(f.read())
    assert img.shape == (32, 32, 4) and img[..., 3].max() > 0

    rdir = tmp_path / "resumed"
    cli.main(["--device", "cpu", "train", "--source", nerf_zip, *TRAIN,
              "--iters", "5", "--checkpoint-dir", str(rdir), "--resume",
              os.path.join(port_dir, "ckpt_0000002.npz")])
    assert "at step 3" in capsys.readouterr().out
    steps = [r["step"] for r in read_metrics(str(rdir)) if "loss" in r]
    assert steps == [3, 4]
    _, step, _, _ = load_checkpoint(str(rdir / "ckpt_final.npz"),
                                    device="cpu")
    assert step == 5


def test_cli_train2d_on_cpu(tmp_path, capsys):
    image = tmp_path / "target.png"
    image.write_bytes(dt.filtered_png(tiny_images(1, 3, size=40)[0]))
    out = str(tmp_path / "fit.png")
    cli.main(["--device", "cpu", "train2d", "--image", str(image), "--size",
              "24", "--iters", "6", "--log-every", "1", "--init-count", "16",
              "--block-size", "32", "--out", out])
    text = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss (\S+)", text)]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert "final PSNR" in text
    with open(out, "rb") as f:
        assert png.decode_png(f.read()).shape == (24, 24, 4)


def test_train2d_target_is_the_reference_target():
    """train2d reads its image through the port's decoder and resizes it
    with Pillow: the target equals the reference's
    np.asarray(Image.open(f).convert("RGB").resize(...)) / 255 exactly."""
    from PIL import Image

    data = dt.filtered_png(tiny_images(1, 4, size=64)[0])
    for size in (None, 24, 80):
        img = Image.open(io.BytesIO(data)).convert("RGB")
        if size:
            img = img.resize((size, size))
        want = np.asarray(img, np.float32) / 255.0
        got = cli.train2d_target(data, size)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_train2d_size_without_pillow_raises(monkeypatch):
    data = png.encode_png(tiny_images(1, 5, size=16)[0])
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert cli.train2d_target(data, None).shape == (16, 16, 3)
    with pytest.raises(ImportError, match="Pillow"):
        cli.train2d_target(data, 8)


def test_cli_on_missing_cuda_raises(nerf_zip):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["eval", "--source", nerf_zip, "--ply", "unused.ply"])


def test_new_modules_import_neither_jax_nor_brush_tpu():
    mods = ["brush_tpu_torch.cli", "brush_tpu_torch.datasets",
            "brush_tpu_torch.datasets.colmap", "brush_tpu_torch.datasets.nerf",
            "brush_tpu_torch.datasets.png", "brush_tpu_torch.datasets.scene",
            "brush_tpu_torch.datasets.loading",
            "brush_tpu_torch.datasets.loader", "brush_tpu_torch.datasets.ply",
            "brush_tpu_torch.datasets.testing", "brush_tpu_torch.native",
            "brush_tpu_torch.utils.checkpoint",
            "brush_tpu_torch.utils.metrics", "brush_tpu_torch.parallel",
            "brush_tpu_torch.parallel.multihost",
            "brush_tpu_torch.parallel.sharding",
            "brush_tpu_torch.parallel.train_step",
            "brush_tpu_torch.parallel.trainer",
            "brush_tpu_torch.utils.profiler",
            "brush_tpu_torch.utils.rerun_viz", "brush_tpu_torch.viewer",
            "brush_tpu_torch.viewer.server"]
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from brush_tpu_torch import native\n"
        "assert native.available()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brush_tpu'))\n"
        "assert not bad, bad\nprint('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
