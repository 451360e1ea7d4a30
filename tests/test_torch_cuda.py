"""The port's CUDA kernels on the card, and the port's device rules.

This file imports nothing of JAX, so it also runs on a machine with a
card and no JAX (see README: `pytest --noconftest -m cuda`). Tests marked
`cuda` hold each CUDA kernel to its plain PyTorch version on the same
inputs and skip without a card; the rest run anywhere. Its scene helpers
are shared with test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.ops.cuda import build
from brush_tpu_torch.ops.cuda import expand as t_expand
from brush_tpu_torch.ops.cuda import rasterize_bwd as t_bwd
from brush_tpu_torch.ops.cuda import rasterize_fwd as t_raster
from brush_tpu_torch.ops.cuda import segsum as t_seg
from brush_tpu_torch.ops.cuda.testing import (
    HAND_POISON_FROM, HAND_TILE_CASES, hand_tiles,
)
from brush_tpu_torch.ops.pipeline import depth_order, tile_bins
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.render import record_inputs, render_splats

# (n, image, pool, largest scale): a plain scene; large splats so the bbox
# (> 8x8 tiles) path expands; a pool smaller than the records (overflow).
SCENES = {
    "small": (512, (64, 48), 2048, 0.5),
    "bbox_splats": (200, (160, 128), 16384, 3.0),
    "overflow": (512, (64, 48), 512, 0.5),
}
CAM = dict(position=[0, 0, -6.0], rotation=[1, 0, 0, 0], fov_x=np.pi / 2,
           fov_y=np.pi / 2)
# Segment layouts made by hand, which the scenes do not reach.
HAND_LAYOUTS = ["long_segment", "empty_runs", "straddle", "total_zero"]
HAND_POOL = 4096


def make_scene(n, seed, scale_hi=0.5, sh_degree=1):
    """Random splats in front of a camera at z=-6 (numpy, float32)."""
    rng = np.random.default_rng(seed)
    quats = rng.normal(size=(n, 4))
    k = (sh_degree + 1) ** 2
    return {
        "means": rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32),
        "log_scales": np.log(rng.uniform(0.02, scale_hi, (n, 3))).astype(
            np.float32),
        "quats": (quats / np.linalg.norm(quats, axis=1, keepdims=True)
                  ).astype(np.float32),
        "sh_coeffs": rng.normal(0, 0.6, (n, k, 3)).astype(np.float32),
        "raw_opacity": rng.normal(0.5, 1.5, n).astype(np.float32),
    }


def port_records(sc, img_size, pool, device="cpu", cell=(1, 1)):
    """The port's stages up to the tile sort on `device` (CPU tensors go
    through the plain kernels), in raster cells of `cell` tiles ("tiles_x"
    and "num_tiles" then count cells)."""
    cp = camera_params(Camera(**CAM), img_size, device=device)
    t = {k: torch.tensor(v, device=device) for k, v in sc.items()}
    rec = record_inputs(t["means"], t["log_scales"], t["quats"],
                        t["sh_coeffs"], t["raw_opacity"], cp, img_size,
                        cell=cell)
    d = depth_order(rec.attrs9, rec.decode, rec.depth_key, pool)
    tiles_x = -(-img_size[0] // (16 * cell[0]))
    num_tiles = tiles_x * -(-img_size[1] // (16 * cell[1]))
    keys, recs = t_expand.expand(d.f5, d.u5, d.cum, d.total, tiles_x,
                                 num_tiles, pool)
    packed, starts, ends = tile_bins(keys, recs, num_tiles)
    return dict(f5=d.f5, u5=d.u5, cum=d.cum, total=d.total,
                raw_total=d.raw_total, offsets=d.offsets, order=d.order,
                keys=keys, recs=recs, packed=packed, starts=starts,
                ends=ends, tiles_x=tiles_x, num_tiles=num_tiles)


def hand_segments(case):
    """(offsets, cum, total) int32 numpy for 700 splats (no multiple of a
    256-splat block) of 1-4 slots each in a pool of HAND_POOL, the last 40
    empty. long_segment: one splat of 1101 slots, longer than two 512-slot
    blocks; empty_runs: 20 empty splats after every 16; straddle: `total`
    falls one slot into a splat, which keeps that slot, and every later
    splat gets zero; total_zero: no live slot."""
    rng = np.random.default_rng(31)
    counts = rng.integers(1, 5, 700)
    if case == "long_segment":
        counts[300] = 1101
    if case == "empty_runs":
        for i in range(16, 700, 36):
            counts[i:i + 20] = 0
    counts[-40:] = 0
    cum = np.cumsum(counts)
    offsets = cum - counts
    total = int(cum[-1])
    assert total <= HAND_POOL
    if case == "straddle":
        w = 350 + int(np.argmax(counts[350:] >= 3))
        total = int(offsets[w]) + 1
    if case == "total_zero":
        total = 0
    return (offsets.astype(np.int32), cum.astype(np.int32),
            np.array([total], np.int32))


def hand_tile_args(case, device):
    """hand_tiles(case) as the rasterizers' arguments."""
    packed, starts, ends, tiles_x = hand_tiles(case)
    return (torch.tensor(packed, device=device),
            torch.tensor(starts, device=device),
            torch.tensor(ends, device=device), tiles_x)


def kernel_constant(kernel, name):
    """The integer `constexpr int <name> = ...;` of csrc/<kernel>.cu."""
    import os
    import re

    with open(os.path.join(build.CSRC, f"{kernel}.cu")) as f:
        found = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    assert len(found) == 1, f"{kernel}.cu: {name} {found}"
    return int(found[0])


def close_with_flips(got, want, atol, flip_tol=0.01, max_flip_frac=2e-3,
                     what=""):
    """The rule of tests/conftest.assert_close_quantized: within atol
    except a counted few alpha-threshold flips, each within flip_tol."""
    diff = np.abs(got - want)
    n_flip = int((diff > atol).sum())
    assert diff.max() <= flip_tol, f"{what}: max diff {diff.max():.2e}"
    assert n_flip <= max(1, int(max_flip_frac * diff.size)), (
        f"{what}: {n_flip}/{diff.size} beyond atol {atol:.0e}")


def flip_check(img, log_t, fidx, want_img, want_log_t, want_fidx, atol,
               transmittance=False):
    """img and log_t (or, with transmittance, T = exp(log_t)) close with
    counted flips; final_idx must agree on every pixel whose outputs
    agreed within atol, up to the same flip budget (a sub-atol flip at the
    T threshold changes it too)."""
    if transmittance:
        log_t, want_log_t = np.exp(log_t), np.exp(want_log_t)
    close_with_flips(img, want_img, atol, what="img")
    close_with_flips(log_t, want_log_t, atol, what="log_t")
    near = ((np.abs(img - want_img) <= atol).all(-1)
            & (np.abs(log_t - want_log_t) <= atol))
    n_bad = int(((fidx != want_fidx) & near).sum())
    assert n_bad <= max(1, int(2e-3 * fidx.size)), f"{n_bad} final_idx"


def test_cuda_request_without_cuda_raises():
    """Asking for the card on a machine without one raises; nothing
    carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from brush_tpu_torch.splats import from_random

    with pytest.raises(RuntimeError, match="cuda"):
        from_random(np.random.default_rng(0), [-1] * 3, [1] * 3, count=8)
    with pytest.raises(RuntimeError, match="cuda"):
        camera_params(Camera(**CAM), (16, 16))


def test_wrappers_reject_bad_inputs():
    r = port_records(make_scene(64, 0), (32, 32), 512)
    with pytest.raises(ValueError, match="f5"):
        t_expand.expand(r["f5"].double(), r["u5"], r["cum"], r["total"],
                        r["tiles_x"], r["num_tiles"], 512)
    with pytest.raises(ValueError, match="packed"):
        t_raster.rasterize_fwd(r["packed"][:7], r["starts"], r["ends"],
                               r["tiles_x"])
    img, log_t, fidx = t_raster.rasterize_fwd(r["packed"], r["starts"],
                                              r["ends"], r["tiles_x"])
    with pytest.raises(ValueError, match="v_out"):
        t_bwd.rasterize_bwd(r["packed"], r["starts"], r["ends"],
                            r["tiles_x"], img[..., :3], log_t, fidx)
    with pytest.raises(ValueError, match="final_idx"):
        t_bwd.rasterize_bwd(r["packed"], r["starts"], r["ends"],
                            r["tiles_x"], img, log_t, fidx.long())
    rows = torch.zeros((t_bwd.GRAD_ROWS, 512))
    with pytest.raises(ValueError, match="rows"):
        t_seg.segment_sum(rows[:8], r["offsets"], r["cum"], r["total"])
    with pytest.raises(ValueError, match="offsets"):
        t_seg.segment_sum(rows, r["offsets"].long(), r["cum"], r["total"])


def test_expand_plain_canonicalizes_negative_zero():
    """-0.0 in a record field is written as +0.0, as the TPU kernel's
    matmul gather leaves it."""
    r = port_records(make_scene(64, 0), (32, 32), 512)
    f5 = r["f5"].clone()
    f5[3] = -0.0
    _, recs = t_expand.expand_plain(f5, r["u5"], r["cum"], r["total"],
                                    r["tiles_x"], r["num_tiles"], 512)
    assert int(r["total"][0]) > 0 and not recs[3].any()


def test_library_name_follows_source_and_headers(tmp_path, monkeypatch):
    """A library's file name carries a hash of its source and of every
    header beside it, so editing a shared header (tile_order.cuh) can
    never leave a stale library loaded."""
    for fname, text in (("a.cu", "// a"), ("b.cu", "// b"),
                        ("shared.cuh", "// h")):
        (tmp_path / fname).write_text(text)
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    a, b = build._lib_path("a"), build._lib_path("b")
    assert a != b and a == build._lib_path("a")
    (tmp_path / "shared.cuh").write_text("// h, edited")
    assert build._lib_path("a") != a and build._lib_path("b") != b
    a = build._lib_path("a")
    (tmp_path / "a.cu").write_text("// a, edited")
    assert build._lib_path("a") != a


def test_kernel_sources_find_their_headers():
    """Every header a kernel source includes lies beside it, where nvcc
    looks first and the library's hash covers it."""
    import os
    import re

    for name in build.SOURCES:
        with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
            for header in re.findall(r'#include "([^"]+)"', f.read()):
                assert header.endswith(".cuh")
                assert os.path.isfile(os.path.join(build.CSRC, header))


# ---- on the card: each CUDA kernel against its plain version ----------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_cuda_expand_equals_plain(name):
    _need_cuda()
    n, img_size, pool, scale_hi = SCENES[name]
    r = port_records(make_scene(n, 5, scale_hi), img_size, pool, "cuda")
    args = (r["f5"], r["u5"], r["cum"], r["total"], r["tiles_x"],
            r["num_tiles"], pool)
    before = t_expand.launches
    keys, recs = t_expand.expand(*args)
    torch.cuda.synchronize()
    assert t_expand.launches == before + 1
    pk, pr = t_expand.expand_plain(*args)
    assert torch.equal(keys, pk) and torch.equal(recs, pr)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["small", "bbox_splats"])
def test_cuda_rasterize_fwd_matches_plain(name):
    _need_cuda()
    n, img_size, pool, scale_hi = SCENES[name]
    r = port_records(make_scene(n, 6, scale_hi), img_size, pool, "cuda")
    args = (r["packed"], r["starts"], r["ends"], r["tiles_x"])
    before = t_raster.launches
    img, log_t, fidx = t_raster.rasterize_fwd(*args)
    torch.cuda.synchronize()
    assert t_raster.launches == before + 1
    want = t_raster.rasterize_fwd_plain(*args)
    flip_check(img.cpu().numpy(), log_t.cpu().numpy(), fidx.cpu().numpy(),
               *(w.cpu().numpy() for w in want), atol=1e-5)
    _same_bits((img, log_t, fidx), t_raster.rasterize_fwd(*args))


def _same_bits(got, again):
    for a, b in zip(got, again):
        assert torch.equal(a, b), "two launches on the same inputs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("case", HAND_TILE_CASES)
def test_cuda_rasterize_fwd_hand_tiles_match_plain(case):
    """The layouts made by hand (ops/cuda/testing.hand_tiles): kernel against
    plain, and a second launch bit-equal. On the opaque tile the records
    behind the last crossing change no bit of the output."""
    _need_cuda()
    args = hand_tile_args(case, "cuda")
    img, log_t, fidx = t_raster.rasterize_fwd(*args)
    torch.cuda.synchronize()
    want = t_raster.rasterize_fwd_plain(*args)
    flip_check(img.cpu().numpy(), log_t.cpu().numpy(), fidx.cpu().numpy(),
               *(w.cpu().numpy() for w in want), atol=1e-5)
    _same_bits((img, log_t, fidx), t_raster.rasterize_fwd(*args))
    if case == "opaque":
        cut = torch.full_like(args[2], HAND_POISON_FROM)
        _same_bits((img, log_t, fidx), t_raster.rasterize_fwd(
            args[0], args[1], cut, args[3]))
        assert int(fidx.max()) < HAND_POISON_FROM - 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["deep", "opaque"])
def test_cuda_rasterize_bwd_on_hand_tiles(case):
    """rasterize_bwd on the forward kernel's log T and final_idx for the
    deep and the saturating tile: the two kernels' active sets agree, so
    the rows match the plain version's on the same inputs."""
    _need_cuda()
    args = hand_tile_args(case, "cuda")
    _, log_t, fidx = t_raster.rasterize_fwd(*args)
    gen = torch.Generator(device="cuda").manual_seed(17)
    v_out = torch.randn((args[1].shape[0], 256, 4), generator=gen,
                        device="cuda")
    b_args = (*args, v_out, log_t, fidx)
    got = t_bwd.rasterize_bwd(*b_args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    rows_close(got, t_bwd.rasterize_bwd_plain(*b_args), 1e-4, case)
    assert torch.equal(got, t_bwd.rasterize_bwd(*b_args))


@pytest.mark.cuda
def test_cuda_rasterize_fwd_hyperbolic_conic_matches_plain():
    _need_cuda()
    n, img_size, pool, scale_hi = SCENES["small"]
    r = port_records(make_scene(n, 9, scale_hi), img_size, pool, "cuda")
    packed = r["packed"].clone()
    live = int(r["total"][0])
    hyper = torch.tensor([1.0, -1.5, 1.0], device="cuda").view(torch.int32)
    packed[2:5, :live:7] = hyper[:, None]
    args = (packed, r["starts"], r["ends"], r["tiles_x"])
    img, log_t, fidx = t_raster.rasterize_fwd(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(img).all() and torch.isfinite(log_t).all()
    want = t_raster.rasterize_fwd_plain(*args)
    flip_check(img.cpu().numpy(), log_t.cpu().numpy(), fidx.cpu().numpy(),
               *(w.cpu().numpy() for w in want), atol=1e-5)
    _same_bits((img, log_t, fidx), t_raster.rasterize_fwd(*args))


@pytest.mark.cuda
def test_cuda_render_matches_cpu():
    _need_cuda()
    sc = make_scene(512, 8)
    out = {}
    for dev in ("cpu", "cuda"):
        t = {k: torch.tensor(v, device=dev) for k, v in sc.items()}
        out[dev] = render_splats(
            t["means"], t["log_scales"], t["quats"], t["sh_coeffs"],
            t["raw_opacity"], camera_params(Camera(**CAM), (64, 48),
                                            device=dev),
            (64, 48), needs_grad=False)
    torch.cuda.synchronize()
    close_with_flips(out["cuda"][0].cpu().numpy(), out["cpu"][0].numpy(),
                     atol=1e-5, what="render")
    assert int(out["cuda"][1].num_isects) == int(out["cpu"][1].num_isects)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [(2, 2), (3, 1), (4, 2)])
def test_cuda_rasterizers_at_cells_match_plain(cell):
    """Both rasterizers at a raster cell (the deep-tile scene: several
    staging batches a cell; 32x32 is 2x2 tiles, which (3, 1) and (4, 2) do
    not divide): forward against plain (tolerances of the tile tests),
    backward on the kernel forward's outputs within 1e-4 of each row's
    largest value, launches counted once, repeats bit-equal."""
    _need_cuda()
    n, img_size, pool, scale_hi = BWD_SCENES["deep_tiles"]
    r = port_records(make_scene(n, 12, scale_hi), img_size, pool, "cuda",
                     cell)
    args = (r["packed"], r["starts"], r["ends"], r["tiles_x"], cell)
    before = (t_raster.launches, t_bwd.launches)
    img, log_t, fidx = t_raster.rasterize_fwd(*args)
    torch.cuda.synchronize()
    p = 256 * cell[0] * cell[1]
    assert img.shape == (r["num_tiles"], p, 4) and log_t.shape[1] == p
    want = t_raster.rasterize_fwd_plain(*args)
    flip_check(img.cpu().numpy(), log_t.cpu().numpy(), fidx.cpu().numpy(),
               *(w.cpu().numpy() for w in want), atol=1e-5)
    _same_bits((img, log_t, fidx), t_raster.rasterize_fwd(*args))
    gen = torch.Generator(device="cuda").manual_seed(19)
    v_out = torch.randn((*log_t.shape, 4), generator=gen, device="cuda")
    b_args = (*args[:4], v_out, log_t, fidx, cell)
    got = t_bwd.rasterize_bwd(*b_args)
    torch.cuda.synchronize()
    assert (t_raster.launches, t_bwd.launches) == (before[0] + 2,
                                                   before[1] + 1)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    rows_close(got, t_bwd.rasterize_bwd_plain(*b_args), 1e-4, f"{cell}")
    assert torch.equal(got, t_bwd.rasterize_bwd(*b_args))


@pytest.mark.cuda
def test_cuda_render_at_cell_matches_tiles():
    """render_splats at cell (2, 2) on the card, with gradients: the image
    of the tile path within 1e-5 but for counted flips, fewer records."""
    _need_cuda()
    sc = make_scene(512, 8)
    t = {k: torch.tensor(v, device="cuda") for k, v in sc.items()}
    cp = camera_params(Camera(**CAM), (80, 48), device="cuda")
    out = {cell: render_splats(t["means"], t["log_scales"], t["quats"],
                               t["sh_coeffs"], t["raw_opacity"], cp, (80, 48),
                               cell=cell)
           for cell in ((1, 1), (2, 2))}
    torch.cuda.synchronize()
    close_with_flips(out[(2, 2)][0].detach().cpu().numpy(),
                     out[(1, 1)][0].detach().cpu().numpy(), atol=1e-5,
                     what="cell render")
    assert 0 < int(out[(2, 2)][1].num_isects) < int(
        out[(1, 1)][1].num_isects)


def rows_close(got, want, rtol, what=""):
    """Each gradient row within rtol of that row's largest |value|."""
    for r in range(want.shape[0]):
        scale = float(want[r].abs().max())
        err = float((got[r] - want[r]).abs().max())
        assert err <= rtol * scale, f"{what} row {r}: {err:.3e} > " \
            f"{rtol:.0e} x {scale:.3e}"


# (n, image, pool, largest scale) for rasterize_bwd: the plain scenes; a
# 32x32 image under 4000 splats, so each of its 4 tiles holds several
# staging batches of records; an image 5 tiles wide.
BWD_SCENES = {
    "small": SCENES["small"],
    "bbox_splats": SCENES["bbox_splats"],
    "hyperbolic": SCENES["small"],
    "deep_tiles": (4000, (32, 32), 16384, 0.3),
    "early_end": (4000, (32, 32), 16384, 0.3),
    "odd_tiles_x": (600, (80, 48), 4096, 0.5),
}
STAGING_BATCH = kernel_constant("rasterize_bwd", "kBatch")


def _bwd_args(case, seed):
    n, img_size, pool, scale_hi = BWD_SCENES[case]
    r = port_records(make_scene(n, seed, scale_hi), img_size, pool, "cuda")
    packed = r["packed"].clone()
    if case == "hyperbolic":
        live = int(r["total"][0])
        hyper = torch.tensor([1.0, -1.5, 1.0], device="cuda").view(
            torch.int32)
        packed[2:5, :live:7] = hyper[:, None]
    _, log_t, fidx = t_raster.rasterize_fwd(packed, r["starts"], r["ends"],
                                            r["tiles_x"])
    if case == "early_end":
        # Every pixel stops inside the tile's second batch from the back
        # of the sweep, each at its own record.
        pix = torch.arange(256, device="cuda", dtype=torch.int32)[None, :]
        stop = r["starts"][:, None] + STAGING_BATCH + 7 + pix % 61
        fidx = torch.minimum(fidx, stop)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    v_out = torch.randn((r["num_tiles"], 256, 4), generator=gen,
                        device="cuda")
    return (packed, r["starts"], r["ends"], r["tiles_x"], v_out, log_t,
            fidx), r


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BWD_SCENES))
def test_cuda_rasterize_bwd_matches_plain(case):
    """Kernel vs plain on the kernel forward's own log T and final_idx: the
    same active set (same rounded sigma, same libdevice exp), so the rows
    differ only in float32 rounding and summation order. A second launch
    on the same inputs is bit-equal."""
    _need_cuda()
    args, r = _bwd_args(case, 14)
    if case in ("deep_tiles", "early_end"):
        assert int((r["ends"] - r["starts"]).max()) > 2 * STAGING_BATCH
    if case == "odd_tiles_x":
        assert r["tiles_x"] % 2 == 1
    before = t_bwd.launches
    got = t_bwd.rasterize_bwd(*args)
    torch.cuda.synchronize()
    assert t_bwd.launches == before + 1
    assert torch.isfinite(got).all()
    rows_close(got, t_bwd.rasterize_bwd_plain(*args), 1e-4, case)
    assert torch.equal(got, t_bwd.rasterize_bwd(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_cuda_segment_sum_matches_plain(name):
    _need_cuda()
    n, img_size, pool, scale_hi = SCENES[name]
    r = port_records(make_scene(n, 15, scale_hi), img_size, pool, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = torch.randn((t_bwd.GRAD_ROWS, pool), generator=gen,
                       device="cuda")
    rows[:, int(r["total"][0]):] = 0.0
    args = (rows, r["offsets"], r["cum"], r["total"])
    before = t_seg.launches
    got = t_seg.segment_sum(*args)
    torch.cuda.synchronize()
    assert t_seg.launches == before + 1
    rows_close(got, t_seg.segment_sum_plain(*args), 1e-5, name)
    assert torch.equal(got, t_seg.segment_sum(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", HAND_LAYOUTS)
def test_cuda_segment_sum_hand_layouts(case, aligned):
    """The hand-made layouts, kernel against plain; the rows also from a
    buffer that starts 4 bytes off a 16-byte boundary, which takes the
    kernel's 4-byte copies. Slots at and past `total` hold garbage that
    must not be summed."""
    _need_cuda()
    offsets, cum, total = (torch.tensor(x, device="cuda")
                           for x in hand_segments(case))
    gen = torch.Generator(device="cuda").manual_seed(16)
    buf = torch.randn(t_bwd.GRAD_ROWS * HAND_POOL + 1, generator=gen,
                      device="cuda")
    rows = buf[0 if aligned else 1:][:t_bwd.GRAD_ROWS * HAND_POOL].view(
        t_bwd.GRAD_ROWS, HAND_POOL)
    assert (rows.data_ptr() % 16 == 0) == aligned
    got = t_seg.segment_sum(rows, offsets, cum, total)
    torch.cuda.synchronize()
    want = t_seg.segment_sum_plain(rows, offsets, cum, total)
    if case == "total_zero":
        assert not got.any() and not want.any()
    else:
        rows_close(got, want, 1e-5, case)
    assert torch.equal(got, t_seg.segment_sum(rows, offsets, cum, total))


@pytest.mark.cuda
def test_cuda_render_grads_match_cpu():
    """The whole differentiable render on the card (four kernels) against
    the CPU (four plain versions)."""
    _need_cuda()
    sc = make_scene(512, 16)
    names = ["means", "log_scales", "quats", "sh_coeffs", "raw_opacity"]
    grads = {}
    for dev in ("cpu", "cuda"):
        p = [torch.tensor(sc[k], device=dev, requires_grad=True)
             for k in names]
        img, _ = render_splats(*p, camera_params(Camera(**CAM), (64, 48),
                                                 device=dev), (64, 48),
                               pack_grad_sort=False)
        (img ** 2).sum().backward()
        grads[dev] = [x.grad.cpu() for x in p]
    for name, a, b in zip(names, grads["cuda"], grads["cpu"]):
        assert torch.isfinite(a).all(), name
        close_with_flips((a / b.abs().max()).numpy(),
                         (b / b.abs().max()).numpy(), atol=1e-4,
                         flip_tol=0.05, what=name)


# ---- stage marks (brush_tpu_torch.utils.profiler) ---------------------

TRAIN_STAGES = [
    "upload", "record_inputs", "depth_order", "expand", "tile_bins",
    "rasterize_fwd", "assemble", "loss", "loss backward", "rasterize_bwd",
    "grad_resort", "segment_sum", "to_global", "autograd rest",
    "densify_stats", "adam", "step end",
]


def test_stage_marks_are_inert_outside_a_recording(monkeypatch):
    """A mark outside profiler.record() records nothing (CPU work passes
    through the marks untouched); record() refuses a machine without
    CUDA rather than timing nothing."""
    from brush_tpu_torch.utils import profiler

    profiler.mark("anything")
    assert profiler._marks is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiler.record():
            pass
    assert profiler._marks is None


@pytest.mark.cuda
def test_cuda_stage_marks_cover_a_train_step():
    """One SplatTrainer step on the card, recorded: every stage of the
    step is marked once, in stream order, the backward's on the autograd
    thread included."""
    _need_cuda()
    from brush_tpu_torch.splats import from_random
    from brush_tpu_torch.train import SceneBatch, SplatTrainer
    from brush_tpu_torch.utils import profiler

    sp = from_random(np.random.default_rng(0), [-1] * 3, [1] * 3, count=256,
                     sh_degree=1, device="cuda")
    trainer = SplatTrainer()
    state = trainer.init_state(sp)
    batch = SceneBatch(np.zeros((48, 64, 3), np.float32), Camera(**CAM))
    with profiler.record() as stages:
        trainer.step(state, batch)
    assert [name for name, _ in stages] == TRAIN_STAGES
    assert all(ms >= 0.0 for _, ms in stages)


@pytest.mark.cuda
def test_cuda_cli_train(tmp_path):
    """`cli train --device cuda` on a tiny NeRF zip (8 train and 2 val
    views at 32x32): every step launches the four kernels, the losses are
    finite and the final eval and export run."""
    _need_cuda()
    import json

    from brush_tpu_torch import cli
    from brush_tpu_torch.datasets import testing as dt

    rng = np.random.default_rng(0)
    splits = {split: [(c2w, rng.integers(0, 256, (32, 32, 4), np.uint8))
                      for c2w in dt.orbit_views(n, seed=seed)]
              for split, n, seed in (("train", 8, 1), ("val", 2, 2))}
    source = str(tmp_path / "tiny.zip")
    dt.write_nerf_zip(source, splits)
    for mod in (t_expand, t_raster, t_bwd, t_seg):
        mod.launches = 0
    cli.main(["--device", "cuda", "train", "--source", source, "--iters",
              "4", "--init-count", "64", "--sh-degree", "1", "--block-size",
              "32", "--log-every", "1", "--checkpoint-dir", str(tmp_path),
              "--export", str(tmp_path / "out.ply")])
    launches = [mod.launches for mod in (t_expand, t_raster, t_bwd, t_seg)]
    assert min(launches) >= 4, launches
    with open(tmp_path / "metrics.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert (tmp_path / "out.ply").stat().st_size > 0
