"""The port's backward kernels against the Pallas kernels, and the dense
oracle's gradients against jax.grad.

rasterize_bwd_plain and rasterize_bwd_pallas (interpret mode, scan_passes
3) take the same packed pool (the port's own, built by its stages and
plain kernels), the same log T and final_idx (from rasterize_fwd_pallas on
that pool) and the same seeded image cotangent. segment_sum_plain and
segment_sum_pallas take the port's own offsets and a seeded row pool. The
CUDA kernels themselves are held to these plain versions in
test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brush_tpu.camera import Camera as JCamera
from brush_tpu.ops.pallas.expand import WINDOW_ALIGN
from brush_tpu.ops.pallas.rasterize_bwd import rasterize_bwd_pallas
from brush_tpu.ops.pallas.rasterize_fwd import rasterize_fwd_pallas
from brush_tpu.ops.pallas.segsum import SEG_ROWS, segment_sum_pallas
from brush_tpu.ops.rasterize_reference import camera_params as j_cp
from brush_tpu.ops.rasterize_reference import render_oracle as j_oracle

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.ops.cuda import rasterize_bwd as t_bwd
from brush_tpu_torch.ops.cuda import segsum as t_seg
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.ops.rasterize_reference import render_oracle
from brush_tpu_torch.ops.cuda.testing import (
    HAND_LAYOUTS, HAND_POOL, hand_segments,
)
from test_torch_cuda import CAM, SCENES, make_scene, port_records
from torch_threads import pin_threads

pin_threads()

K_LANES = 128
K_SEG = 512
u32 = lambda t: t.numpy().view(np.uint32)


def hyperbolic(packed, total, every=7):
    """Give every `every`-th live record an indefinite conic (det < 0) with
    its centre in a corner: sigma runs far below zero across the tile."""
    packed = packed.clone()
    hyper = torch.tensor([1.0, -1.5, 1.0]).view(torch.int32)
    packed[2:5, :total:every] = hyper[:, None]
    packed[0:2, :total:every] = torch.tensor([4.0, 4.0]).view(
        torch.int32)[:, None]
    return packed


def jax_fwd(packed, got, pool):
    """rasterize_fwd_pallas on the port's pool -> (log_t, final_idx)."""
    _, log_t, fidx = rasterize_fwd_pallas(
        jnp.asarray(np.pad(u32(packed), ((0, 0), (0, K_LANES)))),
        jnp.asarray(got["starts"].numpy()), jnp.asarray(got["ends"].numpy()),
        jnp.arange(got["num_tiles"], dtype=jnp.int32),
        tiles_x=got["tiles_x"], num_tiles=got["num_tiles"], max_isects=pool,
        k_lanes=K_LANES, interpret=True, scan_passes=3)
    return np.asarray(log_t), np.asarray(fidx)


@pytest.mark.parametrize("case", ["plain", "zero_cotangent", "hyperbolic"])
def test_rasterize_bwd_plain_matches_pallas(case):
    """Rows 0-8 on the live slots, each scaled by its own largest value,
    within 3e-4 (tests/test_pallas_bwd.py:45-50): the Pallas kernel's
    rank-6 sigma polynomial and MXU scans round differently from the
    direct per-pair evaluation."""
    n, img_size, pool, scale_hi = SCENES["small"]
    got = port_records(make_scene(n, seed=11, scale_hi=scale_hi), img_size,
                       pool)
    total = int(got["total"][0])
    packed = got["packed"]
    if case == "hyperbolic":
        packed = hyperbolic(packed, total)
    log_t, fidx = jax_fwd(packed, got, pool)
    v_out = np.random.default_rng(3).normal(
        size=(got["num_tiles"], 256, 4)).astype(np.float32)
    if case == "zero_cotangent":
        v_out[:] = 0.0
    want = np.asarray(rasterize_bwd_pallas(
        jnp.asarray(np.pad(u32(packed), ((0, 0), (0, K_LANES)))),
        jnp.asarray(v_out), jnp.asarray(log_t), jnp.asarray(fidx),
        jnp.asarray(got["starts"].numpy()), jnp.asarray(got["ends"].numpy()),
        jnp.arange(got["num_tiles"], dtype=jnp.int32),
        tiles_x=got["tiles_x"], num_tiles=got["num_tiles"], max_isects=pool,
        k_lanes=K_LANES, interpret=True, scan_passes=3))[:9, :total]
    grads, swept, active = t_bwd.rasterize_bwd_plain(
        packed, got["starts"], got["ends"], got["tiles_x"],
        torch.tensor(v_out), torch.tensor(log_t), torch.tensor(fidx),
        count_pairs=True)
    assert grads.shape == (t_bwd.GRAD_ROWS, pool)
    grads = grads.numpy()
    assert np.isfinite(grads).all()
    assert not grads[:, total:].any()
    if case == "zero_cotangent":
        assert not grads.any() and not want.any()
        return
    assert 0 < active < swept
    for r in range(9):
        scale = np.abs(want[r]).max() + 1e-8
        np.testing.assert_allclose(grads[r, :total] / scale, want[r] / scale,
                                   atol=3e-4, err_msg=f"row {r} ({case})")


def test_rasterize_bwd_plain_skips_empty_and_unreached_tiles():
    """Tiles with no records, or whose final_idx is -1 everywhere, write
    nothing; the sweep starts at the tile's largest final_idx."""
    n, img_size, pool, scale_hi = SCENES["small"]
    got = port_records(make_scene(n, seed=12, scale_hi=scale_hi), img_size,
                       pool)
    fidx = torch.full((got["num_tiles"], 256), -1, dtype=torch.int32)
    t0 = int(torch.argmax(got["ends"] - got["starts"]))
    s, e = int(got["starts"][t0]), int(got["ends"][t0])
    fidx[t0, 5] = s  # one pixel composited only the tile's first record
    v_out = torch.ones((got["num_tiles"], 256, 4))
    log_t = torch.full((got["num_tiles"], 256), -0.1)
    grads = t_bwd.rasterize_bwd_plain(got["packed"], got["starts"],
                                      got["ends"], got["tiles_x"], v_out,
                                      log_t, fidx)
    assert e - s > 1
    assert not grads[:, :s].any() and not grads[:, s + 1:].any()


def seg_inputs(got, pool, seed):
    """The pallas segsum's window bookkeeping from the port's offsets
    (raster_vjp.py:258-265)."""
    n = got["offsets"].shape[0]
    window = K_SEG + 2 * WINDOW_ALIGN
    n_pad = -(-n // WINDOW_ALIGN) * WINDOW_ALIGN + window
    cum = jnp.asarray(got["cum"].numpy())
    offs_col = jnp.concatenate([
        jnp.asarray(got["offsets"].numpy()),
        jnp.full((n_pad + WINDOW_ALIGN - n,), 1 << 30, jnp.int32)])[None, :]
    starts_blk = jnp.arange(pool // K_SEG, dtype=jnp.int32) * K_SEG
    w0 = jnp.searchsorted(cum, starts_blk, side="right").astype(jnp.int32)
    s_lo = jnp.clip((w0 // WINDOW_ALIGN) * WINDOW_ALIGN, 0, n_pad - window)
    total = int(got["total"][0])
    rows = np.random.default_rng(seed).normal(
        size=(t_bwd.GRAD_ROWS, pool)).astype(np.float32)
    rows[:, total:] = 0.0
    return rows, offs_col, s_lo, n_pad


def plain_vs_pallas_segsum(got, pool, seed):
    """segment_sum_plain against segment_sum_pallas (interpret mode) on
    got's offsets, cum and total and a seeded row pool: each row within
    1e-5 of its largest sum. Returns the plain version's (9, n) sums."""
    n = got["offsets"].shape[0]
    rows, offs_col, s_lo, n_pad = seg_inputs(got, pool, seed)
    grads16 = np.zeros((SEG_ROWS, pool), np.float32)
    grads16[:9] = rows
    want = np.asarray(segment_sum_pallas(
        jnp.asarray(grads16), offs_col, s_lo,
        jnp.asarray(got["total"].numpy()), n_pad=n_pad, max_isects=pool,
        k_seg=K_SEG, interpret=True))[:9, :n]
    out = t_seg.segment_sum_plain(torch.tensor(rows), got["offsets"],
                                  got["cum"], got["total"]).numpy()
    assert out.shape == (9, n)
    for r in range(9):
        scale = np.abs(want[r]).max()
        assert np.abs(out[r] - want[r]).max() <= 1e-5 * scale, r
    return out


@pytest.mark.parametrize("case", HAND_LAYOUTS)
def test_segment_sum_plain_matches_pallas_on_hand_layouts(case):
    """Offsets made by hand (ops/cuda/testing.hand_segments): one segment
    longer than two of the TPU kernel's 512-record blocks, runs of empty
    splats between live ones, a straddle of `total`, and `total` 0."""
    offsets, cum, total = hand_segments(case)
    got = dict(offsets=torch.tensor(offsets), cum=torch.tensor(cum),
               total=torch.tensor(total))
    out = plain_vs_pallas_segsum(got, HAND_POOL, seed=6)
    live = (np.minimum(cum, total[0]) > offsets)
    assert live.any() == (case != "total_zero")
    assert not out[:, ~live].any()
    if live.any():
        assert np.abs(out[:, live]).max() > 0
    if case == "long_segment":
        assert (cum - offsets).max() > 2 * K_SEG
    if case == "empty_runs":
        inner = live[:int(np.flatnonzero(live)[-1])]
        assert (~inner).sum() >= 300   # empty splats between live ones
    if case == "straddle":
        w = int(np.flatnonzero(live)[-1])
        assert offsets[w] < total[0] < cum[w]


@pytest.mark.parametrize("name", ["small", "bbox_splats", "overflow"])
def test_segment_sum_plain_matches_pallas(name):
    """Per-splat sums on the pipeline's own offsets; relative error (to
    each row's largest sum) at most 1e-5. The overflow scene has a splat
    whose records straddle `total`: both keep only its live part."""
    n, img_size, pool, scale_hi = SCENES[name]
    got = port_records(make_scene(n, seed=13, scale_hi=scale_hi), img_size,
                       pool)
    out = plain_vs_pallas_segsum(got, pool, seed=4)
    if name == "overflow":
        cut = int(np.searchsorted(got["cum"].numpy(), int(got["total"][0]),
                                  side="right"))
        assert int(got["offsets"][cut]) < int(got["total"][0]) \
            < int(got["cum"][cut])
        assert not out[:, cut + 1:].any()


def test_oracle_grads_match_jax_with_detached_viewdir():
    """Regression: the port's view_colors let the SH colour's gradient
    flow into the means through the view direction, which the reference
    stops (render.py:262, rasterize_reference.py:85). At SH degree 2 with
    random higher-order coefficients that moved the means gradient by ~4 %
    of its largest value; detached, all five agree to float32 rounding."""
    sc = make_scene(40, seed=21, scale_hi=0.5, sh_degree=2)
    size = (32, 24)
    names = ["means", "log_scales", "quats", "sh_coeffs", "raw_opacity"]
    v = np.random.default_rng(22).normal(size=(24, 32, 4)).astype(np.float32)
    cpj = j_cp(JCamera(**CAM), size)

    def f(*p):
        return jnp.sum(j_oracle(*p, cpj, size) * v)

    want = jax.grad(f, argnums=tuple(range(5)))(
        *(jnp.asarray(sc[k]) for k in names))
    tp = [torch.tensor(sc[k], requires_grad=True) for k in names]
    out = render_oracle(*tp, camera_params(Camera(**CAM), size,
                                           device="cpu"), size)
    (out * torch.tensor(v)).sum().backward()
    for name, a, b in zip(names, want, tp):
        a, b = np.asarray(a), b.grad.numpy()
        scale = np.abs(a).max()
        assert scale > 0, name
        np.testing.assert_allclose(b / scale, a / scale, atol=2e-6,
                                   err_msg=name)


def test_bf16_pair_packing_matches_reference():
    """The grad re-sort's bf16 pairs: the same words as the reference's
    _pack_bf16_pair (round to nearest even, ties included), and the same
    floats back."""
    from brush_tpu.ops.pallas.raster_vjp import _pack_bf16_pair as j_pack
    from brush_tpu.ops.pallas.raster_vjp import _unpack_bf16_pair as j_unpack
    from brush_tpu_torch.ops.pipeline import _pack_bf16_pair, _unpack_bf16_pair

    rng = np.random.default_rng(5)
    a = (rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(
        np.float32)
    # Exact ties: the low 16 bits are 0x8000 (half way between two bf16s).
    ties = ((a.view(np.uint32) & 0xFFFF0000) | 0x8000).view(np.float32)
    a = np.concatenate([a, ties, np.float32([0.0, -0.0, 1.0, -3.5])])
    b = a[::-1].copy()
    words = _pack_bf16_pair(torch.tensor(a), torch.tensor(b))
    want = np.asarray(j_pack(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(u32(words), want)
    for got, ref in zip(_unpack_bf16_pair(words),
                        j_unpack(jnp.asarray(want))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
