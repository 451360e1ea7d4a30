"""The rasterizers on aligned records: the port's pack_isect_splats and
make_pallas_rasterizer against brush_tpu's (the Pallas kernels in
interpret mode, as tests/test_pallas_fwd.py and tests/test_pallas_bwd.py
run them), on the CPU.

The inputs are those JAX tests' own (`build_pipeline_inputs`' seeds and
sizes: projection and build_intersections(align=128) in JAX), passed to
both packages as numpy arrays; one more test runs the port's own
projection and binning into its rasterizer. The JAX side is computed once
a module (`reference`). Tolerances are the JAX tests': images within
assert_close_quantized, gradients within 3e-4 of each gradient's largest
|value|; the pool is bit-equal.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brush_tpu.ops.pallas.raster_vjp import (
    make_pallas_rasterizer as j_make_pallas_rasterizer,
)
from brush_tpu.ops.pallas.rasterize_fwd import pack_isect_splats as j_pack
from brush_tpu.ops.pallas.rasterize_fwd import (
    rasterize_fwd_pallas as j_rasterize_fwd,
)
from tests.conftest import assert_close_quantized
from tests.test_pallas_bwd import _grads as j_grads
from tests.test_pallas_fwd import build_pipeline_inputs

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.constants import SH_C0
from brush_tpu_torch.ops.binning import build_intersections
from brush_tpu_torch.ops import pipeline
from brush_tpu_torch.ops.cuda.rasterize_bwd import rasterize_bwd
from brush_tpu_torch.ops.cuda.rasterize_fwd import (
    pack_isect_splats, rasterize_fwd,
)
from brush_tpu_torch.ops.pipeline import make_pallas_rasterizer
from brush_tpu_torch.ops.projection import project_splats
from brush_tpu_torch.ops.rasterize_reference import camera_params
from brush_tpu_torch.ops.sh import sh_to_color
from torch_threads import pin_threads

pin_threads()

MAX_ISECTS = 1024
K_LANES = 128
NAMES = ("v_xy", "v_conic", "v_color", "v_opac")

# The JAX kernel tests' inputs: build_pipeline_inputs' arguments and the
# image cotangent's seed (None: a forward test; "zero": zeros).
CASES = {
    "fwd_matches_xla": (dict(), None),         # test_pallas_fwd.py:54
    "vjp_matches_xla": (dict(n=60, img_size=(48, 32), seed=3), 0),
    "zero_cotangent": (dict(n=30, img_size=(32, 32), seed=4), "zero"),
    "hyperbolic_conic": (dict(n=40, img_size=(48, 32), seed=7), 1),
}


def _case_inputs(name):
    """(xy, conic, color, opac, isect_gid, starts, ends) numpy and
    (tiles_x, num_tiles) of a case, as the JAX test builds them."""
    kw, _ = CASES[name]
    xy, conic, color, opac, isect, tiles_x, tiles_y = build_pipeline_inputs(
        max_isects=MAX_ISECTS, **kw)
    arrays = [np.array(a) for a in (xy, conic, color, opac, isect.isect_gid,
                                    isect.starts, isect.ends)]
    if name == "hyperbolic_conic":
        # tests/test_pallas_bwd.py:105-108: six compacted splats get an
        # indefinite conic and a corner centre after binning.
        arrays[1][:6] = np.float32([1.0, -1.5, 1.0])
        arrays[0][:6] = np.float32([4.0, 4.0])
    return arrays, tiles_x, tiles_x * tiles_y


def _cotangent(name, num_tiles):
    seed = CASES[name][1]
    if seed == "zero":
        return np.zeros((num_tiles, 256, 4), np.float32)
    return np.random.default_rng(seed).normal(
        size=(num_tiles, 256, 4)).astype(np.float32)


@functools.cache
def reference(name):
    """brush_tpu's pool, image and (with a cotangent) gradients of a case,
    the kernels in interpret mode."""
    arrays, tiles_x, num_tiles = _case_inputs(name)
    xy, conic, color, opac, gid, starts, ends = (jnp.asarray(a)
                                                 for a in arrays)
    tile_ids = jnp.arange(num_tiles, dtype=jnp.int32)
    pool = np.asarray(j_pack(xy, conic, color, opac, gid, MAX_ISECTS,
                             k_lanes=K_LANES))
    raster = j_make_pallas_rasterizer(tiles_x, num_tiles, MAX_ISECTS,
                                      K_LANES, interpret=True)
    img = np.asarray(raster(xy, conic, color, opac, gid, starts, ends,
                            tile_ids))
    grads = None
    if CASES[name][1] is not None:
        isect = types.SimpleNamespace(isect_gid=gid, starts=starts,
                                      ends=ends)
        grads = [np.asarray(g) for g in j_grads(
            raster, xy, conic, color, opac, isect, tile_ids,
            jnp.asarray(_cotangent(name, num_tiles)))]
    return pool, img, grads


def port_run(name, cotangent: bool):
    """The port's pool, image and (with the case's cotangent) gradients,
    on CPU tensors."""
    arrays, tiles_x, num_tiles = _case_inputs(name)
    params = [torch.tensor(a, requires_grad=cotangent) for a in arrays[:4]]
    gid, starts, ends = (torch.tensor(a) for a in arrays[4:])
    pool = pack_isect_splats(*(p.detach() for p in params), gid, MAX_ISECTS,
                             K_LANES)
    raster = make_pallas_rasterizer(tiles_x, num_tiles, MAX_ISECTS, K_LANES)
    img = raster(*params, gid, starts, ends,
                 torch.arange(num_tiles, dtype=torch.int32))
    grads = None
    if cotangent:
        (img * torch.tensor(_cotangent(name, num_tiles))).sum().backward()
        grads = [p.grad.numpy() for p in params]
    return pool.numpy(), img.detach().numpy(), grads


@pytest.mark.parametrize("name", list(CASES))
def test_pack_isect_splats_matches_reference(name):
    """The pool bit for bit: records, padding slots (splat n - 1's record,
    as JAX's clamping gather gives) and the k_lanes zero columns."""
    want = reference(name)[0]
    got, _, _ = port_run(name, cotangent=False)
    assert got.shape == (8, MAX_ISECTS + K_LANES)
    np.testing.assert_array_equal(got.view(np.uint32), want)
    arrays = _case_inputs(name)[0]
    n, gid = arrays[0].shape[0], arrays[4]
    assert (gid == n).any(), "the case has no padding slot"
    assert (got[7, :MAX_ISECTS][gid == n] == n - 1).all()
    assert not got[:, MAX_ISECTS:].any()


@pytest.mark.parametrize("name", list(CASES))
def test_aligned_image_matches_reference(name):
    """The image within assert_close_quantized of brush_tpu's
    make_pallas_rasterizer (tests/test_pallas_fwd.py:54-85's input and
    the backward tests')."""
    want = reference(name)[1]
    _, got, _ = port_run(name, cotangent=False)
    assert got.shape == want.shape
    assert_close_quantized(got, want, err_msg=name)
    assert got[..., 3].max() > 0.1


@pytest.mark.parametrize("name", ["vjp_matches_xla", "hyperbolic_conic"])
def test_aligned_grads_match_reference(name):
    """tests/test_pallas_bwd.py:23-54 and :57-130: each gradient within
    3e-4 of its largest |value| of brush_tpu's, and finite under the
    hyperbolic conics (sigma clamped before the exp in both kernels)."""
    want = reference(name)[2]
    _, _, got = port_run(name, cotangent=True)
    for label, a, b in zip(NAMES, want, got):
        assert np.isfinite(b).all(), f"{label} not finite"
        scale = np.abs(a).max() + 1e-8
        assert scale > 1e-6, f"{label} is zero in the reference"
        np.testing.assert_allclose(b / scale, a / scale, atol=3e-4,
                                   err_msg=f"{name}: {label}")


def test_aligned_backward_sums_in_slot_order_without_index_add(monkeypatch):
    """ROADMAP Queue 3 #12, closed: the aligned backward calls no
    index_add_ (a float scatter-add, atomic on CUDA tensors) outside
    segment_sum, which it calls once; each splat's gradient is the sum of
    its records' rows in slot order, bit for bit, with the padding slots
    and the slack lanes left out."""
    name = "vjp_matches_xla"
    arrays, tiles_x, num_tiles = _case_inputs(name)
    params = [torch.tensor(a, requires_grad=True) for a in arrays[:4]]
    gid, starts, ends = (torch.tensor(a) for a in arrays[4:])
    v = torch.tensor(_cotangent(name, num_tiles))
    calls, inside = [], [False]
    index_add = torch.Tensor.index_add_
    segment_sum = pipeline.segment_sum

    def spy_index_add(self, *args, **kwargs):
        calls.append(("index_add_", inside[0]))
        return index_add(self, *args, **kwargs)

    def spy_segment_sum(*args):
        calls.append(("segment_sum", False))
        inside[0] = True
        try:
            return segment_sum(*args)
        finally:
            inside[0] = False

    monkeypatch.setattr(torch.Tensor, "index_add_", spy_index_add)
    monkeypatch.setattr(pipeline, "segment_sum", spy_segment_sum)
    raster = make_pallas_rasterizer(tiles_x, num_tiles, MAX_ISECTS, K_LANES)
    img = raster(*params, gid, starts, ends, torch.arange(num_tiles))
    (img * v).sum().backward()
    monkeypatch.undo()
    assert ("segment_sum", False) in calls
    assert calls.count(("segment_sum", False)) == 1
    assert ("index_add_", False) not in calls

    n = arrays[0].shape[0]
    packed = pack_isect_splats(*(p.detach() for p in params), gid,
                               MAX_ISECTS, K_LANES)
    _, log_t, fidx = rasterize_fwd(packed, starts, ends, tiles_x)
    rows = rasterize_bwd(packed, starts, ends, tiles_x, v, log_t, fidx)
    want = torch.zeros((9, n), dtype=torch.float32)
    ids = torch.cat([gid.to(torch.int64), torch.full(
        (rows.shape[1] - gid.shape[0],), n, dtype=torch.int64)])
    for slot, w in enumerate(ids.tolist()):
        if w < n:
            want[:, w] = want[:, w] + rows[:, slot]
    assert (ids == n).any() and want.abs().max() > 0
    for p, lo, hi in zip(params, (0, 2, 5, 8), (2, 5, 8, 9)):
        got = p.grad.reshape(n, -1)
        assert torch.equal(got, want[lo:hi].T), (lo, hi)


def test_aligned_zero_cotangent():
    """tests/test_pallas_bwd.py:57-72: a zero cotangent gives exact zeros."""
    for arr in reference("zero_cotangent")[2]:
        np.testing.assert_array_equal(arr, 0.0)
    _, _, got = port_run("zero_cotangent", cotangent=True)
    for label, arr in zip(NAMES, got):
        np.testing.assert_array_equal(arr, 0.0, err_msg=label)


def test_aligned_empty_tiles():
    """tests/test_pallas_fwd.py:88-101: all-empty bins give a black image
    and final_idx -1, as brush_tpu's kernel does; through
    make_pallas_rasterizer too (every slot padding), and with no splat at
    all (JAX's gather refuses n = 0; the port's pool stays zero)."""
    num_tiles, tiles_x, max_isects = 6, 3, 256
    zeros = np.zeros(num_tiles, np.int32)
    want = j_rasterize_fwd(
        jnp.zeros((8, max_isects + 128), jnp.uint32), jnp.asarray(zeros),
        jnp.asarray(zeros), jnp.arange(num_tiles, dtype=jnp.int32),
        tiles_x=tiles_x, num_tiles=num_tiles, max_isects=max_isects,
        k_lanes=128, interpret=True)
    got = rasterize_fwd(torch.zeros((8, max_isects + 128), dtype=torch.int32),
                        torch.tensor(zeros), torch.tensor(zeros), tiles_x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[2].numpy(), -1)

    raster = make_pallas_rasterizer(tiles_x, num_tiles, max_isects, 128)
    tile_ids = torch.arange(num_tiles)
    for n in (5, 0):
        params = [torch.rand(n, c, requires_grad=True) for c in (2, 3, 3)]
        params.append(torch.rand(n, requires_grad=True))
        gid = torch.full((max_isects,), n)
        img = raster(*params, gid, torch.tensor(zeros), torch.tensor(zeros),
                     tile_ids)
        assert tuple(img.shape) == (num_tiles, 256, 4)
        assert not img.any()
        img.sum().backward()
        for p in params:
            assert p.grad.shape == p.shape and not p.grad.any()


def test_aligned_tile_ids_must_be_contiguous():
    """The kernels take a strip's first tile: a contiguous run from any
    tile is accepted (the image's tiles from there), anything else raises."""
    arrays, tiles_x, num_tiles = _case_inputs("fwd_matches_xla")
    args = [torch.tensor(a) for a in arrays]
    raster = make_pallas_rasterizer(tiles_x, num_tiles, MAX_ISECTS, K_LANES)
    ids = torch.arange(num_tiles, dtype=torch.int32)
    for bad in (ids.flip(0), torch.cat([ids[:2], ids[3:], ids[2:3]]),
                ids - 1, ids[:-1]):
        with pytest.raises(ValueError, match="tile_ids"):
            raster(*args, bad)
    # A strip from the second tile row, fed the frame's ranges from there:
    # its tiles are the frame's.
    frame = raster(*args, ids)
    tx = tiles_x
    starts, ends = (torch.cat([t[tx:], t[:tx]]) for t in args[5:7])
    strip = raster(*args[:5], starts, ends, ids + tx)
    assert frame[tx:].any()
    assert torch.equal(strip[:num_tiles - tx], frame[tx:])


def _port_pipeline_inputs(n=80, img_size=(48, 32), seed=0,
                          max_isects=MAX_ISECTS):
    """build_pipeline_inputs' scene through the port's own projection, SH
    and build_intersections(max_isects, align=128), on CPU tensors."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2.5, 2.5, size=(n, 3)).astype(np.float32)
    log_scales = np.log(rng.uniform(0.1, 0.8, size=(n, 3))).astype(
        np.float32)
    quats = rng.normal(size=(n, 4))
    quats = (quats / np.linalg.norm(quats, axis=-1, keepdims=True)).astype(
        np.float32)
    colors = rng.uniform(0, 1, size=(n, 3))
    sh = ((colors[:, None, :] - 0.5) / SH_C0).astype(np.float32)
    opac_raw = np.log(rng.uniform(0.2, 0.9, n)
                      / (1 - rng.uniform(0.2, 0.9, n))).astype(np.float32)
    cam = Camera(position=[0, 0, -8], rotation=[1, 0, 0, 0],
                 fov_x=np.pi / 2, fov_y=np.pi / 2)
    cp = camera_params(cam, img_size, device="cpu")
    means_t = torch.tensor(means)
    proj = project_splats(means_t, torch.tensor(log_scales),
                          torch.tensor(quats), cp.viewmat, cp.focal,
                          cp.pixel_center, img_size)
    viewdir = means_t - cp.viewmat[:3, 3]
    viewdir = viewdir / viewdir.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    color = sh_to_color(0, viewdir, torch.tensor(sh))
    opac = torch.sigmoid(torch.tensor(opac_raw))
    tiles_x, tiles_y = -(-img_size[0] // 16), -(-img_size[1] // 16)
    isect = build_intersections(proj, opac, (tiles_x, tiles_y), max_isects,
                                align=K_LANES)
    o = isect.order
    return (proj.xy[o], proj.conic[o], color[o], opac[o], isect, tiles_x,
            tiles_x * tiles_y)


def test_aligned_slice_matches_reference():
    """The slice end to end: the port's projection, binning (aligned to
    128) and rasterizer against brush_tpu's on the same scene, image and
    gradients within the JAX tests' tolerances."""
    xy, conic, color, opac, isect, tiles_x, num_tiles = \
        _port_pipeline_inputs()
    assert int(isect.num_dropped) == 0
    starts, ends = isect.starts, isect.ends
    assert bool(((starts % K_LANES) == 0).all())
    # The records are brush_tpu's (the projections agree to a few ulps).
    j_records = _case_inputs("fwd_matches_xla")[0][4:]
    for got, want in zip((isect.isect_gid, starts, ends), j_records):
        np.testing.assert_array_equal(got.numpy(), want)
    params = [t.detach().clone().requires_grad_(True)
              for t in (xy, conic, color, opac)]
    raster = make_pallas_rasterizer(tiles_x, num_tiles, MAX_ISECTS, K_LANES)
    img = raster(*params, isect.isect_gid, starts, ends,
                 torch.arange(num_tiles))
    assert_close_quantized(img.detach().numpy(),
                           reference("fwd_matches_xla")[1], err_msg="slice")

    v = np.random.default_rng(2).normal(size=(num_tiles, 256, 4)).astype(
        np.float32)
    (img * torch.tensor(v)).sum().backward()
    j_in = [jnp.asarray(a) for a in _case_inputs("fwd_matches_xla")[0]]
    j_raster = j_make_pallas_rasterizer(tiles_x, num_tiles, MAX_ISECTS,
                                        K_LANES, interpret=True)

    def loss(xy, conic, color, opac):
        return jnp.sum(j_raster(xy, conic, color, opac, *j_in[4:],
                                jnp.arange(num_tiles, dtype=jnp.int32))
                       * jnp.asarray(v))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*j_in[:4])
    for label, a, p in zip(NAMES, want, params):
        a, b = np.asarray(a), p.grad.numpy()
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=3e-4,
                                   err_msg=label)


def test_aligned_num_dropped_undercounts_like_the_reference():
    """ROADMAP Queue 3 #11, pinned: a pool of 512 holds the scene's 219
    records, but aligned to 128 its six tiles need 640 + 23 slots, so the
    last two tiles' records fall past the pool. Both packages count
    num_dropped before the re-layout (brush_tpu/ops/binning.py:570) and
    report 0; their pools are the same, bit for bit."""
    pool = 512
    want = build_pipeline_inputs(max_isects=pool)[4]
    got = _port_pipeline_inputs(max_isects=pool)[4]
    for field in ("isect_gid", "starts", "ends", "num_isects",
                  "num_dropped"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    kept = int((got.ends - got.starts).sum())
    assert int(got.num_dropped) == 0
    assert kept < int(got.num_isects) == 219 <= pool
