"""The port's datasets against brush_tpu's: NeRF and COLMAP loading,
streaming, initial splats, the random-view loader, the PNG codec against
Pillow, PLY export and streamed import, safetensors and the native
points3D parser. Inputs are made from seeds with numpy; the writers are
brush_tpu_torch/datasets/testing.py's."""

import io
import struct
import sys
import zipfile
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from brush_tpu.datasets import load_dataset as j_load_dataset
from brush_tpu.datasets import load_initial_splats as j_load_initial
from brush_tpu.datasets.colmap import _read_points3d_bin as j_points_py
from brush_tpu.datasets.loader import SceneLoader as JSceneLoader
from brush_tpu.datasets.loading import LoadDatasetArgs as JArgs
from brush_tpu.datasets.loading import _decode_image as j_decode
from brush_tpu.datasets.loading import load_dataset_stream as j_stream
from brush_tpu.datasets.ply import load_splats_from_ply as j_load_ply
from brush_tpu.datasets.ply import splats_to_ply as j_to_ply
from brush_tpu.splats import from_random as j_from_random

from brush_tpu_torch import native
from brush_tpu_torch.convert import splats_from_numpy
from brush_tpu_torch.datasets import load_dataset, load_initial_splats, png
from brush_tpu_torch.datasets import loading
from brush_tpu_torch.datasets import testing as dt
from brush_tpu_torch.datasets.colmap import _read_points3d_bin
from brush_tpu_torch.datasets.loader import SceneLoader
from brush_tpu_torch.datasets.loading import (
    LoadDatasetArgs, _decode_image, load_dataset_stream,
)
from brush_tpu_torch.datasets.ply import (
    load_splats_from_ply, load_splats_from_ply_stream, splats_to_ply,
)
from brush_tpu_torch.datasets.scene import has_alpha
from brush_tpu_torch.splats import from_safetensors

SH_C0 = 0.28209479177387814


def smooth_image(rng, h, w, c):
    """A uint8 (h, w, c) image of smooth gradients and a little noise: the
    row filters then have something to predict."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    chans = [np.sin(3 * xx * rng.uniform(1, 4) + yy * rng.uniform(1, 4)
                    + rng.uniform(0, 6)) for _ in range(c)]
    img = 0.5 + 0.4 * np.stack(chans, -1) + rng.normal(0, 0.03, (h, w, c))
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def pillow_png(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG", **kw)
    return buf.getvalue()


def pillow_array(data):
    """What the reference's image_to_array gives, as uint8."""
    im = Image.open(io.BytesIO(data))
    return np.asarray(im.convert("RGBA" if has_alpha(im) else "RGB"))


def nerf_zip(n_train=5, n_val=2, size=(20, 24), prefix="",
             encode=png.encode_png):
    rng = np.random.default_rng(11)
    splits = {"train": [(c, smooth_image(rng, *size, 4))
                        for c in dt.orbit_views(n_train, seed=1)]}
    if n_val:
        splits["val"] = [(c, smooth_image(rng, *size, 4))
                         for c in dt.orbit_views(n_val, seed=2)]
    buf = io.BytesIO()
    dt.write_nerf_zip(buf, splits, prefix=prefix, encode=encode)
    return buf.getvalue()


def colmap_points(n=300, seed=12):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.6, (n, 3)),
            rng.integers(0, 256, (n, 3)).astype(np.uint8))


def colmap_zip(binary=True, n=5, size=24, prefix="scene/"):
    rng = np.random.default_rng(13)
    views = [(c, smooth_image(rng, size, size, 3))
             for c in dt.orbit_views(n, seed=1)]
    buf = io.BytesIO()
    dt.write_colmap_zip(buf, views, size, *colmap_points(), binary=binary,
                        prefix=prefix, encode=pillow_png)
    return buf.getvalue()


def assert_scene_equal(t, j):
    assert (t is None) == (j is None)
    if t is None:
        return
    assert [v.name for v in t.views] == [v.name for v in j.views]
    for tv, jv in zip(t.views, j.views):
        for f in ("position", "rotation", "center_uv"):
            np.testing.assert_allclose(getattr(tv.camera, f),
                                       getattr(jv.camera, f), rtol=0,
                                       atol=1e-12, err_msg=f)
        assert abs(tv.camera.fov_x - jv.camera.fov_x) <= 1e-12
        assert abs(tv.camera.fov_y - jv.camera.fov_y) <= 1e-12
        assert tv.image.dtype == jv.image.dtype == np.float32
        assert tv.image.shape == jv.image.shape
        assert tv.image.tobytes() == jv.image.tobytes(), tv.name


def assert_dataset_equal(t, j):
    assert_scene_equal(t.train, j.train)
    assert_scene_equal(t.eval, j.eval)


NERF_CASES = {
    # (n_val, eval_split_every, faithful_nerf_split, prefix, max_frames)
    "val": (2, None, False, "", None),
    "val_split": (2, 2, False, "lego/", None),
    "val_split_faithful": (2, 2, True, "lego/", None),
    "no_val_split": (0, 2, False, "", 4),
    "no_val_split_faithful": (0, 2, True, "a/b/", None),
}


@pytest.mark.parametrize("case", sorted(NERF_CASES))
def test_nerf_zip_loads_like_reference(case):
    n_val, every, faithful, prefix, frames = NERF_CASES[case]
    data = nerf_zip(n_val=n_val, prefix=prefix, encode=dt.filtered_png)
    kw = dict(eval_split_every=every, faithful_nerf_split=faithful,
              max_frames=frames)
    t = load_dataset(data, LoadDatasetArgs(**kw))
    j = j_load_dataset(data, JArgs(**kw))
    assert_dataset_equal(t, j)
    assert len(t.train.views) > 0


@pytest.mark.parametrize("binary", [True, False])
def test_colmap_zip_loads_like_reference(binary):
    data = colmap_zip(binary=binary)
    args = dict(eval_split_every=3)
    t = load_dataset(data, LoadDatasetArgs(**args))
    j = j_load_dataset(data, JArgs(**args))
    assert_dataset_equal(t, j)
    assert len(t.train.views) == 3 and len(t.eval.views) == 2
    assert t.train.views[0].image.shape == (24, 24, 3)


def test_directory_source_loads_like_zip(tmp_path):
    data = nerf_zip(prefix="scene/")
    zipfile.ZipFile(io.BytesIO(data)).extractall(tmp_path)
    zp = tmp_path / "scene.zip"
    zp.write_bytes(data)
    assert_dataset_equal(load_dataset(str(tmp_path)),
                         j_load_dataset(str(zp)))


@pytest.mark.parametrize("fmt", ["nerf", "colmap"])
def test_dataset_stream_matches_reference(fmt):
    data = nerf_zip(n_train=7, n_val=0) if fmt == "nerf" else colmap_zip()
    args = dict(eval_split_every=3)
    ts = list(load_dataset_stream(data, LoadDatasetArgs(**args), every=2))
    js = list(j_stream(data, JArgs(**args), every=2))
    assert len(ts) == len(js) > 1
    for t, j in zip(ts, js):
        assert_dataset_equal(t, j)
    assert_dataset_equal(ts[-1], j_load_dataset(data, JArgs(**args)))


def test_max_resolution_matches_reference():
    data = nerf_zip(n_train=2, n_val=0, size=(40, 30))
    t = load_dataset(data, LoadDatasetArgs(max_resolution=16))
    j = j_load_dataset(data, JArgs(max_resolution=16))
    assert_dataset_equal(t, j)
    assert t.train.views[0].image.shape == (16, 12, 4)


def test_init_ply_takes_precedence_under_a_prefix():
    js = j_from_random(np.random.default_rng(4), [-1] * 3, [1] * 3,
                       count=7, sh_degree=1)
    buf = io.BytesIO(colmap_zip(prefix="scene/"))
    with zipfile.ZipFile(buf, "a") as zf:
        zf.writestr("scene/init.ply", j_to_ply(js))
    t = load_initial_splats(buf.getvalue(), sh_degree=0, device="cpu")
    j = j_load_initial(buf.getvalue(), sh_degree=0)
    assert t.n_live == int(j.n_live) == 7
    for k, v in t.params().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j.params()[k]))


@pytest.mark.parametrize("binary", [True, False])
def test_colmap_points_init_matches_reference(binary):
    data = colmap_zip(binary=binary)
    t = load_initial_splats(data, sh_degree=2, device="cpu")
    j = j_load_initial(data, sh_degree=2)
    pts, cols = colmap_points()
    assert t.n_live == int(j.n_live) == len(pts)
    assert t.capacity == j.capacity
    jp = {k: np.asarray(v) for k, v in j.params().items()}
    for k in ("means", "sh_coeffs", "quats", "raw_opacity"):
        np.testing.assert_array_equal(t.params()[k].numpy(), jp[k], k)
    np.testing.assert_allclose(
        t.sh_coeffs[:len(pts), 0].numpy(),
        (cols.astype(np.float32) / 255.0 - 0.5) / SH_C0, rtol=1e-6)
    # The reference's 3-NN is its native KD-tree; the port's sums float32
    # differences on the device.
    np.testing.assert_allclose(t.log_scales.numpy(), jp["log_scales"],
                               rtol=0, atol=1e-6)
    assert load_initial_splats(nerf_zip(), device="cpu") is None


def test_scene_loader_draws_like_reference():
    data = nerf_zip(n_train=6, n_val=0)
    t_ds = load_dataset(data)
    j_ds = j_load_dataset(data)
    draws = []
    for loader, ds in ((SceneLoader(t_ds.train, seed=42), t_ds),
                       (JSceneLoader(j_ds.train, seed=42), j_ds)):
        try:
            batches = [loader.next_batch() for _ in range(20)]
        finally:
            loader.close()
        ids = {id(v.image): i for i, v in enumerate(ds.train.views)}
        # Each batch holds its view's own array (the trainer's gt cache is
        # keyed by its identity), never a copy.
        draws.append([ids[id(b.gt_image)] for b in batches])
        assert all(b.scene_extent == ds.train.extent_max() for b in batches)
    assert draws[0] == draws[1]
    assert len(set(draws[0])) > 1


PNG_CASES = ["grey", "grey_alpha", "rgb", "rgba", "palette",
             "palette_trns", "palette_one_transparent", "palette_short",
             "grey_trns", "rgb_trns", "rgba_pillow_adaptive"]


def short_palette_png(rng):
    """A palette PNG whose indices run past its 3-entry PLTE and its
    2-entry tRNS (those pixels read as opaque black)."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    idx = rng.integers(0, 6, (9, 7)).astype(np.uint8)
    rows = np.zeros((9, 8), np.uint8)
    rows[:, 1:] = idx
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 9, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", bytes(range(10, 100, 10)))
            + chunk(b"tRNS", b"\x10\x20")
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def png_case(case, rng):
    img = smooth_image(rng, 23, 31, 4)
    if case == "grey":
        return pillow_png(img[..., 0])
    if case == "grey_alpha":
        return pillow_png(np.ascontiguousarray(img[..., 1:3]))
    if case == "rgb":
        return dt.filtered_png(img[..., :3])
    if case == "rgba":
        return dt.filtered_png(img)
    if case == "rgba_pillow_adaptive":
        return pillow_png(img)
    if case == "palette_short":
        return short_palette_png(rng)
    if case.startswith("palette"):
        pal = Image.fromarray(img[..., :3]).convert(
            "P", palette=Image.ADAPTIVE, colors=40)
        kw = {"palette": {}, "palette_trns": {
            "transparency": bytes(range(0, 240, 6))},
            "palette_one_transparent": {"transparency": 3}}[case]
        buf = io.BytesIO()
        pal.save(buf, "PNG", **kw)
        return buf.getvalue()
    if case == "grey_trns":
        return pillow_png(img[..., 0], transparency=int(img[3, 3, 0]))
    return pillow_png(np.ascontiguousarray(img[..., :3]),
                      transparency=tuple(int(v) for v in img[2, 2, :3]))


@pytest.mark.parametrize("case", PNG_CASES)
def test_png_decode_is_byte_equal_to_pillow(case):
    data = png_case(case, np.random.default_rng(PNG_CASES.index(case)))
    got = png.decode_png(data)
    want = pillow_array(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # And the loader's float image is the reference loader's, bit for bit.
    assert _decode_image(data, None).tobytes() == j_decode(data, None).tobytes()
    if case.endswith("trns") or case in ("palette_one_transparent",
                                         "palette_short"):
        assert got.shape[2] == 4 and (got[..., 3] < 255).any()


@pytest.mark.parametrize("kind", range(5))
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_each_row_filter_matches_pillow(kind, channels):
    img = smooth_image(np.random.default_rng(kind), 17, 13, channels)
    img = img[..., 0] if channels == 1 else img
    data = dt.filtered_png(img, [kind] * 17)
    np.testing.assert_array_equal(png.decode_png(data), pillow_array(data))


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (3, 40), (40, 3)])
def test_png_wavefront_edge_shapes_match_pillow(shape, monkeypatch):
    """The native unfilter, and on a host without a compiler the numpy
    wavefront (Average and Paeth rows along anti-diagonals), on images one
    pixel wide or tall and diagonals cut by the first or last row."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    img = rng.integers(0, 256, (*shape, 4), np.uint8)
    kinds = np.resize([4, 3, 1, 4, 2, 0, 3], shape[0])
    data = dt.filtered_png(img, kinds)
    want = pillow_array(data)
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(png.decode_png(data), want)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(png.decode_png(data), want)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_numpy_unfilter_matches_native(channels, monkeypatch):
    """Every filter, mixed, and only the three that need no left
    neighbour: numpy's unfilter equals the native library's, which the
    Pillow tests above hold."""
    rng = np.random.default_rng(channels)
    img = smooth_image(rng, 29, 21, channels)
    img = img[..., 0] if channels == 1 else img
    cases = [rng.integers(0, 5, 29), rng.integers(0, 3, 29)]
    natives = [png.decode_png(dt.filtered_png(img, k)) for k in cases]
    bad = np.zeros((4, 7), np.uint8)
    bad[2, 0] = 5
    with pytest.raises(ValueError, match="row filter 5"):
        native.png_unfilter(bad, 1)
    monkeypatch.setattr(native, "available", lambda: False)
    for k, want in zip(cases, natives):
        np.testing.assert_array_equal(png.decode_png(dt.filtered_png(img, k)),
                                      want)
    with pytest.raises(ValueError, match="row filter 5"):
        png._unfilter(bad.reshape(-1), 4, 6, 1)


def test_png_mixed_filters_and_encode_round_trip():
    rng = np.random.default_rng(3)
    img = smooth_image(rng, 40, 33, 4)
    kinds = rng.integers(0, 5, 40)
    data = dt.filtered_png(img, kinds)
    np.testing.assert_array_equal(png.decode_png(data), img)
    for c in (1, 3, 4):
        im = img[..., 0] if c == 1 else np.ascontiguousarray(img[..., :c])
        out = np.asarray(Image.open(io.BytesIO(png.encode_png(im))))
        np.testing.assert_array_equal(out, im)
        assert png.decode_png(png.encode_png(im)).shape[:2] == im.shape[:2]
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(img.astype(np.float32))
    bad = bytearray(data)
    bad[40] ^= 1   # the first IDAT's chunk type: its CRC fails
    with pytest.raises(ValueError):
        png.decode_png(bytes(bad))


def test_decoder_is_chosen_by_the_header(monkeypatch):
    """8-bit PNGs that need no resize decode without Pillow; JPEG, 16-bit
    PNG and a resize go to Pillow and, without it, raise ImportError
    naming the format."""
    rng = np.random.default_rng(5)
    img = smooth_image(rng, 20, 20, 3)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    jpeg = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(buf, "PNG")
    png16 = buf.getvalue()
    assert png.read_header(png16).bit_depth == 16
    rgb = pillow_png(img)
    for data in (jpeg, png16):
        np.testing.assert_array_equal(_decode_image(data, None),
                                      j_decode(data, None))
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(_decode_image(rgb, None),
                                  img.astype(np.float32) / 255.0)
    assert _decode_image(rgb, 20).shape == (20, 20, 3)
    with pytest.raises(ImportError, match="JPEG"):
        _decode_image(jpeg, None)
    with pytest.raises(ImportError, match="16-bit"):
        _decode_image(png16, None)
    with pytest.raises(ImportError, match="max_resolution"):
        _decode_image(rgb, 10)


@pytest.fixture
def fresh_png_route():
    """png_route chosen anew in the test, and again after it."""
    loading.png_route.cache_clear()
    yield
    loading.png_route.cache_clear()


def test_png_route_without_native_is_pillow_then_numpy(monkeypatch,
                                                       fresh_png_route):
    """With the native library hidden, 8-bit PNGs (every colour type, a
    palette with tRNS, all five row filters) go to Pillow where it imports
    (the numpy unfilter is never called) and to the numpy unfilter where it
    does not; both give the bytes of the native route."""
    rng = np.random.default_rng(12)
    datas = []
    for channels in (1, 2, 3, 4):
        img = smooth_image(rng, 23, 19, channels)
        img = img[..., 0] if channels == 1 else img
        datas.append(dt.filtered_png(img, rng.integers(0, 5, 23)))
    pal = Image.fromarray(smooth_image(rng, 16, 16, 3)).quantize(32)
    pal.info["transparency"] = 3
    buf = io.BytesIO()
    pal.save(buf, "PNG", transparency=3)
    datas.append(buf.getvalue())
    assert loading.png_route() == "native"
    want = [_decode_image(d, None) for d in datas]

    unfilter = png._unfilter_wavefront
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(png, "_unfilter_wavefront", lambda *a: pytest.fail(
        "the numpy unfilter ran with Pillow installed"))
    loading.png_route.cache_clear()
    assert loading.png_route() == "pillow"
    for d, w in zip(datas, want):
        np.testing.assert_array_equal(_decode_image(d, None), w)

    monkeypatch.setattr(png, "_unfilter_wavefront", unfilter)
    monkeypatch.setitem(sys.modules, "PIL", None)
    loading.png_route.cache_clear()
    assert loading.png_route() == "numpy"
    for d, w in zip(datas, want):
        np.testing.assert_array_equal(_decode_image(d, None), w)


def test_splats_to_ply_matches_reference_export():
    js = j_from_random(np.random.default_rng(6), [-1] * 3, [1] * 3,
                       count=37, sh_degree=2, capacity=64)
    params = {k: np.asarray(v) for k, v in js.params().items()}
    ts = splats_from_numpy(params, int(js.n_live), device="cpu")
    ours, theirs = splats_to_ply(ts), j_to_ply(js)
    head_t, body_t = ours.split(b"end_header\n")
    head_j, body_j = theirs.split(b"end_header\n")
    props = lambda h: [ln for ln in h.split(b"\n")
                       if not ln.startswith(b"comment")]
    assert props(head_t) == props(head_j)
    assert body_t == body_j and len(body_t) == 37 * (14 + 24) * 4
    back = load_splats_from_ply(ours, capacity=64, device="cpu")
    assert back.n_live == 37
    jb = j_load_ply(theirs, capacity=64)
    for k, v in back.params().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jb.params()[k]))
    np.testing.assert_array_equal(back.means[:37].numpy(),
                                  params["means"][:37])


def test_ply_stream_chunks_match_reference():
    from brush_tpu.datasets.ply import load_splats_from_ply_stream as j_s

    js = j_from_random(np.random.default_rng(7), [-1] * 3, [1] * 3,
                       count=25, sh_degree=1)
    data = j_to_ply(js)
    ts = list(load_splats_from_ply_stream(data, chunk=10, device="cpu"))
    jss = list(j_s(data, chunk=10))
    assert [t.n_live for t in ts] == [int(j.n_live) for j in jss] == [10, 25]
    for t, j in zip(ts, jss):
        assert t.capacity == j.capacity
        for k, v in t.params().items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(j.params()[k]))


def test_from_safetensors_round_trip(tmp_path):
    from safetensors.numpy import save_file

    from brush_tpu.splats import from_safetensors as j_from_safetensors

    rng = np.random.default_rng(8)
    n = 9
    d = {"means": rng.normal(size=(n, 3)), "scales": rng.normal(size=(n, 3)),
         "coeffs": rng.normal(size=(n, 4, 3)), "quats": rng.normal(size=(n, 4)),
         "opacities": rng.normal(size=(n,))}
    path = str(tmp_path / "m.safetensors")
    save_file({k: v.astype(np.float32) for k, v in d.items()}, path)
    t = from_safetensors(path, device="cpu")
    j = j_from_safetensors(path)
    assert t.n_live == n and t.sh_count == 4 and t.capacity == j.capacity
    for k, v in t.params().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j.params()[k]))


def test_native_points3d_matches_python_parser():
    pts, cols = colmap_points(n=1000, seed=9)
    rec = np.zeros(len(pts), dt.POINT3D_BIN)
    rec["xyz"], rec["rgb"] = pts, cols
    data = struct.pack("<Q", len(pts)) + rec.tobytes()
    # A track on some points: the parser must skip it.
    tracked = struct.pack("<Q", 2) + rec[:1].tobytes()[:-8] + struct.pack(
        "<Q", 3) + b"\x01" * 24 + rec[1:2].tobytes()
    assert native.available()
    for blob in (data, tracked):
        pos_n, rgb_n = native.read_points3d_bin(blob)
        pos_p, rgb_p = _read_points3d_bin(blob)
        np.testing.assert_array_equal(pos_n, pos_p)
        np.testing.assert_array_equal(rgb_n, rgb_p)
        jp, jc = j_points_py(blob)
        np.testing.assert_array_equal(pos_p, jp)
        np.testing.assert_array_equal(rgb_p, jc)
    for bad in (struct.pack("<Q", 5) + b"\x00" * 10,
                struct.pack("<Q", 2) + rec[:1].tobytes()):
        with pytest.raises(ValueError):
            native.read_points3d_bin(bad)


def test_colmap_twin_of_a_nerf_scene_has_its_cameras():
    """COLMAP poses written from in_nerf_loader_frame(c2w) load as the
    cameras the NeRF loader makes of c2w (chip_smoke.py's COLMAP castle
    relies on it: the castle's means are its point cloud)."""
    rng = np.random.default_rng(14)
    c2ws = dt.orbit_views(4, seed=1)
    imgs = [smooth_image(rng, 24, 24, 3) for _ in c2ws]
    nerf_buf, col_buf = io.BytesIO(), io.BytesIO()
    dt.write_nerf_zip(nerf_buf, {"train": list(zip(c2ws, imgs))})
    dt.write_colmap_zip(col_buf, [(dt.in_nerf_loader_frame(c), im)
                                  for c, im in zip(c2ws, imgs)], 24,
                        *colmap_points(), fov_x=dt.CASTLE_FOV_X)
    t_nerf = load_dataset(nerf_buf.getvalue())
    t_col = load_dataset(col_buf.getvalue())
    for a, b in zip(t_nerf.train.views, t_col.train.views):
        np.testing.assert_allclose(b.camera.position, a.camera.position,
                                   atol=1e-9)
        np.testing.assert_allclose(b.camera.world_to_local(),
                                   a.camera.world_to_local(), atol=1e-9)
        assert abs(b.camera.fov_x - a.camera.fov_x) < 1e-9
        np.testing.assert_array_equal(b.image, a.image)
