"""Plain PyTorch reference of the splat render and of one training step.

What the benchmark holds the program to. It imports nothing of the
program: the semantics are those of Brush's renderer as the program
states them (3D gaussian splatting, Kerbl et al. 2023; EWA projection
with a 0.3 px blur, SH colour, front-to-back compositing of 16 x 16
tiles), written out again here in float32 with TF32 off:

- projection: world to view, the 3D covariance R S S^T R^T, the
  frustum-clamped Jacobian, the 2D covariance and its conic, the 3-sigma
  pixel radius of the conic and the tile bbox it gives; a splat is drawn
  when its depth is past the near plane (0.01), its 2D covariance is
  invertible and its tile bbox is not empty;
- colour: SH to degree 3 with the view direction taken from the
  world-to-view matrix's translation column (the renderer's convention),
  plus 0.5, held to the record format's range [-4, 4] (the gradient
  passes that clamp straight through, as it passes the format's
  quantization);
- records: one a (drawn splat, tile of its bbox), in tile order and by
  depth within a tile; a splat whose bbox spans at most 8 x 8 tiles
  keeps only the tiles its 1/255-alpha ellipse touches (Brush's tile
  test, helpers.wgsl), a larger one every tile of its bbox. A tile's
  records hold the slots [start, start + count) of one list, the tiles'
  counts summed in order;
- compositing: a splat reaches the pixels of its tiles, in depth order;
  alpha = min(0.999, o exp(-sigma)), a pair counts where sigma >= 0 and
  alpha >= 1/255, and a pixel takes a splat only while its
  transmittance after the splat stays above 1e-4. The image is RGB plus
  alpha = 1 - T. The gradient of alpha is that of o exp(-sigma), the
  clamp at 0.999 passed through, as Brush's backward takes it;
- the log-T scan: log T is the sum of the terms log(1 - alpha). With
  `scan` = (passes, lanes), passes < 3, a tile's records go in batches of
  `lanes` slots from its start's slot rounded down to a multiple of 128;
  within a batch the running sum that T and the 1e-4 test read takes
  each term as the sum of its first `passes` bfloat16 parts (each
  rounded to nearest even from what the ones before left), and a batch
  starts from the exact sum of the terms before it. That is the
  truncated scan Brush's TPU renderer ships (scan_passes=2); passes 3 or
  no `scan` is the exact sum. The parts pass the gradient straight
  through;
- loss: (1 - 0.2) L1 - 0.2 SSIM (11 x 11 gaussian window, sigma 1.5,
  zero padding 6), L1 over the ground truth's channels, SSIM over RGB;
- Adam with per-group learning rates (the higher SH orders at 1/20).

The rasterizer works in blocks of tiles: the image first without
gradients, then dL/dimage from the loss, then each block again with
autograd, its gradients gathered into the per-splat attributes, and
last the projection's and colour's backward. Under `precision(True)`
every matrix product of it (projection, SH, compositing, SSIM) is
computed in TF32: the control of the benchmark's comparison.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16
COV_BLUR = 0.3
NEAR_PLANE_Z = 0.01
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.999
LOG_T_EPS = math.log(1e-4)
SH_C0 = 0.2820947917738781
COLOR_LO, COLOR_HI = -4.0, 4.0
# Elements of one block's (tiles, 256, records) arrays.
BLOCK_ELEMENTS = 1 << 25
SCAN_ALIGN = 128
PRETEST_TILES = 8


_TF32 = {"on": False}


@contextlib.contextmanager
def precision(tf32: bool):
    """The control's precision (`tf32`) or the reference's: with TF32,
    the operands of every matrix product of the reference (the world to
    view transform, both covariance products, the SH contraction, the
    compositing sum and the SSIM blurs) are rounded to TF32's 10 mantissa
    bits, as TF32 tensor cores round them, and the products accumulate
    in float32; PyTorch's TF32 flags are set alike."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, _TF32["on"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _TF32["on"] = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _TF32["on"]) = saved


def mm_in(x: torch.Tensor) -> torch.Tensor:
    """A matrix product's operand: itself, or under the TF32 control
    rounded to nearest at 10 mantissa bits (the gradient passes
    through)."""
    if not _TF32["on"]:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


class Cam(NamedTuple):
    viewmat: torch.Tensor   # (4, 4) world to view
    focal: torch.Tensor     # (2,)
    center: torch.Tensor    # (2,)
    size: tuple             # (w, h)


def rotmat_np(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def make_cam(pose: dict, size, device) -> Cam:
    """pose: position, rotation (w, x, y, z camera-to-world), fov_x,
    fov_y; the principal point at the image centre."""
    w, h = int(size[0]), int(size[1])
    r = rotmat_np(pose["rotation"])
    m = np.eye(4)
    m[:3, :3] = r.T
    m[:3, 3] = -r.T @ np.asarray(pose["position"], np.float64)
    focal = [0.5 * w / np.tan(0.5 * pose["fov_x"]),
             0.5 * h / np.tan(0.5 * pose["fov_y"])]
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=device)
    return Cam(f32(m), f32(focal), f32([0.5 * w, 0.5 * h]), (w, h))


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def sh_basis3(d: torch.Tensor) -> torch.Tensor:
    """(n, 16) real SH basis to degree 3 of unit directions (n, 3)."""
    x, y, z = d.unbind(-1)
    z2 = z * z
    fc1, fs1 = x * x - y * y, 2 * x * y
    fc2, fs2 = x * fc1 - y * fs1, x * fs1 + y * fc1
    p6 = 0.9461746957575601 * z2 - 0.3153915652525201
    f0b = -1.092548430592079 * z
    f0c = -2.285228997322329 * z2 + 0.4570457994644658
    f1b = 1.445305721320277 * z
    a = 0.48860251190292
    return torch.stack([
        torch.full_like(x, SH_C0), -a * y, a * z, -a * x,
        0.5462742152960395 * fs1, f0b * y, p6, f0b * x,
        0.5462742152960395 * fc1,
        -0.5900435899266435 * fs2, f1b * fs1, f0c * y,
        z * (1.865881662950577 * z2 - 1.119528997770346), f0c * x,
        f1b * fc1, -0.5900435899266435 * fc2], dim=-1)


class Splat2D(NamedTuple):
    xy: torch.Tensor       # (n, 2)
    conic: torch.Tensor    # (n, 3)
    color: torch.Tensor    # (n, 3)
    opac: torch.Tensor     # (n,)
    depth: torch.Tensor    # (n,) detached
    tmin: torch.Tensor     # (n, 2) int64 tile bbox, inclusive
    tmax: torch.Tensor     # (n, 2) int64 exclusive
    visible: torch.Tensor  # (n,) bool


def project(p: dict, cam: Cam, active: torch.Tensor) -> Splat2D:
    """Per-splat screen-space attributes, differentiable in xy, conic,
    color and opac."""
    w, h = cam.size
    W, t = cam.viewmat[:3, :3], cam.viewmat[:3, 3]
    means = p["means"]
    pv = mm_in(means) @ mm_in(W.T) + t
    depth = pv[:, 2]
    visible = (depth > NEAR_PLANE_Z) & active
    z = torch.where(visible, depth, torch.ones_like(depth))
    q = p["quats"]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    m = quat_rotmat(q) * torch.exp(p["log_scales"])[:, None, :]
    cov3 = mm_in(m) @ mm_in(m.transpose(1, 2))
    img = torch.tensor([float(w), float(h)], device=means.device)
    tan_fov = 0.5 * img / cam.focal
    lim_pos = (img - cam.center) / cam.focal + 0.3 * tan_fov
    lim_neg = cam.center / cam.focal + 0.3 * tan_fov
    tx = z * torch.clamp(pv[:, 0] / z, -lim_neg[0], lim_pos[0])
    ty = z * torch.clamp(pv[:, 1] / z, -lim_neg[1], lim_pos[1])
    zero = torch.zeros_like(z)
    fx, fy = cam.focal[0], cam.focal[1]
    jac = torch.stack([
        torch.stack([fx / z, zero, -fx * tx / (z * z)], -1),
        torch.stack([zero, fy / z, -fy * ty / (z * z)], -1)], 1)
    tm = mm_in(jac) @ mm_in(W)
    cov = mm_in(mm_in(tm) @ mm_in(cov3)) @ mm_in(tm.transpose(1, 2))
    c00 = cov[:, 0, 0] + COV_BLUR
    c01 = cov[:, 0, 1]
    c11 = cov[:, 1, 1] + COV_BLUR
    det = c00 * c11 - c01 * c01
    visible = visible & (det != 0)
    one = torch.ones_like(c00)
    c00 = torch.where(visible, c00, one)
    c01 = torch.where(visible, c01, zero)
    c11 = torch.where(visible, c11, one)
    det = c00 * c11 - c01 * c01
    conic = torch.stack([c11 / det, -c01 / det, c00 / det], -1)
    xy = torch.stack([pv[:, 0] / z, pv[:, 1] / z], -1) * cam.focal \
        + cam.center

    with torch.no_grad():
        cd = conic.detach()
        idet = 1.0 / (cd[:, 0] * cd[:, 2] - cd[:, 1] * cd[:, 1])
        b = 0.5 * (cd[:, 2] * idet + cd[:, 0] * idet)
        disc = torch.sqrt(torch.clamp(b * b - idet, min=0.1))
        radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(
            torch.maximum(b + disc, b - disc), min=0.0)))
        radius = torch.where(visible, torch.nan_to_num(
            radius, nan=0.0, posinf=2.0 ** 30).clamp(0, 2.0 ** 30), 0.0)
        tiles = torch.tensor([-(-w // TILE), -(-h // TILE)],
                             device=means.device, dtype=torch.float32)
        c = xy.detach() / TILE
        r = radius[:, None] / TILE
        lo = torch.nan_to_num(torch.floor(c - r), nan=0.0)
        hi = torch.nan_to_num(torch.floor(c + r + 1.0), nan=0.0)
        tmin = torch.minimum(torch.clamp(lo, min=0.0), tiles).long()
        tmax = torch.minimum(torch.clamp(hi, min=0.0), tiles).long()
        visible = visible & (tmax[:, 0] > tmin[:, 0]) \
            & (tmax[:, 1] > tmin[:, 1])

    view = means.detach() - t
    view = view / torch.clamp(torch.linalg.vector_norm(view, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
    basis = sh_basis3(view)[:, None, :p["sh_coeffs"].shape[1]]
    color = (mm_in(basis) @ mm_in(p["sh_coeffs"]))[:, 0] + 0.5
    color = color + (torch.clamp(color, COLOR_LO, COLOR_HI)
                     - color).detach()
    opac = torch.sigmoid(p["raw_opacity"])
    return Splat2D(xy, conic, color, opac, depth.detach(), tmin, tmax,
                   visible)


class Records(NamedTuple):
    splat: torch.Tensor   # (R,) splat of each record, in (tile, depth) order
    start: torch.Tensor   # (T,) first record of each tile
    count: torch.Tensor   # (T,) records of each tile
    tiles_x: int
    tiles_y: int


def touches(s: Splat2D, ids: torch.Tensor, tx: torch.Tensor,
            ty: torch.Tensor) -> torch.Tensor:
    """Does splat ids' ellipse of alpha 1/255 (sigma = log(255 o)) reach
    tile (tx, ty)? Brush's test of an ellipse against a box: the centre
    inside the box, or one of the two box edges from the corner nearest
    the centre reaching inside the ellipse."""
    sig = torch.log(s.opac.detach()[ids] * 255.0)
    con = s.conic.detach()[ids] / (2.0 * sig)[:, None]
    ca, cb, cc = con.unbind(-1)
    ext = TILE / 2.0
    bx = tx.to(torch.float32) * TILE + ext
    by = ty.to(torch.float32) * TILE + ext
    xy = s.xy.detach()[ids]
    dx, dy = xy[:, 0] - bx, xy[:, 1] - by
    inside = (torch.abs(dx) <= ext) & (torch.abs(dy) <= ext)
    sx, sy = torch.sign(dx), torch.sign(dy)
    cpx = bx + sx * ext - xy[:, 0]
    cpy = by + sy * ext - xy[:, 1]
    gx = ca * cpx + cb * cpy
    gy = cb * cpx + cc * cpy
    c = cpx * gx + cpy * gy - 1.0

    def edge(a, hb):
        # a t^2 + 2 hb t + c <= 0 somewhere on t in [0, 1].
        return ((c <= 0.0) | (a + 2.0 * hb + c <= 0.0)
                | ((hb * hb >= a * c) & (hb <= 0.0) & (-hb <= a)
                   & (a > 0.0)))

    hit = (inside | edge(ca * (4.0 * ext * ext), -sx * (2.0 * ext) * gx)
           | edge(cc * (4.0 * ext * ext), -sy * (2.0 * ext) * gy))
    return (sig > 0.0) & hit


def records(s: Splat2D, size) -> Records:
    """One record per (visible splat, tile of its bbox that the tile test
    keeps), sorted by tile and, within a tile, by depth (ties by splat
    index)."""
    w, h = int(size[0]), int(size[1])
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    ids = torch.nonzero(s.visible)[:, 0]
    tmin, tmax = s.tmin[ids], s.tmax[ids]
    bw = tmax[:, 0] - tmin[:, 0]
    cnt = bw * (tmax[:, 1] - tmin[:, 1])
    total = int(cnt.sum())
    rep = lambda v: torch.repeat_interleave(v, cnt, output_size=total)
    first = torch.cumsum(cnt, 0) - cnt
    off = torch.arange(total, device=ids.device) - rep(first)
    bw_r = rep(bw)
    tile = ((rep(tmin[:, 1]) + off // bw_r) * tiles_x
            + rep(tmin[:, 0]) + off % bw_r)
    splat = rep(ids)
    small = rep((bw <= PRETEST_TILES)
                & (tmax[:, 1] - tmin[:, 1] <= PRETEST_TILES))
    keep = ~small
    keep[small] = touches(s, splat[small], tile[small] % tiles_x,
                          tile[small] // tiles_x)
    splat, tile = splat[keep], tile[keep]
    depth_bits = torch.clamp(s.depth, min=1e-20).view(torch.int32).long()
    order = torch.sort((tile << 32) | depth_bits[splat], stable=True).indices
    splat, tile = splat[order], tile[order]
    count = torch.bincount(tile, minlength=tiles_x * tiles_y)
    return Records(splat, torch.cumsum(count, 0) - count, count, tiles_x,
                   tiles_y)


def _blocks(rec: Records):
    """Tiles with records, most first, grouped so that a block's
    (tiles, 256, records) arrays hold at most BLOCK_ELEMENTS."""
    order = torch.argsort(rec.count, descending=True)
    counts = rec.count[order].tolist()
    tiles = order.tolist()
    i = 0
    while i < len(tiles) and counts[i] > 0:
        k = counts[i]
        n = max(1, BLOCK_ELEMENTS // (256 * k))
        j = min(i + n, len(tiles))
        while j > i + 1 and counts[j - 1] == 0:
            j -= 1
        yield tiles[i:j], k
        i = j


def bf16_parts(x: torch.Tensor, passes: int) -> torch.Tensor:
    """x as the sum of its first `passes` bfloat16 parts, each rounded to
    nearest even from the rest the ones before left; the gradient passes
    straight through."""
    rem = x.detach()
    out = torch.zeros_like(rem)
    for _ in range(passes):
        part = rem.to(torch.bfloat16).to(rem.dtype)
        rem = rem - part
        out = out + part
    return x + (out - x).detach()


def log_t_after(lom: torch.Tensor, first: torch.Tensor, k: int,
                scan) -> torch.Tensor:
    """(B, 256, k) log T after each record of a block of tiles, from the
    terms lom; first (B,) is each tile's first slot in the record list
    (the scan's batches start from it, see the module docstring)."""
    exact = torch.cumsum(lom, dim=-1)
    if scan is None or scan[0] >= 3:
        return exact
    passes, lanes = scan
    kk = torch.arange(k, device=lom.device)
    base = (first // SCAN_ALIGN) * SCAN_ALIGN
    # The local index of the first record of each record's batch.
    batch = (first[:, None] + kk[None] - base[:, None]) // lanes
    start = torch.clamp(base[:, None] + batch * lanes - first[:, None],
                        min=0)
    cut = torch.cumsum(bf16_parts(lom, passes), dim=-1)
    prev = torch.clamp(start - 1, min=0)[:, None, :].expand_as(lom)
    had = (start > 0)[:, None, :]
    carry_exact = torch.where(had, torch.gather(exact, -1, prev), 0.0)
    carry_cut = torch.where(had, torch.gather(cut, -1, prev), 0.0)
    return carry_exact + (cut - carry_cut)


def _composite(attrs, rec: Records, tiles, k: int, count: bool = False,
               scan=None):
    """(B, 256, 4) RGBA of a block of tiles from per-splat (xy, conic,
    color, opac); with `count` also (contributing pairs, records with a
    contributing pixel)."""
    xy, conic, color, opac = attrs
    dev = xy.device
    tl = torch.as_tensor(tiles, device=dev)
    kk = torch.arange(k, device=dev)
    valid = kk[None] < rec.count[tl][:, None]
    idx = torch.clamp(rec.start[tl][:, None] + kk[None],
                      max=max(rec.splat.shape[0] - 1, 0))
    sid = rec.splat[idx]
    lane = torch.arange(256, device=dev)
    px = ((tl % rec.tiles_x) * TILE)[:, None] + (lane % TILE) + 0.5
    py = ((tl // rec.tiles_x) * TILE)[:, None] + (lane // TILE) + 0.5
    sxy, sc = xy[sid], conic[sid]
    dx = sxy[:, None, :, 0] - px[:, :, None]
    dy = sxy[:, None, :, 1] - py[:, :, None]
    sigma = (0.5 * (sc[:, None, :, 0] * dx * dx + sc[:, None, :, 2] * dy * dy)
             + sc[:, None, :, 1] * dx * dy)
    raw = opac[sid][:, None, :] * torch.exp(-torch.clamp(sigma, min=0.0))
    alpha = raw - torch.clamp(raw - ALPHA_MAX, min=0.0).detach()
    ok = (sigma >= 0.0) & (alpha >= ALPHA_EPS) & valid[:, None, :]
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    lom = torch.log1p(-alpha)
    after = log_t_after(lom, rec.start[tl], k, scan)
    # A pixel takes records up to the first whose T falls to 1e-4.
    act = torch.cumsum(after <= LOG_T_EPS, dim=-1) == 0
    fac = alpha * torch.exp(after - lom) * act
    rgb = mm_in(fac) @ mm_in(color[sid])
    log_t = (lom * act).sum(-1)
    out = torch.cat([rgb, (1.0 - torch.exp(log_t))[..., None]], -1)
    if not count:
        return out
    hit = ok & act
    return out, int(hit.sum()), int(hit.any(dim=1).sum())


def tiles_to_image(tiles: torch.Tensor, rec: Records, size) -> torch.Tensor:
    w, h = int(size[0]), int(size[1])
    img = tiles.reshape(rec.tiles_y, rec.tiles_x, TILE, TILE, 4)
    img = img.permute(0, 2, 1, 3, 4).reshape(rec.tiles_y * TILE,
                                             rec.tiles_x * TILE, 4)
    return img[:h, :w]


def image_to_tiles(img: torch.Tensor, rec: Records) -> torch.Tensor:
    h, w = img.shape[:2]
    pad = img.new_zeros((rec.tiles_y * TILE, rec.tiles_x * TILE, 4))
    pad[:h, :w] = img
    return pad.reshape(rec.tiles_y, TILE, rec.tiles_x, TILE, 4).permute(
        0, 2, 1, 3, 4).reshape(-1, TILE * TILE, 4)


@torch.no_grad()
def render(attrs, rec: Records, size, count: bool = False, scan=None):
    """(h, w, 4) image; with `count` also the contributing (pixel, splat)
    pairs and the (splat, tile) records that hold one."""
    out = torch.zeros((rec.tiles_x * rec.tiles_y, 256, 4),
                      dtype=torch.float32, device=attrs[0].device)
    pairs = hits = 0
    for tiles, k in _blocks(rec):
        res = _composite(attrs, rec, tiles, k, count, scan)
        if count:
            res, p, r = res
            pairs += p
            hits += r
        out[torch.as_tensor(tiles, device=out.device)] = res
    img = tiles_to_image(out, rec, size)
    return (img, pairs, hits) if count else img


def backward_tiles(attrs, rec: Records, g_img: torch.Tensor, scan=None):
    """Accumulate dL/d(attrs) into the leaf attributes' .grad, block by
    block, from dL/dimage."""
    g = image_to_tiles(g_img, rec)
    for tiles, k in _blocks(rec):
        out = _composite(attrs, rec, tiles, k, scan=scan)
        out.backward(g[torch.as_tensor(tiles, device=g.device)])


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(size, dtype=np.float32) - size // 2
    v = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    v = v / v.sum()
    return np.outer(v, v).astype(np.float32)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (h, w, 3) images, zero padding 6 (the output is
    two pixels wider than the input), as Brush computes it."""
    wts = torch.as_tensor(gaussian_window(), device=x.device)
    wts = wts[None, None].repeat(3, 1, 1, 1)
    blur = lambda a: F.conv2d(mm_in(a), mm_in(wts), padding=6, groups=3)
    x = x.permute(2, 0, 1)[None]
    y = y.permute(2, 0, 1)[None]
    mx, my = blur(x), blur(y)
    zero = torch.zeros((), device=x.device)
    sxx = torch.maximum(blur(x * x) - mx * mx, zero)
    syy = torch.maximum(blur(y * y) - my * my, zero)
    sxy = blur(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mx * my + c1) * (2 * sxy + c2)) / (
        (mx * mx + my * my + c1) * (sxx + syy + c2))
    return m.mean()


def image_loss(img: torch.Tensor, gt: torch.Tensor,
               ssim_weight: float = 0.2) -> torch.Tensor:
    pred = img if gt.shape[-1] == 4 else img[..., :3]
    l1 = torch.mean(torch.abs(pred - gt))
    return l1 * (1 - ssim_weight) - ssim_weight * ssim(img[..., :3],
                                                       gt[..., :3])


LEAVES = ("means", "sh_coeffs", "quats", "raw_opacity", "log_scales")


def adam(params: dict, grads: dict, m: dict, v: dict, count: int,
         lrs: dict, b1=0.9, b2=0.999, eps=1e-15):
    """One Adam step (bias correction 1 - beta^count in float32)."""
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    b1c = float(1 - f32(b1) ** f32(count))
    b2c = float(1 - f32(b2) ** f32(count))
    out_p, out_m, out_v = {}, {}, {}
    for k in params:
        g = grads[k]
        out_m[k] = b1 * m[k] + (1 - b1) * g
        out_v[k] = b2 * v[k] + (1 - b2) * g * g
        out_p[k] = params[k] - lrs[k] * (out_m[k] / b1c) / (
            torch.sqrt(out_v[k] / b2c) + eps)
    return out_p, out_m, out_v


def group_lrs(sh_count: int, lr_mean: float, device, lr_dc=4e-3,
              sh_scale=20.0, lr_opac=5e-2, lr_scale=1e-2, lr_rot=2e-3):
    sh = torch.full((1, sh_count, 1), lr_dc / sh_scale, device=device)
    sh[:, 0] = lr_dc
    return {"means": lr_mean, "sh_coeffs": sh, "quats": lr_rot,
            "raw_opacity": lr_opac, "log_scales": lr_scale}


def step_grads(params: dict, active: torch.Tensor, cam: Cam,
               gt: torch.Tensor, ssim_weight: float = 0.2, scan=None):
    """(loss, gradients of every leaf) of one training render."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in LEAVES}
    s = project(leaves, cam, active)
    rec = records(s, cam.size)
    graph = (s.xy, s.conic, s.color, s.opac)
    attrs = tuple(a.detach().requires_grad_(True) for a in graph)
    img = render(attrs, rec, cam.size, scan=scan).requires_grad_(True)
    loss = image_loss(img, gt, ssim_weight)
    loss.backward()
    backward_tiles(attrs, rec, img.grad, scan)
    torch.autograd.backward(graph, [
        a.grad if a.grad is not None else torch.zeros_like(a)
        for a in attrs])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return loss.detach(), grads


def render_image(params: dict, active: torch.Tensor, cam: Cam,
                 count: bool = False, scan=None):
    """The rendered (h, w, 4) image (and with `count` the pair counts)."""
    with torch.no_grad():
        s = project(params, cam, active)
        rec = records(s, cam.size)
        return render((s.xy, s.conic, s.color, s.opac), rec, cam.size,
                      count=count, scan=scan)
