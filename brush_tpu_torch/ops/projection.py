"""Gaussian projection: world-space 3D gaussians -> screen-space 2D splats.

Port of brush_tpu/ops/projection.py (reference: helpers.wgsl:119-218,
project_forward.wgsl culling). Dense over the padded splat array with a
validity mask, in float32, with the same expanded scalar form of
T V T^T so the sums round as the reference's do. Culled splats still get
finite values (a safe depth and an identity covariance), and a covariance
with det < 0 gives a finite conic (the rasterizer skips sigma < 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from brush_tpu_torch.constants import COV_BLUR, NEAR_PLANE_Z, TILE_WIDTH


class Projection(NamedTuple):
    """Per-splat screen-space quantities (all padded to N with `visible`)."""

    xy: torch.Tensor        # (N, 2) projected means, pixels
    depth: torch.Tensor     # (N,) view-space z
    conic: torch.Tensor     # (N, 3) inverse 2D covariance (a, b, c)
    radius: torch.Tensor    # (N,) int32 pixel radius of the 3-sigma bound
    tile_min: torch.Tensor  # (N, 2) int32 inclusive tile bbox min (x, y)
    tile_max: torch.Tensor  # (N, 2) int32 exclusive tile bbox max (x, y)
    visible: torch.Tensor   # (N,) bool — survives culling


def normalize_quats(quats: torch.Tensor) -> torch.Tensor:
    return quats / torch.clamp(
        torch.linalg.vector_norm(quats, dim=-1, keepdim=True), min=1e-12)


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz quaternions -> (N, 3, 3) rotation matrices
    (helpers.wgsl:74)."""
    w, x, y, z = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (y2 + z2), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (x2 + z2), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (x2 + y2),
    ], dim=-1)
    return m.reshape(-1, 3, 3)


def calc_cov2d(focal, img_size, pixel_center, viewmat, p_view, scales,
               quats) -> torch.Tensor:
    """Projected 2D covariance (c00, c01, c11) incl. COV_BLUR
    (helpers.wgsl:124-158): EWA projection with the frustum-clamped
    tangent point."""
    img = torch.tensor([float(img_size[0]), float(img_size[1])],
                       dtype=torch.float32, device=p_view.device)
    tan_fov = 0.5 * img / focal
    lims_pos = (img - pixel_center) / focal + 0.3 * tan_fov
    lims_neg = pixel_center / focal + 0.3 * tan_fov

    pz = p_view[:, 2]
    rz = 1.0 / pz
    rz2 = rz * rz
    tx = pz * torch.clamp(p_view[:, 0] * rz, -lims_neg[0], lims_pos[0])
    ty = pz * torch.clamp(p_view[:, 1] * rz, -lims_neg[1], lims_pos[1])

    qw, qx, qy, qz = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    x2, y2, z2 = qx * qx, qy * qy, qz * qz
    xy_, xz_, yz_ = qx * qy, qx * qz, qy * qz
    wx_, wy_, wz_ = qw * qx, qw * qy, qw * qz
    s0, s1, s2 = scales[:, 0], scales[:, 1], scales[:, 2]
    # m_ij = R_ij * s_j  (M = R @ diag(s))
    m00 = (1.0 - 2.0 * (y2 + z2)) * s0
    m01 = (2.0 * (xy_ - wz_)) * s1
    m02 = (2.0 * (xz_ + wy_)) * s2
    m10 = (2.0 * (xy_ + wz_)) * s0
    m11 = (1.0 - 2.0 * (x2 + z2)) * s1
    m12 = (2.0 * (yz_ - wx_)) * s2
    m20 = (2.0 * (xz_ - wy_)) * s0
    m21 = (2.0 * (yz_ + wx_)) * s1
    m22 = (1.0 - 2.0 * (x2 + y2)) * s2
    # V = M M^T, symmetric (6 unique entries)
    v00 = m00 * m00 + m01 * m01 + m02 * m02
    v01 = m00 * m10 + m01 * m11 + m02 * m12
    v02 = m00 * m20 + m01 * m21 + m02 * m22
    v11 = m10 * m10 + m11 * m11 + m12 * m12
    v12 = m10 * m20 + m11 * m21 + m12 * m22
    v22 = m20 * m20 + m21 * m21 + m22 * m22
    # J rows: [fx*rz, 0, -fx*tx*rz2], [0, fy*rz, -fy*ty*rz2]
    ja = focal[0] * rz
    jc0 = -focal[0] * tx * rz2
    jb = focal[1] * rz
    jc1 = -focal[1] * ty * rz2
    # T = J @ W (W constant 3x3), rows t0, t1
    w = viewmat[:3, :3]
    t00 = ja * w[0, 0] + jc0 * w[2, 0]
    t01 = ja * w[0, 1] + jc0 * w[2, 1]
    t02 = ja * w[0, 2] + jc0 * w[2, 2]
    t10 = jb * w[1, 0] + jc1 * w[2, 0]
    t11 = jb * w[1, 1] + jc1 * w[2, 1]
    t12 = jb * w[1, 2] + jc1 * w[2, 2]
    # cov = T V T^T
    u0 = v00 * t00 + v01 * t01 + v02 * t02
    u1 = v01 * t00 + v11 * t01 + v12 * t02
    u2 = v02 * t00 + v12 * t01 + v22 * t02
    c00 = t00 * u0 + t01 * u1 + t02 * u2
    c01 = t10 * u0 + t11 * u1 + t12 * u2
    q0 = v00 * t10 + v01 * t11 + v02 * t12
    q1 = v01 * t10 + v11 * t11 + v12 * t12
    q2 = v02 * t10 + v12 * t11 + v22 * t12
    c11 = t10 * q0 + t11 * q1 + t12 * q2

    return torch.stack([c00 + COV_BLUR, c01, c11 + COV_BLUR], dim=-1)


def cov_to_conic(cov2d: torch.Tensor) -> torch.Tensor:
    """Invert the symmetric 2x2 covariance (helpers.wgsl:160-164)."""
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    inv_det = 1.0 / det
    return torch.stack(
        [cov2d[:, 2] * inv_det, -cov2d[:, 1] * inv_det,
         cov2d[:, 0] * inv_det], dim=-1,
    )


def _f32_to_i32(v: torch.Tensor) -> torch.Tensor:
    """Saturating float -> int32 with NaN -> 0, as XLA converts.

    A plain .to(int32) of NaN or an out-of-range float is undefined in
    PyTorch; the bounds here are past any tile bbox, which clips anyway.
    """
    v = torch.nan_to_num(v, nan=0.0, posinf=2.0 ** 30, neginf=-(2.0 ** 30))
    return torch.clamp(v, -(2.0 ** 30), 2.0 ** 30).to(torch.int32)


def radius_from_conic(conic: torch.Tensor) -> torch.Tensor:
    """Conservative integer pixel radius (helpers.wgsl:192-202), opacity
    fixed at 1 as in the reference (project_forward.wgsl:53)."""
    det = 1.0 / (conic[:, 0] * conic[:, 2] - conic[:, 1] * conic[:, 1])
    cov_x = conic[:, 2] * det
    cov_z = conic[:, 0] * det
    b = 0.5 * (cov_x + cov_z)
    disc = torch.sqrt(torch.clamp(b * b - det, min=0.1))
    v1 = b + disc
    v2 = b - disc
    radius = 3.0 * torch.sqrt(torch.clamp(torch.maximum(v1, v2), min=0.0))
    return _f32_to_i32(torch.ceil(radius))


def tile_bbox(xy: torch.Tensor, radius: torch.Tensor, tile_bounds):
    """Inclusive-min / exclusive-max tile bbox (helpers.wgsl:55-71)."""
    tiles_x, tiles_y = tile_bounds
    bounds = torch.tensor([float(tiles_x), float(tiles_y)],
                          dtype=torch.float32, device=xy.device)
    zero = torch.zeros_like(bounds)
    center = xy / float(TILE_WIDTH)
    rad = radius.to(torch.float32)[:, None] / float(TILE_WIDTH)
    tmin = torch.clamp(torch.floor(center - rad), zero, bounds)
    tmax = torch.clamp(torch.floor(center + rad + 1.0), zero, bounds)
    return _f32_to_i32(tmin), _f32_to_i32(tmax)


def project_splats(means, log_scales, quats, viewmat, focal, pixel_center,
                   img_size, active=None) -> Projection:
    """Project all splats and compute visibility (project_forward.wgsl:
    near plane, zero covariance determinant, empty tile bbox).

    means/log_scales: (N, 3); quats: (N, 4) wxyz, normalized; viewmat
    (4, 4) world-to-view; focal/pixel_center (2,); img_size (w, h) ints;
    active: optional (N,) bool mask of live splats.
    """
    w = viewmat[:3, :3]
    t = viewmat[:3, 3]
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    px = mx * w[0, 0] + my * w[0, 1] + mz * w[0, 2] + t[0]
    py = mx * w[1, 0] + my * w[1, 1] + mz * w[1, 2] + t[1]
    depth = mx * w[2, 0] + my * w[2, 1] + mz * w[2, 2] + t[2]

    visible = depth > NEAR_PLANE_Z
    if active is not None:
        visible = visible & active

    z_safe = torch.where(visible, depth, torch.ones_like(depth))
    p_view = torch.stack([px, py, z_safe], dim=-1)

    scales = torch.exp(log_scales)
    cov2d = calc_cov2d(focal, img_size, pixel_center, viewmat, p_view,
                       scales, quats)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    visible = visible & (det != 0.0)
    ident = torch.tensor([1.0, 0.0, 1.0], dtype=cov2d.dtype,
                         device=cov2d.device)
    cov2d_safe = torch.where(visible[:, None], cov2d, ident)

    conic = cov_to_conic(cov2d_safe)
    xy = p_view[:, :2] / p_view[:, 2:3] * focal + pixel_center
    radius = torch.where(visible, radius_from_conic(conic),
                         torch.zeros((), dtype=torch.int32,
                                     device=means.device))

    tiles_x = -(-int(img_size[0]) // TILE_WIDTH)
    tiles_y = -(-int(img_size[1]) // TILE_WIDTH)
    tmin, tmax = tile_bbox(xy, radius, (tiles_x, tiles_y))
    visible = (visible & (tmax[:, 0] > tmin[:, 0])
               & (tmax[:, 1] > tmin[:, 1]))

    return Projection(
        xy=xy, depth=depth, conic=conic, radius=radius,
        tile_min=tmin, tile_max=tmax, visible=visible,
    )


def quat_norm_plain(quats: torch.Tensor) -> torch.Tensor:
    """|q| of (N, 4) quaternions as sqrt((w w + y y) + (x x + z z)), op by
    op: the order in which torch.linalg.vector_norm's CUDA reduction sums
    four squares (normalize_quats on the card; the CPU's vector_norm may
    sum them in another order). csrc/projection.cu's norm, for its twin."""
    sq = quats * quats
    return torch.sqrt((sq[:, 0] + sq[:, 2]) + (sq[:, 1] + sq[:, 3]))


def project_bwd_plain(means, log_scales, quats, viewmat, focal, pixel_center,
                      img_size, g_xy, g_conic, active=None):
    """The gradients (means, log_scales, quats) of
    project_splats(means, log_scales, normalize_quats(quats), ...) from
    those of xy (N, 2) and conic (N, 3), quats raw: csrc/projection.cu's
    backward op by op (its twin, for the tests and chip_smoke.py; the
    package never calls it). The forward is recomputed in project_splats'
    order, the norm as quat_norm_plain. Autograd's masks: a row culled by
    the near plane or `active` passes xy's gradient to its means through
    z = 1; one culled there or by det == 0 gets no conic gradient; tx = z
    clamp(px / z) passes its gradient to px inside the clamp (inclusive)
    and to z outside; a norm under the 1e-12 clamp passes none."""
    zero = torch.zeros((), dtype=means.dtype, device=means.device)
    w, t = viewmat[:3, :3], viewmat[:3, 3]
    fx, fy = focal[0], focal[1]
    img = torch.tensor([float(img_size[0]), float(img_size[1])],
                       dtype=means.dtype, device=means.device)
    tan_fov = 0.5 * img / focal
    hi = (img - pixel_center) / focal + 0.3 * tan_fov
    lo = -(pixel_center / focal + 0.3 * tan_fov)

    # The forward's terms (project_splats, calc_cov2d, cov_to_conic).
    norm = quat_norm_plain(quats)
    den = torch.clamp(norm, min=1e-12)
    qn = quats / den[:, None]
    qw, qx, qy, qz = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    px = mx * w[0, 0] + my * w[0, 1] + mz * w[0, 2] + t[0]
    py = mx * w[1, 0] + my * w[1, 1] + mz * w[1, 2] + t[1]
    depth = mx * w[2, 0] + my * w[2, 1] + mz * w[2, 2] + t[2]
    vis0 = depth > NEAR_PLANE_Z
    if active is not None:
        vis0 = vis0 & active
    z = torch.where(vis0, depth, torch.ones_like(depth))
    s = torch.exp(log_scales)
    rz = 1.0 / z
    rz2 = rz * rz
    vx, vy = px * rz, py * rz
    vxc = torch.clamp(vx, lo[0], hi[0])
    vyc = torch.clamp(vy, lo[1], hi[1])
    tx, ty = z * vxc, z * vyc
    x2, y2, z2 = qx * qx, qy * qy, qz * qz
    xy_, xz_, yz_ = qx * qy, qx * qz, qy * qz
    wx_, wy_, wz_ = qw * qx, qw * qy, qw * qz
    r = [1.0 - 2.0 * (y2 + z2), 2.0 * (xy_ - wz_), 2.0 * (xz_ + wy_),
         2.0 * (xy_ + wz_), 1.0 - 2.0 * (x2 + z2), 2.0 * (yz_ - wx_),
         2.0 * (xz_ - wy_), 2.0 * (yz_ + wx_), 1.0 - 2.0 * (x2 + y2)]
    m = [r[i] * s[:, i % 3] for i in range(9)]

    def dot3(a0, b0, a1, b1, a2, b2):
        return a0 * b0 + a1 * b1 + a2 * b2

    v00 = dot3(m[0], m[0], m[1], m[1], m[2], m[2])
    v01 = dot3(m[0], m[3], m[1], m[4], m[2], m[5])
    v02 = dot3(m[0], m[6], m[1], m[7], m[2], m[8])
    v11 = dot3(m[3], m[3], m[4], m[4], m[5], m[5])
    v12 = dot3(m[3], m[6], m[4], m[7], m[5], m[8])
    v22 = dot3(m[6], m[6], m[7], m[7], m[8], m[8])
    ja = fx * rz
    jc0 = -fx * tx * rz2
    jb = fy * rz
    jc1 = -fy * ty * rz2
    t0 = [ja * w[0, j] + jc0 * w[2, j] for j in range(3)]
    t1 = [jb * w[1, j] + jc1 * w[2, j] for j in range(3)]
    u = [dot3(v00, t0[0], v01, t0[1], v02, t0[2]),
         dot3(v01, t0[0], v11, t0[1], v12, t0[2]),
         dot3(v02, t0[0], v12, t0[1], v22, t0[2])]
    q = [dot3(v00, t1[0], v01, t1[1], v02, t1[2]),
         dot3(v01, t1[0], v11, t1[1], v12, t1[2]),
         dot3(v02, t1[0], v12, t1[1], v22, t1[2])]
    cov0 = dot3(t0[0], u[0], t0[1], u[1], t0[2], u[2]) + COV_BLUR
    cov1 = dot3(t1[0], u[0], t1[1], u[1], t1[2], u[2])
    cov2 = dot3(t1[0], q[0], t1[1], q[1], t1[2], q[2]) + COV_BLUR
    vis1 = vis0 & (cov0 * cov2 - cov1 * cov1 != 0.0)
    cs0 = torch.where(vis1, cov0, torch.ones_like(cov0))
    cs1 = torch.where(vis1, cov1, zero)
    cs2 = torch.where(vis1, cov2, torch.ones_like(cov2))
    inv = 1.0 / (cs0 * cs2 - cs1 * cs1)

    # conic = (cs2, -cs1, cs0) inv: the safe covariance's gradient, zero
    # where the row is not visible.
    gx, gy = g_xy[:, 0], g_xy[:, 1]
    ga, gb, gc = g_conic[:, 0], g_conic[:, 1], g_conic[:, 2]
    g_inv = (ga * cs2 - gb * cs1) + gc * cs0
    g_det = -(g_inv * (inv * inv))
    g00 = torch.where(vis1, gc * inv + g_det * cs2, zero)
    g01 = torch.where(vis1, -(gb * inv + 2.0 * (g_det * cs1)), zero)
    g11 = torch.where(vis1, ga * inv + g_det * cs0, zero)
    # cov = (t0 V t0, t1 V t0, t1 V t1): T's rows; V's through g_u = g00
    # t0 + g01 t1 and g_q = g11 t1 as H = g_u t0^T + g_q t1^T plus its
    # transpose, whose gradient of M = R diag(s) is H M.
    e00, e11 = 2.0 * g00, 2.0 * g11
    gt0 = [e00 * u[j] + g01 * q[j] for j in range(3)]
    gt1 = [g01 * u[j] + e11 * q[j] for j in range(3)]
    gu = [g00 * t0[j] + g01 * t1[j] for j in range(3)]
    gv = [g11 * t1[j] for j in range(3)]
    h = [None] * 9
    for a in range(3):
        h[4 * a] = 2.0 * (gu[a] * t0[a] + gv[a] * t1[a])
        for b in range(a + 1, 3):
            h[3 * a + b] = h[3 * b + a] = (
                (gu[a] * t0[b] + gu[b] * t0[a])
                + (gv[a] * t1[b] + gv[b] * t1[a]))
    gr = [None] * 9
    gls = []
    for j in range(3):
        gs = None
        for a in range(3):
            gm = h[4 * a] * m[3 * a + j]
            for b in range(3):
                if b != a:
                    gm = gm + h[3 * a + b] * m[3 * b + j]
            gs = gm * r[j] if a == 0 else gs + gm * r[3 * a + j]
            gr[3 * a + j] = gm * s[:, j]
        gls.append(gs * s[:, j])
    # R(q), then q / clamp(|q|, 1e-12).
    d21, d02, d10 = gr[7] - gr[5], gr[2] - gr[6], gr[3] - gr[1]
    s01, s02, s12 = gr[1] + gr[3], gr[2] + gr[6], gr[5] + gr[7]
    gqw = 2.0 * ((qx * d21 + qy * d02) + qz * d10)
    gqx = 2.0 * ((qy * s01 + qz * s02) + qw * d21) - 4.0 * (
        qx * (gr[4] + gr[8]))
    gqy = 2.0 * ((qx * s01 + qz * s12) + qw * d02) - 4.0 * (
        qy * (gr[0] + gr[8]))
    gqz = 2.0 * ((qx * s02 + qy * s12) + qw * d10) - 4.0 * (
        qz * (gr[0] + gr[4]))
    dot = (gqw * qw + gqx * qx) + (gqy * qy + gqz * qz)
    kd = torch.where(norm >= 1e-12, dot, zero)
    gq = [(g - qc * kd) / den for g, qc in ((gqw, qw), (gqx, qx), (gqy, qy),
                                           (gqz, qz))]
    # T = J W; J from rz and t = z clamp(p rz).
    gja = dot3(gt0[0], w[0, 0], gt0[1], w[0, 1], gt0[2], w[0, 2])
    gjc0 = dot3(gt0[0], w[2, 0], gt0[1], w[2, 1], gt0[2], w[2, 2])
    gjb = dot3(gt1[0], w[1, 0], gt1[1], w[1, 1], gt1[2], w[1, 2])
    gjc1 = dot3(gt1[0], w[2, 0], gt1[1], w[2, 1], gt1[2], w[2, 2])
    hx, hy = gjc0 * fx, gjc1 * fy
    g_tx, g_ty = -(hx * rz2), -(hy * rz2)
    g_rz = (gja * fx + gjb * fy) - 2.0 * ((hx * tx + hy * ty) * rz)
    in_x = (vx >= lo[0]) & (vx <= hi[0])
    in_y = (vy >= lo[1]) & (vy <= hi[1])
    gz_t = (torch.where(in_x, zero, g_tx * vxc)
            + torch.where(in_y, zero, g_ty * vyc))
    gz_c = gz_t - g_rz * rz2
    gpx_c = torch.where(vis1 & in_x, g_tx, zero)
    gpy_c = torch.where(vis1 & in_y, g_ty, zero)
    gz_cv = torch.where(vis1, gz_c, zero)
    # xy = (p / z) f + c, then p = W m + t.
    ex, ey = gx * fx, gy * fy
    gpx = ex / z + gpx_c
    gpy = ey / z + gpy_c
    gz = gz_cv - (ex * (px / z) + ey * (py / z)) / z
    gpz = torch.where(vis0, gz, zero)
    g_means = torch.stack([dot3(w[0, j], gpx, w[1, j], gpy, w[2, j], gpz)
                           for j in range(3)], dim=-1)
    g_scales = torch.stack([torch.where(vis1, g, zero) for g in gls], dim=-1)
    g_quats = torch.stack([torch.where(vis1, g, zero) for g in gq], dim=-1)
    return g_means, g_scales, g_quats
