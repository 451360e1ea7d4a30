"""The projection and its backward as two CUDA kernels: each splat's
normalised quaternion, view-space position, 2D covariance, conic, radius
and tile bbox; backward, the gradients of its means, log scales and raw
quaternion.

Replaces no TPU kernel (brush_tpu/ops/projection.py is plain XLA). The
kernels are brush_tpu_torch/csrc/projection.cu (one thread a splat, a
block's rows staged through shared memory; its header gives the design
and the bound). render.project_inputs calls `project` for CUDA tensors:
an autograd Function whose forward launches `project_fwd` and whose
backward launches `project_bwd`, keeping nothing but the inputs. Their
plain twins, which the card tests hold them to bit for bit, are
ops/projection.project_splats on normalize_quats (the CPU's path) and
ops/projection.project_bwd_plain.

Inputs, n splats: means, log_scales (n, 3) and quats (n, 4) float32, the
quaternions raw (wxyz); viewmat (4, 4), focal and pixel_center (2,)
float32 on the same device; img_size (w, h) ints; active: None or (n,)
bool. Outputs: ops/projection.Projection; backward, from the gradients of
xy (n, 2) and conic (n, 3), those of means, log_scales and quats.
No wrapper copies between host and device or reads a device value.
"""

from __future__ import annotations

import torch

from brush_tpu_torch.constants import TILE_WIDTH
from brush_tpu_torch.ops.cuda import build
from brush_tpu_torch.ops.projection import Projection


def _check_inputs(means, log_scales, quats, viewmat, focal, pixel_center,
                  img_size, active, grads=()):
    """grads: the backward's (name, tensor, width) of xy's and conic's
    gradients."""
    n = means.shape[0] if means.dim() == 2 else -1
    f32 = torch.float32
    specs = [("means", means, (n, 3), f32),
             ("log_scales", log_scales, (n, 3), f32),
             ("quats", quats, (n, 4), f32),
             ("viewmat", viewmat, (4, 4), f32), ("focal", focal, (2,), f32),
             ("pixel_center", pixel_center, (2,), f32)]
    specs += [(name, g, (n, width), f32) for name, g, width in grads]
    if active is not None:
        specs.append(("active", active, (n,), torch.bool))
    build.check_tensors(*specs)
    if len(img_size) != 2 or any(int(v) != v or not 1 <= v < (1 << 24)
                                 for v in img_size):
        raise ValueError(f"img_size must be two ints in [1, 2^24), got "
                         f"{img_size}")
    if n >= (1 << 30):
        raise ValueError(f"{n} splats: the kernels index fewer than 2^30")
    if means.device.type != "cuda":
        raise ValueError(f"projection: the kernels take CUDA tensors, got "
                         f"{means.device} (ops/projection.project_splats "
                         f"is the CPU's)")


def _camera(viewmat, focal, pixel_center, active):
    """The camera's tensors and `active` as the kernels' pointers."""
    return (viewmat.contiguous(), focal.contiguous(),
            pixel_center.contiguous(),
            None if active is None else active.contiguous())


def project_fwd(means, log_scales, quats, viewmat, focal, pixel_center,
                img_size, active=None) -> Projection:
    """The Projection of every splat, on the current stream."""
    _check_inputs(means, log_scales, quats, viewmat, focal, pixel_center,
                  img_size, active)
    means, log_scales, quats = (t.contiguous()
                                for t in (means, log_scales, quats))
    viewmat, focal, pixel_center, active = _camera(viewmat, focal,
                                                   pixel_center, active)
    n, dev = means.shape[0], means.device
    w, h = int(img_size[0]), int(img_size[1])

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = Projection(xy=empty(n, 2), depth=empty(n), conic=empty(n, 3),
                     radius=empty(n, dtype=torch.int32),
                     tile_min=empty(n, 2, dtype=torch.int32),
                     tile_max=empty(n, 2, dtype=torch.int32),
                     visible=empty(n, dtype=torch.bool))
    build.launch("project_fwd_launch", dev, means.data_ptr(),
                 log_scales.data_ptr(), quats.data_ptr(),
                 None if active is None else active.data_ptr(),
                 viewmat.data_ptr(), focal.data_ptr(),
                 pixel_center.data_ptr(), w, h, -(-w // TILE_WIDTH),
                 -(-h // TILE_WIDTH), n, *(t.data_ptr() for t in out))
    return out


def project_bwd(means, log_scales, quats, viewmat, focal, pixel_center,
                img_size, g_xy, g_conic, active=None):
    """(g_means, g_log_scales, g_quats) from the gradients of xy and conic,
    on the current stream. The gradients arrive from autograd, maybe as
    views; they are made contiguous (20 bytes a splat) before the
    launch."""
    _check_inputs(means, log_scales, quats, viewmat, focal, pixel_center,
                  img_size, active, (("g_xy", g_xy, 2),
                                     ("g_conic", g_conic, 3)))
    means, log_scales, quats, g_xy, g_conic = (
        t.contiguous() for t in (means, log_scales, quats, g_xy, g_conic))
    viewmat, focal, pixel_center, active = _camera(viewmat, focal,
                                                   pixel_center, active)
    grads = (torch.empty_like(means), torch.empty_like(log_scales),
             torch.empty_like(quats))
    build.launch("project_bwd_launch", means.device, means.data_ptr(),
                 log_scales.data_ptr(), quats.data_ptr(),
                 None if active is None else active.data_ptr(),
                 viewmat.data_ptr(), focal.data_ptr(),
                 pixel_center.data_ptr(), int(img_size[0]),
                 int(img_size[1]), means.shape[0], g_xy.data_ptr(),
                 g_conic.data_ptr(), *(g.data_ptr() for g in grads))
    return grads


class _Project(torch.autograd.Function):
    """Projection's seven fields from the splats; xy and conic carry
    gradients to means, log_scales and quats. The backward keeps the
    inputs alone."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, viewmat, focal, pixel_center,
                img_size, active):
        out = project_fwd(means, log_scales, quats, viewmat, focal,
                          pixel_center, img_size, active)
        ctx.save_for_backward(means, log_scales, quats, viewmat, focal,
                              pixel_center, active)
        ctx.img_size = img_size
        ctx.mark_non_differentiable(out.depth, out.radius, out.tile_min,
                                    out.tile_max, out.visible)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_xy, _g_depth, g_conic, *_):
        means, log_scales, quats, viewmat, focal, pixel_center, active = (
            ctx.saved_tensors)
        return (*project_bwd(means, log_scales, quats, viewmat, focal,
                             pixel_center, ctx.img_size, g_xy, g_conic,
                             active), None, None, None, None, None)


def project(means, log_scales, quats, viewmat, focal, pixel_center,
            img_size, active=None) -> Projection:
    """project_splats(means, log_scales, normalize_quats(quats), ...) under
    autograd, by the kernels: the gradients of xy and conic reach means,
    log_scales and quats; the other fields carry none."""
    return Projection(*_Project.apply(
        means, log_scales, quats, viewmat, focal, pixel_center,
        tuple(int(v) for v in img_size), active))
