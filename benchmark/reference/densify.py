"""Plain PyTorch reference of the densification statistics and the refine.

What the benchmark holds the program's trainer to across a refine. It
imports nothing of the program, and of the benchmark only
reference/splat.py (the render, the loss and Adam). Float32, TF32 off
(`splat.precision`). It holds the live rows only: no padding rows, no
capacity.

The semantics are those of Brush (brush-train/src/train.rs:284-316 and
:459-597, as the program states them) and of 3D gaussian splatting
(Kerbl et al. 2023, sec. 5.2):

- statistics: after a step past warmup, each splat's screen-space
  gradient dL/d(xy), in pixels, is scaled to half-image units (x by w/2,
  y by h/2); its norm adds to the splat's sum, and a splat that emits at
  least one record adds one to its count;
- densify: a splat whose average (sum over max(count, 1)) reaches
  `densify_grad_thresh` densifies. It clones if its largest post-step
  scale is under `densify_size_thresh`: a copy of the splat as it was
  before the step's Adam update is appended. Else it splits: with s and
  R the post-step scales and rotation (the quaternion normalized) and n,
  n2 two standard normal draws, a half at the pre-step mean plus
  R (0.5 n * s) is appended with the post-step rotation, SH and opacity,
  and the splat itself moves to the pre-step mean minus R (0.5 n2 * s);
  both take the log scales log(s / 1.6);
- prune: every candidate, kept original or appended row, whose opacity
  is under `cull_alpha_thresh` or whose largest scale is over
  `cull_scale_thresh` is dropped;
- order: the kept originals in their order, then the kept appended rows
  in the order of the splats they came from;
- opacity reset: at a refine whose index (iteration // refine_every) is
  a positive multiple of `reset_alpha_every_refine`, every kept row's
  opacity becomes `reset_alpha_value`;
- moments: a kept original keeps its Adam moments, an appended row starts
  from zero, the step count goes on; the statistics restart from zero.

Departures from the 3DGS paper, all Brush's: a split's two positions are
offsets of 0.5 N(0, 1) * scale in the splat's frame from separate draws
(the paper samples both from the gaussian itself); the clone is the
pre-step copy; the size threshold is absolute (the paper's is 1 % of the
scene extent); the reset value is 0.004 (the paper's 0.01); no pruning by
screen size. Brush's own code applies its split changes to copies it
then discards (train.rs:482-520); the program's default, followed here,
moves and shrinks the original as the paper intends. The split draws are
inputs, like the weights: the trainer's generator draws them as (rows,
3) tensors, and the caller hands this module the live rows'.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import splat as ref


def step_grads(params: dict, cam: ref.Cam, gt: torch.Tensor,
               ssim_weight: float = 0.2, scan=None):
    """One training render through the loss, as splat.step_grads: (loss,
    the leaves' gradients, dL/d(xy) (n, 2) in pixels, and which splats
    emit a record (n,) bool)."""
    n = params["means"].shape[0]
    active = torch.ones(n, dtype=torch.bool, device=params["means"].device)
    leaves = {k: params[k].detach().requires_grad_(True) for k in ref.LEAVES}
    s = ref.project(leaves, cam, active)
    rec = ref.records(s, cam.size)
    graph = (s.xy, s.conic, s.color, s.opac)
    attrs = tuple(a.detach().requires_grad_(True) for a in graph)
    img = ref.render(attrs, rec, cam.size, scan=scan).requires_grad_(True)
    loss = ref.image_loss(img, gt, ssim_weight)
    loss.backward()
    ref.backward_tiles(attrs, rec, img.grad, scan)
    g_attrs = [a.grad if a.grad is not None else torch.zeros_like(a)
               for a in attrs]
    torch.autograd.backward(graph, g_attrs)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    producing = torch.zeros(n, dtype=torch.bool, device=active.device)
    producing[rec.splat] = True
    return loss.detach(), grads, g_attrs[0], producing


def add_statistics(accum: torch.Tensor, counts: torch.Tensor,
                   xy_grad: torch.Tensor, producing: torch.Tensor, size):
    """The sums and counts after one step past warmup."""
    w, h = size
    scaled = xy_grad * torch.tensor([w / 2.0, h / 2.0],
                                    device=xy_grad.device)
    norms = torch.sqrt(torch.sum(scaled * scaled, dim=1))
    return accum + norms, counts + producing.to(counts.dtype)


def averages(accum: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    return accum / torch.clamp(counts, min=1).to(torch.float32)


def rotate(quats: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) v for each row, the quaternion normalized first."""
    q = quats / torch.clamp(torch.linalg.vector_norm(quats, dim=-1,
                                                     keepdim=True),
                            min=1e-12)
    return torch.sum(ref.quat_rotmat(q) * v[:, None, :], dim=-1)


def resets(it: int, rc: dict) -> bool:
    """Does the refine after iteration `it` reset opacities?"""
    idx = it // rc["refine_every"]
    return idx > 0 and idx % rc["reset_alpha_every_refine"] == 0


@torch.no_grad()
def refine(post: dict, pre: dict, m: dict, v: dict, accum: torch.Tensor,
           counts: torch.Tensor, noise: torch.Tensor, noise2: torch.Tensor,
           rc: dict, reset: bool):
    """One refine of the live rows (the module docstring). `post` and `pre`:
    the parameters after and before the step's Adam update; `m`, `v` its
    moments; `rc` the recipe's thresholds. Returns (params, m, v, stats,
    origin): stats the counts cloned, split, pruned by opacity and by
    scale, and live; origin (rows,) the live row each new row came from."""
    n = post["means"].shape[0]
    dev = post["means"].device
    dens = averages(accum, counts) >= rc["densify_grad_thresh"]
    s = torch.exp(post["log_scales"])
    small = torch.amax(s, dim=1) < rc["densify_size_thresh"]
    clone, split = dens & small, dens & ~small
    half = torch.log(s / 1.6)

    orig = dict(post)
    orig["means"] = torch.where(
        split[:, None], pre["means"] - rotate(post["quats"], 0.5 * noise2 * s),
        post["means"])
    orig["log_scales"] = torch.where(split[:, None], half,
                                     post["log_scales"])

    src = torch.nonzero(dens)[:, 0]
    c = clone[src]
    app = {k: torch.where(c.reshape((-1,) + (1,) * (pre[k].dim() - 1)),
                          pre[k][src], post[k][src]) for k in ref.LEAVES}
    app["means"] = torch.where(
        c[:, None], pre["means"][src],
        pre["means"][src] + rotate(post["quats"][src],
                                   0.5 * noise[src] * s[src]))
    app["log_scales"] = torch.where(c[:, None], pre["log_scales"][src],
                                    half[src])

    def pruned(p):
        alpha = torch.sigmoid(p["raw_opacity"]) < rc["cull_alpha_thresh"]
        big = (torch.amax(torch.exp(p["log_scales"]), dim=1)
               > rc["cull_scale_thresh"])
        return alpha, big & ~alpha

    alpha_o, scale_o = pruned(orig)
    alpha_a, scale_a = pruned(app)
    keep_o = ~alpha_o & ~scale_o
    keep_a = ~alpha_a & ~scale_a
    out = {k: torch.cat([orig[k][keep_o], app[k][keep_a]])
           for k in ref.LEAVES}
    if reset:
        value = rc["reset_alpha_value"]
        out["raw_opacity"] = torch.full_like(out["raw_opacity"],
                                             math.log(value / (1 - value)))
    fresh = int(keep_a.sum())
    moments = [{k: torch.cat([x[k][keep_o], torch.zeros(
        (fresh,) + tuple(x[k].shape[1:]), device=dev)]) for k in ref.LEAVES}
        for x in (m, v)]
    origin = torch.cat([torch.arange(n, device=dev)[keep_o], src[keep_a]])
    stats = {"cloned": int(clone.sum()), "split": int(split.sum()),
             "pruned_alpha": int(alpha_o.sum() + alpha_a.sum()),
             "pruned_scale": int(scale_o.sum() + scale_a.sum()),
             "live": int(origin.shape[0])}
    return out, moments[0], moments[1], stats, origin
