"""The process group as a mesh, state placement, and the two
differentiable collectives of the sharded step (port of
brush_tpu/parallel/sharding.py).

The decomposition is the reference's (BASELINE.md north star; Brush is
single-GPU), on one axis that serves two phases:

- splats are sharded over the ranks for projection, SH and Adam: each rank
  holds a contiguous block of rows of every (C, ...) leaf;
- the attribute rows are all-gathered (forward) and the gradient
  reduce-scattered back to each row block (backward): GatherColumns;
- each rank runs the record pipeline on its own row-aligned strip of
  raster cells, and the image strips are all-gathered for the loss
  (GatherStrips);
- the parameter gradients arrive on their own rows, and Adam runs there.

The mesh is the default process group (multihost.initialize): its world
size (the reference's mesh.size), this rank, and the device it drives.
NCCL joins CUDA ranks, gloo CPU ranks (multihost.backend_for).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from brush_tpu_torch.parallel.multihost import backend_for, rank_device
from brush_tpu_torch.train import map_rows


# torch 2.13 names the two collectives all_gather_single and
# reduce_scatter_single and deprecates the old names with a FutureWarning;
# torch 2.11.0+cu128, on which the H100 runs were made, has only the old
# names.
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    size: int             # ranks in the process group
    rank: int             # this process's rank
    device: torch.device  # the device this rank drives


def make_mesh(device="cuda") -> Mesh:
    """The initialized default process group as a Mesh on `device` (for a
    bare "cuda": cuda:LOCAL_RANK). Raises if no group is initialized or
    its backend is not the one the device needs."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.multihost.initialize() first")
    dev = rank_device(device)
    backend = dist.get_backend()
    if backend != backend_for(dev):
        raise ValueError(f"a {backend} process group cannot carry {dev} "
                         f"tensors; it needs {backend_for(dev)}")
    return Mesh(dist.get_world_size(), dist.get_rank(), dev)


def rows_of(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of x's rows, on its device."""
    c = x.shape[0]
    if c % mesh.size:
        raise ValueError(f"{c} rows do not split over {mesh.size} ranks")
    per = c // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device,
                                                        copy=True)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's block of rows, in rank order (the inverse of
    rows_of)."""
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather(out, x.contiguous())
    return out


def shard_state(state, mesh: Mesh):
    """A TrainState or Splats with every (C, ...) leaf cut to this rank's
    row block; scalars (n_live, the Adam count) stay as they are."""
    return map_rows(state, lambda x: rows_of(x, mesh))


def gather_state(state, mesh: Mesh):
    """The inverse of shard_state, on every rank (for the refine and for
    checkpoints)."""
    return map_rows(state, lambda x: all_gather_rows(x, mesh))


def gather_columns(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(R, n) on each rank -> (R, size n), the ranks' columns in rank
    order."""
    rows = x.shape[0]
    out = all_gather_rows(x, mesh).reshape(mesh.size, rows, -1)
    return out.permute(1, 0, 2).reshape(rows, -1)


class GatherColumns(torch.autograd.Function):
    """gather_columns with its transpose as the backward: the ranks'
    cotangents of all columns are summed and each rank keeps its own
    (reduce-scatter). Every rank back-propagates its own strip's records,
    so each holds a part of every splat's gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_columns(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        rows = g.shape[0]
        parts = g.reshape(rows, mesh.size, -1).permute(1, 0, 2).reshape(
            mesh.size * rows, -1)
        out = torch.empty((rows, parts.shape[1]), dtype=g.dtype,
                          device=g.device)
        _reduce_scatter(out, parts.contiguous(), op=dist.ReduceOp.SUM)
        return out, None


class GatherStrips(torch.autograd.Function):
    """(T, ...) strips on each rank -> (size T, ...) in rank order. The
    backward keeps this rank's strip of the cotangent and communicates
    nothing: every rank computes the same loss from the same gathered
    image, so its cotangent is already whole on each rank (summing the
    ranks' cotangents, as an all-gather's usual transpose does, would give
    size times the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.rows = x.shape[0]
        return all_gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.rank * ctx.rows
        return g[lo:lo + ctx.rows].contiguous(), None
