"""Process-group set-up and rank-local data handling (port of
brush_tpu/parallel/multihost.py).

In JAX a process drives all the devices of its host, and the mesh spans
the processes' devices. In PyTorch a rank is one process driving one
device: ranks are devices, and torch.distributed's collectives (NCCL
between cards, gloo between CPU processes) join them. So `initialize` makes
this process one rank of the process group, and the rank-local helpers
below are by rank where the reference's are by process.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
import torch.distributed as dist

from brush_tpu_torch.device import resolve_device

# torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and
# LOCAL_RANK): present when torchrun started this process.
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device) -> str:
    """NCCL for CUDA tensors, gloo for CPU tensors: chosen by the device."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    LOCAL_RANK; 0 without torchrun): the card it drives."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device) -> torch.device:
    """The device this rank drives: `device`, and for a bare "cuda" the
    card cuda:LOCAL_RANK. Raises where CUDA is asked for and absent."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return dev


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> None:
    """Join the process group as rank process_id of num_processes, whose
    rank 0 listens at coordinator_address ("host:port" for tcp://, or an
    init URL such as file:///path for a file store shared by the ranks).
    With no arguments the world is torchrun's (its environment). The
    backend follows `device` (backend_for); a failed initialization raises.
    """
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None:
        missing = [v for v in TORCHRUN_VARS if v not in os.environ]
        if missing:
            raise RuntimeError(
                f"initialize() without arguments reads torchrun's "
                f"environment; {missing} not set")
        dist.init_process_group(backend_for(dev), init_method="env://")
        return
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend_for(dev), init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))


@contextlib.contextmanager
def process_group(device):
    """The process group of a sharded run on `device`: the caller's where
    one is initialized, else torchrun's where torchrun started this
    process, else a world of one process on a file store in a temporary
    directory. A group made here is destroyed on exit. Yields this rank's
    device."""
    if dist.is_initialized():
        yield rank_device(device)
        return
    with contextlib.ExitStack() as stack:
        if all(v in os.environ for v in TORCHRUN_VARS):
            initialize(device=device)
        else:
            tmp = stack.enter_context(tempfile.TemporaryDirectory(
                prefix="brush_pg_"))
            initialize(f"file://{os.path.join(tmp, 'store')}", 1, 0,
                       device=device)
        try:
            yield rank_device(device)
        finally:
            dist.destroy_process_group()


def _rank_and_size() -> tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def process_view_slice(num_views: int) -> range:
    """The contiguous slice of dataset views this rank hosts: every rank
    draws the same global batch order from identically seeded loaders, but
    decodes only its own views (SURVEY.md §5.8)."""
    r, n = _rank_and_size()
    per = -(-num_views // n)
    return range(r * per, min((r + 1) * per, num_views))


def is_coordinator() -> bool:
    """True on rank 0 (and outside a process group)."""
    return _rank_and_size()[0] == 0
