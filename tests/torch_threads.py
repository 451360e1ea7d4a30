"""One torch intra-op thread pool a test process, sized to its share of
the cores.

Under pytest-xdist every worker starts torch with a pool of one thread a
core, so six workers on eight cores run 48 threads that contend for the
cores; the port's plain kernels (many small torch ops a record batch) then
spend their time waiting for one another. Each tests/test_torch_*.py calls
pin_threads() when it is imported: a worker's pool gets the cores divided
by PYTEST_XDIST_WORKER_COUNT (at least one thread), a run without workers
keeps a thread a core. Thread counts change no result the tests compare
(the plain versions repeat their bits at 1 to 8 threads).
"""

import os

import torch


def pin_threads() -> int:
    """Set and return torch's intra-op thread count for this process."""
    workers = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    threads = max(1, len(os.sched_getaffinity(0)) // workers)
    if torch.get_num_threads() != threads:
        torch.set_num_threads(threads)
    return threads
