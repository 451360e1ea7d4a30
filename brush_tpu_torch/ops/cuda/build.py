"""Build the port's CUDA kernels at first use, bind their C entries, launch
them and count the launches: the one seam between the kernel wrappers and
their native code.

Each source under brush_tpu_torch/csrc/ is compiled by nvcc into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), for sm_90a (Hopper):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

Libraries land in brush_tpu_torch/csrc/build/ (listed in .gitignore) under
a name that carries a hash of the source and of every header (*.cuh) beside
it, so an edited source or header rebuilds and a stale library is never
loaded. `build_all()` starts one nvcc per missing source, all at once, and
waits for them together, one process at a time across processes
(native.build_once, which the host library's build shares).

ENTRIES lists every C entry once with its signature; an entry is bound
when its library is first loaded. A wrapper launches through `launch`,
which counts each launch under the wrapper's name (KERNELS), in one
registry that `launch_counts()` reads and `reset_launch_counts()` clears.
A kernel is one .cu under csrc/, its rows here and one wrapper in this
package that checks the inputs, allocates the outputs and picks the kernel
or its plain twin by device.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import torch

from brush_tpu_torch.native import build_once, library_path

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


class Entry(NamedTuple):
    """A C entry of csrc/<source>.cu: a code a C argument and one for the
    result (P a pointer, I an int, L a long long); a launch entry takes
    the stream last and names the wrapper whose launches it counts."""

    source: str
    args: str
    result: str = "I"
    counts: str | None = None


ENTRIES = {
    "expand_launch": Entry("expand", "PPPPIIIIPPP", counts="expand"),
    "rasterize_fwd_launch": Entry("rasterize_fwd", "PIPPIIIIIIIPPPPP",
                                  counts="rasterize_fwd"),
    "rasterize_fwd_attrs": Entry("rasterize_fwd", "IIP"),
    "rasterize_bwd_launch": Entry("rasterize_bwd", "PIPPIIIIIIIPPPPPPP",
                                  counts="rasterize_bwd"),
    "rasterize_bwd_attrs": Entry("rasterize_bwd", "IP"),
    "segsum_launch": Entry("segsum", "PIPPPIPPP", counts="segment_sum"),
    "segsum_scratch_floats": Entry("segsum", "I", "L"),
    "tile_pretest_launch": Entry("tile_pretest", "PPPPPPIIIPPPPPP",
                                 counts="tile_pretest"),
    "sh_color_fwd_launch": Entry("sh", "PPIPIIIPP", counts="sh_color_fwd"),
    "sh_color_bwd_launch": Entry("sh", "PPIPIIIPP", counts="sh_color_bwd"),
    "project_fwd_launch": Entry("projection", "PPPPPPPIIIIIPPPPPPPP",
                                counts="project_fwd"),
    "project_bwd_launch": Entry("projection", "PPPPPPPIIIPPPPPP",
                                counts="project_bwd"),
}
SOURCES = tuple(dict.fromkeys(e.source for e in ENTRIES.values()))
KERNELS = tuple(e.counts for e in ENTRIES.values() if e.counts)
_CTYPES = {"P": ctypes.c_void_p, "I": ctypes.c_int, "L": ctypes.c_longlong}

_lock = threading.Lock()
_bound: dict = {}   # entry name -> its bound function
_count_lock = threading.Lock()
_launches = dict.fromkeys(KERNELS, 0)


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    /usr/local/cuda/bin/nvcc. Raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return library_path(BUILD_DIR, name, [os.path.join(CSRC, f) for f in
                                          (f"{name}.cu", *headers)])


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library in parallel; returns name -> path.

    Raises RuntimeError with nvcc's output if any compile fails.
    """
    paths = {n: _lib_path(n) for n in names}
    errors = []

    def compile_missing(todo):
        procs = {n: subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", todo[path],
             os.path.join(CSRC, f"{n}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for n, path in paths.items() if path in todo}
        for n, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu (rc "
                              f"{proc.returncode}):\n{log}")
        return {paths[n] for n, proc in procs.items()
                if proc.returncode == 0}

    build_once(BUILD_DIR, list(paths.values()), compile_missing)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def bind(path: str, source: str) -> ctypes.CDLL:
    """The library at path, each C entry of csrc/<source>.cu in ENTRIES
    given its signature (also a library built from another version of that
    source with the same entries)."""
    lib = ctypes.CDLL(path)
    for name, e in ENTRIES.items():
        if e.source == source:
            fn = getattr(lib, name)
            fn.argtypes = [_CTYPES[c] for c in e.args]
            fn.restype = _CTYPES[e.result]
    return lib


def entry(name: str):
    """The C entry `name` of ENTRIES, bound; its library built and loaded
    at first use."""
    fn = _bound.get(name)
    if fn is None:
        with _lock:
            source = ENTRIES[name].source
            if name not in _bound:
                lib = bind(build_all((source,))[source], source)
                _bound.update((n, getattr(lib, n)) for n, e in
                              ENTRIES.items() if e.source == source)
            fn = _bound[name]
    return fn


def check_tensors(*specs) -> None:
    """A wrapper's input check: raise ValueError unless each (name,
    tensor, shape, dtype) of specs has that shape and dtype, and all the
    tensors lie on one device."""
    for name, t, shape, dtype in specs:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if len({t.device for _, t, _, _ in specs}) != 1:
        raise ValueError("inputs on several devices: " + ", ".join(
            f"{name} on {t.device}" for name, t, _, _ in specs))


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def launch(name: str, device, *args) -> None:
    """Launch the kernel of the launch entry `name` on `device` and that
    device's current stream, which it passes after args (tensors as their
    data_ptr()). Raises on a CUDA error; counts the launch under the
    entry's wrapper."""
    fn = entry(name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    check(rc, name)
    with _count_lock:
        _launches[ENTRIES[name].counts] += 1


def read_attrs(name: str, *args) -> tuple:
    """What nvcc made of the kernel instantiation that args pick, as the
    attrs entry `name` reads it on the card (cudaFuncGetAttributes):
    (registers a thread, local memory a thread in bytes, blocks an SM can
    hold)."""
    out = (ctypes.c_int * 3)()
    check(entry(name)(*args, out), name)
    return tuple(out)


def launch_counts() -> dict:
    """{wrapper name: its kernel's launches in this process}, every
    wrapper of KERNELS (plain versions are not counted)."""
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _launches:
            _launches[name] = 0
