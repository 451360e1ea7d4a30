"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under brush_tpu_torch/csrc/ is compiled by nvcc into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), for sm_90a (Hopper):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

Libraries land in brush_tpu_torch/csrc/build/ (listed in .gitignore) under
a name that carries a hash of the source and of every header (*.cuh) beside
it, so an edited source or header rebuilds and a stale library is never
loaded. `build_all()` starts one nvcc per source,
all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("expand", "rasterize_fwd", "rasterize_bwd", "segsum", "sh",
           "tile_pretest")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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
    sha = hashlib.sha1()
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            sha.update(f.read())
    digest = sha.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library in parallel; returns name -> path.

    Raises RuntimeError with nvcc's output if any compile fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {n: _start(n, p) for n, p in paths.items()
             if not os.path.exists(p)}
    errors = []
    for n, proc in procs.items():
        log, _ = proc.communicate()
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):\n"
                          f"{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all((name,))[name])
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
