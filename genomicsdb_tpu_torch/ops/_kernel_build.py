"""Build and load the port's CUDA kernels (nvcc + ctypes).

`load_library()` compiles every `genomicsdb_tpu_torch/csrc/*.cu` into
one shared library with a plain C interface, at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/*.cu

The library lands in `build/genomicsdb_tpu_torch/` under the checkout,
named by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads the cached file.  The first build runs under
two locks: a thread lock, so that threads of one process (the stream
server's connections) that launch at once build and load it once, and
an `fcntl.flock` on `BUILD_DIR/build.lock`, so that processes that start
at once (mesh ranks, rank workers) run nvcc once and the others load
the file it wrote (`os.replace` puts it in place whole).  Nothing is
compiled when a module is imported: the CPU test suite imports every
module on machines with no nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from functools import lru_cache

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "genomicsdb_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_BUILD_LOCK = threading.Lock()


@dataclass(frozen=True)
class KernelLibrary:
    """The loaded library plus what its build reported."""
    lib: ctypes.CDLL
    path: str
    build_seconds: float      # 0.0 when a cached build was loaded
    ptxas_log: str            # nvcc's -Xptxas -v report ("" if cached)


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.isfile("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return path


def _source_hash(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process;
    raises when nvcc is missing or the build fails."""
    with _BUILD_LOCK:
        return _load_library()


@lru_cache(maxsize=1)
def _load_library() -> KernelLibrary:
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    path = os.path.join(BUILD_DIR,
                        f"libgdb_torch_kernels_{_source_hash(srcs)}.so")
    build_s, log = 0.0, ""
    if not os.path.isfile(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, "build.lock"), "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not os.path.isfile(path):   # another process built it
                    build_s, log = _build(srcs, path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    lib = ctypes.CDLL(path)
    _bind(lib)
    return KernelLibrary(lib=lib, path=path, build_seconds=build_s,
                         ptxas_log=log)


def _build(srcs, path: str):
    """nvcc of `srcs` into `path`: (seconds, nvcc's report)."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_s = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
    return build_s, log


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f = lib.gdb_fused_gather_remap
    f.restype = i32
    # 19 inputs + 10 outputs, then B, S, C, 13 int dims/flags, the
    # plan (host ints) and its length, stream
    f.argtypes = [vp] * 29 + [i64] * 3 + [i32] * 13 + [vp, i32, vp]
    lib.gdb_cuda_error_string.restype = ctypes.c_char_p
    lib.gdb_cuda_error_string.argtypes = [i32]
