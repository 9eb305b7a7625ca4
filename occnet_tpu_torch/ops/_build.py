"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`), one
`nvcc` process per source, all started together, and the objects are linked
into ONE shared library with a plain C interface, loaded with `ctypes`.  The
build runs at first use (never at import), goes to `csrc/build/`
(git-ignored), and is keyed by a hash of the sources and flags, so an edited
kernel rebuilds and an unchanged one loads in milliseconds.  Including no
PyTorch header keeps the build to seconds.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `Kernel.__call__` raises on a nonzero code and counts
the launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Sequence

from occnet_tpu_torch.utils.profiling import count, span

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of occnet_tpu_torch are built at first use")
    return found


def _sources() -> Sequence[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process.
    The build or load is the span ``setup.kernels``, and the counter
    ``kernels.built`` is 1 when this process compiled the library."""
    global _lib
    if _lib is not None:
        return _lib
    with span("setup.kernels"):
        srcs = _sources()
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            with open(s, "rb") as f:
                digest.update(os.path.basename(s).encode() + f.read())
        so = os.path.join(BUILD_DIR, "liboccnet_kernels_"
                                     f"{digest.hexdigest()[:16]}.so")
        built = not os.path.exists(so)
        if built:
            _compile(so, [s for s in srcs if s.endswith(".cu")])
        count("kernels.built", int(built))
        _lib = ctypes.CDLL(so)
    return _lib


def _compile(so: str, cu_sources: Sequence[str]) -> None:
    """nvcc -c every source in parallel, then link them into ``so``."""
    nvcc = _nvcc()
    tmp_dir = f"{so}.{os.getpid()}.d"
    os.makedirs(tmp_dir, exist_ok=True)
    jobs = []
    for src in cu_sources:
        obj = os.path.join(tmp_dir, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    tmp = os.path.join(tmp_dir, "lib.so")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
               *[obj for _, obj, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stdout + res.stderr)
    with open(so[:-3] + ".log", "w") as f:
        f.write("\n".join(log))
    if failed:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-4000:])
    os.replace(tmp, so)            # atomic: a concurrent loader never sees
    shutil.rmtree(tmp_dir, ignore_errors=True)   # a half-written library


def build_log() -> str:
    """nvcc's output (with `-Xptxas=-v` register/spill counts) of the build
    that produced the loaded library."""
    if _lib is None:
        return ""
    with open(_lib._name[:-3] + ".log") as f:
        return f.read()


class Kernel:
    """One C entry point of the kernel library plus its launch count.

    `launches` counts successful launches and nothing else, so a caller can
    show that a run went through the kernel (reset it to 0 before the run).
    """

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.symbol} failed to launch: "
                               f"cudaError {err}")
        self.launches += 1


P = ctypes.c_void_p          # device pointers and the cudaStream_t
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float
