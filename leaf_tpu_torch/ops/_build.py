"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

The kernels have a plain C interface, so they build with ``nvcc`` alone in
seconds (no PyTorch headers) and bind with ``ctypes``. The build happens
at first use, from the sources in ``csrc/``, into ``build/`` beside this
file (listed in ``.gitignore``). The library's name carries a hash of the
source and flags, so an edited source builds anew and a finished build is
reused by later processes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load_library", "BUILD_DIR", "SOURCE"]

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "fused_frontend.cu"
BUILD_DIR = _HERE / "build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelLibrary:
    """The loaded library, with what its build printed and took."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_log: str,
                 build_seconds: float):
        self.lib = lib
        self.path = path
        self.build_log = build_log          # nvcc/ptxas output ("" if cached)
        self.build_seconds = build_seconds  # 0.0 when an earlier build was reused
        fn = lib.leaf_fused_fwd_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.fused_fwd_f32 = fn


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (PATH or CUDA_HOME)")


@functools.cache
def load_library() -> KernelLibrary:
    """Build (once per source version) and load the kernel library."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libleaf_kernels_{digest}.so"
    log, seconds = "", 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([_nvcc(), *_FLAGS, "-o", tmp, str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: concurrent builders never clash
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
    return KernelLibrary(ctypes.CDLL(str(out)), out, log, seconds)
