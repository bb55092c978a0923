"""Build and load the port's CUDA kernels (nvcc → shared libraries → ctypes).

The kernels have a plain C interface, so they build with ``nvcc`` alone in
seconds (no PyTorch headers) and bind with ``ctypes``. The build happens
at first use, from the sources in ``csrc/`` (one ``nvcc`` per source, all
started together), into ``build/`` beside this file (listed in
``.gitignore``). Each library's name carries a hash of its source, of
every ``csrc/`` header that source includes, and of the flags, so an edited
source or header builds anew and a finished build is reused by later
processes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load_library", "BUILD_DIR", "SOURCES"]

_HERE = Path(__file__).resolve().parent
# library name → source: the forward kernels (primal and residual-saving)
# and the backward kernel, in f32 (3×TF32) and in bf16, the device phase
# markers (``leaf_tpu_torch.tracing``) and the depthwise convolutions
# (``depthwise.py``)
SOURCES = {"fwd": _HERE / "csrc" / "fused_frontend.cu",
           "bwd": _HERE / "csrc" / "fused_frontend_bwd.cu",
           "fwd_bf16": _HERE / "csrc" / "fused_frontend_bf16.cu",
           "bwd_bf16": _HERE / "csrc" / "fused_frontend_bwd_bf16.cu",
           "marks": _HERE / "csrc" / "marks.cu",
           "depthwise": _HERE / "csrc" / "depthwise.cu"}
BUILD_DIR = _HERE / "build"
# the fused kernels are sm_90a SASS (wgmma); the markers and the depthwise
# kernels are sm_90 SASS and portable PTX, which the driver compiles at load
# on any other card
_PORTABLE = ["-gencode", "arch=compute_90,code=sm_90",
             "-gencode", "arch=compute_75,code=compute_75"]
_ARCH = {"marks": _PORTABLE, "depthwise": _PORTABLE}
_HOPPER = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C entry point → argument types (the launches return the launch's CUDA
# error code, the bf16 backward's smem_bytes its shared memory per block)
_SIGNATURES = {
    "fwd": {"leaf_fused_fwd_f32": [_PTR] * 4 + [_INT] * 4 + [_PTR],
            "leaf_fused_fwd_save_f32": [_PTR] * 5 + [_INT] * 4 + [_PTR]},
    "bwd": {"leaf_fused_bwd_f32": [_PTR] * 6 + [_INT] * 5 + [_PTR]},
    "fwd_bf16": {"leaf_fused_fwd_bf16": [_PTR] * 4 + [_INT] * 4 + [_PTR],
                 "leaf_fused_fwd_save_bf16": [_PTR] * 5 + [_INT] * 4 + [_PTR]},
    "bwd_bf16": {"leaf_fused_bwd_bf16": [_PTR] * 6 + [_INT] * 5 + [_PTR],
                 "leaf_fused_bwd_bf16_smem_bytes": []},
    "marks": {"leaf_phase_mark": [_INT, _PTR],
              "leaf_phase_marks_load": []},
    "depthwise": {"leaf_depthwise_fwd_f32": [_PTR] * 3 + [_INT] * 12 + [_PTR],
                  "leaf_depthwise_dgrad_f32": [_PTR] * 3 + [_INT] * 12
                  + [_PTR],
                  "leaf_depthwise_wgrad_f32": [_PTR] * 4 + [_INT] * 14
                  + [_PTR]},
}


class KernelLibrary:
    """The loaded libraries, with what their builds printed and took."""

    def __init__(self, libs: dict, paths: dict, build_log: str,
                 build_seconds: float):
        self.paths = paths                  # library name → .so path
        self.build_log = build_log          # nvcc/ptxas output ("" if cached)
        self.build_seconds = build_seconds  # 0.0 when earlier builds were reused
        for name, fns in _SIGNATURES.items():
            for sym, argtypes in fns.items():
                fn = getattr(libs[name], sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(self, sym.removeprefix("leaf_"), fn)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (PATH or CUDA_HOME)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _inputs(path: Path) -> list:
    """``path`` and every file it includes with quotes, transitively
    (resolved beside the including file), each once, in a fixed order."""
    files, todo = [], [path]
    while todo:
        f = todo.pop(0)
        if f not in files:
            files.append(f)
            todo += [(f.parent / inc.decode()).resolve()
                     for inc in _INCLUDE.findall(f.read_bytes())]
    return files


def _flags(name: str) -> list:
    return _ARCH.get(name, _HOPPER) + _FLAGS


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for f in _inputs(SOURCES[name]):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"libleaf_{name}_{digest}.so"


@functools.cache
def load_library() -> KernelLibrary:
    """Build (once per source version) and load the kernel libraries."""
    paths = {name: _target(name) for name in SOURCES}
    missing = [name for name, out in paths.items() if not out.exists()]
    log, seconds = "", 0.0
    if missing:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        jobs = {}
        try:
            for name in missing:
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                jobs[name] = (tmp, subprocess.Popen(
                    [nvcc, *_flags(name), "-o", tmp, str(SOURCES[name])],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            for name, (tmp, proc) in jobs.items():
                out, _ = proc.communicate()
                log += f"[{SOURCES[name].name}]\n{out}"
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {SOURCES[name].name} "
                                       f"({proc.returncode}):\n{out}")
                os.replace(tmp, paths[name])  # atomic: builders never clash
        finally:
            for tmp, proc in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
        seconds = time.perf_counter() - t0
    libs = {name: ctypes.CDLL(str(out)) for name, out in paths.items()}
    return KernelLibrary(libs, paths, log, seconds)
