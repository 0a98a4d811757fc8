"""Build and bind the CUDA kernels of `karpenter_tpu_torch/csrc/`.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into a shared
library with a plain C interface, `_build/lib<name>-<hash>.so`, loaded
with `ctypes`; a source may export several entry points (`ENTRIES`).  The hash covers the sources and the flags, so an edited
kernel rebuilds and an unchanged one loads the library already there.
Nothing here runs at import: the first call of a kernel wrapper builds
what it needs, and `build()` builds every kernel at once, one `nvcc` per
source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# the sources, one library each
KERNELS = ("ffd_batch_scan", "ffd_sweep_scan", "ffd_pack")
# entry point -> the source that exports it
ENTRIES = {"ffd_batch_scan": "ffd_batch_scan",
           "ffd_sweep_scan": "ffd_sweep_scan",
           "ffd_sweep_topo_scan": "ffd_sweep_scan",
           "ffd_pack": "ffd_pack"}

# -fmad=false and the precise division/sqrt keep the float arithmetic the
# reference's (the kernels also spell every operation with a
# round-to-nearest intrinsic); never --use_fast_math
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-prec-div=true",
    "-prec-sqrt=true", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register/spill report per kernel from the last build (stderr)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels of karpenter_tpu_torch cannot be built")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(os.listdir(CSRC)):
        if src == f"{name}.cu" or src.endswith(".cuh"):
            with open(os.path.join(CSRC, src), "rb") as f:
                h.update(src.encode() + f.read())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def build(names: Sequence[str] = KERNELS) -> float:
    """Compile every kernel in `names` that has no up-to-date library, one
    `nvcc` process per source, all running at once.  Returns the wall
    seconds spent; raises RuntimeError with nvcc's output on failure."""
    t0 = time.perf_counter()
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed: List[str] = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def kernel(name: str):
    """The ctypes entry point `name` of its source's library, building it
    on first use.  Signature: (ptrs: u64[], nptrs, dims: i32[], ndims,
    stream) -> int."""
    src = ENTRIES[name]
    with _lock:
        lib: Optional[ctypes.CDLL] = _libs.get(src)
        if lib is None:
            build((src,))
            lib = ctypes.CDLL(_lib_path(src))
            for entry, s in ENTRIES.items():
                if s != src:
                    continue
                fn = getattr(lib, entry)
                fn.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _libs[src] = lib
    return getattr(lib, name)


def launch(name: str, ptrs: Sequence[int], dims: Sequence[int],
           stream: int) -> None:
    """Call kernel `name` with device addresses `ptrs` and integer `dims`
    on CUDA stream `stream`; raise if the entry point rejects its
    arguments or the launch fails."""
    fn = kernel(name)
    p = (ctypes.c_uint64 * len(ptrs))(*ptrs)
    d = (ctypes.c_int * len(dims))(*dims)
    rc = fn(p, len(ptrs), d, len(dims), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed: "
            + (f"argument check {rc}" if rc < 0 else f"cudaError {rc}"))
