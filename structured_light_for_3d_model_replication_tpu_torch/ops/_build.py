"""Build the CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles each of ``ops/csrc/*.cu`` to an object, all sources at
once in parallel processes, and links them into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds). The
library lands in ``ops/_kernel_build/<hash>/`` — the hash covers the sources
and the flags, so an edited source builds anew — and is published with an
atomic rename, so concurrent first users never load a torn file. A missing
``nvcc`` or a failed build raises; nothing here falls back.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["NVCC_FLAGS", "sources", "library_path", "build", "load_library"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_NAME = "libslscan_kernels.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_HERE, "csrc", "*.cu")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/"
        "bin): the CUDA toolkit is needed to build the port's kernels")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(_HERE, "_kernel_build", h.hexdigest()[:16], _LIB_NAME)


def build() -> str:
    """Compile the kernels unless this source hash was built already;
    returns the library path."""
    path = library_path()
    if os.path.isfile(path):
        return path
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    jobs = []
    for src in sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    link = [nvcc, "-shared", "-o", tmp] + [obj for _, obj, _ in jobs]
    try:
        for cmd, _, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                                   f"{' '.join(cmd)}\n{out}{err}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        for _, obj, proc in jobs:
            proc.wait()
            if os.path.exists(obj):
                os.remove(obj)
    return path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        return _lib
