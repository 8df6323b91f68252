"""ctypes binding of the port's native IO runtime (``io/csrc/slio.cpp``).

The JAX package's ``io/native.py`` with the port's own library: a
thread-pooled gray PNG stack decoder and buffered binary PLY / STL writers,
the same entry points and output bytes as the JAX package's
``native/libslio.so``.

g++ builds the library at first use into ``io/_native_build/<hash>/`` (the
hash covers the source and the flags), published by an atomic rename so
concurrent first users never load a torn file; ``slio_abi_version() == 1``
is checked; a library that does not load (one built on another host) is
built anew. Where the source (an install without package data), g++,
libpng's header or libpng itself is missing, ``available()`` is False, one
stderr line names what is missing, and the callers take the Python readers
and writers, as in the JAX package. Where
the toolchain is there and the build or the ABI check fails, the call
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading

import numpy as np

__all__ = ["CXX_FLAGS", "LIBS", "library_path", "build", "load", "available",
           "status", "probe_png", "load_gray_stack", "write_ply_native",
           "write_stl_native"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "slio.cpp")
# the JAX package's Makefile flags without -march=native (the library is
# built on each host it runs on) and with FMA contraction off, so the STL
# normals are the same bytes on every host
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-ffp-contract=off",
             "-shared")
LIBS = ("-lpng", "-lz", "-lpthread")
_PROBE = "#include <png.h>\nint main() { return png_access_version_number() == 0; }\n"

_lock = threading.Lock()
_state: dict = {}   # "lib": CDLL | None, "path": str | None, "missing": str | None


def library_path(root: str | None = None) -> str:
    """Where the library of this source and these flags lives (``root``
    defaults to ``io/_native_build``)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    root = root or os.path.join(_HERE, "_native_build")
    return os.path.join(root, h.hexdigest()[:16], "libslio.so")


def _missing(cxx: str | None, work: str) -> str | None:
    """What the host lacks to build the library, or None."""
    if cxx is None:
        return "g++ not found on PATH"
    probe = os.path.join(work, f"probe.{os.getpid()}.{threading.get_ident()}")
    with open(probe + ".cpp", "w") as f:
        f.write(_PROBE)
    try:
        proc = subprocess.run([cxx, probe + ".cpp", "-o", probe + ".out", *LIBS],
                              capture_output=True, text=True)
    finally:
        for p in (probe + ".cpp", probe + ".out"):
            if os.path.exists(p):
                os.remove(p)
    if proc.returncode != 0:
        first = (proc.stderr.strip().splitlines() or ["no output"])[0]
        return f"libpng (png.h or -lpng) not found: {first.split('error: ')[-1]}"
    return None


def build(root: str | None = None) -> tuple[str | None, str | None]:
    """Build the library unless this source and these flags were built
    already. Returns (path, None), or (None, what is missing) where the
    source, g++ or libpng is absent; a failed build raises."""
    if not os.path.isfile(SOURCE):
        return None, f"source {SOURCE} not found"
    path = library_path(root)
    if os.path.isfile(path):
        return path, None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cxx = shutil.which("g++")
    missing = _missing(cxx, os.path.dirname(path))
    if missing is not None:
        return None, missing
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, None


def load(path: str) -> ctypes.CDLL:
    """Load a built library and bind its entry points; raises unless its
    ABI version is 1."""
    lib = ctypes.CDLL(path)
    lib.slio_abi_version.restype = ctypes.c_int
    if lib.slio_abi_version() != 1:
        raise RuntimeError(f"{path}: slio_abi_version() is "
                           f"{lib.slio_abi_version()}, expected 1")
    lib.slio_probe_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.slio_probe_png.restype = ctypes.c_int
    lib.slio_load_gray_stack.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.slio_load_gray_stack.restype = ctypes.c_int
    lib.slio_write_ply.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)]
    lib.slio_write_ply.restype = ctypes.c_int
    lib.slio_write_stl.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32)]
    lib.slio_write_stl.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL | None:
    with _lock:
        if "lib" not in _state:
            path, missing = build()
            lib = None
            if path is not None:
                try:
                    lib = load(path)
                except OSError:   # built on another host (a copied tree): build it here
                    os.remove(path)
                    path, missing = build()
                    lib = load(path) if path else None
            _state.update(lib=lib, path=path, missing=missing)
            if missing is not None:
                print(f"[native] unavailable: {missing}; the Python readers and "
                      f"writers run instead", file=sys.stderr)
        return _state["lib"]


def available() -> bool:
    return _lib() is not None


def status() -> tuple[str | None, str | None]:
    """(library path, None) once built, or (None, what is missing)."""
    _lib()
    return _state["path"], _state["missing"]


def probe_png(path: str):
    """(width, height, channels) of a PNG, or None on failure/unavailable."""
    lib = _lib()
    if lib is None:
        return None
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.slio_probe_png(path.encode(), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(c)) != 0:
        return None
    return w.value, h.value, c.value


def load_gray_stack(paths: list[str], width: int, height: int,
                    n_threads: int = 0) -> np.ndarray | None:
    """Decode PNGs to a uint8 [F, H, W] gray stack on a thread pool
    (``n_threads`` 0: one a hardware thread); None if unavailable, if a
    file is not a .png, or if any file fails (the caller falls back to the
    Python loader)."""
    lib = _lib()
    if lib is None or not paths:
        return None
    if not all(p.lower().endswith(".png") for p in paths):
        return None
    out = np.empty((len(paths), height, width), np.uint8)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.slio_load_gray_stack(
        arr, len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        width, height, n_threads)
    return out if rc == 0 else None


def write_ply_native(path: str, points: np.ndarray, colors: np.ndarray | None = None,
                     normals: np.ndarray | None = None) -> bool:
    """Binary little-endian PLY through the native writer (its header
    carries a ``comment slio native writer`` line). Returns False if
    unavailable or the write failed."""
    lib = _lib()
    if lib is None:
        return False
    pts = np.ascontiguousarray(points, np.float32)
    rgb_ptr = nrm_ptr = None
    if colors is not None:
        rgb = np.ascontiguousarray(colors, np.uint8)
        rgb_ptr = rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if normals is not None:
        nrm = np.ascontiguousarray(normals, np.float32)
        nrm_ptr = nrm.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc = lib.slio_write_ply(path.encode(), len(pts),
                            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            rgb_ptr, nrm_ptr)
    return rc == 0


def write_stl_native(path: str, vertices: np.ndarray, faces: np.ndarray) -> bool:
    """Binary STL through the native writer (face normals from the
    winding, in float32). Returns False if unavailable or the write
    failed."""
    lib = _lib()
    if lib is None:
        return False
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    rc = lib.slio_write_stl(path.encode(), len(f),
                            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return rc == 0
