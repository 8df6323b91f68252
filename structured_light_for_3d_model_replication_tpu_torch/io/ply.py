"""PLY point-cloud and mesh IO, vectorized.

The writers emit the layouts the JAX package writes: binary little-endian
by default, ``x y z`` float, optional ``nx ny nz`` float and ``red green
blue`` uchar, and for meshes a ``vertex_indices`` list of three ints a face;
``write_ply(binary=False)`` the reference's ASCII layout (``%.4f``
coordinates). The reader takes both. Colors are RGB. A binary cloud of
100,000 points or more goes through the native writer (``io/native.py``)
where it is built, as in the JAX package: the same records, and a
``comment slio native writer`` line in the header.

``WritebackQueue`` takes PLY writes off a producer's critical path: one
writer thread, submission order kept, a future per write that re-raises;
``drain`` waits for every write under one shared deadline and raises every
failure together as one ``PlyWriteError``.
"""
from __future__ import annotations

import numpy as np

from structured_light_for_3d_model_replication_tpu_torch.io import native
from structured_light_for_3d_model_replication_tpu_torch.io.atomic import (
    atomic_write,
    commit,
    discard,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import deadline as dl
from structured_light_for_3d_model_replication_tpu_torch.utils import faults

__all__ = ["write_ply", "read_ply", "write_mesh_ply", "WritebackQueue", "PlyWriteError"]

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "ushort": "<u2", "uint16": "<u2", "short": "<i2", "int16": "<i2",
    "uint": "<u4", "uint32": "<u4", "int": "<i4", "int32": "<i4",
}


def _vertex_dtype(has_colors: bool, has_normals: bool) -> np.dtype:
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if has_normals:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if has_colors:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    return np.dtype(fields)


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None,
              normals: np.ndarray | None = None, binary: bool = True) -> None:
    """Write a point cloud: points [N,3] float, colors [N,3] uint8 RGB,
    normals [N,3] float; binary little-endian by default. ``binary=False``
    writes the reference's ASCII layout, ``%.4f`` coordinates (lossy: for
    a final export only). Crash-safe (tmp + fsync + rename); the
    ``ply.write`` fault site fires first."""
    faults.fire("ply.write", item=path)
    points = np.asarray(points, np.float32)
    if binary and points.shape[0] >= 100_000:
        tmp = path + ".tmp"
        try:
            if native.write_ply_native(tmp, points, colors, normals):
                commit(tmp, path)
                return
        finally:
            discard(tmp)
    _write_ply_py(path, points, colors, normals, binary)


def _write_ply_py(path: str, points: np.ndarray, colors, normals, binary: bool) -> None:
    """The Python writer of ``write_ply`` (every size without the native
    library)."""
    n = points.shape[0]
    has_c = colors is not None
    has_n = normals is not None
    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_n:
        header += ["property float nx", "property float ny", "property float nz"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")

    if not binary:
        cols: list[np.ndarray] = [points.astype(np.float64)]
        fmt = "%.4f %.4f %.4f"
        if has_n:
            cols.append(np.asarray(normals, np.float64))
            fmt += " %.6f %.6f %.6f"
        if has_c:
            cols.append(np.asarray(colors, np.float64))
            fmt += " %d %d %d"
        body = np.concatenate(cols, axis=1)
        lines = [fmt % tuple(row) for row in body]
        with atomic_write(path) as tmp, open(tmp, "w") as f:
            f.write("\n".join(header) + "\n")
            f.write("\n".join(lines))
            if lines:
                f.write("\n")
        return
    rec = np.empty(n, _vertex_dtype(has_c, has_n))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if has_n:
        nrm = np.asarray(normals, np.float32)
        rec["nx"], rec["ny"], rec["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    if has_c:
        col = np.asarray(colors, np.uint8)
        rec["red"], rec["green"], rec["blue"] = col[:, 0], col[:, 1], col[:, 2]
    with atomic_write(path) as tmp, open(tmp, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)


class PlyWriteError(RuntimeError):
    """Every write failure of one ``WritebackQueue.drain``, raised together,
    so a later failure is never hidden behind the first: ``errors`` holds
    (path, exception) pairs in submission order."""

    def __init__(self, errors: list[tuple[str, Exception]]):
        self.errors = errors
        detail = "; ".join(f"{p}: {type(e).__name__}: {e}" for p, e in errors)
        super().__init__(f"{len(errors)} PLY write(s) failed: {detail}")


class WritebackQueue:
    """Background PLY writes: one writer thread, so writes land on disk in
    submission order (a crash leaves a clean prefix). ``submit`` returns a
    Future that resolves to the path or re-raises the write's error; the
    bytes are those of a direct ``write_ply`` call.

    ``retry``: a ``faults.RetryPolicy`` under which transient write errors
    retry in the writer thread, each retry reported to ``on_retry(path, n,
    exc)``; ``on_write(path, elapsed_s)`` runs after each successful write.
    """

    def __init__(self, on_write=None, retry=None, on_retry=None):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sl3d-plywrite")
        self._pending: list[tuple[str, object]] = []
        self._on_write = on_write
        self._retry = retry
        self._on_retry = on_retry

    def submit(self, path: str, points: np.ndarray, colors: np.ndarray | None = None,
               normals: np.ndarray | None = None, binary: bool = True):
        """Queue one cloud write; returns a Future resolving to ``path``."""

        def write() -> str:
            import time

            dl.beat("write")   # work started: the stall watchdog's heartbeat
            t0 = time.perf_counter()
            if self._retry is not None:
                faults.retry_call(
                    lambda: write_ply(path, points, colors, normals, binary=binary),
                    self._retry,
                    on_retry=lambda n, e: (self._on_retry(path, n, e)
                                           if self._on_retry else None))
            else:
                write_ply(path, points, colors, normals, binary=binary)
            if self._on_write is not None:
                self._on_write(path, time.perf_counter() - t0)
            return path

        fut = self._pool.submit(write)
        self._pending.append((path, fut))
        return fut

    @property
    def backlog(self) -> int:
        """Writes submitted and not yet finished (the queue-depth gauge)."""
        return sum(1 for _, f in self._pending if not f.done())

    def drain(self, timeout_s: float | None = None) -> list[str]:
        """Wait for every submitted write; returns the paths written. Every
        write error is raised together as one :class:`PlyWriteError`.

        ``timeout_s`` bounds the whole drain (one monotonic deadline shared
        by every write): a write still pending when it runs out joins the
        same ``PlyWriteError`` as a :class:`~.utils.deadline.DeadlineExceeded`
        for its path. None waits without bound."""
        out: list[str] = []
        errors: list[tuple[str, Exception]] = []
        deadline = dl.Deadline.after(timeout_s, "writeback drain")
        for path, f in self._pending:
            try:
                # a spent budget means expired, never unbounded
                rem = deadline.remaining() if deadline is not None else None
                if rem is None:
                    f.exception()   # waits without raising; result() below
                    settled = True
                elif rem <= 0:
                    settled = f.done()
                else:
                    settled = dl.wait_settled(f, rem)
                if settled:
                    out.append(f.result())
                else:
                    errors.append((path, dl.DeadlineExceeded(
                        f"write still pending after the {timeout_s:g}s drain budget "
                        f"(stalled writer thread?)")))
            except Exception as e:
                errors.append((path, e))
        self._pending.clear()
        if errors:
            raise PlyWriteError(errors)
        return out

    def close(self, wait: bool = True, timeout_s: float | None = None) -> None:
        """Shut the writer down. With ``wait`` and ``timeout_s`` the pending
        writes share one deadline; past it the queued tail is cancelled and
        a wedged in-flight write is abandoned."""
        if wait and timeout_s is not None and timeout_s > 0:
            deadline = dl.Deadline.after(timeout_s, "writeback close")
            settled = True
            for _, f in self._pending:
                rem = deadline.remaining()
                if rem <= 0 or not dl.wait_settled(f, rem):
                    settled = False
                    break
            self._pool.shutdown(wait=settled, cancel_futures=not settled)
            return
        self._pool.shutdown(wait=wait, cancel_futures=not wait)

    def __enter__(self) -> "WritebackQueue":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(wait=exc_type is None)


def write_mesh_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
                   colors: np.ndarray | None = None,
                   normals: np.ndarray | None = None) -> None:
    """Write a binary triangle mesh: vertices [N, 3] float, faces [M, 3]
    int, optional per-vertex normals [N, 3] float and colors [N, 3] uint8
    RGB. Crash-safe (tmp + fsync + rename); fires ``ply.write``."""
    faults.fire("ply.write", item=path)
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    has_c = colors is not None
    has_n = normals is not None
    n, m = vertices.shape[0], faces.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_n:
        header += ["property float nx", "property float ny", "property float nz"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {m}", "property list uchar int vertex_indices", "end_header"]
    rec = np.empty(n, _vertex_dtype(has_c, has_n))
    rec["x"], rec["y"], rec["z"] = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    if has_n:
        nrm = np.asarray(normals, np.float32)
        rec["nx"], rec["ny"], rec["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    if has_c:
        col = np.asarray(colors, np.uint8)
        rec["red"], rec["green"], rec["blue"] = col[:, 0], col[:, 1], col[:, 2]
    frec = np.empty(m, np.dtype([("k", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")]))
    frec["k"] = 3
    frec["a"], frec["b"], frec["c"] = faces[:, 0], faces[:, 1], faces[:, 2]
    with atomic_write(path) as tmp, open(tmp, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)
        frec.tofile(f)


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read a vertex PLY (binary little-endian or ascii) -> dict with
    'points' [N,3] f32 and, when present, 'colors' [N,3] u8 and 'normals'."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated PLY header")
            header_lines.append(line.decode("ascii", "replace").strip())
            if header_lines[-1] == "end_header":
                break
        body = f.read()
    fmt = None
    count = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for ln in header_lines:
        parts = ln.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError(f"{path}: list properties on vertices")
            props.append((parts[2], parts[1]))
    if fmt is None:
        raise ValueError(f"{path}: no format line in PLY header")
    names = [p[0] for p in props]
    if fmt == "ascii":
        rows = [r.split() for r in body.decode("ascii", "replace").split("\n")
                if r.strip()][:count]
        arr = np.array([[float(v) for v in r] for r in rows],
                       np.float64).reshape(count, len(props))
    else:
        dt = np.dtype([(p[0], _PLY_DTYPES[p[1]]) for p in props])
        if len(body) < dt.itemsize * count:
            raise ValueError(
                f"{path}: truncated PLY body — {len(body)} bytes for {count} "
                f"vertices ({dt.itemsize * count} expected)")
        rec = np.frombuffer(body, dt, count=count)
        arr = np.stack([rec[nm].astype(np.float64) for nm in names], axis=1) \
            if count else np.zeros((0, len(names)))
    idx = {nm: i for i, nm in enumerate(names)}
    out: dict[str, np.ndarray] = {}
    if all(k in idx for k in ("x", "y", "z")):
        out["points"] = arr[:, [idx["x"], idx["y"], idx["z"]]].astype(np.float32)
    if all(k in idx for k in ("red", "green", "blue")):
        out["colors"] = arr[:, [idx["red"], idx["green"], idx["blue"]]].astype(np.uint8)
    if all(k in idx for k in ("nx", "ny", "nz")):
        out["normals"] = arr[:, [idx["nx"], idx["ny"], idx["nz"]]].astype(np.float32)
    return out
