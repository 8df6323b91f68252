"""PLY point-cloud and mesh IO, vectorized.

The writers emit the binary little-endian layout the JAX package writes:
``x y z`` float, optional ``nx ny nz`` float and ``red green blue`` uchar,
and for meshes a ``vertex_indices`` list of three ints a face. The reader
takes vertex PLYs, also ASCII (the reference's artifacts). Colors are RGB.
"""
from __future__ import annotations

import numpy as np

from structured_light_for_3d_model_replication_tpu_torch.io.atomic import (
    atomic_write,
)

__all__ = ["write_ply", "read_ply", "write_mesh_ply"]

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
              normals: np.ndarray | None = None) -> None:
    """Write a binary point cloud: points [N,3] float, colors [N,3] uint8
    RGB, normals [N,3] float. Crash-safe (tmp + fsync + rename)."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    has_c = colors is not None
    has_n = normals is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_n:
        header += ["property float nx", "property float ny", "property float nz"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")

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


def write_mesh_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write a binary triangle mesh: vertices [N, 3] float, faces [M, 3]
    int. Crash-safe (tmp + fsync + rename)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    n, m = vertices.shape[0], faces.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z",
              f"element face {m}", "property list uchar int vertex_indices",
              "end_header"]
    rec = np.empty(n, _vertex_dtype(False, False))
    rec["x"], rec["y"], rec["z"] = vertices[:, 0], vertices[:, 1], vertices[:, 2]
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
