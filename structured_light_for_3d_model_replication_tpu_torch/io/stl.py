"""Binary STL mesh IO — the print-ready output format.

The port's copy of the JAX package's ``io/stl.py``: 80-byte header, uint32
count, 50-byte records, normals computed from the winding when not
supplied. The same header and record layout, so both packages write the
same bytes for the same arrays (the JAX package's native writer for large
meshes is not ported; numpy writes every size).
"""
from __future__ import annotations

import numpy as np

from structured_light_for_3d_model_replication_tpu_torch.io.atomic import (
    atomic_write,
)

__all__ = ["face_normals", "write_stl", "read_stl"]

_HEADER = b"structured_light_for_3d_model_replication_tpu".ljust(80, b"\0")
_RECORD = np.dtype([("normal", "<f4", 3), ("v0", "<f4", 3), ("v1", "<f4", 3),
                    ("v2", "<f4", 3), ("attr", "<u2")])


def face_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = np.cross(b - a, c - a)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.where(norm > 0, norm, 1)).astype(np.float32)


def write_stl(path: str, vertices: np.ndarray, faces: np.ndarray,
              normals: np.ndarray | None = None) -> None:
    """Write a binary STL: vertices [N, 3] float, faces [M, 3] int.
    Crash-safe (tmp + fsync + rename)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    m = faces.shape[0]
    if normals is None:
        normals = face_normals(vertices, faces)
    rec = np.zeros(m, _RECORD)
    rec["normal"] = np.asarray(normals, np.float32)
    rec["v0"] = vertices[faces[:, 0]]
    rec["v1"] = vertices[faces[:, 1]]
    rec["v2"] = vertices[faces[:, 2]]
    with atomic_write(path) as tmp, open(tmp, "wb") as f:
        f.write(_HEADER)
        f.write(np.uint32(m).tobytes())
        rec.tofile(f)


def read_stl(path: str):
    """Read a binary STL -> (vertices [3M, 3] f32, faces [M, 3] i32,
    normals [M, 3] f32). Vertices are not deduplicated."""
    with open(path, "rb") as f:
        f.seek(80)
        m = int(np.frombuffer(f.read(4), "<u4")[0])
        rec = np.frombuffer(f.read(m * 50), _RECORD, count=m)
    verts = np.stack([rec["v0"], rec["v1"], rec["v2"]], axis=1).reshape(-1, 3)
    faces = np.arange(3 * m, dtype=np.int32).reshape(-1, 3)
    return verts.copy(), faces, rec["normal"].copy()
