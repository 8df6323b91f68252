"""Nearest-neighbour primitives of the merge path.

The port's counterpart of the JAX package's ``ops/knn.py``, cut to what the
merge reads:

  sq_dist           squared distances by coordinate differences
  knn               exact k nearest valid neighbours, blocked ``torch.topk``
                    over difference distances, at any N (feature prep,
                    normals, the cluster step's k-NN graph)
  radius_count      valid neighbours within a radius, the ``radius_count``
                    kernel at any N (the clean chain's cluster and radius
                    steps)
  kdtree_build,     scipy ``cKDTree`` on the host: the exact complement of
  kdtree_distances_rows  the outlier pass's uncertified rows

Every selection here and in the kernels runs on difference distances, so
the JAX package's recompute of the |q|^2+|b|^2-2q.b selection
(``exact_d2``) has no counterpart. Invalid rows are parked at ``FAR`` so
they never appear as neighbours of a valid row, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["FAR", "sq_dist", "knn", "radius_count", "kdtree_build",
           "kdtree_distances_rows"]

FAR = 1e9  # coordinate of invalid/padded points: far from everything
_BLOCK = 1 << 22  # elements of one [queries, base] distance block
_BLOCK_CUDA = 1 << 26  # on the card: fewer, larger launches, the same result


def _parked(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[:, None], points.to(torch.float32),
                       torch.tensor(FAR, dtype=torch.float32, device=points.device))


def sq_dist(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances ((dx*dx + dy*dy) + dz*dz), each step rounded, the
    kernels' order; broadcast over the leading axes of q [..., 3], c [..., 3]."""
    d = q - c
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def knn(points: torch.Tensor, valid: torch.Tensor, k: int,
        exclude_self: bool = True):
    """k nearest valid neighbours of every point: (idx i32 [N, k], d2 f32
    [N, k]) ascending, exact at every size (the JAX package's ``"topk"``
    selector). Query blocks against the whole cloud, ``torch.topk`` per
    block: the distance block is [block, N], never [N, N]. Rows of invalid
    points hold arbitrary (masked) results; fewer than k other rows leave
    +inf slots."""
    n = points.shape[0]
    pts = _parked(points, valid)
    kk = min(k, n)
    block = max(1, (_BLOCK_CUDA if pts.is_cuda else _BLOCK) // max(n, 1))
    cols = torch.arange(n, device=points.device)
    idx_out, d2_out = [], []
    for s in range(0, n, block):
        d2 = sq_dist(pts[s:s + block, None, :], pts[None, :, :])
        if exclude_self:
            rows = torch.arange(s, s + d2.shape[0], device=points.device)
            d2 = d2.masked_fill(rows[:, None] == cols[None, :], float("inf"))
        v, j = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
        idx_out.append(j.to(torch.int32))
        d2_out.append(v)
    idx = torch.cat(idx_out) if idx_out else torch.zeros((0, kk), dtype=torch.int32)
    d2 = torch.cat(d2_out) if d2_out else torch.zeros((0, kk))
    if kk < k:  # fewer rows than k: pad with empty slots
        idx = torch.cat([idx, idx.new_zeros((n, k - kk))], 1)
        d2 = torch.cat([d2, d2.new_full((n, k - kk), float("inf"))], 1)
    return idx, d2


def radius_count(points: torch.Tensor, valid: torch.Tensor, radius: float,
                 exclude_self: bool = True) -> torch.Tensor:
    """Number of valid points within ``radius`` of each point, i32 [N]
    (the JAX package's ``knn.radius_count``): d2 <= float32(radius)^2 by
    coordinate differences. Invalid rows are parked at ``FAR``, so they are
    nobody's neighbour; their own counts are meaningless. One
    ``kernels.radius_count`` launch on the card at every N, its plain
    version on the CPU. ``exclude_self=False`` counts the point itself."""
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

    counts = kernels.radius_count(_parked(points, valid).contiguous(), float(radius))
    return counts if exclude_self else counts + 1


# ---------------------------------------------------------------------------
# scipy cKDTree on the host
# ---------------------------------------------------------------------------

def kdtree_build(points: np.ndarray, valid: np.ndarray):
    """(cKDTree over the valid rows, their global indices)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float32)
    vi = np.flatnonzero(np.asarray(valid))
    return (cKDTree(pts[vi]) if len(vi) else None), vi


def kdtree_distances_rows(points: np.ndarray, valid: np.ndarray,
                          rows: np.ndarray, k: int, tree_vi=None) -> np.ndarray:
    """Euclidean distances [len(rows), k] from the given rows to their k
    nearest OTHER valid points: self dropped by global index, duplicates
    kept at 0, rows with fewer than k real neighbours repeat their last
    real distance, rows with none carry inf (the JAX package's knn_np
    semantics)."""
    rows = np.asarray(rows)
    pts = np.asarray(points, np.float32)
    tree, vi = tree_vi if tree_vi is not None else kdtree_build(points, valid)
    if tree is None:
        return np.full((len(rows), k), np.inf, np.float32)
    kk = min(k + 1, len(vi))
    d, j = tree.query(pts[rows], k=kk, workers=-1)
    d = np.asarray(d).reshape(len(rows), kk)
    j = np.asarray(j).reshape(len(rows), kk)
    dd = np.where(vi[j] == rows[:, None], np.inf, d)
    order = np.argsort(dd, axis=1, kind="stable")[:, :k]
    out = np.full((len(rows), k), np.inf, np.float32)
    out[:, :order.shape[1]] = np.take_along_axis(dd, order, axis=1)
    fin = np.isfinite(out).sum(axis=1)
    last = out[np.arange(out.shape[0]), np.maximum(fin - 1, 0)]
    fill = (np.arange(k)[None, :] >= fin[:, None]) & (fin > 0)[:, None]
    return np.where(fill, last[:, None], out)
