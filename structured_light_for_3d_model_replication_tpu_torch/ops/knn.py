"""Nearest-neighbour primitives: the JAX package's ``ops/knn.py``.

  sq_dist           squared distances by coordinate differences
  knn               k nearest valid neighbours, by the JAX package's engine
                    for the device and the size (below)
  knn_dense_approx  the large-N card engine: the binned selection at
                    ``recall_target``
  radius_count      valid neighbours within a radius: the ``radius_count``
                    kernel on the card at every N, its plain version on the
                    CPU up to _BRUTE_MAX rows, the host grid above
  kdtree_build,     scipy ``cKDTree`` on the host: the exact complement of
  kdtree_distances_rows  the outlier pass's uncertified rows
  knn_np,           the same on numpy arrays (cKDTree), the numpy backend's
  radius_count_np   clean chain (``pointcloud.clean_chain_np``); self
                    excluded unless ``exclude_self=False``
  pad_points        numpy rows padded to a multiple with FAR, invalid rows

``knn`` takes the JAX package's engine (its ``ops/knn.py:91-142``):

  N <= _BRUTE_MAX or exact=True, selector "topk"
                    exact blocked ``torch.topk`` over (difference distance,
                    index) keys, on either device;
  the same with selector "approx:<recall>"
                    the binned selection at that recall: the ``knn_binmin``
                    kernel on the card, its plain version on the CPU;
  N > _BRUTE_MAX, not exact
                    on the card ``knn_dense_approx`` (the binned selection
                    at ``recall_target``); on the CPU the grid hash
                    (``ops/grid.py``), its cell sized from the mean density
                    and searched 2 rings deep.

The binned selection (``_knn_binned``) is XLA's ApproxTopK done by hand:
``kernels.knn_binmin`` gives each row's nearest column in each of M strided
bins (bin b: columns b, b + M, ...), then a top-k over the M winners keyed
by (d2 bits, index) gives k neighbours ascending, lowest index first on
ties. M comes from the ApproxTopK recall model (``kernels.binmin_bins``),
so a row's recall is the model's over its whole column set in one pass; a
miss swaps in a farther neighbour, so the k-th distance is never below the
exact one. A row's result depends on its own distances and M alone, not on
the chunk that computed it or on parked padding rows.

Every selection here and in the kernels runs on difference distances, so
the JAX package's recompute of the |q|^2+|b|^2-2q.b selection
(``exact_d2``) has no counterpart. Invalid rows are parked at ``FAR`` so
they never appear as neighbours of a valid row, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["FAR", "pad_points", "sq_dist", "knn", "knn_dense_approx", "radius_count",
           "kdtree_build", "kdtree_distances_rows", "knn_np", "radius_count_np"]

FAR = 1e9  # coordinate of invalid/padded points: far from everything
_BLOCK = 1 << 22  # elements of one [queries, base] distance block
_BLOCK_CUDA = 1 << 26  # on the card: fewer, larger launches, the same result
_BRUTE_MAX = 65536  # above this many rows knn and radius_count leave the brute engines
_BINNED = 1 << 22       # [rows, M] bin winners a binned chunk on the CPU
_BINNED_CUDA = 1 << 26  # and on the card


def _parked(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[:, None], points.to(torch.float32),
                       torch.tensor(FAR, dtype=torch.float32, device=points.device))


def pad_points(points: np.ndarray, valid: np.ndarray | None, multiple: int):
    """Pad [N, 3] points (and their mask) to a multiple of ``multiple`` with
    rows at FAR, invalid. Returns (points_p, valid_p, n_orig)."""
    n = points.shape[0]
    n_pad = (-n) % multiple
    if valid is None:
        valid = np.ones(n, bool)
    if n_pad:
        points = np.concatenate([points, np.full((n_pad, 3), FAR, points.dtype)], axis=0)
        valid = np.concatenate([valid, np.zeros(n_pad, bool)])
    return points, valid, n


def sq_dist(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances ((dx*dx + dy*dy) + dz*dz), each step rounded, the
    kernels' order; broadcast over the leading axes of q [..., 3], c [..., 3].
    One coordinate at a time, in place: no [..., 3] difference temporary."""
    d2 = q[..., 0] - c[..., 0]
    d2.mul_(d2)
    t = q[..., 1] - c[..., 1]
    d2.add_(t.mul_(t))
    t = q[..., 2] - c[..., 2]
    return d2.add_(t.mul_(t))


def _sq_dist_block(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sq_dist(q[:, None], c[None]) as [len(q), len(c)], one coordinate at a
    time: the same rounded steps without the [.., 3] difference temporary."""
    d2 = q[:, 0:1] - c[None, :, 0]
    d2.mul_(d2)
    t = q[:, 1:2] - c[None, :, 1]
    d2.add_(t.mul_(t))
    torch.sub(q[:, 2:3], c[None, :, 2], out=t)
    return d2.add_(t.mul_(t))


def _keys(d2: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys (d2 bits << 32) | column: d2 is >= 0 or +inf, so its bit
    pattern orders as the float does, and the column breaks exact ties
    towards the lowest index."""
    return (d2.view(torch.int32).to(torch.int64) << 32) | cols


def _smallest_keys(d2: torch.Tensor, kk: int):
    """(The kk smallest (d2, column) keys of every row of d2 [rows, N],
    ascending; the rows where they may be the wrong columns). ``torch.topk``
    on the floats takes the kk + 1 smallest values, which are exact, and the
    kk columns kept are sorted by key. Only where the (kk + 1)-th value
    equals the kk-th does a tie cross the cut, and the columns kept of that
    tie may not be its lowest."""
    v, j = torch.topk(d2, min(kk + 1, d2.shape[1]), dim=1, largest=False, sorted=True)
    key = torch.sort(_keys(v[:, :kk], j[:, :kk]), dim=1).values
    if v.shape[1] == kk:
        return key, torch.zeros(d2.shape[0], dtype=torch.bool, device=d2.device)
    return key, v[:, kk] == v[:, kk - 1]


def knn(points: torch.Tensor, valid: torch.Tensor, k: int, exclude_self: bool = True,
        exact: bool = False, recall_target: float = 0.99, selector: str = "topk"):
    """k nearest valid neighbours of every point: (idx i32 [N, k], d2 f32
    [N, k]) ascending. Rows of invalid points hold arbitrary (masked)
    results; fewer than k other rows leave +inf slots.

    The engine follows the JAX package's dispatch by device and size (see
    the module notes): up to _BRUTE_MAX rows, or with ``exact``, the brute
    engine with ``selector`` "topk" (exact) or "approx:<recall>" (the
    binned selection at that per-row recall, re-sorted ascending); above,
    ``knn_dense_approx`` at ``recall_target`` on the card and the 2-ring
    grid hash on the CPU, which is exact wherever the k-th neighbour lies
    within 2 cell rings and otherwise overestimates distances (never
    underestimates)."""
    engine = _knn_engine(points.device, points.shape[0], exact, selector)
    if engine == "exact":
        return _knn_exact(points, valid, k, exclude_self)
    if engine == "binned":
        return _knn_binned(points, valid, k, exclude_self, _selector_recall(selector))
    if engine == "dense_approx":
        return knn_dense_approx(points, valid, k, exclude_self, recall_target)
    from structured_light_for_3d_model_replication_tpu_torch.ops import grid as gridlib

    pts = points.to(torch.float32)
    inf = torch.tensor(float("inf"), device=pts.device)
    lo = torch.where(valid[:, None], pts, inf).amin(0)
    hi = torch.where(valid[:, None], pts, -inf).amax(0)
    ext = (hi - lo).numpy().astype(np.float64)
    nv = max(int(valid.sum()), 1)
    vol = float(np.prod(np.maximum(ext, 1e-6)))
    # the cell from the mean density, searched 2 rings deep: covers the
    # k-neighbourhood even where local density runs well below the mean
    cell = 1.2 * (vol * max(k, 8) / nv) ** (1.0 / 3.0)
    return gridlib.grid_knn(gridlib.build_grid(pts, valid, cell), k, exclude_self, rings=2)


def _knn_engine(device: torch.device, n: int, exact: bool, selector: str) -> str:
    """knn's engine for a tensor on ``device`` with n rows: "exact",
    "binned", "dense_approx" (the card above _BRUTE_MAX) or "grid" (the CPU
    above _BRUTE_MAX)."""
    if n <= _BRUTE_MAX or exact:
        return "exact" if selector == "topk" else "binned"
    return "grid" if device.type == "cpu" else "dense_approx"


def _radius_engine(device: torch.device, n: int) -> str:
    """radius_count's engine: the "kernel" (its plain version on the CPU),
    or the "grid" for a CPU tensor above _BRUTE_MAX rows."""
    return "grid" if device.type == "cpu" and n > _BRUTE_MAX else "kernel"


def _selector_recall(selector: str) -> float:
    kind, _, recall = selector.partition(":")
    if kind != "approx" or not recall:
        raise ValueError(f"unknown selector {selector!r} (topk | approx:<recall>)")
    return float(recall)


def _knn_exact(points: torch.Tensor, valid: torch.Tensor, k: int, exclude_self: bool):
    """The exact brute engine (the JAX package's "topk" selector). Query
    blocks against the whole cloud, ``torch.topk`` per block: the distance
    block is [block, N], never [N, N]. Neighbours are ordered by (d2,
    index): on exact ties the lowest index comes first, the order of
    ``lax.top_k`` in the JAX package and of the ``nn1`` kernel. Valid rows
    where a tie crosses the k-th place take a top-k over all their (d2,
    index) keys, after one host sync for the whole call."""
    n = points.shape[0]
    pts = _parked(points, valid)
    kk = min(k, n)
    block = max(1, (_BLOCK_CUDA if pts.is_cuda else _BLOCK) // max(n, 1))
    cols = torch.arange(n, device=points.device)

    def distances(rows: torch.Tensor) -> torch.Tensor:
        d2 = _sq_dist_block(pts[rows], pts)
        if exclude_self:
            d2.masked_fill_(rows[:, None] == cols[None, :], float("inf"))
        return d2

    keys, redo = [], []
    for s in range(0, n, block):
        key, cross = _smallest_keys(distances(cols[s:s + block]), kk)
        keys.append(key)
        redo.append(cross & valid[s:s + block])
    if keys:
        key = torch.cat(keys)
        rows = torch.cat(redo).nonzero()[:, 0]
        for s in range(0, rows.shape[0], block):
            r = rows[s:s + block]
            key[r] = torch.topk(_keys(distances(r), cols), kk, dim=1, largest=False,
                                sorted=True).values
    else:
        key = torch.zeros((0, kk), dtype=torch.int64, device=points.device)
    return _unkey(key, k, n)


def _unkey(key: torch.Tensor, k: int, n: int):
    """(d2 bits << 32 | index) keys [N, kk] -> (idx i32 [N, k], d2 f32
    [N, k]), slots past kk empty (index 0, +inf)."""
    idx = (key & 0xFFFFFFFF).to(torch.int32)
    d2 = (key >> 32).to(torch.int32).view(torch.float32)
    kk = key.shape[1]
    if kk < k:  # fewer rows than k: pad with empty slots
        idx = torch.cat([idx, idx.new_zeros((n, k - kk))], 1)
        d2 = torch.cat([d2, d2.new_full((n, k - kk), float("inf"))], 1)
    return idx, d2


def _knn_binned(points: torch.Tensor, valid: torch.Tensor, k: int, exclude_self: bool,
                recall: float):
    """The binned selection at per-row ``recall`` (module notes): row chunks
    of [chunk, M] bin winners from ``kernels.knn_binmin``, then the k
    smallest (d2 bits, index) keys of each row, ascending. Misses only
    swap in a farther neighbour (the k-th distance never drops below the
    exact one). With M = N (``recall`` 1.0, or N at most the model's M)
    every column is its own bin and the exact engine computes the same
    selection."""
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

    n = points.shape[0]
    if n == 0:
        return (torch.zeros((0, k), dtype=torch.int32, device=points.device),
                torch.zeros((0, k), dtype=torch.float32, device=points.device))
    m = kernels.binmin_bins(n, k, recall)
    if m == n:   # every column its own bin: the exact engine's selection
        return _knn_exact(points, valid, k, exclude_self)
    pts = _parked(points, valid).contiguous()
    kk = min(k, m)
    chunk = max(1, (_BINNED_CUDA if pts.is_cuda else _BINNED) // m)
    rows = torch.arange(n, dtype=torch.int32, device=pts.device)
    terms = kernels.binmin_screen_terms(pts) if pts.is_cuda else None  # one cloud, every chunk
    keys = []
    for s in range(0, n, chunk):
        d2, idx = kernels.knn_binmin(pts, rows[s:s + chunk], m, exclude_self, terms)
        keys.append(torch.topk(_keys(d2, idx.to(torch.int64)), kk, dim=1, largest=False,
                               sorted=True).values)
    return _unkey(torch.cat(keys), k, n)


def knn_dense_approx(points: torch.Tensor, valid: torch.Tensor, k: int,
                     exclude_self: bool = True, recall_target: float = 0.99):
    """Large-N k-NN for the card (the JAX package's ``knn_dense_approx``):
    every row against the whole cloud, selected by the binned selection at
    ``recall_target`` per row (``_knn_binned``; the JAX package's
    ``lax.approx_min_k``). Distances are exact difference distances; only
    the selection is approximate, and a miss only overestimates the k-th
    neighbour. No padding: a row's result does not depend on its chunk."""
    return _knn_binned(points, valid, k, exclude_self, recall_target)


def radius_count(points: torch.Tensor, valid: torch.Tensor, radius: float,
                 exclude_self: bool = True) -> torch.Tensor:
    """Number of valid points within ``radius`` of each point, i32 [N]
    (the JAX package's ``knn.radius_count``): d2 <= float32(radius)^2 by
    coordinate differences. Invalid rows are parked at ``FAR``, so they are
    nobody's neighbour; their own counts are meaningless. One
    ``kernels.radius_count`` launch on the card at every N, its plain
    version on the CPU up to _BRUTE_MAX rows; above, a CPU tensor takes the
    grid hash with cell = radius, the cell halved and the rings doubled
    while a cell holds more than 128 points (exact either way: rings * cell
    >= radius). ``exclude_self=False`` counts the point itself."""
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

    if _radius_engine(points.device, points.shape[0]) == "grid":
        from structured_light_for_3d_model_replication_tpu_torch.ops import grid as gridlib

        pts = points.to(torch.float32)
        cell, rings = float(radius), 1
        for _ in range(4):
            occ = gridlib.max_occupancy(pts, valid, cell)
            if occ <= 128 or rings >= 8:
                break
            cell *= 0.5
            rings *= 2
        grid = gridlib.build_grid(pts, valid, cell, max_occ=min(occ, 128))
        return gridlib.grid_radius_count(grid, radius, exclude_self, rings=rings)
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


def knn_np(points: np.ndarray, valid: np.ndarray | None, k: int,
           exclude_self: bool = True):
    """(indices i32 [N, k], squared distances f32 [N, k]) of each row's k
    nearest valid rows by cKDTree (the JAX package's ``knn_np``); with
    ``exclude_self`` a row is not its own neighbour. With fewer than k
    candidates a row repeats its last neighbour, with none it keeps index 0
    at inf."""
    from scipy.spatial import cKDTree

    n = points.shape[0]
    if valid is None:
        valid = np.ones(n, bool)
    vi = np.where(valid)[0]
    if len(vi) == 0:
        return np.zeros((n, k), np.int32), np.full((n, k), np.inf, np.float32)
    kk = min(k + 1 if exclude_self else k, len(vi))
    d, j = cKDTree(points[vi]).query(points, k=kk, workers=-1)
    d = np.asarray(d).reshape(n, kk)
    j = np.asarray(j).reshape(n, kk)
    if exclude_self and kk == k + 1:
        # d is sorted: inf the (at most one) self entry, take the k smallest
        cand = vi[j]
        dd = np.where(cand == np.arange(n)[:, None], np.inf, d)
        order = np.argsort(dd, axis=1, kind="stable")[:, :k]
        rows = np.arange(n)[:, None]
        return (cand[rows, order].astype(np.int32),
                dd[rows, order].astype(np.float32) ** 2)
    if not exclude_self and kk == k:
        return vi[j].astype(np.int32), d.astype(np.float32) ** 2
    idx = np.zeros((n, k), np.int32)
    d2 = np.full((n, k), np.inf, np.float32)
    for row in range(n):
        cand, dd = vi[j[row]], d[row]
        if exclude_self:
            keep = cand != row
            cand, dd = cand[keep], dd[keep]
        cand, dd = cand[:k], dd[:k]
        idx[row, :len(cand)] = cand
        d2[row, :len(dd)] = dd.astype(np.float32) ** 2
        if 0 < len(cand) < k:
            idx[row, len(cand):] = cand[-1]
            d2[row, len(dd):] = d2[row, len(dd) - 1]
    return idx, d2


def radius_count_np(points: np.ndarray, valid: np.ndarray | None, radius: float,
                    exclude_self: bool = True) -> np.ndarray:
    """Number of valid rows within ``radius`` of each row, i32 [N], by
    cKDTree (the JAX package's ``radius_count_np``); with ``exclude_self``
    a valid row does not count itself."""
    from scipy.spatial import cKDTree

    n = points.shape[0]
    if valid is None:
        valid = np.ones(n, bool)
    vi = np.where(valid)[0]
    if len(vi) == 0:
        return np.zeros(n, np.int32)
    counts = np.asarray(cKDTree(points[vi]).query_ball_point(points, radius,
                                                              return_length=True), np.int32)
    if exclude_self:
        counts = counts - valid.astype(np.int32)
    return counts
