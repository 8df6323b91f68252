"""Grid-hash spatial index: the host engine for large clouds (the JAX
package's ``ops/grid.py``).

  1. quantize points to cells of size h; hash cell (ix, iy, iz) into a
     power-of-2 table (open addressing by oversizing: H >= 2N);
  2. one stable sort by hash groups each bucket's points; ranks within the
     group place every point in a fixed [H, M] slot table (M = the largest
     cell occupancy, at most ``occ_cap``);
  3. a query gathers the (2 rings + 1)^3 neighbouring cells' slots, in
     groups of at most _GROUP_WIDTH candidates, and scores them with
     difference distances.

Radius counts are exact when rings * cell >= radius. The k-NN is exact
wherever the k-th neighbour lies within ``rings`` cell rings; beyond, it
overestimates distances (never underestimates). Hash collisions merge
buckets: queries see a superset of candidates, which the distance test
sorts out.

The query entry points are host-only, as in the JAX package, whose bucket
gathers crashed the TPU runtime at merge-cloud shapes: ``grid_knn``,
``grid_radius_count`` and ``grid_query_knn`` raise a RuntimeError for a
grid on any device but the CPU. ``knn.knn`` and ``knn.radius_count`` reach
them for CPU tensors above ``knn._BRUTE_MAX`` rows; the card takes the
binned selection and the ``radius_count`` kernel instead. ``grid_query_knn``
is not wired into ICP: the port's ICP keeps its direction-aware stopping
rule on every device.

Ties follow the JAX package: ``jnp.argsort`` is stable (``torch.sort(...,
stable=True)`` here), and ``lax.top_k`` keeps the first of equal values
(a top-k over (d2 bits, position) keys here).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.ops.knn import _parked

__all__ = ["HashGrid", "build_grid", "max_occupancy", "grid_radius_count", "grid_knn",
           "grid_query_knn"]

_P1, _P2, _P3 = 73856093, 19349663, 83492791
_CHUNK = 8192        # query rows a chunk
_GROUP_WIDTH = 2048  # candidates a query scores a step


class HashGrid(NamedTuple):
    table: torch.Tensor    # int32 [H, M] point index a slot, -1 = empty
    cell_of: torch.Tensor  # int32 [N] hash bucket of each point
    ijk: torch.Tensor      # int32 [N, 3] integer cell coordinates (0 for invalid rows)
    origin: torch.Tensor   # f32 [3]
    cell: torch.Tensor     # f32 scalar cell size
    points: torch.Tensor   # f32 [N, 3] (invalid parked at knn.FAR)
    valid: torch.Tensor    # bool [N]


def _require_host(op: str, device: torch.device) -> None:
    if device.type != "cpu":
        raise RuntimeError(
            f"{op} is host-only: the JAX package's bucket gathers crashed the TPU "
            f"runtime at merge-cloud shapes, and the port keeps its gate. On "
            f"'{device.type}' use ops.knn.knn / knn_dense_approx (the knn_binmin "
            f"kernel), the radius_count kernel or the nn1 kernel instead.")


def _hash_ijk(ijk: torch.Tensor, h_size: int) -> torch.Tensor:
    """(i * P1) ^ (j * P2) ^ (k * P3) in int32 arithmetic (wrapping as
    XLA's does), masked to the table size."""
    p = torch.tensor([_P1, _P2, _P3], dtype=torch.int32, device=ijk.device)
    h = ijk * p
    return (h[..., 0] ^ h[..., 1] ^ h[..., 2]) & (h_size - 1)


def _cells(pts: torch.Tensor, valid: torch.Tensor, cell: torch.Tensor):
    """(origin [3], ijk i32 [N, 3]): the valid rows' least corner and each
    row's cell; invalid rows (parked far away, past the int32 range of a
    cell index) get cell 0 and stay out of every hash."""
    inf = torch.tensor(float("inf"), device=pts.device)
    origin = torch.where(valid[:, None], pts, inf).amin(0)
    origin = torch.where(torch.isfinite(origin), origin, torch.zeros_like(origin))
    f = torch.floor((pts - origin) / cell)
    ijk = torch.where(valid[:, None], f, torch.zeros_like(f)).to(torch.int32)
    return origin, ijk


def _ranks(h_sorted: torch.Tensor) -> torch.Tensor:
    """Rank of each sorted entry within its run of equal values."""
    n = h_sorted.shape[0]
    newrun = torch.ones(n, dtype=torch.bool, device=h_sorted.device)
    newrun[1:] = h_sorted[1:] != h_sorted[:-1]
    ar = torch.arange(n, device=h_sorted.device)
    return ar - torch.cummax(torch.where(newrun, ar, torch.zeros_like(ar)), 0).values


def max_occupancy(points: torch.Tensor, valid: torch.Tensor, cell: float) -> int:
    """Largest number of valid points sharing one hash bucket of a 2^22
    table at this cell size."""
    if points.shape[0] == 0:
        return 0
    pts = _parked(points, valid)
    _, ijk = _cells(pts, valid, torch.tensor(cell, dtype=torch.float32))
    h = torch.where(valid, _hash_ijk(ijk, 1 << 22), torch.full_like(ijk[:, 0], -1))
    h_s = torch.sort(h).values
    return int(torch.where(h_s >= 0, _ranks(h_s), torch.full_like(h_s, -1, dtype=torch.int64))
               .max()) + 1


def build_grid(points: torch.Tensor, valid: torch.Tensor, cell_size: float,
               max_occ: int | None = None, occ_cap: int = 128) -> HashGrid:
    """Size the table (H = the power of 2 >= max(2N, 1024)) and the slots,
    then build. If a cell would hold more than ``occ_cap`` points, the cell
    is halved until it does not (up to 8 times): bounded densification
    instead of dropped neighbours."""
    n = points.shape[0]
    h_size = 1 << max(10, int(np.ceil(np.log2(max(2 * n, 1024)))))
    cell = float(cell_size)
    if max_occ is None:
        for _ in range(8):
            m = max_occupancy(points, valid, float(np.float32(cell)))
            if m <= occ_cap:
                break
            cell *= 0.5
        max_occ = max(1, min(m, occ_cap))
    return _build(points, valid, float(np.float32(cell)), h_size, int(max_occ))


def _build(points, valid, cell: float, h_size: int, max_occ: int) -> HashGrid:
    n = points.shape[0]
    dev = points.device
    pts = _parked(points, valid)
    cell_t = torch.tensor(cell, dtype=torch.float32, device=dev)
    origin, ijk = _cells(pts, valid, cell_t)
    h = torch.where(valid, _hash_ijk(ijk, h_size),
                    torch.full((n,), h_size - 1, dtype=torch.int32, device=dev))
    h_s, order = torch.sort(h, stable=True)
    rank = _ranks(h_s)
    keep = rank < max_occ        # the JAX package drops the rest (mode="drop")
    table = torch.full((h_size * max_occ,), -1, dtype=torch.int32, device=dev)
    table[(h_s.long() * max_occ + rank)[keep]] = order[keep].to(torch.int32)
    return HashGrid(table.view(h_size, max_occ), h, ijk, origin, cell_t, pts, valid)


def _neighbor_buckets(grid: HashGrid, ijk_q: torch.Tensor, rings: int) -> torch.Tensor:
    """[Q, (2 rings + 1)^3] bucket ids a query cell, sorted, duplicates -1."""
    r = range(-rings, rings + 1)
    offs = torch.tensor([(dx, dy, dz) for dx in r for dy in r for dz in r],
                        dtype=torch.int32, device=ijk_q.device)
    h = torch.sort(_hash_ijk(ijk_q[:, None, :] + offs[None], grid.table.shape[0]), 1).values
    dup = torch.zeros_like(h, dtype=torch.bool)
    dup[:, 1:] = h[:, 1:] == h[:, :-1]
    return torch.where(dup, torch.full_like(h, -1), h)


def _bucket_groups(buckets: torch.Tensor, m: int) -> list[torch.Tensor]:
    """[Q, B] buckets -> groups [Q, Bg] of Bg * m <= _GROUP_WIDTH candidates."""
    q, b = buckets.shape
    bg = max(1, _GROUP_WIDTH // max(m, 1))
    g = -(-b // bg)
    if g * bg > b:
        buckets = torch.cat([buckets, buckets.new_full((q, g * bg - b), -1)], 1)
    return list(buckets.view(q, g, bg).unbind(1))


def _scored(grid: HashGrid) -> torch.Tensor:
    """[N + 1, 3]: the grid's points with invalid rows, and a last row that
    empty slots point at, at +inf, so their distances come out +inf."""
    inf = torch.tensor(float("inf"), device=grid.points.device)
    return torch.cat([torch.where(grid.valid[:, None], grid.points, inf), inf.expand(1, 3)])


def _candidates(grid: HashGrid, scored: torch.Tensor, q_pts: torch.Tensor,
                buckets: torch.Tensor):
    """(cand i32 [Q, Bg * M] point indices, -1 = none; d2 f32 [Q, Bg * M],
    +inf for empty slots and invalid points). ``scored``: _scored(grid)."""
    q, m = buckets.shape[0], grid.table.shape[1]
    tab = grid.table.index_select(0, buckets.clamp_min(0).view(-1)).view(q, -1, m)
    cand = torch.where(buckets[..., None] >= 0, tab, -1).view(q, -1)
    n = scored.shape[0] - 1
    c = scored.index_select(0, torch.where(cand < 0, n, cand).view(-1)).view(q, -1, 3)
    d = c - q_pts[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return cand, d2


def _top_k_first(best_d, best_i, d2, cand, k: int):
    """The k smallest of [best | new] a row, the first position on ties
    (``lax.top_k``'s rule): a top-k over (d2 bits, position) keys."""
    cat_d = torch.cat([best_d, d2], 1)
    cat_i = torch.cat([best_i, cand], 1)
    pos = torch.arange(cat_d.shape[1], device=cat_d.device)
    key = (cat_d.view(torch.int32).to(torch.int64) << 32) | pos
    sel = torch.topk(key, k, dim=1, largest=False, sorted=True).values & 0xFFFFFFFF
    return torch.gather(cat_d, 1, sel), torch.gather(cat_i, 1, sel)


def grid_radius_count(grid: HashGrid, radius: float, exclude_self: bool = True,
                      rings: int = 1, chunk: int | None = None) -> torch.Tensor:
    """Exact per-point count of valid neighbours within ``radius``, i32 [N].
    Requires rings * grid.cell >= radius (the sphere fits the searched
    block). Host-only."""
    _require_host("grid_radius_count", grid.points.device)
    n = grid.points.shape[0]
    m = grid.table.shape[1]
    r = torch.tensor(radius, dtype=torch.float32)
    r2 = r * r
    scored = _scored(grid)
    out = []
    for s in range(0, n, chunk or _CHUNK):
        qi = torch.arange(s, min(n, s + (chunk or _CHUNK)), dtype=torch.int32)
        q_pts = grid.points[qi]
        acc = torch.zeros(qi.shape[0], dtype=torch.int32)
        for bucket_g in _bucket_groups(_neighbor_buckets(grid, grid.ijk[qi], rings), m):
            cand, d2 = _candidates(grid, scored, q_pts, bucket_g)
            within = d2 <= r2
            if exclude_self:
                within &= cand != qi[:, None]
            acc += within.sum(1, dtype=torch.int32)
        out.append(acc)
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32)


def _knn_rows(grid: HashGrid, scored, q_pts, ijk_q, k: int, rings: int, self_idx=None):
    m = grid.table.shape[1]
    q = q_pts.shape[0]
    best_d = torch.full((q, k), float("inf"), dtype=torch.float32)
    best_i = torch.full((q, k), -1, dtype=torch.int32)
    for bucket_g in _bucket_groups(_neighbor_buckets(grid, ijk_q, rings), m):
        cand, d2 = _candidates(grid, scored, q_pts, bucket_g)
        if self_idx is not None:
            d2 = torch.where(cand == self_idx[:, None], torch.full_like(d2, float("inf")), d2)
        best_d, best_i = _top_k_first(best_d, best_i, d2, cand, k)
    return best_i.clamp_min(0), best_d


def grid_knn(grid: HashGrid, k: int, exclude_self: bool = True, rings: int = 1,
             chunk: int | None = None):
    """k nearest neighbours from the (2 rings + 1)^3-cell candidate set of
    every grid point: (idx i32 [N, k], d2 f32 [N, k]) ascending; missing
    slots hold index 0 (or a repeat) at +inf. Exact when the k-th
    neighbour lies within ``rings`` cell rings. Host-only."""
    _require_host("grid_knn", grid.points.device)
    n = grid.points.shape[0]
    scored = _scored(grid)
    idx, d2 = [], []
    for s in range(0, n, chunk or _CHUNK):
        qi = torch.arange(s, min(n, s + (chunk or _CHUNK)), dtype=torch.int32)
        i, d = _knn_rows(grid, scored, grid.points[qi], grid.ijk[qi], k, rings,
                         qi if exclude_self else None)
        idx.append(i)
        d2.append(d)
    if not idx:
        return torch.zeros((0, k), dtype=torch.int32), torch.zeros((0, k))
    return torch.cat(idx), torch.cat(d2)


def grid_query_knn(grid: HashGrid, q_pts: torch.Tensor, k: int, rings: int = 1,
                   chunk: int | None = None):
    """k nearest grid points of EXTERNAL queries q_pts [Q, 3] (cross-cloud
    queries: correspondences, chamfer distance), with grid_knn's exactness
    contract. Queries farther than rings * cell from every grid point get
    +inf slots. Host-only."""
    _require_host("grid_query_knn", grid.points.device)
    q_pts = q_pts.to(torch.float32)
    nq = q_pts.shape[0]
    scored = _scored(grid)
    idx, d2 = [], []
    for s in range(0, nq, chunk or _CHUNK):
        q = q_pts[s:s + (chunk or _CHUNK)]
        # cell indices of far queries saturate into the int32 range
        f = torch.floor((q - grid.origin) / grid.cell).clamp(-2.0 ** 31, 2.0 ** 31 - 128)
        i, d = _knn_rows(grid, scored, q, f.to(torch.int32), k, rings)
        idx.append(i)
        d2.append(d)
    if not idx:
        return torch.zeros((0, k), dtype=torch.int32), torch.zeros((0, k))
    return torch.cat(idx), torch.cat(d2)
