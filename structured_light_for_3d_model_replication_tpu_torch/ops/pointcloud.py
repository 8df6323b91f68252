"""Point-cloud ops of the merge path and the clean chain: voxel downsample,
the statistical and radius outlier masks, background plane removal, density
clustering, and the masked clean chain (the JAX package's
``ops/pointcloud.py``).

``clean_chain`` runs the tab-3 chain (background plane -> largest cluster ->
radius outlier -> statistical outlier) as masked steps over one padded
cloud: each step narrows a validity mask, nothing is compacted until the
caller takes the survivors. ``radius_count`` (the cluster step's core test
and the radius step) is a CUDA kernel on the card at every size.

``statistical_outlier_mask`` follows Open3D's statistics exactly: mean
distance to the k nearest neighbours, keep rows within mu + std_ratio *
sigma. It routes as the JAX package does. A CPU tensor above DENSE_MAX rows
takes the cKDTree twin (``statistical_outlier_mask_np``, the JAX package's
host arm). ``approximate=True`` without a cell hint sends a card tensor
above DENSE_MAX rows through ``knn.knn`` at recall 0.99 (above
``knn._BRUTE_MAX`` rows the binned selection). Everything else takes
``_voxelized_knn_mean_dist``:

  dense   clouds of <= 32768 rows: every row against every row, the
          ``knn_mean`` kernel;
  bisect  larger clouds: sorted along the widest axis, each 64-row tile
          against one 2*8192-row window, the ``slab_mean_knn`` kernel; a
          row is certified when its k-th neighbour lies within r = 4 * cell
          and its window covers [x - r, x + r].

Rows the engine leaves uncertified (+inf: cloud boundary, true outliers,
fewer than k neighbours) get their exact value from a host cKDTree. Without
a cell hint, a cloud above 32768 rows takes its cell from the median
nearest-neighbour spacing (``_estimate_spacing``), as the JAX package's
accelerator arm does.

``_voxelized_knn_mean_dist`` also keeps the JAX package's jnp top-k slab
engine (``_slab_topk_engine``: each ``tile`` of sorted queries against one
``window`` of sorted candidates, in plain torch) with its selectors topk,
tournament, iter, approx1 and the diagnostic nosel. A caller reaches it with
an explicit ``tile``/``window`` under the "auto" selector, or by naming one
of those selectors.

``clean_chain_np`` is the numpy backend's chain: the same masked steps on
the host over numpy arrays (cKDTree neighbours, a region-growing DBSCAN,
RANSAC draws from ``np.random.default_rng(0)``), step for step the JAX
package's ``clean_chain_np``, except that a degenerate plane hypothesis
scores 0 there as it does on the device (ROADMAP C2).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib

__all__ = ["voxel_downsample", "voxel_downsample_np", "statistical_outlier_mask",
           "DENSE_MAX", "radius_outlier_mask", "segment_plane", "cluster_labels",
           "largest_cluster_mask", "CLEAN_STEPS", "chain_params", "clean_chain",
           "statistical_outlier_mask_np", "radius_outlier_mask_np", "segment_plane_np",
           "cluster_labels_np", "largest_cluster_mask_np", "clean_chain_np"]

DENSE_MAX = 32768     # the dense engine's largest cloud
_SLAB_FAR = 3e9
_SLAB_TILE, _SLAB_WBLK = 64, 8192
_TOPK_TILE, _TOPK_WINDOW = 1024, 8192   # the top-k slab engine's defaults
_TOPK_SELECTORS = ("topk", "tournament", "iter", "approx1", "nosel")


# ---------------------------------------------------------------------------
# Statistical outlier removal
# ---------------------------------------------------------------------------

def _stat_outlier_from_knn(mean_d: torch.Tensor, valid: torch.Tensor,
                           std_ratio: float) -> torch.Tensor:
    """Keep-mask from per-row mean distances; non-finite rows are outliers
    and stay out of mu and sigma."""
    ok = valid & torch.isfinite(mean_d)
    n_valid = torch.clamp_min(ok.sum(), 1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=mean_d.device)
    mu = torch.where(ok, mean_d, zero).sum() / n_valid
    var = torch.where(ok, (mean_d - mu) ** 2, zero).sum() / n_valid
    thresh = mu + np.float32(std_ratio) * torch.sqrt(var)
    return ok & (mean_d <= thresh)


def statistical_outlier_mask(points: torch.Tensor, valid: torch.Tensor,
                             nb_neighbors: int = 20, std_ratio: float = 2.0,
                             voxelized_cell: float | None = None,
                             approximate: bool = False) -> torch.Tensor:
    """Keep-mask [N] for statistical outlier removal (Open3D semantics).
    ``voxelized_cell``: the voxel size when ``points`` just came out of
    voxel_downsample(cell); it sets the slab engine's certification radius.
    ``approximate``: on the card without a cell, above DENSE_MAX rows, the
    neighbours come from ``knn.knn`` at recall 0.99 (a miss only
    overestimates a row's mean).
    A CPU tensor above DENSE_MAX rows takes the cKDTree twin, whatever the
    options (the JAX package's host arm)."""
    n = points.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=points.device)
    engine = _stat_engine(points.device, n, approximate, voxelized_cell)
    if engine == "host_twin":
        return torch.from_numpy(statistical_outlier_mask_np(
            points.detach().to(torch.float32).numpy(), valid.numpy(), nb_neighbors,
            std_ratio))
    if engine == "knn":
        _, d2 = knnlib.knn(points, valid, nb_neighbors, recall_target=0.99)
        mean_d = kernels.sqrt_f32(torch.clamp_min(d2, 0.0)).mean(1)
        return _stat_outlier_from_knn(mean_d, valid, std_ratio)
    return _engine_mask(points, valid, nb_neighbors, std_ratio, voxelized_cell)


def _stat_engine(device: torch.device, n: int, approximate: bool,
                 cell: float | None) -> str:
    """statistical_outlier_mask's engine (the JAX package's routing):
    "host_twin" for a CPU tensor above DENSE_MAX rows; "knn" for
    ``approximate`` without a cell on the card above DENSE_MAX rows; else
    "engine" (dense or bisect, and the host complement)."""
    if device.type == "cpu":
        return "host_twin" if n > DENSE_MAX else "engine"
    return "knn" if approximate and cell is None and n > DENSE_MAX else "engine"


def _engine_mask(points: torch.Tensor, valid: torch.Tensor, nb_neighbors: int,
                 std_ratio: float, voxelized_cell: float | None) -> torch.Tensor:
    """The mask from ``_voxelized_knn_mean_dist`` (dense or bisect) and the
    host complement of its uncertified rows: the card's arm, on any device."""
    n = points.shape[0]
    cell = voxelized_cell
    if cell is None:
        # 4 * (0.75 * spacing) = 3x the spacing covers the 20th neighbour of
        # surface and volume clouds alike; the dense engine ignores the cell
        cell = 0.75 * _estimate_spacing(points, valid) if n > DENSE_MAX else 1.0
    md = _voxelized_knn_mean_dist(points, valid, cell, nb_neighbors)
    md = _complement(md, points, valid, nb_neighbors, valid & ~torch.isfinite(md))
    return _stat_outlier_from_knn(md, valid, std_ratio)


def _estimate_spacing(points: torch.Tensor, valid: torch.Tensor) -> float:
    """Median nearest-neighbour distance from a subsample: 2048 probe rows
    against a <= 32768-row stride of the cloud, self excluded by index. A
    missed true neighbour only overestimates a row's spacing; the slab
    engine stays exact at any cell, the estimate only sets how many rows it
    certifies."""
    idx = torch.nonzero(valid).flatten()
    n = idx.shape[0]
    if n < 2:
        return 1.0
    qi = idx[::max(1, n // 2048)][:2048]
    bi = idx[::max(1, n // 32768)][:32768]
    q, b = points[qi].to(torch.float32), points[bi].to(torch.float32)
    step = max(1, knnlib._BLOCK // bi.shape[0])
    d2 = []
    for s in range(0, qi.shape[0], step):
        d = knnlib.sq_dist(q[s:s + step, None, :], b[None, :, :])
        d = d.masked_fill(qi[s:s + step, None] == bi[None, :], float("inf"))
        d2.append(d.min(dim=1).values)
    med = float(np.median(kernels.sqrt_f32(torch.cat(d2)).cpu().numpy()))
    return max(med, 1e-6)


def _complement(md: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                k: int, bad: torch.Tensor) -> torch.Tensor:
    """Patch the ``bad`` rows of md with their exact mean k-NN distance from
    a host cKDTree (knn_np semantics, incl. its fill for sparse rows)."""
    bad_idx = torch.nonzero(bad).flatten().cpu().numpy()
    if len(bad_idx) == 0:
        return md
    pts_np = points.detach().to("cpu", torch.float32).numpy()
    val_np = valid.detach().cpu().numpy()
    dsel = knnlib.kdtree_distances_rows(pts_np, val_np, bad_idx, k)
    vals = torch.from_numpy(dsel.mean(axis=1).astype(np.float32)).to(md.device)
    md = md.clone()
    md[torch.from_numpy(bad_idx).to(md.device)] = vals
    return md


def _masked_extent(points: torch.Tensor, valid: torch.Tensor):
    """(lo, hi) [3] over the valid rows; 0 where there are none."""
    inf = torch.tensor(float("inf"), dtype=points.dtype, device=points.device)
    lo = torch.where(valid[:, None], points, inf).amin(0)
    hi = torch.where(valid[:, None], points, -inf).amax(0)
    zero = torch.zeros((), dtype=points.dtype, device=points.device)
    return (torch.where(torch.isfinite(lo), lo, zero),
            torch.where(torch.isfinite(hi), hi, zero))


def _voxelized_knn_mean_dist(points: torch.Tensor, valid: torch.Tensor,
                             cell: float, k: int, tile: int | None = None,
                             window: int | None = None,
                             selector: str = "auto") -> torch.Tensor:
    """Mean distance to the k nearest neighbours, +inf on rows the engine
    cannot certify. ``selector``: "dense", "bisect", one of the top-k slab
    engine's (_TOPK_SELECTORS), or "auto": with no ``tile``/``window``,
    dense up to DENSE_MAX rows, else bisect at tile 64, window 8192; with
    either given, the top-k slab engine (those are its geometry)."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    if selector == "auto":
        if tile is None and window is None:
            selector = "dense" if n <= DENSE_MAX else "bisect"
        else:
            selector = "topk"
    if selector == "dense":
        parked = torch.where(valid[:, None], pts,
                             torch.tensor(knnlib.FAR, dtype=torch.float32,
                                          device=pts.device)).contiguous()
        md, cnt = kernels.knn_mean(parked, int(k))
        cnt = torch.where(valid, cnt, torch.zeros_like(cnt))
        return torch.where(valid & (cnt >= k), md,
                           torch.tensor(float("inf"), device=pts.device))
    if selector in _TOPK_SELECTORS:
        return _slab_topk_engine(pts, valid, cell, k, tile or _TOPK_TILE,
                                 window or _TOPK_WINDOW, selector)
    if selector != "bisect":
        raise ValueError(f"unknown selector {selector!r} "
                         f"(auto|dense|bisect|{'|'.join(_TOPK_SELECTORS)})")
    tile, wblk = tile or _SLAB_TILE, window or _SLAB_WBLK
    pts_s, order, r = _slab_inputs(pts, valid, cell, wblk)
    md, cnt, win_end = kernels.slab_mean_knn(pts_s, r, k, tile=tile, wblk=wblk)
    return _slab_certify(pts_s, order, md, cnt, win_end, r, k)


def _slab_topk_engine(pts: torch.Tensor, valid: torch.Tensor, cell: float, k: int,
                      tile: int, window: int, selector: str) -> torch.Tensor:
    """The JAX package's jnp top-k slab engine (``_slab_knn_mean_dist_jit``)
    in plain torch: the widest axis first, rows sorted by it (invalid rows
    at _SLAB_FAR), padded to L = max(tile multiple, window); tile t's
    queries against the ``window`` sorted candidates from the searchsorted
    start of its first x minus r (r = f32(4 * cell)), clipped to [0, L -
    window). Self excluded by sorted index. A row is certified when its k
    selected distances are <= r^2, the window reaches x + r (the left edge
    holds by construction) and it is real; others get +inf.

    Selection runs on difference distances (the JAX package selects on the
    |q|^2+|b|^2-2q.b expansion and recomputes, so near-ties may pick other
    columns there), by (d2, column) keys: "topk" a top-k; "tournament"
    (window % 128 == 0, k <= 128; else topk) the k best of each 128-column
    group, then the k best of those; "iter" k passes of min-extraction;
    "approx1" the binned selection at recall 1.0 (each column its own bin:
    exact). All four give the same columns. "nosel" is a DIAGNOSTIC ONLY:
    it skips selection and takes the window's first k columns, WRONG by
    construction, to isolate the selector's share of the engine's cost."""
    dev = pts.device
    lo, hi = _masked_extent(pts, valid)
    ax = int(torch.argmax(torch.nan_to_num(hi - lo)))
    pts = pts[:, [ax, (ax + 1) % 3, (ax + 2) % 3]]
    n = pts.shape[0]
    L = max(-(-n // tile) * tile, window)
    r = torch.tensor(4.0 * float(cell), dtype=torch.float32, device=dev)
    far = torch.tensor(_SLAB_FAR, dtype=torch.float32, device=dev)
    x = torch.where(valid, pts[:, 0], torch.tensor(float("inf"), device=dev))
    order = torch.sort(x, stable=True).indices
    pts_s = torch.where(valid[order][:, None], pts[order], far)
    if L > n:
        pts_s = torch.cat([pts_s, far.expand(L - n, 3)])
    x_s = pts_s[:, 0].contiguous()
    n_tiles = L // tile
    first_x = x_s[torch.arange(n_tiles, device=dev) * tile]
    starts = torch.clamp(torch.searchsorted(x_s, first_x - r), 0, L - window).tolist()
    rows = torch.arange(tile, device=dev)
    cols = torch.arange(window, device=dev)
    md_s = torch.empty(L, dtype=torch.float32, device=dev)
    for t, start in enumerate(starts):
        q = pts_s[t * tile:(t + 1) * tile]
        cand = pts_s[start:start + window]
        if selector == "nosel":
            jidx = cols[:k].expand(tile, k)
        else:
            d2 = knnlib._sq_dist_block(q, cand)
            d2.masked_fill_((t * tile + rows)[:, None] == (start + cols)[None, :],
                            float("inf"))
            key = knnlib._keys(d2, cols)
            jidx = _slab_select(key, k, selector, window) & 0xFFFFFFFF
        kd2 = knnlib.sq_dist(q[:, None, :], cand[jidx])
        md = kernels.sqrt_f32(kd2).mean(1)
        qx = q[:, 0]
        right_ok = (start + window >= L) | (x_s[start + window - 1] >= qx + r)
        cert = (kd2.amax(1) <= r * r) & right_ok & (qx < far)
        md_s[t * tile:(t + 1) * tile] = torch.where(cert, md, torch.full_like(md, float("inf")))
    out = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    out[order] = md_s[:n]
    return out


def _slab_select(key: torch.Tensor, k: int, selector: str, window: int) -> torch.Tensor:
    """The k smallest (d2 bits << 32 | column) keys of each row of [tile,
    window], ascending, by the named selector's method."""
    if selector == "iter":
        key = key.clone()
        out = []
        for _ in range(k):
            i = torch.argmin(key, 1, keepdim=True)
            out.append(torch.gather(key, 1, i))
            key.scatter_(1, i, torch.iinfo(torch.int64).max)
        return torch.cat(out, 1)
    if selector == "approx1":
        d2 = (key >> 32).to(torch.int32).view(torch.float32)
        d, j = kernels.bin_minima(d2, kernels.binmin_bins(window, k, 1.0))
        key = knnlib._keys(d, j.to(torch.int64))
    if selector == "tournament" and window % 128 == 0 and k <= 128:
        g = torch.topk(key.view(key.shape[0], window // 128, 128), k, dim=2, largest=False,
                       sorted=True).values
        key = g.reshape(key.shape[0], -1)
    return torch.topk(key, k, dim=1, largest=False, sorted=True).values


def _slab_inputs(points: torch.Tensor, valid: torch.Tensor, cell: float, wblk: int):
    """The slab kernel's input: the widest axis first, rows sorted by it,
    invalid rows parked at the far sentinel, padded to a wblk multiple (at
    least two blocks). Returns (pts_sorted [L, 3], order [n], r)."""
    lo, hi = _masked_extent(points, valid)
    ax = int(torch.argmax(torch.nan_to_num(hi - lo)))
    points = points[:, [ax, (ax + 1) % 3, (ax + 2) % 3]]
    # r on a coarse log grid (~9 % steps), as the JAX engine bakes it in;
    # any r is correct, certification covers the choice
    r = 4.0 * float(cell)
    r = float(np.float32(2.0 ** (round(np.log2(max(r, 1e-9)) * 8) / 8.0)))
    n = points.shape[0]
    L = max(-(-n // wblk) * wblk, 2 * wblk)
    far = torch.tensor(_SLAB_FAR, dtype=torch.float32, device=points.device)
    x = torch.where(valid, points[:, 0], torch.tensor(float("inf"), device=points.device))
    order = torch.sort(x, stable=True).indices
    pts_s = torch.where(valid[order][:, None], points[order], far)
    if L > n:
        pts_s = torch.cat([pts_s, far.expand(L - n, 3)])
    return pts_s.contiguous(), order, r


def _slab_certify(pts_s, order, md, cnt, win_end, r: float, k: int) -> torch.Tensor:
    """Keep rows whose k-th neighbour lies within r and whose window reaches
    x + r (the left edge holds by construction); +inf elsewhere; scatter
    back to the unsorted order."""
    L = pts_s.shape[0]
    n = order.shape[0]
    inf = torch.tensor(float("inf"), device=pts_s.device)
    far = torch.tensor(_SLAB_FAR, dtype=torch.float32, device=pts_s.device)
    x_s = pts_s[:, 0]
    r32 = torch.tensor(r, dtype=torch.float32, device=pts_s.device)
    last = torch.clamp(win_end, max=L).long() - 1
    right_ok = (win_end >= L) | (x_s[last] >= x_s + r32)
    cert = (cnt >= k) & right_ok & (x_s < far)
    md = torch.where(cert, md, inf)
    out = torch.full((n,), float("inf"), device=pts_s.device)
    out[order] = md[:n]
    return out


# ---------------------------------------------------------------------------
# Voxel downsample
# ---------------------------------------------------------------------------

def voxel_downsample(points: torch.Tensor, colors: torch.Tensor,
                     valid: torch.Tensor, voxel_size: float,
                     origin: torch.Tensor | None = None):
    """Average points (and colors) per voxel. Fixed shape: returns
    (points [N, 3] f32, colors [N, 3] u8, valid [N]), one slot a surviving
    voxel in ascending (i, j, k) cell order; survivors fill a slot prefix.
    ``origin`` [3]: the grid's corner (default: the valid points' minimum),
    so that pieces of one cloud voxelize on one grid.

    Grids under 2^10 cells per axis group on one packed int32 key (the JAX
    package's packed arm), larger ones on an int64 key of three 21-bit
    fields (its lexsort arm: same order, no collisions). Segment sums run
    over the sorted order as float64 prefix sums, so the result does not
    depend on the device's atomic order."""
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=points.device)
    lo, hi = _masked_extent(points, valid)
    if origin is not None:
        lo = origin = origin.to(points.device, torch.float32)
    packed = bool(torch.all(torch.floor((hi - lo) / vs) < 1023))
    n = points.shape[0]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=points.device)
    if origin is None:
        origin = torch.where(valid[:, None], points, inf).amin(0)
    ijk = torch.floor((points - origin) / vs)
    if packed:
        ijk = torch.clamp(ijk, 0, 1023).to(torch.int32)
        key = (ijk[:, 0] << 20) | (ijk[:, 1] << 10) | ijk[:, 2]
        key = torch.where(valid, key, torch.tensor(1 << 30, dtype=torch.int32,
                                                   device=points.device))
    else:
        ijk = torch.clamp(ijk, 0, 2 ** 20 - 1).to(torch.int64)
        key = (ijk[:, 0] << 42) | (ijk[:, 1] << 21) | ijk[:, 2]
        key = torch.where(valid, key, torch.tensor(1 << 62, dtype=torch.int64,
                                                   device=points.device))
    k_s, order = torch.sort(key, stable=True)
    newgrp = torch.ones(n, dtype=torch.bool, device=points.device)
    newgrp[1:] = k_s[1:] != k_s[:-1]
    v_s = valid[order]
    # [7, N] rows (count, xyz, rgb): the prefix sums run along the inner axis
    vals = torch.cat([v_s[None].to(torch.float64),
                      torch.where(v_s[:, None], points[order], 0.0).T.to(torch.float64),
                      torch.where(v_s[:, None], colors[order].to(torch.float32),
                                  0.0).T.to(torch.float64)])
    csum = torch.cumsum(vals, 1)
    # segment s spans sorted slots [start_s, end_s]; its sum is a prefix difference
    ends = torch.nonzero(torch.cat([newgrp[1:], newgrp.new_ones(1)])).flatten()
    tot = csum[:, ends]
    tot[:, 1:] = tot[:, 1:] - csum[:, ends[:-1]]
    m = ends.shape[0]
    cnt = tot[0].to(torch.float32)
    out_p = torch.zeros((n, 3), dtype=torch.float32, device=points.device)
    out_c = torch.zeros((n, 3), dtype=torch.uint8, device=points.device)
    out_v = torch.zeros(n, dtype=torch.bool, device=points.device)
    out_p[:m] = (tot[1:4] / torch.clamp_min(tot[0], 1.0)).T.to(torch.float32)
    # color sums are integers, exact in f32: divide in f32 as the JAX package does
    out_c[:m] = (tot[4:7].to(torch.float32) / torch.clamp_min(cnt, 1.0)).T.to(torch.uint8)
    out_v[:m] = cnt > 0
    return out_p, out_c, out_v


# ---------------------------------------------------------------------------
# Radius outlier removal
# ---------------------------------------------------------------------------

def radius_outlier_mask(points: torch.Tensor, valid: torch.Tensor,
                        radius: float = 5.0, nb_points: int = 100) -> torch.Tensor:
    """Keep points with >= nb_points valid neighbours within radius."""
    return valid & (knnlib.radius_count(points, valid, radius) >= nb_points)


# ---------------------------------------------------------------------------
# Plane segmentation / background removal
# ---------------------------------------------------------------------------

def _plane_samples(valid: torch.Tensor, trials: int) -> torch.Tensor:
    """[trials, 3] row indices drawn with replacement, weighted by
    ``valid`` (padded and invalid rows never drawn), from a CPU generator
    seeded with 0: the same draws on every device."""
    w = valid.detach().to("cpu", torch.float32)
    if not bool(w.any()):
        return torch.zeros((trials, 3), dtype=torch.int64)
    g = torch.Generator().manual_seed(0)
    return torch.multinomial(w, trials * 3, replacement=True, generator=g).view(trials, 3)


def segment_plane(points: torch.Tensor, valid: torch.Tensor,
                  distance_threshold: float = 2.0, num_iterations: int = 512,
                  samples=None):
    """Batched-hypothesis RANSAC plane fit -> (plane [4] = (n, d), inlier
    mask [N]). ``num_iterations`` triples are drawn among the valid rows
    (``samples`` [T, 3] gives them instead); each hypothesis scores its
    valid rows within ``distance_threshold``, the first best wins; a
    degenerate triple (no plane) scores 0. The background step keeps the
    inverse of the inliers."""
    n = points.shape[0]
    if n == 0:
        return (torch.zeros(4, dtype=torch.float32, device=points.device),
                torch.zeros(0, dtype=torch.bool, device=points.device))
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        registration as reg,
    )

    reg.exact_f32_products()
    pts = points.to(torch.float32)
    tri = (_plane_samples(valid, num_iterations) if samples is None
           else torch.as_tensor(np.array(samples)))
    tri = tri.to(device=pts.device, dtype=torch.int64)
    p0, p1, p2 = (pts[tri[:, i]] for i in range(3))
    nrm = torch.linalg.cross(p1 - p0, p2 - p0)
    norm = torch.sqrt((nrm * nrm).sum(-1, keepdim=True))
    nrm = nrm / torch.clamp_min(norm, 1e-12)
    d = -(nrm * p0).sum(-1)
    dist = (torch.matmul(nrm, pts.T) + d[:, None]).abs()
    # a triple with a repeated (or collinear) point spans no plane: its zero
    # normal would put every point within the threshold and win (the JAX
    # package keeps such hypotheses, ROADMAP C)
    within = (dist <= distance_threshold) & valid[None, :] & (norm > 1e-12)
    best = torch.argmax(within.sum(1))
    return torch.cat([nrm[best], d[best][None]]), within[best]


# ---------------------------------------------------------------------------
# Density clustering -> largest cluster
# ---------------------------------------------------------------------------

def _lap(timings: dict | None, key: str, t0: float, dev: torch.device) -> float:
    """Add the wall since t0 to timings[key] (the device synchronized
    first); returns the time now. No-op without timings."""
    if timings is None:
        return t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    now = time.perf_counter()
    timings[key] = timings.get(key, 0.0) + now - t0
    return now


def cluster_labels(points: torch.Tensor, valid: torch.Tensor, eps: float = 5.0,
                   min_points: int = 200, k: int = 16, max_iters: int = 200,
                   timings: dict | None = None) -> torch.Tensor:
    """DBSCAN-style labels i32 [N] by min-label propagation on the k-NN
    graph: core points (>= min_points neighbours within eps) pass the
    minimum label across core-to-core edges shorter than eps until nothing
    changes (at most ``max_iters`` rounds, one host sync a round); border
    points take the least label among their in-eps core neighbours; the
    rest are noise (-1). The JAX package's fixed-shape formulation of
    Open3D's cluster_dbscan, label for label. ``timings``: the k-NN graph's,
    the core count's and the label rounds' walls are added to
    ``clean_cluster_{knn,core,rounds}_s`` and the round count to
    ``clean_cluster_rounds`` (the device synchronized at each)."""
    n = points.shape[0]
    dev = points.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    idx, d2 = knnlib.knn(points, valid, k)
    t0 = _lap(timings, "clean_cluster_knn_s", t0, dev)
    idx = idx.long()
    eps2 = kernels._sq_f32(eps).to(dev)
    core = valid & (knnlib.radius_count(points, valid, eps) >= min_points)
    t0 = _lap(timings, "clean_cluster_core_s", t0, dev)
    edge_ok = (d2 <= eps2) & valid[idx] & valid[:, None]
    none = torch.tensor(n, dtype=torch.int64, device=dev)
    labels = torch.where(core, torch.arange(n, device=dev), none)
    cc_edge = edge_ok & core[idx] & core[:, None]
    flat_idx = idx.reshape(-1)
    push_ok = cc_edge.reshape(-1)
    rounds = 0
    for rounds in range(1, max_iters + 1):
        pulled = torch.minimum(labels, torch.where(cc_edge, labels[idx], none).min(1).values)
        push_val = torch.where(push_ok, labels.repeat_interleave(idx.shape[1]), none)
        pushed = torch.full((n,), n, dtype=torch.int64, device=dev).scatter_reduce(
            0, flat_idx, push_val, "amin")
        new = torch.where(core, torch.minimum(pulled, pushed), none)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    neigh_core = torch.where(edge_ok & core[idx], labels[idx], none)
    border = torch.where(valid & ~core, neigh_core.min(1).values, none)
    final = torch.where(core, labels, border)
    out = torch.where(final >= n, -1, final).to(torch.int32)
    _lap(timings, "clean_cluster_rounds_s", t0, dev)
    if timings is not None:
        timings["clean_cluster_rounds"] = timings.get("clean_cluster_rounds", 0) + rounds
    return out


def largest_cluster_mask(points: torch.Tensor, valid: torch.Tensor,
                         eps: float = 5.0, min_points: int = 200,
                         k: int = 16, timings: dict | None = None) -> torch.Tensor:
    """Keep-mask of the most populated cluster (the lowest label on ties)."""
    n = points.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=points.device)
    labels = cluster_labels(points, valid, eps, min_points, k, timings=timings).long()
    sizes = torch.bincount(labels[labels >= 0], minlength=n)
    return valid & (labels == torch.argmax(sizes))


# ---------------------------------------------------------------------------
# Masked clean chain
# ---------------------------------------------------------------------------

CLEAN_STEPS = ("background", "cluster", "radius", "statistical")


def chain_params(cfg, steps=CLEAN_STEPS) -> tuple:
    """A CleanConfig and a step selection -> ((step, ((param, value), ...)),
    ...). A disabled ``background`` step (``remove_background_plane``
    false) vanishes; an unknown step raises."""
    params = []
    for step in steps:
        if step not in CLEAN_STEPS:
            raise ValueError(f"unknown clean step {step!r}; valid: {CLEAN_STEPS}")
        if step == "background":
            if not cfg.remove_background_plane:
                continue
            kw = (("dist", float(cfg.plane_ransac_dist)),
                  ("trials", int(cfg.plane_ransac_trials)))
        elif step == "cluster":
            kw = (("eps", float(cfg.cluster_eps)),
                  ("min_points", int(cfg.cluster_min_points)))
        elif step == "radius":
            kw = (("radius", float(cfg.radius)),
                  ("nb_points", int(cfg.radius_nb_points)))
        else:
            kw = (("nb", int(cfg.outlier_nb_neighbors)),
                  ("std", float(cfg.outlier_std_ratio)))
        params.append((step, kw))
    return tuple(params)


def _chain_step(points, valid, step: str, kw: dict, samples=None,
                timings: dict | None = None) -> torch.Tensor:
    """One masked step: the survivors stay where they are, the mask narrows."""
    if step == "background":
        _, inliers = segment_plane(points, valid, kw["dist"], kw["trials"],
                                   samples=samples)
        return valid & ~inliers
    if step == "cluster":
        return largest_cluster_mask(points, valid, eps=kw["eps"],
                                    min_points=kw["min_points"], timings=timings)
    if step == "radius":
        return valid & radius_outlier_mask(points, valid, kw["radius"], kw["nb_points"])
    return valid & statistical_outlier_mask(points, valid, kw["nb"], kw["std"])


def clean_chain(points: torch.Tensor, valid: torch.Tensor, cfg,
                steps=CLEAN_STEPS, samples=None, timings: dict | None = None):
    """The clean chain over a padded cloud: points [N, 3] f32, valid [N].
    Returns (masks [S, N] bool, counts [S] i32), one row per effective step
    (``chain_params``), masks[i] the keep-mask after step i. Every step runs
    even after one empties the cloud (the caller aborts at a zero count).
    ``samples``: the background step's [T, 3] draws (tests inject the JAX
    package's). ``timings``: each step's host wall is added to
    ``clean_<step>_s`` (its count read back after it, a host sync), and the
    cluster step's split (``cluster_labels``)."""
    params = chain_params(cfg, steps)
    n = points.shape[0]
    if n == 0 or not params:
        return (torch.zeros((len(params), n), dtype=torch.bool, device=points.device),
                torch.zeros(len(params), dtype=torch.int32, device=points.device))
    masks, counts = [], []
    v = valid
    for step, kw in params:
        t0 = time.perf_counter()
        v = _chain_step(points, v, step, dict(kw), samples, timings)
        masks.append(v)
        counts.append(v.sum())
        if timings is not None:
            int(counts[-1])
            key = f"clean_{step}_s"
            timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0
    return torch.stack(masks), torch.stack(counts).to(torch.int32)


# ---------------------------------------------------------------------------
# The numpy backend's chain, on the host
# ---------------------------------------------------------------------------

def voxel_downsample_np(points, colors, valid, voxel_size):
    """Host reference of ``voxel_downsample``: the mean of each occupied
    voxel (Open3D's semantics), compact: (points f32 [M, 3], colors u8
    [M, 3] or None, valid bool [M] all True), in ascending cell order."""
    if valid is None:
        valid = np.ones(points.shape[0], bool)
    pts = points[valid]
    cols = colors[valid] if colors is not None else None
    origin = pts.min(axis=0)
    # divide in f32, as the device path does: a float64 divisor could move
    # a point on a voxel boundary into the next cell
    ijk = np.floor((pts - origin) / np.float32(voxel_size)).astype(np.int64)
    _, inv, cnt = np.unique(ijk, axis=0, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    m = cnt.shape[0]
    out_p = np.zeros((m, 3), np.float64)
    np.add.at(out_p, inv, pts)
    out_p /= cnt[:, None]
    out_c = None
    if cols is not None:
        out_c = np.zeros((m, 3), np.float64)
        np.add.at(out_c, inv, cols)
        out_c = (out_c / cnt[:, None]).astype(np.uint8)
    return out_p.astype(np.float32), out_c, np.ones(m, bool)


def statistical_outlier_mask_np(points: np.ndarray, valid: np.ndarray,
                                nb_neighbors: int = 20, std_ratio: float = 2.0) -> np.ndarray:
    """``statistical_outlier_mask`` by cKDTree; float32 statistics."""
    _, d2 = knnlib.knn_np(points, valid, nb_neighbors)
    mean_d = np.sqrt(np.maximum(d2, 0)).mean(axis=1).astype(np.float32)
    ok = valid & np.isfinite(mean_d)
    n_valid = np.maximum(ok.sum(), 1)
    mu = np.where(ok, mean_d, 0.0).sum() / n_valid
    var = np.where(ok, (mean_d - mu) ** 2, 0.0).sum() / n_valid
    return ok & (mean_d <= mu + np.float32(std_ratio) * np.sqrt(var))


def radius_outlier_mask_np(points: np.ndarray, valid: np.ndarray, radius: float = 5.0,
                           nb_points: int = 100) -> np.ndarray:
    return valid & (knnlib.radius_count_np(points, valid, radius) >= nb_points)


def segment_plane_np(points: np.ndarray, valid: np.ndarray, distance_threshold: float = 2.0,
                     num_iterations: int = 512, seed: int = 0):
    """``segment_plane`` in float64 with draws from ``default_rng(seed)``
    among the valid rows; the first best hypothesis wins, a degenerate one
    scores 0 and has no inliers."""
    rng = np.random.default_rng(seed)
    pts = points.astype(np.float64)
    tri = rng.choice(np.where(valid)[0], size=(num_iterations, 3))
    p0, p1, p2 = pts[tri[:, 0]], pts[tri[:, 1]], pts[tri[:, 2]]
    nrm = np.cross(p1 - p0, p2 - p0)
    norm = np.sqrt((nrm * nrm).sum(-1, keepdims=True))
    nrm = nrm / np.maximum(norm, 1e-12)
    d = -(nrm * p0).sum(-1)
    plane_ok = norm[:, 0] > 1e-12
    best_score, best = -1, 0
    for t in range(num_iterations):
        score = int(((np.abs(pts @ nrm[t] + d[t]) <= distance_threshold) & valid).sum()) \
            if plane_ok[t] else 0
        if score > best_score:
            best_score, best = score, t
    inliers = (np.abs(pts @ nrm[best] + d[best]) <= distance_threshold) & valid & plane_ok[best]
    return np.concatenate([nrm[best], [d[best]]]).astype(np.float32), inliers


def cluster_labels_np(points: np.ndarray, valid: np.ndarray, eps: float = 5.0,
                      min_points: int = 200) -> np.ndarray:
    """Exact DBSCAN labels i64 [N] by cKDTree region growing (noise -1)."""
    from scipy.spatial import cKDTree

    n = points.shape[0]
    vi = np.where(valid)[0]
    labels = np.full(n, -1, np.int64)
    if len(vi) == 0:
        return labels
    tree = cKDTree(points[vi])
    neigh = tree.query_ball_point(points[vi], eps)
    core = np.array([len(x) - 1 for x in neigh]) >= min_points
    labels_v = np.full(len(vi), -1, np.int64)
    cur = 0
    for i in range(len(vi)):
        if labels_v[i] != -1 or not core[i]:
            continue
        stack = [i]
        labels_v[i] = cur
        while stack:
            j = stack.pop()
            if not core[j]:
                continue
            for m in neigh[j]:
                if labels_v[m] == -1:
                    labels_v[m] = cur
                    stack.append(m)
        cur += 1
    labels[vi] = labels_v
    return labels


def largest_cluster_mask_np(points: np.ndarray, valid: np.ndarray, eps: float = 5.0,
                            min_points: int = 200) -> np.ndarray:
    labels = cluster_labels_np(points, valid, eps, min_points)
    pos = labels[labels >= 0]
    if pos.size == 0:
        return np.zeros_like(valid)
    return valid & (labels == np.bincount(pos).argmax())


def clean_chain_np(points: np.ndarray, valid: np.ndarray, cfg, steps=CLEAN_STEPS):
    """``clean_chain`` on the host over numpy arrays (no padding): returns
    (masks [S, N] bool, counts [S] i32)."""
    params = chain_params(cfg, steps)
    n = points.shape[0]
    if n == 0 or not params:
        return np.zeros((len(params), n), bool), np.zeros(len(params), np.int32)
    masks, counts = [], []
    v = np.asarray(valid, bool)
    for step, kw in params:
        kw = dict(kw)
        if step == "background":
            v = v & ~segment_plane_np(points, v, kw["dist"], kw["trials"])[1]
        elif step == "cluster":
            v = largest_cluster_mask_np(points, v, kw["eps"], kw["min_points"])
        elif step == "radius":
            v = v & radius_outlier_mask_np(points, v, kw["radius"], kw["nb_points"])
        else:
            v = v & statistical_outlier_mask_np(points, v, kw["nb"], kw["std"])
        masks.append(v)
        counts.append(int(v.sum()))
    return np.stack(masks), np.asarray(counts, np.int32)
