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
sigma. Its engine is ``_voxelized_knn_mean_dist``:

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
accelerator arm does, on either device. The JAX package's other selectors
(the jnp top_k engines and their tuner arms) are not ported.

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

__all__ = ["voxel_downsample", "statistical_outlier_mask", "DENSE_MAX",
           "radius_outlier_mask", "segment_plane", "cluster_labels",
           "largest_cluster_mask", "CLEAN_STEPS", "chain_params", "clean_chain",
           "statistical_outlier_mask_np", "radius_outlier_mask_np", "segment_plane_np",
           "cluster_labels_np", "largest_cluster_mask_np", "clean_chain_np"]

DENSE_MAX = 32768     # the dense engine's largest cloud
_SLAB_FAR = 3e9
_SLAB_TILE, _SLAB_WBLK = 64, 8192


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
                             voxelized_cell: float | None = None) -> torch.Tensor:
    """Keep-mask [N] for statistical outlier removal (Open3D semantics).
    ``voxelized_cell``: the voxel size when ``points`` just came out of
    voxel_downsample(cell); it sets the slab engine's certification radius."""
    n = points.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=points.device)
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
    cannot certify. ``selector``: "dense", "bisect" or "auto" (dense up to
    DENSE_MAX rows, else bisect at tile 64, window 8192)."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    if selector == "auto":
        selector = "dense" if n <= DENSE_MAX else "bisect"
    if selector == "dense":
        parked = torch.where(valid[:, None], pts,
                             torch.tensor(knnlib.FAR, dtype=torch.float32,
                                          device=pts.device)).contiguous()
        md, cnt = kernels.knn_mean(parked, int(k))
        cnt = torch.where(valid, cnt, torch.zeros_like(cnt))
        return torch.where(valid & (cnt >= k), md,
                           torch.tensor(float("inf"), device=pts.device))
    if selector != "bisect":
        raise ValueError(f"unknown selector {selector!r} (dense|bisect|auto)")
    tile, wblk = tile or _SLAB_TILE, window or _SLAB_WBLK
    pts_s, order, r = _slab_inputs(pts, valid, cell, wblk)
    md, cnt, win_end = kernels.slab_mean_knn(pts_s, r, k, tile=tile, wblk=wblk)
    return _slab_certify(pts_s, order, md, cnt, win_end, r, k)


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
                     valid: torch.Tensor, voxel_size: float):
    """Average points (and colors) per voxel. Fixed shape: returns
    (points [N, 3] f32, colors [N, 3] u8, valid [N]), one slot a surviving
    voxel in ascending (i, j, k) cell order; survivors fill a slot prefix.

    Grids under 2^10 cells per axis group on one packed int32 key (the JAX
    package's packed arm), larger ones on an int64 key of three 21-bit
    fields (its lexsort arm: same order, no collisions). Segment sums run
    over the sorted order as float64 prefix sums, so the result does not
    depend on the device's atomic order."""
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=points.device)
    lo, hi = _masked_extent(points, valid)
    packed = bool(torch.all(torch.floor((hi - lo) / vs) < 1023))
    n = points.shape[0]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=points.device)
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

def cluster_labels(points: torch.Tensor, valid: torch.Tensor, eps: float = 5.0,
                   min_points: int = 200, k: int = 16,
                   max_iters: int = 200) -> torch.Tensor:
    """DBSCAN-style labels i32 [N] by min-label propagation on the k-NN
    graph: core points (>= min_points neighbours within eps) pass the
    minimum label across core-to-core edges shorter than eps until nothing
    changes (at most ``max_iters`` rounds, one host sync a round); border
    points take the least label among their in-eps core neighbours; the
    rest are noise (-1). The JAX package's fixed-shape formulation of
    Open3D's cluster_dbscan, label for label."""
    n = points.shape[0]
    dev = points.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    idx, d2 = knnlib.knn(points, valid, k)
    idx = idx.long()
    eps2 = kernels._sq_f32(eps).to(dev)
    core = valid & (knnlib.radius_count(points, valid, eps) >= min_points)
    edge_ok = (d2 <= eps2) & valid[idx] & valid[:, None]
    none = torch.tensor(n, dtype=torch.int64, device=dev)
    labels = torch.where(core, torch.arange(n, device=dev), none)
    cc_edge = edge_ok & core[idx] & core[:, None]
    flat_idx = idx.reshape(-1)
    push_ok = cc_edge.reshape(-1)
    for _ in range(max_iters):
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
    return torch.where(final >= n, -1, final).to(torch.int32)


def largest_cluster_mask(points: torch.Tensor, valid: torch.Tensor,
                         eps: float = 5.0, min_points: int = 200,
                         k: int = 16) -> torch.Tensor:
    """Keep-mask of the most populated cluster (the lowest label on ties)."""
    n = points.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=points.device)
    labels = cluster_labels(points, valid, eps, min_points, k).long()
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


def _chain_step(points, valid, step: str, kw: dict, samples=None) -> torch.Tensor:
    """One masked step: the survivors stay where they are, the mask narrows."""
    if step == "background":
        _, inliers = segment_plane(points, valid, kw["dist"], kw["trials"],
                                   samples=samples)
        return valid & ~inliers
    if step == "cluster":
        return largest_cluster_mask(points, valid, eps=kw["eps"],
                                    min_points=kw["min_points"])
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
    ``clean_<step>_s`` (its count read back after it, a host sync)."""
    params = chain_params(cfg, steps)
    n = points.shape[0]
    if n == 0 or not params:
        return (torch.zeros((len(params), n), dtype=torch.bool, device=points.device),
                torch.zeros(len(params), dtype=torch.int32, device=points.device))
    masks, counts = [], []
    v = valid
    for step, kw in params:
        t0 = time.perf_counter()
        v = _chain_step(points, v, step, dict(kw), samples)
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
