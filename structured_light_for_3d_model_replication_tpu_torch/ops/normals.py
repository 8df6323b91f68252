"""Normal estimation: PCA over k-neighbourhoods with a closed-form 3x3
eigensolver, and orientation away from the cloud's centre (the JAX
package's ``ops/normals.py``). ``estimate_normals_np`` is the host
reference: cKDTree neighbourhoods and numpy's ``eigh``."""
from __future__ import annotations

import math

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib

__all__ = ["smallest_eigvec_sym3", "estimate_normals", "estimate_normals_np",
           "orient_normals"]


def smallest_eigvec_sym3(cov: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric [.., 3, 3]:
    eigenvalues by the trigonometric solution of the characteristic cubic,
    the eigenvector as the longest cross product of two rows of
    (C - lambda I); +z where the neighbourhood is degenerate."""
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    q = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1) / 3.0
    b = cov - q[..., None, None] * eye
    p2 = (b * b).sum((-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 1e-30))
    r = torch.clamp(torch.linalg.det(b) / (2.0 * p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    m = cov - lam_min[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)
    best = torch.argmax((cands * cands).sum(-1), dim=-1)
    vec = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    norm = torch.sqrt((vec * vec).sum(-1, keepdim=True))
    ok = norm > 1e-12
    fallback = torch.zeros_like(vec)
    fallback[..., 2] = 1.0
    return torch.where(ok, vec / torch.where(ok, norm, torch.ones_like(norm)), fallback)


def estimate_normals(points: torch.Tensor, valid: torch.Tensor, k: int = 30,
                     radius: float | None = None, idx_d2=None) -> torch.Tensor:
    """Unit normals [N, 3] from PCA of each point's k-neighbourhood.
    ``radius``: only neighbours within it enter the fit, unless that leaves
    fewer than 3 (then the pure k-neighbourhood). ``idx_d2``: precomputed
    ascending (idx [N, >=k], d2 [N, >=k])."""
    if idx_d2 is not None:
        idx, d2 = (a[:, :k] for a in idx_d2)
    else:
        idx, d2 = knnlib.knn(points, valid, k)
    idx = idx.long()
    neigh = points[idx]
    ok = valid[idx]
    if radius is not None:
        ok_r = ok & (d2 <= float(radius) ** 2)
        ok = torch.where(ok_r.sum(1, keepdim=True) >= 3, ok_r, ok)
    w = ok.to(torch.float32)[..., None]
    cnt = torch.clamp_min(w.sum(1), 1.0)
    mean = (neigh * w).sum(1) / cnt
    d = (neigh - mean[:, None, :]) * w
    cov = torch.einsum("nki,nkj->nij", d, d) / cnt[..., None]
    return smallest_eigvec_sym3(cov)


def estimate_normals_np(points, valid, k: int = 30, radius: float | None = None):
    """Host reference of ``estimate_normals``: each valid row's normal is
    the eigenvector of the least eigenvalue of its k nearest valid
    neighbours' covariance (``np.cov``, ``np.linalg.eigh``); with ``radius``
    only the neighbours within it count. A row with fewer than 3 such
    neighbours, or invalid, gets (0, 0, 1). f32 [N, 3], unoriented."""
    if valid is None:
        valid = np.ones(points.shape[0], bool)
    idx, d2 = knnlib.knn_np(points, valid, k)
    normals = np.zeros((points.shape[0], 3), np.float32)
    for i in range(points.shape[0]):
        if not valid[i]:
            normals[i] = (0, 0, 1)
            continue
        keep = valid[idx[i]]
        if radius is not None:
            keep = keep & (d2[i] <= radius * radius)
        nb = points[idx[i]][keep]
        if nb.shape[0] < 3:
            normals[i] = (0, 0, 1)
            continue
        _, vecs = np.linalg.eigh(np.cov(nb.T))
        normals[i] = vecs[:, 0]
    return normals


def orient_normals(points: torch.Tensor, normals: torch.Tensor,
                   valid: torch.Tensor, mode: str = "radial",
                   center: torch.Tensor | None = None,
                   flip: bool = False) -> torch.Tensor:
    """Orient normals away from ``center`` (default: the valid rows'
    centroid): modes 'radial' and 'centroid' are that one rule; ``flip``
    turns them all inward. A normal perpendicular to its radius keeps its
    sign."""
    if mode not in ("radial", "centroid"):
        raise ValueError(f"unknown orientation mode: {mode}")
    if center is None:
        w = valid.to(points.dtype)[:, None]
        center = (points * w).sum(0) / torch.clamp_min(w.sum(), 1.0)
    sign = torch.sign(((points - center[None, :]) * normals).sum(-1, keepdim=True))
    oriented = normals * torch.where(sign == 0, torch.ones_like(sign), sign)
    return -oriented if flip else oriented
