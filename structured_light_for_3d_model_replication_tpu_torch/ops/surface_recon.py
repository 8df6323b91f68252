"""Direct point-cloud triangulation: the 'surface' meshing mode (the JAX
package's ``ops/surface_recon.py``).

A ball-pivoting analog. Instead of pivoting a ball edge to edge (a serial
frontier), every candidate triangle in every point's k-neighbour fan is
scored at once with the ball-pivoting acceptance test: circumradius <=
alpha and an empty alpha-ball touching the three vertices, the emptiness
checked against the seed's pool_k nearest neighbours. Seeds go in fixed
chunks (a few [chunk, k(k-1)/2, pool_k] tensors a chunk, plain torch: the
test is a handful of broadcast products, bound by memory traffic, with no
Pallas kernel behind it in the JAX package). Accepted triangles are
deduplicated on the host on the sorted vertex triple, the first
orientation kept, and unreferenced vertices dropped. The neighbours are the
port's exact ``knn``.

Like ball pivoting (and unlike Poisson) the mesh interpolates the input
points and leaves holes where the sampling is too sparse for the ball.
"""
from __future__ import annotations

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
from structured_light_for_3d_model_replication_tpu_torch.ops import meshproc

__all__ = ["ball_pivot_surface", "average_nn_distance"]


def average_nn_distance(points: torch.Tensor, valid: torch.Tensor) -> float:
    """Mean distance to the nearest neighbour over the valid points (the
    ball radius heuristic)."""
    _, d2 = knnlib.knn(points, valid, 1)
    d = torch.sqrt(torch.clamp_min(d2[:, 0], 0.0))
    w = valid.to(torch.float32)
    return float((d * w).sum() / torch.clamp_min(w.sum(), 1.0))


def _score_chunk(ci, pts, nrm, valid, nb_i, pool_i, pairs_p, pairs_q, alpha: float):
    """Score every fan triangle of the seeds ``ci`` [B]: nb_i [B, k] fan
    neighbours, pool_i [B, pk] the emptiness pool. Returns (faces [B*m, 3]
    int64, accept [B*m] bool), each face wound along the vertex normals."""
    a32 = torch.tensor(alpha, dtype=torch.float32, device=pts.device)
    eps = 1e-4 * a32
    i = ci[:, None]
    j = nb_i[:, pairs_p]
    l = nb_i[:, pairs_q]                                          # noqa: E741
    a = pts[ci][:, None, :]
    b = pts[j]
    c = pts[l]
    ok = (j != i) & (l != i) & (j != l)
    ok &= valid[ci][:, None] & valid[j] & valid[l]

    # circumcenter and radius in the triangle's plane
    ab = b - a
    ac = c - a
    n = torch.linalg.cross(ab, ac, dim=-1)
    n2 = (n * n).sum(-1)
    degenerate = n2 < 1e-20
    n2s = torch.clamp_min(n2, 1e-20)
    ab2 = (ab * ab).sum(-1, keepdim=True)
    ac2 = (ac * ac).sum(-1, keepdim=True)
    cc = a + (ac2 * torch.linalg.cross(n, ab, dim=-1)
              + ab2 * torch.linalg.cross(ac, n, dim=-1)) / (2.0 * n2s[..., None])
    rc2 = ((cc - a) ** 2).sum(-1)
    ok &= ~degenerate & (rc2 <= a32 * a32)

    n_hat = n / torch.sqrt(n2s)[..., None]
    h = torch.sqrt(torch.clamp_min(a32 * a32 - rc2, 0.0))[..., None]
    centers = (cc + h * n_hat, cc - h * n_hat)     # the two balls through a, b, c

    pool_pts = pts[pool_i]                                        # [B, pk, 3]
    excl = ((pool_i[:, None, :] == i[:, :, None])
            | (pool_i[:, None, :] == j[..., None])
            | (pool_i[:, None, :] == l[..., None])
            | ~valid[pool_i][:, None, :])                         # [B, m, pk]
    a2 = (a32 - eps) ** 2
    empty = torch.zeros_like(ok)
    for center in centers:
        d = pool_pts[:, None, :, :] - center[:, :, None, :]      # [B, m, pk, 3]
        d2 = (d * d).sum(-1).masked_fill_(excl, float("inf"))
        empty |= d2.amin(-1) >= a2
    ok &= empty

    if nrm is not None:
        vote = ((nrm[ci][:, None, :] + nrm[j] + nrm[l]) * n_hat).sum(-1)
        flip = vote < 0
        j, l = torch.where(flip, l, j), torch.where(flip, j, l)  # noqa: E741
    faces = torch.stack([i.expand_as(j), j, l], dim=-1).reshape(-1, 3)
    return faces, ok.reshape(-1)


def ball_pivot_surface(points, valid=None, normals=None, alpha: float | None = None,
                       k: int = 12, pool_k: int = 24, alpha_factor: float = 2.5,
                       chunk: int = 4096):
    """Triangulate a cloud directly (points [N, 3] tensor on its device,
    ``valid`` [N] and ``normals`` [N, 3] optional). Returns host (vertices
    [V, 3] f32, the input points that some face references, faces [F, 3]
    i32). ``alpha``: the ball radius, by default ``alpha_factor`` times the
    average nearest-neighbour distance. Fan of the ``k`` nearest, pool of
    the ``pool_k`` nearest."""
    pts = points.to(torch.float32).contiguous()
    n = pts.shape[0]
    dev = pts.device
    v = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
         else valid.to(device=dev, dtype=torch.bool))
    nrm = None if normals is None else normals.to(device=dev, dtype=torch.float32)
    if alpha is None:
        alpha = alpha_factor * average_nn_distance(pts, v)
    kk = max(k, 3)
    pk = max(pool_k, kk)
    idx_pool = knnlib.knn(pts, v, pk)[0].long()
    idx_fan = idx_pool[:, :kk]
    pairs = np.asarray([(p, q) for p in range(kk) for q in range(p + 1, kk)])
    pp = torch.as_tensor(pairs[:, 0], device=dev)
    qq = torch.as_tensor(pairs[:, 1], device=dev)

    all_faces = []
    for s in range(0, n, chunk):
        ci = torch.arange(s, min(s + chunk, n), device=dev)
        faces, ok = _score_chunk(ci, pts, nrm, v, idx_fan[ci], idx_pool[ci], pp, qq,
                                 float(alpha))
        all_faces.append(faces[ok].cpu().numpy())
    host_pts = pts.cpu().numpy()
    if sum(map(len, all_faces)) == 0:
        return host_pts, np.zeros((0, 3), np.int32)
    faces = np.concatenate(all_faces).astype(np.int32)
    # one face a vertex triple, the first occurrence's orientation kept
    _, first = np.unique(np.sort(faces, axis=1), axis=0, return_index=True)
    return meshproc.remove_unreferenced(host_pts, faces[np.sort(first)])
