"""SE(3) pose-graph optimization for the multiway merge (the JAX package's
``ops/posegraph.py``).

The turntable's pose graph is small (24 nodes x 6 dof), so it is solved as
a DENSE damped Gauss-Newton iteration built from batched SE(3) ops: every
edge residual and Jacobian block at once, scattered into the [6N, 6N]
normal matrix, one dense solve a step, a fixed number of steps; then the
rotations are re-orthonormalized by SVD. Plain torch: the graph is far too
small for a kernel of its own. Every product runs in full f32
(``registration.exact_f32_products``), as the JAX package pins
Precision.HIGHEST on the same products.

Conventions: poses are world-from-view 4x4 matrices; edge (i, j, Z)
measures view-i-from-view-j. Residual per edge: ``Log(Z^-1 T_i^-1 T_j)``
with right-multiplicative perturbations ``T <- T exp(xi)``,
``dr/dxi_j = I`` and ``dr/dxi_i = -Ad(A^-1)`` with ``A = T_i^-1 T_j``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import registration as reg
from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["exp_se3", "log_se3", "adjoint_se3", "optimize_pose_graph",
           "PoseGraphResult"]


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _coefficients(theta2: torch.Tensor, theta: torch.Tensor):
    """(1 - cos t) / t^2 and (t - sin t) / t^3 of exp and log, their
    small-angle limits below theta^2 = 1e-12."""
    t2c = torch.clamp_min(theta2, 1e-24)
    b = (1 - torch.cos(theta)) / t2c
    c = (theta - torch.sin(theta)) / (t2c * theta)
    small = (theta2[..., 0, 0] < 1e-12)[..., None, None]
    return (torch.where(small, torch.full_like(b, 0.5), b),
            torch.where(small, torch.full_like(c, 1.0 / 6.0), c), small)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """xi = [w(3), v(3)] -> 4x4, batched over leading dims."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-24)
    k = _skew(w)
    k2 = k @ k
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    b, c, small = _coefficients(theta2, theta)
    a = torch.where(small, torch.ones_like(theta), torch.sin(theta) / theta)
    R = eye + a * k + b * k2
    V = eye + b * k + c * k2
    t = (V @ v[..., :, None])[..., 0]
    out = torch.zeros(R.shape[:-2] + (4, 4), dtype=xi.dtype, device=xi.device)
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def _log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle, batched; safe at 0 and near pi (the
    axis from the diagonal of (R + I) / 2, signs from the off-diagonals)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1) / 2, -1.0, 1.0))
    ax = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                      R[..., 0, 2] - R[..., 2, 0],
                      R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.clamp_min(2 * torch.sin(theta), 1e-12)[..., None]
    w_generic = ax * (theta[..., None] / s)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis = torch.sqrt(torch.clamp((diag + 1) / 2, 0, 1))
    one = torch.ones_like(ax)
    axis = axis * torch.where(ax >= 0, one, -one)
    nrm = torch.clamp_min(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), 1e-12)
    w_pi = axis / nrm * theta[..., None]
    w = torch.where(((math.pi - theta) < 1e-3)[..., None], w_pi, w_generic)
    return torch.where((theta < 1e-7)[..., None], ax / 2, w)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """4x4 -> xi = [w, v], batched."""
    w = _log_so3(T[..., :3, :3])
    theta2 = (w * w).sum(-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-24)
    k = _skew(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    b, c, _ = _coefficients(theta2, theta)
    V = eye + b * k + c * (k @ k)
    v = torch.linalg.solve(V, T[..., :3, 3:4])[..., 0]
    return torch.cat([w, v], -1)


def adjoint_se3(T: torch.Tensor) -> torch.Tensor:
    """6x6 adjoint of a 4x4 pose (w-then-v twist ordering), batched."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    top = torch.cat([R, torch.zeros_like(R)], -1)
    bot = torch.cat([_skew(t) @ R, R], -1)
    return torch.cat([top, bot], -2)


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor          # [N, 4, 4] optimized world-from-view
    residual_rmse: torch.Tensor  # [iters] edge residual RMS after each step
    initial_rmse: torch.Tensor


def _weighted_rmse(r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((w * (r * r).sum(-1)).sum() / torch.clamp_min(w.sum(), 1e-9))


def optimize_pose_graph(init_poses, edges_i, edges_j, edge_transforms, edge_weights=None,
                        iters: int = 20, damping: float = 1e-6,
                        device=None) -> PoseGraphResult:
    """Globally optimize world-from-view poses against relative-pose edges
    on ``device`` (None -> cuda). init_poses [N, 4, 4]; edges_{i,j} [E]
    node ids; edge_transforms [E, 4, 4] measuring frame i from frame j;
    edge_weights [E] (e.g. registration fitness). Node 0 is the gauge
    anchor (a 1e12 diagonal on its block). ``iters`` damped Gauss-Newton
    steps, each one dense [6N, 6N] solve (LU, as the JAX package's
    ``jnp.linalg.solve``); then each rotation is replaced by U V^T of its
    SVD."""
    dev = resolve_device(device)
    reg.exact_f32_products()

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    poses = f32(init_poses)
    ei = torch.as_tensor(np.asarray(edges_i, np.int64), device=dev)
    ej = torch.as_tensor(np.asarray(edges_j, np.int64), device=dev)
    Z = f32(edge_transforms)
    w = (torch.ones(ei.shape[0], dtype=torch.float32, device=dev) if edge_weights is None
         else f32(edge_weights))
    n = poses.shape[0]
    Zinv = torch.linalg.inv(Z)
    ar6 = torch.arange(6, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    anchor = torch.zeros(n * 6, dtype=torch.float32, device=dev)
    anchor[:6] = 1e12
    reg_diag = torch.diag(anchor) + damping * torch.eye(n * 6, dtype=torch.float32,
                                                        device=dev)

    def residuals(p):
        return log_se3(Zinv @ torch.linalg.inv(p[ei]) @ p[ej])

    def scatter(H, rows, cols, blocks):
        ri = rows[:, None] * 6 + ar6[None, :]
        ci = cols[:, None] * 6 + ar6[None, :]
        H.index_put_((ri[:, :, None].expand(-1, 6, 6), ci[:, None, :].expand(-1, 6, 6)),
                     blocks, accumulate=True)

    rmse0 = _weighted_rmse(residuals(poses), w)
    hist = []
    for _ in range(iters):
        r = residuals(poses)
        Ji = -adjoint_se3(torch.linalg.inv(poses[ej]) @ poses[ei])      # [E, 6, 6]
        JiT_Ji = torch.einsum("eki,e,ekj->eij", Ji, w, Ji)
        JiT_Jj = Ji.transpose(-1, -2) * w[:, None, None]
        JiT_r = torch.einsum("eki,ek->ei", Ji, w[:, None] * r)
        H = torch.zeros((n * 6, n * 6), dtype=torch.float32, device=dev)
        g = torch.zeros(n * 6, dtype=torch.float32, device=dev)
        scatter(H, ei, ei, JiT_Ji)
        scatter(H, ei, ej, JiT_Jj)
        scatter(H, ej, ei, JiT_Jj.transpose(-1, -2))
        scatter(H, ej, ej, w[:, None, None] * eye6)
        g.index_put_((ei[:, None] * 6 + ar6[None, :],), -JiT_r, accumulate=True)
        g.index_put_((ej[:, None] * 6 + ar6[None, :],), -(w[:, None] * r), accumulate=True)
        xi = torch.linalg.solve(H + reg_diag, g).reshape(n, 6)
        poses = poses @ exp_se3(xi)
        hist.append(_weighted_rmse(residuals(poses), w))
    u, _, vt = torch.linalg.svd(poses[:, :3, :3])
    poses = poses.clone()
    poses[:, :3, :3] = u @ vt
    rmse_hist = torch.stack(hist) if hist else torch.zeros(0, device=dev)
    return PoseGraphResult(poses, rmse_hist, rmse0)
