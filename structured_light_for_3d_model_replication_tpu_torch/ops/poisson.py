"""Screened Poisson surface reconstruction on a regular grid (the JAX
package's ``ops/poisson.py``):

  1. splat oriented normals onto the grid (trilinear) -> vector field V and
     the splat weight W (the "density" of the low-support trim);
  2. divergence of V by central differences -> b;
  3. conjugate gradients on (-L + screen * W / max W) chi = -b, a 7-point
     Laplacian with edge-replicate (Neumann) boundaries;
  4. iso level = the weight-averaged chi at the sample points.

The splat is a sum of many contributions to each cell. On the card an
atomic scatter-add would sum them in an order that changes from run to run,
so ``_trilinear_scatter`` sorts the (cell, value) pairs and sums each
cell's run as a float64 prefix difference: the same grid on every run and
every device. The CG's dot products are f32 reductions in torch's order, so
chi differs from the JAX package's in its last bits; compare surfaces.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["PoissonResult", "poisson_solve", "trilinear_sample"]


class PoissonResult(NamedTuple):
    chi: torch.Tensor      # [G, G, G] implicit function (inside < iso < outside)
    iso: torch.Tensor      # scalar iso level at the surface
    density: torch.Tensor  # [G, G, G] splat weight (sample support per cell)
    origin: torch.Tensor   # [3] world position of voxel (0, 0, 0)'s centre
    cell: torch.Tensor     # scalar voxel size (world units)


def _corners(coords: torch.Tensor, g):
    """The 8 trilinear corners of fractional grid coords [N, 3] on a grid of
    shape g: yields (weight [N], ix, iy, iz), indices clipped to the grid,
    in the JAX package's (dx, dy, dz) order."""
    base = torch.floor(coords)
    frac = coords - base
    base = base.to(torch.int64)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((1 - dx - frac[:, 0]).abs() * (1 - dy - frac[:, 1]).abs()
                     * (1 - dz - frac[:, 2]).abs())
                yield (w, torch.clamp(base[:, 0] + dx, 0, g[0] - 1),
                       torch.clamp(base[:, 1] + dy, 0, g[1] - 1),
                       torch.clamp(base[:, 2] + dz, 0, g[2] - 1))


def _segment_sum(keys: torch.Tensor, values: torch.Tensor, size: int) -> torch.Tensor:
    """Dense [size, C] f32 sums of values [M, C] by integer key [M]: a
    stable sort, then each key's run summed as a float64 prefix difference
    (no atomics, so the same bits on every run)."""
    out = torch.zeros((size, values.shape[1]), dtype=torch.float32, device=values.device)
    if keys.numel() == 0:
        return out
    k_s, order = torch.sort(keys, stable=True)
    # [C, M]: the prefix sums run along the inner axis (laid out [M, C], the
    # four scans of a pipeline run took 0.96 s of device time on the card)
    csum = torch.cumsum(values[order].T.to(torch.float64), 1)
    last = torch.ones_like(k_s, dtype=torch.bool)
    last[:-1] = k_s[1:] != k_s[:-1]
    ends = torch.nonzero(last).flatten()
    tot = csum[:, ends]
    tot[:, 1:] = tot[:, 1:] - csum[:, ends[:-1]]
    out[k_s[ends]] = tot.T.to(torch.float32)
    return out


def _trilinear_scatter(grid_shape, coords: torch.Tensor, values: torch.Tensor,
                       batch: torch.Tensor | None = None) -> torch.Tensor:
    """Splat values [N, C] at fractional grid coords [N, 3] -> [*G, C]
    (with ``batch`` [N], the brick index of each row: [B, *G, C], B =
    grid_shape[0] and G = grid_shape[1:])."""
    g = tuple(grid_shape[-3:])
    lead = tuple(grid_shape[:-3])
    keys, vals = [], []
    for w, ix, iy, iz in _corners(coords, g):
        k = (ix * g[1] + iy) * g[2] + iz
        if batch is not None:
            k = batch * (g[0] * g[1] * g[2]) + k
        keys.append(k)
        vals.append(values * w[:, None])
    size = int(torch.tensor(grid_shape).prod())
    out = _segment_sum(torch.cat(keys), torch.cat(vals), size)
    return out.view(*lead, *g, values.shape[1])


def trilinear_sample(field: torch.Tensor, coords: torch.Tensor,
                     batch: torch.Tensor | None = None) -> torch.Tensor:
    """Sample a [G, G, G] field at fractional coords [N, 3] (with ``batch``
    [N]: a [B, G, G, G] field, row i sampling field[batch[i]])."""
    g = field.shape[-3:]
    flat = field.reshape(-1)
    acc = torch.zeros(coords.shape[0], dtype=torch.float32, device=coords.device)
    for w, ix, iy, iz in _corners(coords, g):
        k = (ix * g[1] + iy) * g[2] + iz
        if batch is not None:
            k = batch * (g[0] * g[1] * g[2]) + k
        acc = acc + w * flat[k]
    return acc


def _laplacian(u: torch.Tensor) -> torch.Tensor:
    """7-point stencil over the last three axes, edge-replicate boundaries
    (a rolled-in wrap value is replaced by the edge value)."""
    lap = -6.0 * u
    nd = u.dim()
    for axis in range(nd - 3, nd):
        for off in (1, -1):
            nb = torch.roll(u, off, axis)
            idx = [slice(None)] * nd
            idx[axis] = 0 if off == 1 else -1
            nb[tuple(idx)] = u[tuple(idx)]
            lap = lap + nb
    return lap


def _divergence(vfield: torch.Tensor) -> torch.Tensor:
    """Central-difference divergence of [..., G, G, G, 3] (cell units),
    one-sided copies at the edges."""
    nd = vfield.dim() - 1
    div = torch.zeros(vfield.shape[:-1], dtype=torch.float32, device=vfield.device)
    for a in range(3):
        axis = nd - 3 + a
        f = vfield[..., a]
        fwd = torch.roll(f, -1, axis)
        bwd = torch.roll(f, 1, axis)
        i0 = [slice(None)] * nd
        i0[axis] = -1
        fwd[tuple(i0)] = f[tuple(i0)]
        i1 = [slice(None)] * nd
        i1[axis] = 0
        bwd[tuple(i1)] = f[tuple(i1)]
        div = div + 0.5 * (fwd - bwd)
    return div


def _cg(a_mul, b: torch.Tensor, iters: int, project=None) -> torch.Tensor:
    """``iters`` conjugate-gradient steps from 0 (no early stop, no host
    sync: the scalars stay on the device). ``project`` masks the search
    directions (the bricks' frozen shell); reductions run over the last
    three axes, one system a leading index."""
    def dot(u, v):
        return (u * v).reshape(*u.shape[:-3], -1).sum(-1)[..., None, None, None]

    x = torch.zeros_like(b)
    r = b
    p = r if project is None else project(r)
    rs = dot(r, r)
    for _ in range(iters):
        ap = a_mul(p) if project is None else project(a_mul(p))
        alpha = rs / torch.clamp_min(dot(p, ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = dot(r, r)
        beta = rs_new / torch.clamp_min(rs, 1e-20)
        p = r + beta * p
        if project is not None:
            p = project(p)
        rs = rs_new
    return x


def poisson_solve(points: torch.Tensor, normals: torch.Tensor,
                  valid: torch.Tensor | None = None, depth: int = 8,
                  cg_iters: int = 350, screen: float = 4.0,
                  margin: float = 0.08) -> PoissonResult:
    """Screened grid Poisson on the points' device; normals must point
    OUTWARD (chi < iso inside). ``depth``: 2^depth cells an axis, at most
    9 (a dense 1024^3 grid is the brick solver's job)."""
    if depth > 9:
        raise ValueError(
            f"depth {depth} > 9: a dense {1 << depth}^3 f32 grid is not solved "
            f"dense; ops/poisson_bricks.poisson_solve_bricks refines depth 10+")
    f32 = torch.float32
    points = points.to(f32)
    normals = normals.to(f32)
    dev = points.device
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.bool, device=dev)
    g = 1 << depth
    margin32 = torch.tensor(margin, dtype=f32, device=dev)
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    lo = torch.where(valid[:, None], points, inf).amin(0)
    hi = torch.where(valid[:, None], points, -inf).amax(0)
    extent = (hi - lo).max() * (1.0 + 2.0 * margin32)
    cell = extent / g
    origin = 0.5 * (lo + hi) - 0.5 * extent
    coords = (points - origin) / cell - 0.5
    w = valid.to(f32)[:, None]
    splat = _trilinear_scatter((g, g, g), coords[valid],
                               torch.cat([normals * w, w], -1)[valid])
    density = splat[..., 3].contiguous()
    div = _divergence(splat[..., :3])
    del splat
    sw = screen * (density / torch.clamp_min(density.max(), 1e-12))
    chi = _cg(lambda x: -_laplacian(x) + sw * x, -div, cg_iters)
    iso = (trilinear_sample(chi, coords) * w[:, 0]).sum() / torch.clamp_min(w.sum(), 1.0)
    return PoissonResult(chi, iso, density, origin + 0.5 * cell, cell)
