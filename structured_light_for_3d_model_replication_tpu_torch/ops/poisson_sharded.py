"""Screened Poisson with the dense grid cut into axis-0 slabs over a device
mesh (the JAX package's ``ops/poisson_sharded.py``).

Each of D slots holds a [G/D, G, G] slab. The splat is formed slab by
slab (a slot keeps the trilinear corner contributions that land in its
slab, so the slabs sum to ``ops/poisson``'s grid), and the 7-point
Laplacian and the central-difference divergence read one boundary plane
from each z-neighbour (``ppermute``), edge-replicated at the grid's ends.
The CG's dot products are ``psum``s; its scalars stay on the devices. The
result matches ``poisson.poisson_solve`` up to f32 reduction order, and is
returned dense (the slabs gathered on the first slot's device) for the
extraction.

On one card a mesh of repeated devices runs the same program; the solve
raises the depth ceiling only over distinct cards: depth 10 is a 1024^3 f32
grid, 4 GiB a field, and the CG holds about six fields.
"""
from __future__ import annotations

import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import poisson
from structured_light_for_3d_model_replication_tpu_torch.parallel import mesh as meshlib

__all__ = ["poisson_solve_sharded"]


def _slab_mesh(devices=None) -> meshlib.DeviceMesh:
    devices = list(devices) if devices is not None else meshlib.attached_devices()
    return meshlib.make_mesh(n_data=len(devices), n_model=1, devices=devices)


def _halos(mesh: meshlib.DeviceMesh, us: list[torch.Tensor]):
    """Each slot's (u[i-1], u[i+1]) boundary planes [1, G, G]: the
    neighbours' edge planes, its own edge plane at the grid's ends."""
    n = mesh.size
    prev = meshlib.ppermute(mesh, [u[-1:] for u in us], [(i, i + 1) for i in range(n - 1)])
    nxt = meshlib.ppermute(mesh, [u[:1] for u in us], [(i + 1, i) for i in range(n - 1)])
    out = []
    for slot, u, p, q in zip(mesh.local_slots(), us, prev, nxt):
        out.append((u[:1] if slot == 0 else p, u[-1:] if slot == n - 1 else q))
    return out


def _laplacian_slab(u: torch.Tensor, prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """``poisson._laplacian`` of a slab: -6u, then u[i-1], u[i+1], u[j-1],
    u[j+1], u[k-1], u[k+1] added in that order (the dense stencil's, so the
    same bits), ``prev`` / ``nxt`` standing for the planes beyond the slab."""
    lap = -6.0 * u
    lap[1:] += u[:-1]
    lap[:1] += prev
    lap[:-1] += u[1:]
    lap[-1:] += nxt
    for axis in (1, 2):
        n = u.shape[axis]
        lap.narrow(axis, 1, n - 1).add_(u.narrow(axis, 0, n - 1))
        lap.narrow(axis, 0, 1).add_(u.narrow(axis, 0, 1))
        lap.narrow(axis, 0, n - 1).add_(u.narrow(axis, 1, n - 1))
        lap.narrow(axis, n - 1, 1).add_(u.narrow(axis, n - 1, 1))
    return lap


def laplacian_sharded(mesh: meshlib.DeviceMesh, us: list[torch.Tensor]) -> list[torch.Tensor]:
    """The 7-point Laplacian of a grid held as this process's slabs."""
    return [_laplacian_slab(u, p, q) for u, (p, q) in zip(us, _halos(mesh, us))]


def _divergence_slab(vf: torch.Tensor, prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """``poisson._divergence`` of a slab [S, G, G, 3] (``prev`` / ``nxt``:
    the x-component planes beyond it)."""
    div = torch.zeros(vf.shape[:3], dtype=torch.float32, device=vf.device)
    f = vf[..., 0]
    fwd = torch.cat([f[1:], nxt])
    bwd = torch.cat([prev, f[:-1]])
    div = div + 0.5 * (fwd - bwd)
    for a in (1, 2):
        f = vf[..., a]
        fwd = torch.roll(f, -1, a)
        bwd = torch.roll(f, 1, a)
        fwd.narrow(a, f.shape[a] - 1, 1).copy_(f.narrow(a, f.shape[a] - 1, 1))
        bwd.narrow(a, 0, 1).copy_(f.narrow(a, 0, 1))
        div = div + 0.5 * (fwd - bwd)
    return div


def _splat_slab(coords: torch.Tensor, values: torch.Tensor, x0: int, slab: int,
                g: int) -> torch.Tensor:
    """The trilinear splat of values [N, C] at fractional coords [N, 3]
    into the slab [slab, G, G, C] starting at grid plane ``x0``: the
    corner contributions outside it are dropped (``poisson._segment_sum``,
    no atomics)."""
    keys, vals = [], []
    for w, ix, iy, iz in poisson._corners(coords, (g, g, g)):
        lx = ix - x0
        inside = (lx >= 0) & (lx < slab)
        keys.append(((lx * g + iy) * g + iz)[inside])
        vals.append((values * w[:, None])[inside])
    out = poisson._segment_sum(torch.cat(keys), torch.cat(vals), slab * g * g)
    return out.view(slab, g, g, values.shape[1])


def poisson_solve_sharded(points, normals, valid=None, depth: int = 10, devices=None,
                          cg_iters: int = 350, screen: float = 4.0,
                          margin: float = 0.08,
                          timings: dict | None = None) -> poisson.PoissonResult:
    """Screened grid Poisson over ``devices`` (default: every attached card,
    else the CPU; a list may repeat a device), one axis-0 slab a device.
    The contract of ``poisson.poisson_solve``: the grid frame, the splat,
    the screened CG from 0 for ``cg_iters`` steps and the iso level are the
    dense solver's; ``chi`` and ``density`` come back whole on the first
    device. ``depth`` at most 16 (the reference's guard); 2^depth must
    divide over the devices. ``timings`` gets ``setup_s`` (frame, splat,
    divergence), ``cg_s`` and ``gather_s`` (host walls, the devices
    synchronized at each edge). (The JAX package's ``compile_only`` lowers
    and compiles its program without buffers; torch has nothing to
    compile, so the port has no such mode.)"""
    import time

    def lap(key: str, t0: float) -> float:
        if timings is None:
            return t0
        for d in {str(d) for d in mesh.local_devices()} - {"cpu"}:
            torch.cuda.synchronize(d)
        t1 = time.perf_counter()
        timings[key] = t1 - t0
        return t1

    t0 = time.perf_counter()
    if depth > 16:
        raise ValueError(f"depth {depth} > 16 (the reference's own guard: "
                         "processing.py:697-699)")
    mesh = _slab_mesh(devices)
    n_dev = mesh.size
    g = 1 << depth
    if g % n_dev:
        raise ValueError(f"grid {g} not divisible by {n_dev} devices")
    slab = g // n_dev
    f32 = torch.float32
    dev0 = mesh.local_devices()[0]
    points = torch.as_tensor(points).to(dev0, f32)
    normals = torch.as_tensor(normals).to(dev0, f32)
    valid = (torch.ones(points.shape[0], dtype=torch.bool, device=dev0) if valid is None
             else torch.as_tensor(valid).to(dev0, torch.bool))
    # the grid frame, as poisson.poisson_solve forms it
    margin32 = torch.tensor(margin, dtype=f32, device=dev0)
    inf = torch.tensor(float("inf"), dtype=f32, device=dev0)
    lo = torch.where(valid[:, None], points, inf).amin(0)
    hi = torch.where(valid[:, None], points, -inf).amax(0)
    extent = (hi - lo).max() * (1.0 + 2.0 * margin32)
    cell = extent / g
    origin = 0.5 * (lo + hi) - 0.5 * extent
    coords = (points - origin) / cell - 0.5
    w = valid.to(f32)[:, None]
    cv = coords[valid]
    vals = torch.cat([normals * w, w], -1)[valid]

    densities, divs = [], []
    splats = [_splat_slab(cv.to(d), vals.to(d), slot * slab, slab, g)
              for slot, d in zip(mesh.local_slots(), mesh.local_devices())]
    planes = _halos(mesh, [s[..., 0] for s in splats])
    for k, (sp, (p, q)) in enumerate(zip(splats, planes)):
        densities.append(sp[..., 3].contiguous())
        divs.append(_divergence_slab(sp, p, q))
        splats[k] = None          # the 4-channel splat is the largest buffer
    del splats, planes
    dmax = meshlib.pmax(mesh, [d.max() for d in densities])
    sws = [screen * (d / torch.clamp_min(m, 1e-12)) for d, m in zip(densities, dmax)]

    def a_mul(xs):
        out = []
        for x, sw, lap in zip(xs, sws, laplacian_sharded(mesh, xs)):
            y = sw * x
            y -= lap          # -lap + sw x, the dense operator's bits
            out.append(y)
        return out

    def dot(us, vs):
        return meshlib.psum(mesh, [torch.dot(u.reshape(-1), v.reshape(-1))
                                   for u, v in zip(us, vs)])

    # CG from 0 (poisson._cg): the scalars stay on the devices, no host sync
    t0 = lap("setup_s", t0)
    r = [-d for d in divs]
    del divs
    x = [torch.zeros_like(t) for t in r]
    p = [t.clone() for t in r]
    rs = dot(r, r)
    for _ in range(cg_iters):
        ap = a_mul(p)
        alpha = [a / torch.clamp_min(b, 1e-20) for a, b in zip(rs, dot(p, ap))]
        for xi, ri, pi, api, al in zip(x, r, p, ap, alpha):
            xi += al * pi           # x + alpha p and r - alpha ap, as _cg rounds them
            ri -= al * api
        del ap
        rs_new = dot(r, r)
        for pi, ri, a, b in zip(p, r, rs_new, rs):
            pi.mul_(a / torch.clamp_min(b, 1e-20)).add_(ri)
        rs = rs_new
    del r, p, sws
    t0 = lap("cg_s", t0)
    chi = meshlib.gather_shards(x, dev0)
    del x
    density = meshlib.gather_shards(densities, dev0)
    del densities
    iso = (poisson.trilinear_sample(chi, coords) * w[:, 0]).sum() / torch.clamp_min(w.sum(), 1.0)
    lap("gather_s", t0)
    return poisson.PoissonResult(chi, iso, density, origin + 0.5 * cell, cell)
