"""Brick-refined screened Poisson: depth 10 and above on one card (the JAX
package's ``ops/poisson_bricks.py``).

  1. solve the whole problem dense at ``base_depth`` (<= 9): the cascadic
     coarse pass that fixes the far field;
  2. mark the fine-level bricks (``brick``^3 cells) that hold samples —
     their number follows the surface area, not the volume;
  3. refine each active brick: splat its samples' fine RHS, start from the
     trilinearly upsampled coarse chi, and run projected CG with the outer
     shell frozen at the coarse solution. ``batch`` bricks solve as one
     [B, D, D, D] batch (D = brick + 2 * halo); the refined fields go to the
     host a batch at a time;
  4. extract the iso-surface brick by brick (interior plus one ring) and
     key every vertex by its global cell, so seams share vertices exactly.

The point-to-brick assignment and the stitching are numpy on the host, as
in the JAX package; the splats are sorted float64 segment sums (no
atomics), so the refined fields are the same on every run.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import poisson as dense
from structured_light_for_3d_model_replication_tpu_torch.ops import surface_nets

__all__ = ["poisson_solve_bricks", "extract_surface_bricks", "BrickPoissonResult"]


class BrickPoissonResult(NamedTuple):
    chi: np.ndarray       # [B, D, D, D] refined local fields (host)
    brick_lo: np.ndarray  # [B, 3] fine-cell index of each DOMAIN corner
    n_bricks: int
    iso: float            # iso level (mean refined chi at the samples)
    origin: np.ndarray    # [3] world position of fine voxel (0, 0, 0)'s CENTRE
    cell: float           # fine voxel size
    depth: int
    brick: int
    halo: int
    coarse: dense.PoissonResult   # the base dense solve (far field)


def _fine_grid_params(points: np.ndarray, valid: np.ndarray, depth: int, margin: float):
    """The dense solve's bounding-box convention in f32, so the coarse and
    fine grids nest."""
    pts = np.asarray(points, np.float32)
    val = np.asarray(valid, bool)
    lo = pts[val].min(axis=0)
    hi = pts[val].max(axis=0)
    extent = np.float32((hi - lo).max() * (1.0 + 2.0 * margin))
    g = 1 << depth
    cell = np.float32(extent / g)
    origin = (0.5 * (lo + hi) - 0.5 * extent).astype(np.float32)
    return origin, cell, g


def _refine_bricks(pts_b, nrm_b, ok_b, lo_b, chi_c, origin, cell, factor: float,
                   screen: float, D: int, brick: int, halo: int, cg_iters: int):
    """Refine a batch of bricks on chi_c's device. pts_b [B, P, 3] world
    points of each brick's dilated domain, ok_b [B, P] their validity,
    lo_b [B, 3] each DOMAIN corner's fine cell. Returns (chi_f [B, D, D, D],
    iso_sum [B], iso_cnt [B]); the iso terms count a sample once, in the
    brick whose interior holds its cell."""
    f32 = torch.float32
    B, P = ok_b.shape
    dev = chi_c.device
    lo_f = lo_b.to(f32)
    coords = (pts_b - origin) / cell - 0.5 - lo_f[:, None, :]
    coords = torch.where(ok_b[..., None], coords, torch.tensor(-10.0, dtype=f32, device=dev))
    w = ok_b.to(f32)[..., None]
    rows = ok_b.reshape(-1)
    bidx = torch.arange(B, device=dev).repeat_interleave(P)[rows]
    splat = dense._trilinear_scatter(
        (B, D, D, D), coords.reshape(-1, 3)[rows],
        torch.cat([nrm_b * w, w], -1).reshape(-1, 4)[rows], batch=bidx)
    density = splat[..., 3]
    div = dense._divergence(splat[..., :3])
    del splat

    # start and frozen shell: the coarse chi upsampled at the fine cells
    ii = torch.arange(D, dtype=f32, device=dev)
    axes = [(lo_f[:, a, None] + ii[None, :] + 0.5) / factor - 0.5 for a in range(3)]
    cc = torch.stack([axes[0][:, :, None, None].expand(B, D, D, D),
                      axes[1][:, None, :, None].expand(B, D, D, D),
                      axes[2][:, None, None, :].expand(B, D, D, D)], -1)
    x0 = dense.trilinear_sample(chi_c, cc.reshape(-1, 3)).reshape(B, D, D, D)

    interior = torch.zeros((D, D, D), dtype=torch.bool, device=dev)
    interior[1:-1, 1:-1, 1:-1] = True
    dmax = density.reshape(B, -1).amax(1)[:, None, None, None]
    sw = screen * (density / torch.clamp_min(dmax, 1e-12))

    def a_mul(x):
        return -dense._laplacian(x) + sw * x

    def project(x):
        return torch.where(interior, x, torch.zeros((), dtype=f32, device=dev))

    b = project(-div - a_mul(x0))
    chi_f = x0 + project(dense._cg(a_mul, b, cg_iters, project=project))

    cells = torch.floor(coords).to(torch.int64)
    owned = ok_b & ((cells >= halo) & (cells < halo + brick)).all(-1)
    chi_at = dense.trilinear_sample(chi_f, coords.reshape(-1, 3),
                                    batch=torch.arange(B, device=dev).repeat_interleave(P))
    chi_at = chi_at.view(B, P)
    zero = torch.zeros((), dtype=f32, device=dev)
    return chi_f, torch.where(owned, chi_at, zero).sum(1), owned.to(f32).sum(1)


def poisson_solve_bricks(points: torch.Tensor, normals: torch.Tensor,
                         valid: torch.Tensor | None = None, depth: int = 11,
                         base_depth: int = 9, brick: int = 32, halo: int = 8,
                         cg_iters: int = 120, base_cg_iters: int = 350,
                         screen: float = 4.0, margin: float = 0.08,
                         batch: int = 32, max_points_per_brick: int = 8192,
                         log=lambda m: None,
                         timings: dict | None = None) -> BrickPoissonResult:
    """Screened Poisson at depth 10..16: a dense base solve plus brick
    refinement, on the points' device. Samples beyond
    ``max_points_per_brick`` in one brick's domain are left out of that
    brick's RHS. ``timings`` gets the base solve's wall
    (``poisson_base_s``, synchronized)."""
    if depth <= base_depth:
        raise ValueError(f"depth {depth} <= base_depth {base_depth}: use "
                         f"ops/poisson.poisson_solve directly")
    if depth > 16:
        raise ValueError("depth > 16 rejected (the reference's own guard)")
    if halo < 2:
        raise ValueError(f"halo {halo} < 2: the stitched extraction needs "
                         f"one ring below and two above the interior")
    if halo + 2 > brick:
        raise ValueError(f"halo {halo} + 2 must not exceed brick {brick} "
                         f"(the 27-neighbourhood candidate gather)")
    dev = points.device
    val_t = (torch.ones(points.shape[0], dtype=torch.bool, device=dev)
             if valid is None else valid)
    pts = points.detach().to("cpu", torch.float32).numpy()
    nrm = normals.detach().to("cpu", torch.float32).numpy()
    val = val_t.detach().cpu().numpy().astype(bool)
    if not val.any():
        raise ValueError("no valid samples")
    base_depth = min(base_depth, 9)

    t0 = time.perf_counter()
    coarse = dense.poisson_solve(points, normals, val_t, depth=base_depth,
                                 cg_iters=base_cg_iters, screen=screen, margin=margin)
    if timings is not None:
        float(coarse.iso)   # waits for the solve
        timings["poisson_base_s"] = time.perf_counter() - t0
    origin, cell, g = _fine_grid_params(pts, val, depth, margin)
    factor = float(g >> base_depth)

    D = brick + 2 * halo
    pts_v, nrm_v = pts[val], nrm[val]
    cidx = np.floor((pts_v - origin) / cell - 0.5).astype(np.int64)
    nb = g // brick
    bid = np.clip(cidx // brick, 0, nb - 1)
    uniq = np.unique(bid[:, 0] * nb * nb + bid[:, 1] * nb + bid[:, 2])
    lo_all = np.stack(np.unravel_index(uniq, (nb, nb, nb)), axis=1).astype(np.int64) * brick
    n_bricks = len(lo_all)
    log(f"[poisson-bricks] depth {depth}: {n_bricks} active bricks of "
        f"{nb}^3 ({brick}^3 cells each, halo {halo}, domain {D}^3)")

    # a brick's dilated domain (reach halo + 2 <= brick) only sees points of
    # its 27-neighbourhood: bucket the points by their own brick once
    pkey = (bid[:, 0] * nb + bid[:, 1]) * nb + bid[:, 2]
    ordp = np.argsort(pkey)
    pk_sorted = pkey[ordp]

    def candidates(g3):
        sels = []
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for dk in (-1, 0, 1):
                    q = (g3[0] + di, g3[1] + dj, g3[2] + dk)
                    if not all(0 <= q[a] < nb for a in range(3)):
                        continue
                    k = (q[0] * nb + q[1]) * nb + q[2]
                    a, z = np.searchsorted(pk_sorted, [k, k + 1])
                    if z > a:
                        sels.append(ordp[a:z])
        return np.concatenate(sels) if sels else np.zeros(0, np.int64)

    origin_t = torch.as_tensor(origin, device=dev)
    cell_t = torch.tensor(cell, dtype=torch.float32, device=dev)
    chi_blocks, lo_blocks = [], []
    iso_sum = iso_cnt = 0.0
    p_cap = max_points_per_brick
    for s in range(0, n_bricks, batch):
        part = lo_all[s:s + batch]
        bsz = len(part)
        pb = np.zeros((batch, p_cap, 3), np.float32)
        nb_arr = np.zeros((batch, p_cap, 3), np.float32)
        ob = np.zeros((batch, p_cap), bool)
        for t, lo3 in enumerate(part):
            dlo = lo3 - halo
            cand = candidates(tuple(lo3 // brick))
            cc = cidx[cand]
            inside = ((cc >= dlo - 2) & (cc < dlo + D + 2)).all(axis=1)
            sel = cand[inside][:p_cap]
            pb[t, :len(sel)] = pts_v[sel]
            nb_arr[t, :len(sel)] = nrm_v[sel]
            ob[t, :len(sel)] = True
        lo_dom = np.concatenate([part - halo, np.zeros((batch - bsz, 3), np.int64)]).astype(np.int32)
        chi_f, s_iso, c_iso = _refine_bricks(
            torch.from_numpy(pb).to(dev), torch.from_numpy(nb_arr).to(dev),
            torch.from_numpy(ob).to(dev), torch.from_numpy(lo_dom).to(dev), coarse.chi,
            origin_t, cell_t, factor, screen, D=D, brick=brick, halo=halo, cg_iters=cg_iters)
        chi_blocks.append(chi_f[:bsz].cpu().numpy())
        lo_blocks.append(lo_dom[:bsz])
        iso_sum += float(s_iso[:bsz].double().sum())
        iso_cnt += float(c_iso[:bsz].double().sum())
    chi_all = np.concatenate(chi_blocks)
    lo_np = np.concatenate(lo_blocks)
    iso = iso_sum / max(iso_cnt, 1.0)
    return BrickPoissonResult(chi_all, lo_np, n_bricks, iso, origin + 0.5 * cell,
                              float(cell), depth, brick, halo, coarse)


def extract_surface_bricks(res: BrickPoissonResult):
    """Iso-surface of a brick-refined solve, stitched canonically:

    - each face comes from exactly one brick, the owner of its generating
      edge's minimal cell (interiors partition the grid);
    - each vertex is keyed by its global surface cell and placed by the
      brick that owns that cell, so seam faces of two bricks share it.

    Each brick's slab first takes its neighbours' refined interior values on
    its ring, so both sides of a seam see the same field. Runs on the host
    (the fields are there). Returns (verts [V, 3] f32 world, faces [F, 3]
    i32)."""
    h, b = res.halo, res.brick
    bids = (res.brick_lo + h) // b
    idx_of = {tuple(k): i for i, k in enumerate(bids)}
    key_chunks, pos_chunks, ownflag_chunks, face_chunks = [], [], [], []
    span = np.int64(1) << 21
    for i in range(res.n_bricks):
        f = res.chi[i][h - 1:h + b + 2, h - 1:h + b + 2, h - 1:h + b + 2].copy()
        slab_lo = res.brick_lo[i] + (h - 1)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for dk in (-1, 0, 1):
                    if di == dj == dk == 0:
                        continue
                    j = idx_of.get((bids[i, 0] + di, bids[i, 1] + dj, bids[i, 2] + dk))
                    if j is None:
                        continue
                    n_lo = res.brick_lo[j] + h
                    lo_g = np.maximum(slab_lo, n_lo)
                    hi_g = np.minimum(slab_lo + b + 3, n_lo + b)
                    if (lo_g >= hi_g).any():
                        continue
                    dst = tuple(slice(lo_g[a] - slab_lo[a], hi_g[a] - slab_lo[a])
                                for a in range(3))
                    src = tuple(slice(lo_g[a] - res.brick_lo[j][a], hi_g[a] - res.brick_lo[j][a])
                                for a in range(3))
                    f[dst] = res.chi[j][src]
        org = res.origin + (res.brick_lo[i] + h - 1) * res.cell
        v, fc, own, vcell = surface_nets.extract_surface(
            torch.from_numpy(f), res.iso, origin=org, cell=res.cell, face_cells=True)
        if not len(v):
            continue
        keep = ((own >= 1) & (own < 1 + b)).all(axis=1)
        fc = np.asarray(fc, np.int64)[keep]
        if not len(fc):
            continue
        gcell = vcell.astype(np.int64) + (res.brick_lo[i] + (h - 1))
        gkey = (gcell[:, 0] * span + gcell[:, 1]) * span + gcell[:, 2]
        interior = ((vcell >= 1) & (vcell < 1 + b)).all(axis=1)
        used = np.unique(fc)
        key_chunks.append(gkey[used])
        pos_chunks.append(np.asarray(v, np.float32)[used])
        ownflag_chunks.append(interior[used])
        face_chunks.append(gkey[fc])
    if not key_chunks:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    keys = np.concatenate(key_chunks)
    pos = np.concatenate(pos_chunks)
    owned = np.concatenate(ownflag_chunks)
    fkeys = np.concatenate(face_chunks)
    # per key, the owner brick's copy first
    order = np.lexsort((~owned, keys))
    ks, ps = keys[order], pos[order]
    uk, first = np.unique(ks, return_index=True)
    verts = ps[first]
    faces = np.searchsorted(uk, fkeys).astype(np.int64)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[good].astype(np.int32)
