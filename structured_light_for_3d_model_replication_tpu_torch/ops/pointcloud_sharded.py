"""The merged cloud's final voxel downsample and statistical outlier pass,
sharded over z-slabs of a device mesh (the JAX package's
``ops/pointcloud_sharded.py``):

  1. ``shard_points_by_slab`` (host): the points split into contiguous
     z-slabs whose bounds are whole cells of the GLOBAL voxel grid, so no
     voxel spans two slots and each slot's local downsample is the global
     ``pointcloud.voxel_downsample`` (same origin, same cells);
  2. each slot voxelizes its slab on that grid (``voxel_downsample`` with
     the global origin);
  3. halo exchange: each slot's whole voxelized buffer goes to both
     z-neighbours (``ppermute``); ``halo <= thinnest slab`` (checked on the
     host) puts every neighbour of a certified row in own + prev + next;
  4. each slot's mean k-NN distance over its candidates, in blocks of at
     most 0.5 GB: a plain product (full f32, no TF32) screens the k + 8
     nearest, their exact differences pick the k; a row is certified when
     its k-th neighbour lies within ``halo``;
  5. the uncertified rows (at most ``_BAD_CAP`` a slot) are gathered on
     every slot (``all_gather``), scored exactly against each slot's
     points, and their k nearest merged across slots;
  6. Open3D's statistics over the mesh: the mean, then the variance about
     it (two passes, ``psum``), one threshold for every slot.

A cloud that cannot be slabbed raises ``SlabRefused``: too thin in z for
the slot count, wider than ``voxel_downsample``'s keys hold (2^20 - 1
cells an axis: the port's wide arm keys on int64, where the JAX package's
packed int32 keys stop at 1023), slabs thinner than the certification
radius, or more uncertified rows than the fallback holds. ``models/reconstruction._postprocess_dispatch`` catches that type
alone and runs the single-device pass.
"""
from __future__ import annotations

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.ops import registration as reg
from structured_light_for_3d_model_replication_tpu_torch.parallel import mesh as meshlib

__all__ = ["SlabRefused", "shard_points_by_slab", "postprocess_merged_sharded"]

# uncertified rows a slot hands to the exact global fallback; on voxelized
# clouds those are far outliers, far fewer than this
_BAD_CAP = 512
# candidates the product screens beyond k; exact differences pick the k
_SCREEN_EXTRA = 8
# one [rows, candidates] f32 block at most
_BLOCK_BYTES = 1 << 29
_PAD = 1e9
# cells an axis voxel_downsample's int64 keys hold (21-bit fields, clamped)
_MAX_CELLS = (1 << 20) - 1


class SlabRefused(ValueError):
    """The cloud cannot be slabbed over this mesh; the single-device pass
    is correct for it."""


def shard_points_by_slab(points, colors, valid, n_dev: int, cell: float):
    """Partition a merged cloud into ``n_dev`` z-slabs aligned to the
    global voxel grid. Returns host (pts [D, Np, 3] f32, cols [D, Np, 3]
    u8, valid [D, Np] bool, origin [3] f32, min_slab_z: the thinnest slab's
    z extent, the bound of a sound halo); Np is the largest slab padded to
    a multiple of 256."""
    pts = np.asarray(points, np.float32)
    cols = (np.asarray(colors, np.uint8) if colors is not None
            else np.zeros_like(pts, dtype=np.uint8))
    v = np.asarray(valid, bool) if valid is not None else np.ones(len(pts), bool)
    if not v.any():
        raise SlabRefused("shard_points_by_slab: empty cloud")
    cell = np.float32(cell)
    origin = pts[v].min(axis=0)   # voxel_downsample's origin
    ext = pts[v].max(axis=0) - origin
    if np.any(np.floor(ext / cell) >= _MAX_CELLS):
        raise SlabRefused(
            f"cloud spans {np.floor(ext / cell).astype(int)} voxel cells: the voxel keys "
            f"cap at {_MAX_CELLS} an axis; raise final_voxel (or crop far outliers first)")
    zc = np.floor((pts[:, 2] - origin[2]) / cell).astype(np.int64)
    zc = np.where(v, zc, 0)
    z_hi = int(zc[v].max()) + 1
    bounds = [round(i * z_hi / n_dev) for i in range(n_dev + 1)]
    if any(bounds[i + 1] == bounds[i] for i in range(n_dev)):
        raise SlabRefused(
            f"cloud spans only {z_hi} voxel cells in z: too thin to slab over {n_dev} "
            f"devices (an empty slab would break the one-slab halo); use fewer devices "
            f"or a smaller cell")
    shard_of = np.minimum(np.searchsorted(np.asarray(bounds[1:]), zc, side="right"),
                          n_dev - 1)
    counts = np.bincount(shard_of[v], minlength=n_dev)
    n_p = int(-(-max(int(counts.max()), 1) // 256) * 256)
    pts_sh = np.full((n_dev, n_p, 3), _PAD, np.float32)
    cols_sh = np.zeros((n_dev, n_p, 3), np.uint8)
    valid_sh = np.zeros((n_dev, n_p), bool)
    for d in range(n_dev):
        sel = v & (shard_of == d)
        k = int(sel.sum())
        pts_sh[d, :k] = pts[sel]
        cols_sh[d, :k] = cols[sel]
        valid_sh[d, :k] = True
    min_slab_z = float(cell) * min(bounds[i + 1] - bounds[i] for i in range(n_dev))
    return pts_sh, cols_sh, valid_sh, origin.astype(np.float32), min_slab_z


def _slab_mesh(mesh_or_devices) -> meshlib.DeviceMesh:
    """The slot line the slabs follow: a DeviceMesh's slots data-major (its
    process group kept), a device list, or a count (the attached devices
    in turn, repeated where there are fewer)."""
    if isinstance(mesh_or_devices, meshlib.DeviceMesh):
        m = mesh_or_devices
        return meshlib.DeviceMesh(list(m.devices.reshape(-1)), m.size, 1,
                                  ranks=list(m.ranks.reshape(-1)), group=m.group,
                                  rank=m.rank)
    if isinstance(mesh_or_devices, int):
        att = meshlib.attached_devices()
        devices = [att[i % len(att)] for i in range(mesh_or_devices)]
    else:
        devices = list(mesh_or_devices)
    return meshlib.make_mesh(n_data=len(devices), n_model=1, devices=devices)


def _host(x, dtype):
    if x is None:
        return None
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, dtype)


def _blocked_rows(n_rows: int, n_cols: int, cap: int = 2048) -> int:
    rows = min(cap, max(n_rows, 1))
    while rows > 64 and rows * n_cols * 4 > _BLOCK_BYTES:
        rows //= 2
    return rows


def _exact_d2(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """|q - c|^2 for q [R, 3] against c [R, K, 3] (exact differences)."""
    d = c - q[:, None, :]
    return (d * d).sum(-1)


def _knn_mean_certified(own: torch.Tensor, cand: torch.Tensor, k: int,
                        halo: float) -> torch.Tensor:
    """Mean distance of each own row (own [n, 3]) to its k nearest
    candidates (cand [m, 3], the own rows first), the row itself left out;
    +inf where the k-th lies beyond ``halo`` or fewer than k exist."""
    dev = own.device
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    n_own, n_c = own.shape[0], cand.shape[0]
    md = torch.full((n_own,), float("inf"), dtype=torch.float32, device=dev)
    if n_own == 0:
        return md
    centre = own.mean(0)
    cp = cand - centre
    cp2 = (cp * cp).sum(-1)
    ks = min(k + _SCREEN_EXTRA, n_c)
    rows = _blocked_rows(n_own, n_c)
    for s in range(0, n_own, rows):
        q = own[s:s + rows] - centre
        r = q.shape[0]
        d2 = torch.addmm((q * q).sum(-1)[:, None] + cp2[None, :], q, cp.T, alpha=-2.0)
        d2[torch.arange(r, device=dev), torch.arange(s, s + r, device=dev)] = inf  # itself
        sd2, idx = torch.topk(d2, ks, dim=1, largest=False)
        ex = torch.where(torch.isfinite(sd2), _exact_d2(own[s:s + rows], cand[idx]), inf)
        if ks < k:
            ex = torch.cat([ex, inf.expand(r, k - ks)], 1)
        kd2, _ = torch.topk(ex, k, dim=1, largest=False, sorted=True)
        m = kernels.sqrt_f32(torch.clamp_min(kd2, 0.0)).mean(1)
        md[s:s + r] = torch.where(kd2[:, -1] <= halo * halo, m, inf)
    return md


def _fallback_topk(qall: torch.Tensor, pts: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest exact d2 [R, k] (ascending, +inf short) of each row
    of ``qall`` [R, 3] over this slot's points ``pts`` [n, 3], a
    coincident point (the row itself) left out."""
    dev = pts.device
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    kk = min(k, pts.shape[0])
    out = torch.full((qall.shape[0], k), float("inf"), dtype=torch.float32, device=dev)
    if kk == 0:
        return out
    rows = _blocked_rows(qall.shape[0], pts.shape[0] * 3)
    for s in range(0, qall.shape[0], rows):
        q = qall[s:s + rows]
        d = pts[None, :, :] - q[:, None, :]
        d2 = (d * d).sum(-1)
        d2 = torch.where(d2 > 0, d2, inf)
        out[s:s + q.shape[0], :kk] = torch.topk(d2, kk, dim=1, largest=False)[0]
    return out


def postprocess_merged_sharded(mesh_or_devices, points, colors, valid, final_voxel: float,
                               outlier_nb: int = 20, outlier_std: float = 2.0,
                               halo: float | None = None):
    """Sharded final voxel + statistical outlier pass of a merged cloud.

    ``mesh_or_devices``: a DeviceMesh (its slots in data-major order), a
    device list, or a count. ``points`` [N, 3] / ``colors`` [N, 3] /
    ``valid`` [N] (None: every row) on the host or a device. Returns host
    (points [M, 3] f32, colors [M, 3] u8) of the kept voxels, slab by
    slab. Each slot's buffers keep the slab partition's fixed shape for the
    exchanges; the k-NN reads only the valid rows."""
    reg.exact_f32_products()
    mesh = _slab_mesh(mesh_or_devices)
    n_dev = mesh.size
    cell = float(final_voxel)
    pts_sh, cols_sh, valid_sh, origin, min_slab_z = shard_points_by_slab(
        _host(points, np.float32), _host(colors, np.uint8), _host(valid, bool), n_dev, cell)
    if halo is None:
        # the k-th neighbour of an interior voxel lies within a few cells
        halo = 8.0 * cell
    if n_dev > 1 and halo > min_slab_z:
        if min_slab_z < 4.0 * cell:
            raise SlabRefused(
                f"slab thickness {min_slab_z:.1f} < certification radius {4.0 * cell:.1f} "
                f"(4 cells): too many devices for this cloud's z extent; use fewer "
                f"devices or a smaller final_voxel")
        halo = min_slab_z
    k = int(outlier_nb)
    vox = [_voxelize(p[0], c[0], v[0], cell, torch.from_numpy(origin))
           for p, c, v in zip(meshlib.batch_sharding(mesh, pts_sh),
                              meshlib.batch_sharding(mesh, cols_sh),
                              meshlib.batch_sharding(mesh, valid_sh))]
    pv = [x[0] for x in vox]
    cv = [x[1] for x in vox]
    vv = [x[2] for x in vox]
    own = [p[v] for p, v in zip(pv, vv)]        # the survivors, a slot prefix
    if n_dev > 1:
        fwd = [(i, i + 1) for i in range(n_dev - 1)]
        bwd = [(i + 1, i) for i in range(n_dev - 1)]
        halo_p = zip(meshlib.ppermute(mesh, pv, fwd), meshlib.ppermute(mesh, pv, bwd))
        halo_v = zip(meshlib.ppermute(mesh, vv, fwd), meshlib.ppermute(mesh, vv, bwd))
        cands = [torch.cat([o, a[x], b[y]]) for o, (a, b), (x, y) in zip(own, halo_p, halo_v)]
    else:
        cands = own
    md = []
    for o, cand, v in zip(own, cands, vv):
        m = torch.full(v.shape, float("inf"), dtype=torch.float32, device=v.device)
        m[:o.shape[0]] = _knn_mean_certified(o, cand, k, float(halo))
        md.append(m)

    # the exact global fallback for the uncertified rows
    bad = [v & ~torch.isfinite(m) for v, m in zip(vv, md)]
    rank = [torch.cumsum(b.to(torch.int32), 0) - 1 for b in bad]
    n_over = meshlib.pmax(mesh, [torch.clamp_min(b.sum() - _BAD_CAP, 0) for b in bad])
    in_buf = [b & (r < _BAD_CAP) for b, r in zip(bad, rank)]
    qbufs, qlive = [], []
    for p, ib, r in zip(pv, in_buf, rank):
        slot = torch.where(ib, r, _BAD_CAP).long()
        q = torch.full((_BAD_CAP + 1, 3), _PAD, dtype=torch.float32, device=p.device)
        q[slot] = p
        live = torch.zeros(_BAD_CAP + 1, dtype=torch.bool, device=p.device)
        live[slot] = True
        qbufs.append(q[:_BAD_CAP])
        qlive.append(live[:_BAD_CAP])
    qall = [q.reshape(-1, 3) for q in meshlib.all_gather(mesh, qbufs)]
    lall = [x.reshape(-1) for x in meshlib.all_gather(mesh, qlive)]
    kd = []
    for q, live, o in zip(qall, lall, own):
        out = torch.full((q.shape[0], k), float("inf"), dtype=torch.float32, device=o.device)
        out[live] = _fallback_topk(q[live], o, k)
        kd.append(out)
    kd_all = meshlib.all_gather(mesh, kd)                # [D, D*CAP, k]
    for j, (slot, ka) in enumerate(zip(mesh.local_slots(), kd_all)):
        comb = ka.permute(1, 0, 2).reshape(ka.shape[1], n_dev * k)
        kd2 = torch.topk(comb, k, dim=1, largest=False, sorted=True)[0]
        md_g = kernels.sqrt_f32(torch.clamp_min(kd2, 0.0)).mean(1)
        mine = md_g[slot * _BAD_CAP:(slot + 1) * _BAD_CAP]
        md[j] = torch.where(in_buf[j], mine[torch.clamp(rank[j], 0, _BAD_CAP - 1).long()],
                            md[j])

    # Open3D's statistics over the whole mesh: the mean, then the variance about it
    ok = [v & torch.isfinite(m) for v, m in zip(vv, md)]
    cnt = [torch.clamp_min(c, 1.0) for c in
           meshlib.psum(mesh, [o.sum().to(torch.float32) for o in ok])]
    mu = [s / c for s, c in zip(meshlib.psum(mesh, [torch.where(o, m, 0.0).sum()
                                                    for o, m in zip(ok, md)]), cnt)]
    var = [s / c for s, c in zip(meshlib.psum(
        mesh, [torch.where(o, (m - u) ** 2, 0.0).sum() for o, m, u in zip(ok, md, mu)]), cnt)]
    keep = [o & (m <= u + np.float32(outlier_std) * torch.sqrt(s2))
            for o, m, u, s2 in zip(ok, md, mu, var)]
    if int(n_over[0]) > 0:
        raise SlabRefused(
            f"{int(n_over[0])} uncertified rows exceeded the per-slab exact-fallback cap "
            f"({_BAD_CAP}); a larger halo, a larger final_voxel or fewer devices "
            f"certifies more rows")
    if mesh.distributed():
        pv, cv, keep = (meshlib.all_gather(mesh, x)[0] for x in (pv, cv, keep))
        pv, cv, keep = pv.reshape(-1, 3), cv.reshape(-1, 3), keep.reshape(-1)
        return pv[keep].cpu().numpy(), cv[keep].cpu().numpy()
    return (np.concatenate([p[m].cpu().numpy() for p, m in zip(pv, keep)]),
            np.concatenate([c[m].cpu().numpy() for c, m in zip(cv, keep)]))


def _voxelize(p, c, v, cell: float, origin: torch.Tensor):
    """A slot's local step: its slab voxelized on the global grid."""
    return pc.voxel_downsample(p, c, v, cell, origin=origin)
