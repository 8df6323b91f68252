"""The sharded multi-view scan step (the JAX package's ``parallel/scan.py``).

Each mesh slot decodes and triangulates its (views, pixel rows) block of a
[V, F, H, W] stack on its device, through the decode kernel; then ``psum``,
``pmin`` and ``pmax`` over the whole mesh give every slot the global cloud
statistics the merge reads: the valid count, the centroid and the bounding
box.
"""
from __future__ import annotations

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import graycode
from structured_light_for_3d_model_replication_tpu_torch.ops import triangulate as tri
from structured_light_for_3d_model_replication_tpu_torch.parallel import mesh as meshlib

__all__ = ["build_sharded_scan_step"]


def build_sharded_scan_step(mesh: meshlib.DeviceMesh, *, proj_size, n_sets_col: int = 11,
                            n_sets_row: int = 11, row_mode: int = 1,
                            epipolar_tol: float = 2.0, downsample: int = 1):
    """Returns ``step(frames_v, rays_hw, oc, plane_col, plane_row, shadow_v,
    contrast_v) -> (CloudResult [V, H*W (x2)], stats)``.

    Frames [V, F, H, W] split views over ``data`` and rows over ``model``
    (each block a contiguous copy on its slot's device); the ray field
    [H, W, 3] splits with the rows; Oc and the plane tables are replicated.
    The cloud is this process's blocks assembled (in one process, the whole
    batch) on the first slot's device, row blocks side by side (with
    row_mode 2 each block holds its column hits, then its row hits, as the
    JAX package's ``shard_map`` output does); ``stats`` (``n_valid``,
    ``centroid``, ``bb_min``, ``bb_max``) are global, on that device too.
    """
    pw, ph = proj_size

    def step(frames_v, rays_hw, oc, plane_col, plane_row, shadow_v, contrast_v):
        frames = meshlib.view_sharding(mesh, frames_v)
        rays = meshlib.shard_rows(mesh, rays_hw, axis=0)
        thr_all = torch.from_numpy(np.stack(
            [np.asarray(torch.as_tensor(shadow_v).cpu(), np.float32),
             np.asarray(torch.as_tensor(contrast_v).cpu(), np.float32)], 1))
        n_data, n_model = mesh.devices.shape
        per_v = thr_all.shape[0] // n_data
        plan = graycode.decode_plan(frames[0].shape[1], n_cols=pw, n_rows=ph,
                                    n_sets_col=n_sets_col, n_sets_row=n_sets_row,
                                    downsample=downsample)
        clouds = []
        for k, (slot, dev) in enumerate(zip(mesh.local_slots(), mesh.local_devices())):
            f = frames[k]
            i = slot // n_model
            t = thr_all[i * per_v:(i + 1) * per_v].to(dev)
            col, row, mask = graycode.decode_views(f, t, plan)
            clouds.append(tri._triangulate_impl(
                col, row, mask, f[:, 0, ..., None], rays[k].reshape(-1, 3),
                torch.as_tensor(oc).to(dev), torch.as_tensor(plane_col).to(dev),
                torch.as_tensor(plane_row).to(dev), row_mode=row_mode,
                epipolar_tol=epipolar_tol))
        big = torch.tensor(1e30, dtype=torch.float32)
        n_valid = meshlib.psum(mesh, [c.valid.to(torch.float32).sum() for c in clouds])
        sums = meshlib.psum(mesh, [(c.points * c.valid[..., None]).sum((0, 1))
                                   for c in clouds])
        bb_min = meshlib.pmin(mesh, [torch.where(c.valid[..., None], c.points,
                                                 big.to(c.points.device)).amin((0, 1))
                                     for c in clouds])
        bb_max = meshlib.pmax(mesh, [torch.where(c.valid[..., None], c.points,
                                                 -big.to(c.points.device)).amax((0, 1))
                                     for c in clouds])
        stats = {"n_valid": n_valid[0],
                 "centroid": sums[0] / torch.clamp_min(n_valid[0], 1.0),
                 "bb_min": bb_min[0], "bb_max": bb_max[0]}
        return _assemble(mesh, clouds), stats

    return step


def _assemble(mesh: meshlib.DeviceMesh, clouds) -> tri.CloudResult:
    """This process's blocks back into [V, pixels]: the row blocks of a
    view group side by side, the view groups stacked."""
    n_model = mesh.devices.shape[1]
    dev = clouds[0].points.device
    groups: dict[int, list] = {}
    for slot, c in zip(mesh.local_slots(), clouds):
        groups.setdefault(slot // n_model, []).append(c)
    parts = []
    for i in sorted(groups):
        blocks = groups[i]
        parts.append(tri.CloudResult(*(meshlib.gather_shards([getattr(b, f) for b in blocks],
                                                             dev, dim=1)
                                       for f in ("points", "colors", "valid"))))
    return tri.CloudResult(*(torch.cat([getattr(p, f) for p in parts])
                             for f in ("points", "colors", "valid")))
