"""Ray-plane triangulation: decoded projector coordinates -> colored 3D points.

  - camera rays from the stored per-pixel unit-ray field Nc, or regenerated
    from the pinhole intrinsics when Nc is absent
  - each camera ray meets the light plane of its decoded projector column:
    t = -(N . Oc + d) / (N . ray), guarded by |denom| > 1e-6
  - row_mode 0: columns only; 1: keep points within ``epipolar_tol`` (mm)
    of the decoded row plane; 2: triangulate against the row planes too and
    concatenate both clouds
  - plane_eval ``table`` gathers the stored plane equations, ``quadratic``
    evaluates the closed-form plane polynomial per pixel

Every pixel keeps its slot (fixed shape, invalidity in a mask); compaction
happens at export (``compact_cloud``). Functions take a leading view axis:
maps [..., H, W] give points [..., N, 3]. All arithmetic is float32, in the
JAX package's operation order.

``triangulate_np`` is the NumPy twin: the JAX package's ``_triangulate_impl``
with ``xp=np``, op for op, so its float32 results equal the JAX package's
``triangulate_np`` bit for bit. ``triangulate(bitexact=True)`` fetches the
(integer-exact) decode maps to the host and returns the twin's result: the
coordinates then equal the NumPy reference path by construction, where the
device arithmetic (fused or reordered) may differ in the last bits.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.calib import geometry
from structured_light_for_3d_model_replication_tpu_torch.ops.kernels import (
    sqrt_f32,
)
from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["CloudResult", "pixel_rays", "poly_from_calib", "prep_calib",
           "triangulate", "triangulate_np", "compact_cloud"]


class CloudResult(NamedTuple):
    """Fixed-shape point cloud: one slot per camera pixel (x2 for row_mode 2).
    ``colors`` is [N, 3] RGB, or [N, 1] gray (frame 0) on the scanner paths,
    replicated to RGB in ``compact_cloud``. The NumPy twin (and so the
    bit-exact arm) returns numpy arrays."""

    points: torch.Tensor  # float32 [..., N, 3] camera-frame mm
    colors: torch.Tensor  # uint8   [..., N, 3] or [..., N, 1]
    valid: torch.Tensor   # bool    [..., N]


def pixel_rays(cam_K, height: int, width: int, device=None) -> torch.Tensor:
    """Unit view rays through every pixel: x = (u - cx)/fx, y = (v - cy)/fy,
    z = 1, normalized, float32 [H*W, 3]."""
    K = torch.as_tensor(np.asarray(cam_K, np.float32), device=resolve_device(device))
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    f32 = dict(dtype=torch.float32, device=K.device)
    u = torch.arange(width, **f32)[None, :]
    v = torch.arange(height, **f32)[:, None]
    x = ((u - cx) / fx) * torch.ones((height, 1), **f32)
    y = ((v - cy) / fy) * torch.ones((1, width), **f32)
    z = torch.ones((height, width), **f32)
    inv_norm = 1.0 / sqrt_f32(x * x + y * y + z * z)
    return torch.stack([x * inv_norm, y * inv_norm, z * inv_norm], dim=-1).reshape(-1, 3)


def _plane_hit(planes, rays, oc):
    """Intersect rays [N, 3] (from oc) with per-pixel planes [..., N, 4]."""
    n_x, n_y, n_z, d = planes.unbind(-1)
    denom = n_x * rays[:, 0] + n_y * rays[:, 1] + n_z * rays[:, 2]
    numer = n_x * oc[0] + n_y * oc[1] + n_z * oc[2] + d
    ok = denom.abs() > 1e-6
    t = torch.where(ok, -numer / torch.where(ok, denom, torch.ones_like(denom)),
                    torch.zeros_like(denom))
    return t, ok


def _poly_planes(coeffs, idx, n_planes):
    """n4(i) = A + B i + C i^2 per index, rescaled to unit normals so the
    |denom| guard and the epipolar distance read as in the table path."""
    i = torch.clamp(idx, 0, n_planes - 1).to(torch.float32)[..., None]
    p = coeffs[0] + i * (coeffs[1] + i * coeffs[2])
    nrm = sqrt_f32(torch.maximum(
        p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2],
        p.new_tensor(1e-30)))
    return p / nrm[..., None]


def _triangulate_impl(col_map, row_map, mask, texture, rays, oc, plane_col,
                      plane_row, *, row_mode: int, epipolar_tol: float,
                      poly=None) -> CloudResult:
    lead = col_map.shape[:-2]
    n = col_map.shape[-2] * col_map.shape[-1]
    cols = torch.clamp(col_map.reshape(*lead, n).long(), 0, plane_col.shape[0] - 1)
    valid = mask.reshape(*lead, n)
    tex = texture.reshape(*lead, n, -1)

    pc = plane_col[cols] if poly is None else _poly_planes(poly[0], cols,
                                                           plane_col.shape[0])
    t_col, ok_col = _plane_hit(pc, rays, oc)
    p_col = oc + rays * t_col[..., None]

    if row_mode in (1, 2):
        rows = torch.clamp(row_map.reshape(*lead, n).long(), 0, plane_row.shape[0] - 1)
        pr = plane_row[rows] if poly is None else _poly_planes(poly[1], rows,
                                                               plane_row.shape[0])
    if row_mode == 0:
        return CloudResult(p_col, tex, valid & ok_col)
    if row_mode == 1:
        dist = (pr[..., 0] * p_col[..., 0] + pr[..., 1] * p_col[..., 1]
                + pr[..., 2] * p_col[..., 2] + pr[..., 3]).abs()
        return CloudResult(p_col, tex, valid & ok_col & (dist < epipolar_tol))
    if row_mode == 2:
        t_row, ok_row = _plane_hit(pr, rays, oc)
        p_row = oc + rays * t_row[..., None]
        return CloudResult(torch.cat([p_col, p_row], dim=-2),
                           torch.cat([tex, tex], dim=-2),
                           torch.cat([valid & ok_col, valid & ok_row], dim=-1))
    raise ValueError(f"row_mode must be 0, 1 or 2, got {row_mode}")


def _plane_tables(calib) -> tuple[np.ndarray, np.ndarray]:
    """(wPlaneCol [W, 4], wPlaneRow [H, 4]) f32; the .mat layout stores them
    transposed [4, N]."""
    pc = np.asarray(calib["wPlaneCol"], np.float32)
    pr = np.asarray(calib["wPlaneRow"], np.float32)
    return (pc.T if pc.shape[0] == 4 else pc), (pr.T if pr.shape[0] == 4 else pr)


def prep_calib(calib, h: int, w: int, device=None):
    """(rays [H*W, 3], oc [3], plane_col [W, 4], plane_row [H, 4]) f32
    tensors of a calibration dict; Nc is used when it matches H*W (stored
    [3, H*W] or [H*W, 3]), else regenerated from cam_K."""
    dev = resolve_device(device)
    pc, pr = _plane_tables(calib)
    nc = calib.get("Nc")
    if nc is not None:
        nc = np.asarray(nc, np.float32)
        if nc.shape[0] == 3:
            nc = nc.T
        if nc.shape[0] != h * w:
            nc = None
    rays = (pixel_rays(calib["cam_K"], h, w, dev) if nc is None
            else torch.from_numpy(np.ascontiguousarray(nc)).to(dev))
    oc = torch.from_numpy(np.asarray(calib["Oc"], np.float32).reshape(3)).to(dev)
    return rays, oc, torch.from_numpy(pc).to(dev), torch.from_numpy(pr).to(dev)


def check_plane_eval(plane_eval: str) -> None:
    if plane_eval not in ("table", "quadratic"):
        raise ValueError(
            f"plane_eval must be 'table' or 'quadratic', got {plane_eval!r}")


def _poly_coeffs(calib) -> tuple[np.ndarray, np.ndarray]:
    for k in ("proj_K", "R", "T"):
        if k not in calib:
            raise ValueError(
                f"plane_eval='quadratic' needs '{k}' in the calibration")
    pc, pr = _plane_tables(calib)
    cc, rr = geometry.plane_poly_coefficients(
        calib["proj_K"], calib["R"], calib["T"], pc.shape[0], pr.shape[0])
    return cc.astype(np.float32), rr.astype(np.float32)


def poly_from_calib(calib, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(col_coeffs [3, 4], row_coeffs [3, 4]) f32 of the quadratic plane
    form, from a calibration dict carrying proj_K/R/T."""
    dev = resolve_device(device)
    return tuple(torch.from_numpy(c).to(dev) for c in _poly_coeffs(calib))


# ---------------------------------------------------------------------------
# the NumPy twin: the JAX package's arithmetic with xp=np, op for op
# ---------------------------------------------------------------------------

def _pixel_rays_np(cam_K, height: int, width: int) -> np.ndarray:
    fx = cam_K[0, 0]
    fy = cam_K[1, 1]
    cx = cam_K[0, 2]
    cy = cam_K[1, 2]
    u = np.arange(width, dtype=np.float32)[None, :]
    v = np.arange(height, dtype=np.float32)[:, None]
    x = ((u - cx) / fx) * np.ones((height, 1), np.float32)
    y = ((v - cy) / fy) * np.ones((1, width), np.float32)
    z = np.ones((height, width), np.float32)
    inv_norm = 1.0 / np.sqrt(x * x + y * y + z * z)
    rays = np.stack([x * inv_norm, y * inv_norm, z * inv_norm], axis=-1)
    return rays.reshape(-1, 3).astype(np.float32)


def _plane_hit_np(planes, rays, oc):
    n_x, n_y, n_z, d = planes[:, 0], planes[:, 1], planes[:, 2], planes[:, 3]
    denom = n_x * rays[:, 0] + n_y * rays[:, 1] + n_z * rays[:, 2]
    numer = n_x * oc[0] + n_y * oc[1] + n_z * oc[2] + d
    ok = np.abs(denom) > 1e-6
    t = np.where(ok, -numer / np.where(ok, denom, 1.0), 0.0)
    return t, ok


def _poly_planes_np(coeffs, idx, n_planes):
    i = np.clip(idx, 0, n_planes - 1).astype(np.float32)[:, None]
    A = coeffs[0][None, :]
    B = coeffs[1][None, :]
    C = coeffs[2][None, :]
    p = A + i * (B + i * C)
    nrm = np.sqrt(np.maximum(p[:, 0] ** 2 + p[:, 1] ** 2 + p[:, 2] ** 2, 1e-30))
    return p / nrm[:, None]


def _triangulate_impl_np(col_map, row_map, mask, texture, rays, oc, plane_col,
                         plane_row, *, row_mode: int, epipolar_tol: float,
                         poly=None) -> CloudResult:
    h, w = col_map.shape
    n = h * w
    cols = np.clip(col_map.reshape(n), 0, plane_col.shape[0] - 1)
    valid = mask.reshape(n)
    tex = texture.reshape(n, -1)

    if poly is None:
        pc = plane_col[cols]
    else:
        pc = _poly_planes_np(poly[0], cols, plane_col.shape[0])
    t_col, ok_col = _plane_hit_np(pc, rays, oc)
    p_col = oc[None, :] + rays * t_col[:, None]

    if row_mode in (1, 2):
        rows = np.clip(row_map.reshape(n), 0, plane_row.shape[0] - 1)
        if poly is None:
            pr = plane_row[rows]
        else:
            pr = _poly_planes_np(poly[1], rows, plane_row.shape[0])

    if row_mode == 0:
        return CloudResult(p_col.astype(np.float32), tex, valid & ok_col)
    if row_mode == 1:
        dist = np.abs(pr[:, 0] * p_col[:, 0] + pr[:, 1] * p_col[:, 1]
                      + pr[:, 2] * p_col[:, 2] + pr[:, 3])
        ok = valid & ok_col & (dist < epipolar_tol)
        return CloudResult(p_col.astype(np.float32), tex, ok)
    if row_mode == 2:
        t_row, ok_row = _plane_hit_np(pr, rays, oc)
        p_row = oc[None, :] + rays * t_row[:, None]
        pts = np.concatenate([p_col, p_row], axis=0).astype(np.float32)
        colors = np.concatenate([tex, tex], axis=0)
        ok = np.concatenate([valid & ok_col, valid & ok_row], axis=0)
        return CloudResult(pts, colors, ok)
    raise ValueError(f"row_mode must be 0, 1 or 2, got {row_mode}")


def _prep_calib_np(calib, h: int, w: int):
    plane_col = np.asarray(calib["wPlaneCol"], np.float32)
    plane_row = np.asarray(calib["wPlaneRow"], np.float32)
    if plane_col.shape[0] == 4:
        plane_col = plane_col.T
    if plane_row.shape[0] == 4:
        plane_row = plane_row.T
    oc = np.asarray(calib["Oc"], np.float32).reshape(3)
    nc = calib.get("Nc")
    if nc is not None:
        nc = np.asarray(nc, np.float32)
        if nc.shape[0] == 3:
            nc = nc.T
        if nc.shape[0] != h * w:
            nc = None
    if nc is None:
        nc = _pixel_rays_np(np.asarray(calib["cam_K"], np.float32), h, w)
    return nc, oc, plane_col, plane_row


def triangulate_np(col_map, row_map, mask, texture, calib, row_mode: int = 1,
                   epipolar_tol: float = 2.0, plane_eval: str = "table") -> CloudResult:
    """The NumPy reference triangulation of one view's maps [H, W] (numpy
    arrays): fixed-shape output, numpy arrays, bit-equal to the JAX
    package's ``triangulate_np``."""
    check_plane_eval(plane_eval)
    h, w = col_map.shape
    rays, oc, p_col, p_row = _prep_calib_np(calib, h, w)
    poly = _poly_coeffs(calib) if plane_eval == "quadratic" else None
    return _triangulate_impl_np(col_map, row_map, mask, texture, rays, oc, p_col, p_row,
                                row_mode=row_mode, epipolar_tol=float(epipolar_tol),
                                poly=poly)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def triangulate(col_map, row_map, mask, texture, calib, row_mode: int = 1,
                epipolar_tol: float = 2.0, plane_eval: str = "table",
                device=None, bitexact: bool = False) -> CloudResult:
    """Triangulate decode maps [..., H, W] (tensors) against a calibration
    dict, on the maps' device unless ``device`` is given.

    ``bitexact``: one view's maps [H, W] are fetched to the host and go
    through ``triangulate_np`` (numpy arrays out), bit-equal to the NumPy
    reference path; needs ``plane_eval='table'``."""
    check_plane_eval(plane_eval)
    if bitexact:
        if plane_eval != "table":
            raise ValueError(
                "bitexact=True requires plane_eval='table' (the NumPy "
                "reference evaluates stored plane tables)")
        return triangulate_np(_host(col_map), _host(row_map), _host(mask),
                              _host(texture), calib, row_mode=row_mode,
                              epipolar_tol=float(epipolar_tol))
    dev = col_map.device if device is None else resolve_device(device)
    h, w = col_map.shape[-2:]
    rays, oc, p_col, p_row = prep_calib(calib, h, w, dev)
    poly = poly_from_calib(calib, dev) if plane_eval == "quadratic" else None
    return _triangulate_impl(
        col_map.to(dev), row_map.to(dev), mask.to(dev), texture.to(dev),
        rays, oc, p_col, p_row, row_mode=row_mode,
        epipolar_tol=float(epipolar_tol), poly=poly)


def compact_cloud(cloud: CloudResult) -> tuple[np.ndarray, np.ndarray]:
    """Compaction of one view: drop invalid slots (on the cloud's device,
    so only valid points are copied) -> host (points [M, 3] f32, colors
    [M, 3] u8); a gray channel is replicated to RGB after masking. A cloud
    of numpy arrays (the NumPy twin's) is masked on the host."""
    ok = cloud.valid
    if isinstance(ok, np.ndarray):
        pts, col = np.asarray(cloud.points)[ok], np.asarray(cloud.colors)[ok]
    else:
        pts = cloud.points[ok].cpu().numpy()
        col = cloud.colors[ok].cpu().numpy()
    if col.ndim == 2 and col.shape[-1] == 1:
        col = np.repeat(col, 3, axis=1)
    return pts, col
