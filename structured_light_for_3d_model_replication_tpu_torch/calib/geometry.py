"""Calibration geometry: per-pixel camera rays + projector light-plane equations.

Given the stereo solve (K_cam, K_proj, R, T with x_proj = R x_cam + T):
  - Nc: unit view ray per camera pixel, stored [3, H*W] (float64)
  - wPlaneCol [W_proj, 4]: for each projector column, the plane through the
    projector center and the column's light sheet, in camera coordinates
  - wPlaneRow [H_proj, 4]: likewise per projector row
  - the quadratic closed form of those planes (plane_poly_coefficients)

Plain numpy in float64, the same arithmetic as the JAX package's module.
"""
from __future__ import annotations

import numpy as np

__all__ = ["camera_ray_field", "projector_planes", "build_calibration",
           "plane_poly_coefficients"]


def camera_ray_field(cam_K, height: int, width: int) -> np.ndarray:
    """Unit rays for every camera pixel as float64 [3, H*W] (reference layout)."""
    K = np.asarray(cam_K, np.float64)
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    x = (u - K[0, 2]) / K[0, 0]
    y = (v - K[1, 2]) / K[1, 1]
    rays = np.stack([x, y, np.ones_like(x)], axis=-1)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    return rays.reshape(-1, 3).T


def _planes_from_lines(a_n: np.ndarray, b_n: np.ndarray, r_inv: np.ndarray,
                       c_p: np.ndarray) -> np.ndarray:
    """Planes spanned by projector-frame directions a_n, b_n ([N,3] each)
    through the projector center c_p (camera frame) -> [N, 4] (n, d)."""
    normal = np.cross(a_n @ r_inv.T, b_n @ r_inv.T)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    d = -(normal @ c_p.reshape(3))
    return np.concatenate([normal, d[:, None]], axis=-1)


def projector_planes(proj_K, R, T, proj_width: int, proj_height: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Light-plane equations (wPlaneCol [W,4], wPlaneRow [H,4]) in camera
    frame. Column c spans the projector rays at (c, 0) and (c, H); row r
    those at (0, r) and (W, r)."""
    K = np.asarray(proj_K, np.float64)
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    r_inv = R.T
    c_p = -r_inv @ T  # projector center in camera coordinates

    c = np.arange(proj_width, dtype=np.float64)
    xc = (c - cx) / fx
    top = np.stack([xc, np.full_like(xc, (0.0 - cy) / fy), np.ones_like(xc)], axis=-1)
    bot = np.stack([xc, np.full_like(xc, (proj_height - cy) / fy), np.ones_like(xc)], axis=-1)
    plane_col = _planes_from_lines(top, bot, r_inv, c_p)

    r = np.arange(proj_height, dtype=np.float64)
    yr = (r - cy) / fy
    left = np.stack([np.full_like(yr, (0.0 - cx) / fx), yr, np.ones_like(yr)], axis=-1)
    right = np.stack([np.full_like(yr, (proj_width - cx) / fx), yr, np.ones_like(yr)], axis=-1)
    plane_row = _planes_from_lines(left, right, r_inv, c_p)
    return plane_col, plane_row


def build_calibration(cam_K, cam_dist, proj_K, R, T,
                      cam_width: int, cam_height: int,
                      proj_width: int = 1920, proj_height: int = 1080,
                      include_ray_field: bool = True) -> dict:
    """The full calibration dict in the reference's .mat layout: Nc [3,H*W],
    Oc [3,1], dc, wPlaneCol/Row stored transposed [4,N], cam_K/proj_K/R/T."""
    plane_col, plane_row = projector_planes(proj_K, R, T, proj_width, proj_height)
    calib = {
        "Oc": np.zeros((3, 1)),
        "dc": np.asarray(cam_dist, np.float64).reshape(1, -1),
        "wPlaneCol": plane_col.T,
        "wPlaneRow": plane_row.T,
        "cam_K": np.asarray(cam_K, np.float64),
        "proj_K": np.asarray(proj_K, np.float64),
        "R": np.asarray(R, np.float64),
        "T": np.asarray(T, np.float64).reshape(3, 1),
        "cam_size": np.array([cam_width, cam_height], np.int64),
    }
    if include_ray_field:
        calib["Nc"] = camera_ray_field(cam_K, cam_height, cam_width)
    return calib


def plane_poly_coefficients(proj_K, R, T, proj_width: int, proj_height: int
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Quadratic closed form of the light planes.

    The two projector-frame directions spanning column c's plane are affine
    in c, so their cross product — the unnormalized normal — is exactly
    quadratic in c (same for rows), and ray-plane intersection is invariant
    to plane scale. Returns (col_coeffs [3, 4], row_coeffs [3, 4]) float64:
    rows A, B, C of (nx, ny, nz, d); plane4(c) = A + B*c + C*c*c.
    """
    K = np.asarray(proj_K, np.float64)
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    r_inv = R.T
    c_p = -r_inv @ T

    def axis_coeffs(u_axis: bool):
        if u_axis:  # column planes: rays at (c, 0) and (c, H)
            a0 = np.array([-cx / fx, (0.0 - cy) / fy, 1.0])
            b0 = np.array([-cx / fx, (proj_height - cy) / fy, 1.0])
            step = np.array([1.0 / fx, 0.0, 0.0])
        else:       # row planes: rays at (0, r) and (W, r)
            a0 = np.array([(0.0 - cx) / fx, -cy / fy, 1.0])
            b0 = np.array([(proj_width - cx) / fx, -cy / fy, 1.0])
            step = np.array([0.0, 1.0 / fy, 0.0])
        a0, b0, s = a0 @ r_inv.T, b0 @ r_inv.T, step @ r_inv.T
        A3 = np.cross(a0, b0)
        B3 = np.cross(a0, s) + np.cross(s, b0)
        C3 = np.cross(s, s)  # = 0; kept for symmetry
        coeffs = np.stack([A3, B3, C3])
        d = -(coeffs @ c_p)
        return np.concatenate([coeffs, d[:, None]], axis=1)

    return axis_coeffs(True), axis_coeffs(False)
