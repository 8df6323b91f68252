"""Calibration geometry plot.

A 3-D rig plot rendered to a PNG: the camera at the origin, the projector
posed by R/T, both frusta, the baseline, the Euler-angle readout, and a few
light-plane traces, so a bad stereo solve shows at a glance
(``inspect-calib --plot``). matplotlib is imported inside ``plot_rig``.
"""
from __future__ import annotations

import numpy as np

from structured_light_for_3d_model_replication_tpu_torch.calib.inspect import (
    euler_angles_deg,
)

__all__ = ["plot_rig", "frustum_corners"]


def frustum_corners(K: np.ndarray, width: int, height: int,
                    depth: float) -> np.ndarray:
    """[4, 3] camera-frame corners of the image plane pushed to ``depth``."""
    K = np.asarray(K, np.float64)
    pts = []
    for u, v in ((0, 0), (width, 0), (width, height), (0, height)):
        x = (u - K[0, 2]) / K[0, 0]
        y = (v - K[1, 2]) / K[1, 1]
        pts.append((x * depth, y * depth, depth))
    return np.asarray(pts)


def plot_rig(calib: dict, out_path: str, depth: float = 300.0,
             n_planes: int = 6) -> dict:
    """Render the rig to ``out_path`` (PNG). Returns the numeric summary
    (baseline mm, Euler angles) printed beside the plot."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    R = np.asarray(calib["R"], np.float64)
    T = np.asarray(calib["T"], np.float64).reshape(3)
    cam_K = np.asarray(calib["cam_K"], np.float64)
    proj_K = np.asarray(calib["proj_K"], np.float64)
    pc = np.asarray(calib["wPlaneCol"], np.float64)
    if pc.shape[0] == 4:
        pc = pc.T

    # projector pose in the camera frame: x_p = R x_c + T -> center at -R^T T
    r_inv = R.T
    proj_center = -r_inv @ T
    baseline = float(np.linalg.norm(T))
    euler = euler_angles_deg(R)

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")

    def draw_frustum(center, rot, K, w, h, color, label):
        corners = frustum_corners(K, w, h, depth) @ rot.T + center
        for c in corners:
            ax.plot(*zip(center, c), color=color, lw=0.8)
        loop = np.vstack([corners, corners[:1]])
        ax.plot(loop[:, 0], loop[:, 1], loop[:, 2], color=color, lw=1.2,
                label=label)

    cam_wh = (int(2 * cam_K[0, 2]) or 1920, int(2 * cam_K[1, 2]) or 1080)
    proj_wh = (pc.shape[0], int(2 * proj_K[1, 2]) or 1080)
    draw_frustum(np.zeros(3), np.eye(3), cam_K, *cam_wh,
                 color="#1d4ed8", label="camera")
    draw_frustum(proj_center, r_inv, proj_K, *proj_wh,
                 color="#e5484d", label="projector")
    ax.plot(*zip(np.zeros(3), proj_center), "k--", lw=1,
            label=f"baseline {baseline:.1f} mm")

    # a few light planes: intersect plane normals with the viewing volume by
    # drawing the projector ray fan at sampled columns
    for ci in np.linspace(0, pc.shape[0] - 1, n_planes, dtype=int):
        n4 = pc[ci]
        # draw the plane's trace: points at depth where n . p + d = 0
        xs = np.linspace(-0.4 * depth, 0.4 * depth, 2)
        for z in (0.6 * depth, depth):
            # solve n_x x + n_y y + n_z z + d = 0 for y over xs
            if abs(n4[1]) < 1e-9:
                continue
            ys = -(n4[0] * xs + n4[2] * z + n4[3]) / n4[1]
            ax.plot(xs, ys, [z, z], color="#f59e0b", lw=0.5, alpha=0.6)

    ax.set_xlabel("x (mm)")
    ax.set_ylabel("y (mm)")
    ax.set_zlabel("z (mm)")
    ax.set_title(f"baseline {baseline:.1f} mm | "
                 f"euler xyz {euler[0]:.1f}/{euler[1]:.1f}/{euler[2]:.1f} deg")
    ax.legend(loc="upper left", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return {"baseline_mm": baseline, "euler_deg": euler, "plot": out_path}
