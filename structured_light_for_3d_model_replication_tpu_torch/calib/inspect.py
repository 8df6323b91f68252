"""Calibration inspection: a readable geometry summary and quality bands.

Focal lengths, principal points, the camera-projector baseline, the relative
rotation as Euler angles, the distortion strength, and the reprojection
error's band (< 0.5 px EXCELLENT, < 1.0 px GOOD, else POOR). The same text
as the JAX package's ``inspect-calib``.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "euler_angles_deg",
    "quality_band",
    "summarize_calibration",
    "format_summary",
]

QUALITY_BANDS = ((0.5, "EXCELLENT"), (1.0, "GOOD"))


def quality_band(reprojection_error_px: float) -> str:
    """Reference quality bands for a reprojection error in pixels."""
    for limit, label in QUALITY_BANDS:
        if reprojection_error_px < limit:
            return label
    return "POOR"


def euler_angles_deg(R: np.ndarray) -> tuple[float, float, float]:
    """ZYX (yaw-pitch-roll) Euler decomposition of a rotation matrix, degrees.

    The convention of the calibration plot's readout (``calib/visualize.py``).
    """
    R = np.asarray(R, np.float64)
    sy = float(np.hypot(R[0, 0], R[1, 0]))
    if sy > 1e-6:
        roll = np.arctan2(R[2, 1], R[2, 2])
        pitch = np.arctan2(-R[2, 0], sy)
        yaw = np.arctan2(R[1, 0], R[0, 0])
    else:  # gimbal lock
        roll = np.arctan2(-R[1, 2], R[1, 1])
        pitch = np.arctan2(-R[2, 0], sy)
        yaw = 0.0
    return tuple(float(np.degrees(a)) for a in (roll, pitch, yaw))


def _intrinsics(K: np.ndarray) -> dict:
    K = np.asarray(K, np.float64)
    return {
        "fx": float(K[0, 0]),
        "fy": float(K[1, 1]),
        "cx": float(K[0, 2]),
        "cy": float(K[1, 2]),
    }


def summarize_calibration(calib: dict,
                          reprojection_error_px: float | None = None) -> dict:
    """Structured geometry summary of a saved calibration dict (.mat layout)."""
    R = np.asarray(calib["R"], np.float64)
    T = np.asarray(calib["T"], np.float64).reshape(3)
    dist = np.asarray(calib.get("dc", np.zeros(5)), np.float64).reshape(-1)
    baseline = float(np.linalg.norm(T))
    proj_center_cam = (-R.T @ T).reshape(3)
    roll, pitch, yaw = euler_angles_deg(R)
    out = {
        "camera": _intrinsics(calib["cam_K"]),
        "projector": _intrinsics(calib["proj_K"]),
        "baseline_mm": baseline,
        "projector_center_cam_mm": proj_center_cam.tolist(),
        "euler_deg": {"roll": roll, "pitch": pitch, "yaw": yaw},
        "distortion": dist.tolist(),
        "distortion_strength": float(np.abs(dist).sum()),
    }
    if "wPlaneCol" in calib:
        out["n_planes_col"] = int(np.asarray(calib["wPlaneCol"]).shape[-1])
    if "wPlaneRow" in calib:
        out["n_planes_row"] = int(np.asarray(calib["wPlaneRow"]).shape[-1])
    if reprojection_error_px is not None:
        out["reprojection_error_px"] = float(reprojection_error_px)
        out["quality"] = quality_band(float(reprojection_error_px))
    return out


def format_summary(summary: dict) -> str:
    """Render the summary as the operator-facing report text."""
    cam, proj = summary["camera"], summary["projector"]
    e = summary["euler_deg"]
    lines = [
        "=== Calibration summary ===",
        f"camera:    fx={cam['fx']:.2f} fy={cam['fy']:.2f} "
        f"cx={cam['cx']:.2f} cy={cam['cy']:.2f}",
        f"projector: fx={proj['fx']:.2f} fy={proj['fy']:.2f} "
        f"cx={proj['cx']:.2f} cy={proj['cy']:.2f}",
        f"baseline:  {summary['baseline_mm']:.2f} mm",
        f"rotation:  roll={e['roll']:.2f} pitch={e['pitch']:.2f} "
        f"yaw={e['yaw']:.2f} deg",
        f"distortion strength: {summary['distortion_strength']:.4f}",
    ]
    if "reprojection_error_px" in summary:
        lines.append(
            f"reprojection error: {summary['reprojection_error_px']:.4f} px "
            f"[{summary['quality']}]"
        )
    return "\n".join(lines)
