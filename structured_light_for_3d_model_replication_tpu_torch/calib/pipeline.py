"""Projector-camera stereo calibration pipeline.

  analyze:   read the pose folders (>= 3), detect the chessboard in each
             white frame, Gray-decode the projector coordinates at every
             corner, run quick per-device calibrations and report each
             pose's reprojection errors, so bad poses can be pruned;
  calibrate: on the selected poses, solve the camera and projector
             intrinsics, bond them with a stereo solve (intrinsics fixed),
             and save the geometry the scan pipeline reads: per-pixel camera
             rays and per-column / per-row projector light planes
             (``calib/geometry.py``).

The Levenberg-Marquardt solves run on the host with OpenCV, as in the JAX
package; the corner-level decode is vectorized numpy. The same calls on the
same inputs as the JAX package's module, so both give the same observations,
solutions and ``calib.mat`` files (each package loads the other's).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from structured_light_for_3d_model_replication_tpu_torch.calib import chessboard as cb
from structured_light_for_3d_model_replication_tpu_torch.calib.geometry import (
    build_calibration,
)
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import matfile
from structured_light_for_3d_model_replication_tpu_torch.ops.graycode import (
    _n_bits,
    frames_per_view,
)

__all__ = [
    "PoseObservation",
    "CalibrationSolution",
    "decode_at_points",
    "collect_calibration_data",
    "analyze_calibration",
    "reprojection_errors",
    "select_poses",
    "calibrate_stereo",
    "calibrate_and_save",
]


class PoseObservation(NamedTuple):
    """Matched point triple for one chessboard pose: world <-> camera <-> projector."""

    name: str
    obj_pts: np.ndarray   # [N, 3] float32, board frame (z = 0)
    cam_pts: np.ndarray   # [N, 2] float32, camera pixels (sub-pixel)
    proj_pts: np.ndarray  # [N, 2] float32, decoded projector pixels


class CalibrationSolution(NamedTuple):
    cam_K: np.ndarray
    cam_dist: np.ndarray
    proj_K: np.ndarray
    proj_dist: np.ndarray
    R: np.ndarray          # x_proj = R @ x_cam + T
    T: np.ndarray
    rms_stereo: float
    rms_cam: float
    rms_proj: float
    img_shape: tuple[int, int]   # camera (width, height)
    proj_shape: tuple[int, int]  # projector (width, height)


def decode_at_points(pattern_frames: np.ndarray, points_xy: np.ndarray,
                     n_bits_col: int, n_bits_row: int) -> tuple[np.ndarray, np.ndarray]:
    """Gray-decode projector (col, row) at sparse camera pixels.

    ``pattern_frames``: [2*(n_bits_col+n_bits_row), H, W] — the pattern/inverse
    pairs of one pose, white/black frames already stripped (the capture-file
    contract of ops.graycode.generate_pattern_stack). ``points_xy``: [N, 2]
    float pixel coords.

    All bits x all corners resolve in one vectorized compare + prefix-XOR
    pass; the coordinates truncate to the pixel (``astype(np.intp)``).
    """
    x = points_xy[:, 0].astype(np.intp)
    y = points_xy[:, 1].astype(np.intp)
    h, w = pattern_frames.shape[1:]
    x = np.clip(x, 0, w - 1)
    y = np.clip(y, 0, h - 1)
    vals = pattern_frames[:, y, x].astype(np.int16)  # [F, N]
    pat, inv = vals[0::2], vals[1::2]
    gray = (pat > inv)                                # [bits, N] MSB first

    def axis_value(bits: np.ndarray) -> np.ndarray:
        binary = np.bitwise_xor.accumulate(bits.astype(np.int64), axis=0)
        weights = 1 << np.arange(bits.shape[0] - 1, -1, -1, dtype=np.int64)
        return (binary * weights[:, None]).sum(axis=0).astype(np.float64)

    col = axis_value(gray[:n_bits_col])
    row = axis_value(gray[n_bits_col : n_bits_col + n_bits_row])
    return col, row


def collect_calibration_data(
    base_dir: str,
    pose_list: list[str] | None = None,
    board: cb.BoardSpec = cb.BoardSpec(),
    proj_size: tuple[int, int] = (1920, 1080),
    save_previews: bool = True,
    log=print,
) -> tuple[list[PoseObservation], tuple[int, int]]:
    """Detect + decode every usable pose folder under ``base_dir``.

    Each pose folder holds one capture sequence (white, black, then
    pattern/inverse pairs — 46 files at 1080p). Returns the observations and the
    camera image size (width, height). Poses without a detectable board or with
    an incomplete sequence are skipped with a log line, mirroring the
    per-pose tolerance of the capture flow.
    """
    if pose_list is None:
        pose_list = sorted(
            d for d in os.listdir(base_dir)
            if os.path.isdir(os.path.join(base_dir, d)) and d != "corners_preview"
        )
    obj = cb.board_object_points(board)
    n_bits_col, n_bits_row = _n_bits(proj_size[0]), _n_bits(proj_size[1])
    need = frames_per_view(proj_size[0], proj_size[1])

    observations: list[PoseObservation] = []
    img_shape: tuple[int, int] | None = None
    for pose in pose_list:
        path = os.path.join(base_dir, pose)
        try:
            files = imio.list_frame_files(path)
        except (FileNotFoundError, NotADirectoryError):
            log(f"[calib] {pose}: not a pose folder, skipped")
            continue
        if len(files) < need:
            log(f"[calib] {pose}: {len(files)} frames < {need} required, skipped")
            continue
        white = imio.load_color(files[0])
        if img_shape is None:
            img_shape = (white.shape[1], white.shape[0])
        corners = cb.find_corners(white, board)
        if corners is None:
            log(f"[calib] {pose}: chessboard not found, skipped")
            continue
        if save_previews:
            preview_dir = os.path.join(base_dir, "corners_preview")
            os.makedirs(preview_dir, exist_ok=True)
            imio.save_image(os.path.join(preview_dir, f"{pose}.png"),
                            cb.draw_corner_preview(white, corners, board))
        patterns = np.stack(
            [imio.load_gray(f) for f in files[2 : need]], axis=0
        )
        col, row = decode_at_points(patterns, corners, n_bits_col, n_bits_row)
        proj_pts = np.column_stack([col, row]).astype(np.float32)
        observations.append(PoseObservation(pose, obj, corners, proj_pts))
    if img_shape is None:
        raise ValueError(f"no usable calibration poses under {base_dir}")
    return observations, img_shape


def _cv2_pts(points_2d: np.ndarray) -> np.ndarray:
    return points_2d.reshape(-1, 1, 2).astype(np.float32)


def reprojection_errors(observations: list[PoseObservation],
                        img_shape: tuple[int, int],
                        proj_size: tuple[int, int] = (1920, 1080),
                        ) -> dict[str, tuple[float, float]]:
    """Per-pose (camera_err, projector_err) in px via quick independent solves.

    True per-pose RMS of the back-projected board corners — the number the
    operator prunes poses with, comparable with the <0.5/<1.0 px quality bands
    (``calib/inspect.py``); RMS keeps the bands meaningful whatever the
    board size.
    """
    import cv2

    obj = [o.obj_pts for o in observations]
    cam = [_cv2_pts(o.cam_pts) for o in observations]
    proj = [_cv2_pts(o.proj_pts) for o in observations]
    _, mc, dc, rvc, tvc = cv2.calibrateCamera(obj, cam, img_shape, None, None)
    _, mp, dp, rvp, tvp = cv2.calibrateCamera(obj, proj, proj_size, None, None)

    errors: dict[str, tuple[float, float]] = {}
    for i, o in enumerate(observations):
        back_c, _ = cv2.projectPoints(o.obj_pts, rvc[i], tvc[i], mc, dc)
        back_p, _ = cv2.projectPoints(o.obj_pts, rvp[i], tvp[i], mp, dp)
        err_c = float(np.sqrt(np.mean(np.sum((cam[i] - back_c) ** 2, axis=-1))))
        err_p = float(np.sqrt(np.mean(np.sum((proj[i] - back_p) ** 2, axis=-1))))
        errors[o.name] = (err_c, err_p)
    return errors


def analyze_calibration(base_dir: str,
                        board: cb.BoardSpec = cb.BoardSpec(),
                        proj_size: tuple[int, int] = (1920, 1080),
                        log=print):
    """Step-2 analysis: decode all poses, return per-pose errors for pruning.

    Requires >= 3 usable poses for the stereo geometry to be determined
    (the stereo geometry is not determined by fewer).
    """
    observations, img_shape = collect_calibration_data(
        base_dir, board=board, proj_size=proj_size, log=log
    )
    if len(observations) < 3:
        raise ValueError(
            f"need at least 3 usable calibration poses, found {len(observations)}"
        )
    errors = reprojection_errors(observations, img_shape, proj_size)
    return errors, observations, img_shape


def select_poses(errors: dict[str, tuple[float, float]],
                 max_cam_err: float = 1.0,
                 max_proj_err: float = 2.0) -> list[str]:
    """Automatic pose pruning: keep poses under both error ceilings, else
    the three best-scoring poses."""
    keep = [p for p, (ec, ep) in errors.items()
            if ec <= max_cam_err and ep <= max_proj_err]
    if len(keep) >= 3:
        return keep
    # fewer than 3 survived the ceilings: fall back to the 3 best-scoring poses
    return sorted(errors, key=lambda p: sum(errors[p]))[:3]


def calibrate_stereo(observations: list[PoseObservation],
                     img_shape: tuple[int, int],
                     proj_size: tuple[int, int] = (1920, 1080),
                     log=print) -> CalibrationSolution:
    """Camera solve + projector-as-camera solve + stereo bond (intrinsics fixed),
    a three-stage scheme."""
    import cv2

    obj = [o.obj_pts for o in observations]
    cam = [_cv2_pts(o.cam_pts) for o in observations]
    proj = [_cv2_pts(o.proj_pts) for o in observations]
    log(f"[calib] solving camera intrinsics over {len(obj)} poses...")
    rms_c, mc, dc, _, _ = cv2.calibrateCamera(obj, cam, img_shape, None, None)
    log(f"[calib] camera RMS {rms_c:.4f} px; solving projector intrinsics...")
    rms_p, mp, dp, _, _ = cv2.calibrateCamera(obj, proj, proj_size, None, None)
    log(f"[calib] projector RMS {rms_p:.4f} px; stereo solve...")
    rms_s, K1, D1, K2, D2, R, T, _, _ = cv2.stereoCalibrate(
        obj, cam, proj, mc, dc, mp, dp, img_shape,
        flags=cv2.CALIB_FIX_INTRINSIC,
    )
    log(f"[calib] stereo RMS {rms_s:.4f} px")
    return CalibrationSolution(
        cam_K=K1, cam_dist=D1, proj_K=K2, proj_dist=D2, R=R, T=T,
        rms_stereo=float(rms_s), rms_cam=float(rms_c), rms_proj=float(rms_p),
        img_shape=img_shape, proj_shape=proj_size,
    )


def calibrate_and_save(base_dir: str, output_file: str,
                       selected_poses: list[str] | None = None,
                       board: cb.BoardSpec = cb.BoardSpec(),
                       proj_size: tuple[int, int] = (1920, 1080),
                       include_ray_field: bool = True,
                       observations: list[PoseObservation] | None = None,
                       img_shape: tuple[int, int] | None = None,
                       log=print) -> CalibrationSolution:
    """Full final calibration: decode selected poses, stereo solve, build the
    ray field + light-plane tables, save the .mat-layout calibration file
    (the end-to-end job of ``calibrate``).

    Pass the ``observations`` + ``img_shape`` that ``analyze_calibration``
    already produced to skip re-reading and re-decoding every pose from disk;
    ``selected_poses`` then filters that list by name.
    """
    if observations is not None and img_shape is not None:
        if selected_poses is not None:
            names = set(selected_poses)
            observations = [o for o in observations if o.name in names]
    else:
        observations, img_shape = collect_calibration_data(
            base_dir, selected_poses, board=board, proj_size=proj_size, log=log
        )
    if len(observations) < 3:
        raise ValueError(
            f"need at least 3 usable calibration poses, found {len(observations)}"
        )
    sol = calibrate_stereo(observations, img_shape, proj_size, log=log)
    calib = build_calibration(
        sol.cam_K, sol.cam_dist, sol.proj_K, sol.R, sol.T,
        cam_width=img_shape[0], cam_height=img_shape[1],
        proj_width=proj_size[0], proj_height=proj_size[1],
        include_ray_field=include_ray_field,
    )
    matfile.save_calibration(output_file, calib)
    log(f"[calib] saved {output_file} (stereo RMS {sol.rms_stereo:.4f} px)")
    return sol
