"""Chessboard corner detection for projector-camera calibration.

The white frame of each calibration pose is contrast-enhanced (Gaussian blur
+ CLAHE), the inner-corner grid is located on that image, the corners are
refined to sub-pixel accuracy on the raw grayscale, and an annotated preview
is drawn for the operator. OpenCV supplies the detector; without cv2 every
function here raises (``_require_cv2``). The same calls, in the same order,
as the JAX package's module, so both give the same corners.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = [
    "BoardSpec",
    "board_object_points",
    "find_corners",
    "draw_corner_preview",
]


def _require_cv2():
    try:
        import cv2
    except ImportError as e:  # pragma: no cover - environment dependent
        raise RuntimeError(
            "chessboard detection requires OpenCV (cv2); install opencv-python "
            "or use precomputed corner files"
        ) from e
    return cv2


class BoardSpec(NamedTuple):
    """Inner-corner grid of the calibration chessboard."""

    rows: int = 7
    cols: int = 7
    square_size: float = 35.0  # mm


def board_object_points(board: BoardSpec) -> np.ndarray:
    """World coordinates of the inner corners, z=0 plane, row-major [N, 3] float32.

    The JAX package's mgrid layout, so the two packages' observations match.
    """
    obj = np.zeros((board.rows * board.cols, 3), np.float32)
    obj[:, :2] = np.mgrid[0 : board.rows, 0 : board.cols].T.reshape(-1, 2)
    return obj * board.square_size


def enhance_for_detection(gray: np.ndarray) -> np.ndarray:
    """Blur + CLAHE contrast pull, the detection preprocessing."""
    cv2 = _require_cv2()
    blurred = cv2.GaussianBlur(gray, (5, 5), 0)
    clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    return clahe.apply(blurred)


def find_corners(image: np.ndarray, board: BoardSpec,
                 refine: bool = True) -> np.ndarray | None:
    """Locate the board's inner corners in a white-frame image.

    Returns sub-pixel corner coordinates [N, 2] float32 (N = rows*cols) or None
    when no complete grid is found. Detection runs on the enhanced image but the
    sub-pixel refinement runs on the raw grayscale — CLAHE shifts local
    extrema.
    """
    cv2 = _require_cv2()
    if image.ndim == 3:
        # io.images normalizes to RGB at the IO boundary, so use RGB weights
        gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
    else:
        gray = image
    ok, corners = cv2.findChessboardCorners(
        enhance_for_detection(gray), (board.rows, board.cols), None
    )
    if not ok:
        return None
    if refine:
        corners = cv2.cornerSubPix(
            gray, corners, (11, 11), (-1, -1),
            (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 0.001),
        )
    return corners.reshape(-1, 2).astype(np.float32)


def draw_corner_preview(image: np.ndarray, corners: np.ndarray,
                        board: BoardSpec) -> np.ndarray:
    """Annotated copy of ``image`` with the detected grid drawn on it."""
    cv2 = _require_cv2()
    preview = image.copy()
    if preview.ndim == 2:
        preview = cv2.cvtColor(preview, cv2.COLOR_GRAY2BGR)
    cv2.drawChessboardCorners(
        preview, (board.rows, board.cols),
        corners.reshape(-1, 1, 2).astype(np.float32), True,
    )
    return preview
