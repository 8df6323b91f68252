"""Projector-camera stereo calibration.

  chessboard   corner detection + board geometry (OpenCV required)
  pipeline     analyze / prune / solve / save end-to-end calibration
  geometry     ray field + projector light-plane construction (batched)
  undistort    Brown-Conrady undistortion in PyTorch (map + batched remap)
  inspect      readable geometry summary + quality bands
  visualize    3-D rig plot to a PNG (matplotlib, imported when called)
"""
from structured_light_for_3d_model_replication_tpu_torch.calib.geometry import (  # noqa: F401
    build_calibration,
    camera_ray_field,
    projector_planes,
)
from structured_light_for_3d_model_replication_tpu_torch.calib.chessboard import (  # noqa: F401
    BoardSpec,
    board_object_points,
    find_corners,
)
from structured_light_for_3d_model_replication_tpu_torch.calib.inspect import (  # noqa: F401
    format_summary,
    quality_band,
    summarize_calibration,
)
