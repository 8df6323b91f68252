"""Acquisition: everything between the pipeline and the physical rig.

  server     HTTP capture rendezvous (phone long-poll + upload), stdlib-only
  sequencer  Gray-code pattern sequence -> numbered frame files per pose
  projector  fullscreen pattern display (OpenCV) + virtual backend
  turntable  serial stepper protocol + simulation/loopback backends
  android    client for the Android camera-host pull API
  webcam     local cv2.VideoCapture capture backend
  autoscan   the 360-degree turntable sweep orchestrator
  viewer     operator web viewer for per-stage artifacts + StageRecorder
"""
from structured_light_for_3d_model_replication_tpu_torch.acquire.autoscan import (  # noqa: F401
    auto_scan_360,
    view_folder_name,
)
from structured_light_for_3d_model_replication_tpu_torch.acquire.sequencer import (  # noqa: F401
    CaptureSequencer,
)
from structured_light_for_3d_model_replication_tpu_torch.acquire.server import (  # noqa: F401
    CaptureServer,
    CaptureTimeout,
)
from structured_light_for_3d_model_replication_tpu_torch.acquire.turntable import (  # noqa: F401
    LoopbackTurntable,
    SerialTurntable,
    SimulatedTurntable,
    open_turntable,
)
from structured_light_for_3d_model_replication_tpu_torch.acquire.viewer import (  # noqa: F401
    StageRecorder,
    ViewerServer,
)
