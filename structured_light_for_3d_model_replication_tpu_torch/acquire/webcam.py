"""Local-webcam capture backend.

Captures with a locally attached webcam through ``cv2.VideoCapture`` instead
of the phone: the same ``capture(save_path)`` contract ``CaptureSequencer``
takes, so projector sequencing, calibration capture and auto-scan all work
with a USB camera and no phone or server. cv2 is imported by the
constructor.
"""
from __future__ import annotations

import numpy as np

__all__ = ["WebcamCapture"]


class WebcamCapture:
    """``capture(save_path)`` against a local cv2.VideoCapture device.

    Parameters: device index, requested size, and how many frames to discard
    per trigger so auto-exposure settles on the new pattern (the legacy script
    grabs several frames per capture for the same reason).
    """

    def __init__(self, device: int = 0, size: tuple[int, int] | None = None,
                 warmup_frames: int = 3):
        import cv2

        self._cv2 = cv2
        self.cap = cv2.VideoCapture(device)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open webcam device {device}")
        if size is not None:
            self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, size[0])
            self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, size[1])
        self.warmup_frames = warmup_frames

    def read(self) -> np.ndarray:
        for _ in range(self.warmup_frames):
            self.cap.grab()
        ok, frame = self.cap.read()
        if not ok:
            raise RuntimeError("webcam read failed")
        return frame

    def __call__(self, save_path: str) -> str:
        frame = self.read()
        if not self._cv2.imwrite(save_path, frame):
            raise IOError(f"failed to write {save_path}")
        return save_path

    def close(self) -> None:
        self.cap.release()

    def __enter__(self) -> "WebcamCapture":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
