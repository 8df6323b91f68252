"""Projector display: fullscreen pattern presentation on the second monitor.

An OpenCV window is placed at the projector's screen offset and forced
fullscreen; each pattern is shown with a settle delay before the capture
triggers. A virtual backend records the frames for headless runs and tests.
The JAX package's classes and factory, unchanged.
"""
from __future__ import annotations

import time

import numpy as np

__all__ = ["OpenCVProjector", "VirtualProjector", "open_projector"]


class OpenCVProjector:
    """Real projector output via an OpenCV fullscreen window (cv2-gated)."""

    WINDOW = "slscan-projector"

    def __init__(self, screen_offset_x: int = 1920, width: int = 1920,
                 height: int = 1080):
        import cv2

        self._cv2 = cv2
        self.size = (width, height)
        cv2.namedWindow(self.WINDOW, cv2.WINDOW_NORMAL)
        cv2.moveWindow(self.WINDOW, screen_offset_x, 0)
        cv2.setWindowProperty(
            self.WINDOW, cv2.WND_PROP_FULLSCREEN, cv2.WINDOW_FULLSCREEN
        )

    def show(self, frame: np.ndarray, settle_ms: int = 200) -> None:
        """Display one pattern and block for the projector settle time."""
        self._cv2.imshow(self.WINDOW, np.asarray(frame, np.uint8))
        self._cv2.waitKey(max(1, int(settle_ms)))

    def close(self) -> None:
        self._cv2.destroyWindow(self.WINDOW)


class VirtualProjector:
    """Headless backend: records every shown frame (tests, dry runs)."""

    def __init__(self, width: int = 1920, height: int = 1080,
                 realtime: bool = False):
        self.size = (width, height)
        self.realtime = realtime
        self.shown: list[np.ndarray] = []
        self.settle_log: list[int] = []

    def show(self, frame: np.ndarray, settle_ms: int = 200) -> None:
        self.shown.append(np.asarray(frame, np.uint8).copy())
        self.settle_log.append(int(settle_ms))
        if self.realtime:
            time.sleep(settle_ms / 1000.0)

    def close(self) -> None:
        pass


def open_projector(kind: str = "auto", screen_offset_x: int = 1920,
                   width: int = 1920, height: int = 1080):
    """Factory: ``opencv``, ``virtual``, or ``auto`` (opencv when importable +
    a display exists, else virtual)."""
    if kind == "opencv":
        return OpenCVProjector(screen_offset_x, width, height)
    if kind == "virtual":
        return VirtualProjector(width, height)
    if kind == "auto":
        try:
            return OpenCVProjector(screen_offset_x, width, height)
        except Exception:
            return VirtualProjector(width, height)
    raise ValueError(f"unknown projector kind: {kind}")
