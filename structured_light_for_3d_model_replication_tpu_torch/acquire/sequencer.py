"""Capture sequencer: project the Gray-code stack and collect one frame each.

A scan of a 1920x1080 projector is 46 frames (white, black, then a
pattern/inverse pair for each of 11 column bits and 11 row bits), written to
a pose folder as ``01.png``..``46.png``. Calibration capture repeats the
sequence once a chessboard pose with a longer settle. The capture trigger is
any callable ``(save_path) -> None``: the HTTP rendezvous
(``CaptureServer.trigger_capture``), the Android host client, a webcam. With
``pack_frames`` a scan's folder is packed to ``frames.slbp`` as soon as its
frames land (the ``frame.pack`` fault site fires first).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Sequence

import numpy as np

from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc

__all__ = ["CaptureSequencer", "scan_frame_names"]

CaptureFn = Callable[[str], object]


def scan_frame_names(n_frames: int, ext: str = "png") -> list[str]:
    """The numbered-file contract: 01.png, 02.png, ..."""
    return [f"{i + 1:02d}.{ext}" for i in range(n_frames)]


class CaptureSequencer:
    """Drives projector + camera through one full pattern sequence per pose."""

    def __init__(self, projector, capture: CaptureFn,
                 proj_size: tuple[int, int] = (1920, 1080),
                 brightness: int = 200, downsample: int = 1,
                 scan_settle_ms: int = 200, calib_settle_ms: int = 250,
                 pack_frames: bool = False, pack_keep_raw: bool = False,
                 log=print):
        self.projector = projector
        self.capture = capture
        self.proj_size = proj_size
        self.brightness = brightness
        self.downsample = downsample
        self.scan_settle_ms = scan_settle_ms
        self.calib_settle_ms = calib_settle_ms
        self.pack_frames = pack_frames
        self.pack_keep_raw = pack_keep_raw
        self.log = log
        self._patterns: np.ndarray | None = None

    @property
    def patterns(self) -> np.ndarray:
        if self._patterns is None:
            self._patterns = gc.generate_pattern_stack(
                self.proj_size[0], self.proj_size[1],
                brightness=self.brightness, downsample=self.downsample,
            )
        return self._patterns

    def capture_sequence(self, save_dir: str, settle_ms: int,
                         progress: Callable[[int, int], None] | None = None
                         ) -> list[str]:
        """Project every frame, capturing each to its numbered file."""
        os.makedirs(save_dir, exist_ok=True)
        frames = self.patterns
        names = scan_frame_names(frames.shape[0])
        paths = []
        t0 = time.monotonic()
        for i, (frame, name) in enumerate(zip(frames, names)):
            self.projector.show(frame, settle_ms)
            path = os.path.join(save_dir, name)
            self.capture(path)
            paths.append(path)
            if progress:
                progress(i + 1, frames.shape[0])
        self.log(f"[capture] {len(paths)} frames -> {save_dir} "
                 f"({time.monotonic() - t0:.1f}s)")
        return paths

    def capture_scan(self, save_dir: str,
                     progress: Callable[[int, int], None] | None = None
                     ) -> list[str]:
        """One object scan (46 frames at 1080p), scan settle time.

        With ``pack_frames`` the landed sequence is immediately packed to
        the 1-bit bit-plane container (``frames.slbp``, io/images.py) —
        the scan folder ships ~8x fewer bytes and the pipeline's packed
        ingest uploads it as-is. Calibration captures are never packed:
        chessboard detection needs the full grayscale frames. A failure
        here raises like any capture failure, so auto-scan's per-view
        retry budget (``acquire.capture_retries``) covers it."""
        paths = self.capture_sequence(save_dir, self.scan_settle_ms,
                                      progress)
        if self.pack_frames:
            from structured_light_for_3d_model_replication_tpu_torch.io import (
                images as imio,
            )
            from structured_light_for_3d_model_replication_tpu_torch.utils import (
                faults,
            )

            faults.fire("frame.pack", item=save_dir)
            packed = imio.pack_scan_folder(save_dir,
                                           keep_raw=self.pack_keep_raw)
            self.log(f"[capture] packed -> {packed} "
                     f"({os.path.getsize(packed)} B)")
            paths = [packed] + (paths if self.pack_keep_raw else [])
        return paths

    def capture_calibration(self, save_dir: str, num_poses: int,
                            on_pose: Callable[[int], None] | None = None,
                            pose_names: Sequence[str] | None = None
                            ) -> list[str]:
        """Calibration capture: one full sequence per chessboard pose.

        ``on_pose(i)`` is the operator hook between poses (the operator moves
        the board); in scripted runs it can move a fixture.
        """
        done = []
        for p in range(num_poses):
            if on_pose:
                on_pose(p)
            name = pose_names[p] if pose_names else f"pose{p + 1:02d}"
            pose_dir = os.path.join(save_dir, name)
            self.capture_sequence(pose_dir, self.calib_settle_ms)
            done.append(pose_dir)
        return done
