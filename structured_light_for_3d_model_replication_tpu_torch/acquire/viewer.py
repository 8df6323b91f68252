"""Per-stage artifacts for the operator viewer: ``StageRecorder``.

The JAX package's recorder (``acquire/viewer.py``), the same file names,
layout and progress entries: ``merge-360 --artifacts`` writes each chain
step's preview cloud as ``merge_step_NN.ply``, ``clean --artifacts`` each
clean step's cloud as ``clean_<step>.ply``, and both append an entry to
``progress.json`` that a viewer polls. The HTTP viewer and the auto-scan
progress hook are not ported.
"""
from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

from structured_light_for_3d_model_replication_tpu_torch.io import ply

__all__ = ["StageRecorder"]


class StageRecorder:
    """Persist per-stage artifacts and progress entries.

    Use as ``merge_360(..., step_callback=StageRecorder(dir).merge_step)``:
    each chain step writes ``merge_step_NN.ply`` (a preview capped at
    ``max_points_per_step`` points by a stride) and appends a progress
    entry."""

    def __init__(self, artifact_dir: str, max_points_per_step: int = 200_000):
        self.dir = artifact_dir
        self.max_points = int(max_points_per_step)
        self._t0 = time.time()
        self._lock = threading.Lock()
        os.makedirs(artifact_dir, exist_ok=True)
        self._progress_path = os.path.join(artifact_dir, "progress.json")
        self._events: list[dict] = []
        self._merge_p: list[np.ndarray] = []
        self._merge_c: list[np.ndarray] = []

    def log_stage(self, stage: str, **info) -> None:
        """Append one progress entry ({stage, t, **info}) and publish the
        whole list atomically."""
        with self._lock:
            self._events.append({"stage": stage, "t": round(time.time() - self._t0, 2),
                                 **info})
            tmp = self._progress_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._events, f)
            os.replace(tmp, self._progress_path)

    def merge_step(self, i: int, points, colors, total=None) -> None:
        """The merge's ``step_callback``: ``points`` / ``colors`` are the
        newly folded view's arrays and ``total`` the running point count;
        ``i == 0`` seeds the base view without writing an artifact."""
        with self._lock:
            if i == 0:
                self._merge_p, self._merge_c = [], []
            self._merge_p.append(np.asarray(points))
            self._merge_c.append(np.asarray(colors))
            views_p, views_c = list(self._merge_p), list(self._merge_c)
        if i == 0:
            return
        total = int(total) if total is not None else sum(len(p) for p in views_p)
        stride = max(1, total // self.max_points)
        pts = np.concatenate([p[::stride] for p in views_p])
        cols = np.concatenate([c[::stride] for c in views_c])
        path = os.path.join(self.dir, f"merge_step_{i:02d}.ply")
        ply.write_ply(path + ".tmp", pts, cols)   # the viewer may read it mid-merge
        os.replace(path + ".tmp", path)
        self.log_stage("merge", step=i, points=int(total), file=os.path.basename(path))

    def save_cloud(self, name: str, points: np.ndarray,
                   colors: np.ndarray | None = None) -> str:
        """One stage's cloud as ``<name>.ply`` (capped at
        ``max_points_per_step`` points by a stride; gray 180 without
        colors) and a progress entry. Returns the path."""
        total = len(points)
        stride = max(1, total // self.max_points)
        pts = np.asarray(points)[::stride]
        if colors is None:
            cols = np.full((len(pts), 3), 180, np.uint8)
        else:
            cols = np.asarray(colors)[::stride]
        path = os.path.join(self.dir, name if name.endswith(".ply") else name + ".ply")
        ply.write_ply(path + ".tmp", pts, cols)
        os.replace(path + ".tmp", path)
        self.log_stage("cloud", points=int(total), file=os.path.basename(path))
        return path
