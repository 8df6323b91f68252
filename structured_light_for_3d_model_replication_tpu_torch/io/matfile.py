"""Calibration IO: the reference's MATLAB .mat layout, or an .npz twin.

Keys: {Nc, Oc, dc, wPlaneCol, wPlaneRow, cam_K, proj_K, R, T}. The .npz form
needs numpy only; the .mat form needs scipy.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["save_calibration", "load_calibration"]


def save_calibration(path: str, calib: dict) -> None:
    """Save to .mat (reference-compatible) or .npz by extension."""
    data = {k: np.asarray(v) for k, v in calib.items() if v is not None}
    if path.endswith(".npz"):
        np.savez_compressed(path, **data)
    else:
        import scipy.io

        scipy.io.savemat(path, data)


def load_calibration(path: str) -> dict:
    """Load a calibration dict (MATLAB metadata keys dropped)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Calibration file not found: {path}")
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    import scipy.io

    raw = scipy.io.loadmat(path)
    calib = {k: v for k, v in raw.items() if not k.startswith("__")}
    missing = [k for k in ("Oc", "wPlaneCol", "wPlaneRow") if k not in calib]
    if missing:
        raise ValueError(f"{path}: not a calibration file (missing {missing})")
    return calib
