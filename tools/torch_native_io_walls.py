#!/usr/bin/env python3
"""Host walls of the port's native IO runtime against the Python readers
and writers, on this machine's CPU (no card needed).

    python3 tools/torch_native_io_walls.py [--views 2] [--reps 3]
        [--points 188067] [--faces 7500000]

Loads: ``chip_smoke.py``'s 1920x1080x46 render, written as phase 9(a)
writes it (numbered PNG frames, libpng's adaptive row filters), ``--views``
folders. Each folder is read ``--reps`` times in turn by

  native      ``io/native.load_gray_stack`` (one thread a hardware thread,
              as ``io/images.load_stack`` calls it)
  cv2_serial  ``io/images.load_gray`` frame by frame on one thread (the
              serial lane's load where the native library is missing)
  cv2_pool    the same on ``parallel.io_workers`` threads (the default
              config's pool)

and the native stack must equal the cv2 stack byte for byte.

Writes: a seeded cloud of ``--points`` points with colours through
``ply.write_ply`` (native at >= 100,000 points) and ``ply._write_ply_py``,
and a seeded mesh of ``--faces`` faces through ``stl.write_stl`` (native at
>= 50,000 faces) and the numpy writer (normals given); the defaults are
the mesh arm's merged cloud and STL (``PERF.md`` section 4). Files go to a
temporary directory under ``TMPDIR``.

Prints one JSON line a measurement and a last line with each arm's median,
the CPU count and the native library's status.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

from structured_light_for_3d_model_replication_tpu_torch.config import Config  # noqa: E402
from structured_light_for_3d_model_replication_tpu_torch.io import (  # noqa: E402
    images as imio,
)
from structured_light_for_3d_model_replication_tpu_torch.io import native, ply, stl  # noqa: E402


def _time(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def _load_arms(folder: str, io_workers: int) -> dict:
    from concurrent.futures import ThreadPoolExecutor

    files = imio.list_frame_files(folder)
    w, h, _ = native.probe_png(files[0])
    t_nat, stack = _time(lambda: native.load_gray_stack(files, w, h))
    t_ser, ref = _time(lambda: np.stack([imio.load_gray(f) for f in files]))
    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        t_pool, pooled = _time(lambda: np.stack(list(pool.map(imio.load_gray, files))))
    if stack is None or stack.tobytes() != ref.tobytes() or pooled.tobytes() != ref.tobytes():
        raise SystemExit(f"{folder}: the native and cv2 stacks differ")
    return {"native": t_nat, "cv2_serial": t_ser, "cv2_pool": t_pool, "frames": len(files)}


def _write_arms(tmp: str, n_points: int, n_faces: int) -> dict:
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 80, (n_points, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (n_points, 3)).astype(np.uint8)
    n_verts = max(3, n_faces // 2)
    verts = rng.normal(0, 80, (n_verts, 3)).astype(np.float32)
    faces = rng.integers(0, n_verts, (n_faces, 3)).astype(np.int32)
    out = {}
    out["ply_native"], _ = _time(lambda: ply.write_ply(os.path.join(tmp, "n.ply"), pts, cols))
    out["ply_python"], _ = _time(lambda: ply._write_ply_py(os.path.join(tmp, "p.ply"), pts,
                                                           cols, None, True))
    out["stl_native"], _ = _time(lambda: stl.write_stl(os.path.join(tmp, "n.stl"), verts, faces))
    out["stl_python"], _ = _time(lambda: stl.write_stl(
        os.path.join(tmp, "p.stl"), verts, faces, normals=stl.face_normals(verts, faces)))
    for name in ("n.ply", "p.ply", "n.stl", "p.stl"):
        os.remove(os.path.join(tmp, name))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--points", type=int, default=188_067)
    ap.add_argument("--faces", type=int, default=7_500_000)
    args = ap.parse_args()
    path, missing = native.status()
    if path is None:
        print(json.dumps({"native": f"unavailable: {missing}"}))
        return 1
    io_workers = Config().parallel.io_workers
    loads, writes = [], []
    with tempfile.TemporaryDirectory(prefix="slscan_native_walls_") as tmp:
        _, frames_np, _ = chip_smoke.render_views()
        filters = chip_smoke._write_png_views(os.path.join(tmp, "png"),
                                              frames_np[:args.views], args.views)
        del frames_np
        folders = sorted(os.path.join(tmp, "png", d) for d in os.listdir(os.path.join(tmp, "png")))
        for rep in range(args.reps):
            for folder in folders:
                row = _load_arms(folder, io_workers)
                loads.append(row)
                print(json.dumps({"load": os.path.basename(folder), "rep": rep, **row}),
                      flush=True)
            row = _write_arms(tmp, args.points, args.faces)
            writes.append(row)
            print(json.dumps({"write": rep, "points": args.points, "faces": args.faces, **row}),
                  flush=True)
    med = {f"load_{k}_s_per_view": statistics.median(r[k] for r in loads)
           for k in ("native", "cv2_serial", "cv2_pool")}
    med.update({f"{k}_s": statistics.median(r[k] for r in writes) for k in writes[0]})
    print(json.dumps({"median": med, "views": args.views, "reps": args.reps,
                      "io_workers": io_workers, "png_filter_rows": filters,
                      "cpus": os.cpu_count(), "native": path}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
