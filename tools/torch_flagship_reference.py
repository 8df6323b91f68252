#!/usr/bin/env python3
"""Reference clean counts of the flagship capture, for the port's on-card gates.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/torch_flagship_reference.py \
        [--views N]

On the CPU: renders ``chip_smoke.py``'s 1080p views (``chip_smoke.
render_views``: ``synthetic.sphere_on_background`` through a 1920x1080
camera and projector, per-view seeded noise), stores the first N (default
``chip_smoke.FLAGSHIP_VIEWS``) as .slbp containers as phase 3 stores them,
and runs the JAX package's ``reconstruct_source`` and clean chain
(``pipeline/stages._clean_arrays``) on each with the default ``Config()``
at the render's projector size: the same views, config and steps as
``chip_smoke.py`` phase 15(b)'s ``run_pipeline``. On the CPU a view of
~1.06 M points takes the JAX package's host arms above 65,536 rows: the
grid-hash k-NN in the cluster step, the grid radius count, the cKDTree twin
of the statistical step.

Prints one JSON line a view (its counts after each clean step, the cleaned
points' distance to the true sphere: ``synthetic.sphere_surface_distance``
median and p99, its wall) and last the line ``chip_smoke.FLAGSHIP_CLEAN_JAX``
holds: {"clean_counts": [[input, background, cluster, radius, statistical],
...], "surf_mm": [[median, p99], ...]}. About 2-3 minutes a view and
~12 GB on 8 cores.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=chip_smoke.FLAGSHIP_VIEWS)
    args = ap.parse_args()

    from structured_light_for_3d_model_replication_tpu.config import Config
    from structured_light_for_3d_model_replication_tpu.io import matfile as jmatfile
    from structured_light_for_3d_model_replication_tpu.pipeline import stages
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    scene = syn.sphere_on_background()
    counts, surf = [], []
    with tempfile.TemporaryDirectory(prefix="slscan_flagship_ref_") as root:
        rig, frames_np, _ = chip_smoke.render_views()
        calib_path = os.path.join(root, "calib.npz")
        matfile.save_calibration(calib_path, rig.calibration())
        views = []
        for i in range(args.views):
            view = os.path.join(root, chip_smoke.flagship_view_name(i))
            imio.save_packed_stack(view, imio.pack_stack(frames_np[i]))
            views.append(view)
        del frames_np
        calib = jmatfile.load_calibration(calib_path)
        cfg = Config()
        cfg.decode.n_cols, cfg.decode.n_rows = chip_smoke.PROJ
        for view in views:
            t0 = time.perf_counter()
            pts, cols = stages.reconstruct_source(view, calib, cfg)
            t_rec = time.perf_counter() - t0
            kept, _, c = stages._clean_arrays(np.asarray(pts, np.float32),
                                              np.asarray(cols), cfg)
            d = syn.sphere_surface_distance(kept, scene)
            row = [c.get(k, 0) for k in chip_smoke.PIPE_STEPS]
            counts.append(row)
            surf.append([float(np.median(d)), float(np.percentile(d, 99))])
            print(json.dumps({"view": os.path.basename(view), "clean_counts": row,
                              "surf_mm": surf[-1], "reconstruct_s": t_rec,
                              "clean_s": time.perf_counter() - t0 - t_rec}), flush=True)
    print(json.dumps({"clean_counts": counts, "surf_mm": surf}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
