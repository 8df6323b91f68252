#!/usr/bin/env python3
"""Reference errors of the merge scenes, for the port's on-card gates.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/torch_merge_reference.py [--port]

Two scenes of ``chip_smoke.py``, merged with the JAX package's
``merge_views`` (``merge_360``, default ``Config()``, 4096 trials) on the
CPU:

- flagship: three spheres, 24 turntable views 15 degrees apart about
  (0, 0, 400), a 480x360 camera, a 512x256 projector, manual thresholds,
  row_mode 1, rendered with the port's ``utils/synthetic.py`` and
  reconstructed with the port's ``reconstruct`` on the CPU into PLYs;
- pose: ``synthetic.lumpy_views`` at the same 24 poses, written as PLYs.

Prints one JSON line a scene and package: the recovered transforms' errors
against the true turntable poses, and for the flagship the merged points'
distance to the true sphere surfaces. ``chip_smoke.py`` gates the port's
merges on the card at 1.5x the JAX package's errors. ``--port`` also merges
the same PLYs with the port on the CPU (the card's arithmetic in its plain
versions, the same RANSAC draws).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", action="store_true",
                    help="also merge with the port on the CPU")
    args = ap.parse_args()
    import torch

    from structured_light_for_3d_model_replication_tpu.config import Config as JConfig
    from structured_light_for_3d_model_replication_tpu.pipeline import stages as jstages
    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    dev = torch.device("cpu")
    with tempfile.TemporaryDirectory(prefix="slscan_mref_") as root:
        t0 = time.perf_counter()
        data, calib, poses = chip_smoke.render_merge_views(root)
        ply_dir = chip_smoke.reconstruct_merge_views(dev, data, calib,
                                                     os.path.join(root, "views"))
        pose_dir, _ = chip_smoke.write_pose_views(root)
        print(f"views: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

        def accuracy(scene, transforms, points):
            if scene == "pose":
                return chip_smoke.pose_accuracy(transforms, poses)
            return chip_smoke.merge_accuracy(transforms, points, poses)

        for scene, views in (("flagship", ply_dir), ("pose", pose_dir)):
            t0 = time.perf_counter()
            points, _, transforms = jstages.merge_views(
                views, os.path.join(root, f"jax_{scene}.ply"), cfg=JConfig(),
                log=lambda *a: None)
            print(json.dumps({"merge": f"jax_cpu_{scene}", "wall_s": time.perf_counter() - t0,
                              "accuracy": accuracy(scene, transforms, points)}), flush=True)
            if args.port:
                t0 = time.perf_counter()
                tm: dict = {}
                points, _, transforms = stages.merge_views(
                    views, os.path.join(root, f"port_{scene}.ply"), cfg=Config(),
                    device=dev, timings=tm, log=lambda *a: None)
                print(json.dumps({"merge": f"port_cpu_{scene}",
                                  "wall_s": time.perf_counter() - t0, "timings_s": tm,
                                  "accuracy": accuracy(scene, transforms, points)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
