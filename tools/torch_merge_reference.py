#!/usr/bin/env python3
"""Reference errors of the merge scenes, for the port's on-card gates.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/torch_merge_reference.py \
        [--method sequential|posegraph] [--standalone] [--port]

Two scenes of ``chip_smoke.py``, merged with the JAX package's
``merge_views`` (default ``Config()``, 4096 trials; ``merge_360``, or
``merge_360_posegraph`` with ``--method posegraph``) on the CPU:

- flagship: three spheres, 24 turntable views 15 degrees apart about
  (0, 0, 400), a 480x360 camera, a 512x256 projector, manual thresholds,
  row_mode 1, rendered with the port's ``utils/synthetic.py`` and
  reconstructed with the port's ``reconstruct`` on the CPU into PLYs;
- pose: ``synthetic.lumpy_views`` at the same 24 poses, written as PLYs.

Prints one JSON line a scene and package: the recovered transforms' errors
against the true turntable poses, for the flagship the merged points'
distance to the true sphere surfaces and the views' slot occupancy (the
device arm's gate), and for the posegraph merge whether the loop closure
was kept (its pose errors by ``chip_smoke.pose_accuracy_chord``).
``chip_smoke.py`` gates the port's merges on the card at 1.5x the JAX
package's errors (``FLAGSHIP_JAX``, ``POSE_JAX``, ``POSEGRAPH_JAX``).
``--port`` also merges the same PLYs with the port on the CPU (the card's
arithmetic in its plain versions).

``--standalone`` instead runs phase 11(c)'s inputs through the JAX
package's ``ransac_global_registration`` and ``icp_point_to_plane`` (its CPU
arms): pose views 1 -> 0 after ``prep_view`` (voxel 3 mm), and the flagship
cloud at the true poses (``chip_smoke.flagship_cloud``, 182,828 points)
against its noisy moved copy (``chip_smoke.big_icp_inputs``); it prints each
recovered transform's error against the truth (``STANDALONE_JAX``).
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


def _occupancy(ply_dir: str) -> dict:
    counts = [len(p) for p, _ in chip_smoke.read_clouds(ply_dir)]
    n_raw = -(-max(counts) // 8192) * 8192
    return {"view_points_min": min(counts), "view_points_max": max(counts),
            "occupancy": sum(counts) / (len(counts) * n_raw)}


def standalone(ply_dir: str, pose_dir: str, poses) -> None:
    """The ``--standalone`` report (module docstring)."""
    import jax.numpy as jnp
    import torch

    from structured_light_for_3d_model_replication_tpu.models import reconstruction as jrec
    from structured_light_for_3d_model_replication_tpu.ops import normals as jnrm
    from structured_light_for_3d_model_replication_tpu.ops import registration as jreg
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    voxel = 3.0
    clouds = chip_smoke.read_clouds(pose_dir)
    truth = chip_smoke.true_pair_transforms(poses)[0]
    src, dst = (jrec.prep_view(clouds[i][0], voxel) for i in (1, 0))
    t0 = time.perf_counter()
    g = jreg.ransac_global_registration(src.points, src.features, src.valid, dst.points,
                                        dst.features, dst.valid, max_dist=voxel * 1.5)
    icp = jreg.icp_point_to_plane(src.points, src.valid, dst.points, dst.valid,
                                  dst.normals, init_transform=g.transform,
                                  max_dist=voxel * 1.5)
    print(json.dumps({"standalone": "jax_cpu_lumpy", "wall_s": time.perf_counter() - t0,
                      "ransac": chip_smoke.transform_error(np.asarray(g.transform), truth),
                      "ransac_fitness": float(g.fitness),
                      "icp": chip_smoke.transform_error(np.asarray(icp.transform), truth),
                      "icp_fitness": float(icp.fitness)}), flush=True)
    views = [p for p, _ in chip_smoke.read_clouds(ply_dir)]
    truth_v = syn.turntable_transforms(poses)
    cloud, valid, _, _ = chip_smoke.flagship_cloud(torch.device("cpu"), views, truth_v)
    cloud = cloud[valid].numpy()
    s_pts, d_pts, T = chip_smoke.big_icp_inputs(cloud)
    ones = jnp.ones(len(d_pts), bool)
    t0 = time.perf_counter()
    nr = jnrm.estimate_normals(jnp.asarray(d_pts), ones, k=30)
    big = jreg.icp_point_to_plane(s_pts, None, d_pts, None, nr, max_dist=voxel * 1.5)
    print(json.dumps({"standalone": "jax_cpu_big_icp", "rows": int(len(d_pts)),
                      "wall_s": time.perf_counter() - t0,
                      "icp": chip_smoke.transform_error(np.asarray(big.transform), T),
                      "icp_fitness": float(big.fitness)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", choices=["sequential", "posegraph"], default="sequential")
    ap.add_argument("--standalone", action="store_true",
                    help="phase 11(c)'s standalone registrations instead of the merges")
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
        if args.standalone:
            standalone(ply_dir, pose_dir, poses)
            return 0

        def accuracy(scene, transforms, points, logs):
            pose = (chip_smoke.pose_accuracy_chord if args.method == "posegraph"
                    else chip_smoke.pose_accuracy)
            acc = (pose(transforms, poses) if scene == "pose" else
                   dict(chip_smoke.merge_accuracy(transforms, points, poses),
                        **_occupancy(ply_dir)))
            if args.method == "posegraph":
                acc["loop_closure"] = not any("loop closure rejected" in m for m in logs)
            return acc

        for scene, views in (("flagship", ply_dir), ("pose", pose_dir)):
            jcfg, cfg = JConfig(), Config()
            jcfg.merge.method = cfg.merge.method = args.method
            logs: list[str] = []
            t0 = time.perf_counter()
            points, _, transforms = jstages.merge_views(
                views, os.path.join(root, f"jax_{scene}.ply"), cfg=jcfg, log=logs.append)
            print(json.dumps({"merge": f"jax_cpu_{scene}", "method": args.method,
                              "wall_s": time.perf_counter() - t0,
                              "accuracy": accuracy(scene, transforms, points, logs)}),
                  flush=True)
            if args.port:
                logs = []
                t0 = time.perf_counter()
                tm: dict = {}
                points, _, transforms = stages.merge_views(
                    views, os.path.join(root, f"port_{scene}.ply"), cfg=cfg,
                    device=dev, timings=tm, log=logs.append)
                print(json.dumps({"merge": f"port_cpu_{scene}", "method": args.method,
                                  "wall_s": time.perf_counter() - t0, "timings_s": tm,
                                  "accuracy": accuracy(scene, transforms, points, logs)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
