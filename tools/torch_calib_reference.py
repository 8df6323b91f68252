#!/usr/bin/env python3
"""Reference errors of the calibration phase, for the port's on-card gates.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/torch_calib_reference.py [--port]

On the CPU: renders ``chip_smoke.py``'s phase 12(a) boards
(``chip_smoke.render_calibration``: ``synthetic.calibration_poses`` through
phase 2's 1080p rig, lit by its 46-frame stack), writes them as pose folders
of PNG frames, and runs the JAX package's ``calibrate`` command on them
(``calibrate_and_save`` after the automatic pose pruning), with
``chip_smoke.CALIB_SET``. Its errors against the true rig
(``chip_smoke.calib_errors``). Then the JAX package's ``reconstruct`` of
phase 2's view 0 (``chip_smoke.render_views``, stored as .slbp as phase 3
stores it) with the recovered calibration in the table and quadratic lanes,
and with the true calibration: the points' distance to the true surfaces
(``chip_smoke.surface_errors``: median, p99, points). Prints the one JSON
line that ``chip_smoke.CALIB_JAX`` holds. ``--port`` also runs the port's
``calibrate`` command on the same folders (on the CPU; a second line).
About 5 minutes and 8 GB on 8 cores.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def _calibrate(main, pose_root: str, out: str, rig) -> dict:
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile

    rc, text = chip_smoke.run_cli(main, ["calibrate", pose_root, "--output", out,
                                         *chip_smoke.CALIB_SET])
    if rc != 0:
        raise SystemExit(f"calibrate exited {rc}")
    rows = chip_smoke.pose_rows(text)
    if len(rows) != chip_smoke.CALIB_POSES:
        raise SystemExit(f"{len(rows)} of {chip_smoke.CALIB_POSES} poses detected")
    return chip_smoke.calib_errors(matfile.load_calibration(out),
                                   chip_smoke.stereo_rms(text), rig)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", action="store_true",
                    help="also calibrate with the port's command on the CPU")
    args = ap.parse_args()

    from structured_light_for_3d_model_replication_tpu import cli as jcli
    from structured_light_for_3d_model_replication_tpu.config import Config
    from structured_light_for_3d_model_replication_tpu.pipeline import stages
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile

    with tempfile.TemporaryDirectory(prefix="slscan_calib_ref_") as root:
        rig, frames_np, _ = chip_smoke.render_views()
        _, renders = chip_smoke.render_calibration(rig)
        pose_root = os.path.join(root, "poses")
        for i, frames in enumerate(renders):
            imio.save_stack(os.path.join(pose_root, f"pose{i + 1:02d}"), frames)
        del renders
        calib_mat = os.path.join(root, "calib.mat")
        calib = _calibrate(jcli.main, pose_root, calib_mat, rig)
        if args.port:
            from structured_light_for_3d_model_replication_tpu_torch import cli

            port = _calibrate(cli.main, pose_root, os.path.join(root, "port.mat"), rig)
            print(json.dumps({"port_cpu_calib": port}), flush=True)

        view = os.path.join(root, "view_000deg")
        imio.save_packed_stack(view, imio.pack_stack(frames_np[0]))
        del frames_np
        true_calib = os.path.join(root, "true.npz")
        matfile.save_calibration(true_calib, rig.calibration())
        recon = {}
        for arm, path in (("table", calib_mat), ("quadratic", calib_mat),
                          ("true", true_calib)):
            cfg = Config()
            cfg.decode.n_cols, cfg.decode.n_rows = chip_smoke.PROJ
            cfg.triangulate.plane_eval = "quadratic" if arm == "quadratic" else "table"
            out = os.path.join(root, f"{arm}.ply")
            stages.reconstruct(path, view, mode="single", output=out, cfg=cfg,
                               log=lambda m: None)
            recon[arm] = chip_smoke.surface_errors(out)
    print(json.dumps({"calib": calib, "recon": recon}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
