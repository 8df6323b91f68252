"""Command-line interface of the port.

  python -m structured_light_for_3d_model_replication_tpu_torch reconstruct \\
      <target> --calib calib.mat [--mode batch] [--output out/] \\
      [--compute-batch N] [--packed-ingest] [--set decode.thresh_mode=manual] \\
      [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch clean \\
      <in.ply | folder> <out.ply | folder> [--steps background,cluster,...] \\
      [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch merge-360 \\
      <folder of view PLYs> <out.ply> [--method sequential] \\
      [--save-transforms T.json] [--set merge.ransac_trials=2048] \\
      [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch mesh \\
      <cloud.ply> <out.stl | out.ply> [--save-normals N.ply] [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch pipeline \\
      <scan root> --calib calib.mat --out <dir> [--steps ...] \\
      [--compute-batch N] [--packed-ingest] [--device cuda|cpu]

The flags are the JAX CLI's, plus ``--device`` (default cuda; without
CUDA the command fails unless ``--device cpu`` is given).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from structured_light_for_3d_model_replication_tpu_torch import (
    __version__,
    load_config,
)


_STEPS = ("background", "cluster", "radius", "statistical")


def _steps(text: str) -> tuple[str, ...]:
    return tuple(s.strip() for s in text.split(",") if s.strip())


def parse_overrides(pairs: list[str]) -> dict[str, str]:
    out: dict[str, str] = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--set expects KEY=VALUE, got {pair!r}")
        k, v = pair.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m structured_light_for_3d_model_replication_tpu_torch",
        description="structured-light scan-to-print on PyTorch + CUDA")
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="command")
    p = sub.add_parser("reconstruct",
                       help="decode + triangulate scan folder(s) into PLY clouds")
    p.add_argument("target", help="scan folder (single), parent folder (batch), "
                                  "or comma-separated file list (files)")
    p.add_argument("--calib", required=True, help="calibration file (.mat/.npz)")
    p.add_argument("--mode", choices=["single", "batch", "files"],
                   default="single")
    p.add_argument("--output", default=None,
                   help="output .ply (single) or output directory (batch/files)")
    p.add_argument("--compute-batch", type=int, default=None,
                   help="views per device launch; <=1 runs one view per "
                        "launch (default: parallel.compute_batch)")
    p.add_argument("--packed-ingest", dest="packed_ingest",
                   action="store_true", default=None,
                   help="load views as packed bit-planes and decode from the "
                        "bits on the device (pipeline.packed_ingest); "
                        "byte-identical outputs, batched lane only")
    p.add_argument("--no-packed-ingest", dest="packed_ingest",
                   action="store_false", help="force raw frame ingest")
    _common_args(p)
    p = sub.add_parser("clean",
                       help="point-cloud clean chain on one PLY, or on every PLY "
                            "of a folder (then the output is a folder)")
    p.add_argument("input", help=".ply file, or a folder of .ply files")
    p.add_argument("output", help="output .ply (file input) or folder (folder input)")
    p.add_argument("--steps", default=",".join(_STEPS),
                   help="comma list drawn from " + ",".join(_STEPS))
    _common_args(p)
    p = sub.add_parser("merge-360", help="register + merge a folder of per-view PLYs")
    p.add_argument("input_folder")
    p.add_argument("output")
    p.add_argument("--method", choices=["sequential", "posegraph"], default=None,
                   help="override merge.method ('posegraph' is not ported)")
    p.add_argument("--save-transforms", default=None,
                   help="write per-view 4x4 transforms as JSON")
    _common_args(p)
    p = sub.add_parser("mesh", help="mesh a cloud PLY into STL or mesh-PLY")
    p.add_argument("input")
    p.add_argument("output", help=".stl or .ply output path")
    p.add_argument("--save-normals", default=None,
                   help="also write the cloud with its oriented normals (PLY)")
    _common_args(p)
    p = sub.add_parser(
        "pipeline", aliases=["print"],
        help="scan-to-print: reconstruct -> per-view clean -> merge-360 -> mesh in "
             "one process; writes <out>/merged.ply and <out>/model.stl")
    p.add_argument("target", help="scan root: one folder per view")
    p.add_argument("--calib", required=True, help="calibration file (.mat/.npz)")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--steps", default=",".join(_STEPS),
                   help="clean-chain steps per view (comma list; empty string "
                        "disables cleaning)")
    p.add_argument("--stl-name", default="model.stl")
    p.add_argument("--no-cache", action="store_true",
                   help="pipeline.cache=false (the port has no stage cache yet: "
                        "every stage is computed either way)")
    p.add_argument("--io-workers", type=int, default=None,
                   help="host I/O threads for frame loads (parallel.io_workers)")
    p.add_argument("--compute-batch", type=int, default=None,
                   help="views per device launch for the reconstruct stage "
                        "(default: parallel.compute_batch)")
    p.add_argument("--stream", dest="stream", action="store_true", default=None,
                   help="merge.stream (the streaming registrar is not ported: "
                        "the barrier merge runs either way)")
    p.add_argument("--no-stream", dest="stream", action="store_false",
                   help="merge.stream=false")
    p.add_argument("--pair-batch", type=int, default=None,
                   help="pairs per registration launch group (merge.pair_batch)")
    p.add_argument("--packed-ingest", dest="packed_ingest", action="store_true",
                   default=None, help="decode from packed bit-planes "
                                      "(pipeline.packed_ingest)")
    p.add_argument("--no-packed-ingest", dest="packed_ingest", action="store_false",
                   help="force raw frame ingest")
    _common_args(p)
    return parser


def _common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    p.add_argument("--config", default=None, help="path to a JSON config file")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted config override, e.g. --set decode.n_cols=1280")


def main(argv: list[str] | None = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.command not in ("reconstruct", "clean", "merge-360", "mesh", "pipeline",
                            "print"):
        parser.print_help()
        return 1
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import (
        stages,
    )

    cfg = load_config(args.config, parse_overrides(args.set))
    if args.command == "clean":
        steps = _steps(args.steps)
        if os.path.isdir(args.input):
            report = stages.clean_batch(args.input, args.output, cfg=cfg, steps=steps,
                                        device=args.device)
            return 0 if report.outputs and not report.failed else (
                2 if report.outputs else 1)
        stages.clean_cloud(args.input, args.output, cfg=cfg, steps=steps,
                           device=args.device)
        return 0
    if args.command == "mesh":
        stages.mesh_cloud(args.input, args.output, cfg=cfg,
                          save_normals_path=args.save_normals, device=args.device)
        return 0
    if args.command in ("pipeline", "print"):
        if args.no_cache:
            cfg.pipeline.cache = False
        if args.io_workers is not None:
            cfg.parallel.io_workers = args.io_workers
        if args.compute_batch is not None:
            cfg.parallel.compute_batch = args.compute_batch
        if args.stream is not None:
            cfg.merge.stream = args.stream
        if args.pair_batch is not None:
            cfg.merge.pair_batch = args.pair_batch
        if args.packed_ingest is not None:
            cfg.pipeline.packed_ingest = args.packed_ingest
        report = stages.run_pipeline(args.calib, args.target, args.out, cfg=cfg,
                                     steps=_steps(args.steps), stl_name=args.stl_name,
                                     device=args.device)
        for counts in report.clean_counts:   # per view, angle order
            print(f"[pipeline] clean {json.dumps(counts)}")
        print("[pipeline] walls (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in report.walls_s.items()))
        return 0
    if args.command == "merge-360":
        if args.method:
            cfg.merge.method = args.method
        _, _, transforms = stages.merge_views(args.input_folder, args.output,
                                              cfg=cfg, device=args.device)
        if args.save_transforms:
            with open(args.save_transforms, "w") as f:
                json.dump([t.tolist() for t in transforms], f, indent=2)
        return 0
    if args.compute_batch is not None:
        cfg.parallel.compute_batch = args.compute_batch
    if args.packed_ingest is not None:
        cfg.pipeline.packed_ingest = args.packed_ingest
    report = stages.reconstruct(args.calib, args.target, mode=args.mode,
                                output=args.output, cfg=cfg,
                                device=args.device)
    return 0 if report.outputs else 1


if __name__ == "__main__":
    sys.exit(main())
