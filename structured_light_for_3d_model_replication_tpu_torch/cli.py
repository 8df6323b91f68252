"""Command-line interface of the port.

  python -m structured_light_for_3d_model_replication_tpu_torch reconstruct \\
      <target> --calib calib.mat [--mode batch] [--output out/] \\
      [--compute-batch N] [--packed-ingest] [--set decode.thresh_mode=manual] \\
      [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch merge-360 \\
      <folder of view PLYs> <out.ply> [--method sequential] \\
      [--save-transforms T.json] [--set merge.ransac_trials=2048] \\
      [--device cuda|cpu]

The flags are the JAX CLI's, plus ``--device`` (default cuda; without
CUDA the command fails unless ``--device cpu`` is given).
"""
from __future__ import annotations

import argparse
import json
import sys

from structured_light_for_3d_model_replication_tpu_torch import (
    __version__,
    load_config,
)


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
        description="structured-light scan path on PyTorch + CUDA")
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
    p = sub.add_parser("merge-360", help="register + merge a folder of per-view PLYs")
    p.add_argument("input_folder")
    p.add_argument("output")
    p.add_argument("--method", choices=["sequential", "posegraph"], default=None,
                   help="override merge.method ('posegraph' is not ported)")
    p.add_argument("--save-transforms", default=None,
                   help="write per-view 4x4 transforms as JSON")
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
    if args.command not in ("reconstruct", "merge-360"):
        parser.print_help()
        return 1
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import (
        stages,
    )

    cfg = load_config(args.config, parse_overrides(args.set))
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
