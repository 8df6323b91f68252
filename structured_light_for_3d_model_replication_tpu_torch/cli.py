"""Command-line interface of the port.

  python -m structured_light_for_3d_model_replication_tpu_torch reconstruct \\
      <target> --calib calib.mat [--mode batch] [--output out/] \\
      [--compute-batch N] [--packed-ingest] [--set decode.thresh_mode=manual] \\
      [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch clean \\
      <in.ply | folder> <out.ply | folder> [--steps background,cluster,...] \\
      [--artifacts DIR] [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch merge-360 \\
      <folder of view PLYs> <out.ply> [--method sequential|posegraph] \\
      [--save-transforms T.json] [--artifacts DIR] \\
      [--set merge.ransac_trials=2048] [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch mesh \\
      <cloud.ply> <out.stl | out.ply> [--save-normals N.ply] \\
      [--set mesh.mode=surface] [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch pipeline \\
      <scan root> --calib calib.mat --out <dir> [--steps ...] \\
      [--compute-batch N] [--packed-ingest] [--no-cache] [--no-stream] \\
      [--pair-batch N] [--trace] [--run-budget S] [--no-deadlines] \\
      [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch report \\
      <pipeline out dir> [--validate] [--prometheus] [--chrome-trace [PATH]] \\
      [--width N]
  python -m structured_light_for_3d_model_replication_tpu_torch config \\
      [--config C.json] [--set KEY=VALUE]
  python -m structured_light_for_3d_model_replication_tpu_torch patterns <dir>
  python -m structured_light_for_3d_model_replication_tpu_torch synth <root> \\
      [--views 4] [--cam 320x240] [--proj 256x128]

The flags and exit codes are the JAX CLI's, plus ``--device`` on the
commands that compute (default cuda; without CUDA the command fails
unless ``--device cpu`` is given). ``config`` prints the resolved
configuration as the JAX package's JSON (its keys, the dropped ones
included); ``report`` reads a traced ``pipeline`` run (``--trace``);
``--artifacts`` records each clean step's or merge step's cloud and a
``progress.json`` (``acquire/viewer.StageRecorder``). Every command that
computes arms the fault-injection plan of the ``faults`` config section, which the
``SL3D_FAULTS`` / ``SL3D_FAULTS_SEED`` environment variables override.
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
from structured_light_for_3d_model_replication_tpu_torch.acquire.viewer import (
    StageRecorder,
)
from structured_light_for_3d_model_replication_tpu_torch.config import jax_dict


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
    p.add_argument("--io-workers", type=int, default=None,
                   help="host I/O threads for the overlapped lanes (frame "
                        "prefetch + PLY writeback; <=1 with --compute-batch <= 1 "
                        "runs the serial loop; default: parallel.io_workers)")
    p.add_argument("--prefetch-depth", type=int, default=None,
                   help="frame stacks the prefetcher may hold ahead of compute "
                        "(default: parallel.prefetch_depth)")
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
    p.add_argument("--artifacts", default=None,
                   help="record each step's cloud (clean_<step>.ply) and "
                        "progress.json into this directory (single-file mode only)")
    _common_args(p)
    p = sub.add_parser("merge-360", help="register + merge a folder of per-view PLYs")
    p.add_argument("input_folder")
    p.add_argument("output")
    p.add_argument("--method", choices=["sequential", "posegraph"], default=None,
                   help="override merge.method ('posegraph': the odometry chain plus a "
                        "first<->last loop closure, solved as a pose graph)")
    p.add_argument("--save-transforms", default=None,
                   help="write per-view 4x4 transforms as JSON")
    p.add_argument("--artifacts", default=None,
                   help="record each chain step's preview cloud (merge_step_NN.ply) "
                        "and progress.json into this directory")
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
    p.add_argument("--ascii", action="store_true",
                   help="write the final merged PLY in ASCII (pipeline.ascii_output: "
                        "the reference's %%.4f layout, lossy); intermediates stay "
                        "binary")
    p.add_argument("--no-cache", action="store_true",
                   help="pipeline.cache=false: compute every stage, read and write "
                        "no <out>/.slscan-cache entry")
    p.add_argument("--io-workers", type=int, default=None,
                   help="host I/O threads for frame loads (parallel.io_workers)")
    p.add_argument("--prefetch-depth", type=int, default=None,
                   help="frame stacks the prefetcher may hold ahead of compute "
                        "(parallel.prefetch_depth)")
    p.add_argument("--compute-batch", type=int, default=None,
                   help="views per device launch for the reconstruct stage "
                        "(default: parallel.compute_batch)")
    p.add_argument("--stream", dest="stream", action="store_true", default=None,
                   help="merge.stream: register pair (i, i+1) while later views "
                        "are still being cleaned (the default)")
    p.add_argument("--no-stream", dest="stream", action="store_false",
                   help="merge.stream=false: the barrier merge after the last view "
                        "(the same bytes)")
    p.add_argument("--pair-batch", type=int, default=None,
                   help="pairs per registration launch group (merge.pair_batch)")
    p.add_argument("--packed-ingest", dest="packed_ingest", action="store_true",
                   default=None, help="decode from packed bit-planes "
                                      "(pipeline.packed_ingest)")
    p.add_argument("--no-packed-ingest", dest="packed_ingest", action="store_false",
                   help="force raw frame ingest")
    p.add_argument("--fused-clean", dest="fused_clean", action="store_true",
                   default=None,
                   help="pipeline.fused_clean: compact + clean + compact again each "
                        "batch's views on the device and copy them to the host "
                        "once; byte-identical to the discrete drain (batched lane "
                        "only)")
    p.add_argument("--no-fused-clean", dest="fused_clean", action="store_false",
                   help="the discrete host-masked clean (pipeline.fused_clean=false)")
    p.add_argument("--trace", action="store_true",
                   help="arm the flight recorder (observability.trace; env "
                        "SL3D_TRACE=1): <out>/trace.jsonl + <out>/metrics.json")
    p.add_argument("--run-budget", type=float, default=None, metavar="S",
                   help="overall wall-clock budget of the run, seconds "
                        "(pipeline.run_budget_s; 0 = unbounded): past it the run "
                        "aborts with an aborted failure manifest")
    p.add_argument("--no-deadlines", action="store_true",
                   help="disable the per-lane deadlines and the stall watchdog "
                        "(deadlines.enabled=false; env SL3D_NO_DEADLINES=1)")
    _common_args(p)
    p = sub.add_parser(
        "report",
        help="render a traced pipeline run's flight-recorder artifacts: lane "
             "timeline, stage walls, cache hit ratios, launch table, fault ledger")
    p.add_argument("out_dir", help="a pipeline out dir holding trace.jsonl "
                                   "(run with --trace)")
    p.add_argument("--width", type=int, default=60, help="timeline width in columns")
    p.add_argument("--chrome-trace", nargs="?", const="", default=None, metavar="PATH",
                   help="also export a Chrome/Perfetto trace-event JSON "
                        "(default: <out_dir>/trace.json)")
    p.add_argument("--prometheus", action="store_true",
                   help="print metrics.json as Prometheus exposition text instead "
                        "of the report")
    p.add_argument("--validate", action="store_true",
                   help="schema-check the journal and exit non-zero on any problem")
    _config_args(p)
    p = sub.add_parser("config", help="print the resolved configuration as JSON")
    _config_args(p)
    p = sub.add_parser("patterns", help="write the Gray-code pattern stack")
    p.add_argument("out_dir")
    _config_args(p)
    p = sub.add_parser("synth", help="render a synthetic turntable scan dataset")
    p.add_argument("output_root")
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--cam", default="320x240", help="camera WxH")
    p.add_argument("--proj", default="256x128", help="projector WxH")
    _config_args(p)
    return parser


def _common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    _config_args(p)


def _config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, help="path to a JSON config file")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted config override, e.g. --set decode.n_cols=1280")


def _print_pipeline(report, out_dir: str) -> None:
    for counts in report.clean_counts:   # per merged view, angle order
        print(f"[pipeline] clean {json.dumps(counts)}")
    print(f"[pipeline] merge mode: {report.merge_mode} ({report.merge_status}), "
          f"mesh {report.mesh_status}")
    o = report.overlap or {}
    if o.get("pair_launches"):
        print(f"[pipeline] streamed merge: {o['pairs_dispatched']} pair(s) in "
              f"{o['pair_launches']} register launch(es), register {o['register_s']}s "
              f"vs critical path {o['critical_path_s']}s")
    if report.cache:
        print(f"[pipeline] stage cache: {report.cache['hits']} hits, "
              f"{report.cache['misses']} misses")
    print("[pipeline] walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in report.walls_s.items()))
    if report.degraded:
        # a degraded run completed with reduced coverage: exit 0, say so
        print(f"[pipeline] WARNING: completed DEGRADED; see {report.manifest_path}",
              file=sys.stderr)
    if os.path.exists(os.path.join(out_dir, "stalls.json")):
        print(f"[pipeline] WARNING: the stall watchdog fired; -> "
              f"{os.path.join(out_dir, 'stalls.json')}", file=sys.stderr)


def _report(args, cfg) -> int:
    """``report``: validate, render, re-emit or export a traced run's
    journal (exit 1 without a journal, on an invalid one, or without
    metrics.json under ``--prometheus``)."""
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import (
        report as replib,
    )
    from structured_light_for_3d_model_replication_tpu_torch.utils import telemetry

    trace_file = cfg.observability.trace_file
    journal = os.path.join(args.out_dir, trace_file)
    journals = replib.host_journals(args.out_dir, trace_file)
    if not journals:
        print(f"[report] no {trace_file} under {args.out_dir} — run the pipeline "
              f"with --trace (or SL3D_TRACE=1) first", file=sys.stderr)
        return 1
    if args.validate:
        any_errors = False
        for jp in journals:
            errors = replib.validate_journal(jp)
            for e in errors:
                print(f"[report] INVALID: {e}", file=sys.stderr)
            print(f"[report] journal {'INVALID' if errors else 'valid'}: {jp}")
            any_errors = any_errors or bool(errors)
        if any_errors:
            return 1
    if not os.path.exists(journal):
        rows = replib.merge_host_timeline(args.out_dir, trace_file)
        if not args.validate and not args.prometheus:
            print(replib.render_host_timeline(rows))
        return 0
    if args.prometheus:
        mpath = os.path.join(args.out_dir, cfg.observability.metrics_file)
        if not os.path.exists(mpath):
            print(f"[report] no {cfg.observability.metrics_file} under "
                  f"{args.out_dir} (interrupted run?)", file=sys.stderr)
            return 1
        with open(mpath, encoding="utf-8") as f:
            print(telemetry.prometheus_text(json.load(f)), end="")
        return 0
    analysis = replib.analyze_run(args.out_dir, trace_file=trace_file,
                                  metrics_file=cfg.observability.metrics_file)
    if not args.validate:
        print(replib.render_report(analysis, width=args.width))
        if len(journals) > 1:
            print()
            print(replib.render_host_timeline(
                replib.merge_host_timeline(args.out_dir, trace_file)))
    if args.chrome_trace is not None:
        out_path = args.chrome_trace or os.path.join(args.out_dir, "trace.json")
        info = telemetry.export_chrome_trace(journal, out_path)
        print(f"[report] chrome trace -> {out_path} ({info['events']} events, "
              f"{info['lanes']} lane(s) on {info['tracks']} track(s)); open at "
              f"ui.perfetto.dev or chrome://tracing")
    return 0


def _synth(args) -> int:
    """``synth``: a synthetic turntable capture under ``output_root``: the
    rig's ``calib.mat`` and one folder of numbered PNG frames a view
    (``scan_<deg>deg_scan``), the JAX command's scene and layout."""
    import numpy as np

    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile
    from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

    def wh(s):
        w, h = s.lower().split("x")
        return int(w), int(h)

    rig = syn.default_rig(cam_size=wh(args.cam), proj_size=wh(args.proj))
    obj, background = syn.sphere_on_background().objects  # the turntable turns obj
    # an off-pivot satellite above the sphere makes every view distinct
    satellite = syn.Sphere(np.array([48.0, -92.0, 430.0]), 16.0)
    os.makedirs(args.output_root, exist_ok=True)
    matfile.save_calibration(os.path.join(args.output_root, "calib.mat"),
                             rig.calibration())
    step = 360.0 / args.views
    pivot = np.array([0.0, 0.0, 420.0])
    for i, (R, t) in enumerate(syn.turntable_poses(args.views, step, pivot)):
        view_scene = syn.Scene([obj.transformed(R, t), satellite.transformed(R, t),
                                background])
        frames, _ = syn.render_scene(rig, view_scene)
        d = os.path.join(args.output_root, f"scan_{int(round(i * step)):03d}deg_scan")
        imio.save_stack(d, frames)
        print(f"[synth] view {i + 1}/{args.views} -> {d}")
    print(f"[synth] calib + {args.views} views under {args.output_root}")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 1
    if args.command == "synth":
        return _synth(args)
    cfg = load_config(args.config, parse_overrides(args.set))
    if args.command == "config":
        json.dump(jax_dict(cfg), sys.stdout, indent=2)
        print()
        return 0
    if args.command == "report":
        return _report(args, cfg)
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import (
        stages,
    )
    from structured_light_for_3d_model_replication_tpu_torch.utils import faults

    plan = faults.configure_from(cfg.faults)
    if plan is not None:
        print(f"[faults] CHAOS RUN: {len(plan.rules)} injection rule(s) armed "
              f"(seed {plan.seed})", file=sys.stderr)
    if args.command == "patterns":
        stages.write_patterns(args.out_dir, cfg=cfg)
        return 0
    if args.command == "clean":
        steps = _steps(args.steps)
        if os.path.isdir(args.input):
            report = stages.clean_batch(args.input, args.output, cfg=cfg, steps=steps,
                                        device=args.device)
            return 0 if report.outputs and not report.failed else (
                2 if report.outputs else 1)
        step_cb = None
        if args.artifacts:
            rec = StageRecorder(args.artifacts)
            step_cb = lambda name, p, c: rec.save_cloud(f"clean_{name}", p, c)  # noqa: E731
        stages.clean_cloud(args.input, args.output, cfg=cfg, steps=steps,
                           device=args.device, step_callback=step_cb)
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
        if args.prefetch_depth is not None:
            cfg.parallel.prefetch_depth = args.prefetch_depth
        if args.compute_batch is not None:
            cfg.parallel.compute_batch = args.compute_batch
        if args.ascii:
            cfg.pipeline.ascii_output = True
        if args.fused_clean is not None:
            cfg.pipeline.fused_clean = args.fused_clean
        if args.stream is not None:
            cfg.merge.stream = args.stream
        if args.pair_batch is not None:
            cfg.merge.pair_batch = args.pair_batch
        if args.packed_ingest is not None:
            cfg.pipeline.packed_ingest = args.packed_ingest
        if args.trace:
            cfg.observability.trace = True
        if args.run_budget is not None:
            cfg.pipeline.run_budget_s = args.run_budget
        if args.no_deadlines:
            cfg.deadlines.enabled = False
        report = stages.run_pipeline(args.calib, args.target, args.out, cfg=cfg,
                                     steps=_steps(args.steps), stl_name=args.stl_name,
                                     device=args.device)
        _print_pipeline(report, args.out)
        return 0
    if args.command == "merge-360":
        if args.method:
            cfg.merge.method = args.method
        step_cb = StageRecorder(args.artifacts).merge_step if args.artifacts else None
        _, _, transforms = stages.merge_views(args.input_folder, args.output,
                                              cfg=cfg, device=args.device,
                                              step_callback=step_cb)
        if args.save_transforms:
            with open(args.save_transforms, "w") as f:
                json.dump([t.tolist() for t in transforms], f, indent=2)
        return 0
    if args.io_workers is not None:
        cfg.parallel.io_workers = args.io_workers
    if args.prefetch_depth is not None:
        cfg.parallel.prefetch_depth = args.prefetch_depth
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
