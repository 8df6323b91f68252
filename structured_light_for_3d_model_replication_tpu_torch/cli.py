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
      [--pair-batch N] [--view-plys] [--no-incremental] [--trace] \\
      [--run-budget S] [--no-deadlines] [--workers N] [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch worker \\
      --spec <out>/.coord/worker0.json
  python -m structured_light_for_3d_model_replication_tpu_torch report \\
      <pipeline out dir> [--validate] [--prometheus] [--chrome-trace [PATH]] \\
      [--width N]
  python -m structured_light_for_3d_model_replication_tpu_torch config \\
      [--config C.json] [--set KEY=VALUE]
  python -m structured_light_for_3d_model_replication_tpu_torch patterns <dir>
  python -m structured_light_for_3d_model_replication_tpu_torch synth <root> \\
      [--views 4] [--cam 320x240] [--proj 256x128]
  python -m structured_light_for_3d_model_replication_tpu_torch calibrate \\
      <pose folders> [--output calib.mat] [--analyze-only] [--poses a,b,c] \\
      [--review ARTIFACT_DIR] [--set checkerboard.rows=6]
  python -m structured_light_for_3d_model_replication_tpu_torch inspect-calib \\
      calib.mat [--plot rig.png]
  python -m structured_light_for_3d_model_replication_tpu_torch scan <dir>
  python -m structured_light_for_3d_model_replication_tpu_torch auto-scan \\
      <root> [--base-name scan] [--artifacts DIR] [--set acquire.simulate=true]
  python -m structured_light_for_3d_model_replication_tpu_torch capture-serve \\
      [--save-dir captures] [--viewer] [--artifact-dir artifacts]
  python -m structured_light_for_3d_model_replication_tpu_torch viewer <dir> \\
      [--port 5051]
  python -m structured_light_for_3d_model_replication_tpu_torch serve <root> \\
      [--port 0] [--ha] [--fleet] [--auth] [--ready-file F] [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch tenant \\
      add|list <root> [name] [--key K] [--rate-limit N] [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch warmup \\
      [--cam 1920x1080] [--proj 1920x1080] [--views 24] [--compute-batch N] \\
      [--merge-views 24] [--device cuda|cpu]
  python -m structured_light_for_3d_model_replication_tpu_torch doctor \\
      [--no-probe] [--probe-timeout S] [--root DIR]

The flags and exit codes are the JAX CLI's, plus ``--device`` on the
commands that compute (default cuda; without CUDA the command fails
unless ``--device cpu`` is given). ``config`` prints the resolved
configuration as the JAX package's JSON (its keys, the dropped ones
included); ``report`` reads a traced ``pipeline`` run (``--trace``); ``pipeline
--workers N`` (or ``--set coordinator.listen=host:port``) runs the scan
across worker processes on ``--device``, each started as ``worker --spec``
with that device in its spec (``worker`` reads its config and device from
the spec alone);
``--artifacts`` records each clean step's or merge step's cloud and a
``progress.json`` (``acquire/viewer.StageRecorder``). ``calibrate`` solves
the stereo rig on the host with OpenCV and prints the JAX CLI's tables;
``scan`` / ``auto-scan`` drive the capture rig of the ``acquire`` section
(``acquire.simulate=true``: a virtual projector and a simulated turntable,
frames still come from the phone through the capture server);
``capture-serve`` and ``viewer`` serve until interrupted (ctrl-C, exit 0).
``serve`` runs the multi-tenant scan service (``pipeline/serving.py``) on
``--device`` until SIGTERM/SIGINT, which drain it; ``tenant add`` mints a
tenant's API key for its ``--auth`` front door. ``warmup`` pre-pays a fresh
machine's first scan on the card: the kernels' ``nvcc`` build and the first
launch of each kernel family at the given shapes (the port has no compile
cache: ``--cache-dir`` is accepted and has no effect). ``doctor`` checks the
card (a bounded probe in a subprocess, the card's name and power limit), the
card lock, the kernel library and the native IO library, and exits 1 when
the probe fails.
Every command past ``config`` and ``report`` arms the fault-injection plan of the ``faults`` config section, which the
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
    p.add_argument("--view-plys", action="store_true",
                   help="pipeline.write_view_plys: also write each cleaned view as "
                        "<out>/views/*.ply (on the writeback queue; always binary)")
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
    p.add_argument("--incremental", dest="incremental", action="store_true",
                   default=None,
                   help="merge.incremental (coordinated runs with the streamed merge): "
                        "fold cleaned views and pair transforms into the merged "
                        "cloud as items settle, so only the postprocess remains "
                        "after the last item; the same bytes as the barrier assembly")
    p.add_argument("--no-incremental", dest="incremental", action="store_false",
                   help="the one assembly pass after the last item "
                        "(merge.incremental=false)")
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
    p.add_argument("--workers", type=int, default=None, metavar="N",
                   help="coordinated multiprocess mode (coordinator.workers): "
                        "lease per-view and per-pair items to N worker processes "
                        "on --device, with lease expiry and work stealing; a "
                        "killed worker costs only its in-flight items and the "
                        "output stays byte-identical to a single-process run "
                        "(grants journal to <out>/ledger.jsonl; a crashed "
                        "coordinator resumes with zero recompute)")
    _common_args(p)
    p = sub.add_parser(
        "worker",
        help="one coordinated-run worker process, started by 'pipeline --workers "
             "N' (or joining a listening coordinator with <out>/.coord/join.json)")
    p.add_argument("--spec", required=True,
                   help="worker spec JSON written by the coordinator "
                        "(<out>/.coord/workerN.json); it names the config and the "
                        "device")
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
    p = sub.add_parser("calibrate",
                       help="analyze calibration poses and solve the stereo rig")
    p.add_argument("base_dir", help="folder of per-pose capture folders")
    p.add_argument("--output", default=None,
                   help="calibration output file (default: <base_dir>/calib.mat)")
    p.add_argument("--analyze-only", action="store_true",
                   help="only print per-pose reprojection errors")
    p.add_argument("--poses", default=None,
                   help="comma list of pose folder names to use (default: auto "
                        "pruning by error ceilings)")
    p.add_argument("--max-cam-err", type=float, default=1.0)
    p.add_argument("--max-proj-err", type=float, default=2.0)
    p.add_argument("--review", default=None, metavar="ARTIFACT_DIR",
                   help="publish per-pose errors to this viewer artifact dir and "
                        "WAIT for the operator's in-viewer pose selection before "
                        "the final solve")
    p.add_argument("--review-timeout", type=float, default=600.0,
                   help="seconds to wait for the in-viewer selection before "
                        "falling back to auto pruning")
    _config_args(p)
    p = sub.add_parser("inspect-calib",
                       help="human-readable calibration summary (quality bands)")
    p.add_argument("calib", help="calibration file (.mat/.npz)")
    p.add_argument("--plot", default=None, metavar="PNG",
                   help="also render the 3-D rig geometry plot to this PNG "
                        "(needs matplotlib)")
    _config_args(p)
    p = sub.add_parser("capture-serve", help="run the phone-capture HTTP server")
    p.add_argument("--save-dir", default="captures",
                   help="where manual /upload images land")
    p.add_argument("--viewer", action="store_true",
                   help="also serve the artifact web viewer (next port up)")
    p.add_argument("--artifact-dir", default="artifacts",
                   help="directory the --viewer browses")
    _config_args(p)
    p = sub.add_parser("viewer",
                       help="web viewer for per-stage artifacts (PLY/STL/PNG) and "
                            "the calibration pose review")
    p.add_argument("artifact_dir")
    p.add_argument("--port", type=int, default=5051)
    _config_args(p)
    p = sub.add_parser("scan", help="capture one structured-light sequence")
    p.add_argument("save_dir")
    _config_args(p)
    p = sub.add_parser("auto-scan", help="full 360-degree turntable sweep")
    p.add_argument("output_root")
    p.add_argument("--base-name", default="scan")
    p.add_argument("--artifacts", default=None,
                   help="record live sweep progress (elapsed/remaining) into this "
                        "directory for the web viewer")
    _config_args(p)
    _serving_parsers(sub)
    return parser


def _serving_parsers(sub) -> None:
    """``serve``, ``tenant``, ``warmup`` and ``doctor``: the JAX CLI's
    flags, plus ``--device`` where the command computes."""
    p = sub.add_parser(
        "serve",
        help="persistent multi-tenant scan service: POST /submit scan requests, "
             "cross-tenant launches on one device, per-request SLOs, per-tenant "
             "quotas, Prometheus /metrics; every result byte-identical to a solo "
             "`pipeline` run. Durable: accepted requests survive kill -9 (a "
             "restart over the same root resumes them); SIGTERM/SIGINT drain")
    p.add_argument("root", help="service state directory (scans/, shared stage "
                                "cache, ledger.jsonl, requests/, serve.json)")
    p.add_argument("--host", default=None, help="bind address (default: serving.host)")
    p.add_argument("--port", type=int, default=None,
                   help="bind port, 0 = ephemeral (default: serving.port)")
    p.add_argument("--max-active-scans", type=int, default=None,
                   help="scans admitted to the engine at once "
                        "(default: serving.max_active_scans)")
    p.add_argument("--drain-budget", type=float, default=None,
                   help="seconds active scans get to finish after SIGTERM before "
                        "being checkpointed for the next start "
                        "(default: serving.drain_budget_s)")
    p.add_argument("--ready-file", default=None,
                   help="also write the bound-address JSON here once listening")
    p.add_argument("--ha", action="store_true", default=None,
                   help="join the leader-elected gateway group over this root "
                        "(serving.ha_enabled): one member owns the engine, the "
                        "rest serve reads and redirect /submit to the leader")
    p.add_argument("--ha-lease", type=float, default=None,
                   help="leader lease lifetime in seconds — the failover bound "
                        "(default: serving.ha_lease_s)")
    p.add_argument("--fleet", action="store_true", default=None,
                   help="elastic worker fleet (serving.fleet_enabled): the leader "
                        "autoscales `worker` processes on --device against live "
                        "queue signals and journals every decision to the ledger")
    p.add_argument("--fleet-max", type=int, default=None,
                   help="fleet size ceiling (default: serving.fleet_max_workers)")
    p.add_argument("--fleet-min", type=int, default=None,
                   help="fleet size floor kept warm even when idle "
                        "(default: serving.fleet_min_workers)")
    p.add_argument("--auth", action="store_true", default=None,
                   help="authenticated front door (serving.auth_enabled): /submit "
                        "requires a per-tenant API key from <root>/tenants.json "
                        "(`tenant add` mints one) and enforces per-tenant rate "
                        "limits; metered usage served at /usage")
    _common_args(p)
    p = sub.add_parser(
        "tenant",
        help="manage the authenticated front door's tenants: `tenant add <root> "
             "<name>` mints an API key (printed ONCE; only its sha256 lands in "
             "<root>/tenants.json), `tenant list <root>` shows who exists")
    p.add_argument("action", choices=("add", "list"))
    p.add_argument("root", help="service state directory (the one `serve` runs over)")
    p.add_argument("name", nargs="?", default=None, help="tenant name (add)")
    p.add_argument("--key", default=None,
                   help="use this key instead of minting one (key rotation; still "
                        "stored hashed)")
    p.add_argument("--rate-limit", type=int, default=None,
                   help="per-tenant submits allowed per window (overrides "
                        "serving.auth_rate_limit for this tenant)")
    p.add_argument("--rate-window", type=float, default=None,
                   help="sliding window seconds for --rate-limit")
    _common_args(p)
    p = sub.add_parser(
        "warmup",
        help="pre-pay a fresh machine's first scan on the card: build the kernels "
             "(nvcc) and launch each kernel family once at the given shapes")
    p.add_argument("--cam", default="1920x1080", help="camera WxH to warm")
    p.add_argument("--proj", default="1920x1080", help="projector WxH to warm")
    p.add_argument("--views", type=int, default=24,
                   help="view count of the forward_views launch")
    p.add_argument("--compute-batch", type=int, default=None,
                   help="also warm the batched lane's launches (raw, packed and the "
                        "fused clean) at this compute_batch (default: "
                        "parallel.compute_batch; 0 skips)")
    p.add_argument("--merge-views", type=int, default=24,
                   help="turntable views of the merge warm (0 skips it)")
    p.add_argument("--merge-cam", default="480x360")
    p.add_argument("--merge-proj", default="512x256")
    p.add_argument("--cache-dir", default=".jax_cache",
                   help="accepted for the JAX CLI's sake; the port has no compile "
                        "cache (its kernels live in ops/_kernel_build/<hash>/)")
    _common_args(p)
    p = sub.add_parser(
        "doctor",
        help="diagnose the execution environment: the card (bounded probe in a "
             "subprocess, name and power limit), the card lock, the kernel "
             "library, the native IO library and the optional modules")
    p.add_argument("--probe-timeout", type=float, default=60.0,
                   help="seconds before the card probe is declared hung")
    p.add_argument("--no-probe", action="store_true",
                   help="skip the card probe (report the rest at once; also the "
                        "switch for intentionally CPU-only setups)")
    p.add_argument("--root", default=".",
                   help="directory whose .gpu_lock to inspect (default: current "
                        "directory)")
    _config_args(p)


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
    if report.assembly:
        asm = report.assembly
        tail = asm.get("tail_s")
        print(f"[pipeline] assembly: {asm.get('used_views', 0)} of "
              f"{asm.get('folded_views', 0)} folded view(s) seeded the merge"
              + (f"; tail {tail}s after last item settled" if tail is not None else ""))
    if report.coordinator:
        c = report.coordinator
        print(f"[pipeline] coordinator: {c['items_total']} item(s) across "
              f"{c['workers']} worker(s), steals={c.get('steals', 0)}, "
              f"resumed={c.get('resumed_completed', 0)}; ledger -> {c['ledger']}")
        if c.get("listen"):
            fb = c.get("fabric") or {}
            print(f"[pipeline] fabric: listening on {c['listen']}; blob "
                  f"fetches={fb.get('fetches', 0)} pushes={fb.get('pushes', 0)} "
                  f"dedups={fb.get('dedups', 0)} ({fb.get('bytes_fetched', 0)} B out / "
                  f"{fb.get('bytes_pushed', 0)} B in / {fb.get('bytes_deduped', 0)} B "
                  f"deduped); locality hits={c.get('locality_hits', 0)} "
                  f"misses={c.get('locality_misses', 0)}")
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


def _calibrate(args, cfg) -> int:
    """``calibrate``: per-pose errors, pose selection (``--poses``, the
    viewer's ``--review``, else automatic pruning) and the stereo solve."""
    from structured_light_for_3d_model_replication_tpu_torch.calib import chessboard as cb
    from structured_light_for_3d_model_replication_tpu_torch.calib import inspect as ci
    from structured_light_for_3d_model_replication_tpu_torch.calib import pipeline as cp

    board = cb.BoardSpec(rows=cfg.checkerboard.rows, cols=cfg.checkerboard.cols,
                         square_size=cfg.checkerboard.square_size_mm)
    proj_size = (cfg.projector.width, cfg.projector.height)
    errors, observations, img_shape = cp.analyze_calibration(
        args.base_dir, board=board, proj_size=proj_size)
    print(f"{'pose':<20} {'cam px':>8} {'proj px':>8}  quality")
    for pose, (ec, ep) in sorted(errors.items()):
        print(f"{pose:<20} {ec:>8.3f} {ep:>8.3f}  {ci.quality_band(ec)}")
    if args.analyze_only:
        return 0
    if args.poses:
        selected = [p.strip() for p in args.poses.split(",") if p.strip()]
    elif args.review:
        from structured_light_for_3d_model_replication_tpu_torch.acquire import (
            viewer as viewerlib,
        )

        viewerlib.publish_pose_review(args.review, errors)
        print(f"pose review published to {args.review} — select poses in "
              f"the viewer (sl3d viewer {args.review}); waiting up to "
              f"{args.review_timeout:.0f}s...")
        selected = viewerlib.await_pose_selection(args.review, args.review_timeout)
        if selected is not None:
            selected = [s for s in selected if s in errors]
        if not selected:  # timeout, empty selection, or no matching names
            print("no usable selection received — falling back to auto pruning")
            selected = cp.select_poses(errors, args.max_cam_err, args.max_proj_err)
    else:
        selected = cp.select_poses(errors, args.max_cam_err, args.max_proj_err)
    print(f"using {len(selected)}/{len(errors)} poses: {', '.join(sorted(selected))}")
    output = args.output or os.path.join(args.base_dir, "calib.mat")
    cp.calibrate_and_save(args.base_dir, output, selected_poses=selected,
                          board=board, proj_size=proj_size,
                          observations=observations, img_shape=img_shape)
    return 0


def _inspect_calib(args) -> int:
    from structured_light_for_3d_model_replication_tpu_torch.calib import inspect as ci
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile

    calib = matfile.load_calibration(args.calib)
    print(ci.format_summary(ci.summarize_calibration(calib)))
    if args.plot:
        from structured_light_for_3d_model_replication_tpu_torch.calib import visualize

        info = visualize.plot_rig(calib, args.plot)
        print(f"rig plot -> {info['plot']}")
    return 0


def _serve_until_interrupted(*servers) -> int:
    import time

    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        for srv in servers:
            if srv is not None:
                srv.stop()
    return 0


def _capture_serve(args, cfg) -> int:
    from structured_light_for_3d_model_replication_tpu_torch.acquire.server import (
        CaptureServer,
    )

    a = cfg.acquire
    os.makedirs(args.save_dir, exist_ok=True)
    srv = CaptureServer(a.http_host, a.http_port, poll_hold=a.long_poll_hold_s,
                        disconnect_after=a.disconnect_after_s,
                        upload_dir=args.save_dir).start()
    print(f"capture server on http://{a.http_host}:{srv.port} "
          f"(open this on the phone; ctrl-C to stop)", flush=True)
    view = None
    if args.viewer:
        from structured_light_for_3d_model_replication_tpu_torch.acquire.viewer import (
            ViewerServer,
        )

        os.makedirs(args.artifact_dir, exist_ok=True)
        view = ViewerServer(args.artifact_dir, a.http_host, srv.port + 1).start()
        print(f"artifact viewer on http://{a.http_host}:{view.port}", flush=True)
    return _serve_until_interrupted(srv, view)


def _viewer(args, cfg) -> int:
    from structured_light_for_3d_model_replication_tpu_torch.acquire.viewer import (
        ViewerServer,
    )

    host = cfg.acquire.http_host
    view = ViewerServer(args.artifact_dir, host, args.port).start()
    print(f"artifact viewer on http://{host}:{view.port} "
          f"(serving {args.artifact_dir}; ctrl-C to stop)", flush=True)
    return _serve_until_interrupted(view)


def _build_capture_rig(cfg):
    """Capture server + projector + sequencer + turntable from the
    ``acquire`` and ``projector`` sections."""
    from structured_light_for_3d_model_replication_tpu_torch.acquire.projector import (
        open_projector,
    )
    from structured_light_for_3d_model_replication_tpu_torch.acquire.sequencer import (
        CaptureSequencer,
    )
    from structured_light_for_3d_model_replication_tpu_torch.acquire.server import (
        CaptureServer,
    )
    from structured_light_for_3d_model_replication_tpu_torch.acquire.turntable import (
        open_turntable,
    )

    a = cfg.acquire
    server = CaptureServer(a.http_host, a.http_port, poll_hold=a.long_poll_hold_s,
                           disconnect_after=a.disconnect_after_s).start()
    projector = open_projector("virtual" if a.simulate else "auto",
                               screen_offset_x=cfg.projector.screen_offset_x)
    sequencer = CaptureSequencer(
        projector,
        lambda path: server.trigger_capture(path, timeout=a.capture_timeout_s),
        proj_size=(cfg.projector.width, cfg.projector.height),
        brightness=cfg.projector.brightness,
        downsample=cfg.projector.downsample,
        scan_settle_ms=a.settle_ms_scan, calib_settle_ms=a.settle_ms_calib,
        pack_frames=a.pack_frames, pack_keep_raw=a.pack_keep_raw,
    )
    turntable = open_turntable("sim" if a.simulate else "auto",
                               port=a.serial_port or None)
    return server, projector, sequencer, turntable


def _close_rig(server, projector, turntable) -> None:
    projector.close()
    server.stop()
    if hasattr(turntable, "close"):
        turntable.close()


def _scan(args, cfg) -> int:
    server, projector, sequencer, turntable = _build_capture_rig(cfg)
    try:
        sequencer.capture_scan(args.save_dir)
    finally:
        _close_rig(server, projector, turntable)
    return 0


def _auto_scan(args, cfg) -> int:
    from structured_light_for_3d_model_replication_tpu_torch.acquire.autoscan import (
        auto_scan_360,
    )

    progress = StageRecorder(args.artifacts).autoscan_progress if args.artifacts else None
    server, projector, sequencer, turntable = _build_capture_rig(cfg)
    a = cfg.acquire
    try:
        result = auto_scan_360(
            sequencer, turntable, args.output_root, turns=a.turns,
            step_deg=a.degrees_per_turn, base_name=args.base_name,
            rotate_timeout=a.rotate_timeout_s, capture_retries=a.capture_retries,
            rotate_retries=a.rotate_retries, progress=progress)
    finally:
        _close_rig(server, projector, turntable)
    return 0 if result.view_dirs else 1


def _serve(args, cfg) -> int:
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import serving

    s = cfg.serving
    if args.host is not None:
        s.host = args.host
    if args.port is not None:
        s.port = args.port
    if args.max_active_scans is not None:
        s.max_active_scans = args.max_active_scans
    if args.drain_budget is not None:
        s.drain_budget_s = args.drain_budget
    if args.ha:
        s.ha_enabled = True
    if args.ha_lease is not None:
        s.ha_lease_s = args.ha_lease
    if args.fleet:
        s.fleet_enabled = True
    if args.fleet_max is not None:
        s.fleet_max_workers = args.fleet_max
    if args.fleet_min is not None:
        s.fleet_min_workers = args.fleet_min
    if args.auth:
        s.auth_enabled = True
    if hasattr(sys.stdout, "reconfigure"):
        sys.stdout.reconfigure(line_buffering=True)
    return serving.serve(args.root, cfg=cfg, ready_file=args.ready_file,
                         device=args.device)


def _tenant(args) -> int:
    import secrets

    from structured_light_for_3d_model_replication_tpu_torch.parallel import admission
    from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
        resolve_device,
    )

    resolve_device(args.device)
    path = os.path.join(args.root, "tenants.json")
    if args.action == "list":
        auth = admission.TenantAuth(path)
        names = auth.known()
        if not names:
            print(f"no tenants in {path}")
            return 0
        for name in names:
            lim = auth.tenant_limits(name)
            print(f"{name}{f'  rate {lim[0]}/{lim[1]:g}s' if lim else ''}")
        return 0
    if not args.name:
        print("tenant add needs a name", file=sys.stderr)
        return 1
    key = args.key or secrets.token_hex(16)
    os.makedirs(args.root, exist_ok=True)
    admission.write_tenant(path, args.name, key, rate_limit=args.rate_limit,
                           rate_window_s=args.rate_window)
    # the only time the plaintext exists outside the client: tenants.json
    # holds its sha256 only
    print(f"tenant {args.name!r} written to {path}")
    print(f"API key (save it — shown once): {key}")
    return 0


def _wh(text: str) -> tuple[int, int]:
    w, h = text.lower().split("x")
    return int(w), int(h)


def _warmup(args, cfg) -> int:
    """Pre-pay what a fresh machine pays on its first scan: the kernels'
    build, then each kernel family's first launch at the given shapes
    (``kernels.first_launch_ms`` times each entry's first launch by CUDA
    events), each step's wall beside it."""
    import time

    import numpy as np
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device(args.device)
    if args.cache_dir != ".jax_cache":
        print(f"[warmup] --cache-dir {args.cache_dir!r} has no effect: the port has "
              f"no compile cache", file=sys.stderr)
    if dev.type != "cuda":
        print(f"[warmup] device {dev}: the CPU runs the kernels' plain versions and "
              f"has no kernels to build; nothing to warm")
        return 0
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models.scanner import (
        SLScanner,
    )
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.ops import _build, kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import fused_view as fvlib
    from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc
    from structured_light_for_3d_model_replication_tpu_torch.ops import triangulate as tri
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
    from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

    built = os.path.isfile(_build.library_path())
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[warmup] kernel library {'found built' if built else 'built'} in "
          f"{time.perf_counter() - t0:.2f}s -> {_build.library_path()}", flush=True)
    cam, proj = _wh(args.cam), _wh(args.proj)
    base = gc.generate_pattern_stack(proj[0], proj[1])
    yi = (np.arange(cam[1]) * proj[1]) // cam[1]
    xi = (np.arange(cam[0]) * proj[0]) // cam[0]
    frames = np.ascontiguousarray(base[:, yi[:, None], xi[None, :]])
    calib = syn.default_rig(cam_size=cam, proj_size=proj).calibration()
    kw = dict(thresh_mode="manual")
    steps: list[tuple[str, float, dict]] = []

    def step(name: str, fn):
        with kernels.first_launch_ms() as first:
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t) * 1e3
        steps.append((name, wall, first))
        print(f"[warmup] {name}: {wall:.1f} ms"
              + "".join(f"; {k} first launch {v:.3f} ms" for k, v in first.items()
                        if k not in {e for _, _, f in steps[:-1] for e in f}),
              flush=True)
        return out

    sc = None
    for plane_eval in ("quadratic", "table"):
        sc = SLScanner(calib, cam, proj, row_mode=1, plane_eval=plane_eval, device=dev)
        res = step(f"forward[{plane_eval}] {cam[0]}x{cam[1]}",
                   lambda: sc.forward(frames, **kw))
    if args.views > 1:
        stack = np.stack([np.roll(frames, 7 * i, axis=2) for i in range(args.views)])
        step(f"forward_views[{args.views}]", lambda: sc.forward_views(stack, **kw))
        del stack
    cb = args.compute_batch if args.compute_batch is not None else cfg.parallel.compute_batch
    if cb > 1:
        stack = np.stack([np.roll(frames, 7 * i, axis=2) for i in range(cb)])
        res = step(f"batched lane[{cb}]", lambda: sc.forward_views_batched(stack, **kw))
        step(f"fused_clean[{cb}]", lambda: fvlib.fused_clean_views(
            res.points, res.colors, res.valid, cfg.clean, stages.CLEAN_STEPS))
        packed = [imio.pack_stack(v) for v in stack]
        step(f"forward_views_packed[{cb}]", lambda: sc.forward_views_packed(
            np.stack([p.planes for p in packed]), np.stack([p.white for p in packed]),
            np.stack([p.black for p in packed]), n_frames=int(frames.shape[0]), **kw))
        del stack, packed
    pts, cols = tri.compact_cloud(res if cb <= 1 else tri.CloudResult(
        res.points[0], res.colors[0], res.valid[0]))
    step(f"clean chain[{len(pts)} points]", lambda: stages._clean_arrays(
        pts, cols, cfg, stages.CLEAN_STEPS, device=dev))
    if args.merge_views > 1:
        mcam, mproj = _wh(args.merge_cam), _wh(args.merge_proj)
        mrig = syn.default_rig(cam_size=mcam, proj_size=mproj)
        scene = syn.Scene([syn.Sphere(np.array([0.0, 0.0, 420.0]), 70.0),
                           syn.Sphere(np.array([55.0, -40.0, 360.0]), 28.0),
                           syn.Sphere(np.array([-48.0, 35.0, 370.0]), 22.0)])
        t = time.perf_counter()
        clouds = []
        for R, tr in syn.turntable_poses(args.merge_views, 360.0 / args.merge_views,
                                         pivot=np.array([0.0, 0.0, 400.0])):
            vf, _ = syn.render_scene(mrig, scene.transformed(R, tr))
            dec = gc.decode_stack_np(vf, n_cols=mproj[0], n_rows=mproj[1],
                                     thresh_mode="manual")
            cloud = tri.triangulate_np(dec.col_map, dec.row_map, dec.mask, dec.texture,
                                       mrig.calibration(), row_mode=1)
            p, c = tri.compact_cloud(cloud)
            clouds.append((p.astype(np.float32), c.astype(np.uint8)))
        print(f"[warmup] rendered {args.merge_views} merge views on the host in "
              f"{time.perf_counter() - t:.1f}s", flush=True)
        step(f"merge chain[{args.merge_views}]", lambda: recon.merge_360(
            clouds, cfg=cfg.merge, log=lambda m: None, device=dev))
    seen = {e for _, _, f in steps for e in f}
    for k in kernels.KERNELS:
        if not any(e.startswith(f"slscan_{k.__name__}") for e in seen):
            print(f"[warmup] {k.__name__}: not launched at these shapes")
    print(f"[warmup] done: {len(seen)} kernel entries launched; later processes "
          f"find the library built")
    return 0


def _doctor(args) -> int:
    """One-shot environment diagnosis; every check is bounded (the card
    probe runs in a subprocess, ``nvidia-smi`` under a timeout)."""
    import subprocess

    from structured_light_for_3d_model_replication_tpu_torch.io import native
    from structured_light_for_3d_model_replication_tpu_torch.ops import _build
    from structured_light_for_3d_model_replication_tpu_torch.utils import gpulock
    from structured_light_for_3d_model_replication_tpu_torch.utils.preflight import (
        accelerator_preflight,
    )

    ok = True
    root = os.path.abspath(args.root)
    if args.no_probe:
        print("[doctor] card: probe skipped (--no-probe)")
    else:
        status, detail = accelerator_preflight(timeout=args.probe_timeout, cwd=root)
        healthy = status == "ok" and detail != "cpu"
        print(f"[doctor] card: {'ok' if healthy else 'FAIL'} — {status} ({detail})")
        if status == "ok" and detail == "cpu":
            print("[doctor]   no CUDA device is visible; intentionally CPU-only? "
                  "use --no-probe and --device cpu")
        ok = ok and healthy
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        rows = smi.stdout.strip().splitlines() if smi.returncode == 0 else []
        print("[doctor] nvidia-smi: " + ("; ".join(rows) if rows else
                                         f"exit {smi.returncode}"))
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"[doctor] nvidia-smi: unavailable ({type(e).__name__})")
    held, detail = gpulock.probe_gpu_lock(root)
    print(f"[doctor] gpu lock: {'HELD (' + detail + ') — another card client is '
                                'active; it releases on exit' if held else detail}")
    lib = _build.library_path()
    if os.path.isfile(lib):
        print(f"[doctor] kernel library: built for the current sources ({lib})")
    else:
        print(f"[doctor] kernel library: not built for the current sources — the "
              f"first scan on the card runs nvcc; `warmup` pre-pays it ({lib})")
    path, why = native.status()
    print(f"[doctor] native slio: {'available (' + path + ')' if path else 'unavailable'}"
          + (f" — {why}" if why and not path else ""))
    for mod, why in (("cv2", "chessboard detection / projector window"),
                     ("serial", "hardware turntable"),
                     ("matplotlib", "calibration rig plots")):
        try:
            __import__(mod)
            print(f"[doctor] {mod}: available")
        except ImportError:
            print(f"[doctor] {mod}: absent — {why} unavailable (everything else works)")
    print(f"[doctor] {'all core checks passed' if ok else 'ISSUES FOUND'}")
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 1
    if args.command == "synth":
        return _synth(args)
    if args.command == "worker":
        # config, faults, device and identity all come from the spec the
        # coordinator wrote: the worker sees exactly the coordinator's
        # resolved config. Line-buffered, so a killed worker's log is whole.
        from structured_light_for_3d_model_replication_tpu_torch.parallel import worker

        if hasattr(sys.stdout, "reconfigure"):
            sys.stdout.reconfigure(line_buffering=True)
        return worker.run_worker(args.spec)
    cfg = load_config(args.config, parse_overrides(args.set))
    if args.command == "config":
        json.dump(jax_dict(cfg), sys.stdout, indent=2)
        print()
        return 0
    if args.command == "report":
        return _report(args, cfg)
    if args.command == "doctor":
        return _doctor(args)
    if args.command == "tenant":
        return _tenant(args)
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
    if args.command == "calibrate":
        return _calibrate(args, cfg)
    if args.command == "inspect-calib":
        return _inspect_calib(args)
    if args.command == "capture-serve":
        return _capture_serve(args, cfg)
    if args.command == "viewer":
        return _viewer(args, cfg)
    if args.command == "scan":
        return _scan(args, cfg)
    if args.command == "auto-scan":
        return _auto_scan(args, cfg)
    if args.command == "serve":
        return _serve(args, cfg)
    if args.command == "warmup":
        return _warmup(args, cfg)
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
        if args.view_plys:
            cfg.pipeline.write_view_plys = True
        if args.ascii:
            cfg.pipeline.ascii_output = True
        if args.fused_clean is not None:
            cfg.pipeline.fused_clean = args.fused_clean
        if args.stream is not None:
            cfg.merge.stream = args.stream
        if args.pair_batch is not None:
            cfg.merge.pair_batch = args.pair_batch
        if args.incremental is not None:
            cfg.merge.incremental = args.incremental
        if args.packed_ingest is not None:
            cfg.pipeline.packed_ingest = args.packed_ingest
        if args.trace:
            cfg.observability.trace = True
        if args.run_budget is not None:
            cfg.pipeline.run_budget_s = args.run_budget
        if args.no_deadlines:
            cfg.deadlines.enabled = False
        if args.workers is not None:
            cfg.coordinator.workers = args.workers
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
