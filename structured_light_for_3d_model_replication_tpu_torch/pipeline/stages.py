"""File-level stages: scan folders -> per-view colored PLY -> cleaned views
-> merged cloud -> mesh, and the whole chain in one process.

``run_pipeline`` is the port's main path (the JAX package's ``sl3d
pipeline``) and runs its default schedule: capture folders -> per-view
clouds -> the masked clean chain -> 360-degree merge -> Poisson mesh ->
``merged.ply`` + ``model.stl``, the clouds handed stage to stage in memory.

  - Every stage sits behind the content-addressed stage cache under
    ``<out>/.slscan-cache`` (``pipeline/stagecache.py``): a rerun recomputes
    only the stages whose inputs changed.
  - A view whose load, compute or clean fails retries transient faults
    under ``pipeline.max_retries``; an exhausted or permanent failure
    quarantines the view (``<out>/quarantine/<view>.json``) and the run
    completes DEGRADED above ``max(2, pipeline.min_views)`` views, with a
    ``failures.json`` manifest; below the floor it aborts.
  - ``deadlines`` bound every lane wait, a watchdog turns silent lanes into
    ``stalls.json``, and ``pipeline.run_budget_s`` aborts the whole run.
  - ``merge.stream`` (default) registers pair (i, i+1) on a worker thread
    while later views are still being cleaned (``_StreamRegistrar``); the
    barrier arm runs ``merge_360`` after the last view. Both arms give the
    same bytes.

Not ported: the coordinator, ``parallel.merge_mesh``, ``merge.method=
'posegraph'`` (``merge_360`` raises), the incremental assembly prefold, the
prefetch pool and the writeback queue.

``clean_cloud`` / ``clean_batch`` (``sl3d clean``), ``merge_views``
(``sl3d merge-360``) and ``mesh_cloud`` (``sl3d mesh``) are the file-level
stages.

``reconstruct`` is the port's user entry point of the scan path (the JAX
package's ``sl3d reconstruct``): it resolves the scan sources, builds one
SLScanner on the device, and runs one of three lanes:

  serial   one view per device launch (``parallel.compute_batch <= 1`` or a
           single source)
  batched  ``compute_batch`` views per launch, frames stacked [V, F, H, W]
  packed   the batched lane fed packed bit-planes (``pipeline.packed_ingest``):
           ~8x fewer bytes to the device, byte-identical PLYs

Each lane loads and computes a view under the retry budget, records a view
that still fails as a ``FailureRecord`` and goes on. The batched lane fires
``compute.view`` per view at batch assembly; any failure of a batch re-runs
its views one at a time, so one bad view never quarantines its batchmates.
Outputs follow the JAX package's path contract: ``<output>/<view>.ply`` for
batch/files mode, ``output`` itself (or ``<target>.ply``) for single mode.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.config import Config
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import atomic, matfile, ply
from structured_light_for_3d_model_replication_tpu_torch.models import meshing
from structured_light_for_3d_model_replication_tpu_torch.models import (
    reconstruction as recon,
)
from structured_light_for_3d_model_replication_tpu_torch.models.scanner import (
    SLScanner,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc
from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
from structured_light_for_3d_model_replication_tpu_torch.ops import normals as nrm
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    triangulate as tri,
)
from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (
    StageCache,
    config_subtree,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import deadline as dl
from structured_light_for_3d_model_replication_tpu_torch.utils import faults
from structured_light_for_3d_model_replication_tpu_torch.utils import profiling as prof
from structured_light_for_3d_model_replication_tpu_torch.utils import telemetry as tel
from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["BatchReport", "reconstruct", "reconstruct_source",
           "sort_ply_paths_by_angle", "merge_views", "CLEAN_STEPS", "clean_cloud",
           "clean_batch", "mesh_cloud", "PipelineReport", "run_pipeline"]

CLEAN_STEPS = pc.CLEAN_STEPS

_DEG_RE = re.compile(r"(\d+(?:\.\d+)?)\s*deg", re.IGNORECASE)


@dataclass
class BatchReport:
    """What one reconstruct run wrote, and how. ``failures`` holds the
    structured record of every ``failed`` tuple; ``retries`` counts the
    transient-fault retries taken."""

    outputs: list[str] = field(default_factory=list)
    points: list[int] = field(default_factory=list)  # per output
    failed: list[tuple[str, str]] = field(default_factory=list)  # (input, error)
    failures: list[faults.FailureRecord] = field(default_factory=list)
    retries: int = 0
    lane: str = ""          # serial | batched | packed
    launches: int = 0       # device forward calls (one per batch)
    device: str = ""
    elapsed_s: float = 0.0
    overlap: dict | None = None  # OverlapStats.as_dict() of the lane
    run_id: str | None = None

    @property
    def summary(self) -> str:
        retr = f", {self.retries} retried" if self.retries else ""
        return (f"{len(self.outputs)}/{len(self.outputs) + len(self.failed)} view(s) "
                f"on {self.device} in {self.elapsed_s:.2f}s ({self.lane} lane, "
                f"{self.launches} launch(es){retr})")


def _scan_sources(target: str, mode: str, need: int, log=None) -> list[str]:
    """``target`` -> scan sources: ``single`` is the folder itself, ``batch``
    every sub-folder with at least ``need`` frames (the others are logged
    and skipped), ``files`` a comma-separated list."""
    if mode == "single":
        return [target]
    if mode == "batch":
        out = []
        for s in sorted(os.path.join(target, d) for d in os.listdir(target)
                        if os.path.isdir(os.path.join(target, d))):
            try:
                n = imio.count_frames(s)
            except (FileNotFoundError, NotADirectoryError, IOError):
                if log is not None:
                    log(f"[reconstruct] skipping {s}: no frame images found")
                continue
            if n >= need:
                out.append(s)
            elif log is not None:
                log(f"[reconstruct] skipping {s}: {n} frames < {need} "
                    f"required (partial capture?)")
        return out
    if mode == "files":
        return [p.strip() for p in target.split(",") if p.strip()]
    raise ValueError(f"unknown reconstruct mode {mode!r} (single|batch|files)")


def _item_name(src) -> str:
    return os.path.basename(os.path.normpath(src)) or "cloud"


def _out_path_for(src, mode: str, output: str | None) -> str:
    if mode == "single" and output:
        return output
    if output:
        return os.path.join(output, f"{_item_name(src)}.ply")
    return os.path.normpath(src) + ".ply"


def _forward_kw(cfg: Config) -> dict:
    d = cfg.decode
    return dict(thresh_mode=d.thresh_mode, shadow_val=d.shadow_val,
                contrast_val=d.contrast_val)


def _build_scanner(sources, calib: dict, cfg: Config, device=None) -> SLScanner:
    """One SLScanner for the run; the camera size comes from the first
    source (packed header or first frame)."""
    if cfg.triangulate.bitexact:
        raise ValueError("triangulate.bitexact is not ported yet")
    first = imio.list_frame_files(sources[0])
    hdr = imio.probe_packed(first[0])
    if hdr is not None:
        cam_size = (int(hdr["width"]), int(hdr["height"]))
    else:
        probe = imio.load_gray(first[0])
        cam_size = (probe.shape[1], probe.shape[0])
    return SLScanner(
        calib, cam_size, proj_size=(cfg.decode.n_cols, cfg.decode.n_rows),
        row_mode=cfg.triangulate.row_mode,
        epipolar_tol=cfg.triangulate.epipolar_tol,
        n_sets_col=cfg.decode.n_sets_col, n_sets_row=cfg.decode.n_sets_row,
        downsample=cfg.projector.downsample,
        plane_eval=cfg.triangulate.plane_eval, device=device)


def reconstruct_source(source, calib: dict, cfg: Config, scanner=None,
                       device=None) -> tuple[np.ndarray, np.ndarray]:
    """One scan source -> compact (points [M, 3] f32, colors [M, 3] u8)."""
    scanner = scanner or _build_scanner([source], calib, cfg, device)
    frames, _ = imio.load_stack(source, io_workers=cfg.parallel.io_workers)
    return tri.compact_cloud(scanner.forward(frames, **_forward_kw(cfg)))


# ---------------------------------------------------------------------------
# the failure domain: retries, lane deadlines, the run budget, records
# ---------------------------------------------------------------------------

def _retry_policy(cfg: Config) -> faults.RetryPolicy:
    """The per-view transient-retry budget, from ``pipeline.*``."""
    return faults.RetryPolicy(
        max_retries=cfg.pipeline.max_retries,
        backoff_base_s=cfg.pipeline.retry_backoff_s,
        backoff_max_s=cfg.pipeline.retry_backoff_max_s,
        jitter=cfg.pipeline.retry_jitter)


def _retry_stage(stage: str, fn, policy: faults.RetryPolicy, on_retry=None):
    """``faults.retry_call`` with the failing stage annotated onto the final
    exception, so the FailureRecord built downstream names the right lane."""
    try:
        return faults.retry_call(fn, policy, on_retry=on_retry)
    except faults.InjectedCrash:
        raise
    except Exception as e:
        faults.annotate(e, stage=stage)
        raise


def _stage_retry(policy: faults.RetryPolicy, report: BatchReport,
                 stats: prof.OverlapStats, log, name: str):
    """``retry(stage, fn)`` for one view: ``fn`` under the retry budget,
    each retry counted in the report and in the lane's stats."""

    def retry(stage: str, fn):
        def on_retry(n, e):
            report.retries += 1
            stats.add_retry(stage)
            log(f"[reconstruct] {name}: transient {type(e).__name__} in {stage} "
                f"({e}); retry {n}/{policy.max_retries} after "
                f"{policy.delay_s(n):.2f}s backoff")
        return _retry_stage(stage, fn, policy, on_retry)

    return retry


def _lane_budget_s(cfg: Config, lane: str) -> float | None:
    """The bounded-wait budget of one lane's wait, or None (a plain blocking
    wait) when the deadline layer is off or the lane budget is 0; never past
    the run budget."""
    dcfg = cfg.deadlines
    if not dcfg.enabled:
        return None
    budget = getattr(dcfg, f"{lane}_s", 0.0)
    if budget <= 0:
        return None
    ctx = dl.current()
    if ctx is not None and ctx.run_deadline is not None:
        budget = min(budget, max(0.05, ctx.run_deadline.remaining()))
    return budget


def _lane_wait(fut, cfg: Config, lane: str, what: str):
    """Bounded ``Future.result`` of one lane item: a stalled worker costs
    its item a DeadlineExceeded (annotated with the lane) instead of
    hanging the run."""
    try:
        return dl.wait_future(fut, _lane_budget_s(cfg, lane), what=what)
    except dl.DeadlineExceeded as e:
        faults.annotate(e, stage=lane)
        raise


def _budget_check(what: str) -> None:
    """The ``pipeline.run_budget_s`` check (the ABORT path), at stage
    boundaries and lane scheduling steps."""
    ctx = dl.current()
    if ctx is not None:
        ctx.check_run_budget(what)


def _record_failure(report: BatchReport, src, name: str, exc: BaseException,
                    log, stats: prof.OverlapStats, default_stage: str = "compute") -> None:
    """One per-view failure -> log line + ``failed`` tuple + FailureRecord."""
    rec = faults.FailureRecord.from_exception(default_stage, name, exc)
    log(f"[reconstruct] {name} FAILED ({rec.stage}, attempt {rec.attempts}): {exc}")
    report.failed.append((src, str(exc)))
    report.failures.append(rec)
    tr = tel.current()
    if tr is not None:
        tr.instant("failure.record", view=name, stage=rec.stage,
                   error=rec.error_type, attempts=rec.attempts,
                   transient=rec.transient)
    stats.add_failure(rec.stage if rec.stage in prof.OverlapStats._STAGES
                      else default_stage)


@contextlib.contextmanager
def _run_context(cfg: Config, out_dir: str | None, run_id: str, log):
    """The deadline layer of one run: the run budget and the lane watchdog,
    installed process-wide for the block; a no-op when ``deadlines`` is off
    or an enclosing run already installed one."""
    dcfg = cfg.deadlines
    if not dcfg.enabled or dl.current() is not None:
        yield None
        return
    ctx = dl.RunContext(run_deadline=dl.Deadline.after(cfg.pipeline.run_budget_s,
                                                       "pipeline run"))
    if dcfg.hard_stall_s > 0 or dcfg.soft_stall_s > 0:
        ctx.watchdog = dl.Watchdog(dcfg.soft_stall_s, dcfg.hard_stall_s, ctx.token,
                                   poll_s=dcfg.watchdog_poll_s, out_dir=out_dir,
                                   run_id=run_id, log=log)
    prev = dl.activate(ctx)
    if ctx.watchdog is not None:
        ctx.watchdog.start()
    if ctx.run_deadline is not None:
        log(f"[pipeline] run budget armed: {cfg.pipeline.run_budget_s:g}s")
    try:
        yield ctx
    finally:
        # wake lingering cancel-aware sleeps so teardown never outlives them
        ctx.token.cancel("run ended")
        if ctx.watchdog is not None:
            ctx.watchdog.stop()
            if ctx.watchdog.breaches:
                log(f"[pipeline] watchdog recorded {len(ctx.watchdog.breaches)} "
                    f"stall breach(es)" + (f" -> {ctx.watchdog.stalls_path}"
                                           if ctx.watchdog.stalls_path else ""))
        dl.deactivate(prev)


# ---------------------------------------------------------------------------
# the reconstruct lanes
# ---------------------------------------------------------------------------

def _load_fired(src, cfg: Config) -> np.ndarray:
    """A view's frame stack [F, H, W] behind the ``frame.load`` site (and
    ``frame.pack`` for a packed source, whose unpack is the codec step)."""
    dl.beat("load")
    faults.fire("frame.load", item=src)
    if imio.packed_file(src) is not None:
        dl.beat("load")
        faults.fire("frame.pack", item=src)
    return imio.load_stack(src, io_workers=cfg.parallel.io_workers)[0]


def _load_packed_fired(src, cfg: Config) -> imio.PackedStack:
    """Packed ingest: a packed source loads its container, a raw source
    packs at load, behind ``frame.load`` and ``frame.pack``."""
    dl.beat("load")
    faults.fire("frame.load", item=src)
    if imio.packed_file(src) is not None:
        dl.beat("load")
        faults.fire("frame.pack", item=src)
        return imio.load_packed_stack(src)
    frames, texture = imio.load_stack(src, io_workers=cfg.parallel.io_workers)
    dl.beat("load")
    faults.fire("frame.pack", item=src)
    return imio.pack_stack(frames, texture=texture)


def _compute_fired(scanner: SLScanner, frames, cfg: Config, src,
                   use_fused: bool | None = None):
    """One view's decode + triangulate + compaction behind ``compute.view``.
    ``use_fused=False`` is the per-view twin of the packed lane (decode +
    triangulate, as ``forward_views_packed``)."""
    dl.beat("compute")
    faults.fire("compute.view", item=src)
    out = scanner.forward_views(np.asarray(frames)[None], use_fused=use_fused,
                                **_forward_kw(cfg))
    return tri.compact_cloud(tri.CloudResult(out.points[0], out.colors[0], out.valid[0]))


def _reconstruct_serial(sources, cfg, scanner, report, emit, log, stats) -> None:
    """One view a launch. ``emit(src, points, colors, retry)`` takes each
    compact cloud (a PLY write, or the pipeline's clean + collect) and runs
    its own steps through ``retry(stage, fn)``. A view that fails after its
    retries is recorded and the loop goes on."""
    policy = _retry_policy(cfg)
    for src in sources:
        _budget_check("reconstruct")
        name = _item_name(src)
        retry = _stage_retry(policy, report, stats, log, name)
        try:
            t0 = time.perf_counter()
            frames = retry("load", lambda: _load_fired(src, cfg))
            stats.add("load", time.perf_counter() - t0, view=name)
            t0 = time.perf_counter()
            pts, cols = retry("compute", lambda: _compute_fired(scanner, frames, cfg, src))
            report.launches += 1
            stats.add("compute", time.perf_counter() - t0, items=1, view=name)
            emit(src, pts, cols, retry)
        except Exception as e:
            _record_failure(report, src, name, e, log, stats)


def _reconstruct_batched(sources, cfg, scanner, report, emit, log, stats,
                         packed: bool) -> None:
    """``compute_batch`` views per device launch, each compact cloud to
    ``emit`` as in the serial lane. Stacks of one batch must share a shape;
    a change of shape closes the batch early. ``compute.view`` fires per
    view at batch assembly; a fault there re-runs the batch's views one at
    a time under the retry budget (a packed stack unpacks for it: decode +
    triangulate of the binarized stack is the packed lane's bit for bit).
    So does a failure of the batched launch on the CPU, as in the JAX
    package; on the card it fails the run, so a kernel that fails at the
    batch's shape never passes as a per-view success."""
    batch_n = max(1, cfg.parallel.compute_batch)
    policy = _retry_policy(cfg)
    loader = _load_packed_fired if packed else _load_fired

    def retry_for(src):
        return _stage_retry(policy, report, stats, log, _item_name(src))

    def load(src):
        t0 = time.perf_counter()
        out = retry_for(src)("load", lambda: loader(src, cfg))
        stats.add("load", time.perf_counter() - t0, view=_item_name(src))
        return out

    def finish(src, pts, cols):
        try:
            emit(src, pts, cols, retry_for(src))
        except Exception as e:
            _record_failure(report, src, _item_name(src), e, log, stats)

    def one_view(src, stack):
        frames = imio.unpack_stack(stack)[0] if packed else stack
        try:
            t0 = time.perf_counter()
            pts, cols = retry_for(src)("compute", lambda: _compute_fired(
                scanner, frames, cfg, src, use_fused=False if packed else None))
            report.launches += 1
            stats.add("compute", time.perf_counter() - t0, items=1, view=_item_name(src))
        except Exception as e:
            _record_failure(report, src, _item_name(src), e, log, stats)
            return
        finish(src, pts, cols)

    def run(batch):
        poisoned = None
        for src, _ in batch:
            dl.beat("compute")
            try:
                faults.fire("compute.view", item=src)
            except faults.InjectedCrash:
                raise
            except Exception as e:
                poisoned = e
                break
        if poisoned is None:
            try:
                t0 = time.perf_counter()
                stacks = [s for _, s in batch]
                if packed:
                    cloud = scanner.forward_views_packed(
                        np.stack([s.planes for s in stacks]),
                        np.stack([s.white for s in stacks]),
                        np.stack([s.black for s in stacks]),
                        n_frames=stacks[0].n_frames, **_forward_kw(cfg))
                else:
                    cloud = scanner.forward_views(np.stack(stacks), **_forward_kw(cfg))
                report.launches += 1
                views = [tri.compact_cloud(tri.CloudResult(
                    cloud.points[j], cloud.colors[j], cloud.valid[j]))
                    for j in range(len(batch))]
                dt = time.perf_counter() - t0
                stats.add("compute", dt, items=len(batch))
                stats.add_launch(len(batch), len(batch), dt)
            except faults.InjectedCrash:
                raise
            except Exception as e:
                if scanner.device.type == "cuda":
                    raise
                poisoned = e
        if poisoned is not None:
            if faults.is_transient(poisoned):
                # the per-view re-run below is this transient's retry
                report.retries += 1
                stats.add_retry("compute")
            log(f"[reconstruct] batch of {len(batch)} view(s) degraded to per-view "
                f"compute ({type(poisoned).__name__}: {poisoned})")
            for src, stack in batch:
                one_view(src, stack)
            return
        for (src, _), (pts, cols) in zip(batch, views):
            finish(src, pts, cols)

    pool = ThreadPoolExecutor(max_workers=max(1, cfg.parallel.io_workers),
                              thread_name_prefix="sl3d-load")
    try:
        for i in range(0, len(sources), batch_n):
            _budget_check("reconstruct")
            loads = [(src, pool.submit(load, src)) for src in sources[i:i + batch_n]]
            batch: list = []
            for src, fut in loads:
                try:
                    stack = _lane_wait(fut, cfg, "load", f"load of {_item_name(src)}")
                except faults.InjectedCrash:
                    raise
                except Exception as e:
                    _record_failure(report, src, _item_name(src), e, log, stats, "load")
                    continue
                if batch and stack.shape != batch[0][1].shape:
                    run(batch)
                    batch = []
                batch.append((src, stack))
            if batch:
                run(batch)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def _lane(cfg: Config, n_sources: int) -> str:
    """batched (packed with ``pipeline.packed_ingest``) for several sources
    at ``compute_batch`` > 1, else serial."""
    if cfg.parallel.compute_batch > 1 and n_sources > 1:
        return "packed" if cfg.pipeline.packed_ingest else "batched"
    return "serial"


def _reconstruct_lane(sources, cfg, scanner, report, emit, log, stats) -> None:
    """Run the lane ``reconstruct`` and ``run_pipeline`` share; ``stats``
    gets its load / compute walls and ``report.overlap`` their snapshot."""
    lane = _lane(cfg, len(sources))
    t0 = time.perf_counter()
    with prof.trace():
        if lane == "serial":
            _reconstruct_serial(sources, cfg, scanner, report, emit, log, stats)
        else:
            _reconstruct_batched(sources, cfg, scanner, report, emit, log, stats,
                                 packed=lane == "packed")
    stats.finish(time.perf_counter() - t0)
    report.overlap = stats.as_dict()


def reconstruct(calib_path: str, target: str, mode: str = "single",
                output: str | None = None, cfg: Config | None = None,
                device=None, log=print) -> BatchReport:
    """Scan folder(s) -> per-view colored PLY, on ``device`` (None -> cuda).

    ``output``: for single mode a .ply path (default ``<target>.ply``); for
    batch/files mode a directory (default: beside each source). A view that
    fails is recorded in ``report.failed`` / ``report.failures`` and the
    others go on; the run owns a deadline context unless an enclosing run
    installed one.
    """
    cfg = cfg or Config()
    dev = resolve_device(device)
    calib = matfile.load_calibration(calib_path)
    need = gc.frames_per_view(cfg.decode.n_cols, cfg.decode.n_rows,
                              cfg.projector.downsample)
    sources = _scan_sources(target, mode, need, log=log)
    if not sources:
        raise ValueError(f"no scan sources found under {target!r} (mode={mode})")
    scanner = _build_scanner(sources, calib, cfg, dev)
    if output and mode != "single":
        os.makedirs(output, exist_ok=True)
    tr = tel.current()
    report = BatchReport(device=str(dev), lane=_lane(cfg, len(sources)),
                         run_id=tr.run_id if tr is not None else tel.new_run_id())
    t0 = time.perf_counter()

    def emit(src, pts, cols, retry):
        out_path = _out_path_for(src, mode, output)
        retry("write", lambda: ply.write_ply(out_path, pts, cols))
        log(f"[reconstruct] {_item_name(src)}: {len(pts):,} points -> {out_path}")
        report.outputs.append(out_path)
        report.points.append(len(pts))

    stall_dir = output if output and os.path.isdir(output) else None
    with _run_context(cfg, stall_dir, report.run_id, log):
        _reconstruct_lane(sources, cfg, scanner, report, emit, log, prof.OverlapStats())
    report.elapsed_s = time.perf_counter() - t0
    log(f"[reconstruct] {report.summary}")
    return report


def sort_ply_paths_by_angle(paths: list[str]) -> list[str]:
    """Order merge inputs by the ``"<n>deg"`` tag in the filename, untagged
    files after them in lexical order."""

    def key(p):
        m = _DEG_RE.search(os.path.basename(p))
        return (0, float(m.group(1)), p) if m else (1, 0.0, p)

    return sorted(paths, key=key)


def merge_views(input_folder: str, output_ply: str, cfg: Config | None = None,
                log=print, device=None, timings: dict | None = None):
    """Folder of per-view PLYs -> one registered 360-degree cloud PLY, on
    ``device`` (None -> cuda). A view that cannot be read is dropped with a
    warning as long as max(2, pipeline.min_views) readable views remain.
    Returns (points, colors, transforms)."""
    cfg = cfg or Config()
    dev = resolve_device(device)
    out_abs = os.path.abspath(output_ply)
    paths = sort_ply_paths_by_angle([
        p for f in os.listdir(input_folder)
        if f.lower().endswith(".ply")
        and os.path.abspath(p := os.path.join(input_folder, f)) != out_abs])
    if len(paths) < 2:
        raise ValueError(f"need >= 2 PLY views in {input_folder}, found {len(paths)}")
    log(f"[merge] {len(paths)} views: " + ", ".join(os.path.basename(p) for p in paths))

    def read_one(p):
        try:
            return ply.read_ply(p), None
        except faults.InjectedCrash:
            raise
        except Exception as e:  # a torn or corrupt view is dropped below
            return None, e

    with ThreadPoolExecutor(max_workers=max(1, min(cfg.parallel.io_workers,
                                                   len(paths)))) as pool:
        datas = list(pool.map(read_one, paths))
    dropped = [(p, e) for p, (d, e) in zip(paths, datas) if d is None]
    for p, e in dropped:
        log(f"[merge] WARNING: dropping unreadable view {os.path.basename(p)}: {e}")
    floor = max(2, cfg.pipeline.min_views)
    if len(paths) - len(dropped) < floor:
        raise ValueError(
            f"merge: only {len(paths) - len(dropped)}/{len(paths)} views readable, "
            f"below the pipeline.min_views={floor} floor (unreadable: "
            f"{[os.path.basename(p) for p, _ in dropped]})")
    clouds = []
    for d, _ in datas:
        if d is None:
            continue
        c = d.get("colors")
        if c is None:
            c = np.zeros_like(d["points"], dtype=np.uint8)
        clouds.append((np.asarray(d["points"], np.float32), np.asarray(c, np.uint8)))
    with prof.trace():
        points, colors, transforms = recon.merge_360(clouds, cfg.merge, log=log,
                                                     timings=timings, device=dev)
    ply.write_ply(output_ply, points, colors)
    log(f"[merge] wrote {output_ply} ({len(points):,} points)")
    return points, colors, transforms


# ---------------------------------------------------------------------------
# clean
# ---------------------------------------------------------------------------

def _clean_arrays(pts: np.ndarray, cols: np.ndarray, cfg: Config,
                  steps=CLEAN_STEPS, log=None, device=None,
                  timings: dict | None = None):
    """The masked clean chain on one in-memory cloud, on ``device`` (None ->
    cuda): the cloud padded to its 2048-multiple bucket with rows at 1e9
    (valid = the first n rows), ``ops/pointcloud.clean_chain``, survivors
    taken once at the end. Returns (points', colors', counts {"input": n,
    step: survivors}). A step that leaves no point aborts the chain there
    (later steps are not counted). ``timings`` gets ``clean_<step>_s``."""
    log = log or (lambda m: None)
    n = len(pts)
    counts = {"input": n}
    params = pc.chain_params(cfg.clean, tuple(steps))
    if not params:
        return pts, cols, counts
    dev = resolve_device(device)
    bucket = recon._bucket_pad(n)
    pts_pad = np.full((bucket, 3), knnlib.FAR, np.float32)
    pts_pad[:n] = pts
    valid = torch.arange(bucket, device=dev) < n
    masks, cnts = pc.clean_chain(torch.from_numpy(pts_pad).to(dev), valid, cfg.clean,
                                 tuple(steps), timings=timings)
    masks = masks[:, :n].cpu().numpy()
    cnts = cnts.cpu().numpy()
    final = masks[-1]
    for i, (step, _) in enumerate(params):
        counts[step] = int(cnts[i])
        log(f"[clean] {step}: {int(cnts[i]):,} points remain")
        if int(cnts[i]) == 0:
            log("[clean] WARNING: all points removed; aborting chain")
            final = masks[i]
            break
    return pts[final], cols[final], counts


def _read_cloud(path: str):
    data = ply.read_ply(path)
    pts = np.asarray(data["points"], np.float32)
    cols = data.get("colors")
    return pts, (np.asarray(cols, np.uint8) if cols is not None
                 else np.zeros_like(pts, dtype=np.uint8))


def clean_cloud(input_ply: str, output_ply: str, cfg: Config | None = None,
                steps=CLEAN_STEPS, log=print, device=None) -> dict:
    """The clean chain on one cloud PLY (background plane -> largest
    cluster -> radius outlier -> statistical outlier, each selectable), on
    ``device`` (None -> cuda). Returns the per-step counts."""
    cfg = cfg or Config()
    pts, cols = _read_cloud(input_ply)
    pts, cols, counts = _clean_arrays(pts, cols, cfg, tuple(steps), log=log, device=device)
    ply.write_ply(output_ply, pts, cols)
    log(f"[clean] wrote {output_ply} ({len(pts):,} points)")
    return counts


def clean_batch(input_folder: str, output_folder: str, cfg: Config | None = None,
                steps=CLEAN_STEPS, log=print, device=None) -> BatchReport:
    """Clean every PLY of a folder into ``output_folder`` (reads on the I/O
    pool); a cloud that fails is logged and listed in ``report.failed``,
    the others go on."""
    cfg = cfg or Config()
    dev = resolve_device(device)
    paths = sorted(os.path.join(input_folder, f) for f in os.listdir(input_folder)
                   if f.lower().endswith(".ply"))
    if not paths:
        raise ValueError(f"no .ply files in {input_folder!r}")
    os.makedirs(output_folder, exist_ok=True)
    report = BatchReport(lane="clean", device=str(dev))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, min(cfg.parallel.io_workers,
                                                   len(paths)))) as pool:
        for src, fut in [(p, pool.submit(_read_cloud, p)) for p in paths]:
            name = os.path.basename(src)
            try:
                pts, cols = fut.result()
                pts, cols, _ = _clean_arrays(pts, cols, cfg, tuple(steps), device=dev)
                out_path = os.path.join(output_folder, name)
                ply.write_ply(out_path, pts, cols)
            except Exception as e:  # per-item tolerance: the batch goes on
                log(f"[clean] {name} FAILED: {e}")
                report.failed.append((src, str(e)))
                continue
            log(f"[clean] {name}: {len(pts):,} points -> {out_path}")
            report.outputs.append(out_path)
            report.points.append(len(pts))
    report.elapsed_s = time.perf_counter() - t0
    log(f"[clean] {len(report.outputs)} cloud(s) cleaned, {len(report.failed)} "
        f"failed, on {dev} in {report.elapsed_s:.2f}s")
    return report


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

def _mesh_arrays(pts: np.ndarray, cfg: Config, log=print, normals=None, device=None,
                 timings: dict | None = None):
    """Cloud arrays -> (verts, faces, normals) on ``device``: normals
    estimated (k = mesh.normal_max_nn) and oriented (mesh.orientation)
    when not given, then ``meshing.reconstruct_mesh``. ``timings`` gets
    ``normals_s`` and the meshing stages."""
    tm = timings if timings is not None else {}
    dev = resolve_device(device)
    if normals is None:
        t0 = time.perf_counter()
        p = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev)
        v = torch.ones(len(pts), dtype=torch.bool, device=dev)
        nr = nrm.estimate_normals(p, v, k=cfg.mesh.normal_max_nn,
                                  radius=cfg.mesh.normal_radius or None)
        normals = nrm.orient_normals(p, nr, v, mode=cfg.mesh.orientation).cpu().numpy()
        tm["normals_s"] = time.perf_counter() - t0
        log(f"[mesh] estimated normals (k={cfg.mesh.normal_max_nn}, "
            f"{cfg.mesh.orientation} orientation)")
    verts, faces = meshing.reconstruct_mesh(pts, None, normals, cfg=cfg.mesh, log=log,
                                            device=dev, timings=tm)
    return np.asarray(verts), np.asarray(faces), normals


def _write_mesh(output_path: str, verts, faces, log=print) -> None:
    if output_path.lower().endswith(".stl"):
        meshing.mesh_to_stl(output_path, verts, faces)
    else:
        ply.write_mesh_ply(output_path, verts, faces)
    log(f"[mesh] wrote {output_path} ({len(verts):,} verts, {len(faces):,} faces)")


def mesh_cloud(input_ply: str, output_path: str, cfg: Config | None = None,
               save_normals_path: str | None = None, log=print, device=None,
               timings: dict | None = None):
    """Cloud PLY -> mesh (.stl, or a mesh .ply by extension) on ``device``
    (None -> cuda); the PLY's own normals are used when it has them.
    ``save_normals_path`` also writes the cloud with the normals used.
    ``timings`` gets the meshing stages' walls and ``write_s``."""
    cfg = cfg or Config()
    tm = timings if timings is not None else {}
    data = ply.read_ply(input_ply)
    pts = np.asarray(data["points"], np.float32)
    verts, faces, normals = _mesh_arrays(pts, cfg, log=log, normals=data.get("normals"),
                                         device=device, timings=tm)
    if save_normals_path:
        ply.write_ply(save_normals_path, pts, data.get("colors"), normals)
        log(f"[mesh] normals debug cloud -> {save_normals_path}")
    t0 = time.perf_counter()
    _write_mesh(output_path, verts, faces, log=log)
    tm["write_s"] = time.perf_counter() - t0
    return verts, faces


# ---------------------------------------------------------------------------
# the scan-to-print pipeline
# ---------------------------------------------------------------------------

@dataclass
class PipelineReport:
    """What one scan-to-print run did."""

    run_id: str | None = None
    merged_ply: str | None = None
    stl_path: str | None = None
    views_computed: int = 0
    views_cached: int = 0
    failed: list[tuple[str, str]] = field(default_factory=list)
    failures: list[faults.FailureRecord] = field(default_factory=list)
    retries: int = 0
    degraded: bool = False          # merged with fewer views or a fallback pair
    manifest_path: str | None = None
    merge_status: str = ""          # 'computed' | 'cache-hit'
    merge_mode: str = ""            # 'streamed' | 'barrier' | another merge.method
    mesh_status: str = ""           # 'computed' | 'cache-hit'
    merged_points: int = 0
    mesh_verts: int = 0
    mesh_faces: int = 0
    device: str = ""
    clean_counts: list[dict] = field(default_factory=list)  # per merged view, angle order
    transforms: list = field(default_factory=list)  # view i -> view 0, angle order
    overlap: dict | None = None     # OverlapStats of the lanes incl. register
    cache: dict | None = None       # StageCache.stats()
    walls_s: dict = field(default_factory=dict)   # per stage, host wall
    elapsed_s: float = 0.0

    @property
    def summary(self) -> str:
        deg = ""
        if self.degraded:
            parts = []
            if self.failed:
                parts.append(f"{len(self.failed)} view(s) quarantined")
            pair_fails = len(self.failures) - len(self.failed)
            if pair_fails > 0:
                parts.append(f"{pair_fails} pair(s) identity-fallback")
            deg = " DEGRADED (" + ", ".join(parts or ["see manifest"]) + ")"
        return (f"{self.views_computed} views computed + {self.views_cached} cached, "
                f"merge {self.merge_status} ({self.merge_mode}), mesh {self.mesh_status}, "
                f"{self.merged_points:,} merged points, {self.mesh_faces:,} faces on "
                f"{self.device} in {self.elapsed_s:.1f}s{deg}")


def _write_json_atomic(path: str, payload: dict) -> None:
    with atomic.atomic_write(path) as tmp, open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


def _quarantine_failures(out_dir: str, failures, log) -> None:
    """One ``<out>/quarantine/<view>.json`` per failed view."""
    qdir = os.path.join(out_dir, "quarantine")
    os.makedirs(qdir, exist_ok=True)
    tr = tel.current()
    for rec in failures:
        _write_json_atomic(os.path.join(qdir, f"{rec.view}.json"), rec.as_dict())
        if tr is not None:
            tr.instant("quarantine", view=rec.view, stage=rec.stage, error=rec.error_type)
    log(f"[pipeline] quarantined {len(failures)} failed view(s) -> {qdir}")


def _failure_manifest(out_dir: str, report: PipelineReport, views_total: int,
                      views_survived: int, aborted: bool, log,
                      reason: str | None = None) -> str:
    """The failure manifest next to the STL (the JAX package's fields, and
    the abort ``reason``): every FailureRecord, the verdict, and the fired
    injection counts."""
    plan = faults.active_plan()
    path = os.path.join(out_dir, "failures.json")
    payload = {
        "run_id": report.run_id, "views_total": views_total,
        "views_survived": views_survived, "degraded": report.degraded,
        "aborted": aborted, "retries": report.retries,
        "merge_mode": report.merge_mode,
        "failures": [r.as_dict() for r in report.failures],
        "injected_faults": plan.counts() if plan is not None else {}}
    if reason is not None:
        payload["reason"] = reason
    _write_json_atomic(path, payload)
    log(f"[pipeline] failure manifest -> {path}")
    return path


# merge.stream / merge.pair_batch / merge.incremental are SCHEDULE knobs:
# the streamed and barrier arms give the same bytes, so none enters merge
# or pair key material
_MERGE_SCHEDULE_KNOBS = ("stream", "pair_batch", "incremental")


def _engine_json(dev: torch.device) -> str:
    """The port's tag in every cache key, where the JAX package puts its
    backend: the engine and the device type. The CPU runs the kernels'
    plain versions, which are not bit-equal to them, and meshes at a
    shallower depth, so a directory written on one device never hands its
    entries to a run on the other."""
    return json.dumps({"engine": "torch", "device": dev.type})


def _merge_numeric_json(cfg: Config) -> str:
    """The merge config subtree minus its schedule knobs — the key material
    shared by the merge entry and every per-pair entry."""
    d = dataclasses.asdict(cfg.merge)
    for k in _MERGE_SCHEDULE_KNOBS:
        d.pop(k, None)
    return json.dumps({"merge": d}, sort_keys=True)


class _StreamRegistrar:
    """The ``register`` lane of the streaming 360 merge.

    ``run_pipeline`` feeds each view's cleaned compact cloud (host arrays)
    here the moment the lane has cleaned it (or straight from the view
    cache); one worker thread preps the view (``recon.prep_view``) and, as
    soon as views i and i+1 are both present with every earlier view
    accounted for, registers pair i -> i+1 through
    ``recon.register_prep_pairs``, so feature prep + RANSAC + ICP overlap
    the reconstruction and clean of later views. Cache-miss pairs dispatch
    in groups of ``merge.pair_batch``; each pair owns a stage-cache entry
    keyed on the two views' output digests, the merge numerics and its chain
    id, so a rerun with one dirty view re-registers only its <= 2 pairs.

    Pair ids are CHAIN POSITIONS over the surviving views — the ids the
    barrier ``merge_360`` assigns — so the streamed transforms are the
    barrier arm's. While every view so far arrived in order, a pair's chain
    position is its first view's index; a pair past a quarantined view
    (including the (k-1) -> (k+1) re-pair around it) registers in
    ``finish``'s catch-up, once the survivors are known.

    A failing pair retries under the pipeline retry policy, then falls back
    to the IDENTITY transform with a warning and a FailureRecord: the run
    completes DEGRADED. Such a pair is never published to the pair cache,
    and a merge holding one never to the merge cache.

    Device work: the lane takes only host arrays, passes ``device``
    explicitly, and on CUDA runs on a stream of its own (``_on_stream``, the
    worker and ``finish``'s catch-up alike), so the clean chain's host syncs
    on the main thread never wait on queued RANSAC/ICP work, nor the
    reverse; every result comes back to the host. ``close`` is bounded by
    ``deadlines.register_s``: a worker blocked past it (a wedged device call
    cannot be cancelled) is abandoned and ``finish`` gives every pair it
    never resolved the identity fallback.
    """

    def __init__(self, cfg: Config, cache: StageCache, stats: prof.OverlapStats,
                 device: torch.device, log):
        self.cfg = cfg
        self.cache = cache
        self.stats = stats
        self.device = device
        self.log = log
        self.voxel = float(cfg.merge.voxel_size)
        self.pair_batch = max(1, cfg.merge.pair_batch)
        self.policy = _retry_policy(cfg)
        self._pair_cfg = _merge_numeric_json(cfg) + _engine_json(device)
        self._stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sl3d-register")
        self._futs: list = []
        self._closed = False
        self._wedged = False   # the bounded close timed out; the worker is untrusted
        # mutated only on the worker until close() drains it; finish()'s
        # catch-up then owns it on the caller's thread
        self._digests: dict[int, str] = {}
        self._clouds: dict[int, tuple] = {}
        self._preps: dict[int, object] = {}
        self._frontier = 0            # first view index not yet fed
        self._chain: list[int] = []   # contiguous prefix of fed views
        self._seen: set[tuple] = set()
        self._done: dict[tuple, tuple] = {}
        self._pending: list[tuple] = []
        self.failures: list[faults.FailureRecord] = []

    def _on_stream(self):
        """The lane's device work goes to its own stream (CUDA only)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def feed(self, i: int, pts: np.ndarray, cols: np.ndarray) -> None:
        """Hand view ``i``'s cleaned cloud to the lane (any thread)."""
        self._futs.append(self._pool.submit(self._note, i, pts, cols))

    def close(self, cancel: bool = False) -> None:
        """Drain the worker (``cancel``: drop the feeds not yet started) and
        surface injected crashes. Idempotent; bounded by
        ``deadlines.register_s`` when the deadline layer is on."""
        if self._closed:
            return
        self._closed = True
        budget = _lane_budget_s(self.cfg, "register")
        self._pool.shutdown(wait=budget is None, cancel_futures=cancel)
        if budget is not None:
            deadline = dl.Deadline.after(budget, "register-lane close")
            for f in self._futs:
                rem = deadline.remaining()
                if rem <= 0 or not dl.wait_settled(f, rem):
                    self._wedged = True
                    self.log(f"[pipeline] WARNING: register lane still busy after its "
                             f"{budget:g}s close budget; abandoning the worker, "
                             f"unresolved pairs fall back to the identity transform")
                    break
        for f in self._futs:
            if not f.done() or f.cancelled():
                continue
            e = f.exception()
            if isinstance(e, faults.InjectedCrash):
                raise e
            if e is not None:
                self.log(f"[pipeline] WARNING: register lane error ({type(e).__name__}: "
                         f"{e}); the affected pairs fall to the merge-time catch-up")

    def finish(self, order: list[int], collected: dict):
        """Barrier the lane, register every remaining survivor pair, and
        return host ``(T [P, 4, 4], gfit [P], ifit [P], irmse [P])`` for the
        consecutive pairs of ``order``."""
        self.close()
        pairs = [(p, order[p + 1], order[p]) for p in range(len(order) - 1)]
        if self._wedged:
            for t in pairs:
                if t not in self._done:
                    self._identity(t, dl.DeadlineExceeded(
                        "register lane stalled past deadlines.register_s; "
                        "pair abandoned"))
        else:
            for i in order:  # backfill a feed the worker never recorded
                if i not in self._digests:
                    self._clouds[i] = collected[i]
                    self._digests[i] = StageCache.digest_arrays(
                        points=collected[i][0], colors=collected[i][1])
            with self._on_stream():
                for t in pairs:
                    if t not in self._seen:
                        if t[1] - t[2] > 1:
                            self.log(f"[pipeline] re-pairing around quarantined "
                                     f"view(s): pair {t[2]}->{t[1]} (chain position "
                                     f"{t[0]})")
                        self._enqueue(*t)
                self._dispatch()
        if not pairs:
            z = np.zeros(0, np.float32)
            return np.zeros((0, 4, 4), np.float32), z, z, z
        T = np.stack([self._done[t][0] for t in pairs])
        gf, fi, ir = (np.asarray([self._done[t][k] for t in pairs], np.float32)
                      for k in (1, 2, 3))
        return T, gf, fi, ir

    # ---- worker internals ------------------------------------------------

    def _note(self, i: int, pts, cols) -> None:
        dl.beat("register")
        self._digests[i] = StageCache.digest_arrays(points=pts, colors=cols)
        self._clouds[i] = (pts, cols)
        with self._on_stream():
            while self._frontier in self._clouds:
                self._chain.append(self._frontier)
                self._frontier += 1
                if len(self._chain) >= 2:
                    # both ends fed and every earlier view resolved: the chain
                    # position (the RANSAC seed) is final
                    self._enqueue(len(self._chain) - 2, self._chain[-1],
                                  self._chain[-2])

    def _enqueue(self, pid: int, src: int, dst: int) -> None:
        t = (pid, src, dst)
        self._seen.add(t)
        key = self.cache.key("pair", digests=[self._digests[dst], self._digests[src]],
                             config_json=self._pair_cfg + json.dumps({"pair": pid}))
        hit = self.cache.get("pair", key)
        if hit is not None:
            self._done[t] = (np.asarray(hit["T"], np.float32), float(hit["gfit"]),
                             float(hit["ifit"]), float(hit["irmse"]))
            return
        self._pending.append((t, key))
        if len(self._pending) >= self.pair_batch:
            self._dispatch()

    def _prep(self, i: int):
        p = self._preps.get(i)
        if p is None:
            t0 = time.perf_counter()
            p = recon.prep_view(self._clouds[i][0], self.voxel,
                                self.cfg.merge.sample_before, device=self.device)
            self.stats.add("register", time.perf_counter() - t0, view=i)
            self._preps[i] = p
        return p

    def _identity(self, t: tuple, exc: BaseException) -> None:
        _pid, src, dst = t
        self.log(f"[pipeline] WARNING: registration of pair {dst}->{src} failed "
                 f"permanently ({type(exc).__name__}: {exc}); falling back to the "
                 f"IDENTITY transform — the merge completes DEGRADED with view {src} "
                 f"left in its neighbour's frame")
        self.failures.append(faults.FailureRecord.from_exception(
            "register", f"pair_{dst}_{src}", exc))
        self.stats.add_failure("register")
        self._done[t] = (np.eye(4, dtype=np.float32), 0.0, 0.0, 0.0)

    def _dispatch(self) -> None:
        group, self._pending = self._pending, []
        if not group:
            return

        def on_retry(n, e):
            self.stats.add_retry("register")
            self.log(f"[pipeline] transient {type(e).__name__} in register lane "
                     f"({e}); retry {n}/{self.policy.max_retries}")

        live = []
        for t, key in group:
            _pid, src, dst = t
            try:
                faults.retry_call(
                    lambda d=dst, s=src: faults.fire("register.pair", item=f"{d}->{s}"),
                    self.policy, on_retry=on_retry)
                live.append((t, key))
            except faults.InjectedCrash:
                raise
            except Exception as e:
                self._identity(t, e)
        if not live:
            return
        pairs = [(self._prep(src), self._prep(dst)) for (_pid, src, dst), _ in live]
        ids = [t[0] for t, _ in live]
        t0 = time.perf_counter()
        try:
            T, gf, fi, ir = faults.retry_call(
                lambda: recon.register_prep_pairs(pairs, ids, self.cfg.merge, self.voxel),
                self.policy, on_retry=on_retry)
        except faults.InjectedCrash:
            raise
        except Exception as e:
            for t, _ in live:
                self._identity(t, e)
            return
        self.stats.add_pair_launch(len(live), time.perf_counter() - t0)
        for j, (t, key) in enumerate(live):
            self._done[t] = (np.asarray(T[j], np.float32), float(gf[j]), float(fi[j]),
                             float(ir[j]))
            self.cache.put("pair", key, T=np.asarray(T[j], np.float32),
                           gfit=np.float32(gf[j]), ifit=np.float32(fi[j]),
                           irmse=np.float32(ir[j]))


def _view_plan(calib_path: str, target: str, cfg: Config, steps: tuple[str, ...],
               cache: StageCache, log, dev: torch.device):
    """Angle-ordered scan sources and their content-addressed view keys
    (calibration bytes, frame bytes, the decode / triangulate / projector /
    clean subtree, the steps and ``dev``'s engine tag), hashed on the I/O
    pool.
    Returns (calib, sources, view keys, keying wall in s)."""
    calib = matfile.load_calibration(calib_path)
    need = gc.frames_per_view(cfg.decode.n_cols, cfg.decode.n_rows, cfg.projector.downsample)
    sources = _scan_sources(target, "batch", need, log=log)
    if len(sources) < 2:
        raise ValueError(f"pipeline needs >= 2 scan views under {target!r}, found "
                         f"{len(sources)}")
    sources = sort_ply_paths_by_angle(sources)
    view_cfg = config_subtree(cfg, ("decode", "triangulate", "projector", "clean")) + \
        json.dumps({"steps": list(steps)}) + _engine_json(dev)
    t0 = time.perf_counter()
    with tel.stage("cache.keys", views=len(sources)):
        view_keys = cache.keys_parallel(
            "view", [[calib_path] + imio.list_frame_files(src) for src in sources],
            config_json=view_cfg, io_workers=cfg.parallel.io_workers,
            timeout_s=_lane_budget_s(cfg, "cache"))
    return calib, sources, view_keys, time.perf_counter() - t0


def run_pipeline(calib_path: str, target: str, out_dir: str, cfg: Config | None = None,
                 steps=CLEAN_STEPS, merged_name: str = "merged.ply",
                 stl_name: str = "model.stl", log=print, device=None) -> PipelineReport:
    """Scan-to-print on ``device`` (None -> cuda): every view folder under
    ``target`` (with enough frames, in ``<n>deg`` angle order) ->
    ``reconstruct``'s lane -> ``_clean_arrays`` -> the streamed or barrier
    merge -> ``_mesh_arrays`` -> ``<out_dir>/merged.ply`` and
    ``<out_dir>/model.stl``, each stage behind the stage cache (module
    docstring). With ``observability.trace`` the run writes ``trace.jsonl``
    and ``metrics.json``; it runs under the deadline layer. An exception
    aborts the run and leaves ``<out_dir>/failures.json``."""
    cfg = cfg or Config()
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    # a previous run's stall ledger / manifest must not pass for this run's
    for stale in ("stalls.json", "failures.json"):
        p = os.path.join(out_dir, stale)
        if os.path.exists(p):
            os.remove(p)
    report = PipelineReport(run_id=tel.new_run_id(), device=str(dev))
    tracer = prev = None
    if cfg.observability.trace:
        tracer = tel.Tracer(
            os.path.join(out_dir, cfg.observability.trace_file),
            run_id=report.run_id,
            meta={"tool": "pipeline", "target": os.path.abspath(target),
                  "engine": "torch", "device": str(dev),
                  "merge_method": cfg.merge.method, "merge_stream": cfg.merge.stream,
                  "host_cpus": os.cpu_count(),
                  "device_count": torch.cuda.device_count() if dev.type == "cuda" else 0})
        prev = tel.activate(tracer)
        log(f"[pipeline] flight recorder armed (run {report.run_id}) -> {tracer.path}")
    try:
        with _run_context(cfg, out_dir, report.run_id, log):
            _run_pipeline_impl(calib_path, target, out_dir, cfg, tuple(steps),
                               merged_name, stl_name, log, dev, report)
        if tracer is not None:
            g = tracer.registry.set_gauge
            g("sl3d_run_wall_seconds", report.elapsed_s)
            g("sl3d_views_computed", report.views_computed)
            g("sl3d_views_cached", report.views_cached)
            g("sl3d_merged_points", report.merged_points)
            g("sl3d_degraded", int(report.degraded))
            if report.overlap:
                g("sl3d_critical_path_seconds", report.overlap.get("critical_path_s") or 0.0)
        return report
    except Exception as e:
        # every abort leaves a manifest; the below-floor path wrote its own
        mpath = os.path.join(out_dir, "failures.json")
        if not os.path.exists(mpath):
            _write_json_atomic(mpath, {
                "run_id": report.run_id, "aborted": True, "degraded": False,
                "reason": f"{type(e).__name__}: {e}",
                "run_budget_s": cfg.pipeline.run_budget_s,
                "clean_counts": report.clean_counts,
                "failures": [faults.FailureRecord.from_exception(
                    "pipeline", "run", e).as_dict()]})
            log(f"[pipeline] ABORTED ({type(e).__name__}: {e}); manifest -> {mpath}")
        raise
    finally:
        if tracer is not None:
            tel.deactivate(prev)
            metrics_path = os.path.join(out_dir, cfg.observability.metrics_file)
            tracer.close(metrics_path)
            log(f"[pipeline] flight recorder -> {tracer.path} + {metrics_path}")


def _run_pipeline_impl(calib_path, target, out_dir, cfg: Config, steps, merged_name,
                       stl_name, log, dev, report: PipelineReport) -> None:
    t_start = time.perf_counter()
    walls = report.walls_s
    # a kill -9 in an earlier run leaves *.tmp orphans; none is data
    atomic.sweep_tmp(out_dir, log=log, recursive=True)
    cache = StageCache(os.path.join(out_dir, ".slscan-cache"), enabled=cfg.pipeline.cache,
                       log=log, verify=cfg.pipeline.verify_cache)
    calib, sources, view_keys, walls["cache_keys_s"] = _view_plan(
        calib_path, target, cfg, steps, cache, log, dev)
    floor = max(2, cfg.pipeline.min_views)
    if len(sources) < floor:
        reason = (f"pipeline: {len(sources)} scan view(s) under {target!r}, below the "
                  f"pipeline.min_views={floor} floor")
        report.manifest_path = _failure_manifest(out_dir, report, len(sources), 0,
                                                 aborted=True, log=log, reason=reason)
        raise ValueError(reason)

    # ---- stage 1+2: per-view reconstruct + clean, behind the view cache ----
    collected: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    counts: dict[int, dict] = {}
    missing: list[tuple[int, str]] = []
    for i, src in enumerate(sources):
        hit = cache.get("view", view_keys[i])
        if hit is not None:
            collected[i] = (np.asarray(hit["points"], np.float32),
                            np.asarray(hit["colors"], np.uint8))
            counts[i] = json.loads(str(hit["counts"]))
        else:
            missing.append((i, src))
    report.views_cached = len(collected)
    if cfg.merge.method != "sequential":
        # no streamed arm: the barrier merge_360 raises for the unported
        # method, as it did before the streamed arm existed
        report.merge_mode = cfg.merge.method
    else:
        report.merge_mode = "streamed" if cfg.merge.stream else "barrier"
    stream: _StreamRegistrar | None = None
    stats = prof.OverlapStats()
    t_stream0 = time.perf_counter()

    def arm_stream() -> _StreamRegistrar:
        nonlocal stream
        stream = _StreamRegistrar(cfg, cache, stats, dev, log)
        log(f"[pipeline] merge: streaming register lane armed "
            f"(pair_batch={cfg.merge.pair_batch})")
        for i in sorted(collected):
            stream.feed(i, *collected[i])
        return stream

    try:
        # with every view cached the lane arms only on a merge-cache miss, so
        # a fully warm rerun looks nothing up and computes nothing
        if report.merge_mode == "streamed" and missing:
            arm_stream()
        if missing:
            _reconstruct_missing(missing, calib, cfg, steps, view_keys, cache, collected,
                                 counts, lambda: stream, stats, out_dir, log, dev, report)
        report.views_computed = len(collected) - report.views_cached

        # ---- failure domain: quarantine + degrade-or-abort -------------------
        if report.failures:
            _quarantine_failures(out_dir, report.failures, log)
        if len(collected) < floor:
            reason = (f"pipeline: only {len(collected)} views survived reconstruction, "
                      f"below the pipeline.min_views={floor} floor (failed: "
                      f"{[os.path.basename(s) for s, _ in report.failed]})")
            report.manifest_path = _failure_manifest(
                out_dir, report, len(sources), len(collected), aborted=True, log=log,
                reason=reason)
            raise ValueError(f"{reason}; see {report.manifest_path}")
        if report.failed:
            report.degraded = True
            log(f"[pipeline] WARNING: {len(report.failed)}/{len(sources)} view(s) failed "
                f"and were quarantined; continuing DEGRADED with {len(collected)} views "
                f"(floor: pipeline.min_views={floor})")
        order = sorted(collected)
        report.clean_counts = [counts[i] for i in order]

        # ---- stage 3: merge-360 ----------------------------------------------
        _budget_check("merge")
        # the merge and mesh barriers are opaque device calls with no
        # heartbeat inside: the watchdog pauses; the run budget still holds
        dl.watchdog_suspend()
        t_merge = time.perf_counter()
        points, colors = _merge_stage(order, collected, cfg, cache, stream, arm_stream,
                                      stats, t_stream0, log, dev, report)
        walls["merge_s"] = time.perf_counter() - t_merge
    except BaseException:
        if stream is not None:
            with contextlib.suppress(BaseException):   # the abort is the headline
                stream.close(cancel=True)
        raise
    tr = tel.current()
    if tr is not None:
        tr.span_end("merge", walls["merge_s"], status=report.merge_status,
                    mode=report.merge_mode, views=len(order))

    def final_write_retry(n, e):
        report.retries += 1
        log(f"[pipeline] transient {type(e).__name__} writing a final artifact ({e}); "
            f"retry {n}")

    t0 = time.perf_counter()
    merged_path = os.path.join(out_dir, merged_name)
    _retry_stage("write", lambda: ply.write_ply(merged_path, points, colors),
                 _retry_policy(cfg), final_write_retry)
    walls["write_merged_s"] = time.perf_counter() - t0
    log(f"[pipeline] merged cloud -> {merged_path} ({len(points):,} points)")
    report.merged_ply, report.merged_points = merged_path, len(points)

    # ---- stage 4: mesh -> STL ----------------------------------------------
    _budget_check("mesh")
    t0 = time.perf_counter()
    mesh_key = cache.key("mesh", digests=[StageCache.digest_arrays(points=points)],
                         config_json=config_subtree(cfg, ("mesh",)) + _engine_json(dev))
    hit = cache.get("mesh", mesh_key)
    if hit is not None:
        verts = np.asarray(hit["verts"], np.float32)
        faces = np.asarray(hit["faces"], np.int32)
        report.mesh_status = "cache-hit"
    else:
        mesh_tm: dict = {}
        with prof.trace():
            verts, faces, _ = _mesh_arrays(points, cfg, log=log, device=dev,
                                           timings=mesh_tm)
        walls.update({f"mesh_{k}": v for k, v in mesh_tm.items()})
        cache.put("mesh", mesh_key, verts=verts, faces=faces)
        report.mesh_status = "computed"
    walls["mesh_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stl_path = os.path.join(out_dir, stl_name)
    _retry_stage("write", lambda: meshing.mesh_to_stl(stl_path, verts, faces),
                 _retry_policy(cfg), final_write_retry)
    walls["write_stl_s"] = time.perf_counter() - t0
    if tr is not None:
        tr.span_end("mesh", walls["mesh_s"], status=report.mesh_status,
                    verts=len(verts), faces=len(faces))
    log(f"[pipeline] model -> {stl_path} ({len(verts):,} verts, {len(faces):,} faces)")
    report.stl_path, report.mesh_verts, report.mesh_faces = stl_path, len(verts), len(faces)

    if report.failures:
        report.manifest_path = _failure_manifest(out_dir, report, len(sources),
                                                 len(collected), aborted=False, log=log)
    report.cache = cache.stats()
    report.elapsed_s = time.perf_counter() - t_start
    log(f"[pipeline] {report.summary}")


def _reconstruct_missing(missing, calib, cfg, steps, view_keys, cache, collected, counts,
                         get_stream, stats, out_dir, log, dev, report) -> None:
    """Reconstruct + clean the views the view cache missed: each cleaned
    view is collected, published to the cache and fed to the register lane
    (when one is armed). Failures land in ``report``."""
    index = {src: i for i, src in missing}
    sources = [src for _, src in missing]
    scanner = _build_scanner(sources, calib, cfg, dev)
    view_dir = os.path.join(out_dir, "views") if cfg.pipeline.write_view_plys else None
    if view_dir:
        os.makedirs(view_dir, exist_ok=True)
    clean_tm: dict[str, float] = {}
    clean_s = 0.0

    def emit(src, pts, cols, retry):
        nonlocal clean_s
        t0 = time.perf_counter()
        pts, cols, c = retry("clean", lambda: _clean_arrays(
            pts, cols, cfg, steps, device=dev, timings=clean_tm))
        dt = time.perf_counter() - t0
        clean_s += dt
        stats.add("clean", dt, view=_item_name(src))
        if view_dir:
            retry("write", lambda: ply.write_ply(_out_path_for(src, "batch", view_dir),
                                                 pts, cols))
        i = index[src]
        collected[i], counts[i] = (pts, cols), c
        cache.put("view", view_keys[i], points=pts, colors=cols,
                  counts=np.asarray(json.dumps(c)))
        stream = get_stream()
        if stream is not None:
            stream.feed(i, pts, cols)
        log(f"[pipeline] {_item_name(src)}: {c['input']:,} -> {len(pts):,} points "
            f"after {', '.join(s for s in c if s != 'input') or 'no clean'}")

    batch = BatchReport(device=str(dev), run_id=report.run_id)
    t0 = time.perf_counter()
    _reconstruct_lane(sources, cfg, scanner, batch, emit, log, stats)
    tr = tel.current()
    if tr is not None:
        tr.span_end("reconstruct", time.perf_counter() - t0, views=len(sources))
    report.walls_s["reconstruct_s"] = time.perf_counter() - t0 - clean_s
    report.walls_s.update(clean_tm)
    report.failed, report.failures, report.retries = batch.failed, batch.failures, batch.retries
    report.overlap = batch.overlap
    failed = {s for s, _ in batch.failed}
    for i, src in missing:   # a quarantined view never also merges
        if src in failed:
            collected.pop(i, None)


def _merge_stage(order, collected, cfg, cache, stream, arm_stream, stats, t_stream0, log,
                 dev, report):
    """The merge behind the merge cache: the streamed arm finishes the
    register lane and runs ``finalize_chain``, the barrier arm runs
    ``merge_360``. Returns (points, colors); sets the report's merge fields
    and transforms."""
    digests = [StageCache.digest_arrays(points=collected[i][0], colors=collected[i][1])
               for i in order]
    merge_key = cache.key("merge", digests=digests,
                          config_json=_merge_numeric_json(cfg) + _engine_json(dev))
    hit = cache.get("merge", merge_key)
    if hit is not None:
        if stream is not None:
            # the same view bytes: every streamed pair was a hit; drain
            stream.close()
            stats.finish(time.perf_counter() - t_stream0)
            report.overlap = stats.as_dict()
        report.transforms = list(np.asarray(hit["transforms"], np.float32))
        report.merge_status = "cache-hit"
        return np.asarray(hit["points"], np.float32), np.asarray(hit["colors"], np.uint8)
    clouds = [collected[i] for i in order]
    tm: dict = {}
    cacheable = True
    with prof.trace():
        if report.merge_mode == "streamed":
            if stream is None:
                # every view cached but the merge dirty (a merge config edit):
                # the lane runs now; the pair cache makes unchanged pairs free
                stream = arm_stream()
            t0 = time.perf_counter()
            T, gf, fi, ir = stream.finish(order, collected)
            tm["register_wait_s"] = time.perf_counter() - t0
            stats.finish(time.perf_counter() - t_stream0)
            report.overlap = stats.as_dict()
            points, colors, transforms = recon.finalize_chain(
                clouds, T, gf, fi, ir, cfg.merge, log=log, timings=tm, device=dev)
            if stream.failures:
                report.failures.extend(stream.failures)
                report.degraded = True
                cacheable = False   # a rerun must retry the real registration
                log(f"[pipeline] WARNING: {len(stream.failures)} pair registration(s) "
                    f"fell back to identity; the merged model is DEGRADED at those seams")
        else:
            points, colors, transforms = recon.merge_360(clouds, cfg.merge, log=log,
                                                         timings=tm, device=dev)
    report.walls_s.update({f"merge_{k}": v for k, v in tm.items()})
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.uint8)
    if cacheable:
        cache.put("merge", merge_key, points=points, colors=colors,
                  transforms=np.stack([np.asarray(t, np.float32) for t in transforms]))
    report.transforms = list(transforms)
    report.merge_status = "computed"
    return points, colors
