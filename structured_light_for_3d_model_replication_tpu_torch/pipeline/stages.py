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
    barrier arm runs ``merge_360``'s host-list arm after the last view. Both
    arms give the same bytes, which is why the merge cache key strips
    ``merge.stream`` (the JAX package's barrier arm hands an accelerator
    ``merge_360`` a DeviceClouds stack, whose device arm gives other bytes).
    ``merge.method='posegraph'`` has no streamed arm: the barrier
    ``merge_360_posegraph`` runs after the last view, with a notice.
  - the views are reconstructed and cleaned on ``reconstruct``'s lanes:
    the clean chain runs in the lane's drain thread, beside the next view's
    load and launch; ``pipeline.fused_clean`` keeps the span from decode
    output to cleaned cloud on the device (``ops/fused_view.py``) and hands
    the cleaned device buffers to the register lane.

With ``coordinator.workers > 0`` or a ``coordinator.listen`` endpoint,
``run_pipeline`` hands the run to ``parallel/coordinator.run_coordinated``:
worker processes warm the stage cache item by item (a view, a chain pair)
and the coordinator's assembly pass is this single-process run over the
warmed cache, so the bytes are the single-process run's. With
``merge.incremental`` the coordinator folds settled views and pairs into
the merge while the workers still run (``pipeline/assembly.py``); the
assembly pass re-validates that ``prefold`` and seeds ``finalize_chain``
with the prefix that holds.

``parallel.merge_mesh`` with two or more cards attached
(``parallel/mesh.merge_mesh``) shards the merge's pairs, accumulate and
final pass over the cards, in every arm (the streamed register lane, the
barrier merge, ``merge_views``); ``parallel.shard_views`` (on by default)
shards each batch of the batched lane over them (``views_mesh``), padded to
a multiple of the card count. One card or the CPU runs unsharded.

``clean_cloud`` / ``clean_batch`` (``sl3d clean``), ``merge_views``
(``sl3d merge-360``) and ``mesh_cloud`` (``sl3d mesh``) are the file-level
stages.

``reconstruct`` is the port's user entry point of the scan path (the JAX
package's ``sl3d reconstruct``): it resolves the scan sources, builds one
SLScanner on the device, and runs the JAX package's executor, one of four
lanes (``_lane``):

  batched    ``compute_batch`` views a launch, frames stacked [V, F, H, W]
             (``parallel.compute_batch > 1`` and several sources)
  packed     the batched lane fed packed bit-planes (``pipeline.packed_ingest``):
             ~8x fewer bytes to the device, byte-identical PLYs
  pipelined  one view a launch, overlapped (``compute_batch <= 1``,
             ``io_workers > 1``)
  serial     one view at a time on the calling thread

The scanner-free arms build no SLScanner and never take the batched lane
(they triangulate one view at a time on the host):
``triangulate.bitexact`` decodes on the device (the decode kernel, once a
view) and triangulates through the NumPy twin, bit-equal to the NumPy
reference path; ``parallel.backend='numpy'`` decodes and triangulates on
the host (``decode_stack_np``, ``triangulate_np``) and, as in the JAX
package, also cleans there (``clean_chain_np``); the merge and the mesh
run on the device in both arms, as the JAX package runs them under jax.

The overlapped lanes (batched, packed, pipelined) prefetch stacks on the
``io_workers`` pool (a window of ``compute_batch + prefetch_depth``, or
``prefetch_depth`` a view; on the card each into a slot of a ring of pinned
host buffers, copied with ``non_blocking`` on an upload stream), dispatch
on the calling thread while the previous launch is still in flight, and
drain on one worker thread (``sl3d-drain``, on a stream of its own, after
the launch's event): the device sync, compaction, the clean chain, the
``collect`` hook, and the PLY on a ``ply.WritebackQueue``. Each lane loads
and computes a view under the retry budget and records a view that still
fails as a ``FailureRecord``; results are assembled in source order, so
``outputs`` and ``failed`` are the same in every lane. The batched lane
fires ``compute.view`` per view at batch assembly; a fault there re-runs
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
import threading
import time
from collections import deque
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
from structured_light_for_3d_model_replication_tpu_torch.parallel import mesh as meshlib
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
           "clean_batch", "mesh_cloud", "PipelineReport", "run_pipeline",
           "write_patterns"]

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
    lane: str = ""          # serial | pipelined | batched | packed (| clean)
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


def _scanner_free(cfg: Config) -> bool:
    """The numpy backend and the bit-exact export triangulate each view
    through the NumPy twin on the host: no scanner, no batched lane."""
    return cfg.parallel.backend == "numpy" or cfg.triangulate.bitexact


def _build_scanner(sources, calib: dict, cfg: Config, device=None) -> SLScanner | None:
    """One SLScanner for the run, or None for the scanner-free arms; the
    camera size comes from the first source (packed header or first
    frame)."""
    if _scanner_free(cfg):
        return None
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


def _host_cloud(frames: np.ndarray, texture: np.ndarray, calib: dict, cfg: Config,
                device: torch.device) -> tri.CloudResult:
    """One view of the scanner-free arms (numpy arrays out): the numpy
    backend decodes and triangulates on the host; the bit-exact export
    decodes on ``device`` and triangulates the fetched maps through the
    NumPy twin (``plane_eval='quadratic'`` raises there)."""
    d, t = cfg.decode, cfg.triangulate
    kw = dict(n_cols=d.n_cols, n_rows=d.n_rows, n_sets_col=d.n_sets_col,
              n_sets_row=d.n_sets_row, thresh_mode=d.thresh_mode,
              shadow_val=d.shadow_val, contrast_val=d.contrast_val,
              downsample=cfg.projector.downsample)
    if cfg.parallel.backend == "numpy":
        dec = gc.decode_stack_np(frames, texture, **kw)
        return tri.triangulate_np(dec.col_map, dec.row_map, dec.mask, dec.texture, calib,
                                  row_mode=t.row_mode, epipolar_tol=t.epipolar_tol,
                                  plane_eval=t.plane_eval)
    dec = gc.decode_stack(frames, device=device, **kw)
    return tri.triangulate(dec.col_map, dec.row_map, dec.mask, texture, calib,
                           row_mode=t.row_mode, epipolar_tol=t.epipolar_tol,
                           plane_eval=t.plane_eval, bitexact=True)


def reconstruct_source(source, calib: dict, cfg: Config, scanner=None,
                       device=None) -> tuple[np.ndarray, np.ndarray]:
    """One scan source -> compact (points [M, 3] f32, colors [M, 3] u8)."""
    frames, texture = imio.load_stack(source, io_workers=cfg.parallel.io_workers)
    if _scanner_free(cfg):
        return tri.compact_cloud(_host_cloud(frames, texture, calib, cfg,
                                             resolve_device(device)))
    scanner = scanner or _build_scanner([source], calib, cfg, device)
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


def _lane_on_retry(stats: prof.OverlapStats, policy: faults.RetryPolicy, log,
                   lane: str, name: str | None = None):
    """The retry hook of one lane: counted in ``stats`` and logged."""

    def on_retry(n, e):
        stats.add_retry(lane)
        who = f"{name}: " if name else ""
        log(f"[reconstruct] {who}transient {type(e).__name__} in {lane} ({e}); retry "
            f"{n}/{policy.max_retries} after {policy.delay_s(n):.2f}s backoff")

    return on_retry


def _stage_retry(policy: faults.RetryPolicy, stats: prof.OverlapStats, log, name: str):
    """``retry(stage, fn)`` for one view: ``fn`` under the retry budget,
    each retry counted in the lane's stats (``_reconstruct_lane`` adds the
    lanes' retries to the report)."""

    def retry(stage: str, fn):
        return _retry_stage(stage, fn, policy, _lane_on_retry(stats, policy, log, stage,
                                                              name))

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

@dataclass
class _Tail:
    """What a lane does with each compact view, after compute: the JAX
    package's executor hooks. ``clean_steps``: the masked clean chain (None:
    no clean); ``write_plys``: the per-view PLY at the ``mode`` / ``output``
    path contract (on the writeback queue in the overlapped lanes);
    ``collect(idx, src, points, colors, counts, dev=None)``: the in-memory
    sink, called on the lane's drain thread (``dev``: the fused drain's
    ``(device points, count)``). ``timings`` gets the clean chain's
    ``clean_<step>_s``; the chain runs on ``device``. ``calib``: what the
    scanner-free arms triangulate against."""

    mode: str
    output: str | None
    device: torch.device
    clean_steps: tuple | None = None
    collect: object = None
    write_plys: bool = True
    timings: dict | None = None
    calib: dict | None = None


def _on_card(scanner: SLScanner | None) -> bool:
    """The lanes' CUDA machinery (pinned staging, the upload and drain
    streams, events) runs where the scanner's tensors live on a card; the
    scanner-free arms take none of it."""
    return (scanner is not None and scanner.device.type == "cuda"
            and torch.cuda.is_available())


def _load_fired(src, cfg: Config) -> tuple[np.ndarray, np.ndarray]:
    """A view's (frame stack [F, H, W], texture [H, W, 3]) behind the
    ``frame.load`` site (and ``frame.pack`` for a packed source, whose
    unpack is the codec step)."""
    dl.beat("load")
    faults.fire("frame.load", item=src)
    if imio.packed_file(src) is not None:
        dl.beat("load")
        faults.fire("frame.pack", item=src)
    return imio.load_stack(src, io_workers=cfg.parallel.io_workers)


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


def _forward_fired(scanner: SLScanner | None, frames, cfg: Config, src,
                   use_fused: bool | None = None, texture=None,
                   tail: _Tail | None = None) -> tri.CloudResult:
    """One view's decode + triangulate behind ``compute.view``: ``frames``
    [F, H, W] (host or card). ``use_fused=False`` is the per-view twin of
    the packed lane (decode + triangulate, as ``forward_views_packed``).
    Without a scanner, the scanner-free arm (``_host_cloud``) against
    ``tail.calib`` on ``tail.device``, colored by ``texture``."""
    dl.beat("compute")
    faults.fire("compute.view", item=src)
    if scanner is None:
        return _host_cloud(frames, texture, tail.calib, cfg, tail.device)
    frames_v = frames[None] if isinstance(frames, torch.Tensor) else np.asarray(frames)[None]
    out = scanner.forward_views(frames_v, use_fused=use_fused, **_forward_kw(cfg))
    return tri.CloudResult(out.points[0], out.colors[0], out.valid[0])


def _compute_fired(scanner: SLScanner | None, frames, cfg: Config, src,
                   use_fused: bool | None = None, texture=None, tail: _Tail | None = None):
    """``_forward_fired`` and the compaction: host (points, colors)."""
    return tri.compact_cloud(_forward_fired(scanner, frames, cfg, src, use_fused,
                                            texture, tail))


class _Staging:
    """Host -> card staging of one run's stacks (CUDA only): a ring of
    pinned host buffers, one a slot of the prefetch window, allocated once
    a run (again only for a stack of another shape), an upload stream, and
    each slot's event of the last copy out of it.

    The main thread takes a slot before it submits a load (``acquire``,
    which returns a lease: the slot and the acquire's serial number); the
    prefetch thread waits on the slot's event before it refills the buffer
    (``fill``), so a buffer is never overwritten while a copy out of it is
    in flight; ``release`` hands the slot back once its copy is queued.
    A slot has one holder at a time: a lease released twice, or after its
    slot went to another load, frees nothing, and ``fill`` or ``upload``
    on such a lease raises. A copy from pinned memory with ``non_blocking``
    does not block the host.
    """

    def __init__(self, device: torch.device, n_slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self._bufs: list[tuple | None] = [None] * n_slots
        self._events: list = [None] * n_slots
        self._free = list(range(n_slots))
        self._owner: list[int | None] = [None] * n_slots   # serial of the holding lease
        self._serial = 0
        self._lock = threading.Lock()
        self.pinned_bytes = 0   # bytes copied to the card out of the ring

    def acquire(self) -> tuple[int, int] | None:
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop(0)
            self._serial += 1
            self._owner[slot] = self._serial
            return slot, self._serial

    def release(self, lease: tuple[int, int] | None) -> None:
        """Hand a lease's slot back; a lease that no longer holds its slot
        frees nothing."""
        if lease is None:
            return
        with self._lock:
            slot, serial = lease
            if self._owner[slot] == serial:
                self._owner[slot] = None
                self._free.append(slot)

    def _held(self, lease: tuple[int, int]) -> int:
        with self._lock:
            slot, serial = lease
            if self._owner[slot] != serial:
                raise RuntimeError(f"staging slot {slot} is used by a load that no "
                                   "longer holds it")
            return slot

    def fill(self, lease: tuple[int, int], arrays) -> tuple:
        """Copy ``arrays`` (host u8) into the leased slot's pinned buffers,
        once the slot's last copy to the card has completed."""
        slot = self._held(lease)
        ev = self._events[slot]
        if ev is not None:
            ev.synchronize()
        bufs = self._bufs[slot]
        if bufs is None or [tuple(b.shape) for b in bufs] != [a.shape for a in arrays]:
            bufs = tuple(torch.empty(a.shape, dtype=torch.uint8, pin_memory=True)
                         for a in arrays)
            self._bufs[slot] = bufs
        for b, a in zip(bufs, arrays):
            np.copyto(b.numpy(), a)
        return bufs

    def upload(self, parts: list[torch.Tensor], leases: list[tuple[int, int]],
               stacked: bool):
        """Queue pinned ``parts`` to the card on the upload stream: into one
        [V, ...] tensor (``stacked``), else one tensor each. Records one
        event, which each leased slot keeps as its last copy. Returns
        (tensor or tensors, event); the consumer's stream waits on the event
        and takes the tensors with ``record_stream``."""
        slots = [self._held(lease) for lease in leases]
        with torch.cuda.stream(self.stream):
            if stacked:
                out = torch.empty((len(parts),) + tuple(parts[0].shape), dtype=torch.uint8,
                                  device=self.device)
                for j, p in enumerate(parts):
                    out[j].copy_(p, non_blocking=True)
            else:
                out = tuple(p.to(self.device, non_blocking=True) for p in parts)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        with self._lock:
            self.pinned_bytes += sum(int(p.numel()) for p in parts)
        for s in slots:
            self._events[s] = ev
        return out, ev


def _take_on_stream(ev, tensors, stream=None) -> None:
    """Make ``stream`` (None: the current one) wait on ``ev`` and own
    ``tensors`` made on another stream (``record_stream``), so the caching
    allocator never hands their memory out while this stream still reads
    them."""
    stream = stream if stream is not None else torch.cuda.current_stream()
    if ev is not None:
        stream.wait_event(ev)
    for t in tensors:
        t.record_stream(stream)


@contextlib.contextmanager
def _drain_stream(stream, ev=None, tensors=()):
    """The drain thread's device work: on its own stream, after ``ev`` (the
    event recorded behind the launch that made ``tensors``)."""
    if stream is None:
        yield
        return
    with torch.cuda.stream(stream):
        _take_on_stream(ev, tensors, stream)
        yield


def _writeback(cfg: Config, stats: prof.OverlapStats, policy: faults.RetryPolicy,
               log) -> ply.WritebackQueue:
    """The lanes' writeback queue: write walls into the ``write`` lane,
    transient write errors retried under the pipeline policy."""

    on_retry = _lane_on_retry(stats, policy, log, "write")
    return ply.WritebackQueue(
        on_write=lambda path, dt: stats.add("write", dt, view=os.path.basename(path)),
        retry=policy, on_retry=lambda path, n, e: on_retry(n, e))


def _mark_fatal(exc: BaseException) -> None:
    """A device failure on the card that must fail the run: the in-order
    assembly re-raises it instead of recording a view failure."""
    with contextlib.suppress(AttributeError, TypeError):
        exc.sl3d_fatal = True


def _join(futs, budget_s: float | None) -> None:
    """Wait, under one shared budget, for lane work already running: on an
    abort no prefetch or drain thread outlives the run by more than that."""
    deadline = dl.Deadline.after(budget_s, "lane join")
    for f in futs:
        if f.done():   # finished, or cancelled by the pool's shutdown
            continue
        rem = deadline.remaining() if deadline is not None else None
        if rem is not None and rem <= 0:
            return
        dl.wait_settled(f, rem)


class _Prefetch:
    """The prefetch window of an overlapped lane: loads go to ``pool`` in
    source order while fewer than ``depth`` are in flight and, on the card,
    a staging slot is free (a slot's lease is taken before its load is
    submitted, so the oldest loads always hold one). ``started`` keeps every future
    of the lane (loads and drains) for the join on an abort."""

    def __init__(self, pool: ThreadPoolExecutor, loader, sources, depth: int,
                 staging: _Staging | None):
        self.pool, self.loader, self.depth, self.staging = pool, loader, depth, staging
        self.pending = list(enumerate(sources))
        self.inflight: deque = deque()   # (idx, src, load future, lease)
        self.started: list = []
        self._next = 0

    def top_up(self) -> None:
        while self._next < len(self.pending) and len(self.inflight) < self.depth:
            lease = None
            if self.staging is not None:
                lease = self.staging.acquire()
                if lease is None:
                    return
            idx, src = self.pending[self._next]
            fut = self.pool.submit(self.loader, src, lease)
            self.started.append(fut)
            self.inflight.append((idx, src, fut, lease))
            self._next += 1

    def release(self, lease) -> None:
        if self.staging is not None:
            self.staging.release(lease)


def _finish_view(idx, src, pts, cols, cfg: Config, tail: _Tail, stats, retry,
                 wbq: ply.WritebackQueue | None = None, counts: dict | None = None,
                 dev=None, fire_clean: bool = False):
    """The per-view tail every lane shares: the clean chain (unless the
    fused drain already cleaned the view: ``counts`` given), the PLY (on
    ``wbq``, else written here), ``collect``. ``fire_clean``: the batched
    lane's ``clean.fused`` site fires before the chain, so a poisoned view
    quarantines alone. Returns (out path, points, write future or None)."""
    name = _item_name(src)
    if tail.clean_steps is not None and counts is None:
        t0 = time.perf_counter()

        def clean():
            if fire_clean:
                faults.fire("clean.fused", item=src)
            return _clean_arrays(pts, cols, cfg, tail.clean_steps, device=tail.device,
                                 timings=tail.timings, stats=stats)

        pts, cols, counts = retry("clean", clean)
        stats.add("clean", time.perf_counter() - t0, view=name)
    counts = counts if counts is not None else {"input": len(pts)}
    out_path = _out_path_for(src, tail.mode, tail.output) if tail.write_plys else name
    wfut = None
    if tail.write_plys:
        if wbq is not None:
            wfut = wbq.submit(out_path, pts, cols)
        else:
            t0 = time.perf_counter()
            retry("write", lambda: ply.write_ply(out_path, pts, cols))
            stats.add("write", time.perf_counter() - t0, view=name)
    if tail.collect is not None:
        tail.collect(idx, src, pts, cols, counts, dev=dev)
    return out_path, len(pts), wfut


def _view_done(report: BatchReport, name: str, out_path: str, n_pts: int, written: bool,
               log) -> None:
    log(f"[reconstruct] {name}: {n_pts:,} points -> "
        f"{out_path if written else 'in-memory handoff'}")
    report.outputs.append(out_path)
    report.points.append(n_pts)


def _assemble(report: BatchReport, src, out, cfg: Config, log, stats) -> None:
    """In-order assembly of one view's result: ``out`` is ("ok", path, n,
    write future) or ("fail", src, exc). A write error surfaces here,
    bounded by the write lane's budget; a device failure marked fatal
    (``_mark_fatal``) re-raises."""
    name = _item_name(src)
    if out[0] == "ok":
        _, out_path, n_pts, wfut = out
        try:
            if wfut is not None:
                _lane_wait(wfut, cfg, "write", f"write of {name}")
            _view_done(report, name, out_path, n_pts, wfut is not None, log)
            return
        except faults.InjectedCrash:
            raise
        except Exception as e:
            _budget_check("reconstruct")
            faults.annotate(e, stage="write")
            err = e
    else:
        err = out[2]
    if getattr(err, "sl3d_fatal", False):
        raise err
    _record_failure(report, src, name, err, log, stats)


def _reconstruct_serial(sources, cfg, scanner, report, log, stats, tail: _Tail) -> dict:
    """The reference-shaped loop: load, compute, clean, write, collect, one
    view at a time on the calling thread (``io_workers <= 1``, or one
    source). A view that fails after its retries is recorded and the loop
    goes on. Each view is timed under a ``StageTimer``, whose report goes to
    the framework log at DEBUG (``SL3D_LOG=DEBUG``)."""
    policy = _retry_policy(cfg)
    timer = prof.StageTimer()
    for idx, src in enumerate(sources):
        _budget_check("reconstruct")
        name = _item_name(src)
        retry = _stage_retry(policy, stats, log, name)
        try:
            with timer.stage(name):
                t0 = time.perf_counter()
                frames, texture = retry("load", lambda: _load_fired(src, cfg))
                stats.add("load", time.perf_counter() - t0, view=name)
                t0 = time.perf_counter()
                pts, cols = retry("compute", lambda: _compute_fired(
                    scanner, frames, cfg, src, texture=texture, tail=tail))
                report.launches += 1
                stats.add("compute", time.perf_counter() - t0, items=1, view=name)
                out_path, n_pts, _ = _finish_view(idx, src, pts, cols, cfg, tail, stats,
                                                  retry)
            _view_done(report, name, out_path, n_pts, tail.write_plys, log)
        except Exception as e:
            _record_failure(report, src, name, e, log, stats)
    prof.get_logger().debug("reconstruct stage timing:\n%s", timer.report())
    return {}


def _reconstruct_pipelined(sources, cfg, scanner, report, log, stats, tail: _Tail) -> dict:
    """The per-view overlapped lane (``compute_batch <= 1``, ``io_workers >
    1``), the JAX package's schedule:

      load     frame stacks prefetched on the ``io_workers`` pool, at most
               ``prefetch_depth`` ahead (on the card each into a pinned
               slot of the staging ring)
      compute  the main thread uploads and dispatches view N+1 while view N
               is still in flight; at most ``prefetch_depth + 1`` views are
               dispatched and not yet drained
      drain    one worker (``sl3d-drain``, on its own stream, after the
               view's launch event) pays the device sync and the
               compaction, runs the clean chain and ``collect``, and hands
               the PLY to the writeback queue

    Results are assembled strictly in source order, so ``outputs``,
    ``failed`` and the summary equal the serial lane's."""
    policy = _retry_policy(cfg)
    depth = max(1, cfg.parallel.prefetch_depth)
    card = _on_card(scanner)
    staging = _Staging(scanner.device, depth) if card else None
    drain_stream = torch.cuda.Stream(device=scanner.device) if card else None
    load_pool = ThreadPoolExecutor(max_workers=max(1, cfg.parallel.io_workers),
                                   thread_name_prefix="sl3d-prefetch")
    drain_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sl3d-drain")
    wbq = _writeback(cfg, stats, policy, log)

    def load_one(src, lease):
        t0 = time.perf_counter()
        frames, texture = _retry_stage("load", lambda: _load_fired(src, cfg), policy,
                                       _lane_on_retry(stats, policy, log, "load"))
        stats.add("load", time.perf_counter() - t0, view=_item_name(src))
        staged = staging.fill(lease, (frames,)) if staging is not None else None
        return frames, texture, staged

    def dispatch(src, frames, texture, staged, lease):
        if staged is not None:
            t0 = time.perf_counter()
            (frames,), ev = staging.upload([staged[0]], [lease], stacked=False)
            _take_on_stream(ev, (frames,))
            stats.add("transfer", time.perf_counter() - t0, view=_item_name(src))
        stats.add_transfer(frames=int(frames.nbytes))
        cloud = _forward_fired(scanner, frames, cfg, src, texture=texture, tail=tail)
        if staged is None:
            return cloud, None
        done = torch.cuda.Event()
        done.record()
        return cloud, done

    def drain_one(idx, src, cloud, ev):
        name = _item_name(src)
        with _drain_stream(drain_stream, ev, (cloud.points, cloud.colors, cloud.valid)):
            t0 = time.perf_counter()
            pts, cols = tri.compact_cloud(cloud)
            stats.add("compute", time.perf_counter() - t0, items=1, view=name)
            retry = _stage_retry(policy, stats, log, name)
            out_path, n_pts, wfut = _finish_view(idx, src, pts, cols, cfg, tail, stats,
                                                 retry, wbq)
        return "ok", out_path, n_pts, wfut

    results: dict[int, tuple] = {}
    window = _Prefetch(load_pool, load_one, sources, depth, staging)
    undrained: deque = deque()
    aborted = True
    try:
        window.top_up()
        while window.inflight:
            _budget_check("reconstruct")
            idx, src, lfut, lease = window.inflight.popleft()
            stats.sample_queue(len(window.inflight))
            name = _item_name(src)
            try:
                frames, texture, staged = _lane_wait(lfut, cfg, "load", f"load of {name}")
            except faults.InjectedCrash:
                raise
            except Exception as e:
                results[idx] = ("fail", src, e)
                window.release(lease)
                window.top_up()
                continue
            while len(undrained) > depth:
                dl.wait_settled(undrained.popleft(), _lane_budget_s(cfg, "compute"))
            try:
                t0 = time.perf_counter()
                cloud, ev = _retry_stage("compute",
                                         lambda: dispatch(src, frames, texture, staged,
                                                          lease),
                                         policy, _lane_on_retry(stats, policy, log, "compute"))
                report.launches += 1
                stats.add("compute", time.perf_counter() - t0, view=name)
            except faults.InjectedCrash:
                raise
            except Exception as e:
                results[idx] = ("fail", src, e)
                continue
            finally:
                window.release(lease)
                window.top_up()
            dfut = drain_pool.submit(drain_one, idx, src, cloud, ev)
            window.started.append(dfut)
            undrained.append(dfut)
            results[idx] = ("done", dfut)

        for idx, src in window.pending:
            _budget_check("reconstruct")
            kind, *rest = results[idx]
            if kind == "done":
                try:
                    out = _lane_wait(rest[0], cfg, "compute", f"drain of {_item_name(src)}")
                except faults.InjectedCrash:
                    raise
                except Exception as e:
                    _budget_check("reconstruct")   # a wait cut by the run budget aborts
                    out = ("fail", src, e)
            else:
                out = ("fail", src, rest[-1])
            _assemble(report, src, out, cfg, log, stats)
        aborted = False
    finally:
        load_pool.shutdown(wait=False, cancel_futures=True)
        drain_pool.shutdown(wait=False, cancel_futures=True)
        if aborted:
            _join(window.started, cfg.deadlines.drain_s if cfg.deadlines.enabled else None)
        wbq.close(wait=True, timeout_s=_lane_budget_s(cfg, "drain"))
    return {"transfer_bytes_pinned": staging.pinned_bytes if staging else 0}


def _pad_views(a, bucket: int):
    """A batch [V, ...] (host array or tensor) padded to ``bucket`` views
    with copies of its last view."""
    pad = bucket - a.shape[0]
    if pad <= 0:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])


def _reconstruct_batched(sources, cfg, scanner, report, log, stats, tail: _Tail,
                         packed: bool) -> dict:
    """The view-batched lane (``compute_batch > 1``), the JAX package's
    schedule, ``compute_batch`` views a device launch:

      load      stacks prefetched on the ``io_workers`` pool, a window of
                ``compute_batch + prefetch_depth`` ahead. On the card each
                raw stack lands in a pinned slot of the staging ring; a
                packed stack's planes, white and black go to the card from
                the prefetch thread as they arrive
      transfer  the main thread queues the batch's copy on the upload
                stream (raw) or stacks the views on the card (packed); the
                compute stream waits on the copies' events
      compute   one ``forward_views_batched`` (``forward_views_packed``)
                launch a batch, dispatched while the previous batch still
                drains; at most two batches are dispatched and not yet
                drained
      drain     one worker (``sl3d-drain``, its own stream, after the
                batch's launch event): one copy of the batch to the host,
                per-view compaction (``tri.compact_cloud``), then each
                view's clean, ``collect`` and writeback; with
                ``pipeline.fused_clean`` the batch is compacted and cleaned
                on the card instead (``ops/fused_view``) and comes to the
                host in one copy

    Stacks of one batch share a shape: a change of shape closes the batch
    early. The kernels take any V, so the view axis is not padded, except
    over a views mesh (``parallel.shard_views`` with >= 2 cards): the batch
    pads to a multiple of the card count with copies of its last view,
    shards over the cards (``forward_views_batched(mesh=)``) and drops the
    copies.
    ``compute.view`` fires per view at assembly; a fault there, or a fault
    injected at the fused drain's ``clean.fused`` site, re-runs the batch's
    views one at a time under the retry budget (a packed stack unpacks for
    it: decode + triangulate of the binarized stack is the packed lane's
    bit for bit). Any other failure of a batched launch or drain does the
    same on the CPU, as in the JAX package; on the card it fails the run,
    so a kernel that fails at the batch's shape never passes as a per-view
    success. Results are assembled in source order."""
    policy = _retry_policy(cfg)
    batch_n = max(1, cfg.parallel.compute_batch)
    depth = batch_n + max(1, cfg.parallel.prefetch_depth)
    card = _on_card(scanner)
    staging = _Staging(scanner.device, depth) if card else None
    drain_stream = torch.cuda.Stream(device=scanner.device) if card else None
    use_fused = bool(cfg.pipeline.fused_clean)
    mesh = meshlib.views_mesh(cfg.parallel)
    n_dev = mesh.size if mesh is not None else 1
    if mesh is not None:
        log(f"[reconstruct] sharding view batches over {n_dev} devices "
            f"(parallel.shard_views)")
    load_pool = ThreadPoolExecutor(max_workers=max(1, cfg.parallel.io_workers),
                                   thread_name_prefix="sl3d-prefetch")
    drain_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sl3d-drain")
    wbq = _writeback(cfg, stats, policy, log)
    launch_lock = threading.Lock()

    def count_launch():
        with launch_lock:
            report.launches += 1

    def on_card_fatal(e: BaseException) -> bool:
        return scanner.device.type == "cuda" and not isinstance(e, faults.InjectedFault)

    def load_one(src, lease):
        t0 = time.perf_counter()
        frames = _retry_stage("load", lambda: _load_fired(src, cfg)[0], policy,
                              _lane_on_retry(stats, policy, log, "load"))
        stats.add("load", time.perf_counter() - t0, view=_item_name(src))
        return frames, (staging.fill(lease, (frames,)) if staging is not None else None)

    def load_one_packed(src, lease):
        t0 = time.perf_counter()
        ps = _retry_stage("load", lambda: _load_packed_fired(src, cfg), policy,
                          _lane_on_retry(stats, policy, log, "load"))
        stats.add("load", time.perf_counter() - t0, view=_item_name(src))
        dev = None
        if staging is not None:
            t0 = time.perf_counter()
            bufs = staging.fill(lease, (ps.planes, ps.white, ps.black))
            dev = staging.upload(list(bufs), [lease], stacked=False)
            staging.release(lease)   # the copy is queued: the slot may refill
            stats.add("transfer", time.perf_counter() - t0, view=_item_name(src))
        stats.add_transfer(frames=ps.planes.nbytes + ps.white.nbytes + ps.black.nbytes,
                           frames_raw=int(np.prod(ps.shape)))
        return ps, dev

    def ok(idx, src, pts, cols, counts=None, dev=None):
        try:
            out_path, n_pts, wfut = _finish_view(
                idx, src, pts, cols, cfg, tail, stats,
                _stage_retry(policy, stats, log, _item_name(src)), wbq,
                counts=counts, dev=dev, fire_clean=True)
        except faults.InjectedCrash:
            raise
        except Exception as e:
            return "fail", src, e
        return "ok", out_path, n_pts, wfut

    def run_view_fallback(item):
        idx, src, stack, _ = item
        frames = imio.unpack_stack(stack)[0] if packed else stack
        try:
            t0 = time.perf_counter()
            pts, cols = _retry_stage(
                "compute", lambda: _compute_fired(scanner, frames, cfg, src,
                                                  use_fused=False if packed else None),
                policy, _lane_on_retry(stats, policy, log, "compute"))
            count_launch()
            stats.add("compute", time.perf_counter() - t0, items=1, view=_item_name(src))
        except faults.InjectedCrash:
            raise
        except Exception as e:
            return "fail", src, e
        return ok(idx, src, pts, cols)

    def fallback(items):
        with _drain_stream(drain_stream):
            return [run_view_fallback(it) for it in items]

    def drain_fused(items, cloud):
        from structured_light_for_3d_model_replication_tpu_torch.ops import (
            fused_view as fvlib,
        )

        for _idx, src, _s, _d in items:
            faults.fire("clean.fused", item=src)
        t0 = time.perf_counter()
        views, d2h, clean_s = fvlib.fused_clean_views(
            cloud.points, cloud.colors, cloud.valid, cfg.clean, tail.clean_steps or (),
            timings=tail.timings)
        wall = time.perf_counter() - t0
        stats.add("compute", max(0.0, wall - clean_s), items=len(items))
        if clean_s:
            stats.add("clean", clean_s)
        stats.add_transfer(d2h=d2h)
        stats.add_kernel("fused_view", wall, bucket=int(cloud.points.shape[1]),
                         bytes_moved=d2h)
        return [(idx, src, v.points, v.colors, v.counts, (v.dev_points, v.count))
                for (idx, src, _s, _d), v in zip(items, views)]

    def drain_batch(items, cloud, ev):
        with _drain_stream(drain_stream, ev, (cloud.points, cloud.colors, cloud.valid)):
            try:
                if use_fused:
                    views = drain_fused(items, cloud)
                else:
                    t0 = time.perf_counter()
                    pts_v, cols_v, val_v = (cloud.points.cpu(), cloud.colors.cpu(),
                                            cloud.valid.cpu())
                    stats.add("compute", time.perf_counter() - t0, items=len(items))
                    stats.add_transfer(d2h=sum(t.numel() * t.element_size()
                                               for t in (pts_v, cols_v, val_v)))
                    views = []
                    for j, (idx, src, _s, _d) in enumerate(items):
                        pts, cols = tri.compact_cloud(
                            tri.CloudResult(pts_v[j], cols_v[j], val_v[j]))
                        views.append((idx, src, pts, cols, None, None))
            except faults.InjectedCrash:
                raise
            except Exception as e:
                if on_card_fatal(e):
                    _mark_fatal(e)
                    raise
                if faults.is_transient(e):
                    # the batch-level firing spent a transient's budget; the
                    # per-view re-run below is its retry
                    stats.add_retry("clean" if use_fused else "compute")
                log(f"[reconstruct] batched drain of {len(items)} view(s) failed "
                    f"({type(e).__name__}: {e}); re-running views individually")
                return [run_view_fallback(it) for it in items]
            return [ok(idx, src, pts, cols, counts, dev)
                    for idx, src, pts, cols, counts, dev in views]

    def dispatch_batch(items):
        """Main thread: assemble, upload and launch one batch; returns the
        drain future. A poisoned batch degrades to the per-view lane inside
        the drain worker; on the card a launch that raises fails the run."""
        poisoned = None
        try:
            for it in items:
                src = it[1]
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
                    v = len(items)
                    bucket = -(-v // n_dev) * n_dev
                    cur = torch.cuda.current_stream() if staging is not None else None
                    if packed:
                        if staging is not None:
                            for it in items:
                                parts, ev = it[3]
                                _take_on_stream(ev, parts, cur)
                            planes, white, black = (torch.stack([it[3][0][k] for it in items])
                                                    for k in range(3))
                        else:
                            planes, white, black = (
                                np.stack([getattr(it[2], k) for it in items])
                                for k in ("planes", "white", "black"))
                        stats.add("transfer", time.perf_counter() - t0)
                        t0 = time.perf_counter()
                        cloud = scanner.forward_views_packed(
                            *(_pad_views(a, bucket) for a in (planes, white, black)),
                            n_frames=items[0][2].n_frames, mesh=mesh, **_forward_kw(cfg))
                    else:
                        if staging is not None:
                            frames, ev = staging.upload([it[3][0] for it in items],
                                                        [it[4] for it in items], stacked=True)
                            _take_on_stream(ev, (frames,), cur)
                        else:
                            frames = np.stack([it[2] for it in items])
                        stats.add("transfer", time.perf_counter() - t0)
                        stats.add_transfer(frames=sum(int(it[2].nbytes) for it in items))
                        t0 = time.perf_counter()
                        cloud = scanner.forward_views_batched(
                            _pad_views(frames, bucket), mesh=mesh, **_forward_kw(cfg))
                    if bucket > v:
                        cloud = tri.CloudResult(*(a[:v] for a in cloud))
                    count_launch()
                    stats.add_launch(v, bucket, time.perf_counter() - t0)
                    done = None
                    if cur is not None:
                        done = torch.cuda.Event()
                        done.record(cur)
                    return drain_pool.submit(drain_batch, [it[:4] for it in items], cloud,
                                             done)
                except faults.InjectedCrash:
                    raise
                except Exception as e:
                    if scanner.device.type == "cuda":
                        raise
                    poisoned = e
        finally:
            for it in items:
                window.release(it[4])
        if faults.is_transient(poisoned):
            # the assembly-time firing spent a transient's budget; the
            # per-view re-run below is its retry
            stats.add_retry("compute")
        log(f"[reconstruct] batch of {len(items)} view(s) degraded to per-view compute "
            f"({type(poisoned).__name__}: {poisoned})")
        return drain_pool.submit(fallback, [it[:4] for it in items])

    results: dict[int, tuple] = {}
    window = _Prefetch(load_pool, load_one_packed if packed else load_one, sources, depth,
                       staging)
    batch_items: list[tuple] = []
    batch_futs: deque = deque()

    def flush():
        if not batch_items:
            return
        # double buffer: at most 2 dispatched-but-undrained batches
        while len(batch_futs) >= 2:
            dl.wait_settled(batch_futs.popleft(), _lane_budget_s(cfg, "compute"))
        dfut = dispatch_batch(list(batch_items))
        window.started.append(dfut)
        batch_futs.append(dfut)
        for j, it in enumerate(batch_items):
            results[it[0]] = ("batch", dfut, j)
        batch_items.clear()
        window.top_up()

    aborted = True
    try:
        window.top_up()
        while window.inflight:
            _budget_check("reconstruct")
            idx, src, lfut, lease = window.inflight.popleft()
            stats.sample_queue(len(window.inflight))
            window.top_up()
            try:
                stack, staged = _lane_wait(lfut, cfg, "load", f"load of {_item_name(src)}")
            except faults.InjectedCrash:
                raise
            except Exception as e:
                results[idx] = ("fail", src, e)
                window.release(lease)
                window.top_up()
                continue
            if batch_items and stack.shape != batch_items[0][2].shape:
                flush()   # stacks of another shape cannot share a launch
            # a packed load handed its lease back once its upload was queued
            batch_items.append((idx, src, stack, staged, None if packed else lease))
            if len(batch_items) >= batch_n:
                flush()
        flush()   # the ragged tail

        for idx, src in window.pending:
            _budget_check("reconstruct")
            kind, *rest = results[idx]
            if kind == "batch":
                dfut, j = rest
                try:
                    out = _lane_wait(dfut, cfg, "compute",
                                     f"batch drain of {_item_name(src)}")[j]
                except faults.InjectedCrash:
                    raise
                except Exception as e:
                    _budget_check("reconstruct")   # a wait cut by the run budget aborts
                    out = ("fail", src, e)
            else:
                out = ("fail", src, rest[-1])
            _assemble(report, src, out, cfg, log, stats)
        aborted = False
    finally:
        load_pool.shutdown(wait=False, cancel_futures=True)
        drain_pool.shutdown(wait=False, cancel_futures=True)
        if aborted:
            _join(window.started, cfg.deadlines.drain_s if cfg.deadlines.enabled else None)
        wbq.close(wait=True, timeout_s=_lane_budget_s(cfg, "drain"))
    return {"compute_batch": batch_n,
            "transfer_bytes_pinned": staging.pinned_bytes if staging else 0}


def _lane(cfg: Config, n_sources: int) -> str:
    """The JAX package's choice: batched (packed with
    ``pipeline.packed_ingest``) for several sources at ``compute_batch`` >
    1 with a scanner, else pipelined for several sources at ``io_workers``
    > 1, else serial."""
    if n_sources > 1 and cfg.parallel.compute_batch > 1 and not _scanner_free(cfg):
        return "packed" if cfg.pipeline.packed_ingest else "batched"
    if n_sources > 1 and cfg.parallel.io_workers > 1:
        return "pipelined"
    return "serial"


def _reconstruct_lane(sources, cfg, scanner, report, log, stats, tail: _Tail) -> None:
    """Run the lane ``reconstruct`` and ``run_pipeline`` share; ``stats``
    gets its lanes' walls and ``report.overlap`` their snapshot. The lanes'
    transient retries (every lane but ``register``) add to
    ``report.retries``."""
    lane = _lane(cfg, len(sources))
    before = _lane_retries(stats)
    t0 = time.perf_counter()
    with prof.trace():
        if lane == "serial":
            extra = _reconstruct_serial(sources, cfg, scanner, report, log, stats, tail)
        elif lane == "pipelined":
            extra = _reconstruct_pipelined(sources, cfg, scanner, report, log, stats, tail)
        else:
            extra = _reconstruct_batched(sources, cfg, scanner, report, log, stats, tail,
                                         packed=lane == "packed")
    stats.finish(time.perf_counter() - t0)
    if lane != "serial":
        prof.get_logger().debug("reconstruct %s overlap: %s",
                                "pipeline" if lane == "pipelined" else "batched",
                                stats.summary())
    report.overlap = {**stats.as_dict(), **extra}
    report.retries += _lane_retries(stats) - before


def _lane_retries(stats: prof.OverlapStats) -> int:
    return sum(n for lane, n in stats.as_dict()["retries"].items() if lane != "register")


def reconstruct(calib_path: str, target: str, mode: str = "single",
                output: str | None = None, cfg: Config | None = None,
                device=None, log=print) -> BatchReport:
    """Scan folder(s) -> per-view colored PLY, on ``device`` (None -> cuda).

    ``output``: for single mode a .ply path (default ``<target>.ply``); for
    batch/files mode a directory (default: beside each source). The lane is
    the JAX package's choice (``_lane``): batched, else pipelined, else
    serial; outputs and report are the same in each. A view that fails is
    recorded in ``report.failed`` / ``report.failures`` and the others go
    on; the run owns a deadline context unless an enclosing run installed
    one.
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
    stall_dir = output if output and os.path.isdir(output) else None
    with _run_context(cfg, stall_dir, report.run_id, log):
        _reconstruct_lane(sources, cfg, scanner, report, log, prof.OverlapStats(),
                          _Tail(mode, output, dev, calib=calib))
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
                log=print, device=None, timings: dict | None = None, step_callback=None):
    """Folder of per-view PLYs -> one registered 360-degree cloud PLY, on
    ``device`` (None -> cuda). A view that cannot be read is dropped with a
    warning as long as max(2, pipeline.min_views) readable views remain.
    ``step_callback(i, points, colors, total)`` is ``merge_360``'s (e.g.
    ``StageRecorder.merge_step``). ``merge.method='posegraph'`` runs
    ``merge_360_posegraph``; ``parallel.force_bf16_features`` forces the
    bf16 feature product. ``merge_360`` takes its device arm on the card
    unless its gate refuses (a step callback does). Returns (points, colors,
    transforms)."""
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
    merge = recon.merge_360_posegraph if cfg.merge.method == "posegraph" else recon.merge_360
    mesh = _merge_mesh_grid(cfg, log)
    with prof.trace():
        points, colors, transforms = merge(clouds, cfg.merge, log=log, timings=timings,
                                           device=dev, step_callback=step_callback,
                                           feat_bf16=cfg.parallel.force_bf16_features,
                                           mesh=mesh)
    ply.write_ply(output_ply, points, colors)
    log(f"[merge] wrote {output_ply} ({len(points):,} points)")
    return points, colors, transforms


# ---------------------------------------------------------------------------
# clean
# ---------------------------------------------------------------------------

def _clean_arrays(pts: np.ndarray, cols: np.ndarray, cfg: Config,
                  steps=CLEAN_STEPS, log=None, device=None,
                  timings: dict | None = None, stats: prof.OverlapStats | None = None,
                  step_callback=None):
    """The masked clean chain on one in-memory cloud, on ``device`` (None ->
    cuda): the cloud padded to its 2048-multiple bucket with rows at 1e9
    (valid = the first n rows), ``ops/pointcloud.clean_chain``, survivors
    taken once at the end; under ``parallel.backend='numpy'`` the host
    chain ``clean_chain_np`` on the unpadded cloud instead. Returns (points', colors', counts {"input": n,
    step: survivors}). A step that leaves no point aborts the chain there
    (later steps are not counted). ``timings`` gets ``clean_<step>_s``;
    ``stats`` the round trip's bytes (the cloud up, the step masks down:
    what the fused drain does without). ``step_callback(step, points,
    colors)`` gets each step's surviving cloud."""
    log = log or (lambda m: None)
    n = len(pts)
    counts = {"input": n}
    params = pc.chain_params(cfg.clean, tuple(steps))
    if not params:
        return pts, cols, counts
    if cfg.parallel.backend == "numpy":
        masks, cnts = pc.clean_chain_np(pts, np.ones(n, bool), cfg.clean, tuple(steps))
    else:
        dev = resolve_device(device)
        bucket = recon._bucket_pad(n)
        pts_pad = np.full((bucket, 3), knnlib.FAR, np.float32)
        pts_pad[:n] = pts
        valid = torch.arange(bucket, device=dev) < n
        masks, cnts = pc.clean_chain(torch.from_numpy(pts_pad).to(dev), valid, cfg.clean,
                                     tuple(steps), timings=timings)
        masks = masks[:, :n].cpu().numpy()
        cnts = cnts.cpu().numpy()
        if stats is not None:
            stats.add_transfer(h2d=int(pts_pad.nbytes) + bucket,
                               d2h=int(masks.nbytes) + int(cnts.nbytes))
    final = masks[-1]
    for i, (step, _) in enumerate(params):
        counts[step] = int(cnts[i])
        log(f"[clean] {step}: {int(cnts[i]):,} points remain")
        if step_callback is not None:
            step_callback(step, pts[masks[i]], cols[masks[i]])
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
                steps=CLEAN_STEPS, log=print, device=None, step_callback=None) -> dict:
    """The clean chain on one cloud PLY (background plane -> largest
    cluster -> radius outlier -> statistical outlier, each selectable), on
    ``device`` (None -> cuda). ``step_callback(name, points, colors)`` gets
    each step's surviving cloud (``acquire.viewer.StageRecorder``); it
    changes nothing of the output. Returns the per-step counts."""
    cfg = cfg or Config()
    pts, cols = _read_cloud(input_ply)
    pts, cols, counts = _clean_arrays(pts, cols, cfg, tuple(steps), log=log, device=device,
                                      step_callback=step_callback)
    ply.write_ply(output_ply, pts, cols)
    log(f"[clean] wrote {output_ply} ({len(pts):,} points)")
    return counts


def clean_batch(input_folder: str, output_folder: str, cfg: Config | None = None,
                steps=CLEAN_STEPS, log=print, device=None) -> BatchReport:
    """Clean every PLY of a folder into ``output_folder``: reads on the I/O
    pool, the chain per cloud, writes on the writeback queue. A cloud that
    fails is logged and listed in ``report.failed``, the others go on."""
    cfg = cfg or Config()
    dev = resolve_device(device)
    paths = sorted(os.path.join(input_folder, f) for f in os.listdir(input_folder)
                   if f.lower().endswith(".ply"))
    if not paths:
        raise ValueError(f"no .ply files in {input_folder!r}")
    os.makedirs(output_folder, exist_ok=True)
    report = BatchReport(lane="clean", device=str(dev))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, min(cfg.parallel.io_workers, len(paths))),
                            thread_name_prefix="sl3d-cleanread") as pool, \
            ply.WritebackQueue() as wbq:
        pend = []
        for src, fut in [(p, pool.submit(_read_cloud, p)) for p in paths]:
            name = os.path.basename(src)
            try:
                pts, cols = fut.result()
                pts, cols, _ = _clean_arrays(pts, cols, cfg, tuple(steps), device=dev)
                out_path = os.path.join(output_folder, name)
                pend.append((src, out_path, len(pts), wbq.submit(out_path, pts, cols)))
            except Exception as e:  # per-item tolerance: the batch goes on
                log(f"[clean] {name} FAILED: {e}")
                report.failed.append((src, str(e)))
        for src, out_path, n_pts, wfut in pend:
            try:
                wfut.result()
            except Exception as e:
                log(f"[clean] {os.path.basename(src)} FAILED: {e}")
                report.failed.append((src, str(e)))
                continue
            log(f"[clean] {os.path.basename(src)}: {n_pts:,} points -> {out_path}")
            report.outputs.append(out_path)
            report.points.append(n_pts)
    report.elapsed_s = time.perf_counter() - t0
    log(f"[clean] {len(report.outputs)} cloud(s) cleaned, {len(report.failed)} "
        f"failed, on {dev} in {report.elapsed_s:.2f}s")
    return report


def write_patterns(out_dir: str, cfg: Config | None = None, log=print) -> list[str]:
    """The projector's Gray-code pattern stack (``projector`` config) as
    numbered images under ``out_dir``: the frames a capture projects."""
    cfg = cfg or Config()
    p = cfg.projector
    frames = gc.generate_pattern_stack(p.width, p.height, brightness=p.brightness,
                                       downsample=p.downsample)
    paths = imio.save_stack(out_dir, frames)
    log(f"[patterns] {len(paths)} frames -> {out_dir}")
    return paths


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
    merge_mode: str = ""            # 'streamed' | 'barrier' | 'posegraph'
    mesh_status: str = ""           # 'computed' | 'cache-hit'
    merged_points: int = 0
    mesh_verts: int = 0
    mesh_faces: int = 0
    device: str = ""
    clean_counts: list[dict] = field(default_factory=list)  # per merged view, angle order
    transforms: list = field(default_factory=list)  # view i -> view 0, angle order
    overlap: dict | None = None     # OverlapStats of the lanes incl. register
    # a coordinated run's lease/steal/ledger summary (the coordinator
    # attaches it after the assembly pass)
    coordinator: dict | None = None
    # the incremental assembly's accounting (merge.incremental pods only):
    # folded / used views, folded pairs, fold wall, tail_s
    assembly: dict | None = None
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


def _engine_json(cfg: Config, dev: torch.device) -> str:
    """The port's tag in every cache key: ``parallel.backend``, as the JAX
    package keys it (the numpy backend decodes, triangulates and cleans on
    the host), the engine and the device type. The CPU runs the kernels'
    plain versions, which are not bit-equal to them, and meshes at a
    shallower depth, so a directory written on one device never hands its
    entries to a run on the other."""
    return json.dumps({"backend": cfg.parallel.backend, "engine": "torch",
                       "device": dev.type})


def _merge_mesh_grid(cfg: Config, log=None):
    """The merge's mesh (``parallel.merge_mesh`` over >= 2 cards), else
    None; resolved here for every merge arm."""
    mesh = meshlib.merge_mesh(cfg.parallel)
    if mesh is not None and log is not None:
        log(f"[merge] sharding the chain over {mesh.size} devices (parallel.merge_mesh)")
    return mesh


def _merge_numeric_json(cfg: Config) -> str:
    """The merge config subtree minus its schedule knobs, and
    ``parallel.force_bf16_features`` (it changes the correspondences), as
    the JAX package keys them — the key material shared by the merge entry
    and every per-pair entry."""
    d = dataclasses.asdict(cfg.merge)
    for k in _MERGE_SCHEDULE_KNOBS:
        d.pop(k, None)
    return json.dumps({"merge": d}, sort_keys=True) + json.dumps(
        {"force_bf16": cfg.parallel.force_bf16_features})


def _pair_key(cache: StageCache, cfg: Config, dev: torch.device, dig_dst: str,
              dig_src: str, pid: int) -> str:
    """The stage-cache key of chain pair ``pid`` (view dst <- view src): the
    two cleaned views' output digests, the merge numerics, the engine tag
    and the chain position. The streamed registrar, a coordinated worker's
    pair item and the incremental assembly all key pairs here: a drifted
    key would read as a cold merge, never as a wrong byte."""
    return cache.key("pair", digests=[dig_dst, dig_src],
                     config_json=_merge_numeric_json(cfg) + _engine_json(cfg, dev)
                     + json.dumps({"pair": pid}))


class _StreamRegistrar:
    """The ``register`` lane of the streaming 360 merge.

    ``run_pipeline`` feeds each view's cleaned compact cloud (host arrays)
    here the moment the lane has cleaned it (or straight from the view
    cache), from the reconstruct lane's drain thread; one worker thread
    preps the view (``recon.prep_view``, or ``recon.prep_view_device`` on the
    fused drain's device buffers) and, as
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

    Device work: the lane passes ``device`` explicitly and on CUDA runs on a
    stream of its own (``_on_stream``, the worker and ``finish``'s catch-up
    alike), so the clean chain's host syncs on the drain thread never wait
    on queued RANSAC/ICP work, nor the reverse; every result comes back to
    the host. A feed with ``dev=(device points, count)`` (the fused drain)
    is prepped from that buffer with no upload: the drain's one copy to the
    host came after the buffer was made, so it is complete when fed, and
    the lane's stream takes it with ``record_stream`` so its memory is not
    handed out while the prep still reads it. ``close`` is bounded by
    ``deadlines.register_s``: a worker blocked past it (a wedged device call
    cannot be cancelled) is abandoned and ``finish`` gives every pair it
    never resolved the identity fallback.
    """

    def __init__(self, cfg: Config, cache: StageCache, stats: prof.OverlapStats,
                 device: torch.device, log, mesh=None):
        self.cfg = cfg
        self.mesh = mesh   # parallel.merge_mesh: the pair groups shard over it
        self.cache = cache
        self.stats = stats
        self.device = device
        self.log = log
        self.voxel = float(cfg.merge.voxel_size)
        self.pair_batch = max(1, cfg.merge.pair_batch)
        self.policy = _retry_policy(cfg)
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
        self._devs: dict[int, tuple] = {}   # the fused drain's (points, count)
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

    def feed(self, i: int, pts: np.ndarray, cols: np.ndarray, dev=None) -> None:
        """Hand view ``i``'s cleaned cloud to the lane (any thread); ``dev``:
        the same points on the card, ``(tensor [B, 3], count)``."""
        self._futs.append(self._pool.submit(self._note, i, pts, cols, dev))

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
                if f.done():   # finished, or cancelled by the shutdown above
                    continue
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

    def _note(self, i: int, pts, cols, dev=None) -> None:
        dl.beat("register")
        self._digests[i] = StageCache.digest_arrays(points=pts, colors=cols)
        self._clouds[i] = (pts, cols)
        if dev is not None:
            self._devs[i] = dev
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
        key = _pair_key(self.cache, self.cfg, self.device, self._digests[dst],
                        self._digests[src], pid)
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
            dev = self._devs.pop(i, None)
            if dev is not None and self.cfg.merge.sample_before <= 1:
                if self._stream is not None:
                    dev[0].record_stream(self._stream)
                # bit-identical to prep_view on the host points
                p = recon.prep_view_device(dev[0], dev[1], self.voxel)
            else:
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
                lambda: recon.register_prep_pairs(
                    pairs, ids, self.cfg.merge, self.voxel,
                    feat_bf16=self.cfg.parallel.force_bf16_features, mesh=self.mesh),
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
        json.dumps({"steps": list(steps)}) + _engine_json(cfg, dev)
    t0 = time.perf_counter()
    with tel.stage("cache.keys", views=len(sources)):
        view_keys = cache.keys_parallel(
            "view", [[calib_path] + imio.list_frame_files(src) for src in sources],
            config_json=view_cfg, io_workers=cfg.parallel.io_workers,
            timeout_s=_lane_budget_s(cfg, "cache"))
    return calib, sources, view_keys, time.perf_counter() - t0


def run_pipeline(calib_path: str, target: str, out_dir: str, cfg: Config | None = None,
                 steps=CLEAN_STEPS, merged_name: str = "merged.ply",
                 stl_name: str = "model.stl", log=print, device=None,
                 prefold=None, cache: StageCache | None = None) -> PipelineReport:
    """Scan-to-print on ``device`` (None -> cuda): every view folder under
    ``target`` (with enough frames, in ``<n>deg`` angle order) ->
    ``reconstruct``'s lane -> ``_clean_arrays`` -> the streamed or barrier
    merge -> ``_mesh_arrays`` -> ``<out_dir>/merged.ply`` and
    ``<out_dir>/model.stl``, each stage behind the stage cache (module
    docstring). With ``observability.trace`` the run writes ``trace.jsonl``
    and ``metrics.json``; it runs under the deadline layer. An exception
    aborts the run and leaves ``<out_dir>/failures.json``.

    ``coordinator.workers > 0`` or ``coordinator.listen`` runs the scan
    across worker processes on ``device`` (``run_coordinated``), which
    re-enters here with ``workers=0`` for the assembly pass. ``prefold``
    (that pass of an incremental pod only): the coordinator's fold lane's
    merged prefix (``pipeline.assembly.Prefold``), re-validated against this
    run's own view order, digests and pair transforms before it seeds
    ``finalize_chain``, so the bytes never depend on it. ``cache``: a
    caller's stage cache in place of ``<out_dir>/.slscan-cache`` (the
    serving assembly passes its tenant's ``TenantCache`` over the shared
    store); the keys are the same either way."""
    cfg = cfg or Config()
    if cfg.coordinator.workers > 0 or cfg.coordinator.listen:
        # lazy: the coordinator imports this module for the item programs
        from structured_light_for_3d_model_replication_tpu_torch.parallel import (
            coordinator,
        )

        return coordinator.run_coordinated(calib_path, target, out_dir, cfg,
                                           steps=tuple(steps), merged_name=merged_name,
                                           stl_name=stl_name, log=log, device=device)
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
                  "backend": cfg.parallel.backend, "engine": "torch",
                  "device": str(dev),
                  "merge_method": cfg.merge.method, "merge_stream": cfg.merge.stream,
                  "host_cpus": os.cpu_count(),
                  "device_count": torch.cuda.device_count() if dev.type == "cuda" else 0})
        prev = tel.activate(tracer)
        log(f"[pipeline] flight recorder armed (run {report.run_id}) -> {tracer.path}")
    try:
        with _run_context(cfg, out_dir, report.run_id, log):
            _run_pipeline_impl(calib_path, target, out_dir, cfg, tuple(steps),
                               merged_name, stl_name, log, dev, report, prefold, cache)
        if tracer is not None:
            g = tracer.registry.set_gauge
            g("sl3d_run_wall_seconds", report.elapsed_s)
            g("sl3d_views_computed", report.views_computed)
            g("sl3d_views_cached", report.views_cached)
            g("sl3d_merged_points", report.merged_points)
            g("sl3d_degraded", int(report.degraded))
            if report.overlap:
                g("sl3d_critical_path_seconds", report.overlap.get("critical_path_s") or 0.0)
            if report.assembly and report.assembly.get("tail_s") is not None:
                # the value the assembly.tail journal instant carries
                g("sl3d_assembly_tail_seconds", report.assembly["tail_s"])
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
                       stl_name, log, dev, report: PipelineReport, prefold=None,
                       cache: StageCache | None = None) -> None:
    t_start = time.perf_counter()
    walls = report.walls_s
    # a kill -9 in an earlier run leaves *.tmp orphans; none is data
    atomic.sweep_tmp(out_dir, log=log, recursive=True)
    if cache is None:
        cache = StageCache(os.path.join(out_dir, ".slscan-cache"),
                           enabled=cfg.pipeline.cache, log=log,
                           verify=cfg.pipeline.verify_cache)
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
    if cfg.merge.method == "posegraph":
        if cfg.merge.stream:
            log("[pipeline] NOTICE: merge.method='posegraph' has no streaming arm — "
                "merge.stream is ignored and the barrier pose-graph merge runs after "
                "reconstruction")
        report.merge_mode = "posegraph"
    else:
        report.merge_mode = "streamed" if cfg.merge.stream else "barrier"
    stream: _StreamRegistrar | None = None
    stats = prof.OverlapStats()
    t_stream0 = time.perf_counter()

    def arm_stream() -> _StreamRegistrar:
        nonlocal stream
        stream = _StreamRegistrar(cfg, cache, stats, dev, log, _merge_mesh_grid(cfg, log))
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
                                      stats, t_stream0, log, dev, report, prefold)
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
    _retry_stage("write", lambda: ply.write_ply(merged_path, points, colors,
                                                binary=not cfg.pipeline.ascii_output),
                 _retry_policy(cfg), final_write_retry)
    walls["write_merged_s"] = time.perf_counter() - t0
    log(f"[pipeline] merged cloud -> {merged_path} ({len(points):,} points)")
    report.merged_ply, report.merged_points = merged_path, len(points)

    # ---- stage 4: mesh -> STL ----------------------------------------------
    _budget_check("mesh")
    t0 = time.perf_counter()
    mesh_key = cache.key("mesh", digests=[StageCache.digest_arrays(points=points)],
                         config_json=config_subtree(cfg, ("mesh",)) + _engine_json(cfg, dev))
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
    if prefold is not None:
        if report.assembly is None:
            # a merge cache hit (or no streamed merge): nothing was seeded
            report.assembly = {"folded_views": prefold.offered_views, "used_views": 0,
                               "folded_pairs": len(prefold.T_pairs),
                               "fold_wall_s": round(sum(e[2] for e in prefold.events), 6)}
        if prefold.settled_unix:
            # the OverlapStats gauge and the assembly.tail instant, one call
            report.assembly["tail_s"] = round(time.time() - prefold.settled_unix, 6)
            stats.set_assembly_tail(report.assembly["tail_s"], report.assembly)
            if report.overlap is not None:
                report.overlap.update(stats.assembly_snapshot())
    report.cache = cache.stats()
    report.elapsed_s = time.perf_counter() - t_start
    log(f"[pipeline] {report.summary}")


def _reconstruct_missing(missing, calib, cfg, steps, view_keys, cache, collected, counts,
                         get_stream, stats, out_dir, log, dev, report) -> None:
    """Reconstruct + clean the views the view cache missed, on the lane
    ``reconstruct`` takes, with the clean chain in the lane's drain
    (``_Tail``): each cleaned view is collected, published to the cache and
    fed to the register lane (when one is armed) from the drain thread.
    Failures land in ``report``; a view whose wait timed out is quarantined
    and never merges, even if its drain finishes late."""
    index = {src: i for i, src in missing}
    sources = [src for _, src in missing]
    scanner = _build_scanner(sources, calib, cfg, dev)
    view_dir = os.path.join(out_dir, "views") if cfg.pipeline.write_view_plys else None
    if view_dir:
        os.makedirs(view_dir, exist_ok=True)
    clean_tm: dict[str, float] = {}
    lock = threading.Lock()
    accepting = True

    def collect(_j, src, pts, cols, c, dev=None):
        nonlocal accepting
        i = index[src]
        with lock:
            if not accepting:   # the lane gave up on this view: never merge it
                return
            collected[i], counts[i] = (pts, cols), c
        cache.put("view", view_keys[i], points=pts, colors=cols,
                  counts=np.asarray(json.dumps(c)))
        stream = get_stream()
        if stream is not None:
            stream.feed(i, pts, cols, dev=dev)
        log(f"[pipeline] {_item_name(src)}: {c['input']:,} -> {len(pts):,} points "
            f"after {', '.join(s for s in c if s != 'input') or 'no clean'}")

    batch = BatchReport(device=str(dev), run_id=report.run_id, lane=_lane(cfg, len(sources)))
    tail = _Tail("batch", view_dir, dev, clean_steps=tuple(steps), collect=collect,
                 write_plys=view_dir is not None, timings=clean_tm, calib=calib)
    t0 = time.perf_counter()
    try:
        _reconstruct_lane(sources, cfg, scanner, batch, log, stats, tail)
    finally:
        with lock:
            accepting = False
    tr = tel.current()
    if tr is not None:
        tr.span_end("reconstruct", time.perf_counter() - t0, views=len(sources))
    report.walls_s["reconstruct_s"] = time.perf_counter() - t0
    report.walls_s["clean_s"] = (batch.overlap or {}).get("clean_s", 0.0)
    report.walls_s.update(clean_tm)
    report.failed, report.failures, report.retries = batch.failed, batch.failures, batch.retries
    report.overlap = batch.overlap
    failed = {s for s, _ in batch.failed}
    for i, src in missing:   # a quarantined view never also merges
        if src in failed:
            collected.pop(i, None)
            counts.pop(i, None)


def _merge_stage(order, collected, cfg, cache, stream, arm_stream, stats, t_stream0, log,
                 dev, report, prefold=None):
    """The merge behind the merge cache: the streamed arm finishes the
    register lane and runs ``finalize_chain`` (seeded with the validated
    part of ``prefold``), the barrier arm runs ``merge_360``. Returns
    (points, colors); sets the report's merge fields and transforms."""
    digests = [StageCache.digest_arrays(points=collected[i][0], colors=collected[i][1])
               for i in order]
    # merge_mesh changes the final pass's arithmetic (slab-sharded), so it
    # keys the merge (not the pairs: a sharded pair gives the same bytes)
    merge_key = cache.key("merge", digests=digests,
                          config_json=_merge_numeric_json(cfg) + _engine_json(cfg, dev)
                          + json.dumps({"merge_mesh": cfg.parallel.merge_mesh}))
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
            pf = None
            if prefold is not None:
                # trust nothing the pod phase folded until it matches this
                # pass's order, digests and transforms
                pf = prefold.validate(order, dict(zip(order, digests)), T, log=log)
            if pf is not None:
                # the fold lane's events, replayed now that a journal is open
                for kind, idx, dur in pf.events:
                    stats.add_fold(kind, idx, dur)
                report.assembly = {"folded_views": prefold.offered_views,
                                   "used_views": len(pf.transforms),
                                   "folded_pairs": len(pf.T_pairs),
                                   "fold_wall_s": round(sum(e[2] for e in pf.events), 6)}
                log(f"[assembly] seeding finalize from {len(pf.transforms)} prefolded "
                    f"view(s); only the {len(order) - len(pf.transforms)}-view suffix "
                    f"accumulates here")
            report.overlap = stats.as_dict()
            points, colors, transforms = recon.finalize_chain(
                clouds, T, gf, fi, ir, cfg.merge, log=log, timings=tm, device=dev,
                prefold=pf, mesh=stream.mesh)
            if stream.failures:
                report.failures.extend(stream.failures)
                report.degraded = True
                cacheable = False   # a rerun must retry the real registration
                log(f"[pipeline] WARNING: {len(stream.failures)} pair registration(s) "
                    f"fell back to identity; the merged model is DEGRADED at those seams")
        else:
            # the barrier arms run the host-list computation (the posegraph
            # merge has only one arm): byte-identical to the streamed arm, as
            # the merge key (no merge.stream in it) promises
            fb16 = cfg.parallel.force_bf16_features
            mesh = _merge_mesh_grid(cfg, log)
            if report.merge_mode == "posegraph":
                points, colors, transforms = recon.merge_360_posegraph(
                    clouds, cfg.merge, log=log, timings=tm, device=dev, feat_bf16=fb16,
                    mesh=mesh)
            else:
                points, colors, transforms = recon._merge_host_list(
                    clouds, cfg.merge, log, tm, dev, feat_bf16=fb16, mesh=mesh)
    report.walls_s.update({f"merge_{k}": v for k, v in tm.items()
                           if isinstance(v, float)})
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.uint8)
    if cacheable:
        cache.put("merge", merge_key, points=points, colors=colors,
                  transforms=np.stack([np.asarray(t, np.float32) for t in transforms]))
    report.transforms = list(transforms)
    report.merge_status = "computed"
    return points, colors
