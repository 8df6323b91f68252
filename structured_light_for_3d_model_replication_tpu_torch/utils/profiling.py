"""Stage timing, the framework logger, lane overlap accounting and the
device profiler hook.

  - ``StageTimer``: nested, context-managed stage timing with a report
    (the serial reconstruct lane times each view under one).
  - ``get_logger``: the ``sl3d`` stdlib logger, its level from ``SL3D_LOG``
    (DEBUG / INFO / WARNING, default INFO); ``attach_callback`` forwards it
    to a reference-style ``log_callback(str)`` sink, ``attached_callback``
    is the scoped form that always detaches.
  - ``OverlapStats``: per-lane wall accounting of the reconstruct lanes
    (load, transfer, compute, clean, write) and the streaming register
    lane, the prefetch window's depth, device<->host bytes and kernel-lane
    launches, the pod fabric's blob bytes and the incremental assembly's
    folds, under the JAX package's ``as_dict`` keys; its ``add`` is also
    the heartbeat the stall watchdog listens for, and the one a
    coordinated worker renews its leases from (``set_heartbeat_hook``).
  - ``trace``: context manager around ``torch.profiler`` so any stage can
    emit a device trace (set ``SL3D_TRACE_DIR`` or pass a path; the trace is
    a Chrome-trace JSON that Perfetto loads).
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field

from structured_light_for_3d_model_replication_tpu_torch.utils import (
    deadline as _deadline,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import telemetry

__all__ = ["StageTimer", "OverlapStats", "trace", "get_logger", "attach_callback",
           "attached_callback", "detach_callback", "set_heartbeat_hook"]

# ambient progress-heartbeat hook: a coordinated-run worker installs its
# lease renewal here, so every ``OverlapStats.add`` (the call that adds a
# lane wall and beats the stall watchdog) also renews the worker's leases:
# liveness as the coordinator sees it and compute progress come from one
# call site. The hook never raises; unset, it costs one None check.
_HEARTBEAT = None


def set_heartbeat_hook(hook):
    """Install (or clear, with None) the heartbeat hook; returns the
    previous one."""
    global _HEARTBEAT
    prev = _HEARTBEAT
    _HEARTBEAT = hook
    return prev


_LOGGER_NAME = "sl3d"


def get_logger(name: str = _LOGGER_NAME) -> logging.Logger:
    """Framework logger; level from SL3D_LOG (DEBUG/INFO/WARNING, default INFO)."""
    logger = logging.getLogger(name)
    if not getattr(logger, "_sl3d_configured", False):
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("SL3D_LOG", "INFO").upper())
        logger.propagate = False
        logger._sl3d_configured = True
    return logger


class _CallbackHandler(logging.Handler):
    def __init__(self, callback):
        super().__init__()
        self._cb = callback

    def emit(self, record):
        self._cb(self.format(record))


def attach_callback(callback, level=logging.INFO) -> logging.Handler:
    """Forward the framework log to a ``log_callback(str)`` sink (the
    reference's Tk text-widget pattern). Returns the handler for
    ``detach_callback``; ``attached_callback`` is the form that cannot leak.
    Re-attaching an equal callback (``==``: a bound method is a new object on
    every access) replaces its handler rather than adding a second one."""
    logger = get_logger()
    for h in list(logger.handlers):
        if isinstance(h, _CallbackHandler) and h._cb == callback:
            logger.removeHandler(h)
            h.close()
    h = _CallbackHandler(callback)
    h.setLevel(level)
    h.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(h)
    return h


def detach_callback(handler: logging.Handler) -> None:
    """Remove a handler returned by :func:`attach_callback`."""
    get_logger().removeHandler(handler)
    handler.close()


@contextlib.contextmanager
def attached_callback(callback, level=logging.INFO):
    """Scoped :func:`attach_callback`: the handler is detached however the
    block leaves."""
    h = attach_callback(callback, level)
    try:
        yield h
    finally:
        detach_callback(h)


@dataclass
class _Record:
    name: str
    elapsed_s: float
    depth: int


@dataclass
class StageTimer:
    """Nested stage timing::

        timer = StageTimer()
        with timer.stage("decode"):
            ...
        with timer.stage("merge"):
            with timer.stage("merge/icp"):
                ...
        print(timer.report())

    A record is appended when its stage ends (innermost first), with its
    nesting depth (1 at the top level)."""

    records: list[_Record] = field(default_factory=list)
    _depth: int = 0

    @contextlib.contextmanager
    def stage(self, name: str, log=None):
        t0 = time.perf_counter()
        self._depth += 1
        try:
            yield self
        finally:
            self._depth -= 1
            dt = time.perf_counter() - t0
            self.records.append(_Record(name, dt, self._depth))
            if log is not None:
                log(f"[timing] {name}: {dt:.3f}s")

    def total(self, name: str) -> float:
        return sum(r.elapsed_s for r in self.records if r.name == name)

    def as_dict(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0.0) + r.elapsed_s
        return out

    def report(self) -> str:
        """One line a record, in completion order, indented by depth."""
        return "\n".join(f"{'  ' * r.depth}{r.name:<32} {r.elapsed_s:9.3f}s"
                         for r in self.records)


class OverlapStats:
    """Overlap accounting for the reconstruct lanes (load / compute / clean /
    write) and the streaming merge's register lane.

    Worker threads accumulate per-stage wall time with ``add``; the owner
    stamps the end-to-end wall with ``finish``. The overlap is then
    *measurable*, not asserted: ``critical_path_s`` strictly below the
    lanes' sum (``serial_sum_s``) means they ran concurrently, and
    ``register_s`` beside ``critical_path_s`` reads as how much pair
    registration the stream hid. Memory is O(1) in run length: the launch
    gauges are exact running aggregates, never retained sample lists.

    Flight recorder: when a :mod:`~.utils.telemetry` tracer is active,
    ``add``/``add_pair_launch`` emit the per-lane span events and the
    retry/failure/launch accessors emit instants — journal-derived lane
    walls and these sums come from the SAME calls, so the two layers
    cannot drift. Disabled cost is one module-global None check.
    """

    _STAGES = ("load", "transfer", "compute", "clean", "write", "register")

    def __init__(self):
        self._lock = threading.Lock()
        self._stage_s = {s: 0.0 for s in self._STAGES}
        self._retries = {s: 0 for s in self._STAGES}
        self._failures = {s: 0 for s in self._STAGES}
        self._items = 0
        # queue-depth gauge: exact running aggregates, not a sample list
        self._q_n = 0
        self._q_sum = 0
        self._q_max = 0
        # batch-launch accounting (the view-batched executor): how many
        # device launches carried how many real views, and the first
        # dispatch wall per bucket size (the compile-cost proxy — later
        # launches of the same bucket reuse the executable)
        self._launches = 0
        self._views_dispatched = 0
        self._bv_min: int | None = None
        self._bv_max: int | None = None
        self._bucket_first_s: dict[int, float] = {}
        # register-lane launch accounting (the streaming merge): how many
        # pair-registration launches carried how many real pairs
        self._pair_launches = 0
        self._pairs_dispatched = 0
        # device<->host transfer bytes (exact running sums): ``frames`` is
        # the frame-stack upload every arm pays, so the cloud path's traffic
        # is h2d - frames + d2h
        self._h2d_bytes = 0
        self._d2h_bytes = 0
        self._frame_bytes = 0
        # what the frame uploads would have cost unpacked (raw u8 stacks)
        self._frame_raw_bytes = 0
        # per-kernel-lane launch accounting: name -> [launches, wall_s, bytes]
        self._kernels: dict[str, list] = {}
        # pod-fabric blob bytes (a worker's L2 fetches, pushes and dedups)
        self._fabric_fetched = 0
        self._fabric_pushed = 0
        self._fabric_deduped = 0
        # the incremental assembly: folds replayed by the assembly pass and
        # the tail from the last item settled to the artifacts on disk
        self._asm_fold_s = 0.0
        self._asm_views = 0
        self._asm_pairs = 0
        self._asm_tail_s: float | None = None
        self.critical_path_s = 0.0

    def add(self, stage: str, elapsed_s: float, items: int = 0,
            view=None) -> None:
        """Accumulate ``elapsed_s`` of wall time into ``stage`` (thread-safe).
        ``view`` (a name or index) only annotates the trace span — it never
        changes the aggregate accounting."""
        if stage not in self._stage_s:
            raise ValueError(f"unknown pipeline stage {stage!r}; "
                             f"valid: {self._STAGES}")
        with self._lock:
            self._stage_s[stage] += elapsed_s
            self._items += items
        # lane heartbeat for the stall watchdog — emitted from the SAME
        # call that accumulates the lane wall (the telemetry can't-drift
        # pattern), so liveness and accounting cannot disagree. One None
        # check when no watchdog is armed.
        _deadline.beat(stage)
        hb = _HEARTBEAT
        if hb is not None:   # a coordinated worker's lease renewal
            hb(stage)
        tr = telemetry.current()
        if tr is not None:
            tr.lane(stage, elapsed_s, view=view)

    def add_retry(self, stage: str) -> None:
        """Count one transient-fault retry in a lane (the resilience layer's
        per-lane gauge: a climbing load retry count with a flat failure
        count means backoff is absorbing the blips it is meant to)."""
        if stage not in self._retries:
            raise ValueError(f"unknown pipeline stage {stage!r}")
        with self._lock:
            self._retries[stage] += 1
        tr = telemetry.current()
        if tr is not None:
            tr.instant("lane.retry", lane=stage)

    def add_failure(self, stage: str) -> None:
        """Count one exhausted/permanent per-item failure in a lane."""
        if stage not in self._failures:
            raise ValueError(f"unknown pipeline stage {stage!r}")
        with self._lock:
            self._failures[stage] += 1
        tr = telemetry.current()
        if tr is not None:
            tr.instant("lane.failure", lane=stage)

    def add_launch(self, n_views: int, bucket: int,
                   dispatch_s: float) -> None:
        """Record one batched device launch carrying ``n_views`` real views
        padded to ``bucket`` slots; ``dispatch_s`` is the (async) dispatch
        wall — dominated by trace+compile the first time a bucket is seen,
        near-zero after (the no-retrace gauge)."""
        n = int(n_views)
        with self._lock:
            self._launches += 1
            self._views_dispatched += n
            self._bv_min = n if self._bv_min is None else min(self._bv_min, n)
            self._bv_max = n if self._bv_max is None else max(self._bv_max, n)
            if bucket not in self._bucket_first_s:
                self._bucket_first_s[int(bucket)] = round(dispatch_s, 4)
        tr = telemetry.current()
        if tr is not None:
            tr.instant("launch", views=n, bucket=int(bucket),
                       dispatch_s=round(dispatch_s, 6))

    def add_pair_launch(self, n_pairs: int, dispatch_s: float) -> None:
        """Record one register-lane launch carrying ``n_pairs`` real pairs
        (group padding excluded); ``dispatch_s`` accumulates into the
        ``register`` lane as well, so register_s vs critical_path_s reads
        directly as how much pair registration the stream hid."""
        n = int(n_pairs)
        with self._lock:
            self._pair_launches += 1
            self._pairs_dispatched += n
            self._stage_s["register"] += dispatch_s
        _deadline.beat("register")
        hb = _HEARTBEAT
        if hb is not None:
            hb("register")
        tr = telemetry.current()
        if tr is not None:
            # the register wall includes launch dispatch — mirror it as a
            # lane span so journal-derived walls stay equal to register_s
            tr.lane("register", dispatch_s, pairs=n)
            tr.instant("pair_launch", pairs=n,
                       dispatch_s=round(dispatch_s, 6))

    def add_transfer(self, h2d: int = 0, d2h: int = 0, frames: int = 0,
                     frames_raw: int = 0) -> None:
        """Accumulate device<->host bytes. ``frames`` counts the frame-stack
        upload (it also adds into ``h2d``); ``frames_raw`` is the unpacked
        size of the same stacks (defaults to ``frames``: the raw lane), so
        the packed lane's wire bytes read beside what a raw upload costs."""
        h, d, fr = int(h2d), int(d2h), int(frames)
        fr_raw = int(frames_raw) or fr
        with self._lock:
            self._h2d_bytes += h + fr
            self._d2h_bytes += d
            self._frame_bytes += fr
            self._frame_raw_bytes += fr_raw
        tr = telemetry.current()
        if tr is not None:
            tr.instant("transfer.bytes", h2d=h + fr or None, d2h=d or None,
                       frames=fr or None, frames_raw=fr_raw if fr_raw != fr else None)
            if fr and fr_raw > fr:
                tr.instant("transfer.packed_ratio", ratio=round(fr_raw / fr, 3),
                           wire=fr, raw=fr_raw)

    def add_kernel(self, name: str, wall_s: float, bucket=None,
                   bytes_moved: int = 0) -> None:
        """Record one kernel-lane launch (``fused_view``): wall, optional
        bucket, and the bytes it moved across the host boundary."""
        w = float(wall_s)
        with self._lock:
            agg = self._kernels.setdefault(name, [0, 0.0, 0])
            agg[0] += 1
            agg[1] += w
            agg[2] += int(bytes_moved)
        tr = telemetry.current()
        if tr is not None:
            tr.instant(f"kernel.{name}", wall_s=round(w, 6),
                       bucket=int(bucket) if bucket is not None else None,
                       bytes=int(bytes_moved) or None)

    def add_fabric(self, fetched: int = 0, pushed: int = 0, deduped: int = 0) -> None:
        """Pod-fabric blob bytes: ``fetched`` (an L2 hit promoted into L1),
        ``pushed`` (a write-through publish L2 took), ``deduped`` (a push L2
        already held). The ``fabric.bytes`` journal instant comes from this
        same call, so ``report``'s fabric totals match these counters."""
        f, p, d = int(fetched), int(pushed), int(deduped)
        with self._lock:
            self._fabric_fetched += f
            self._fabric_pushed += p
            self._fabric_deduped += d
        tr = telemetry.current()
        if tr is not None:
            tr.instant("fabric.bytes", fetched=f or None, pushed=p or None,
                       deduped=d or None)

    def add_fold(self, kind: str, idx: int, dur_s: float) -> None:
        """One incremental-assembly fold (``kind`` 'view' or 'pair'). The
        pod phase runs before ``run_pipeline`` opens its journal, so the
        fold lane buffers its events and the assembly pass replays them
        here: the ``assembly`` lane span and these sums from one call."""
        d = float(dur_s)
        with self._lock:
            self._asm_fold_s += d
            if kind == "view":
                self._asm_views += 1
            else:
                self._asm_pairs += 1
        tr = telemetry.current()
        if tr is not None:
            tr.lane("assembly", d, **{str(kind): int(idx)})

    def set_assembly_tail(self, tail_s: float, info: dict | None = None) -> None:
        """Stamp the assembly tail (last item settled -> artifacts on disk)
        and journal the ``assembly.tail`` instant from the same call."""
        t = float(tail_s)
        with self._lock:
            self._asm_tail_s = t
        tr = telemetry.current()
        if tr is not None:
            tr.instant("assembly.tail", **{"tail_s": round(t, 6), **(info or {})})

    def assembly_snapshot(self) -> dict:
        """The assembly lane's gauges alone (the tail is known only after
        the main ``as_dict`` snapshot)."""
        with self._lock:
            out = {"assembly_s": round(self._asm_fold_s, 4),
                   "assembly_folded_views": self._asm_views,
                   "assembly_folded_pairs": self._asm_pairs}
            if self._asm_tail_s is not None:
                out["assembly_tail_s"] = round(self._asm_tail_s, 4)
            return out

    def sample_queue(self, depth: int) -> None:
        """One sample of the prefetch window's depth."""
        d = int(depth)
        with self._lock:
            self._q_n += 1
            self._q_sum += d
            if d > self._q_max:
                self._q_max = d

    def finish(self, critical_path_s: float) -> None:
        self.critical_path_s = critical_path_s
        tr = telemetry.current()
        if tr is not None:
            tr.instant("executor.finish",
                       critical_path_s=round(critical_path_s, 6))

    @property
    def serial_sum_s(self) -> float:
        return sum(self._stage_s.values())

    def as_dict(self) -> dict:
        """The bench/report payload: per-stage walls, critical path, gauges."""
        out = {f"{s}_s": round(v, 4) for s, v in self._stage_s.items()}
        out["critical_path_s"] = round(self.critical_path_s, 4)
        out["serial_sum_s"] = round(self.serial_sum_s, 4)
        out["overlap_ratio"] = (round(self.serial_sum_s / self.critical_path_s, 3)
                                if self.critical_path_s > 0 else None)
        out["items"] = self._items
        out["max_queue_depth"] = self._q_max
        out["mean_queue_depth"] = (round(self._q_sum / self._q_n, 2)
                                   if self._q_n else 0.0)
        out["retries"] = dict(self._retries)
        out["failures"] = dict(self._failures)
        out["retry_total"] = sum(self._retries.values())
        out["failure_total"] = sum(self._failures.values())
        # batched-launch gauges (zeros/None on the per-view executors);
        # the per-item normalizations make batched and per-view lines
        # directly comparable
        out["launches"] = self._launches
        out["views_dispatched"] = self._views_dispatched
        out["mean_views_per_launch"] = (
            round(self._views_dispatched / self._launches, 2)
            if self._launches else 0.0)
        out["min_views_per_launch"] = self._bv_min or 0
        out["max_views_per_launch"] = self._bv_max or 0
        out["bucket_first_dispatch_s"] = {
            str(k): v for k, v in sorted(self._bucket_first_s.items())}
        # register-lane gauges (zeros on runs without a streaming merge)
        out["pair_launches"] = self._pair_launches
        out["pairs_dispatched"] = self._pairs_dispatched
        out["mean_pairs_per_launch"] = (
            round(self._pairs_dispatched / self._pair_launches, 2)
            if self._pair_launches else 0.0)
        out["transfer_bytes_h2d"] = self._h2d_bytes
        out["transfer_bytes_d2h"] = self._d2h_bytes
        out["transfer_bytes_frames"] = self._frame_bytes
        out["transfer_bytes_frames_raw"] = self._frame_raw_bytes
        out["frame_bytes_ratio"] = (round(self._frame_raw_bytes / self._frame_bytes, 2)
                                    if self._frame_bytes else None)
        out["fabric_bytes_fetched"] = self._fabric_fetched
        out["fabric_bytes_pushed"] = self._fabric_pushed
        out["fabric_bytes_deduped"] = self._fabric_deduped
        out["kernels"] = {
            name: {"launches": agg[0], "wall_s": round(agg[1], 4), "bytes_moved": agg[2]}
            for name, agg in sorted(self._kernels.items())}
        out.update(self.assembly_snapshot())
        items = self._items
        out["compute_per_item_s"] = (round(self._stage_s["compute"] / items, 4)
                                     if items else None)
        out["transfer_per_item_s"] = (round(self._stage_s["transfer"] / items, 4)
                                      if items else None)
        return out

    def summary(self) -> str:
        """One line of the lanes against the critical path (the DEBUG log)."""
        d = self.as_dict()
        clean = f" + clean {d['clean_s']}s" if d["clean_s"] else ""
        xfer = f" + transfer {d['transfer_s']}s" if d["transfer_s"] else ""
        resil = ""
        if d["retry_total"] or d["failure_total"]:
            resil = f", {d['retry_total']} retries / {d['failure_total']} failures"
        batched = ""
        if d["launches"]:
            batched = (f", {d['views_dispatched']} views in {d['launches']} launches "
                       f"(mean {d['mean_views_per_launch']}/launch)")
        if d["pair_launches"]:
            batched += (f", {d['pairs_dispatched']} pairs in {d['pair_launches']} "
                        f"register launches (register {d['register_s']}s)")
        return (f"load {d['load_s']}s{xfer} + compute {d['compute_s']}s{clean} + write "
                f"{d['write_s']}s = {d['serial_sum_s']}s serial-equivalent in "
                f"{d['critical_path_s']}s wall (overlap x{d['overlap_ratio']}, queue depth "
                f"max {d['max_queue_depth']} mean {d['mean_queue_depth']}{batched}{resil})")


# torch.profiler runs one profile per process at a time, and the lanes
# carry trace() calls that nest (a lane inside run_pipeline's stages): the
# OUTER call owns the profile, inner entries no-op.
_TRACE_LOCK = threading.Lock()
_TRACE_DEPTH = 0


@contextlib.contextmanager
def trace(trace_dir: str | None = None):
    """Device and host profile around a block, written as a Chrome-trace
    JSON (``trace-<pid>-<ns>.json``) into ``trace_dir``.

    No-ops unless a directory is given or ``SL3D_TRACE_DIR`` is set — safe to
    leave in production paths. Reentrant: entering while a profile is
    already active (any thread) no-ops the inner call, so nested stage
    instrumentation composes; everything inside lands in the outer capture.
    """
    global _TRACE_DEPTH
    trace_dir = trace_dir or os.environ.get("SL3D_TRACE_DIR")
    if not trace_dir:
        yield
        return
    with _TRACE_LOCK:
        owner = _TRACE_DEPTH == 0
        _TRACE_DEPTH += 1
    try:
        if not owner:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
    finally:
        with _TRACE_LOCK:
            _TRACE_DEPTH -= 1
