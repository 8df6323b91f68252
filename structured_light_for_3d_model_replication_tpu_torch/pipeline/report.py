"""``report``: render a traced run's flight-recorder artifacts.

The port's copy of the JAX package's ``pipeline/report.py``, the same
rules and the same text: it reads the journal (``trace.jsonl``), the
metrics snapshot (``metrics.json``), the failure manifest
(``failures.json``) and the stall dump (``stalls.json``) of a ``pipeline``
out dir written with ``observability.trace`` and renders

  - the lane timeline: each lane's busy intervals over the run wall (the
    executor's load / transfer / compute / clean / write lanes, the
    register lane), from the lane spans ``OverlapStats.add`` journals;
  - stage walls, lane walls and span counts, cache hit ratios, the
    launch / bucket table and the transfer bytes;
  - the fault ledger (retries, failures, injected faults, quarantined
    views) and the stall ledger (watchdog breaches, last heartbeats).

A journal with no ``end`` marker reports as INTERRUPTED; torn trailing
lines are tolerated. ``validate_journal`` schema-checks a journal.
``host_journals`` / ``merge_host_timeline`` fold the per-host journals of
a coordinated run (the port runs on one host, so one journal).
``utils/telemetry.export_chrome_trace`` writes the Perfetto trace and
``prometheus_text`` re-emits ``metrics.json``.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field

from structured_light_for_3d_model_replication_tpu_torch.utils import telemetry

__all__ = ["RunAnalysis", "analyze_run", "render_report", "validate_journal",
           "host_journals", "merge_host_timeline", "render_host_timeline",
           "worker_tag"]

_LANES = telemetry.LANE_ORDER


# ---------------------------------------------------------------------------
# journal validation
# ---------------------------------------------------------------------------

_REQUIRED = {
    "meta": ("schema", "run_id", "t0_unix"),
    "span": ("ev", "t", "dur"),
    "instant": ("ev", "t"),
    "end": ("t",),
}


def validate_journal(path: str) -> list[str]:
    """Schema-check a journal; returns a list of human-readable problems
    (empty == valid). A missing ``end`` marker is NOT an error — that is
    what an interrupted run looks like — but a missing/late meta line, an
    unknown event type, or a span without a duration is."""
    errors: list[str] = []
    j = telemetry.read_journal(path)
    for s, seg in enumerate(j["segments"]):
        meta = seg["meta"]
        if meta is None:
            errors.append(f"segment {s}: no meta header line")
        else:
            for k in _REQUIRED["meta"]:
                if k not in meta:
                    errors.append(f"segment {s}: meta line missing {k!r}")
            if meta.get("schema") not in (telemetry.SCHEMA,):
                errors.append(f"segment {s}: unknown schema "
                              f"{meta.get('schema')!r} "
                              f"(expected {telemetry.SCHEMA})")
        for i, ev in enumerate(seg["events"]):
            kind = ev.get("type")
            if kind not in _REQUIRED:
                errors.append(f"segment {s} event {i}: unknown type {kind!r}")
                continue
            for k in _REQUIRED[kind]:
                if k not in ev:
                    errors.append(f"segment {s} event {i} "
                                  f"({kind}/{ev.get('ev')}): missing {k!r}")
            if kind == "span" and ev.get("ev") == "lane" and "lane" not in ev:
                errors.append(f"segment {s} event {i}: lane span without "
                              f"a lane")
            t = ev.get("t")
            if isinstance(t, (int, float)) and t < -1e-6:
                errors.append(f"segment {s} event {i}: negative "
                              f"timestamp {t}")
    return errors


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

@dataclass
class RunAnalysis:
    out_dir: str
    run_id: str | None = None
    meta: dict = field(default_factory=dict)
    wall_s: float = 0.0
    ended: bool = False            # end marker present (clean close)
    runs_in_journal: int = 1       # appended segments (reruns keep history)
    truncated_lines: int = 0
    events: int = 0
    lane_walls: dict[str, float] = field(default_factory=dict)
    lane_spans: dict[str, int] = field(default_factory=dict)
    lane_intervals: dict[str, list[tuple[float, float]]] = \
        field(default_factory=dict)
    stage_walls: dict[str, float] = field(default_factory=dict)
    cache: dict[str, dict[str, int]] = field(default_factory=dict)
    launches: list[dict] = field(default_factory=list)
    pair_launches: list[dict] = field(default_factory=list)
    retries: dict[str, int] = field(default_factory=dict)
    failures: dict[str, int] = field(default_factory=dict)
    injected: dict[str, int] = field(default_factory=dict)
    quarantined: list[dict] = field(default_factory=list)
    critical_path_s: float | None = None
    # kernel table: per-kernel launch/wall/bytes totals with a per-bucket
    # breakdown (from the `kernel.*` instants the launch accounting and
    # the kernel wrappers emit) + the h2d/d2h transfer-byte counters
    kernels: dict[str, dict] = field(default_factory=dict)
    transfer: dict[str, int] = field(default_factory=dict)
    # pod-fabric blob traffic (from `fabric.bytes` instants): bytes this
    # host fetched from / pushed to / deduped against the L2 blobstore —
    # the artifact-side twin of the OverlapStats fabric counters
    fabric: dict[str, int] = field(default_factory=dict)
    manifest: dict | None = None   # failures.json payload
    metrics: dict | None = None    # metrics.json payload
    # incremental-assembly close-out: the `assembly.tail` instant the
    # assembly pass emits when a prefold was in play (tail_s + fold
    # counters) — the journal-side twin of the
    # `sl3d_assembly_tail_seconds` metrics gauge
    assembly: dict | None = None
    # stall ledger: watchdog breaches seen in the journal, the last
    # heartbeat time per lane (span ends + lane.heartbeat instants), and
    # the stalls.json payload the watchdog persists on a breach
    stall_events: list[dict] = field(default_factory=list)
    lane_last_beat: dict[str, float] = field(default_factory=dict)
    stalls: dict | None = None


def _merge_intervals(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def analyze_run(out_dir: str, trace_file: str = "trace.jsonl",
                metrics_file: str = "metrics.json") -> RunAnalysis:
    """Build a :class:`RunAnalysis` from whatever artifacts the out dir
    holds. Requires the journal; metrics.json and failures.json are
    optional (interrupted runs have no metrics, clean runs no manifest)."""
    path = os.path.join(out_dir, trace_file)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no {trace_file} under {out_dir!r} — run the pipeline with "
            f"observability.trace=true (--trace / SL3D_TRACE=1) to record "
            f"one")
    j = telemetry.read_journal(path)
    # meta/events are the journal's LATEST segment: reruns append a fresh
    # run header, so analysis is always run-scoped while history survives
    a = RunAnalysis(out_dir=out_dir, meta=j["meta"] or {},
                    runs_in_journal=j["runs"],
                    truncated_lines=j["truncated"],
                    events=len(j["events"]))
    a.run_id = a.meta.get("run_id")
    t_max = 0.0
    for ev in j["events"]:
        t = float(ev.get("t", 0.0))
        dur = float(ev.get("dur", 0.0) or 0.0)
        t_max = max(t_max, t + max(dur, 0.0))
        kind = ev.get("type")
        name = ev.get("ev")
        if kind == "end":
            a.ended = True
        elif kind == "span" and name == "lane":
            lane = ev.get("lane", "?")
            a.lane_walls[lane] = a.lane_walls.get(lane, 0.0) + dur
            a.lane_spans[lane] = a.lane_spans.get(lane, 0) + 1
            a.lane_intervals.setdefault(lane, []).append((t, t + dur))
            a.lane_last_beat[lane] = max(a.lane_last_beat.get(lane, 0.0),
                                         t + dur)
        elif kind == "span" and name == "stage":
            st = ev.get("stage", "?")
            a.stage_walls[st] = a.stage_walls.get(st, 0.0) + dur
        elif kind == "instant":
            if name and name.startswith("cache."):
                st = ev.get("stage", "?")
                a.cache.setdefault(st, {})
                k = name[6:]
                a.cache[st][k] = a.cache[st].get(k, 0) + 1
            elif name == "launch":
                a.launches.append(ev)
            elif name == "pair_launch":
                a.pair_launches.append(ev)
            elif name == "lane.retry":
                ln = ev.get("lane", "?")
                a.retries[ln] = a.retries.get(ln, 0) + 1
            elif name == "lane.failure":
                ln = ev.get("lane", "?")
                a.failures[ln] = a.failures.get(ln, 0) + 1
            elif name == "fault.injected":
                site = f"{ev.get('site', '?')}:{ev.get('kind', '?')}"
                a.injected[site] = a.injected.get(site, 0) + 1
            elif name == "quarantine":
                a.quarantined.append(ev)
            elif name == "watchdog.stall":
                a.stall_events.append(ev)
            elif name == "lane.heartbeat":
                ln = ev.get("lane", "?")
                a.lane_last_beat[ln] = max(a.lane_last_beat.get(ln, 0.0), t)
            elif name == "executor.finish":
                a.critical_path_s = ev.get("critical_path_s")
            elif name == "assembly.tail":
                a.assembly = ev
            elif name == "transfer.bytes":
                for k in ("h2d", "d2h", "frames", "frames_raw"):
                    v = ev.get(k)
                    if v:
                        a.transfer[k] = a.transfer.get(k, 0) + int(v)
            elif name == "fabric.bytes":
                for k in ("fetched", "pushed", "deduped"):
                    v = ev.get(k)
                    if v:
                        a.fabric[k] = a.fabric.get(k, 0) + int(v)
            elif name and name.startswith("kernel."):
                kn = name[7:]
                rec = a.kernels.setdefault(
                    kn, {"launches": 0, "wall_s": 0.0, "bytes": 0,
                         "compiled": 0, "buckets": {}})
                rec["launches"] += 1
                rec["wall_s"] += float(ev.get("wall_s", 0.0) or 0.0)
                rec["bytes"] += int(ev.get("bytes", 0) or 0)
                if ev.get("compiled"):
                    rec["compiled"] += 1
                b = ev.get("bucket")
                if b is not None:
                    bk = rec["buckets"].setdefault(
                        int(b), {"launches": 0, "wall_s": 0.0, "bytes": 0})
                    bk["launches"] += 1
                    bk["wall_s"] += float(ev.get("wall_s", 0.0) or 0.0)
                    bk["bytes"] += int(ev.get("bytes", 0) or 0)
    a.wall_s = t_max
    for lane in a.lane_intervals:
        a.lane_intervals[lane] = _merge_intervals(a.lane_intervals[lane])
    mpath = os.path.join(out_dir, metrics_file)
    if os.path.exists(mpath):
        try:
            with open(mpath, encoding="utf-8") as f:
                a.metrics = json.load(f)
        except (OSError, ValueError):
            a.metrics = None
    fpath = os.path.join(out_dir, "failures.json")
    if os.path.exists(fpath):
        try:
            with open(fpath, encoding="utf-8") as f:
                a.manifest = json.load(f)
        except (OSError, ValueError):
            a.manifest = None
    spath = os.path.join(out_dir, "stalls.json")
    if os.path.exists(spath):
        try:
            with open(spath, encoding="utf-8") as f:
                a.stalls = json.load(f)
        except (OSError, ValueError):
            a.stalls = None
    return a


# ---------------------------------------------------------------------------
# multi-host journal merge (coordinated runs: N workers share one out dir)
# ---------------------------------------------------------------------------

def worker_tag(worker: str, generation: int = 0) -> str:
    """Display identity of one worker incarnation: ``fw0`` for the first
    spawn, ``fw0#g2`` for its second respawn (the JAX package's
    ``parallel/netutil.worker_tag``)."""
    g = int(generation)
    return f"{worker}#g{g}" if g > 0 else str(worker)


def host_journals(out_dir: str, trace_file: str = "trace.jsonl") -> list[str]:
    """Every journal in an out dir: the coordinator/single-process
    ``trace_file`` plus the host-scoped ``trace.<rank>-<pid>.jsonl``
    siblings coordinated workers write (``telemetry.host_scoped`` naming).
    The unscoped journal sorts first."""
    stem, dot, ext = trace_file.rpartition(".")
    pat = f"{stem}.*.{ext}" if dot else f"{trace_file}.*"
    main = os.path.join(out_dir, trace_file)
    sibs = sorted(glob.glob(os.path.join(out_dir, pat)))
    out = [main] if os.path.exists(main) else []
    out += [p for p in sibs if p != main]
    return out


def merge_host_timeline(out_dir: str,
                        trace_file: str = "trace.jsonl") -> list[dict]:
    """Fold every per-host journal into ONE time-ordered event list, each
    row stamped with its ``host`` column. Per-host relative timestamps are
    rebased onto each journal's ``t0_unix`` wall anchor, so events from
    different processes interleave in true order (subject to host clock
    skew — irrelevant on one machine, labeled per-host anyway)."""
    rows: list[dict] = []
    for path in host_journals(out_dir, trace_file):
        j = telemetry.read_journal(path)
        meta = j["meta"] or {}
        host = (meta.get("host") or meta.get("tool")
                or os.path.basename(path))
        # fleet respawns reuse the rank but bump the generation stamp:
        # `fw0#g2` is the same lane healed twice, not three workers —
        # the healed-vs-flapping distinction at a glance
        if meta.get("generation"):
            host = worker_tag(host, int(meta["generation"]))
        # networked workers advertise the address they dialed from; show
        # it in the host column so a pod run reads `w0 10.0.0.2:41234`
        if meta.get("addr"):
            host = f"{host} {meta['addr']}"
        t0 = float(meta.get("t0_unix", 0.0) or 0.0)
        for ev in j["events"]:
            row = dict(ev)
            row["host"] = host
            row["t_unix"] = t0 + float(ev.get("t", 0.0) or 0.0)
            rows.append(row)
    rows.sort(key=lambda r: r["t_unix"])
    return rows


def render_host_timeline(rows: list[dict], limit: int = 60) -> str:
    """The merged cross-host timeline as a host-column table (the last
    ``limit`` events; earlier ones summarize to a count). Pure function —
    the CLI prints it under the per-journal report when worker journals
    are present."""
    L: list[str] = []
    hosts = sorted({r["host"] for r in rows})
    L.append(f"multi-host timeline — {len(rows)} event(s) across "
             f"{len(hosts)} journal(s): {', '.join(hosts)}")
    if not rows:
        return "\n".join(L)
    t_base = rows[0]["t_unix"]
    shown = rows[-limit:] if len(rows) > limit else rows
    if len(rows) > limit:
        L.append(f"  ... {len(rows) - limit} earlier event(s) elided ...")
    wh = max(len(h) for h in hosts)
    for r in shown:
        what = r.get("ev") or r.get("type", "?")
        detail = " ".join(
            f"{k}={r[k]}" for k in ("lane", "stage", "item", "view",
                                    "status", "site", "kind", "error")
            if k in r)
        L.append(f"  +{r['t_unix'] - t_base:8.3f}s  {r['host']:<{wh}}  "
                 f"{what}" + (f"  {detail}" if detail else ""))
    # pod-wide fabric total: the workers' journals carry the
    # `fabric.bytes` instants (the coordinator's own journal has none),
    # so the cross-host fold is where the blobstore traffic is summable —
    # it must reconcile with the coordinator's blob-server counters
    fabric = {k: sum(int(r.get(k) or 0) for r in rows
                     if (r.get("ev") or r.get("type")) == "fabric.bytes")
              for k in ("fetched", "pushed", "deduped")}
    if any(fabric.values()):
        L.append(f"  pod fabric total: {fabric['fetched']} B fetched / "
                 f"{fabric['pushed']} B pushed / {fabric['deduped']} B "
                 f"deduped over the blobstore wire")
    return "\n".join(L)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _bar(intervals: list[tuple[float, float]], wall: float,
         width: int) -> str:
    cells = [" "] * width
    if wall <= 0:
        return "".join(cells)
    for t0, t1 in intervals:
        i0 = max(0, min(width - 1, int(t0 / wall * width)))
        i1 = max(i0, min(width - 1, int(t1 / wall * width)))
        for i in range(i0, i1 + 1):
            cells[i] = "#"
    return "".join(cells)


def _lane_sort_key(lane: str):
    return (_LANES.index(lane) if lane in _LANES else len(_LANES), lane)


def render_report(a: RunAnalysis, width: int = 60) -> str:
    """The terminal report. Pure function of the analysis — testable, and
    the CLI just prints it."""
    L: list[str] = []
    m = a.meta
    status = "clean close" if a.ended else "INTERRUPTED (no end marker)"
    degraded = bool(a.manifest and a.manifest.get("degraded"))
    if degraded:
        status += ", DEGRADED"
    L.append(f"flight recorder report — run {a.run_id or '?'}")
    L.append(f"  out dir  : {a.out_dir}")
    L.append(f"  status   : {status}")
    L.append(f"  events   : {a.events} "
             f"({a.truncated_lines} torn line(s) tolerated)"
             + (f"; journal holds {a.runs_in_journal} run(s), showing "
                f"the latest" if a.runs_in_journal > 1 else ""))
    regime = (f"{m.get('host_cpus', '?')} host cpu(s), "
              f"{m.get('device_count') if m.get('device_count') is not None else '?'} device(s), "
              f"backend {m.get('backend', '?')}")
    L.append(f"  regime   : {regime}")
    L.append(f"  wall     : {a.wall_s:.2f}s"
             + (f" (critical path {a.critical_path_s:.2f}s)"
                if a.critical_path_s is not None else ""))

    lanes = sorted(a.lane_walls, key=_lane_sort_key)
    if lanes:
        L.append("")
        L.append(f"lane timeline (each column ~{a.wall_s / max(width, 1):.3f}s)")
        for lane in lanes:
            bar = _bar(a.lane_intervals.get(lane, []), a.wall_s, width)
            L.append(f"  {lane:<9}|{bar}| {a.lane_walls[lane]:8.2f}s "
                     f"{a.lane_spans.get(lane, 0):4d} span(s)")
        busy = sum(a.lane_walls.values())
        if a.wall_s > 0:
            L.append(f"  serial-equivalent {busy:.2f}s in {a.wall_s:.2f}s "
                     f"wall (overlap x{busy / a.wall_s:.2f})")

    if a.stage_walls:
        L.append("")
        L.append("stage walls")
        for st, w in sorted(a.stage_walls.items(), key=lambda kv: -kv[1]):
            L.append(f"  {st:<14} {w:8.2f}s")

    if a.cache:
        L.append("")
        L.append("stage cache")
        for st in sorted(a.cache):
            c = a.cache[st]
            hits, misses = c.get("hit", 0), c.get("miss", 0)
            total = hits + misses
            ratio = f"{hits / total * 100:.0f}%" if total else "-"
            extra = "".join(
                f", {k} {v}" for k, v in sorted(c.items())
                if k not in ("hit", "miss"))
            L.append(f"  {st:<6} {hits} hit / {misses} miss ({ratio} hit "
                     f"ratio{extra})")

    if a.launches or a.pair_launches:
        L.append("")
        L.append("device launches")
        if a.launches:
            views = sum(e.get("views", 0) for e in a.launches)
            buckets: dict[int, int] = {}
            for e in a.launches:
                b = e.get("bucket", 0)
                buckets[b] = buckets.get(b, 0) + 1
            L.append(f"  view batches : {views} view(s) in "
                     f"{len(a.launches)} launch(es), mean "
                     f"{views / len(a.launches):.1f}/launch")
            for b in sorted(buckets):
                first = next((e.get("dispatch_s") for e in a.launches
                              if e.get("bucket") == b), None)
                L.append(f"    bucket {b:<4} x{buckets[b]} "
                         f"(first dispatch {first}s)")
        if a.pair_launches:
            pairs = sum(e.get("pairs", 0) for e in a.pair_launches)
            L.append(f"  pair batches : {pairs} pair(s) in "
                     f"{len(a.pair_launches)} register launch(es), mean "
                     f"{pairs / len(a.pair_launches):.1f}/launch")

    if a.assembly is not None or "assembly" in a.lane_walls:
        L.append("")
        L.append("incremental assembly")
        folds = a.lane_spans.get("assembly", 0)
        fold_s = a.lane_walls.get("assembly", 0.0)
        L.append(f"  folds      : {folds} fold event(s), {fold_s:.3f}s "
                 f"folded into the pod window")
        asm = a.assembly or {}
        if asm.get("used_views") is not None:
            L.append(f"  prefix     : {asm.get('used_views')} of "
                     f"{asm.get('folded_views', '?')} folded view(s) "
                     f"validated, {asm.get('folded_pairs', '?')} pair "
                     f"transform(s) pre-chained")
        tail = asm.get("tail_s")
        if tail is not None:
            line = f"  tail_s     : {float(tail):.3f}s after last item settled"
            # can't-drift cross-check: the journal instant and the
            # metrics gauge are written from the SAME report field, so
            # any drift means the close-out path forked — flag >1%
            gauge = None
            for row in (a.metrics or {}).get("gauges", []):
                if row.get("name") == "sl3d_assembly_tail_seconds":
                    gauge = float(row.get("value", 0.0))
            if gauge is None:
                line += " (metrics absent; no cross-check)"
            else:
                ref = max(abs(float(tail)), abs(gauge), 1e-9)
                drift = abs(float(tail) - gauge) / ref
                if drift > 0.01:
                    line += (f" [DRIFT: metrics gauge says {gauge:.3f}s, "
                             f"{drift * 100:.1f}% apart]")
                else:
                    line += f" (= metrics gauge, drift {drift * 100:.2f}%)"
            L.append(line)

    if a.kernels or a.transfer or a.fabric:
        L.append("")
        L.append("kernel table")
        for kn in sorted(a.kernels):
            rec = a.kernels[kn]
            detail = (f", {rec['bytes']} B moved" if rec["bytes"] else "")
            if rec["compiled"]:
                detail += f", {rec['compiled']} compiled dispatch(es)"
            L.append(f"  {kn:<14} {rec['launches']} launch(es), "
                     f"{rec['wall_s']:.3f}s wall{detail}")
            for b in sorted(rec["buckets"]):
                bk = rec["buckets"][b]
                L.append(f"    bucket {b:<4} x{bk['launches']} "
                         f"({bk['wall_s']:.3f}s"
                         + (f", {bk['bytes']} B" if bk["bytes"] else "")
                         + ")")
        if a.transfer:
            fr = a.transfer.get("frames", 0)
            raw = a.transfer.get("frames_raw", 0)
            packed = ""
            if fr and raw > fr:
                # frames_raw is only journaled when it differs from the
                # wire size, i.e. packed ingest was on — show both sides
                packed = (f"; packed ingest: {fr} B wire for {raw} B raw "
                          f"({raw / fr:.1f}x fewer frame bytes)")
            L.append(f"  transfers      {a.transfer.get('h2d', 0)} B h2d "
                     f"({fr} B frame uploads) / "
                     f"{a.transfer.get('d2h', 0)} B d2h" + packed)
        if a.fabric:
            L.append(f"  fabric         {a.fabric.get('fetched', 0)} B "
                     f"fetched / {a.fabric.get('pushed', 0)} B pushed / "
                     f"{a.fabric.get('deduped', 0)} B deduped over the "
                     f"blobstore wire")

    if (a.retries or a.failures or a.injected or a.quarantined
            or (a.manifest and a.manifest.get("failures"))):
        L.append("")
        L.append("fault ledger")
        if a.injected:
            for site, n in sorted(a.injected.items()):
                L.append(f"  injected   {site}: x{n}")
        if a.retries:
            for ln, n in sorted(a.retries.items()):
                L.append(f"  retries    {ln}: x{n}")
        if a.failures:
            for ln, n in sorted(a.failures.items()):
                L.append(f"  failures   {ln}: x{n}")
        for q in a.quarantined:
            L.append(f"  quarantined view {q.get('view')} "
                     f"({q.get('stage')}: {q.get('error')})")
        if a.manifest:
            for rec in a.manifest.get("failures", []):
                L.append(f"  manifest   {rec.get('stage')}/{rec.get('view')}"
                         f": {rec.get('error_type')} after "
                         f"{rec.get('attempts')} attempt(s) "
                         f"({'transient' if rec.get('transient') else 'permanent'})")
            L.append(f"  manifest verdict: degraded="
                     f"{a.manifest.get('degraded')} aborted="
                     f"{a.manifest.get('aborted')} "
                     f"({a.manifest.get('views_survived')}/"
                     f"{a.manifest.get('views_total')} views survived)")
    else:
        L.append("")
        L.append("fault ledger: clean (no retries, failures, or injections)")

    # ---- stall ledger: rendered for clean/DEGRADED/INTERRUPTED alike ----
    breaches = list(a.stall_events)
    if a.stalls:
        # stalls.json is authoritative when present (the journal may have
        # been truncated before the watchdog event flushed)
        breaches = a.stalls.get("breaches", breaches)
    if breaches or a.stalls:
        L.append("")
        L.append("stall ledger")
        for b in breaches:
            lanes = b.get("lane_ages") or b.get("lanes") or {}
            lanestr = ", ".join(f"{ln} {age}s ago"
                                for ln, age in sorted(lanes.items()))
            L.append(f"  {str(b.get('level', '?')).upper():<5} breach: no "
                     f"heartbeat for {b.get('age_s', '?')}s"
                     + (f" (last beats: {lanestr})" if lanestr else ""))
        if a.lane_last_beat and a.wall_s > 0:
            ages = ", ".join(
                f"{ln} {max(0.0, a.wall_s - t):.2f}s"
                for ln, t in sorted(a.lane_last_beat.items(),
                                    key=lambda kv: _lane_sort_key(kv[0])))
            L.append(f"  last-heartbeat age at end of journal: {ages}")
        if a.stalls:
            n_stack = len(a.stalls.get("thread_stacks", []))
            L.append(f"  stalls.json: {len(a.stalls.get('breaches', []))} "
                     f"breach(es), thread-stack dump "
                     f"({n_stack} line(s)) — the wedge's stack lives "
                     f"there")
    else:
        L.append("")
        L.append("stall ledger: clean (no watchdog breaches)")

    if a.metrics is None:
        L.append("")
        L.append("metrics.json: absent (interrupted before close, or "
                 "observability.metrics_file renamed) — journal-only "
                 "analysis above")
    return "\n".join(L)
