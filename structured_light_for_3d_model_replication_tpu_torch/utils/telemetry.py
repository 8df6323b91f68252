"""Run-scoped flight recorder: typed event tracing + a metrics registry.

``OverlapStats`` reports aggregate lane sums; this module records *when*
things happened, to *which* view/pair/launch, so a slow, degraded, or
stalled run is diagnosable from its artifacts alone:

  - :class:`Tracer` — thread-safe recorder of typed span/instant events,
    appended line-by-line (each line flushed) to a crash-safe
    ``trace.jsonl`` journal in the run's out dir. A ``kill -9`` mid-run
    loses at most one partial trailing line; readers tolerate it.
  - :class:`MetricsRegistry` — dependency-free (stdlib-only) counters,
    gauges, and fixed-bucket histograms with p50/p95/p99, serialized to
    ``metrics.json`` next to the STL.

The journal and metrics formats are the JAX package's (schema
``sl3d-trace-v1``), so its ``sl3d report`` reads a port run's journal.

The whole layer is off by default (``observability.trace`` config /
``SL3D_TRACE`` env). Disabled cost is one module-global ``None`` check at
every instrumentation point (the ``faults.fire`` contract): call sites do

    tr = telemetry.current()
    if tr is not None:
        tr.instant("cache.hit", stage=stage)

Journal schema (``sl3d-trace-v1``) — one JSON object per line:

  meta     first line: {"type":"meta","schema","run_id","t0_unix", ...}
  span     {"type":"span","ev":"lane"|"stage","t":<s since t0>,
           "dur":<s>,"th":<thread>, "lane"|"stage", "view"/"pair"/...}
  instant  {"type":"instant","ev":<name>,"t","th", event fields...}
           wired events: lane.retry, lane.failure, cache.hit/miss/evict/
           put_error, launch, pair_launch, fault.injected, retry,
           failure.record, quarantine, executor.finish (critical_path_s),
           lane.heartbeat (throttled, >=1/s per lane while a watchdog is
           armed), watchdog.stall (level=soft|hard, age_s, lane ages)
  end      last line on a clean close: {"type":"end","t","events"}

The ``lane`` spans are emitted from *inside* ``OverlapStats.add`` /
``add_pair_launch`` — the same calls that accumulate the per-lane walls —
so journal-derived lane walls and ``OverlapStats`` cannot drift.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

__all__ = [
    "SCHEMA", "LANE_ORDER", "Tracer", "MetricsRegistry", "current", "activate",
    "deactivate", "new_run_id", "stage", "prometheus_text", "read_journal",
    "export_chrome_trace", "set_host_tag", "host_tag", "host_scoped",
]

SCHEMA = "sl3d-trace-v1"
# the lanes top to bottom in a report and a Chrome trace: the executor's
# five, the register lane, the JAX package's assembly lane, run stages
LANE_ORDER = ("load", "transfer", "compute", "clean", "write", "register",
              "assembly", "stage")

# histogram bucket ladders: log-ish spacing for seconds, powers of two for
# per-launch counts. The +inf bucket is implicit (the overflow count).
_SECONDS_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0, 120.0, 300.0)
_COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


# host-scope identity of a coordinated run: when N workers share one out
# dir, every run id and artifact a worker writes (trace.jsonl,
# metrics.json, failures.json) carries the writer's tag, so no worker
# clobbers another's. Unset (the coordinator, a single-process run) every
# artifact keeps its canonical name.
_HOST_TAG: str | None = None


def set_host_tag(tag: str | None) -> str | None:
    """Install this process's host tag (``w<rank>-<pid>`` in a worker
    process; None restores canonical names). Returns the previous tag."""
    global _HOST_TAG
    prev = _HOST_TAG
    _HOST_TAG = tag or None
    return prev


def host_tag() -> str | None:
    return _HOST_TAG


def host_scoped(filename: str) -> str:
    """The host tag stamped into an artifact name before its extension
    (``trace.jsonl`` -> ``trace.w0-1234.jsonl``); the name itself when no
    tag is set."""
    if _HOST_TAG is None:
        return filename
    stem, dot, ext = filename.rpartition(".")
    if not dot:
        return f"{filename}.{_HOST_TAG}"
    return f"{stem}.{_HOST_TAG}.{ext}"


def new_run_id() -> str:
    """Sortable, collision-safe run identifier (UTC stamp + random hex, and
    the host tag in a worker process)."""
    rid = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()) + "-" + os.urandom(4).hex()
    if _HOST_TAG is not None:
        rid += "-" + _HOST_TAG
    return rid


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def _labelkey(labels: dict, extra: dict | None = None) -> tuple:
    """Canonical (sorted, stringified) label identity. ``extra`` is the
    explicit ``labels={}`` dict — it merges OVER the kwargs form so call
    sites can use label names that aren't valid Python identifiers
    (e.g. dotted stage paths) without name-mangling."""
    merged = dict(labels)
    if extra:
        merged.update(extra)
    return tuple(sorted((k, str(v)) for k, v in merged.items()
                        if v is not None))


class _Histogram:
    __slots__ = ("buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets=_SECONDS_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1 = +inf overflow
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for i, edge in enumerate(self.buckets):  # noqa: B007
            if v <= edge:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> float | None:
        """Bucket-interpolated quantile estimate, clamped to [min, max]."""
        if self.count == 0:
            return None
        rank = q * self.count
        seen = 0.0
        lo = 0.0
        for i, c in enumerate(self.counts):
            hi = (self.buckets[i] if i < len(self.buckets)
                  else (self.max if self.max is not None else lo))
            if seen + c >= rank and c > 0:
                frac = (rank - seen) / c
                est = lo + (hi - lo) * frac
                return max(self.min or 0.0, min(est, self.max or est))
            seen += c
            lo = hi
        return self.max


class MetricsRegistry:
    """Dependency-free counters / gauges / fixed-bucket histograms.

    Thread-safe; serializes to a plain dict (``as_dict``) for
    ``metrics.json``. No third-party client library.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, _Histogram] = {}

    def inc(self, name: str, value: float = 1.0, labels: dict | None = None,
            **kwlabels) -> None:
        k = (name, _labelkey(kwlabels, labels))
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float,
                  labels: dict | None = None, **kwlabels) -> None:
        with self._lock:
            self._gauges[(name, _labelkey(kwlabels, labels))] = float(value)

    def observe(self, name: str, value: float, buckets=_SECONDS_BUCKETS,
                labels: dict | None = None, **kwlabels) -> None:
        k = (name, _labelkey(kwlabels, labels))
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Histogram(buckets)
            h.observe(value)

    def counter_value(self, name: str, labels: dict | None = None,
                      **kwlabels) -> float:
        with self._lock:
            return self._counters.get((name, _labelkey(kwlabels, labels)), 0.0)

    def as_dict(self) -> dict:
        def row(k, v):
            return {"name": k[0], "labels": dict(k[1]), "value": v}

        with self._lock:
            out = {
                "counters": [row(k, round(v, 6))
                             for k, v in sorted(self._counters.items())],
                "gauges": [row(k, round(v, 6))
                           for k, v in sorted(self._gauges.items())],
                "histograms": [],
            }
            for k, h in sorted(self._hists.items()):
                out["histograms"].append({
                    "name": k[0], "labels": dict(k[1]),
                    "buckets": list(h.buckets),
                    "counts": list(h.counts),
                    "count": h.count, "sum": round(h.sum, 6),
                    "min": h.min, "max": h.max,
                    "p50": h.quantile(0.50), "p95": h.quantile(0.95),
                    "p99": h.quantile(0.99),
                })
        return out

    def to_prometheus(self) -> str:
        """Prometheus exposition text of the live registry
        (``prometheus_text`` of ``as_dict``)."""
        return prometheus_text(self.as_dict())


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

class Tracer:
    """Append-only journal writer + metrics accumulator for ONE run.

    Every emit serializes one JSON line and flushes it, so a crash at any
    point leaves a journal whose every complete line parses (the atomic.py
    contract, at line granularity). Emit failures (disk full) are counted
    and swallowed — observability must never kill the run it observes.
    """

    def __init__(self, path: str, run_id: str | None = None,
                 meta: dict | None = None,
                 registry: MetricsRegistry | None = None):
        self.path = path
        self.run_id = run_id or new_run_id()
        self.registry = registry or MetricsRegistry()
        self.dropped = 0
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._t0_unix = time.time()
        self._events = 0
        self._closed = False
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        head = {"type": "meta", "schema": SCHEMA, "run_id": self.run_id,
                "t0_unix": round(self._t0_unix, 3)}
        head.update(meta or {})
        self._emit(head)

    # -- core --------------------------------------------------------------

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def _emit(self, obj: dict) -> None:
        try:
            line = json.dumps(obj, separators=(",", ":"), default=str)
        except (TypeError, ValueError):
            self.dropped += 1
            return
        with self._lock:
            if self._closed:
                self.dropped += 1
                return
            try:
                self._f.write(line + "\n")
                self._f.flush()
                self._events += 1
            except OSError:
                self.dropped += 1

    @staticmethod
    def _clean(fields: dict) -> dict:
        return {k: v for k, v in fields.items() if v is not None}

    # -- event API ---------------------------------------------------------

    def instant(self, ev: str, **fields) -> None:
        """Typed point event. Known events also feed the metrics registry
        (retry/failure counters per lane, cache event counters per stage,
        launch counters + per-launch histograms, injected-fault counters)."""
        reg = self.registry
        reg.inc("sl3d_events_total", ev=ev)
        if ev == "lane.retry":
            reg.inc("sl3d_retries_total", lane=fields.get("lane"))
        elif ev == "lane.failure":
            reg.inc("sl3d_failures_total", lane=fields.get("lane"))
        elif ev.startswith("cache."):
            reg.inc("sl3d_cache_events_total", stage=fields.get("stage"),
                    kind=ev[6:])
        elif ev == "launch":
            reg.inc("sl3d_launches_total")
            if fields.get("views") is not None:
                reg.observe("sl3d_views_per_launch", fields["views"],
                            buckets=_COUNT_BUCKETS)
        elif ev == "pair_launch":
            reg.inc("sl3d_pair_launches_total")
            if fields.get("pairs") is not None:
                reg.observe("sl3d_pairs_per_launch", fields["pairs"],
                            buckets=_COUNT_BUCKETS)
        elif ev == "fault.injected":
            reg.inc("sl3d_faults_injected_total", site=fields.get("site"),
                    kind=fields.get("kind"))
        elif ev == "transfer.bytes":
            if fields.get("h2d"):
                reg.inc("sl3d_transfer_bytes_total", float(fields["h2d"]),
                        dir="h2d")
            if fields.get("d2h"):
                reg.inc("sl3d_transfer_bytes_total", float(fields["d2h"]),
                        dir="d2h")
        elif ev.startswith("kernel."):
            reg.inc("sl3d_kernel_events_total", kernel=ev[7:])
            if fields.get("wall_s") is not None:
                reg.observe("sl3d_kernel_seconds", fields["wall_s"],
                            kernel=ev[7:])
        elif ev == "watchdog.stall":
            reg.inc("sl3d_stalls_total", level=fields.get("level"))
        self._emit(self._clean(
            {"type": "instant", "ev": ev, "t": round(self.now(), 6),
             "th": threading.current_thread().name, **fields}))

    def lane(self, lane: str, dur_s: float, **fields) -> None:
        """One lane-busy span that ENDED just now (``OverlapStats.add``
        calls this right after measuring, so start = now - dur). The
        journal's per-lane walls are sums of exactly these durations."""
        dur = float(dur_s)
        self.registry.observe("sl3d_lane_seconds", dur, lane=lane)
        self._emit(self._clean(
            {"type": "span", "ev": "lane", "lane": lane,
             "t": round(max(0.0, self.now() - dur), 6),
             "dur": round(dur, 6),
             "th": threading.current_thread().name, **fields}))

    def span_end(self, name: str, dur_s: float, **fields) -> None:
        """A named run-level stage span that just ended (keys/reconstruct/
        merge/mesh/...)."""
        dur = float(dur_s)
        self.registry.inc("sl3d_stage_wall_seconds_total", dur, stage=name)
        self._emit(self._clean(
            {"type": "span", "ev": "stage", "stage": name,
             "t": round(max(0.0, self.now() - dur), 6),
             "dur": round(dur, 6),
             "th": threading.current_thread().name, **fields}))

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.span_end(name, time.perf_counter() - t0, **fields)

    # -- close -------------------------------------------------------------

    def close(self, metrics_path: str | None = None) -> None:
        """Write the end marker, close the journal, and (optionally) persist
        the metrics registry as crash-safe JSON. Idempotent; runs in the
        pipeline's ``finally`` so even an InjectedCrash gets a metrics
        snapshot of everything recorded up to the crash."""
        if self._closed:
            return
        self.registry.set_gauge("sl3d_trace_events", self._events + 1)
        self.registry.set_gauge("sl3d_trace_dropped", self.dropped)
        self._emit({"type": "end", "t": round(self.now(), 6),
                    "events": self._events + 1})
        with self._lock:
            self._closed = True
            try:
                self._f.close()
            except OSError:
                pass
        if metrics_path is not None:
            payload = {"schema": SCHEMA, "run_id": self.run_id,
                       "t0_unix": round(self._t0_unix, 3),
                       "wall_s": round(self.now(), 6)}
            payload.update(self.registry.as_dict())
            tmp = metrics_path + ".tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(payload, f, indent=2, sort_keys=True)
                    f.write("\n")
                os.replace(tmp, metrics_path)
            except OSError:
                self.dropped += 1
                try:
                    os.remove(tmp)
                except OSError:
                    pass


# ---------------------------------------------------------------------------
# module-global current tracer (the faults._PLAN pattern: disabled == None)
# ---------------------------------------------------------------------------

_TRACER: Tracer | None = None


def current() -> Tracer | None:
    """The active tracer, or None when tracing is off. Hot paths fetch this
    once and guard with ``is not None`` — the zero-allocation disabled
    path."""
    return _TRACER


def activate(tracer: Tracer | None) -> Tracer | None:
    """Install ``tracer`` process-wide; returns the PREVIOUS tracer so a
    nested scope (bench arms, tests) can restore it on exit."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def deactivate(restore: Tracer | None = None) -> None:
    global _TRACER
    _TRACER = restore


@contextlib.contextmanager
def stage(name: str, **fields):
    """Run-level stage span on the CURRENT tracer; no-op without one. Used
    at stage granularity (a handful per run), never in per-view loops."""
    tr = _TRACER
    if tr is None:
        yield
        return
    with tr.span(name, **fields):
        yield


# ---------------------------------------------------------------------------
# readers and exporters (the JAX package's, for ``report``)
# ---------------------------------------------------------------------------

def _prom_escape(v) -> str:
    """Label-value escaping of the Prometheus exposition format (backslash,
    double quote, newline)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_prom_escape(v)}"' for k, v in sorted(items.items())) + "}"


def prometheus_text(metrics: dict) -> str:
    """Prometheus exposition text of a ``MetricsRegistry.as_dict`` payload
    (or a loaded ``metrics.json``)."""
    lines: list[str] = []
    typed: set[str] = set()

    def head(name, kind):
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for row in metrics.get("counters", []):
        head(row["name"], "counter")
        lines.append(f"{row['name']}{_prom_labels(row['labels'])} {row['value']}")
    for row in metrics.get("gauges", []):
        head(row["name"], "gauge")
        lines.append(f"{row['name']}{_prom_labels(row['labels'])} {row['value']}")
    for h in metrics.get("histograms", []):
        name = h["name"]
        head(name, "histogram")
        cum = 0
        for edge, c in zip(h["buckets"] + ["+Inf"], h["counts"]):
            cum += c
            lines.append(f"{name}_bucket{_prom_labels(h['labels'], {'le': edge})} {cum}")
        lines.append(f"{name}_sum{_prom_labels(h['labels'])} {h['sum']}")
        lines.append(f"{name}_count{_prom_labels(h['labels'])} {h['count']}")
    return "\n".join(lines) + "\n"


def read_journal(path: str) -> dict:
    """Parse a ``trace.jsonl`` tolerantly: every well-formed line is an
    event; a torn trailing line or stray corruption counts in
    ``truncated``. The journal holds one segment a run (a rerun into the
    same out dir appends a new meta line): ``meta`` / ``events`` are the
    latest run's, ``segments`` the whole history in order."""
    entries: list[dict] = []
    truncated = 0
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                truncated += 1
                continue
            if not isinstance(obj, dict) or "type" not in obj:
                truncated += 1
                continue
            entries.append(obj)
    starts = [i for i, o in enumerate(entries) if o["type"] == "meta"]
    segments: list[dict] = []
    if not starts:
        segments.append({"meta": None, "events": entries})
    else:
        if starts[0] != 0:
            segments.append({"meta": None, "events": entries[:starts[0]]})
        for a, b in zip(starts, starts[1:] + [len(entries)]):
            segments.append({"meta": entries[a], "events": entries[a + 1:b]})
    last = segments[-1]
    return {"meta": last["meta"], "events": last["events"], "truncated": truncated,
            "segments": segments,
            "runs": sum(1 for s in segments if s["meta"] is not None)}


def export_chrome_trace(journal_path: str, out_path: str) -> dict:
    """A journal as Chrome trace-event JSON (Perfetto, chrome://tracing):
    one track a distinct (lane, thread), sorted by ``LANE_ORDER``. Returns
    {events, lanes, tracks, truncated}."""
    j = read_journal(journal_path)
    meta = j["meta"] or {}
    run_id = meta.get("run_id", "?")
    pid = 1
    tids: dict[tuple, int] = {}
    out: list[dict] = [{"ph": "M", "pid": pid, "name": "process_name",
                        "args": {"name": f"sl3d run {run_id}"}}]

    def tid_for(lane: str, th: str) -> int:
        key = (lane, th)
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = len(tids) + 1
            order = LANE_ORDER.index(lane) if lane in LANE_ORDER else len(LANE_ORDER)
            out.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                        "args": {"name": f"{lane} [{th}]"}})
            out.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_sort_index",
                        "args": {"sort_index": order * 64 + tid}})
        return tid

    for ev in j["events"]:
        t_us = float(ev.get("t", 0.0)) * 1e6
        th = str(ev.get("th", "main"))
        if ev["type"] == "span":
            lane = ev.get("lane") or "stage"
            name = (ev.get("stage") if ev["ev"] == "stage"
                    else str(ev.get("view", ev.get("pair", lane))))
            args = {k: v for k, v in ev.items() if k not in ("type", "ev", "t", "dur", "th")}
            out.append({"ph": "X", "pid": pid, "tid": tid_for(lane, th), "ts": t_us,
                        "dur": float(ev.get("dur", 0.0)) * 1e6, "name": str(name),
                        "cat": ev["ev"], "args": args})
        elif ev["type"] == "instant":
            args = {k: v for k, v in ev.items() if k not in ("type", "ev", "t", "th")}
            lane = ev.get("lane") or "events"
            out.append({"ph": "i", "s": "t", "pid": pid, "tid": tid_for(lane, th),
                        "ts": t_us, "name": ev["ev"], "cat": "instant", "args": args})
    payload = {"traceEvents": out, "displayTimeUnit": "ms",
               "metadata": {"schema": SCHEMA, "run_id": run_id,
                            "truncated_lines": j["truncated"]}}
    tmp = out_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, separators=(",", ":"))
    os.replace(tmp, out_path)
    return {"events": len(out), "lanes": len({k[0] for k in tids}),
            "tracks": len(tids), "truncated": j["truncated"]}
