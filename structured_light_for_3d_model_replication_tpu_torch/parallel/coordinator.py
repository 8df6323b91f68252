"""Host-level fault domains: the preemption-tolerant multiprocess coordinator.

``run_coordinated`` splits one scan into leased work items (per-view
reconstruct+clean, per-pair registration — the same bucket-laddered view
programs and chain-position pair ids the fused pipeline uses), grants them
to N local worker processes over a loopback lease protocol, and steals back
expired leases so a killed / preempted / wedged / partitioned worker costs
only its in-flight items. Workers are *cache warmers*: every result lands in
the content-addressed StageCache under the exact key the single-process
pipeline would use (``stages._view_plan`` is shared), so the final assembly
pass IS a plain single-process ``run_pipeline`` over the warmed cache —
coordinated output is byte-identical to a single-process run by
construction, a lost item merely recomputes in assembly, and DEGRADED
completion means exactly what it means single-process (assembly owns the
``pipeline.min_views`` floor and every abort/degrade decision).

The device travels in the worker spec: every worker computes on the
coordinator's resolved device (a CPU run spawns CPU workers, a CUDA run
CUDA workers, each with its own CUDA context), since the stage-cache keys
carry the device type and a worker on another device would warm entries
the assembly pass never reads. On CUDA the coordinator loads the kernel
library before it spawns anyone, so no worker runs ``nvcc``. A worker
whose kernel fails reports the item ``failed``; the assembly pass then
recomputes it on the card in this process, where the same failure raises.

Crash safety: every grant / complete / steal / failed / lost is journaled
to an append-only JSONL ledger (``ledger.jsonl``, tmp-free line appends +
fsync — the trace-journal discipline). A coordinator that crashes mid-run
resumes from the stage cache plus the ledger with ZERO recompute of
completed items: replay unions completed ids across segments, and the
cache already holds their bytes.

Lease protocol (see parallel/lease.py for the bookkeeping invariants):

  worker                         coordinator
    | -- hello {worker, pid} -->  | registers, returns lease_s/heartbeat_s
    | -- next {worker} -------->  | journal grant, lease item, send spec
    | ... computes; OverlapStats.add's heartbeat hook sends ...
    | -- beat {worker} -------->  | renews ALL the worker's leases
    | -- complete {item, gen} ->  | journal + settle iff (worker, gen)
    |                             |   still hold the lease, else "stolen"
    | -- failed {item, ...} --->  | journal; item recomputes in assembly
    | <- shutdown --------------  | when every item is settled

The ledger, the wire messages, the spec and file names are the JAX
package's (``parallel/coordinator.py``), so either package replays the
other's ``ledger.jsonl``.

A worker that misses ``lease_s`` of heartbeats has its items stolen
(generation bump) and re-granted to survivors; an item stolen more than
``coordinator.max_steals`` times is declared LOST and left to assembly.

**Pod fabric** (``coordinator.listen`` non-empty): the same protocol over a
real TCP endpoint instead of an ephemeral loopback port, so ``worker``
processes on OTHER hosts can join. What changes:

  - the server binds ``coordinator.listen`` (netutil endpoint grammar,
    IPv6-safe) and, when ``coordinator.secret`` is set, requires a matching
    ``hello`` as a connection's first request (anything else answers
    ``{"error": "unauthorized"}``);
  - a content-addressed blob service (pipeline/blobstore.py) co-hosts next
    to the coordinator, backed by the SAME cache directory assembly reads —
    spawned workers get private L1 roots and the fabric is their L2, so the
    cache-warmer parity construction carries over to hosts that do not
    share a disk (a missing payload is a recompute, never a wrong byte);
  - ``hello``/``next``/``beat`` carry inventory diffs (which blob names the
    worker's L1 holds) into a :class:`~.lease.LocalityIndex`, and pair
    grants prefer the worker already holding BOTH cleaned-view payloads
    (``locality: hit`` on the grant event; plain FIFO fallback means a
    cold worker never starves).
"""
from __future__ import annotations

import copy
import json
import os
import socket
import subprocess
import sys
import threading
import time

from structured_light_for_3d_model_replication_tpu_torch.config import Config
from structured_light_for_3d_model_replication_tpu_torch.parallel import netutil
from structured_light_for_3d_model_replication_tpu_torch.utils import deadline as dl
from structured_light_for_3d_model_replication_tpu_torch.utils import faults
from structured_light_for_3d_model_replication_tpu_torch.utils import telemetry as tel
from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["Ledger", "run_coordinated", "LEDGER_SCHEMA"]

LEDGER_SCHEMA = "sl3d-ledger-v1"

# item lifecycle: pending -> granted -> completed | failed | lost
# (failed/lost items are NOT errors at run scope — assembly recomputes them)
_SETTLED = ("completed", "failed", "lost")


class Ledger:
    """Append-only, crash-safe work ledger (one JSONL line per event).

    Segment discipline mirrors the trace journal: every coordinator start
    appends a ``meta`` head line, so one file accumulates segments across
    crashes and replay can attribute events to attempts. Events are
    line-buffered and fsynced — a torn final line (kill -9 mid-write) is
    tolerated by replay, never repaired in place."""

    def __init__(self, path: str, run_id: str, meta: dict | None = None,
                 epoch=None, fence=None):
        # HA serving: ``epoch`` is a callable giving the writer's current
        # fencing token, stamped on every line; ``fence`` runs before each
        # append and raises (election.FencedWrite) to refuse the write of a
        # deposed leader. Without them a line is what it always was.
        self.path = path
        self._lock = threading.Lock()
        self._epoch = epoch
        self._fence = fence
        self._f = open(path, "a", encoding="utf-8")
        head = {"type": "meta", "schema": LEDGER_SCHEMA, "run_id": run_id,
                "t0_unix": time.time()}
        if epoch is not None:
            head["epoch"] = int(epoch())
        head.update(meta or {})
        self._append(head)

    def _append(self, rec: dict) -> None:
        with self._lock:
            self._f.write(json.dumps(rec, sort_keys=True) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())

    def event(self, type_: str, **fields) -> None:
        # chaos hook BEFORE the append: a crash here loses the event (the
        # torn-tail / lost-line case replay must tolerate), a transient
        # here surfaces to the caller exactly like a full-disk write
        faults.fire("ledger.append", item=type_)
        if self._fence is not None:
            self._fence()
        rec = {"type": type_, "t": round(time.time(), 6)}
        if self._epoch is not None:
            rec["epoch"] = int(self._epoch())
        rec.update(fields)
        self._append(rec)

    def close(self) -> None:
        with self._lock:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            finally:
                self._f.close()

    @staticmethod
    def replay(path: str) -> dict:
        """Fold a ledger back into resume state: the union of completed
        item ids across every segment (a completed item never un-completes
        — its bytes are in the stage cache), plus segment/event counts for
        reporting. Unparseable lines (the torn tail) are skipped."""
        completed: set[str] = set()
        segments = 0
        events = 0
        if not os.path.exists(path):
            return {"completed": completed, "segments": 0, "events": 0}
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue    # torn tail from a crash mid-append
                t = rec.get("type")
                if t == "meta":
                    if rec.get("schema") != LEDGER_SCHEMA:
                        raise ValueError(
                            f"ledger {path}: unknown schema "
                            f"{rec.get('schema')!r} (want {LEDGER_SCHEMA})")
                    segments += 1
                    continue
                events += 1
                if t == "complete":
                    completed.add(rec["item"])
        return {"completed": completed, "segments": segments,
                "events": events}


class _Item:
    __slots__ = ("id", "kind", "spec", "state", "deps", "worker")

    def __init__(self, id: str, kind: str, spec: dict,
                 deps: tuple[str, ...] = ()):
        self.id = id
        self.kind = kind
        self.spec = spec
        self.state = "pending"
        self.deps = deps
        self.worker: str | None = None


class _Coordinator:
    """Shared state between the socket server threads and the poll loop."""

    def __init__(self, cfg: Config, items: list[_Item], ledger: Ledger,
                 run_id: str, view_done: set[str], log):
        from structured_light_for_3d_model_replication_tpu_torch.parallel.lease import (
            LeaseTable,
            LocalityIndex,
        )

        self.cfg = cfg
        self.items = {it.id: it for it in items}
        self.order = [it.id for it in items]
        self.ledger = ledger
        self.run_id = run_id
        self.view_done = view_done      # settled-successfully view item ids
        self.log = log
        self.leases = LeaseTable(cfg.coordinator.lease_s)
        self.lock = threading.Lock()
        self.done = threading.Event()
        self.crash: BaseException | None = None   # injected coord crash
        self.workers_seen: dict[str, int] = {}    # worker -> pid
        self.worker_addrs: dict[str, str] = {}    # worker -> advertised addr
        self.completed_by: dict[str, int] = {}
        self.steal_count = 0
        self.late_completes = 0
        # fabric mode only: inventory-driven grant preference. Off-fabric
        # (shared disk) the index stays None and grants are plain FIFO
        self.locality = (LocalityIndex() if cfg.coordinator.listen
                         else None)
        self.blob_endpoint = ""         # set by run_coordinated in fabric mode
        # incremental assembly lane (merge.incremental): fed every
        # successfully settled item id; None when the knob is off
        self.assembler = None

    # ---- queue logic (call under self.lock) ------------------------------

    def _pair_needs(self, it: _Item) -> tuple[str, ...] | None:
        """The blob names a pair item reads (its endpoints' cleaned-view
        payloads) — what locality scoring matches against inventories."""
        if it.kind != "pair":
            return None
        return (f"view-{it.spec['key_dst'][:16]}",
                f"view-{it.spec['key_src'][:16]}")

    def _grantable(self, worker: str | None = None) \
            -> tuple[_Item | None, str | None]:
        """First grantable item for ``worker`` plus the locality verdict
        ("hit"/"miss"/None). Without a locality index (off-fabric) this is
        plain FIFO over dep-ready pending items."""
        cands: list[_Item] = []
        for iid in self.order:
            it = self.items[iid]
            if it.state != "pending":
                continue
            if all(d in self.view_done for d in it.deps):
                if self.locality is None or worker is None:
                    return it, None
                cands.append(it)
        if not cands:
            return None, None
        idx, hit = self.locality.choose(
            worker, [(it.id, self._pair_needs(it)) for it in cands])
        chosen = cands[idx]
        if chosen.kind != "pair":
            return chosen, None
        return chosen, ("hit" if hit else "miss")

    def _dep_blocked_forever(self, it: _Item) -> bool:
        """A pending pair whose endpoint view FAILED or was LOST can never
        have its deps met — assembly will recompute the whole chain link."""
        for d in it.deps:
            dep = self.items.get(d)
            if dep is not None and dep.state in ("failed", "lost"):
                return True
        return False

    def unsettled(self) -> int:
        with self.lock:
            return sum(1 for it in self.items.values()
                       if it.state not in _SETTLED)

    def _check_done(self) -> None:
        if all(it.state in _SETTLED for it in self.items.values()):
            self.done.set()

    # ---- protocol ops (any server thread) --------------------------------

    def _fold_inventory(self, req: dict) -> None:
        """Inventory diffs piggyback on hello/next/beat; additive, so a
        replayed or reordered diff is harmless."""
        if self.locality is not None:
            inv = req.get("inventory")
            if inv:
                self.locality.update(req["worker"], inv)

    def op_hello(self, req: dict) -> dict:
        w = req["worker"]
        with self.lock:
            self.workers_seen[w] = int(req.get("pid", 0))
            if req.get("addr"):
                self.worker_addrs[w] = str(req["addr"])
        self._fold_inventory(req)
        c = self.cfg.coordinator
        out = {"ok": True, "run_id": self.run_id,
               "lease_s": c.lease_s, "heartbeat_s": c.heartbeat_s}
        if self.blob_endpoint:
            out["blob"] = self.blob_endpoint
        return out

    def op_next(self, req: dict) -> dict:
        w = req["worker"]
        self.leases.renew(w)
        self._fold_inventory(req)
        if self.done.is_set():
            return {"shutdown": True}
        with self.lock:
            it, loc = self._grantable(w)
            if it is None:
                # settle dep-dead pairs while we are here, so the run
                # drains instead of idling on unreachable work
                for iid in self.order:
                    cand = self.items[iid]
                    if (cand.state == "pending"
                            and self._dep_blocked_forever(cand)):
                        cand.state = "lost"
                        self.ledger.event("lost", item=cand.id,
                                          reason="dep-failed")
                self._check_done()
                if self.done.is_set():
                    return {"shutdown": True}
                return {"wait": max(0.05, self.cfg.coordinator.heartbeat_s
                                    / 4.0)}
            # injected coordinator-crash site: fires BEFORE the grant is
            # journaled, so resume sees a clean prefix (the crash-safety
            # contract is about completed work, never in-flight grants)
            faults.fire("coord.grant", item=f"{w}:{it.id}")
            lease = self.leases.grant(it.id, w)
            it.state = "granted"
            it.worker = w
            ev = {"item": it.id, "worker": w, "gen": lease.gen}
            if loc is not None:
                ev["locality"] = loc
            self.ledger.event("grant", **ev)
        return {"grant": {"id": it.id, "gen": lease.gen, "kind": it.kind,
                          "spec": it.spec}}

    def op_beat(self, req: dict) -> dict:
        self._fold_inventory(req)
        return {"ok": self.leases.renew(req["worker"])}

    def op_complete(self, req: dict) -> dict:
        w, iid, gen = req["worker"], req["item"], int(req["gen"])
        accepted = self.leases.complete(iid, w, gen)
        with self.lock:
            it = self.items.get(iid)
            if accepted and it is not None:
                it.state = "completed"
                if it.kind == "view":
                    self.view_done.add(iid)
                self.completed_by[w] = self.completed_by.get(w, 0) + 1
                self.ledger.event("complete", item=iid, worker=w, gen=gen)
                if self.assembler is not None:
                    # enqueue-only (the fold runs on the assembler's own
                    # worker) — never blocks the server thread
                    self.assembler.note_item(iid)
                self._check_done()
                return {"ok": "accepted"}
            # stale echo after a steal: the RESULT may still be perfectly
            # good (content-addressed cache put), only the credit is void
            self.late_completes += 1
            self.ledger.event("late-complete", item=iid, worker=w, gen=gen)
            return {"ok": "stolen"}

    def op_failed(self, req: dict) -> dict:
        w, iid = req["worker"], req["item"]
        self.leases.complete(iid, w, int(req.get("gen", 0)))
        with self.lock:
            it = self.items.get(iid)
            if it is not None and it.state not in _SETTLED:
                it.state = "failed"
                self.ledger.event("failed", item=iid, worker=w,
                                  error=str(req.get("error", ""))[:500],
                                  error_type=req.get("error_type", ""),
                                  transient=bool(req.get("transient")))
                self.log(f"[coord] item {iid} FAILED on {w} "
                         f"({req.get('error_type')}); assembly will "
                         f"recompute it")
                self._check_done()
        return {"ok": True}

    # ---- expiry / dead-worker sweeps (poll loop) -------------------------

    def _revoke(self, iid: str, why: str) -> None:
        """Under self.lock: return a stolen/dropped item to the queue, or
        declare it lost past the steal budget."""
        gen = self.leases.steal(iid)
        self.steal_count += 1
        it = self.items[iid]
        self.ledger.event("steal", item=iid, worker=it.worker, gen=gen,
                          reason=why)
        if self.leases.steals(iid) > self.cfg.coordinator.max_steals:
            it.state = "lost"
            self.ledger.event("lost", item=iid, reason="max-steals")
            self.log(f"[coord] item {iid} exceeded max_steals="
                     f"{self.cfg.coordinator.max_steals} — LOST "
                     f"(assembly recomputes it)")
        else:
            it.state = "pending"
            it.worker = None

    def sweep_expired(self) -> None:
        for lease in self.leases.expired():
            with self.lock:
                if self.items[lease.item].state != "granted":
                    continue
                self.log(f"[coord] lease on {lease.item} (held by "
                         f"{lease.worker}) expired — stealing")
                self._revoke(lease.item, "lease-expired")
                self._check_done()

    def drop_worker(self, worker: str, why: str) -> None:
        if self.locality is not None:
            self.locality.drop_worker(worker)
        items = self.leases.drop_worker(worker)
        with self.lock:
            for iid in items:
                if self.items[iid].state != "granted":
                    continue
                self.steal_count += 1
                # generation == lifetime steal count (bumps only on
                # revocation), and drop_worker already bumped it
                gen = self.leases.steals(iid)
                it = self.items[iid]
                self.ledger.event("steal", item=iid, worker=worker,
                                  gen=gen, reason=why)
                if gen > self.cfg.coordinator.max_steals:
                    it.state = "lost"
                    self.ledger.event("lost", item=iid,
                                      reason="max-steals")
                else:
                    it.state = "pending"
                    it.worker = None
            self._check_done()
        if items:
            self.log(f"[coord] reclaimed {len(items)} item(s) from "
                     f"{worker} ({why})")


class _Server:
    """Newline-JSON lease server; one daemon thread per worker connection.
    Binds loopback + an ephemeral port by default;
    ``coordinator.listen`` rebinds it to a real endpoint so remote
    ``worker`` processes can dial in, and ``coordinator.secret``
    gates every connection behind a matching first-``hello``. Injected
    coordinator crashes raised in a handler are STORED (the socket thread
    must not die silently) and re-raised by the poll loop — the
    coordinator process then actually crashes."""

    def __init__(self, coord: _Coordinator, port: int, log,
                 listen: str = "", secret: str = ""):
        self.coord = coord
        self.log = log
        self.secret = secret
        host, bind_port = netutil.parse_endpoint(listen, default_port=port)
        self._sock = socket.create_server((host, bind_port))
        self._sock.settimeout(0.2)
        self.host = self._sock.getsockname()[0]
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="sl3d-coord-accept", daemon=True)
        self._accept_thread.start()

    @property
    def endpoint(self) -> str:
        return netutil.format_endpoint(self.host, self.port)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name="sl3d-coord-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        ops = {"hello": self.coord.op_hello, "next": self.coord.op_next,
               "beat": self.coord.op_beat, "complete": self.coord.op_complete,
               "failed": self.coord.op_failed}
        # per-connection auth: with a secret set, the FIRST request must
        # be a hello presenting it; until then every op answers
        # unauthorized and the connection closes (fail-closed — an
        # unauthenticated peer learns nothing about the run)
        authed = not self.secret
        try:
            with conn, conn.makefile("rw", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                        if not authed:
                            if (req.get("op") != "hello"
                                    or req.get("secret") != self.secret):
                                f.write(json.dumps(
                                    {"error": "unauthorized"}) + "\n")
                                f.flush()
                                return
                            authed = True
                        resp = ops[req["op"]](req)
                    except faults.InjectedCrash as e:
                        # surface on the poll loop; tell the worker to
                        # idle so it doesn't spin on a dying coordinator
                        self.coord.crash = e
                        self.coord.done.set()
                        resp = {"wait": 0.5}
                    except Exception as e:
                        resp = {"error": f"{type(e).__name__}: {e}"}
                    f.write(json.dumps(resp) + "\n")
                    f.flush()
        except (OSError, ValueError):
            pass    # worker vanished mid-exchange; lease expiry covers it

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# run_coordinated
# ---------------------------------------------------------------------------


def _build_items(cfg: Config, sources: list[str], view_keys: list[str],
                 cache, completed: set[str]) -> tuple[list[_Item], set[str]]:
    """The work ledger: one view item per cache-miss view, one pair item
    per chain link when the streamed register lane would run. ``completed``
    (ledger replay) and cache hits both exclude items — zero recompute on
    resume."""
    items: list[_Item] = []
    view_done: set[str] = set()
    for i, src in enumerate(sources):
        iid = f"view:{i}"
        if iid in completed or cache.get("view", view_keys[i]) is not None:
            view_done.add(iid)
            continue
        items.append(_Item(iid, "view",
                           {"index": i, "src": src, "key": view_keys[i]}))
    streamed = cfg.merge.stream and cfg.merge.method != "posegraph"
    if streamed:
        for i in range(len(sources) - 1):
            iid = f"pair:{i}"
            if iid in completed:
                continue
            # pair caching is digest-keyed on the endpoint OUTPUTS, so the
            # worker resolves the key itself once both views are in cache
            items.append(_Item(
                iid, "pair",
                {"pid": i, "dst": i, "src": i + 1,
                 "key_dst": view_keys[i], "key_src": view_keys[i + 1]},
                deps=(f"view:{i}", f"view:{i + 1}")))
    return items, view_done


def _spawn_worker(rank: int, n: int, port: int, spec_dir: str,
                  cfg_path: str, calib_path: str, target: str, out_dir: str,
                  steps: tuple[str, ...], device: str,
                  fabric: dict | None = None, name: str | None = None,
                  generation: int = 0,
                  cache_root: str | None = None) -> subprocess.Popen:
    """Write ``<spec_dir>/worker<rank>.json`` and start ``python -m
    structured_light_for_3d_model_replication_tpu_torch worker --spec`` on
    it (fork + exec, so a coordinator that already holds a CUDA context
    hands none to the child), its output in ``worker<rank>.log``. The
    serving fleet names its workers (``name``), stamps a respawn's
    ``generation`` and points them at the service's shared store
    (``cache_root``)."""
    wname = name or f"w{rank}"
    spec = {"config": cfg_path, "calib": calib_path, "target": target,
            "out": out_dir, "steps": list(steps), "port": port,
            "worker": wname, "num_workers": n, "device": device}
    if generation:
        # a fleet respawn reuses the rank's name; the generation tells this
        # incarnation from the one the supervisor reaped
        spec["generation"] = int(generation)
    if fabric:
        # networked mode: dial the real endpoint, authenticate, use the
        # blob fabric as L2 — and warm a PRIVATE L1 root, so each spawned
        # worker honestly simulates a host with its own disk (fabric
        # traffic, dedup, and locality are real and measurable on one box)
        spec.update(fabric)
        spec["cache_root"] = os.path.join(out_dir,
                                          f".slscan-cache.{wname}")
    if cache_root:
        # the fleet on loopback warms the service's shared store directly
        spec["cache_root"] = cache_root
    spec_path = os.path.join(spec_dir, f"worker{rank}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f, indent=2)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p] + [env.get("PYTHONPATH", "")]).rstrip(
            os.pathsep)
    log_path = os.path.join(spec_dir, f"worker{rank}.log")
    logf = open(log_path, "ab")
    pkg = __name__.split(".")[0]
    proc = subprocess.Popen(
        [sys.executable, "-m", pkg, "worker", "--spec", spec_path],
        stdout=logf, stderr=subprocess.STDOUT, env=env)
    logf.close()     # the child holds its own fd
    return proc


def run_coordinated(calib_path: str, target: str, out_dir: str,
                    cfg: Config, steps: tuple[str, ...],
                    merged_name: str = "merged.ply",
                    stl_name: str = "model.stl", log=print, device=None):
    """Coordinate one scan across ``cfg.coordinator.workers`` local worker
    processes on ``device`` (None -> cuda), then assemble the final
    artifacts with a single-process ``run_pipeline`` pass over the warmed
    stage cache (workers=0 — no recursion). Returns that pass's
    PipelineReport with a ``coordinator`` summary dict attached."""
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import (
        stages,
    )
    from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (
        StageCache,
    )

    dev = resolve_device(device)
    n = int(cfg.coordinator.workers)
    t0 = time.monotonic()
    os.makedirs(out_dir, exist_ok=True)
    run_id = tel.new_run_id()
    budget = dl.Deadline.after(cfg.pipeline.run_budget_s,
                               "coordinated run")
    cache = StageCache(os.path.join(out_dir, ".slscan-cache"),
                       enabled=True, log=log,
                       verify=cfg.pipeline.verify_cache)
    if not cfg.pipeline.cache:
        # workers hand results over THROUGH the cache; a cache-off
        # coordinated run would compute everything twice for nothing
        log("[coord] NOTICE: pipeline.cache is off but coordinated mode "
            "requires the stage cache as the result channel — enabling it "
            "for this run")
        cfg = copy.deepcopy(cfg)
        cfg.pipeline.cache = True
    if dev.type == "cuda":
        # build (or find) the kernels once, here: N workers that each
        # found no library would each run nvcc
        from structured_light_for_3d_model_replication_tpu_torch.ops import (
            _build,
        )

        _build.load_library()
    steps = tuple(steps)
    calib, sources, view_keys, _ = stages._view_plan(
        calib_path, target, cfg, steps, cache, log, dev)

    ledger_path = os.path.join(out_dir, "ledger.jsonl")
    resume = Ledger.replay(ledger_path)
    if resume["completed"]:
        log(f"[coord] resume: ledger already credits "
            f"{len(resume['completed'])} completed item(s) across "
            f"{resume['segments']} segment(s) — zero recompute for those")
    items, view_done = _build_items(cfg, sources, view_keys, cache,
                                    resume["completed"])
    ledger = Ledger(ledger_path, run_id,
                    meta={"workers": n, "items": len(items),
                          "views": len(sources),
                          "resumed_completed": len(resume["completed"])})
    coord = _Coordinator(cfg, items, ledger, run_id, view_done, log)
    info = {"workers": n, "items_total": len(items),
            "resumed_completed": len(resume["completed"]),
            "ledger": ledger_path, "device": str(dev)}

    if not items:
        log("[coord] nothing to lease (cache + ledger cover every item); "
            "going straight to assembly")
        ledger.close()
        return _assemble(calib_path, target, out_dir, cfg, steps,
                         merged_name, stl_name, log, dev, coord, info, t0,
                         settled_unix=time.time())

    assembler = None
    if (cfg.merge.incremental and cfg.merge.stream
            and cfg.merge.method != "posegraph"):
        from structured_light_for_3d_model_replication_tpu_torch.pipeline import (
            assembly,
        )

        assembler = assembly.IncrementalAssembler(cfg, view_keys, cache, dev,
                                                  log=log)
        coord.assembler = assembler
        # pre-settled work (ledger resume + cache-hit views) folds now, so
        # the lane starts from the same state a fresh observer would see
        pre = sorted(set(view_done) | set(resume["completed"]))
        for iid in pre:
            assembler.note_item(iid)
        log(f"[coord] incremental assembly lane up "
            f"({len(pre)} pre-settled item(s) fed)")

    fabric = bool(cfg.coordinator.listen)
    server = _Server(coord, cfg.coordinator.port, log,
                     listen=cfg.coordinator.listen,
                     secret=cfg.coordinator.secret)
    blob = None
    if fabric:
        from structured_light_for_3d_model_replication_tpu_torch.pipeline.blobstore import (
            BlobServer,
        )

        blob = BlobServer(cache.root, host=server.host, port=0,
                          secret=cfg.coordinator.secret, log=log,
                          on_blob=(assembler.note_blob
                                   if assembler is not None else None))
        coord.blob_endpoint = blob.endpoint
    log(f"[coord] run {run_id}: {len(items)} item(s) "
        f"({sum(1 for i in items if i.kind == 'view')} view, "
        f"{sum(1 for i in items if i.kind == 'pair')} pair) across "
        f"{n} worker(s) on {dev}; lease {cfg.coordinator.lease_s:g}s, "
        + (f"listening on {server.endpoint} (blob {blob.endpoint}), "
           if fabric else f"port {server.port}, ")
        + f"ledger -> {ledger_path}")

    spec_dir = os.path.join(out_dir, ".coord")
    os.makedirs(spec_dir, exist_ok=True)
    wcfg = copy.deepcopy(cfg)
    wcfg.coordinator.workers = 0
    cfg_path = os.path.join(spec_dir, "cfg.json")
    wcfg.save(cfg_path)
    fabric_spec = None
    if fabric:
        fabric_spec = {"connect": server.endpoint,
                       "secret": cfg.coordinator.secret,
                       "blob": blob.endpoint}
        # the two-terminal walkthrough: `worker --spec
        # <out>/.coord/join.json` joins this run from another shell (or,
        # with listen on a routable address, another machine — copy the
        # spec and adjust the paths it names)
        join = {"config": cfg_path, "calib": calib_path, "target": target,
                "out": out_dir, "steps": list(steps), "port": server.port,
                "worker": "ext0", "num_workers": n, "device": str(dev),
                **fabric_spec,
                "cache_root": os.path.join(out_dir, ".slscan-cache.ext0")}
        with open(os.path.join(spec_dir, "join.json"), "w") as f:
            json.dump(join, f, indent=2)
    procs: dict[str, subprocess.Popen] = {}
    t_settled = None
    try:
        for r in range(n):
            procs[f"w{r}"] = _spawn_worker(
                r, n, server.port, spec_dir, cfg_path, calib_path, target,
                out_dir, steps, str(dev), fabric=fabric_spec)
        poll_s = max(0.05, min(0.5, cfg.coordinator.heartbeat_s / 4.0))
        reaped: set[str] = set()
        while not coord.done.is_set():
            if coord.crash is not None:
                raise coord.crash
            if budget is not None and budget.remaining() <= 0:
                raise dl.DeadlineExceeded(
                    f"coordinated run still has {coord.unsettled()} "
                    f"unsettled item(s) past the "
                    f"pipeline.run_budget_s={cfg.pipeline.run_budget_s:g}s "
                    f"budget")
            coord.sweep_expired()
            alive = 0
            for w, p in procs.items():
                rc = p.poll()
                if rc is None:
                    alive += 1
                elif w not in reaped:
                    reaped.add(w)
                    log(f"[coord] worker {w} (pid {p.pid}) exited rc={rc} "
                        f"with work unsettled — reclaiming its leases")
                    coord.drop_worker(w, f"worker-exit rc={rc}")
            # fabric runs may be fed by EXTERNAL workers the coordinator
            # never spawned (joined via coordinator.listen) — with one
            # seen, or with none spawned at all (n=0 waits for joins),
            # zero live children does not mean zero workers; lease expiry
            # + max_steals + the run budget still bound the run
            externals = any(w not in procs for w in coord.workers_seen)
            if (alive == 0 and not coord.done.is_set()
                    and not (fabric and (n == 0 or externals))):
                # no survivors: whatever is left can never be granted
                with coord.lock:
                    for iid in coord.order:
                        it = coord.items[iid]
                        if it.state not in _SETTLED:
                            it.state = "lost"
                            ledger.event("lost", item=iid,
                                         reason="no-workers")
                    coord._check_done()
                log("[coord] every worker is gone; remaining items marked "
                    "LOST — assembly recomputes them")
            coord.done.wait(poll_s)
        if coord.crash is not None:
            raise coord.crash
        t_settled = time.time()   # last item settled: the tail anchor
    except Exception as e:
        # abort contract: a run that dies during coordination must be
        # diagnosable from disk. InjectedCrash is a BaseException and
        # deliberately bypasses this — crash-safety (ledger + cache)
        # covers it instead.
        mpath = os.path.join(out_dir, tel.host_scoped("failures.json"))
        stages._write_json_atomic(mpath, {
            "run_id": run_id, "aborted": True, "degraded": False,
            "reason": str(e),
            "run_budget_s": cfg.pipeline.run_budget_s,
            "failures": [faults.FailureRecord.from_exception(
                "coordinator", "run", e).as_dict()],
        })
        log(f"[coord] ABORTED ({type(e).__name__}: {e}); "
            f"manifest -> {mpath}")
        raise
    finally:
        # bounded, idempotent teardown: survivors get shutdown on their
        # next poll; stragglers are terminated, then killed
        coord.done.set()
        deadline = dl.Deadline.after(
            max(2.0, 2 * cfg.coordinator.heartbeat_s), "worker drain")
        for p in procs.values():
            while p.poll() is None and deadline.remaining() > 0:
                time.sleep(0.05)
            if p.poll() is None:
                p.terminate()
        for p in procs.values():
            if p.poll() is None:
                try:
                    p.wait(timeout=1.0)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        if blob is not None:
            blob.close()
        server.close()
        if assembler is not None:
            assembler.close()
        ledger.close()

    with coord.lock:
        states = {}
        for it in coord.items.values():
            states[it.state] = states.get(it.state, 0) + 1
    info.update({
        "completed_by_worker": dict(coord.completed_by),
        "steals": coord.steal_count,
        "late_completes": coord.late_completes,
        "item_states": states,
        "worker_exit_codes": {w: p.returncode for w, p in procs.items()},
        "coordination_wall_s": round(time.monotonic() - t0, 3),
    })
    if coord.worker_addrs:
        info["worker_addrs"] = dict(coord.worker_addrs)
    if fabric:
        info["listen"] = server.endpoint
        info["fabric"] = blob.counters() if blob is not None else {}
        if coord.locality is not None:
            info.update(coord.locality.counters())
    lost = states.get("lost", 0) + states.get("failed", 0)
    prefold = None
    if assembler is not None:
        prefold = assembler.prefold(t_settled if t_settled is not None
                                    else time.time())
        info["assembly_lane"] = {"folded_views": prefold.offered_views,
                                 "folded_pairs": len(prefold.T_pairs)}
        log(f"[coord] assembly lane folded {prefold.offered_views}/"
            f"{len(sources)} view(s) before the last item settled")
    log(f"[coord] coordination done in {info['coordination_wall_s']:.2f}s: "
        f"{states} (steals={coord.steal_count}); "
        + (f"{lost} item(s) fall to assembly recompute; " if lost else "")
        + "assembling final artifacts single-process")
    return _assemble(calib_path, target, out_dir, cfg, steps, merged_name,
                     stl_name, log, dev, coord, info, t0, prefold=prefold,
                     settled_unix=t_settled)


def _assemble(calib_path, target, out_dir, cfg, steps, merged_name,
              stl_name, log, dev, coord, info, t0, prefold=None,
              settled_unix=None):
    """The assembly pass: the proven single-process pipeline over the
    warmed cache, on the coordinator's device. Every floor/degrade/abort
    rule runs HERE, on exactly the state a clean run on the survivors
    would see — which is the degraded ≡ clean-run-on-survivors
    byte-identity argument. A ``prefold`` (incremental assembly lane) only
    SEEDS the accumulate with already-validated state; everything it
    carries is re-validated against this pass's own order/digests/
    transforms before use."""
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import (
        stages,
    )

    acfg = copy.deepcopy(cfg)
    acfg.coordinator.workers = 0
    acfg.coordinator.listen = ""     # fabric is torn down; plain run now
    acfg.pipeline.cache = True
    report = stages.run_pipeline(calib_path, target, out_dir, cfg=acfg,
                                 steps=steps, merged_name=merged_name,
                                 stl_name=stl_name, log=log, device=dev,
                                 prefold=prefold)
    info["total_wall_s"] = round(time.monotonic() - t0, 3)
    anchor = (prefold.settled_unix if prefold is not None
              else settled_unix)
    asm = {"enabled": prefold is not None}
    if anchor is not None:
        # wall from last-item-settled to artifacts-on-disk
        asm["tail_s"] = round(time.time() - anchor, 3)
    if prefold is not None:
        asm["folded_views"] = prefold.offered_views
        asm["folded_pairs"] = len(prefold.T_pairs)
        if report.assembly:
            asm.update(report.assembly)
    info["assembly"] = asm
    report.coordinator = info
    return report
