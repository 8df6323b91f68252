"""Multi-scan admission control: the coordinator's work ledger across tenants.

``parallel/coordinator.py`` coordinates ONE scan's items across worker
processes. The serving gateway needs the same machinery one level up —
many tenants' scans multiplexing onto one device — so this module
generalizes the work ledger:

  - items gain a tenant/scan scope: ids are ``<scan_id>/view:<i>`` (the
    coordinator's ``view:<i>`` namespaced by scan), so one ledger and one
    lease table cover every in-flight request at once;
  - grants go through the SAME ``LeaseTable`` (grant / renew / steal /
    generation bump); the grantee is an in-process engine lane (or a fleet
    worker), and a lane that wedges past ``lease_s`` has its items swept
    back to pending exactly like a dead worker;
  - every submit / admit / grant / complete / failed / abort is journaled
    to the coordinator's fsync'd ``Ledger`` (schema ``sl3d-ledger-v1``)
    with ``tenant=``/``scan=`` fields.

What is new at this level is policy: per-tenant quotas (queued + active
caps; a submit over quota is REJECTED at the door, never silently queued)
and weighted-fair scheduling. Fairness is stride-style: every tenant
accumulates ``served / weight`` virtual time, and both scan admission and
item grants pick the eligible tenant with the lowest virtual time.

Durability policy lives here too: overload shedding (a queued scan whose
wait already blew its SLO, or ``max_queue_wait_s``, is shed with a
``shed`` ledger event before it wastes engine time), a per-tenant circuit
breaker (N consecutive failed/aborted scans open it; submits fast-fail
with a retry hint until a half-open probe closes it), and
``replay_serving``, the ledger fold a restarted gateway resumes from.

No HTTP, no device code, no stages import: policy stays unit-testable with
fake items and an injected clock. The port's copy of the JAX package's
``parallel/admission.py``: the same events, reason codes, schemas
(``sl3d-ledger-v1``, ``sl3d-tenants-v1``) and fold, so either package
replays the other's ledger and reads its ``tenants.json``.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import threading
import time

from structured_light_for_3d_model_replication_tpu_torch.parallel.coordinator import (
    LEDGER_SCHEMA,
    Ledger,
)
from structured_light_for_3d_model_replication_tpu_torch.parallel.lease import (
    LeaseTable,
)

__all__ = ["ScanJob", "AdmissionController", "replay_serving", "TERMINAL",
           "TenantAuth", "RateLimiter", "fold_usage", "hash_key",
           "write_tenant", "TENANTS_SCHEMA"]

# scan lifecycle (the request's /status surface):
#   queued -> admitted -> warmed -> assembling -> done|degraded|failed|aborted
# plus two durability states: ``shed`` (terminal — dropped from the queue
# before starting, it could no longer meet its SLO) and ``checkpointed``
# (NON-terminal — parked by a drain-budget breach; the next start()
# replays it back to queued with its warmed views already cached)
_TERMINAL = ("done", "degraded", "failed", "aborted", "rejected", "shed")
TERMINAL = _TERMINAL


class ScanJob:
    """One tenant's scan request, from submit to terminal state."""

    def __init__(self, scan_id: str, tenant: str, target: str,
                 calib: str, out_dir: str, weight: float = 1.0,
                 budget_s: float = 0.0, meta: dict | None = None):
        self.scan_id = scan_id
        self.tenant = tenant
        self.target = target
        self.calib = calib
        self.out_dir = out_dir
        self.weight = max(0.1, float(weight))
        self.budget_s = float(budget_s)      # 0 = no per-request SLO
        self.meta = dict(meta or {})
        self.state = "queued"
        self.error = ""
        self.submitted_mono = time.monotonic()
        self.submitted_unix = time.time()
        self.finished_mono: float | None = None
        self.report: dict = {}               # assembly summary for /status

    def elapsed_s(self) -> float:
        end = self.finished_mono or time.monotonic()
        return end - self.submitted_mono

    def budget_remaining(self) -> float | None:
        """Remaining per-request SLO budget, None when no budget armed.
        The clock starts at SUBMIT — queue wait burns budget too, which is
        what makes it a request SLO rather than a compute budget."""
        if self.budget_s <= 0:
            return None
        return self.budget_s - self.elapsed_s()

    def as_dict(self) -> dict:
        d = {"scan_id": self.scan_id, "tenant": self.tenant,
             "state": self.state, "elapsed_s": round(self.elapsed_s(), 3),
             "weight": self.weight, "budget_s": self.budget_s,
             "submitted_unix": self.submitted_unix}
        if self.error:
            d["error"] = self.error
        if self.report:
            d["report"] = self.report
        return d


class _Item:
    __slots__ = ("id", "scan_id", "tenant", "spec", "state")

    def __init__(self, id: str, scan_id: str, tenant: str, spec: dict):
        self.id = id
        self.scan_id = scan_id
        self.tenant = tenant
        self.spec = spec
        self.state = "pending"      # pending -> granted -> done|failed


class _Breaker:
    """One tenant's circuit-breaker state. closed: ``opened_at is None``;
    open: set to the monotonic open time; half-open: open past cooldown
    with ``probe`` holding the single in-flight probe scan_id."""

    __slots__ = ("fails", "opened_at", "probe")

    def __init__(self):
        self.fails = 0          # consecutive failed/aborted finishes
        self.opened_at: float | None = None
        self.probe: str | None = None


class AdmissionController:
    """Quotas + weighted-fair scheduling over the multi-scan ledger."""

    def __init__(self, ledger_path: str, run_id: str, lease_s: float = 30.0,
                 max_active_scans: int = 4, tenant_active_quota: int = 2,
                 tenant_queue_quota: int = 8, queue_depth: int = 64,
                 max_queue_wait_s: float = 0.0, breaker_threshold: int = 0,
                 breaker_cooldown_s: float = 30.0, clock=time.monotonic,
                 epoch=None, fence=None, log=print):
        self.lock = threading.RLock()
        self.log = log
        self.max_active_scans = int(max_active_scans)
        self.tenant_active_quota = int(tenant_active_quota)
        self.tenant_queue_quota = int(tenant_queue_quota)
        self.queue_depth = int(queue_depth)
        self.max_queue_wait_s = float(max_queue_wait_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self._clock = clock                      # injectable for tests
        self.leases = LeaseTable(lease_s)
        # HA: the gateway's election handle supplies ``epoch``
        # (stamps every journal line with the writer's fencing token) and
        # ``fence`` (rejects the append of a deposed leader). Solo
        # gateways pass neither and journal exactly as before.
        self.ledger = Ledger(ledger_path, run_id, meta={"mode": "serving"},
                             epoch=epoch, fence=fence)
        self.jobs: dict[str, ScanJob] = {}       # scan_id -> job
        self.queue: list[str] = []               # queued scan_ids, FIFO/tenant
        self.items: dict[str, _Item] = {}        # item id -> item
        self._scan_items: dict[str, list[str]] = {}
        self._vtime: dict[str, float] = {}       # tenant -> virtual time
        self._breakers: dict[str, _Breaker] = {}
        self._seq = itertools.count(1)

    # ---- submit / quotas -------------------------------------------------

    def submit(self, job: ScanJob, persist=None) -> tuple[bool, dict]:
        """Admit-or-reject at the door. Over-quota submissions are refused
        with a machine-readable ``reason`` (the gateway's 429/503), never
        silently queued — a rejected request costs the service nothing.
        ``persist``, when given, runs AFTER every check passes and BEFORE
        the scan is journaled or queued (the durable-record write: if it
        raises, nothing was admitted and the caller can 503-retry)."""
        with self.lock:
            allowed, info, is_probe = self._breaker_check(job.tenant)
            if not allowed:
                return False, info
            queued = [j for j in self.jobs.values() if j.state == "queued"]
            if len(queued) >= self.queue_depth:
                return False, {"reason": "queue-full",
                               "error": (f"service queue full "
                                         f"({self.queue_depth} queued)")}
            t_queued = sum(1 for j in queued if j.tenant == job.tenant)
            if t_queued >= self.tenant_queue_quota:
                return False, {"reason": "tenant-queue-quota",
                               "error": (f"tenant {job.tenant!r} queue "
                                         f"quota reached "
                                         f"({self.tenant_queue_quota})")}
            if persist is not None:
                persist(job)
            # journal BEFORE any in-memory mutation: a failed append
            # (full disk, injected transient) leaves nothing admitted, so
            # the caller's "retry" answer is actually true
            self.ledger.event("submit", scan=job.scan_id, tenant=job.tenant,
                              target=job.target, calib=job.calib,
                              out_dir=job.out_dir, weight=job.weight,
                              budget_s=job.budget_s)
            self.jobs[job.scan_id] = job
            self.queue.append(job.scan_id)
            self._vtime.setdefault(job.tenant, self._min_vtime())
            if is_probe:
                self._breakers[job.tenant].probe = job.scan_id
                self.ledger.event("breaker-probe", scan=job.scan_id,
                                  tenant=job.tenant)
        return True, {"reason": "queued"}

    # ---- circuit breaker -------------------------------------------------

    def _breaker_check(self, tenant: str) -> tuple[bool, dict, bool]:
        """(allowed, rejection-info, is_half_open_probe). Caller holds the
        lock. An open breaker fast-fails submits with the cooldown
        remainder as the retry hint; once cooled down, exactly ONE probe
        scan is let through and its outcome closes or re-opens."""
        if self.breaker_threshold <= 0:
            return True, {}, False
        b = self._breakers.get(tenant)
        if b is None or b.opened_at is None:
            return True, {}, False
        waited = self._clock() - b.opened_at
        if waited < self.breaker_cooldown_s:
            rem = self.breaker_cooldown_s - waited
            return False, {"reason": "circuit-open",
                           "retry_after_s": round(max(0.001, rem), 3),
                           "error": (f"tenant {tenant!r} circuit open "
                                     f"({b.fails} consecutive failures); "
                                     f"retry in {rem:.1f}s")}, False
        if b.probe is not None:
            return False, {"reason": "circuit-open",
                           "retry_after_s": round(self.breaker_cooldown_s,
                                                  3),
                           "error": (f"tenant {tenant!r} circuit half-open"
                                     f"; probe {b.probe!r} in flight")}, \
                False
        return True, {}, True

    def _breaker_record(self, job: ScanJob, state: str) -> None:
        """Fold one terminal outcome into the tenant's breaker. Caller
        holds the lock. Shed/checkpointed scans never count — they carry
        no evidence about the tenant's inputs."""
        if self.breaker_threshold <= 0:
            return
        b = self._breakers.setdefault(job.tenant, _Breaker())
        if state in ("done", "degraded"):
            b.fails = 0
            if b.opened_at is not None:
                b.opened_at = None
                b.probe = None
                self.ledger.event("breaker-close", tenant=job.tenant,
                                  scan=job.scan_id)
        elif state in ("failed", "aborted"):
            if b.opened_at is not None and b.probe == job.scan_id:
                b.probe = None
                b.opened_at = self._clock()
                self.ledger.event("breaker-open", tenant=job.tenant,
                                  scan=job.scan_id, reason="probe-failed",
                                  fails=b.fails)
            else:
                b.fails += 1
                if (b.opened_at is None
                        and b.fails >= self.breaker_threshold):
                    b.opened_at = self._clock()
                    self.ledger.event("breaker-open", tenant=job.tenant,
                                      scan=job.scan_id, fails=b.fails)

    def restore_breaker(self, tenant: str, fails: int) -> None:
        """Re-arm a tenant's breaker from a replayed failure streak (a
        restart must not grant a broken tenant a fresh threshold)."""
        if self.breaker_threshold <= 0 or fails <= 0:
            return
        with self.lock:
            b = self._breakers.setdefault(tenant, _Breaker())
            b.fails = int(fails)
            if b.fails >= self.breaker_threshold and b.opened_at is None:
                b.opened_at = self._clock()
                self.ledger.event("breaker-open", tenant=tenant,
                                  fails=b.fails, reason="restored")

    def _min_vtime(self) -> float:
        """New tenants join at the floor of current virtual time so they
        can't bank unfair credit from before they existed."""
        return min(self._vtime.values(), default=0.0)

    def _active(self) -> list[ScanJob]:
        return [j for j in self.jobs.values()
                if j.state in ("admitted", "warmed", "assembling")]

    # ---- weighted-fair admission ----------------------------------------

    def admit_next(self) -> list[ScanJob]:
        """Move queued scans into the admitted set while capacity allows,
        picking the lowest-virtual-time tenant each round. Returns the
        newly admitted jobs (the engine plans their items)."""
        out: list[ScanJob] = []
        with self.lock:
            while True:
                active = self._active()
                if len(active) >= self.max_active_scans:
                    break
                per_tenant: dict[str, int] = {}
                for j in active:
                    per_tenant[j.tenant] = per_tenant.get(j.tenant, 0) + 1
                eligible: dict[str, str] = {}    # tenant -> first scan_id
                for sid in self.queue:
                    j = self.jobs[sid]
                    if j.tenant in eligible:
                        continue
                    if (per_tenant.get(j.tenant, 0)
                            >= self.tenant_active_quota):
                        continue
                    eligible[j.tenant] = sid
                if not eligible:
                    break
                tenant = min(eligible,
                             key=lambda t: (self._vtime.get(t, 0.0), t))
                sid = eligible[tenant]
                self.queue.remove(sid)
                job = self.jobs[sid]
                job.state = "admitted"
                self.ledger.event("admit", scan=sid, tenant=tenant,
                                  wait_s=round(job.elapsed_s(), 3))
                out.append(job)
        return out

    # ---- items -----------------------------------------------------------

    def add_items(self, scan_id: str, specs: list[dict]) -> list[str]:
        """Register a newly admitted scan's work items (one per cache-miss
        view). Ids are ``<scan_id>/view:<i>`` — the coordinator's item ids
        namespaced by scan, so one ledger covers every tenant."""
        job = self.jobs[scan_id]
        ids = []
        with self.lock:
            for spec in specs:
                iid = f"{scan_id}/view:{spec['index']}"
                self.items[iid] = _Item(iid, scan_id, job.tenant, spec)
                ids.append(iid)
            self._scan_items[scan_id] = list(ids)
            self.ledger.event("plan", scan=scan_id, tenant=job.tenant,
                              items=len(ids))
        return ids

    def next_views(self, lane: str, max_n: int) -> list[tuple[str, int, dict]]:
        """Grant up to ``max_n`` pending view items to an engine lane,
        interleaved weighted-fair across tenants — THE cross-tenant
        batching hook: one bucket launch is assembled from exactly one of
        these grant sets, so views from different scans fill the same
        launch whenever more than one tenant has pending work. Returns
        [(item_id, lease_gen, spec), ...]; charges each grant to its
        tenant's virtual time."""
        grants: list[tuple[str, int, dict]] = []
        with self.lock:
            self.leases.renew(lane)
            pending: dict[str, list[_Item]] = {}
            for iid in sorted(self.items):
                it = self.items[iid]
                if it.state == "pending":
                    pending.setdefault(it.tenant, []).append(it)
            while len(grants) < max_n and pending:
                tenant = min(pending,
                             key=lambda t: (self._vtime.get(t, 0.0), t))
                it = pending[tenant].pop(0)
                if not pending[tenant]:
                    del pending[tenant]
                lease = self.leases.grant(it.id, lane)
                it.state = "granted"
                w = self.jobs[it.scan_id].weight
                self._vtime[tenant] = self._vtime.get(tenant, 0.0) + 1.0 / w
                self.ledger.event("grant", item=it.id, scan=it.scan_id,
                                  tenant=tenant, worker=lane,
                                  gen=lease.gen)
                grants.append((it.id, lease.gen, it.spec))
        return grants

    def beat(self, lane: str) -> int:
        return self.leases.renew(lane)

    def complete(self, item_id: str, lane: str, gen: int) -> bool:
        with self.lock:
            it = self.items.get(item_id)
            accepted = self.leases.complete(item_id, lane, gen)
            if accepted and it is not None:
                it.state = "done"
                self.ledger.event("complete", item=item_id,
                                  scan=it.scan_id, tenant=it.tenant,
                                  worker=lane, gen=gen)
            elif it is not None:
                self.ledger.event("late-complete", item=item_id,
                                  scan=it.scan_id, worker=lane, gen=gen)
            return accepted

    def failed(self, item_id: str, lane: str, gen: int,
               error: str = "") -> None:
        """A failed item settles as failed and is NOT retried here — the
        assembly pass recomputes it through the full per-view
        retry/quarantine lane, so failure policy lives in exactly one
        place, the coordinator's construction)."""
        with self.lock:
            it = self.items.get(item_id)
            self.leases.complete(item_id, lane, gen)
            if it is not None and it.state != "done":
                it.state = "failed"
                self.ledger.event("failed", item=item_id, scan=it.scan_id,
                                  tenant=it.tenant, worker=lane,
                                  error=str(error)[:500])

    def sweep_expired(self) -> int:
        """Steal expired lane leases back to pending (a wedged engine lane
        is the in-process twin of a dead worker)."""
        n = 0
        for lease in self.leases.expired():
            with self.lock:
                it = self.items.get(lease.item)
                if it is None or it.state != "granted":
                    continue
                gen = self.leases.steal(lease.item)
                it.state = "pending"
                self.ledger.event("steal", item=lease.item,
                                  worker=lease.worker, gen=gen,
                                  reason="lease-expired")
                n += 1
        return n

    def drop_lane(self, lane: str, reason: str = "worker-dead") -> int:
        """Immediately steal everything a dead lane/worker holds back to
        pending — the fleet supervisor's fast path when it REAPS a worker
        (no need to wait ``lease_s`` for the leases to age out). Safe by
        the same construction as sweep_expired: the steal bumps each
        item's generation, so a late complete from the corpse is refused
        by the exact-triple match."""
        n = 0
        with self.lock:
            for item_id in self.leases.drop_worker(lane):
                it = self.items.get(item_id)
                if it is None or it.state != "granted":
                    continue
                it.state = "pending"
                self.ledger.event("steal", item=item_id, worker=lane,
                                  gen=self.leases.gen(item_id),
                                  reason=reason)
                n += 1
        return n

    def open_breakers(self) -> int:
        """How many tenants currently have an OPEN circuit breaker — one
        of the fleet supervisor's scale signals (a breaker storm means
        failures, not load; scaling out would add fuel)."""
        with self.lock:
            return sum(1 for b in self._breakers.values()
                       if b.opened_at is not None)

    def signals(self) -> dict:
        """One consistent snapshot of the live scale signals the fleet
        supervisor decides from. Everything here is already
        exported via /metrics — this is the same data read under one
        lock so a decision journals a coherent snapshot."""
        with self.lock:
            pending = granted = 0
            for it in self.items.values():
                if it.state == "pending":
                    pending += 1
                elif it.state == "granted":
                    granted += 1
            waits = [self.jobs[sid].elapsed_s() for sid in self.queue]
            waits.sort()

            def pct(p: float) -> float:
                if not waits:
                    return 0.0
                i = min(len(waits) - 1, int(p * (len(waits) - 1)))
                return round(waits[i], 3)

            return {"queued_scans": len(self.queue),
                    "active_scans": len(self._active()),
                    "pending_items": pending,
                    "granted_items": granted,
                    "queue_wait_p50_s": pct(0.5),
                    "queue_wait_p99_s": pct(0.99),
                    "open_breakers": sum(
                        1 for b in self._breakers.values()
                        if b.opened_at is not None)}

    def scan_settled(self, scan_id: str) -> bool:
        """True when every item of ``scan_id`` is done or failed — the
        scan is WARMED and ready for its assembly pass."""
        with self.lock:
            return all(self.items[iid].state in ("done", "failed")
                       for iid in self._scan_items.get(scan_id, []))

    def scan_item_states(self, scan_id: str) -> dict:
        with self.lock:
            out: dict[str, int] = {}
            for iid in self._scan_items.get(scan_id, []):
                s = self.items[iid].state
                out[s] = out.get(s, 0) + 1
            return out

    # ---- terminal transitions -------------------------------------------

    def finish(self, scan_id: str, state: str, error: str = "",
               report: dict | None = None) -> None:
        with self.lock:
            job = self.jobs[scan_id]
            job.state = state
            job.error = error
            job.finished_mono = time.monotonic()
            if report:
                job.report = report
            for iid in self._scan_items.pop(scan_id, []):
                self.items.pop(iid, None)
            # the report summary rides the finish event so a restarted
            # service can serve /status for already-terminal scans
            # straight from the replayed ledger
            self.ledger.event("finish", scan=scan_id, tenant=job.tenant,
                              state=state, error=str(error)[:500],
                              elapsed_s=round(job.elapsed_s(), 3),
                              report=job.report or {})
            self._breaker_record(job, state)

    def checkpoint(self, scan_id: str, reason: str = "drain") -> bool:
        """Park a non-terminal scan at drain time: its items are dropped
        (warmed views live on in the stage cache — that work is kept),
        the state goes CHECKPOINTED, and the journaled event tells the
        next start() to replay it back into the queue."""
        with self.lock:
            job = self.jobs.get(scan_id)
            if job is None or job.state in _TERMINAL:
                return False
            if scan_id in self.queue:
                self.queue.remove(scan_id)
            job.state = "checkpointed"
            job.error = reason
            for iid in self._scan_items.pop(scan_id, []):
                self.items.pop(iid, None)
            self.ledger.event("checkpoint", scan=scan_id,
                              tenant=job.tenant, reason=reason)
            return True

    def shed_expired(self) -> list[ScanJob]:
        """Drop queued scans that can no longer start usefully: their SLO
        budget is already gone, or they out-waited ``max_queue_wait_s``.
        Shedding at the queue head is the overload valve — a scan that
        would only burn engine time to abort later is refused work NOW,
        while the client can still retry elsewhere."""
        out: list[ScanJob] = []
        with self.lock:
            for sid in list(self.queue):
                job = self.jobs[sid]
                wait = job.elapsed_s()
                rem = job.budget_remaining()
                if rem is not None and rem <= 0:
                    reason = (f"queue wait {wait:.1f}s consumed the "
                              f"{job.budget_s:g}s SLO budget")
                elif 0 < self.max_queue_wait_s < wait:
                    reason = (f"queue wait {wait:.1f}s exceeded "
                              f"max_queue_wait_s="
                              f"{self.max_queue_wait_s:g}")
                else:
                    continue
                self.queue.remove(sid)
                job.state = "shed"
                job.error = reason
                job.finished_mono = time.monotonic()
                self.ledger.event("shed", scan=sid, tenant=job.tenant,
                                  reason=reason, wait_s=round(wait, 3))
                out.append(job)
        return out

    # ---- restart-resume --------------------------------------------------

    def restore(self, job: ScanJob) -> None:
        """Re-enqueue a replayed non-terminal scan, bypassing the door
        quotas — a previous incarnation of the service already accepted
        (and journaled) it; refusing it now would break the 202 the
        client holds. Journals a ``resume`` event so the ledger reads as
        the scan's full history across process generations."""
        with self.lock:
            job.state = "queued"
            self.jobs[job.scan_id] = job
            self.queue.append(job.scan_id)
            self._vtime.setdefault(job.tenant, self._min_vtime())
            self.ledger.event("resume", scan=job.scan_id,
                              tenant=job.tenant)

    def restore_terminal(self, job: ScanJob) -> None:
        """Re-register an already-terminal scan (state set by the caller
        from the replayed ledger) so /status and /result keep answering
        across restarts. Nothing to journal — nothing changed."""
        with self.lock:
            self.jobs[job.scan_id] = job

    def snapshot(self) -> dict:
        with self.lock:
            states: dict[str, int] = {}
            for j in self.jobs.values():
                states[j.state] = states.get(j.state, 0) + 1
            return {"scans": {sid: j.as_dict()
                              for sid, j in self.jobs.items()},
                    "states": states,
                    "queued": len(self.queue),
                    "active": len(self._active()),
                    "vtime": dict(self._vtime)}

    def close(self) -> None:
        self.ledger.close()


def replay_serving(path: str) -> dict:
    """Fold a serving ledger into restart-resume state. Torn-tail
    tolerant like :meth:`Ledger.replay` (a crash mid-append loses at most
    the line being written), and a superset of it: besides the union of
    completed item ids this folds each scan's LAST journaled state —
    submit → queued, admit → admitted, warmed, finish → its terminal
    state (with error/report), shed, checkpoint → checkpointed, resume →
    queued again — plus each tenant's consecutive failed/aborted streak,
    so circuit breakers survive restarts.

    Epoch fencing: HA gateways stamp every line with the
    writer's election epoch. The fold tracks the newest epoch seen so
    far and IGNORES any later line carrying an older one — the append a
    zombie leader raced past the live fence cannot resurrect state or
    credit items the new leader's segment already owns. Lines without an
    epoch (solo gateways, pre-HA ledgers) are never fenced. Returns::

        {"scans": {scan_id: {"tenant", "state", "target", "calib",
                             "out_dir", "weight", "budget_s",
                             "submitted_unix", "error", "report",
                             "elapsed_s"}},
         "completed": set[item_id], "tenant_fails": {tenant: int},
         "segments": int, "events": int,
         "max_epoch": int, "stale_ignored": int}
    """
    scans: dict[str, dict] = {}
    completed: set[str] = set()
    tenant_fails: dict[str, int] = {}
    segments = events = 0
    max_epoch = stale_ignored = 0
    if not os.path.exists(path):
        return {"scans": scans, "completed": completed,
                "tenant_fails": tenant_fails, "segments": 0, "events": 0,
                "max_epoch": 0, "stale_ignored": 0}

    def rec_for(rec: dict) -> dict:
        sid = rec["scan"]
        r = scans.get(sid)
        if r is None:
            r = scans[sid] = {"tenant": rec.get("tenant", ""),
                              "state": "queued", "target": "",
                              "calib": "", "out_dir": "", "weight": 1.0,
                              "budget_s": 0.0, "submitted_unix": 0.0,
                              "error": "", "report": {},
                              "elapsed_s": 0.0}
        return r

    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue        # torn tail from a crash mid-append
            e = ev.get("epoch")
            if e is not None:
                e = int(e)
                if e < max_epoch:
                    stale_ignored += 1   # fenced-out zombie append
                    continue
                max_epoch = e
            t = ev.get("type")
            if t == "meta":
                if ev.get("schema") != LEDGER_SCHEMA:
                    raise ValueError(
                        f"ledger {path}: unknown schema "
                        f"{ev.get('schema')!r} (want {LEDGER_SCHEMA})")
                segments += 1
                continue
            events += 1
            if t == "complete":
                completed.add(ev["item"])
                continue
            if "scan" not in ev:
                continue
            if t == "submit":
                r = rec_for(ev)
                r.update(state="queued",
                         target=ev.get("target", ""),
                         calib=ev.get("calib", ""),
                         out_dir=ev.get("out_dir", ""),
                         weight=float(ev.get("weight", 1.0)),
                         budget_s=float(ev.get("budget_s", 0.0)),
                         submitted_unix=float(ev.get("t", 0.0)))
            elif t == "admit":
                rec_for(ev)["state"] = "admitted"
            elif t == "warmed":
                rec_for(ev)["state"] = "warmed"
            elif t == "finish":
                r = rec_for(ev)
                r.update(state=ev.get("state", "failed"),
                         error=ev.get("error", ""),
                         report=ev.get("report") or {},
                         elapsed_s=float(ev.get("elapsed_s", 0.0)))
            elif t == "shed":
                r = rec_for(ev)
                r.update(state="shed", error=ev.get("reason", ""))
            elif t == "checkpoint":
                rec_for(ev)["state"] = "checkpointed"
            elif t == "resume":
                rec_for(ev)["state"] = "queued"
            if t in ("finish", "shed"):
                tenant = ev.get("tenant", "")
                st = ev.get("state", "shed" if t == "shed" else "")
                if st in ("failed", "aborted"):
                    tenant_fails[tenant] = tenant_fails.get(tenant, 0) + 1
                elif st in ("done", "degraded"):
                    tenant_fails[tenant] = 0
    return {"scans": scans, "completed": completed,
            "tenant_fails": tenant_fails, "segments": segments,
            "events": events, "max_epoch": max_epoch,
            "stale_ignored": stale_ignored}


def fold_usage(rs: dict) -> dict:
    """Per-tenant usage metering folded from a :func:`replay_serving`
    result: the /usage surface. Metering reads the SAME
    epoch-fenced fold that restart-resume and the follower read model
    use, so a bill can never disagree with what the service actually
    credited — and a zombie leader's fenced-out lines never meter.

    Returns ``{tenant: {"submitted", "done", "degraded", "failed",
    "aborted", "shed", "in_flight", "views_completed", "compute_s"}}``
    where ``compute_s`` sums terminal scans' elapsed_s (queue wait burns
    SLO budget, so it bills — the same clock /status reports)."""
    usage: dict[str, dict] = {}

    def row(tenant: str) -> dict:
        r = usage.get(tenant)
        if r is None:
            r = usage[tenant] = {"submitted": 0, "done": 0, "degraded": 0,
                                 "failed": 0, "aborted": 0, "shed": 0,
                                 "in_flight": 0, "views_completed": 0,
                                 "compute_s": 0.0}
        return r

    scan_tenant: dict[str, str] = {}
    for sid, r in rs["scans"].items():
        tenant = r.get("tenant", "") or "anon"
        scan_tenant[sid] = tenant
        u = row(tenant)
        u["submitted"] += 1
        state = r.get("state", "")
        if state in ("done", "degraded", "failed", "aborted", "shed"):
            u[state] += 1
            u["compute_s"] = round(
                u["compute_s"] + float(r.get("elapsed_s", 0.0)), 3)
        elif state != "rejected":
            u["in_flight"] += 1
    for item_id in rs["completed"]:
        sid = item_id.rsplit("/", 1)[0]
        tenant = scan_tenant.get(sid)
        if tenant is not None:
            row(tenant)["views_completed"] += 1
    return usage


# ---- front-door auth -------------------------------------------------------

TENANTS_SCHEMA = "sl3d-tenants-v1"


def hash_key(key: str) -> str:
    """sha256 of an API key — the only form ever at rest or compared."""
    return hashlib.sha256(key.encode("utf-8")).hexdigest()


class TenantAuth:
    """Per-tenant API keys, verified against sha256 hashes at rest in
    ``<root>/tenants.json`` (``tenant add`` writes it; the plaintext
    key is printed exactly once at creation). The file is re-read only
    when its stat changes — key rotation needs no restart — and a
    missing/unreadable file with auth enabled fails CLOSED (every submit
    401s) rather than silently opening the door."""

    def __init__(self, path: str, clock=time.monotonic):
        self.path = path
        self._clock = clock
        self._lock = threading.Lock()
        self._stat: tuple | None = None
        self._tenants: dict[str, dict] = {}

    def _load(self) -> dict[str, dict]:
        try:
            st = os.stat(self.path)
            key = (st.st_mtime_ns, st.st_size, st.st_ino)
        except OSError:
            key = None
        with self._lock:
            if key is not None and key == self._stat:
                return self._tenants
            tenants: dict[str, dict] = {}
            if key is not None:
                try:
                    with open(self.path, encoding="utf-8") as f:
                        doc = json.load(f)
                    if doc.get("schema") == TENANTS_SCHEMA:
                        tenants = dict(doc.get("tenants") or {})
                except (OSError, ValueError):
                    tenants = {}     # unreadable = no keys = fail closed
            self._stat = key
            self._tenants = tenants
            return tenants

    def known(self) -> list[str]:
        return sorted(self._load())

    def tenant_limits(self, tenant: str) -> tuple[int, float] | None:
        """Per-tenant (rate_limit, rate_window_s) override from
        tenants.json, None when the tenant carries none."""
        rec = self._load().get(tenant)
        if rec is None or "rate_limit" not in rec:
            return None
        return (int(rec.get("rate_limit", 0)),
                float(rec.get("rate_window_s", 60.0)))

    def check(self, tenant: str, key: str) -> dict | None:
        """None = authenticated; otherwise a machine-readable rejection
        body (``reason`` ∈ auth-required | auth-invalid | auth-forbidden
        — the gateway maps them to 401/401/403). A key that IS valid for
        a different tenant is 403 (we know who you are — you may not act
        as someone else); an unknown key is 401."""
        if not key:
            return {"reason": "auth-required",
                    "error": "missing API key (X-API-Key header or "
                             "api_key field)"}
        tenants = self._load()
        h = hash_key(key)
        rec = tenants.get(tenant)
        if rec is not None and rec.get("key_sha256") == h:
            return None
        for other, orec in tenants.items():
            if orec.get("key_sha256") == h:
                return {"reason": "auth-forbidden",
                        "error": f"key belongs to tenant {other!r}, "
                                 f"not {tenant!r}"}
        return {"reason": "auth-invalid",
                "error": f"unknown API key for tenant {tenant!r}"}


def write_tenant(path: str, tenant: str, key: str,
                 rate_limit: int | None = None,
                 rate_window_s: float | None = None) -> None:
    """Add/update one tenant's hashed key in ``tenants.json`` (atomic
    rewrite; creates the file). CLI-facing — the server only reads."""
    from structured_light_for_3d_model_replication_tpu_torch.io.atomic import (
        atomic_write,
    )

    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if doc.get("schema") != TENANTS_SCHEMA:
            doc = {"schema": TENANTS_SCHEMA, "tenants": {}}
    except (OSError, ValueError):
        doc = {"schema": TENANTS_SCHEMA, "tenants": {}}
    rec = doc["tenants"].setdefault(tenant, {})
    rec["key_sha256"] = hash_key(key)
    if rate_limit is not None:
        rec["rate_limit"] = int(rate_limit)
    if rate_window_s is not None:
        rec["rate_window_s"] = float(rate_window_s)
    with atomic_write(path) as tmp:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())


class RateLimiter:
    """Per-tenant sliding-window submit limiter, expressed in the quota
    vocabulary: over the limit answers ``rate-limited`` + retry_after_s
    (HTTP 429), exactly like ``tenant-queue-quota``. Injectable clock —
    the 429 matrix unit-tests with zero real sleeps."""

    def __init__(self, limit: int, window_s: float = 60.0,
                 clock=time.monotonic):
        self.limit = int(limit)
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._hits: dict[str, list[float]] = {}   # tenant -> admit times

    def allow(self, tenant: str,
              limit: int | None = None,
              window_s: float | None = None) -> dict | None:
        """None = allowed (and counted); otherwise the rejection body.
        Per-tenant overrides (tenants.json) ride in as arguments."""
        lim = self.limit if limit is None else int(limit)
        win = self.window_s if window_s is None else float(window_s)
        if lim <= 0:
            return None
        now = self._clock()
        with self._lock:
            hits = self._hits.setdefault(tenant, [])
            cut = now - win
            while hits and hits[0] <= cut:
                hits.pop(0)
            if len(hits) >= lim:
                retry = max(0.001, hits[0] + win - now)
                return {"reason": "rate-limited",
                        "retry_after_s": round(retry, 3),
                        "error": (f"tenant {tenant!r} over rate limit "
                                  f"({lim} submits per {win:g}s)")}
            hits.append(now)
            return None
