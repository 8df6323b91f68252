"""Elastic worker fleet: the leader gateway as fabric coordinator.

The LEADER gateway (or a solo one) owns a :class:`FleetSupervisor` that

  signal    samples the admission controller's live scale signals once
            per tick under one lock (queue depth, pending grantable
            items, queue-wait p50/p99, open breakers — the numbers
            /metrics exports), so every decision journals a coherent
            snapshot of WHY;
  decide    runs the pure :func:`decide` over that snapshot: scale up
            toward ceil(backlog / fleet_scale_up_queue) clamped into
            [fleet_min_workers, fleet_max_workers], never scale in while
            any work is queued/active, retire to the floor only after
            ``fleet_scale_in_idle_s`` of idleness (hysteresis), and never
            scale UP on a breaker storm (failures are not load);
  enact     spawns ``worker --spec`` processes of this package (rank-named
            ``fw0, fw1, ...``) on the service's device, which dial a
            :class:`_FleetBridge` — the coordinator wire protocol (its
            ``_Server``, reused as is) adapted onto the admission
            controller, so fleet workers drain the SAME weighted-fair grant
            pool as the in-process engine lanes. Their grants carry the
            scan's calib path (a fleet worker hops between tenants' scans)
            and their completes warm the SAME content-addressed store the
            assembly pass reads, so the bytes are a solo run's, and
            scale-in is safe: a retired or killed worker just loses its
            leases, the items steal back to pending, and the bytes it did
            put stay valid cache entries;
  journal   writes every decision — scale-up, scale-in, spawn, respawn,
            retire, worker-exit, spawn-failed — to the SAME fsync'd,
            epoch-fenced ledger as the admission events, with the deciding
            signal snapshot attached. :func:`replay_fleet` folds it back
            (stale epochs ignored) so a promoted follower resumes the
            fleet its predecessor ran;
  heal      detects worker death through ``Popen.poll`` and the lease
            machinery (a dead worker's leases are dropped at once —
            ``drop_lane`` steals its items back with a generation bump, so
            the corpse's late completes are refused), then respawns the
            RANK under a capped exponential backoff; a rank that dies
            ``fleet_flap_threshold`` times inside ``fleet_flap_window_s``
            is FLAPPING and holds at the max backoff until the window
            drains. Respawns reuse the rank and bump a GENERATION stamp
            carried in the worker spec, hello and trace meta.

Epoch fencing: the supervisor belongs to one reign. Its journal writes go
through the admission ledger's fence (a deposed leader's append raises
``FencedWrite``: the supervisor stops and the service demotes), and it
polls :meth:`LeaderLease.superseded` at the top of every tick — spawn and
retire are side effects no ledger fence can un-run, so a zombie supervisor
must stop DECIDING the moment the takeover lands.

Each worker is its own process and, on CUDA, its own CUDA context; a worker
spec that names CUDA on a host without it raises before the worker joins.
The supervisor reaps every child it started (``close``).

Chaos sites: ``fleet.decide`` fires before each decision (a transient
skips the tick, an injected crash fells the service like an engine-loop
crash) and ``worker.spawn`` fires between the journaled spawn decision and
the ``Popen`` (a transient schedules a backoff retry; a crash is the
supervisor dying mid-action — the journaled-but-unspawned rank is what
resume respawns).

The port's copy of the JAX package's ``parallel/fleet.py``: the same
decisions, schedules and ledger events, so either package folds the
other's fleet journal.
"""
from __future__ import annotations

import copy
import json
import os
import threading
import time

from structured_light_for_3d_model_replication_tpu_torch.parallel import (
    coordinator as coord_mod,
)
from structured_light_for_3d_model_replication_tpu_torch.parallel import election
from structured_light_for_3d_model_replication_tpu_torch.parallel import netutil
from structured_light_for_3d_model_replication_tpu_torch.utils import faults

__all__ = ["FleetSupervisor", "FlapTracker", "decide", "replay_fleet",
           "FleetParams"]


class FleetParams:
    """The decision function's knobs, lifted from ``ServingConfig`` so
    :func:`decide` stays a pure function unit-testable without a config
    object (the lease.py discipline)."""

    __slots__ = ("min_workers", "max_workers", "scale_up_queue",
                 "scale_in_idle_s")

    def __init__(self, min_workers: int = 0, max_workers: int = 4,
                 scale_up_queue: int = 4, scale_in_idle_s: float = 5.0):
        self.min_workers = max(0, int(min_workers))
        self.max_workers = max(self.min_workers, int(max_workers))
        self.scale_up_queue = max(1, int(scale_up_queue))
        self.scale_in_idle_s = float(scale_in_idle_s)

    @classmethod
    def from_serving(cls, scfg) -> "FleetParams":
        return cls(min_workers=scfg.fleet_min_workers,
                   max_workers=scfg.fleet_max_workers,
                   scale_up_queue=scfg.fleet_scale_up_queue,
                   scale_in_idle_s=scfg.fleet_scale_in_idle_s)


def decide(sig: dict, live: int, idle_s: float, p: FleetParams) -> dict:
    """One scaling decision from one signal snapshot. Pure — no clock, no
    I/O; ``idle_s`` is how long the caller has observed the service fully
    idle. Returns ``{"action": "scale-up"|"scale-in"|"hold", "target",
    "reason"}`` where ``target`` is the worker count to converge on.

    Rules, in order:
      - never drop below the floor: ``live < min_workers`` scales up
        regardless of load;
      - a breaker storm (open breakers, no backlog growth to serve)
        never scales UP — failures are not load;
      - backlog scales up toward ``ceil(pending / scale_up_queue)`` plus
        one worker per queued-but-unplanned scan, clamped to the cap;
      - any work in flight (pending, granted, queued, active) HOLDS —
        scale-in under load would thrash;
      - a fully idle service retires to the floor only after
        ``scale_in_idle_s`` of continuous idleness (hysteresis).
    """
    backlog = int(sig.get("pending_items", 0))
    queued = int(sig.get("queued_scans", 0))
    active = int(sig.get("active_scans", 0))
    granted = int(sig.get("granted_items", 0))
    breakers = int(sig.get("open_breakers", 0))
    lo, hi = p.min_workers, p.max_workers
    if live < lo:
        return {"action": "scale-up", "target": lo,
                "reason": f"below floor ({live} < {lo})"}
    if backlog or queued:
        desired = (backlog + p.scale_up_queue - 1) // p.scale_up_queue
        desired += queued          # each unplanned scan will add items
        desired = max(lo, min(hi, desired))
        if desired > live:
            if breakers:
                return {"action": "hold", "target": live,
                        "reason": (f"{breakers} open breaker(s): "
                                   f"failures are not load")}
            return {"action": "scale-up", "target": desired,
                    "reason": (f"backlog {backlog} item(s) + {queued} "
                               f"queued scan(s) wants {desired} "
                               f"(p99 wait {sig.get('queue_wait_p99_s', 0)}"
                               f"s)")}
        return {"action": "hold", "target": live,
                "reason": f"backlog served by {live} worker(s)"}
    if active or granted:
        return {"action": "hold", "target": live,
                "reason": f"{active} active scan(s), {granted} granted "
                          f"item(s) in flight"}
    if live > lo and idle_s >= p.scale_in_idle_s:
        return {"action": "scale-in", "target": lo,
                "reason": f"idle {idle_s:.1f}s >= {p.scale_in_idle_s:g}s"}
    return {"action": "hold", "target": live,
            "reason": (f"idle {idle_s:.1f}s" if live > lo
                       else "at floor, nothing to do")}


class FlapTracker:
    """Per-rank death accounting: capped exponential backoff, flap
    damping. Injectable clock — unit-testable with zero real sleeps.

    The backoff derives from how many deaths the rank has inside the
    sliding window: ``backoff_s * 2**(deaths-1)`` capped at
    ``backoff_max_s``; at ``threshold`` deaths the rank is FLAPPING and
    pins to the cap until the window drains (a rank that keeps dying
    gets capacity back slowly, never a tight respawn loop). A clean
    retirement clears the rank's history — a deliberate scale-in is not
    evidence of trouble."""

    def __init__(self, window_s: float = 60.0, threshold: int = 3,
                 backoff_s: float = 0.5, backoff_max_s: float = 30.0,
                 clock=time.monotonic):
        self.window_s = float(window_s)
        self.threshold = int(threshold)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self._clock = clock
        self._deaths: dict[int, list[float]] = {}

    def _pruned(self, rank: int) -> list[float]:
        d = self._deaths.setdefault(rank, [])
        cut = self._clock() - self.window_s
        while d and d[0] <= cut:
            d.pop(0)
        return d

    def record_exit(self, rank: int, clean: bool = False) -> None:
        if clean:
            self._deaths.pop(rank, None)
            return
        self._pruned(rank).append(self._clock())

    def deaths(self, rank: int) -> int:
        return len(self._pruned(rank))

    def flapping(self, rank: int) -> bool:
        return self.threshold > 0 and self.deaths(rank) >= self.threshold

    def backoff(self, rank: int) -> float:
        n = self.deaths(rank)
        if n <= 0:
            return 0.0
        if self.flapping(rank):
            return self.backoff_max_s
        return min(self.backoff_max_s,
                   self.backoff_s * (2.0 ** (n - 1)))


class _FleetBridge:
    """The coordinator wire protocol served FROM the admission
    controller: fleet workers speak the coordinator's newline-JSON ops
    (hello/next/beat/complete/failed) against the serving lease table,
    so ``worker.py`` needed no new client code. Hosted by the reused
    ``coordinator._Server`` — which expects ``crash``/``done`` for its
    injected-crash plumbing; the supervisor re-raises a stored crash on
    its next tick (the coordinator-poll-loop shape)."""

    def __init__(self, sup: "FleetSupervisor"):
        self.sup = sup
        self.adm = sup.adm
        self.crash: BaseException | None = None
        self.done = threading.Event()

    def op_hello(self, req: dict) -> dict:
        w = str(req.get("worker", ""))
        self.sup.note_hello(w, pid=int(req.get("pid", 0)),
                            generation=int(req.get("generation", 0)),
                            addr=req.get("addr") or "")
        return {"ok": True, "run_id": self.sup.run_id,
                "lease_s": self.adm.leases.lease_s,
                "heartbeat_s": self.sup.heartbeat_s}

    def op_next(self, req: dict) -> dict:
        w = str(req.get("worker", ""))
        if self.sup.is_retiring(w):
            # the scale-in drain: the worker exits clean on this answer;
            # anything it still held steals away at reap (safe by the
            # lease construction)
            return {"shutdown": True}
        grants = self.adm.next_views(w, 1)
        if not grants:
            return {"wait": self.sup.idle_wait_s}
        iid, gen, spec = grants[0]
        with self.adm.lock:
            job = self.adm.jobs.get(spec["scan"])
            calib = job.calib if job is not None else ""
        # fleet workers serve MANY scans: the grant carries the item's
        # calib (the engine lanes read it from their in-process _ScanCtx)
        return {"grant": {"id": iid, "gen": gen, "kind": "view",
                          "spec": dict(spec, calib=calib)}}

    def op_beat(self, req: dict) -> dict:
        return {"ok": self.adm.beat(str(req.get("worker", "")))}

    def op_complete(self, req: dict) -> dict:
        ok = self.adm.complete(req["item"], str(req.get("worker", "")),
                               int(req.get("gen", 0)))
        return {"ok": "accepted" if ok else "stolen"}

    def op_failed(self, req: dict) -> dict:
        self.adm.failed(req["item"], str(req.get("worker", "")),
                        int(req.get("gen", 0)),
                        error=req.get("error", ""))
        return {"ok": True}


class FleetSupervisor:
    """One reign's autoscaler. Owned by the leader (or solo) gateway:
    constructed with that reign's admission controller, started after
    promotion, closed on demotion — its ledger writes fence exactly like
    the engine's. See the module docstring for the loop."""

    def __init__(self, root: str, cfg, adm, store_root: str,
                 steps: tuple = (), log=print, registry=None,
                 lease: "election.LeaderLease | None" = None,
                 on_demote=None, on_crash=None, run_id: str = "",
                 clock=time.monotonic, spawn_fn=None, device: str = "cuda"):
        scfg = cfg.serving
        self.root = os.path.abspath(root)
        self.fleet_dir = os.path.join(self.root, "fleet")
        self.cfg = cfg
        self.adm = adm
        self.store_root = store_root
        self.steps = tuple(steps)
        self.log = log
        self.registry = registry
        self.lease = lease
        self.on_demote = on_demote
        self.on_crash = on_crash
        self._clock = clock
        self._spawn_fn = spawn_fn        # injectable for unit tests
        self.device = str(device)        # every worker's spec names it
        self.params = FleetParams.from_serving(scfg)
        self.poll_s = max(0.05, float(scfg.fleet_poll_s))
        self.idle_wait_s = min(0.2, self.poll_s)
        self.heartbeat_s = float(cfg.coordinator.heartbeat_s)
        self.run_id = run_id or "fleet"
        self.flap = FlapTracker(window_s=scfg.fleet_flap_window_s,
                                threshold=scfg.fleet_flap_threshold,
                                backoff_s=scfg.fleet_backoff_s,
                                backoff_max_s=scfg.fleet_backoff_max_s,
                                clock=clock)
        self.target = self.params.min_workers
        self._lock = threading.Lock()
        self._gen: dict[int, int] = {}          # rank -> latest generation
        self._workers: dict[int, dict] = {}     # rank -> {proc, gen, ...}
        self._retiring: set[str] = set()
        self._respawn_at: dict[int, float] = {}
        self._hellos: dict[str, dict] = {}      # worker -> pid/gen/addr
        self._idle_since = self._clock()
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.bridge: _FleetBridge | None = None
        self.server = None
        self._cfg_path = ""

    # ---- bridge-facing state ---------------------------------------------

    def is_retiring(self, worker: str) -> bool:
        with self._lock:
            return worker in self._retiring

    def note_hello(self, worker: str, pid: int = 0, generation: int = 0,
                   addr: str = "") -> None:
        with self._lock:
            self._hellos[worker] = {"pid": pid, "generation": generation,
                                    "addr": addr}

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> None:
        os.makedirs(self.fleet_dir, exist_ok=True)
        # the workers' config: the EXACT serving config (clean steps and
        # numerics are view-cache key material — any drift would cache
        # wrong bytes under right keys), minus anything recursive
        wcfg = copy.deepcopy(self.cfg)
        wcfg.coordinator.workers = 0
        wcfg.serving.fleet_enabled = False
        wcfg.serving.ha_enabled = False
        self._cfg_path = os.path.join(self.fleet_dir, "cfg.json")
        wcfg.save(self._cfg_path)
        self.bridge = _FleetBridge(self)
        self.server = coord_mod._Server(
            self.bridge, 0, self.log,
            listen=self.cfg.serving.fleet_listen,
            secret=self.cfg.serving.fleet_secret)
        inherited = replay_fleet(self.adm.ledger.path)
        self._gen.update(inherited["generations"])
        resume = [r for r in inherited["live"]
                  if r < self.params.max_workers]
        if resume:
            # a promoted follower resumes the fleet it inherited: same
            # ranks, bumped generations (the old incarnations either died
            # with the old leader or are dialing its dead bridge)
            self._journal("resume", ranks=resume,
                          target=int(inherited["target"]))
            self.target = max(self.params.min_workers, len(resume))
            for rank in resume:
                try:
                    self._spawn(rank, action="respawn",
                                sig={"resumed": True})
                except (faults.InjectedCrash, election.FencedWrite):
                    raise
                except BaseException as e:
                    self.log(f"[fleet] resume spawn fw{rank} failed: {e}")
        self._thread = threading.Thread(target=self._loop,
                                        name="sl3d-fleet", daemon=True)
        self._thread.start()
        self.log(f"[fleet] supervisor up on {self.server.endpoint} "
                 f"(target {self.target}, bounds "
                 f"[{self.params.min_workers}, {self.params.max_workers}]"
                 + (f", resumed {resume}" if resume else "") + ")")

    def close(self, kill_budget_s: float = 5.0) -> None:
        """Retire every worker (clean shutdown answers first, SIGTERM
        then SIGKILL past the budget), stop the bridge and the loop.
        Called on demotion and service stop; never journals — a deposed
        supervisor's ledger writes would be fenced anyway, and the new
        leader's resume owns the fleet's story from here."""
        self._stop.set()
        with self._lock:
            self._retiring.update(f"fw{r}" for r in self._workers)
            procs = {r: w["proc"] for r, w in self._workers.items()}
            self._respawn_at.clear()
        t_end = self._clock() + max(0.0, kill_budget_s)
        while procs and self._clock() < t_end:
            for r in [r for r, p in procs.items() if p.poll() is not None]:
                procs.pop(r)
            if procs:
                time.sleep(0.05)
        for p in procs.values():
            try:
                p.terminate()
            except OSError:
                pass
        for p in procs.values():
            try:
                p.wait(timeout=2.0)
            except Exception:
                try:
                    p.kill()
                    p.wait(timeout=5.0)     # reap: no child outlives close
                except Exception:
                    pass
        with self._lock:
            for rank in list(self._workers):
                self.adm.drop_lane(f"fw{rank}", "fleet-stop")
            self._workers.clear()
        if self.server is not None:
            self.server.close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # ---- the loop --------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except faults.InjectedCrash as e:
                # the supervisor dies like the engine: simulated process
                # death, restart-resume (or a takeover) is the recovery
                if self.on_crash is not None:
                    self.on_crash("fleet", e)
                return
            except election.FencedWrite as e:
                self.log(f"[fleet] decision fenced ({e}) — stopping")
                if self.on_demote is not None:
                    self.on_demote(f"fleet: {e}")
                return
            except BaseException as e:
                self.log(f"[fleet] tick error: {type(e).__name__}: {e}")
            self._stop.wait(self.poll_s)

    def _tick(self) -> None:
        if self.bridge is not None and self.bridge.crash is not None:
            crash, self.bridge.crash = self.bridge.crash, None
            raise crash
        if self.lease is not None and self.lease.superseded():
            # a newer epoch exists: stop DECIDING now — spawn/retire are
            # side effects the ledger fence cannot un-run
            self.log("[fleet] superseded by a newer epoch — stopping")
            self._stop.set()
            if self.on_demote is not None:
                self.on_demote("fleet: epoch superseded")
            return
        now = self._clock()
        self._reap()
        self._respawn_due(now)
        sig = self.adm.signals()
        busy = (sig["pending_items"] or sig["granted_items"]
                or sig["queued_scans"] or sig["active_scans"])
        if busy:
            self._idle_since = now
        # chaos: a transient here skips the tick (the decision simply
        # doesn't happen this round), a crash fells the supervisor
        faults.fire("fleet.decide", item=str(self._ticks))
        self._ticks += 1
        with self._lock:
            live = len(self._workers) + len(self._respawn_at)
        d = decide(sig, live, now - self._idle_since, self.params)
        if d["action"] == "scale-up":
            self._journal("scale-up", target=d["target"],
                          reason=d["reason"], signals=sig)
            self.target = d["target"]
            self._scale_up(sig)
        elif d["action"] == "scale-in":
            self._journal("scale-in", target=d["target"],
                          reason=d["reason"], signals=sig)
            self.target = d["target"]
            self._scale_in()
        if self.registry is not None:
            self.registry.set_gauge("sl3d_fleet_target",
                                    float(self.target))
            self.registry.set_gauge("sl3d_fleet_live",
                                    float(len(self._workers)))

    def _reap(self) -> None:
        """Collect exited workers: drop their leases NOW (items steal
        back with a generation bump — the corpse's late completes are
        refused), then classify: a retiring worker's exit is a clean
        retirement whatever its rc; anything else is a death that
        schedules a backoff respawn."""
        with self._lock:
            exited = [(r, w) for r, w in self._workers.items()
                      if w["proc"].poll() is not None]
            for r, _ in exited:
                del self._workers[r]
        for rank, w in exited:
            name = f"fw{rank}"
            rc = w["proc"].returncode
            stolen = self.adm.drop_lane(name, reason=f"worker-exit-{rc}")
            with self._lock:
                was_retiring = name in self._retiring
                self._retiring.discard(name)
            if was_retiring:
                self.flap.record_exit(rank, clean=True)
                self._journal("retired", rank=rank, gen=w["gen"], rc=rc,
                              stolen=stolen)
                self._inc("sl3d_fleet_retired_total")
                continue
            self.flap.record_exit(rank)
            back = self.flap.backoff(rank)
            flapping = self.flap.flapping(rank)
            self._journal("worker-exit", rank=rank, gen=w["gen"], rc=rc,
                          stolen=stolen, backoff_s=round(back, 3),
                          flapping=flapping)
            self.log(f"[fleet] {netutil.worker_tag(name, w['gen'])} died "
                     f"(rc {rc}, {stolen} item(s) stolen back) — respawn "
                     f"in {back:.2f}s"
                     + (" [FLAPPING]" if flapping else ""))
            self._inc("sl3d_fleet_worker_exits_total")
            if flapping:
                self._inc("sl3d_fleet_flap_damped_total")
            with self._lock:
                self._respawn_at[rank] = self._clock() + back

    def _respawn_due(self, now: float) -> None:
        with self._lock:
            due = sorted(r for r, t in self._respawn_at.items()
                         if t <= now)
        for rank in due:
            with self._lock:
                self._respawn_at.pop(rank, None)
                over = len(self._workers) >= self.target
            if over:
                continue        # target shrank while the rank backed off
            self._spawn(rank, action="respawn")

    def _scale_up(self, sig: dict) -> None:
        while True:
            with self._lock:
                live = len(self._workers) + len(self._respawn_at)
                used = set(self._workers) | set(self._respawn_at)
            if live >= self.target:
                return
            rank = next(r for r in range(self.params.max_workers + 1)
                        if r not in used)
            self._spawn(rank, action="spawn", sig=sig)

    def _scale_in(self) -> None:
        with self._lock:
            # highest ranks first; a scheduled respawn is retired by
            # simply cancelling it
            while (len(self._workers) + len(self._respawn_at)
                   > self.target and self._respawn_at):
                self._respawn_at.pop(max(self._respawn_at))
            excess = sorted(self._workers, reverse=True)[
                :max(0, len(self._workers) + len(self._respawn_at)
                     - self.target)]
            ranks = []
            for rank in excess:
                name = f"fw{rank}"
                if name not in self._retiring:
                    self._retiring.add(name)
                    ranks.append(rank)
        for rank in ranks:
            self._journal("retire", rank=rank,
                          held=len(self.adm.leases.worker_items(
                              f"fw{rank}")))

    def _spawn(self, rank: int, action: str = "spawn",
               sig: dict | None = None) -> None:
        gen = self._gen.get(rank, -1) + 1
        self._gen[rank] = gen
        name = f"fw{rank}"
        # journal BEFORE the side effect (and through the fence): a
        # crash between journal and Popen leaves a live-but-unspawned
        # rank in the ledger — exactly what the next resume respawns
        self._journal(action, rank=rank, gen=gen, signals=sig or {})
        try:
            faults.fire("worker.spawn", item=name)
        except faults.InjectedCrash:
            raise
        except BaseException as e:
            # transient spawn failure: journal it out of the live set and
            # retry under the rank's backoff
            self.flap.record_exit(rank)
            back = self.flap.backoff(rank)
            self._journal("spawn-failed", rank=rank, gen=gen,
                          error=str(e)[:200], backoff_s=round(back, 3))
            self.log(f"[fleet] spawn {name} failed ({e}); retry in "
                     f"{back:.2f}s")
            with self._lock:
                self._respawn_at[rank] = self._clock() + back
            return
        fabric = None
        if self.cfg.serving.fleet_listen:
            fabric = {"connect": self.server.endpoint,
                      "secret": self.cfg.serving.fleet_secret}
        if self._spawn_fn is not None:
            proc = self._spawn_fn(rank, gen)
        else:
            proc = coord_mod._spawn_worker(
                rank, max(1, self.target), self.server.port,
                self.fleet_dir, self._cfg_path, "", "", self.fleet_dir,
                self.steps, self.device, fabric=fabric, name=name,
                generation=gen, cache_root=self.store_root)
        with self._lock:
            self._workers[rank] = {"proc": proc, "gen": gen,
                                   "spawned_at": self._clock()}
        self._inc("sl3d_fleet_spawns_total")
        self.log(f"[fleet] spawned {netutil.worker_tag(name, gen)} "
                 f"(pid {proc.pid})")

    # ---- plumbing --------------------------------------------------------

    def _journal(self, action: str, **fields) -> None:
        self.adm.ledger.event("fleet", action=action, **fields)

    def _inc(self, name: str) -> None:
        if self.registry is not None:
            self.registry.inc(name)

    def state(self) -> dict:
        """Live fleet state in the same shape :func:`replay_fleet`
        returns, so the two can be compared."""
        with self._lock:
            return {"target": self.target,
                    "live": sorted(self._workers),
                    "generations": {r: w["gen"]
                                    for r, w in self._workers.items()},
                    "pids": {r: w["proc"].pid
                             for r, w in self._workers.items()},
                    "retiring": sorted(self._retiring),
                    "respawning": sorted(self._respawn_at),
                    "hellos": dict(self._hellos)}


def replay_fleet(path: str) -> dict:
    """Fold the ledger's ``fleet`` events into the final fleet state,
    under the same epoch fence as :func:`replay_serving` (a zombie
    supervisor's raced-in decisions are ignored). Returns ``{"target",
    "live": [ranks], "generations": {rank: gen}, "events", "max_epoch",
    "stale_ignored"}`` — what a promoted follower resumes, and what the
    live supervisor's :meth:`state` must agree with."""
    target = 0
    live: set[int] = set()
    gens: dict[int, int] = {}
    events = max_epoch = stale_ignored = 0
    if not os.path.exists(path):
        return {"target": 0, "live": [], "generations": {}, "events": 0,
                "max_epoch": 0, "stale_ignored": 0}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue            # torn tail
            e = ev.get("epoch")
            if e is not None:
                e = int(e)
                if e < max_epoch:
                    stale_ignored += 1
                    continue
                max_epoch = e
            if ev.get("type") != "fleet":
                continue
            events += 1
            action = ev.get("action")
            if "target" in ev:
                target = int(ev["target"])
            rank = ev.get("rank")
            if rank is None:
                continue
            rank = int(rank)
            if action in ("spawn", "respawn"):
                live.add(rank)
                gens[rank] = max(gens.get(rank, 0),
                                 int(ev.get("gen", 0)))
            elif action in ("worker-exit", "retired", "spawn-failed"):
                live.discard(rank)
    return {"target": target, "live": sorted(live), "generations": gens,
            "events": events, "max_epoch": max_epoch,
            "stale_ignored": stale_ignored}
