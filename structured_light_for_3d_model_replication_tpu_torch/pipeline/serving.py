"""``serve`` — the persistent multi-tenant scan service, on the card.

One long-lived process, many tenants, one shared device, built from the
layers the pipeline already has:

  gateway   stdlib ``ThreadingHTTPServer`` speaking JSON, the no-deps
            transport of the coordinator's newline-JSON wire protocol.
            ``/submit`` · ``/status/<id>`` · ``/result/<id>`` ·
            ``/metrics`` · ``/healthz`` · ``/usage``. With
            ``serving.auth_enabled`` the door checks per-tenant API keys
            (sha256 at rest in ``<root>/tenants.json``; 401/403 with
            machine-readable reasons) and per-tenant sliding-window rate
            limits (429) before anything else.
  admission ``parallel/admission.py``: per-tenant quotas (a submit over
            quota is a 429 at the door) and weighted-fair scheduling over
            the multi-scan form of the coordinator's lease/ledger, every
            grant/steal/complete journaled fsync'd.
  engine    in-process lanes that warm the content-addressed stage cache,
            drawing view grants interleaved across tenants, so views of
            DIFFERENT scans fill the same ``forward_views`` launch on the
            card (cross-tenant batching). The kernels take any number of
            views, so a group is launched as it is, unpadded. The item
            program is the coordinated worker's (load → compute → compact
            → clean → put); the scanner-free arms (numpy backend,
            bit-exact export) take the per-view lane.
  assembly  one request at a time, the single-process ``run_pipeline``
            over the warmed cache in the tenant's cache namespace
            (``TenantCache``), so every response is **byte-identical to a
            solo ``pipeline`` run** of the same input: engine lanes only
            warm; the assembly recomputes anything missing through the
            full retry/quarantine lane.

Everything that computes runs on the service's ``device`` (None → cuda;
the tests pass ``"cpu"``): the scanners, the clean chain and every
``run_pipeline``. The view cache keys carry the device type, as the solo
pipeline's do.

No fallback hides a kernel failure: an injected fault in a group degrades
it to the per-view lane (a poisoned view fails alone), but on the card any
other failure of a launch fails the group's items, journaled and counted in
``sl3d_serve_view_failures_total``, and the assembly then recomputes those
views on the card, where the same failure fails the request.

Failure domains are per REQUEST: a poisoned view quarantines inside its
own scan's assembly (that request completes DEGRADED with its own
``failures.json``); a per-request SLO (``budget_s``, clock starting at
submit) aborts only that request through the run budget; the service keeps
running through all of it.

Cache sharing is content-addressed and tenant-scoped at once: identical
frame bytes and config from two tenants hash to ONE cached entry (dedup,
decided when a scan is planned), while ``TenantCache`` ref-marker
namespaces keep eviction and listing per tenant, and outputs never alias
because every request owns its ``out_dir``.

Durability — the service state outlives the process:

  records   every accepted ``/submit`` is persisted FIRST as a request
            record (``<root>/requests/<scan_id>.json``, schema
            ``sl3d-request-v1``, atomic write + fsync) and only then
            journaled, queued and answered.
  resume    ``start()`` sweeps torn ``.tmp`` records, folds
            ``ledger.jsonl`` through ``replay_serving``, re-registers
            terminal scans (so /status and /result keep answering) and
            re-queues every non-terminal one. Ledger-credited views are
            already bytes in the content-addressed cache, so a restarted
            service plans them WARM: zero recompute, and the served
            PLY/STL stays byte-identical to an uninterrupted run.
            Client-supplied scan_ids are durably idempotent: the same
            (tenant, target, calib) re-submitted returns the existing
            request, a different one is a 409 conflict.
  lifecycle ``phase``: ready → draining → stopped. SIGTERM/SIGINT (and
            ``stop()``) drain: new submits 503 with Retry-After, active
            scans get ``serving.drain_budget_s`` to finish; past it the
            in-flight assembly is aborted through ``RunContext.abort``
            (failures.json) and the scan is CHECKPOINTED — non-terminal,
            re-queued by the next start with its warmed views cached.
  overload  ``shed_expired`` drops queued scans that already blew their
            SLO (or ``serving.max_queue_wait_s``); a per-tenant circuit
            breaker fast-fails a tenant whose scans keep failing until a
            half-open probe proves recovery.
  chaos     ``serve.crash`` fires at the grant / complete / assembly
            boundaries, ``ledger.append`` on every journal line,
            ``http.submit`` in the gateway.

Gateway HA — ``serving.ha_enabled`` runs N gateways over ONE shared root,
exactly one owning the engine at a time:

  election  ``parallel/election.py``: an fsync'd, atomically renewed
            leader lease (``<root>/leader.json``) with a monotonic epoch
            that bumps on every takeover. Followers bind HTTP, serve reads
            (from a cached fold of the shared ledger and the shared
            artifact tree) and answer /submit with a ``not-leader``
            redirect carrying the leader's address.
  fencing   the leader's ledger appends and request records are stamped
            with its epoch and pass ``LeaderLease.fence`` first: a deposed
            leader's write is REJECTED (``FencedWrite``) and it demotes;
            ``replay_serving`` ignores stale-epoch lines offline.
  takeover  is the restart-resume path run on the standby: ledger-credited
            views finish as cache hits (``views_computed == 0``), and
            ``serve.json`` is rewritten with the new epoch.

Threads: engine lanes, the assembler (whose ``run_pipeline`` runs its own
register stream), HTTP handler threads, the HA loop and the fleet
supervisor share the card. A lane keeps its tensors to itself: frames go
up through its own pinned staging ring and upload stream (the consumer
stream waits on the copy's event and takes the tensor with
``record_stream``), and each view comes back to the host before the lane
moves on.

The port's copy of the JAX package's ``pipeline/serving.py``: the same
files under the root, schemas (``sl3d-ledger-v1``, ``sl3d-request-v1``,
``sl3d-leader-v1``), fault sites and HTTP reason codes, so either
package's gateway can resume a root the other wrote.
"""
from __future__ import annotations

import copy
import fcntl
import json
import os
import re
import signal
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from structured_light_for_3d_model_replication_tpu_torch.config import Config
from structured_light_for_3d_model_replication_tpu_torch.io.atomic import (
    atomic_write,
    sweep_tmp,
)
from structured_light_for_3d_model_replication_tpu_torch.parallel.admission import (
    AdmissionController,
    RateLimiter,
    ScanJob,
    TenantAuth,
    fold_usage,
    replay_serving,
)
from structured_light_for_3d_model_replication_tpu_torch.parallel.admission import (
    TERMINAL as _TERMINAL,
)
from structured_light_for_3d_model_replication_tpu_torch.parallel import election
from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (
    TenantCache,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import (
    deadline as dl,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import faults
from structured_light_for_3d_model_replication_tpu_torch.utils import (
    telemetry as tel,
)
from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["ScanService", "serve", "start_gateway", "REQUEST_SCHEMA"]

_ID_RE = re.compile(r"[^A-Za-z0-9._-]+")
_AUTO_ID_RE = re.compile(r"-s(\d{4,})$")

REQUEST_SCHEMA = "sl3d-request-v1"

# machine-readable /submit rejection reasons -> HTTP status. 429 =
# per-tenant/backlog quota (client backs off and retries), 503 =
# service-side refusal (draining, open breaker, injected transient,
# HA follower redirect — retry after Retry-After, at the advertised
# leader when the body carries one), 409 = durable-id conflict,
# 400 = malformed
_REASON_HTTP = {"tenant-queue-quota": 429, "queue-full": 429,
                "rate-limited": 429,
                "draining": 503, "stopped": 503, "crashed": 503,
                "circuit-open": 503, "transient": 503,
                "not-leader": 503,
                "auth-required": 401, "auth-invalid": 401,
                "auth-forbidden": 403,
                "scan-id-conflict": 409, "bad-request": 400}


def _safe_id(s: str, fallback: str) -> str:
    s = _ID_RE.sub("-", str(s or "")).strip("-.")[:64]
    return s or fallback


class _ScanCtx:
    """Everything the engine holds for one admitted scan: the shared plan
    (``stages._view_plan`` — the SAME key derivation the assembly pass
    will use), this tenant's cache namespace, and the scanner key that
    lets different scans share one launch."""

    __slots__ = ("job", "steps", "calib", "sources", "view_keys", "cache",
                 "scanner_key")

    def __init__(self, job, steps, calib, sources, view_keys, cache,
                 scanner_key):
        self.job = job
        self.steps = steps
        self.calib = calib
        self.sources = sources
        self.view_keys = view_keys
        self.cache = cache
        self.scanner_key = scanner_key


class ScanService:
    """The serving core: admission + engine + assembly over one shared
    stage-cache store, on ``device`` (None → cuda; raises without CUDA).
    HTTP lives in ``_Handler``/``serve`` so tests can drive this object
    directly."""

    def __init__(self, root: str, cfg: Config | None = None, log=print,
                 device=None):
        from structured_light_for_3d_model_replication_tpu_torch.pipeline import (
            stages,
        )

        self.cfg = cfg or Config()
        self.log = log
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # build (or find) the kernels once, before any lane, assembly
            # or fleet worker could each start nvcc
            from structured_light_for_3d_model_replication_tpu_torch.ops import (
                _build,
            )

            _build.load_library()
        self.root = os.path.abspath(root)
        self.scans_dir = os.path.join(self.root, "scans")
        self.store_root = os.path.join(self.root, "cache")
        self.ns_root = os.path.join(self.root, "cache-ns")
        self.requests_dir = os.path.join(self.root, "requests")
        os.makedirs(self.scans_dir, exist_ok=True)
        os.makedirs(self.store_root, exist_ok=True)
        os.makedirs(self.requests_dir, exist_ok=True)
        self.run_id = tel.new_run_id()
        self.registry = tel.MetricsRegistry()
        scfg = self.cfg.serving
        self._ledger_path = os.path.join(self.root, "ledger.jsonl")
        # HA: with ha_enabled this gateway joins a leader-
        # elected group over the shared root. It boots as a FOLLOWER —
        # no ledger open, no engine — and only builds the admission
        # core when it wins the lease (see _promote). role is one of
        # solo | follower | leader | demoting.
        self.ha = bool(scfg.ha_enabled)
        self.role = "follower" if self.ha else "solo"
        self.election: election.LeaderLease | None = None
        self._adv: dict | None = None   # advertised address (gateway)
        self._guard_f = None            # single-writer flock (solo mode)
        self._ha_thread: threading.Thread | None = None
        self._reign_threads: list[threading.Thread] = []
        self._lead_stop = threading.Event()   # set on demotion only
        self._demote_lock = threading.Lock()
        self._view_key: tuple | None = None   # follower fold cache
        self._view_rs: dict | None = None
        if self.ha:
            self.election = election.LeaderLease(
                os.path.join(self.root, "leader.json"),
                owner=self.run_id, lease_s=scfg.ha_lease_s)
            self._probe_guard()
            self.adm: AdmissionController | None = None
        else:
            # single-writer guard BEFORE the ledger opens: a second solo
            # gateway on this root must fail fast, not interleave meta
            # lines into a ledger someone else is serving from
            self._acquire_guard()
            self.adm = self._make_adm()
        # lifecycle phase: ready -> draining -> stopped (crashed when an
        # injected crash felled the in-process service). A bare
        # ScanService accepts submits from construction (tests drive it
        # without start()); only drain/stop flips the gate
        self.phase = "ready"
        self._draining = threading.Event()   # admit_next gate
        self._drain_breach = threading.Event()
        self.exit_on_crash = False           # serve() sets True: real exit
        self._stages = stages
        self._policy = stages._retry_policy(self.cfg)
        self._fwd_kw = stages._forward_kw(self.cfg)
        self._scans: dict[str, _ScanCtx] = {}
        self._scanners: dict[tuple, object] = {}   # scanner_key -> scanner
        self._staging: dict[str, object] = {}      # lane -> pinned ring (card)
        # elastic fleet: the supervisor belongs to whichever
        # reign owns the engine — solo start() builds it, _promote
        # rebuilds it from the replayed ledger, _demote tears it down
        self.fleet = None
        # front-door auth: per-tenant API keys + rate limits. Disabled
        # (the default), it costs /submit ONE attribute check
        self._auth: TenantAuth | None = None
        self._rlim: RateLimiter | None = None
        if scfg.auth_enabled:
            self._auth = TenantAuth(
                scfg.auth_tenants_file
                or os.path.join(self.root, "tenants.json"))
            self._rlim = RateLimiter(scfg.auth_rate_limit,
                                     scfg.auth_rate_window_s)
        self._scan_lock = threading.Lock()
        self._assembly_q: list[str] = []
        self._assembly_cv = threading.Condition()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._seq = 0
        self._seq_lock = threading.Lock()

    # ---- HA plumbing -----------------------------------------------------

    @property
    def epoch(self) -> int:
        """This gateway's fencing token: 0 for solo gateways and
        followers, the held lease epoch while leading."""
        return self.election.epoch if self.election is not None else 0

    def _make_adm(self) -> AdmissionController:
        scfg = self.cfg.serving
        ep = fence = None
        if self.election is not None:
            ep = lambda: self.election.epoch      # noqa: E731
            fence = self.election.fence
        return AdmissionController(
            self._ledger_path, self.run_id,
            lease_s=scfg.lease_s, max_active_scans=scfg.max_active_scans,
            tenant_active_quota=scfg.tenant_active_quota,
            tenant_queue_quota=scfg.tenant_queue_quota,
            queue_depth=scfg.queue_depth,
            max_queue_wait_s=scfg.max_queue_wait_s,
            breaker_threshold=scfg.breaker_threshold,
            breaker_cooldown_s=scfg.breaker_cooldown_s,
            epoch=ep, fence=fence, log=self.log)

    def _guard_path(self) -> str:
        return os.path.join(self.root, "serve.lock")

    def _acquire_guard(self) -> None:
        """Single-writer guard for SOLO gateways:
        hold an exclusive flock on ``<root>/serve.lock`` for the life of
        the service. A second solo gateway on the same root fails fast
        with who-owns-it instead of silently interleaving ledger
        appends. Same-pid contention is tolerated — an in-process
        crash-restart twin (tests) still holds the dead instance's
        fd, and the pid proves it is us."""
        lp = os.path.join(self.root, "leader.json")
        try:
            with open(lp, encoding="utf-8") as f:
                cur = json.load(f)
        except (OSError, ValueError):
            cur = None
        if (cur is not None
                and float(cur.get("expires_unix", 0.0)) > time.time()):
            raise RuntimeError(
                f"root {self.root} already served by HA leader "
                f"{cur.get('owner')!r} (pid {cur.get('pid')}, epoch "
                f"{cur.get('epoch')}); start this gateway with "
                f"serving.ha_enabled to join the group")
        f = open(self._guard_path(), "a+", encoding="utf-8")
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            f.seek(0)
            try:
                info = json.load(f)
            except ValueError:
                info = {}
            f.close()
            if int(info.get("pid", -1)) == os.getpid():
                self.log("[serve] serve.lock held by this process "
                         "(in-process restart); continuing")
                return
            raise RuntimeError(
                f"root {self.root} already served by pid "
                f"{info.get('pid')} (run {info.get('run_id')}, "
                f"{'HA epoch %s' % info.get('epoch') if info.get('ha') else 'solo'}"
                f"); refusing a second writer — stop it or run an HA "
                f"group (serving.ha_enabled)") from None
        f.seek(0)
        f.truncate()
        json.dump({"pid": os.getpid(), "run_id": self.run_id,
                   "ha": False, "epoch": 0}, f)
        f.flush()
        self._guard_f = f

    def _probe_guard(self) -> None:
        """HA members don't HOLD the flock (a zombie's fd must never
        block a takeover — the lease file is their arbiter), but they do
        refuse to join a root a SOLO gateway is actively serving."""
        try:
            f = open(self._guard_path(), "r+", encoding="utf-8")
        except OSError:
            return
        try:
            try:
                fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)
            except OSError:
                f.seek(0)
                try:
                    info = json.load(f)
                except ValueError:
                    info = {}
                if (not info.get("ha")
                        and int(info.get("pid", -1)) != os.getpid()):
                    raise RuntimeError(
                        f"root {self.root} already served by solo "
                        f"gateway pid {info.get('pid')} (run "
                        f"{info.get('run_id')}); stop it before "
                        f"starting an HA group") from None
        finally:
            f.close()

    def _release_guard(self) -> None:
        if self._guard_f is None:
            return
        try:
            fcntl.flock(self._guard_f.fileno(), fcntl.LOCK_UN)
        except OSError:
            pass
        try:
            self._guard_f.close()
        except OSError:
            pass
        self._guard_f = None

    def advertise(self, host: str, port: int, argv=None) -> None:
        """Record this gateway's bound address — the leader lease and
        serve.json both carry it so clients and followers can point at
        the current leader. Called by start_gateway before start()."""
        self._adv = {"host": host, "port": int(port),
                     "argv": list(argv if argv is not None else sys.argv)}
        if self.election is not None:
            self.election.info.update(host=host, port=int(port))

    def _publish_serve_json(self) -> None:
        """The discovery handshake, epoch-stamped and ATOMICALLY
        rewritten: a client holding a stale leader
        address re-reads this file and sees a newer epoch + address
        instead of retrying a dead socket forever. Solo gateways write
        it once at startup (epoch 0); HA leaders rewrite it on every
        takeover."""
        if self._adv is None:
            return
        info = {"host": self._adv["host"], "port": self._adv["port"],
                "pid": os.getpid(), "run_id": self.run_id,
                "root": self.root, "argv": self._adv["argv"],
                "role": self.role, "epoch": self.epoch}
        path = os.path.join(self.root, "serve.json")
        with atomic_write(path) as tmp:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(info, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())

    def _redirect_body(self) -> dict:
        """The follower's /submit answer: the machine-readable rejection
        envelope pointing at the current leader."""
        scfg = self.cfg.serving
        body = {"error": f"this gateway is a {self.role}; submit to "
                         f"the leader",
                "reason": "not-leader", "role": self.role,
                "retry_after_s": round(
                    scfg.ha_poll_s or max(0.1, scfg.ha_lease_s / 5.0), 3)}
        cur = self.election.current() if self.election is not None else None
        if cur is not None:
            body["epoch"] = int(cur.get("epoch", 0))
            if cur.get("host") is not None and cur.get("port") is not None:
                body["leader"] = {
                    "host": cur["host"], "port": cur["port"],
                    "url": f"http://{cur['host']}:{cur['port']}"}
        return body

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> None:
        scfg = self.cfg.serving
        if self.ha:
            # HA member: the election loop owns the engine lifecycle —
            # it promotes (building admission + lanes) when this member
            # wins the lease and demotes when it loses it
            self._ha_thread = threading.Thread(
                target=self._ha_loop, name="sl3d-serve-ha", daemon=True)
            self._ha_thread.start()
            self.log(f"[serve] HA member up (run {self.run_id}) "
                     f"root={self.root} — awaiting election")
            return
        if scfg.durable:
            self._resume()
        self._threads.extend(self._start_engine_threads())
        self._start_fleet()
        self.log(f"[serve] service up (run {self.run_id}) root={self.root}")

    def _start_engine_threads(self) -> list[threading.Thread]:
        scfg = self.cfg.serving
        lead = self._lead_stop
        ths: list[threading.Thread] = []
        for i in range(max(1, scfg.engine_lanes)):
            t = threading.Thread(target=self._engine_loop,
                                 args=(f"lane{i}", lead),
                                 name=f"sl3d-serve-engine-{i}", daemon=True)
            t.start()
            ths.append(t)
        t = threading.Thread(target=self._assembler_loop, args=(lead,),
                             name="sl3d-serve-assembler", daemon=True)
        t.start()
        ths.append(t)
        return ths

    # ---- HA lifecycle ----------------------------------------------------

    def _ha_loop(self) -> None:
        """The member's election state machine. Followers try to acquire
        every poll tick (cheap: one flock'd read, a write only on a win);
        the leader renews every renew tick. A renew that comes back
        superseded — the manufactured zombie case: a stalled renew let
        the lease expire and a standby stole it — demotes; the fence on
        every ledger append is the backstop for writes already in
        flight."""
        scfg = self.cfg.serving
        renew_s = scfg.ha_renew_s or max(0.1, scfg.ha_lease_s / 3.0)
        poll_s = scfg.ha_poll_s or max(0.1, scfg.ha_lease_s / 5.0)
        while not self._stop.is_set():
            if self.role == "leader":
                ok = True
                try:
                    ok = self.election.renew()
                except faults.InjectedCrash as e:
                    self._crash("election.renew", e)
                    return
                except BaseException as e:
                    # transient lease-file trouble: keep leading, retry
                    # next tick — expiry + steal is the real arbiter
                    self.log(f"[serve] lease renew error: "
                             f"{type(e).__name__}: {e}")
                if not ok:
                    self._request_demote("lease lost (renew superseded)")
                self._stop.wait(renew_s)
            elif self.role == "follower" and self.phase == "ready":
                won = False
                try:
                    won = self.election.acquire()
                except faults.InjectedCrash as e:
                    self._crash("election.acquire", e)
                    return
                except BaseException as e:
                    self.log(f"[serve] lease acquire error: "
                             f"{type(e).__name__}: {e}")
                if won and not self._stop.is_set():
                    try:
                        self._promote()
                    except BaseException as e:
                        self.log(f"[serve] promotion FAILED: "
                                 f"{type(e).__name__}: {e}")
                        try:
                            self.election.release()
                        except Exception:
                            pass
                else:
                    self._stop.wait(poll_s)
            else:           # demoting (a worker thread is tearing down)
                self._stop.wait(poll_s)

    def _promote(self) -> None:
        """Takeover: the restart-resume path run on the standby. Open a
        new ledger segment stamped with our epoch, fold what every
        previous epoch journaled, re-queue non-terminal scans (their
        credited views are already cache bytes — zero recompute), start
        the engine, and atomically republish serve.json so clients
        re-discover."""
        ep = self.election.epoch
        self.log(f"[serve] elected LEADER (epoch {ep}, run {self.run_id})")
        self._lead_stop = threading.Event()
        self.adm = self._make_adm()
        try:
            self.adm.ledger.event("takeover", owner=self.run_id)
            if self.cfg.serving.durable:
                self._resume()
        except BaseException:
            adm, self.adm = self.adm, None
            try:
                adm.close()
            except Exception:
                pass
            raise
        self._reign_threads = self._start_engine_threads()
        with self._demote_lock:
            self.role = "leader"
        self.registry.inc("sl3d_serve_takeovers_total")
        self._publish_serve_json()
        # the fleet is a LEADER organ: the new supervisor replays the
        # shared ledger's fleet events and respawns the inherited ranks
        # (bumped generations) under OUR epoch's fence
        self._start_fleet()

    def _request_demote(self, why: str) -> None:
        """Thread-safe, idempotent-per-reign demotion trigger — safe to
        call from the engine/assembler threads being torn down (the
        teardown runs on a helper thread and never joins its caller)."""
        with self._demote_lock:
            if not self.ha or self.role != "leader":
                return
            self.role = "demoting"
        threading.Thread(target=self._demote, args=(why,),
                         daemon=True).start()

    def _demote(self, why: str) -> None:
        self.log(f"[serve] DEPOSED (epoch {self.election.epoch}): {why} "
                 f"— demoting to follower")
        self._lead_stop.set()
        # fleet first: its workers hold leases in the adm this teardown
        # is about to close, and its supervisor journals through a fence
        # that already rejects us
        self._stop_fleet()
        with self._assembly_cv:
            self._assembly_cv.notify_all()
        # an in-flight assembly is left to FINISH, not aborted: its
        # terminal journal line is fenced (the new leader owns the
        # credit) and its artifacts are byte-identical to what the new
        # leader produces over the same cache, so letting it run is
        # harmless — while dl.current() is process-global and may
        # belong to the NEW leader's run when both members share a
        # process (tests), so aborting it could kill the wrong
        # reign's work
        me = threading.current_thread()
        for t in self._reign_threads:
            if t is not me and t.is_alive():
                t.join()        # unbounded: engine/assembly always end
        self._reign_threads = []
        adm, self.adm = self.adm, None
        if adm is not None:
            try:
                adm.close()
            except Exception:
                pass
        with self._scan_lock:
            self._scans.clear()
            self._scanners.clear()
        with self._assembly_cv:
            self._assembly_q.clear()
        self.election.epoch = 0
        self.registry.inc("sl3d_serve_demotions_total")
        with self._demote_lock:
            self.role = "follower"

    def _resume(self) -> None:
        """Restart-resume: request records + ledger replay → the queue a
        previous incarnation left behind. Terminal scans come back as
        /status-able history; everything else re-queues. The warmed views
        of a resumed scan are already bytes in the content-addressed
        cache, so ``_plan`` sees them as cache hits — zero recompute of
        ledger-credited work, byte parity as for a coordinated run."""
        swept = sweep_tmp(self.requests_dir)
        if swept:
            self.log(f"[serve] swept {len(swept)} torn request record(s)")
        rs = replay_serving(self.adm.ledger.path)
        records: list[dict] = []
        torn = 0
        for fn in sorted(os.listdir(self.requests_dir)):
            if not fn.endswith(".json"):
                continue
            path = os.path.join(self.requests_dir, fn)
            try:
                with open(path, encoding="utf-8") as f:
                    rec = json.load(f)
                if (rec.get("schema") != REQUEST_SCHEMA
                        or not rec.get("scan_id") or not rec.get("calib")):
                    raise ValueError("missing fields")
            except (ValueError, OSError) as e:
                # torn/garbled record: tolerated, never resumed — the
                # fsync-before-202 ordering means its client never got
                # an accept to hold us to
                torn += 1
                self.log(f"[serve] skipping unreadable request record "
                         f"{fn}: {e}")
                continue
            records.append(rec)
        records.sort(key=lambda r: (r.get("submitted_unix", 0.0),
                                    r["scan_id"]))
        now_mono, now_unix = time.monotonic(), time.time()
        n_term = n_res = 0
        for rec in records:
            sid = rec["scan_id"]
            job = ScanJob(sid, rec.get("tenant", "anon"), rec["target"],
                          rec["calib"],
                          rec.get("out_dir",
                                  os.path.join(self.scans_dir, sid)),
                          weight=rec.get("weight", 1.0),
                          budget_s=rec.get("budget_s", 0.0))
            # re-base the SLO clock to true wall time since the original
            # submit: a crash does not stop a client's deadline
            job.submitted_unix = rec.get("submitted_unix", now_unix)
            job.submitted_mono = now_mono - max(
                0.0, now_unix - job.submitted_unix)
            m = _AUTO_ID_RE.search(sid)
            if m:        # keep auto scan ids collision-free across runs
                with self._seq_lock:
                    self._seq = max(self._seq, int(m.group(1)))
            led = rs["scans"].get(sid)
            if led is not None and led["state"] in _TERMINAL:
                job.state = led["state"]
                job.error = led["error"]
                job.report = led["report"]
                job.finished_mono = job.submitted_mono + led["elapsed_s"]
                self.adm.restore_terminal(job)
                n_term += 1
            else:
                self.adm.restore(job)
                n_res += 1
        for tenant, fails in rs["tenant_fails"].items():
            self.adm.restore_breaker(tenant, fails)
        self.registry.inc("sl3d_serve_resumed_total", n_res)
        if records or torn:
            self.log(f"[serve] resume: {n_res} scan(s) re-queued, "
                     f"{n_term} terminal restored, {torn} torn record(s) "
                     f"skipped ({rs['segments']} ledger segment(s), "
                     f"{len(rs['completed'])} credited item(s))")

    def drain(self, budget_s: float | None = None) -> dict:
        """Graceful drain: stop admitting, let active scans finish within
        the budget, then abort-and-checkpoint whatever is still running
        (the ``RunContext.abort`` lever — the in-flight assembly
        exits through its normal DeadlineExceeded path, failures.json
        included, and the scan parks as CHECKPOINTED for the next
        start). Returns {"finished": n, "checkpointed": [scan_ids]}."""
        scfg = self.cfg.serving
        budget = scfg.drain_budget_s if budget_s is None else budget_s
        self.phase = "draining"
        self._draining.set()
        if self.adm is None:      # HA follower: nothing in flight here
            return {"finished": 0, "checkpointed": []}
        try:
            self.adm.ledger.event("drain", budget_s=budget)
        except Exception:
            pass
        t_end = time.monotonic() + max(0.0, budget)

        def active():
            with self.adm.lock:
                return [j for j in self.adm.jobs.values()
                        if j.state in ("admitted", "warmed", "assembling")]

        while active() and time.monotonic() < t_end:
            time.sleep(0.05)
        left = active()
        checkpointed: list[str] = []
        if left:
            self._drain_breach.set()
            ctx = dl.current()
            if ctx is not None:
                ctx.abort("drain budget exceeded")
            # the aborted assembly settles through _assemble (which sees
            # _drain_breach and checkpoints); give it a bounded window
            t_stop = time.monotonic() + 15.0
            while (time.monotonic() < t_stop
                   and any(j.state == "assembling" for j in active())):
                time.sleep(0.05)
            # an aborted assembly checkpoints ITSELF (in _assemble);
            # everything else still admitted/warmed is parked here
            for j in left:
                if (j.state == "checkpointed"
                        or self.adm.checkpoint(
                            j.scan_id, reason=f"drain budget {budget:g}s "
                                              f"exceeded")):
                    checkpointed.append(j.scan_id)
        n_fin = sum(1 for j in self.adm.jobs.values()
                    if j.state in ("done", "degraded"))
        self.log(f"[serve] drained: {n_fin} finished, "
                 f"{len(checkpointed)} checkpointed")
        return {"finished": n_fin, "checkpointed": checkpointed}

    def stop(self, drain_budget_s: float | None = None) -> dict:
        """Drain then close — the SIGTERM path. A later ScanService over
        the same root resumes anything queued or checkpointed."""
        res = self.drain(drain_budget_s)
        self.close()
        return res

    def close(self) -> None:
        self._stop.set()
        self._stop_fleet()
        with self._assembly_cv:
            self._assembly_cv.notify_all()
        for t in self._threads + self._reign_threads:
            t.join(timeout=10.0)
        if self._ha_thread is not None:
            self._ha_thread.join(timeout=10.0)
        adm = self.adm
        if adm is not None:
            adm.close()
        if (self.election is not None and self.election.epoch > 0
                and self.phase != "crashed"):
            # graceful step-down: expire the lease NOW so the standby
            # takes over on its next poll. A crashed service must NOT
            # release — simulated process death hands over by expiry,
            # exactly like the real kill -9
            try:
                self.election.release()
            except Exception:
                pass
        self._release_guard()
        if self.phase != "crashed":
            self.phase = "stopped"

    def _crash(self, where: str, exc: BaseException) -> None:
        """An injected ``serve.crash`` fired: die like the real thing.
        Under ``serve()`` (exit_on_crash) the PROCESS exits 137 with the
        ledger fd left dangling mid-line — exactly a kill -9. In-process
        (tests) the service wedges into phase=crashed without
        journaling a finish or closing the ledger; a new ScanService
        over the same root is the restart."""
        self.log(f"[serve] CRASH at {where}: {exc}")
        self.phase = "crashed"
        self._stop.set()
        with self._assembly_cv:
            self._assembly_cv.notify_all()
        if self.exit_on_crash:
            os._exit(137)

    # ---- elastic fleet ---------------------------------------------------

    def _start_fleet(self) -> None:
        """Spin up this reign's fleet supervisor (no-op unless
        ``serving.fleet_enabled``). Import is lazy — a fleet-less service
        never loads the coordinator stack."""
        if not self.cfg.serving.fleet_enabled or self.adm is None:
            return
        from structured_light_for_3d_model_replication_tpu_torch.parallel import (
            fleet as fleet_mod,
        )
        sup = fleet_mod.FleetSupervisor(
            self.root, self.cfg, self.adm, self.store_root,
            steps=self._engine_steps(), log=self.log,
            registry=self.registry, lease=self.election,
            on_demote=self._request_demote, on_crash=self._crash,
            run_id=self.run_id, device=str(self.device))
        sup.start()
        self.fleet = sup

    def _stop_fleet(self) -> None:
        sup, self.fleet = self.fleet, None
        if sup is not None:
            try:
                sup.close()
            except Exception as e:
                self.log(f"[serve] fleet teardown error: "
                         f"{type(e).__name__}: {e}")

    def usage(self, tenant: str | None = None) -> dict:
        """Per-tenant usage metering: :func:`fold_usage` over the SAME
        cached epoch-fenced ledger fold the follower read model uses —
        the bill agrees with what the service credited, on leaders and
        followers alike."""
        u = fold_usage(self._follower_view())
        if tenant is not None:
            u = {tenant: u[tenant]} if tenant in u else {}
        return {"schema": "sl3d-usage-v1", "tenants": u}

    # ---- submit ----------------------------------------------------------

    def submit(self, payload: dict) -> tuple[bool, dict]:
        """One scan submission: validate, quota-check, persist, queue.
        Returns (accepted, body) where body is the /submit response JSON;
        rejections carry a machine-readable ``reason`` (and
        ``retry_after_s`` when the client should come back). A re-submit
        of an existing client scan_id with the SAME (tenant, target,
        calib) is idempotent — it returns the existing request — because
        after a gateway crash the client cannot know whether its first
        202 committed."""
        scfg = self.cfg.serving
        if self.phase != "ready":
            self.registry.inc("sl3d_serve_rejected_total",
                              tenant=_safe_id(payload.get("tenant"),
                                              "anon"))
            return False, {"error": f"service is {self.phase}",
                           "reason": ("draining"
                                      if self.phase == "draining"
                                      else self.phase),
                           "retry_after_s": max(1.0, scfg.drain_budget_s)}
        if self._auth is not None:
            # the front door: identity before anything else —
            # an unauthenticated caller learns nothing, not even where
            # the leader is. Reasons map to 401/403; a valid key then
            # passes the per-tenant sliding-window rate limit (429 in
            # the same quota vocabulary as tenant-queue-quota)
            t0 = _safe_id(payload.get("tenant"), "anon")
            err = self._auth.check(t0, str(payload.get("api_key") or ""))
            if err is not None:
                self.registry.inc("sl3d_serve_auth_denied_total",
                                  tenant=t0)
                return False, dict(err, tenant=t0)
            limits = self._auth.tenant_limits(t0)
            err = (self._rlim.allow(t0, *limits) if limits
                   else self._rlim.allow(t0))
            if err is not None:
                self.registry.inc("sl3d_serve_rate_limited_total",
                                  tenant=t0)
                return False, dict(err, tenant=t0)
        adm = self.adm
        if self.ha and (self.role != "leader" or adm is None):
            # HA follower / mid-transition member: machine-readable
            # redirect to the current leader
            self.registry.inc("sl3d_serve_redirected_total")
            return False, self._redirect_body()
        tenant = _safe_id(payload.get("tenant"), "anon")
        target = str(payload.get("target") or "")
        calib = str(payload.get("calib") or "")
        if not target or not os.path.isdir(target):
            return False, {"error": f"target is not a directory: "
                                    f"{target!r}", "reason": "bad-request"}
        if not calib or not os.path.isfile(calib):
            return False, {"error": f"calib is not a file: {calib!r}",
                           "reason": "bad-request"}
        client_id = _safe_id(payload.get("scan_id"), "")
        if client_id:
            scan_id = f"{tenant}-{client_id}"
        else:
            with self._seq_lock:
                self._seq += 1
                scan_id = f"{tenant}-s{self._seq:04d}"
        out_dir = os.path.join(self.scans_dir, scan_id)
        budget = payload.get("budget_s", scfg.default_budget_s)
        job = ScanJob(scan_id, tenant, os.path.abspath(target),
                      os.path.abspath(calib), out_dir,
                      weight=float(payload.get("weight",
                                               scfg.default_weight)),
                      budget_s=float(budget or 0.0))
        persist = self._write_record if scfg.durable else None
        try:
            with adm.lock:
                prior = adm.jobs.get(scan_id)
                if prior is not None:
                    if (prior.tenant, prior.target, prior.calib) == \
                            (job.tenant, job.target, job.calib):
                        return True, {"scan_id": scan_id, "tenant": tenant,
                                      "state": prior.state,
                                      "duplicate": True}
                    return False, {"error": f"scan_id {scan_id!r} already "
                                            "exists with different "
                                            "inputs",
                                   "reason": "scan-id-conflict"}
                ok, info = adm.submit(job, persist=persist)
        except faults.InjectedCrash:
            raise
        except election.FencedWrite as e:
            # deposed between the role check and the journal append: the
            # fence rejected the write before any line hit the ledger
            self.log(f"[serve] submit fenced: {e}")
            self._request_demote(f"submit: {e}")
            return False, self._redirect_body()
        except BaseException as e:
            # durable-record or journal write failed: nothing admitted,
            # the client can safely retry the same scan_id
            self.registry.inc("sl3d_serve_rejected_total", tenant=tenant)
            return False, {"error": f"submit not durable: {e}",
                           "reason": "transient", "retry_after_s": 1.0}
        if not ok:
            self.registry.inc("sl3d_serve_rejected_total", tenant=tenant)
            body = {"error": info.get("error", "rejected"),
                    "reason": info.get("reason", "bad-request"),
                    "tenant": tenant}
            if "retry_after_s" in info:
                body["retry_after_s"] = info["retry_after_s"]
            return False, body
        self.registry.inc("sl3d_serve_submitted_total", tenant=tenant)
        return True, {"scan_id": scan_id, "tenant": tenant,
                      "state": "queued"}

    def _write_record(self, job) -> None:
        """The durability point: the request record is bytes-on-disk
        (fsync'd) BEFORE the scan is journaled, queued, or 202'd — so an
        accepted request can always be replayed, and anything the crash
        interrupted earlier left no accept for the client to hold."""
        rec = {"schema": REQUEST_SCHEMA, "scan_id": job.scan_id,
               "tenant": job.tenant, "target": job.target,
               "calib": job.calib, "out_dir": job.out_dir,
               "weight": job.weight, "budget_s": job.budget_s,
               "submitted_unix": job.submitted_unix,
               "epoch": self.epoch}   # writer's fencing token (HA)
        path = os.path.join(self.requests_dir, f"{job.scan_id}.json")
        with atomic_write(path) as tmp:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(rec, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())

    def _follower_view(self) -> dict:
        """The follower read model: a fold of the SHARED ledger, cached
        by (size, mtime) so /status polls don't re-fold an unchanged
        file. Epoch fencing inside replay_serving means a follower never
        reports state a deposed writer raced in."""
        try:
            st = os.stat(self._ledger_path)
            key = (st.st_size, st.st_mtime_ns)
        except OSError:
            key = None
        if key is not None and key == self._view_key \
                and self._view_rs is not None:
            return self._view_rs
        rs = replay_serving(self._ledger_path)
        self._view_key, self._view_rs = key, rs
        return rs

    def status(self, scan_id: str) -> dict | None:
        adm = self.adm
        if adm is None:       # HA follower: answer from the shared ledger
            r = self._follower_view()["scans"].get(scan_id)
            if r is None:
                return None
            return {"scan_id": scan_id, "tenant": r["tenant"],
                    "state": r["state"], "error": r["error"],
                    "report": r["report"], "elapsed_s": r["elapsed_s"],
                    "items": {}, "via": "follower-replay"}
        with adm.lock:
            job = adm.jobs.get(scan_id)
            if job is None:
                return None
            d = job.as_dict()
            d["items"] = adm.scan_item_states(scan_id)
            return d

    def result_path(self, scan_id: str, artifact: str) -> tuple[str, dict]:
        """Path of a finished request's artifact, or ("", error-body).
        Works on followers too: artifacts live on the SHARED root, and
        the ledger fold says which requests are terminal."""
        adm = self.adm
        if adm is None:
            r = self._follower_view()["scans"].get(scan_id)
            if r is None:
                return "", {"error": f"unknown scan_id {scan_id!r}"}
            state, out_dir = r["state"], r["out_dir"]
        else:
            with adm.lock:
                job = adm.jobs.get(scan_id)
            if job is None:
                return "", {"error": f"unknown scan_id {scan_id!r}"}
            state, out_dir = job.state, job.out_dir
        if state not in ("done", "degraded"):
            return "", {"error": f"scan {scan_id!r} is {state}",
                        "state": state}
        name = {"ply": "merged.ply", "stl": "model.stl"}.get(artifact)
        if name is None:
            return "", {"error": f"unknown artifact {artifact!r} "
                                 "(want ply|stl)"}
        path = os.path.join(out_dir, name)
        if not os.path.isfile(path):
            return "", {"error": f"{name} missing for {scan_id!r}"}
        return path, {}

    def snapshot(self) -> dict:
        adm = self.adm
        if adm is None:
            states = [r["state"]
                      for r in self._follower_view()["scans"].values()]
            snap = {"active": sum(1 for s in states
                                  if s in ("admitted", "warmed",
                                           "assembling")),
                    "queued": states.count("queued"),
                    "scans": len(states)}
        else:
            snap = adm.snapshot()
        snap["run_id"] = self.run_id
        snap["role"] = self.role
        snap["epoch"] = self.epoch
        return snap

    # ---- engine: plan ----------------------------------------------------

    def _plan(self, job) -> None:
        """Plan one admitted scan: derive sources + content-addressed view
        keys through the SAME ``_view_plan`` the assembly pass uses, probe
        the scanner key, register the cache-miss views as grantable items.
        A warm view (this tenant or ANY other — the keys carry no
        identity) completes at plan time: cross-tenant dedup is free."""
        st = self._stages
        job_log = self._job_log(job)
        cache = TenantCache(self.store_root, job.tenant,
                            ns_root=self.ns_root, enabled=True,
                            verify=self.cfg.pipeline.verify_cache,
                            log=lambda *_: None)
        calib, sources, view_keys, _ = st._view_plan(
            job.calib, job.target, self.cfg, self._engine_steps(), cache,
            job_log, self.device)
        scanner_key = self._scanner_key(job.calib, sources)
        specs, warm = [], 0
        for i, (src, key) in enumerate(zip(sources, view_keys)):
            if cache.get("view", key) is not None:
                warm += 1          # get() also marked this tenant's ref
                continue
            specs.append({"index": i, "src": src, "key": key,
                          "scan": job.scan_id})
        ctx = _ScanCtx(job, self._engine_steps(), calib, sources,
                       view_keys, cache, scanner_key)
        with self._scan_lock:
            self._scans[job.scan_id] = ctx
        self.adm.add_items(job.scan_id, specs)
        self.registry.inc("sl3d_serve_views_planned_total",
                          len(specs) + warm, tenant=job.tenant)
        self.registry.inc("sl3d_serve_views_dedup_total", warm,
                          tenant=job.tenant)
        job_log(f"[serve] {job.scan_id}: planned {len(specs)} view(s) to "
                f"warm, {warm} already cached")

    def _engine_steps(self) -> tuple:
        s = tuple(x.strip() for x in
                  self.cfg.serving.clean_steps.split(",") if x.strip())
        return s or tuple(self._stages.CLEAN_STEPS)

    def _scanner_key(self, calib_path: str, sources) -> tuple | None:
        """Scans sharing (calib file, camera geometry, device) share one
        scanner — the identity a cross-scan launch groups on. None on the
        scanner-free arms (numpy backend, bit-exact export: per-view
        lane)."""
        if self._stages._scanner_free(self.cfg):
            return None
        from structured_light_for_3d_model_replication_tpu_torch.io import (
            images as imio,
        )

        first = imio.list_frame_files(sources[0])
        hdr = imio.probe_packed(first[0])
        if hdr is not None:
            cam_size = (int(hdr["width"]), int(hdr["height"]))
        else:
            probe = imio.load_gray(first[0])
            cam_size = (probe.shape[1], probe.shape[0])
        return (os.path.abspath(calib_path), cam_size, str(self.device))

    def _scanner_for(self, ctx: _ScanCtx):
        if ctx.scanner_key is None:
            return None
        with self._scan_lock:
            sc = self._scanners.get(ctx.scanner_key)
            if sc is None:
                sc = self._stages._build_scanner(ctx.sources, ctx.calib,
                                                 self.cfg, self.device)
                self._scanners[ctx.scanner_key] = sc
            return sc

    # ---- engine: item programs ------------------------------------------

    def _engine_loop(self, lane: str, lead: threading.Event) -> None:
        poll = max(0.01, self.cfg.serving.poll_s)
        batch_n = max(1, self.cfg.parallel.compute_batch)
        while not self._stop.is_set() and not lead.is_set():
            try:
                self.adm.sweep_expired()
                for job in self.adm.shed_expired():
                    self._finish_metrics(job, "shed")
                    self.log(f"[serve] {job.scan_id}: SHED ({job.error})")
                if not self._draining.is_set():
                    for job in self.adm.admit_next():
                        try:
                            self._plan(job)
                        except election.FencedWrite:
                            raise
                        except Exception as e:
                            self.adm.finish(job.scan_id, "failed",
                                            error=f"plan: {e}")
                            self._finish_metrics(job, "failed")
                            self.log(f"[serve] {job.scan_id}: plan FAILED "
                                     f"({type(e).__name__}: {e})")
                self._queue_settled()
                grants = self.adm.next_views(lane, batch_n)
                if not grants:
                    self._stop.wait(poll)
                    continue
                self._run_grants(lane, grants)
            except faults.InjectedCrash as e:
                # an injected crash is the one thing the engine must NOT
                # survive: it simulates process death (restart-resume is
                # the recovery path, not this loop)
                self._crash(f"engine {lane}", e)
                return
            except election.FencedWrite as e:
                # a journal append was rejected: this gateway was deposed
                # while the lane worked. Nothing hit the ledger; the new
                # leader's resume owns every affected scan. Self-demote.
                self.log(f"[serve] engine {lane}: write fenced ({e})")
                self._request_demote(f"engine {lane}: {e}")
                return
            except BaseException as e:
                # the engine must survive anything else an item throws at
                # it (the service IS the process that must not die);
                # affected leases age into steals
                self.log(f"[serve] engine {lane}: {type(e).__name__}: {e}")
                self._stop.wait(poll)

    def _run_grants(self, lane: str, grants) -> None:
        """One grant set → loads → one (or more) launches. Grouping is by
        (scanner, frame shape): views from different scans land in the
        SAME group whenever their geometry matches — this is where
        cross-tenant batching actually happens."""
        st = self._stages
        loaded: dict[tuple | None, list] = {}
        for iid, gen, spec in grants:
            # crash boundary: the grant is journaled but no work happened
            # — restart re-plans the view as a cache miss
            faults.fire("serve.crash", item=f"grant:{iid}")
            with self._scan_lock:
                ctx = self._scans.get(spec["scan"])
            if ctx is None:            # scan finished/failed underneath us
                self.adm.failed(iid, lane, gen, "scan context gone")
                continue
            try:
                frames, texture = st._retry_stage(
                    "load",
                    lambda s=spec["src"]: st._load_fired(s, self.cfg),
                    self._policy)
            except (faults.InjectedCrash, election.FencedWrite):
                raise
            except BaseException as e:
                self._item_failed(lane, iid, gen, ctx,
                                  f"load: {type(e).__name__}: {e}")
                continue
            gkey = (None if ctx.scanner_key is None
                    else ctx.scanner_key + (frames.shape,))
            loaded.setdefault(gkey, []).append(
                (iid, gen, spec, ctx, frames, texture))
            self.adm.beat(lane)
        for gkey, items in loaded.items():
            if gkey is None or len(items) == 1:
                for it in items:
                    self._view_single(lane, it)
            else:
                self._view_batched(lane, items)

    def _finish_item(self, lane, iid, gen, spec, ctx, pts, cols) -> None:
        """Clean + cache one computed view (the coordinated worker's tail,
        the clean chain on the service's device) and settle its lease."""
        st = self._stages
        pts, cols, counts = st._clean_arrays(pts, cols, self.cfg, ctx.steps,
                                             device=self.device)
        ctx.cache.put("view", spec["key"], points=pts, colors=cols,
                      counts=np.asarray(json.dumps(counts)))
        # crash boundary: the bytes are cached but the complete event is
        # NOT journaled — restart still re-plans this view WARM (the
        # cache, not the ledger, is the source of truth for bytes)
        faults.fire("serve.crash", item=f"complete:{iid}")
        self.adm.complete(iid, lane, gen)
        self.registry.inc("sl3d_serve_views_warmed_total",
                          tenant=ctx.job.tenant)

    def _item_failed(self, lane, iid, gen, ctx, error: str) -> None:
        """Settle one item as failed: journaled with its error, counted,
        logged. The request's assembly recomputes the view through the
        full retry/quarantine lane."""
        self.adm.failed(iid, lane, gen, error)
        self.registry.inc("sl3d_serve_view_failures_total",
                          tenant=ctx.job.tenant)
        self.log(f"[serve] {iid}: view FAILED ({error})")

    def _view_single(self, lane: str, item) -> None:
        """The per-view engine lane: the coordinated worker's ``_do_view``
        program. ``compute.view`` fires inside ``_compute_fired`` — a
        seeded fault fails the item here, the item is NOT cached, and the
        request's assembly pass recomputes it through the full
        retry/quarantine lane (failure policy lives in one place). The
        scanner-free arms triangulate against the scan's calibration."""
        st = self._stages
        iid, gen, spec, ctx, frames, texture = item
        try:
            scanner = self._scanner_for(ctx)
            tail = st._Tail("batch", None, self.device, write_plys=False,
                            calib=ctx.calib)
            pts, cols = st._retry_stage(
                "compute",
                lambda: st._compute_fired(scanner, frames, self.cfg,
                                          spec["src"], texture=texture,
                                          tail=tail),
                self._policy)
            self._finish_item(lane, iid, gen, spec, ctx, pts, cols)
        except (faults.InjectedCrash, election.FencedWrite):
            raise
        except BaseException as e:
            self._item_failed(lane, iid, gen, ctx,
                              f"compute: {type(e).__name__}: {e}")

    def _lane_staging(self, lane: str, device):
        """The lane's pinned staging ring on the card: ``compute_batch``
        slots, one a view of the largest group a grant set can make."""
        staging = self._staging.get(lane)
        if staging is None:
            staging = self._stages._Staging(
                device, max(1, self.cfg.parallel.compute_batch))
            self._staging[lane] = staging
        return staging

    def _upload(self, lane: str, scanner, frames: list):
        """The group's stacks as one uint8 [V, F, H, W] tensor on the
        scanner's device, staged as the batched lane stages a batch: each
        stack through a pinned slot, one copy on the upload stream, and the
        current stream waits on its event and owns the tensor. On the CPU
        the stacked host array."""
        st = self._stages
        if not st._on_card(scanner):
            return np.stack(frames)
        staging = self._lane_staging(lane, scanner.device)
        leases, parts = [], []
        try:
            for f in frames:
                lease = staging.acquire()
                if lease is None:
                    raise RuntimeError(f"lane {lane}: no free staging slot for a "
                                       f"group of {len(frames)} view(s)")
                leases.append(lease)
                parts.append(staging.fill(lease, (f,))[0])
            stacked, ev = staging.upload(parts, leases, stacked=True)
            st._take_on_stream(ev, (stacked,))
            return stacked
        finally:
            for lease in leases:
                staging.release(lease)

    def _view_batched(self, lane: str, items) -> None:
        """One ``forward_views`` launch over the views of possibly MANY
        scans: the batched lane's program with the grant set as the batch,
        unpadded (the kernels take any number of views), then one copy of
        the group back to the host. ``compute.view`` fires per item before
        the launch; an injected fault there or in the launch degrades the
        whole group to the per-view lane, where a poisoned view fails
        ALONE and its groupmates (other tenants included) complete. On the
        card any other failure of the launch fails the group's items,
        journaled and counted: a kernel that fails at this group's shape
        never passes as a per-view success."""
        st = self._stages
        from structured_light_for_3d_model_replication_tpu_torch.ops import (
            triangulate as tri,
        )

        poisoned = None
        for iid, gen, spec, ctx, _f, _t in items:
            try:
                faults.fire("compute.view", item=spec["src"])
            except faults.InjectedCrash:
                raise
            except BaseException as e:
                poisoned = e
                break
        if poisoned is None:
            scanner = None
            try:
                scanner = self._scanner_for(items[0][3])
                v = len(items)
                fv = self._upload(lane, scanner,
                                  [f for _, _, _, _, f, _ in items])
                cloud = scanner.forward_views(fv, **self._fwd_kw)
                pts_v, cols_v, val_v = (cloud.points.cpu(), cloud.colors.cpu(),
                                        cloud.valid.cpu())
            except (faults.InjectedCrash, election.FencedWrite):
                raise
            except BaseException as e:
                if (scanner is not None and scanner.device.type == "cuda"
                        and not isinstance(e, faults.InjectedFault)):
                    msg = f"launch: {type(e).__name__}: {e}"
                    for iid, gen, _s, ctx, _f, _t in items:
                        self._item_failed(lane, iid, gen, ctx, msg)
                    return
                poisoned = e
        if poisoned is not None:
            self.log(f"[serve] batch of {len(items)} view(s) degraded to "
                     f"per-view compute ({type(poisoned).__name__}: "
                     f"{poisoned})")
            for it in items:
                self._view_single(lane, it)
            return
        tenants = {it[3].job.tenant for it in items}
        scans = {it[2]["scan"] for it in items}
        self.registry.inc("sl3d_serve_launches_total")
        self.registry.inc("sl3d_serve_launch_views_total", v)
        if len(scans) > 1:
            self.registry.inc("sl3d_serve_cross_scan_launches_total")
        if len(tenants) > 1:
            self.registry.inc("sl3d_serve_cross_tenant_launches_total")
        for j, (iid, gen, spec, ctx, _f, _t) in enumerate(items):
            try:
                pts, cols = tri.compact_cloud(
                    tri.CloudResult(pts_v[j], cols_v[j], val_v[j]))
                self._finish_item(lane, iid, gen, spec, ctx, pts, cols)
            except (faults.InjectedCrash, election.FencedWrite):
                raise
            except BaseException as e:
                self._item_failed(lane, iid, gen, ctx,
                                  f"drain: {type(e).__name__}: {e}")

    # ---- assembly --------------------------------------------------------

    def _queue_settled(self) -> None:
        """Flip admitted scans whose items all settled to WARMED and hand
        them to the assembler (a scan with zero cache-miss items settles
        immediately — the fully-deduped fast path)."""
        with self.adm.lock:
            ready = [sid for sid, j in self.adm.jobs.items()
                     if j.state == "admitted"
                     and self.adm.scan_settled(sid)]
            for sid in ready:
                self.adm.jobs[sid].state = "warmed"
                self.adm.ledger.event("warmed", scan=sid)
        if ready:
            with self._assembly_cv:
                self._assembly_q.extend(ready)
                self._assembly_cv.notify_all()

    def _assembler_loop(self, lead: threading.Event) -> None:
        """ONE assembly at a time: requests share the engine for warming
        but serialize through the single-process pipeline — device
        contention stays simple and the byte parity is the coordinated
        run's."""
        while True:
            with self._assembly_cv:
                while (not self._assembly_q and not self._stop.is_set()
                       and not lead.is_set()):
                    self._assembly_cv.wait(timeout=0.5)
                if lead.is_set():
                    return      # deposed: the new leader owns the queue
                if self._stop.is_set() and not self._assembly_q:
                    return
                sid = self._assembly_q.pop(0)
            adm = self.adm
            if adm is None:     # deposed underneath us
                return
            with adm.lock:
                job = adm.jobs.get(sid)
            if job is None or job.state != "warmed":
                continue        # checkpointed/finished underneath us
            try:
                self._assemble(job)
            except faults.InjectedCrash as e:
                # simulated process death mid-assembly: no finish event
                # journaled, scan left "assembling" — restart re-queues
                # it and re-assembles over the warm cache
                self._crash(f"assembly {sid}", e)
                return
            except election.FencedWrite as e:
                # the terminal journal line was rejected: deposed mid-
                # assembly. The artifacts are fine (atomic writes, same
                # bytes the new leader will produce over the same cache)
                # but the CREDIT belongs to the new epoch — self-demote
                self.log(f"[serve] assembly {sid}: write fenced ({e})")
                self._request_demote(f"assembly {sid}: {e}")
                return

    def _job_log(self, job):
        def _log(msg):
            self.log(f"[{job.scan_id}] {msg}")
        return _log

    def _assemble(self, job) -> None:
        """The request's answer: ``run_pipeline`` over the warmed shared
        cache, in this tenant's namespace, under the request's REMAINING
        SLO budget. Terminal state maps: clean run → done; quarantined
        views above the floor → degraded (its own failures.json); budget
        breach → aborted (its manifest); anything else → failed. The
        service outlives every one of these."""
        st = self._stages
        adm = self.adm      # capture: demotion swaps self.adm to None
        with self._scan_lock:
            ctx = self._scans.get(job.scan_id)
        with adm.lock:
            job.state = "assembling"
        # crash boundary: warmed + journaled, assembly never started —
        # restart finds every view cached and re-assembles for free
        faults.fire("serve.crash", item=f"assembly:{job.scan_id}")
        rcfg = copy.deepcopy(self.cfg)
        rcfg.coordinator.workers = 0
        rem = job.budget_remaining()
        if rem is not None:
            # the run budget, re-based to what the queue+warm phases
            # left; an already-blown budget aborts at the first stage
            # boundary and still leaves a manifest
            rcfg.pipeline.run_budget_s = max(0.05, rem)
        cache = (ctx.cache if ctx is not None else TenantCache(
            self.store_root, job.tenant, ns_root=self.ns_root,
            enabled=True, verify=rcfg.pipeline.verify_cache,
            log=lambda *_: None))
        steps = ctx.steps if ctx is not None else self._engine_steps()
        t0 = time.monotonic()
        state, error, report_d = "failed", "", {}
        try:
            report = st.run_pipeline(job.calib, job.target, job.out_dir,
                                     cfg=rcfg, steps=steps,
                                     log=self._job_log(job), cache=cache,
                                     device=self.device)
            state = "degraded" if report.degraded else "done"
            report_d = {"run_id": report.run_id,
                        "views_computed": report.views_computed,
                        "views_cached": report.views_cached,
                        "merged_points": report.merged_points,
                        "failed_views": len(report.failed),
                        "merged_ply": report.merged_ply,
                        "stl_path": report.stl_path,
                        "assembly_s": round(report.elapsed_s, 3)}
        except dl.DeadlineExceeded as e:
            if self._drain_breach.is_set():
                # not an SLO verdict — the SERVICE ran out of drain
                # budget. Park the scan (failures.json already written by
                # the abort path); the next start() re-queues it
                state, error = "checkpointed", f"drain checkpoint: {e}"
            else:
                state, error = "aborted", f"SLO budget exceeded: {e}"
        except faults.InjectedCrash:
            raise
        except BaseException as e:
            state, error = "failed", f"{type(e).__name__}: {e}"
        finally:
            with self._scan_lock:
                self._scans.pop(job.scan_id, None)
        if state == "checkpointed":
            adm.checkpoint(job.scan_id, reason=error)
            self.registry.inc("sl3d_serve_checkpointed_total",
                              tenant=job.tenant)
        else:
            adm.finish(job.scan_id, state, error=error,
                       report=report_d)
            self._finish_metrics(job, state,
                                 assembly_s=time.monotonic() - t0)
        self.log(f"[serve] {job.scan_id}: {state.upper()} "
                 f"({job.elapsed_s():.2f}s total)" +
                 (f" — {error}" if error else ""))

    def _finish_metrics(self, job, state: str, assembly_s: float = 0.0):
        self.registry.inc("sl3d_serve_requests_total", tenant=job.tenant,
                          state=state)
        self.registry.observe("sl3d_serve_request_seconds",
                              job.elapsed_s(), tenant=job.tenant)
        if assembly_s:
            self.registry.observe("sl3d_serve_assembly_seconds",
                                  assembly_s, tenant=job.tenant)

    # ---- metrics surface -------------------------------------------------

    def metrics_text(self) -> str:
        snap = self.snapshot()
        self.registry.set_gauge("sl3d_serve_scans_active",
                                snap.get("active", 0))
        self.registry.set_gauge("sl3d_serve_scans_queued",
                                snap.get("queued", 0))
        self.registry.set_gauge("sl3d_serve_ready",
                                1.0 if self.phase == "ready" else 0.0)
        self.registry.set_gauge(
            "sl3d_serve_leader",
            1.0 if self.role in ("solo", "leader") else 0.0)
        self.registry.set_gauge("sl3d_serve_epoch", float(self.epoch))
        return tel.prometheus_text(self.registry.as_dict())


# ---- HTTP gateway --------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    """Thin JSON shim over ScanService; one instance per request (stdlib
    threading server), all state on ``self.server.service``."""

    protocol_version = "HTTP/1.1"

    @property
    def service(self) -> ScanService:
        return self.server.service      # type: ignore[attr-defined]

    def log_message(self, fmt, *args):   # route through the service log
        self.service.log("[serve.http] " + fmt % args)

    def _json(self, code: int, body: dict,
              retry_after: float | None = None) -> None:
        data = (json.dumps(body) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if retry_after is not None:
            self.send_header("Retry-After",
                             str(max(1, int(round(retry_after)))))
        self.end_headers()
        self.wfile.write(data)

    def _bytes(self, code: int, data: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path != "/submit":
            return self._json(404, {"error": f"no route {parsed.path!r}"})
        try:
            n = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            return self._json(400, {"error": f"bad JSON body: {e}",
                                    "reason": "bad-request"})
        if isinstance(payload, dict) and not payload.get("api_key"):
            # header form of the credential; the body field wins so a
            # scripted client can carry both through one JSON blob
            key = self.headers.get("X-API-Key")
            if key:
                payload["api_key"] = key
        try:
            faults.fire("http.submit",
                        item=str(payload.get("tenant") or ""))
        except faults.InjectedCrash as e:
            self.service._crash("http.submit", e)
            raise
        except BaseException as e:
            return self._json(503, {"error": f"injected: {e}",
                                    "reason": "transient",
                                    "retry_after_s": 1.0}, retry_after=1.0)
        ok, body = self.service.submit(payload)
        if ok:
            return self._json(200, body)
        # the machine-readable ``reason`` picks the status; retryable
        # rejections (429 backpressure, 503 service-side) carry
        # Retry-After so clients back off instead of hammering
        code = _REASON_HTTP.get(body.get("reason", "bad-request"), 400)
        ra = body.get("retry_after_s", 1.0) if code in (429, 503) else None
        return self._json(code, body, retry_after=ra)

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        path = parsed.path
        if path == "/healthz":
            snap = self.service.snapshot()
            phase = self.service.phase
            return self._json(200, {"ok": phase == "ready",
                                    "phase": phase,
                                    "role": snap["role"],
                                    "epoch": snap["epoch"],
                                    "run_id": snap["run_id"],
                                    "active": snap["active"],
                                    "queued": snap["queued"]})
        if path == "/metrics":
            return self._bytes(200, self.service.metrics_text().encode(),
                               "text/plain; version=0.0.4")
        if path == "/usage":
            q = urllib.parse.parse_qs(parsed.query)
            tenant = (q.get("tenant") or [None])[0]
            return self._json(200, self.service.usage(tenant))
        if path.startswith("/status/"):
            d = self.service.status(path[len("/status/"):])
            if d is None:
                return self._json(404, {"error": "unknown scan_id"})
            return self._json(200, d)
        if path.startswith("/result/"):
            scan_id = path[len("/result/"):]
            q = urllib.parse.parse_qs(parsed.query)
            artifact = (q.get("artifact") or ["ply"])[0]
            fpath, err = self.service.result_path(scan_id, artifact)
            if not fpath:
                code = 409 if err.get("state") else 404
                return self._json(code, err)
            with open(fpath, "rb") as f:
                return self._bytes(200, f.read(),
                                   "application/octet-stream")
        return self._json(404, {"error": f"no route {path!r}"})


def start_gateway(root: str, cfg: Config | None = None, log=print,
                  ready_file: str | None = None, device=None):
    """Bind + start the service on ``device`` (None → cuda) WITHOUT
    blocking: returns (httpd, svc). The caller runs
    ``httpd.serve_forever`` (``serve`` does, on the main thread; tests push
    it to a daemon thread) and tears down with ``httpd.shutdown();
    httpd.server_close(); svc.close()``. Writes ``<root>/serve.json`` (and
    optional ``ready_file``) with the bound address — the discovery
    handshake for clients."""
    cfg = cfg or Config()
    svc = ScanService(root, cfg=cfg, log=log, device=device)
    httpd = ThreadingHTTPServer((cfg.serving.host, cfg.serving.port),
                                _Handler)
    httpd.service = svc                  # type: ignore[attr-defined]
    httpd.daemon_threads = True
    host, port = httpd.server_address[0], httpd.server_address[1]
    # the bound address must be known BEFORE start(): an HA member that
    # wins the election advertises it in the lease + serve.json
    svc.advertise(host, port, argv=sys.argv)
    svc.start()
    if not svc.ha:
        # solo: publish the discovery handshake now (epoch 0). HA:
        # serve.json is the LEADER's to write — _promote rewrites it
        # atomically with the new epoch on every takeover
        svc._publish_serve_json()
    info = {"host": host, "port": port, "pid": os.getpid(),
            "run_id": svc.run_id, "root": svc.root, "role": svc.role,
            "epoch": svc.epoch,
            "argv": list(sys.argv)}   # the relaunch recipe
    if ready_file:
        with open(ready_file, "w") as f:
            json.dump(info, f)
    log(f"[serve] listening on http://{host}:{port} role={svc.role} "
        f"(endpoints: /submit /status/<id> /result/<id> /metrics "
        f"/healthz /usage)")
    return httpd, svc


def serve(root: str, cfg: Config | None = None, log=print,
          ready_file: str | None = None, device=None) -> int:
    """Run the gateway on ``device`` (None → cuda) until interrupted (the
    ``serve`` command).

    SIGTERM and SIGINT both DRAIN: new submits 503 with Retry-After,
    active scans get ``serving.drain_budget_s`` to finish or checkpoint,
    then the process exits cleanly — a container stop is a resume point,
    not a data loss. An injected ``serve.crash`` under this entry exits
    the process 137 (the twin of a kill -9)."""
    cfg = cfg or Config()
    faults.configure_from(cfg.faults)
    httpd, svc = start_gateway(root, cfg=cfg, log=log,
                               ready_file=ready_file, device=device)
    svc.exit_on_crash = True

    def _on_signal(signum, frame):
        log(f"[serve] signal {signum}; draining")
        # serve_forever must NOT be shut down from inside its own
        # signal frame (deadlock); a helper thread breaks the loop
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    prev = {}
    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[s] = signal.signal(s, _on_signal)
        except ValueError:
            pass        # not the main thread (tests drive serve() there)
    try:
        httpd.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        log("[serve] interrupted; draining")
    finally:
        for s, h in prev.items():
            try:
                signal.signal(s, h)
            except ValueError:
                pass
        httpd.server_close()
        svc.stop()
        log("[serve] stopped cleanly; restart resumes from "
            f"{svc.root}")
    return 0
