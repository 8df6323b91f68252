"""Deterministic fault injection + the retry/quarantine toolkit.

The scan-to-print chain is a long sequence of fallible steps (serial turntable
moves, HTTP frame capture, per-view decode/triangulate, disk I/O). This module
supplies the two halves of making that chain resilient:

1. **Fault injection** — named sites in the product code call :func:`fire`;
   a :class:`FaultPlan` (armed from the ``faults`` config section or the
   ``SL3D_FAULTS`` env var, seeded so chaos runs are reproducible) decides
   which calls raise. Disabled by default: ``fire`` is a single ``None``
   check, so production paths pay nothing.

   Sites wired through the port (the JAX package's names):

   ====================  ====================================================
   ``frame.load``        per-view frame-stack load (both reconstruct lanes)
   ``frame.pack``        bit-plane pack/unpack codec step of a packed
                         source or of the packed-ingest loader
   ``compute.view``      per-view decode+triangulate dispatch (the batched
                         lane fires it per view at batch assembly)
   ``ply.write``         every PLY/STL artifact write (io/ply.py, io/stl.py)
   ``cache.get``         stage-cache lookup (pipeline/stagecache.py)
   ``cache.put``         stage-cache publish
   ``register.pair``     streamed-merge pair registration (item is
                         ``"<dst>-><src>"`` view indices; an exhausted or
                         permanent hit falls back to the identity transform)
   ``serial.rotate``     every turntable rotation (acquire/turntable.py;
                         item is the port name, ``sim`` or ``loopback``)
   ``http.capture``      each Android camera-host capture attempt
                         (acquire/android.py; item is the host URL)
   ``worker.item``       each leased item a coordinated worker starts
                         (parallel/worker.py; item is ``"<worker>:<item>"``)
   ``worker.sock``       each control frame on the coordinator or blob-store
                         wire (where ``net.slowlink`` delays)
   ``coord.grant``       each grant, before it is journaled (coordinator)
   ``ledger.append``     each ledger event, before its append
   ``blob.fetch``        each blob-store fetch / push (pipeline/blobstore.py)
   ``blob.push``
   ``serve.crash``       the serving gateway's crash boundaries (item is
                         ``"grant:<item>"``, ``"complete:<item>"`` or
                         ``"assembly:<scan_id>"``; pipeline/serving.py)
   ``http.submit``       each gateway /submit before admission
   ``election.acquire``  each HA leader-lease acquire / renew attempt (item
   ``election.renew``    is the member's owner id; parallel/election.py)
   ``fleet.decide``      each fleet supervisor decision (parallel/fleet.py)
   ``worker.spawn``      each fleet worker spawn, after its journal line
   ====================  ====================================================

   ``frame.pack`` also fires in the capture sequencer's pack-on-capture
   step (acquire/sequencer.py; item is the view folder).

2. **Retry/quarantine toolkit** — the exception classifier
   (:func:`is_transient`), the bounded exponential-backoff
   :class:`RetryPolicy` + :func:`retry_call`, and the structured
   :class:`FailureRecord` the pipeline quarantines permanently-failed views
   with.

Fault-spec grammar (comma-separated rules)::

    site[~substr]:kind[@n][xM][%p]

    kind     transient | permanent | crash | stall[(T)] | slow[(T)]
             | worker.kill | worker.preempt[(T)] | net.partition[(T)]
             | net.slowlink[(T)]
    ~substr  only fire() calls whose item contains substr count as hits
    @n       arm on the n-th matching hit (1-based; default 1)
    xM       fire at most M times (default: unlimited for permanent,
             1 for every other kind)
    %p       each armed hit fires with probability p (seeded RNG)

Examples::

    frame.load:transient                 first stack load fails once
    compute.view~144deg:permanent        view 144deg never decodes
    ply.write:transient@2x3              writes 2,3,4 fail
    cache.get:transient%0.5              each lookup fails with p=.5 (seeded)
    ply.write~merged:crash               simulated kill -9 at the merged write
    register.pair:stall(2.5)             first pair registration hangs 2.5s
    frame.load~072deg:slow(0.5)          view 072deg's load straggles 0.5s

``transient``/``permanent`` raise ordinary exceptions the retry/quarantine
machinery handles; ``crash`` raises :class:`InjectedCrash` (a BaseException,
like KeyboardInterrupt) that no per-item handler may swallow — the
interrupt-mid-stage simulation for crash-safety tests.

``stall``/``slow`` model faults that do not raise at all: the ``fire()``
call BLOCKS for T seconds (defaults: ``STALL_DEFAULT_S``/``SLOW_DEFAULT_S``)
and then returns normally, as if the wedge resolved. Both are cancel-aware
(:func:`~.deadline.sleep_cancellable`): a watchdog hard breach cancels the
run token and the sleeping site raises :class:`~.deadline.Cancelled`
instead — so injected hangs are always bounded and chaos tests terminate.
``stall`` is the hang the deadline layer must catch (pick T above the
lane's deadline); ``slow`` is the straggler that must trip only the SOFT
watchdog threshold and still complete.

The **host-scope kinds** (``worker.kill``, ``worker.preempt(T)``,
``net.partition(T)``, ``net.slowlink(T)``) model whole-process fates in
coordinated multi-process runs: a worker (``parallel/worker.py``) exits
137 on ``worker.kill``, 143 after the grace of ``worker.preempt``, finishes
its item cut off from the coordinator and reports it late on
``net.partition``; ``net.slowlink`` delays each wire frame. One spec string
means the same in both packages.
"""
from __future__ import annotations

import math
import os
import random
import threading
import time
import urllib.error
from dataclasses import dataclass, field

from structured_light_for_3d_model_replication_tpu_torch.utils import (
    deadline as dl,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import telemetry

__all__ = [
    "InjectedFault", "TransientFault", "PermanentFault", "InjectedCrash",
    "WorkerKilled", "WorkerPreempted", "NetPartition",
    "FaultRule", "FaultPlan", "configure", "configure_from", "reset", "fire",
    "active_plan", "is_transient", "RetryPolicy", "retry_call", "annotate",
    "jitter_rng", "FailureRecord", "STALL_DEFAULT_S", "SLOW_DEFAULT_S",
    "PREEMPT_GRACE_DEFAULT_S", "PARTITION_DEFAULT_S", "SLOWLINK_DEFAULT_S",
]


# ---------------------------------------------------------------------------
# injected exception types
# ---------------------------------------------------------------------------

class InjectedFault(RuntimeError):
    """Base of the injectable (catchable) faults."""

    transient = False


class TransientFault(InjectedFault):
    """Models a recoverable blip (dropped connection, EAGAIN, torn read)."""

    transient = True


class PermanentFault(InjectedFault):
    """Models a deterministic failure (corrupt capture, bad view)."""

    transient = False


class InjectedCrash(BaseException):
    """Simulated ``kill -9``: escapes every ``except Exception`` handler, so
    per-item tolerance cannot swallow it — only crash-safe artifact handling
    (tmp+rename, startup sweeps, the stage cache) may mask its effects."""


class WorkerKilled(InjectedCrash):
    """Host-scope ``worker.kill``: the worker loop must die IMMEDIATELY
    (``os._exit``, no cleanup) — the SIGKILL / OOM-kill simulation. An
    InjectedCrash subclass so no per-item handler can absorb it."""


class WorkerPreempted(InjectedCrash):
    """Host-scope ``worker.preempt(T)``: the worker got a preemption notice
    with ``grace_s`` seconds to vacate. The loop stops taking work and
    exits after the grace window; in-flight leases expire and are stolen."""

    def __init__(self, detail: str, grace_s: float):
        super().__init__(detail)
        self.grace_s = grace_s


class NetPartition(TransientFault):
    """Host-scope ``net.partition(T)``: the worker's link to the
    coordinator goes dark for ``duration_s`` seconds. Transient — the
    worker survives, reconnects, and may find its leases stolen."""

    def __init__(self, detail: str, duration_s: float):
        super().__init__(detail)
        self.duration_s = duration_s


# ---------------------------------------------------------------------------
# the fault plan
# ---------------------------------------------------------------------------

_KINDS = ("transient", "permanent", "crash", "stall", "slow",
          "worker.kill", "worker.preempt", "net.partition",
          "net.slowlink")

# the kinds that accept a ``(T)`` duration, and what T means for each:
# stall/slow/net.slowlink block for T; worker.preempt grants T of grace
# before the forced exit; net.partition keeps the link dark for T
_DURATION_KINDS = ("stall", "slow", "worker.preempt", "net.partition",
                   "net.slowlink")

# default block durations for the non-raising kinds when no ``(T)`` is
# given. Long enough to trip production-default lane deadlines / the
# watchdog; chaos tests pass explicit small durations
STALL_DEFAULT_S = 30.0
SLOW_DEFAULT_S = 1.0
PREEMPT_GRACE_DEFAULT_S = 0.5
PARTITION_DEFAULT_S = 1.0
SLOWLINK_DEFAULT_S = 0.25   # per-frame delay: visible, never lease-fatal


@dataclass
class FaultRule:
    site: str
    kind: str
    match: str = ""
    arm_at: int = 1          # start firing on the n-th matching hit
    times: float = math.inf  # how many times to fire once armed
    prob: float = 1.0        # per-armed-hit probability (seeded)
    duration_s: float | None = None  # stall/slow block time (None=default)
    hits: int = 0
    fired: int = 0

    @classmethod
    def parse(cls, text: str) -> "FaultRule":
        head, sep, tail = text.strip().partition(":")
        if not sep:
            raise ValueError(f"fault rule {text!r}: expected site:kind")
        site, _, match = head.partition("~")
        kind, arm_at, times, prob = tail, 1, None, 1.0
        if "%" in kind:
            kind, p = kind.split("%", 1)
            prob = float(p)
        if "x" in kind:     # no kind name or (T) digits contain an 'x'
            kind, m = kind.split("x", 1)
            times = int(m)
        if "@" in kind:
            kind, n = kind.split("@", 1)
            arm_at = int(n)
        duration = None
        if kind.endswith(")") and "(" in kind:
            kind, d = kind[:-1].split("(", 1)
            duration = float(d)
        if kind not in _KINDS:
            raise ValueError(
                f"fault rule {text!r}: kind {kind!r} not in {_KINDS}")
        if duration is not None and kind not in _DURATION_KINDS:
            raise ValueError(
                f"fault rule {text!r}: only "
                f"{'/'.join(_DURATION_KINDS)} take a (T) duration")
        if times is None:
            times = math.inf if kind == "permanent" else 1
        return cls(site=site.strip(), kind=kind, match=match,
                   arm_at=arm_at, times=times, prob=prob,
                   duration_s=duration)

    @property
    def block_s(self) -> float:
        """Effective ``(T)`` duration for the duration-taking kinds."""
        if self.duration_s is not None:
            return self.duration_s
        return {"stall": STALL_DEFAULT_S,
                "worker.preempt": PREEMPT_GRACE_DEFAULT_S,
                "net.partition": PARTITION_DEFAULT_S,
                "net.slowlink": SLOWLINK_DEFAULT_S,
                }.get(self.kind, SLOW_DEFAULT_S)

    def throw(self) -> None:
        detail = (f"injected {self.kind} fault at {self.site}"
                  + (f" (match {self.match!r})" if self.match else ""))
        if self.kind == "worker.kill":
            raise WorkerKilled(detail)
        if self.kind == "worker.preempt":
            raise WorkerPreempted(detail, grace_s=self.block_s)
        if self.kind == "net.partition":
            raise NetPartition(detail, duration_s=self.block_s)
        if self.kind == "crash":
            raise InjectedCrash(detail)
        if self.kind == "transient":
            raise TransientFault(detail)
        raise PermanentFault(detail)


class FaultPlan:
    """A parsed, seeded fault plan. Thread-safe: fire() is called from the
    prefetch/drain/writeback worker threads as well as the main thread."""

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        self.rules = rules
        self.seed = seed
        self._rng = random.Random(seed)
        # a SEPARATE seeded stream for retry-backoff jitter: drawing
        # jitter from ``_rng`` would shift the %p decision sequence,
        # changing which faults fire between jittered and unjittered runs
        self._jitter_rng = random.Random(seed ^ 0x6A77)
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultPlan":
        rules = [FaultRule.parse(r) for r in spec.split(",") if r.strip()]
        return cls(rules, seed)

    def fire(self, site: str, item=None) -> None:
        text = "" if item is None else str(item)
        hit: FaultRule | None = None
        # decide under the lock, act OUTSIDE it: a stall/slow rule sleeps
        # for seconds, and holding the plan lock through that would
        # serialize every other lane's fire() behind the injected wedge
        with self._lock:
            for rule in self.rules:
                if rule.site != site:
                    continue
                if rule.match and rule.match not in text:
                    continue
                rule.hits += 1
                if rule.hits < rule.arm_at or rule.fired >= rule.times:
                    continue
                if rule.prob < 1.0 and self._rng.random() > rule.prob:
                    continue
                rule.fired += 1
                hit = rule
                break
        if hit is None:
            return
        tr = telemetry.current()
        if tr is not None:
            # chaos runs leave their injections in the journal, so
            # the fault ledger needs no log scraping
            tr.instant("fault.injected", site=site, kind=hit.kind,
                       item=text or None,
                       duration_s=(hit.block_s
                                   if hit.kind in _DURATION_KINDS
                                   else None))
        if hit.kind in ("stall", "slow", "net.slowlink"):
            # block, then RESUME normally (a wedge that eventually
            # resolves); cancel-aware so a watchdog hard breach raises
            # deadline.Cancelled out of the sleep and the item is
            # abandoned instead of waiting out the full duration
            dl.sleep_cancellable(
                hit.block_s,
                what=f"injected {hit.kind} at {site}"
                     + (f" ({text})" if text else ""))
            return
        hit.throw()

    def counts(self) -> dict[str, int]:
        """Fired-per-site accounting (for manifests and assertions)."""
        out: dict[str, int] = {}
        for r in self.rules:
            if r.fired:
                out[r.site] = out.get(r.site, 0) + r.fired
        return out


# module-global active plan; None (the default) means every fire() is a no-op
_PLAN: FaultPlan | None = None


def configure(spec: str = "", seed: int = 0) -> FaultPlan | None:
    """Install a fault plan process-wide; empty spec deactivates. Returns the
    installed plan (or None)."""
    global _PLAN
    _PLAN = FaultPlan.from_spec(spec, seed) if spec.strip() else None
    return _PLAN


def configure_from(faults_cfg) -> FaultPlan | None:
    """Arm from a ``FaultsConfig`` section; the ``SL3D_FAULTS`` /
    ``SL3D_FAULTS_SEED`` env vars win over the config (the chaos-run switch
    that needs no config file edit)."""
    spec = os.environ.get("SL3D_FAULTS", "")
    if spec:
        seed = int(os.environ.get("SL3D_FAULTS_SEED", "0"))
    else:
        spec = getattr(faults_cfg, "spec", "") or ""
        seed = int(getattr(faults_cfg, "seed", 0) or 0)
    return configure(spec, seed)


def reset() -> None:
    configure("")


def active_plan() -> FaultPlan | None:
    return _PLAN


def fire(site: str, item=None) -> None:
    """Injection site: raises per the active plan; no-op (one None check)
    when no plan is armed — the zero-overhead-by-default contract."""
    if _PLAN is None:
        return
    _PLAN.fire(site, item)


# ---------------------------------------------------------------------------
# transient-vs-permanent classification
# ---------------------------------------------------------------------------

_TRANSIENT_ERRNOS = frozenset({
    4,    # EINTR
    11,   # EAGAIN
    16,   # EBUSY
    104,  # ECONNRESET
    110,  # ETIMEDOUT
    111,  # ECONNREFUSED (service restarting)
})


def is_transient(exc: BaseException) -> bool:
    """Classify an exception as transient (worth a bounded retry) or
    permanent (retry is wasted work; quarantine instead).

    Unknown exception types default to permanent — a retry budget spent on a
    deterministic failure just delays the quarantine decision."""
    if isinstance(exc, InjectedFault):
        return exc.transient
    if isinstance(exc, dl.Cancelled):
        # a cancelled item was abandoned by the watchdog/run teardown;
        # retrying would re-enter the wedge the cancel just broke
        return False
    if isinstance(exc, (ConnectionError, TimeoutError)):
        # includes deadline.DeadlineExceeded (a TimeoutError subclass):
        # hitting a deadline is a scheduling outcome, not proof the item
        # is poisoned, so a retry budget MAY be spent on it
        return True
    if isinstance(exc, urllib.error.URLError):
        # wraps socket-level failures; the HTTP capture path's blip class
        return True
    if isinstance(exc, OSError):
        return exc.errno in _TRANSIENT_ERRNOS
    return False


# ---------------------------------------------------------------------------
# bounded retry + exponential backoff
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: retry ``max_retries`` times, sleeping
    ``backoff_base_s * 2**(retry-1)`` (capped at ``backoff_max_s``) before
    each. ``max_retries=0`` disables retrying entirely.

    ``jitter=True`` turns each sleep into FULL jitter — uniform in
    ``[0, delay_s(retry)]`` — so N workers tripping over the same
    transient (a coordinator blip, a shared-mount hiccup) spread their
    retries instead of thundering back in lockstep. The draw comes from
    the armed fault plan's seeded jitter stream (:func:`jitter_rng`), so
    chaos tests stay reproducible; ``delay_s`` itself stays deterministic
    (it is the CEILING, and what retry logs/traces may quote)."""

    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_max_s: float = 1.0
    jitter: bool = False

    def delay_s(self, retry: int) -> float:
        """Deterministic backoff ceiling before the ``retry``-th retry
        (1-based). With ``jitter``, the actual sleep is drawn uniformly
        below this inside :func:`retry_call`."""
        return min(self.backoff_base_s * (2.0 ** (retry - 1)),
                   self.backoff_max_s)


_JITTER_FALLBACK = random.Random()


def jitter_rng() -> random.Random:
    """The seeded jitter stream when a fault plan is armed (deterministic
    chaos runs), else an OS-seeded RNG (real runs, where true randomness
    is exactly what anti-herd jitter wants)."""
    plan = _PLAN
    if plan is not None:
        return plan._jitter_rng
    return _JITTER_FALLBACK


def retry_call(fn, policy: RetryPolicy, *, classify=is_transient,
               on_retry=None, sleep=time.sleep):
    """Run ``fn()`` with the policy's transient-retry budget.

    Permanent (per ``classify``) or budget-exhausted exceptions re-raise the
    ORIGINAL exception annotated with ``_sl3d_attempts`` (total attempts
    made) so failure records can report the true attempt count.
    ``on_retry(retry_index, exc)`` fires before each backoff sleep — the
    hook retry counters and logs hang off. :class:`InjectedCrash` is never
    retried (it models a process kill)."""
    attempts = 1
    while True:
        try:
            return fn()
        except InjectedCrash:
            raise
        except Exception as e:
            retries_done = attempts - 1
            if retries_done >= policy.max_retries or not classify(e):
                annotate(e, attempts=attempts)
                raise
            if on_retry is not None:
                on_retry(retries_done + 1, e)
            delay = policy.delay_s(retries_done + 1)
            if policy.jitter:
                delay = jitter_rng().uniform(0.0, delay)
            tr = telemetry.current()
            if tr is not None:
                tr.instant("retry", attempt=retries_done + 1,
                           error=type(e).__name__,
                           backoff_s=round(delay, 4))
            sleep(delay)
            attempts += 1


def annotate(exc: BaseException, stage: str | None = None,
             attempts: int | None = None) -> BaseException:
    """Attach failure-record context to an exception that will cross a
    thread/future boundary before being recorded."""
    if stage is not None:
        exc._sl3d_stage = stage  # type: ignore[attr-defined]
    if attempts is not None:
        exc._sl3d_attempts = attempts  # type: ignore[attr-defined]
    return exc


# ---------------------------------------------------------------------------
# structured failure records (the quarantine payload)
# ---------------------------------------------------------------------------

@dataclass
class FailureRecord:
    """One per-item failure, structured for the failure manifest: which
    stage, which view, how many attempts were made, what raised, and whether
    the final exception classified transient (budget exhausted) or permanent
    (not worth retrying)."""

    stage: str
    view: str
    attempts: int
    error_type: str
    message: str
    transient: bool
    extra: dict = field(default_factory=dict)

    @classmethod
    def from_exception(cls, stage: str, view: str, exc: BaseException,
                       attempts: int | None = None) -> "FailureRecord":
        return cls(
            stage=getattr(exc, "_sl3d_stage", None) or stage,
            view=view,
            attempts=attempts if attempts is not None
            else getattr(exc, "_sl3d_attempts", 1),
            error_type=type(exc).__name__,
            message=str(exc),
            transient=is_transient(exc),
        )

    def as_dict(self) -> dict:
        out = {"stage": self.stage, "view": self.view,
               "attempts": self.attempts, "error_type": self.error_type,
               "message": self.message, "transient": self.transient}
        if self.extra:
            out["extra"] = self.extra
        return out
