"""Deadlines, cooperative cancellation, and the lane watchdog.

Retries and quarantine handle faults that *raise*; this module handles the
ones that never return: a wedged frame load, device dispatch, PLY write or
pair registration would otherwise freeze a scan with no diagnostic.

  - :class:`Deadline` — a monotonic-clock time budget (``time.monotonic``
    only; wall-clock arithmetic drifts across NTP steps/suspends and is
    banned for deadlines repo-wide).
  - :class:`DeadlineExceeded` — raised when a budget runs out. Subclasses
    :class:`TimeoutError`, so ``faults.is_transient`` classifies it
    TRANSIENT: a deadline hit is a scheduling outcome, not proof the item
    is poisoned, and a retry budget *may* be spent on it where one exists.
  - :class:`CancelToken` — cooperative cancellation. Nothing in Python can
    safely kill a wedged thread; instead, long sleeps and injected stalls
    poll the token (:func:`sleep_cancellable`) and raise
    :class:`Cancelled` (classified PERMANENT — a cancelled item is
    abandoned, never retried).
  - :func:`wait_future` / :func:`wait_settled` — the bounded replacements
    for bare ``Future.result()`` / ``Future.exception()``. Built on
    ``concurrent.futures.wait`` so a poll-window expiry can never be
    confused with a ``TimeoutError`` *raised by the work itself* (on
    py3.11+ ``futures.TimeoutError`` IS builtin ``TimeoutError``).
  - :class:`Watchdog` — a daemon thread consuming the lane heartbeats
    that ``OverlapStats.add``/``add_pair_launch`` emit (the
    can't-drift pattern: the same calls that accumulate lane walls feed
    the liveness signal, so the two can never disagree). No heartbeat
    from ANY lane for ``soft_stall_s`` -> a ``watchdog.stall`` trace
    event + warning; for ``hard_stall_s`` -> the run token is cancelled
    (breaking any cancel-aware stall so its item quarantines like a
    permanently-failed one) and every thread's stack is dumped via
    ``faulthandler`` into a crash-safe ``stalls.json`` next to
    ``failures.json``. When progress resumes the cancel level is lowered
    again — the token is a stall-breaker, not a run abort.

Ambient context (the ``faults._PLAN`` / ``telemetry._TRACER`` pattern):
``run_pipeline``/``reconstruct`` install a :class:`RunContext` with
:func:`activate`; hot paths fetch it with :func:`current` (one
module-global ``None`` check when the deadline layer is disabled — the
zero-overhead-by-default contract the faults and telemetry layers hold).

Division of labor, by where a stall lives:

  worker-thread stall   the main thread's bounded ``wait_future`` on that
                        item's future raises :class:`DeadlineExceeded`
                        after the lane budget -> the item is recorded and
                        quarantined, the run continues (DEGRADED above
                        the survivor floor)
  main-thread stall     no future guards it; the watchdog's hard breach
                        cancels the token and a cancel-aware stall
                        raises :class:`Cancelled` out of the wedge ->
                        same per-item quarantine path
  real hard hang        cannot be interrupted from Python; the watchdog
                        still dumps every thread's stack to
                        ``stalls.json`` so the wedge is diagnosable from
                        artifacts, and the overall ``pipeline.
                        run_budget_s`` bounds everything reachable from
                        the main thread
"""
from __future__ import annotations

import faulthandler
import json
import os
import threading
import time
from concurrent.futures import wait as _futures_wait
from dataclasses import dataclass, field

from structured_light_for_3d_model_replication_tpu_torch.utils import telemetry

__all__ = [
    "DeadlineExceeded", "Cancelled", "Deadline", "CancelToken",
    "wait_future", "wait_settled", "sleep_cancellable", "Watchdog",
    "RunContext", "activate", "deactivate", "current", "beat",
    "watchdog_suspend", "watchdog_resume", "STALLS_SCHEMA",
]

STALLS_SCHEMA = "sl3d-stalls-v1"


class DeadlineExceeded(TimeoutError):
    """A time budget ran out. TimeoutError subclass on purpose:
    ``faults.is_transient`` classifies it transient — hitting a deadline
    is a scheduling outcome, not proof the item is poisoned."""


class Cancelled(RuntimeError):
    """The run's CancelToken was raised while this op waited/slept. NOT
    transient: a cancelled item is abandoned (quarantined), never
    retried — retrying would re-enter the wedge the cancel broke."""


class Deadline:
    """Monotonic-clock time budget. ``None`` (from :meth:`after` with a
    non-positive budget) means unbounded everywhere it is accepted."""

    __slots__ = ("t_end", "budget_s", "what")

    def __init__(self, budget_s: float, what: str = ""):
        self.budget_s = float(budget_s)
        self.t_end = time.monotonic() + self.budget_s
        self.what = what

    @classmethod
    def after(cls, budget_s: float | None,
              what: str = "") -> "Deadline | None":
        """A Deadline ``budget_s`` from now, or None for no/zero budget —
        the config convention (``0`` == unbounded) in one place."""
        if budget_s is None or budget_s <= 0:
            return None
        return cls(budget_s, what)

    def remaining(self) -> float:
        return self.t_end - time.monotonic()

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.t_end

    def check(self, what: str = "") -> None:
        if self.expired:
            label = what or self.what or "operation"
            raise DeadlineExceeded(
                f"{label} exceeded its {self.budget_s:g}s budget")


class CancelToken:
    """Cooperative cancellation flag. ``cancel`` is a LEVEL, not an edge:
    the watchdog raises it to break a wedge and lowers it (:meth:`clear`)
    once the run makes progress again, so one stalled item is abandoned
    without dragging the rest of the run down with it."""

    def __init__(self):
        self._event = threading.Event()
        self._reason = ""
        self._lock = threading.Lock()

    def cancel(self, reason: str = "") -> None:
        with self._lock:
            if reason:
                self._reason = reason
        self._event.set()

    def clear(self) -> None:
        """Lower the cancel level (the watchdog's progress-resumed path)."""
        self._event.clear()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    @property
    def reason(self) -> str:
        return self._reason

    def check(self, what: str = "") -> None:
        if self._event.is_set():
            detail = self._reason or "cancelled"
            raise Cancelled(f"{what or 'operation'} cancelled ({detail})")

    def wait(self, timeout_s: float) -> bool:
        """Block up to ``timeout_s`` for cancellation; True if cancelled."""
        return self._event.wait(timeout_s)


def wait_future(fut, timeout_s: float | None, what: str = ""):
    """``fut.result()`` bounded by ``timeout_s`` (None/<=0 = unbounded).

    Built on ``concurrent.futures.wait`` so the poll expiry is decided by
    *settledness*, never by catching TimeoutError — a work function that
    itself raises TimeoutError propagates immediately instead of being
    mistaken for an unexpired wait (futures.TimeoutError aliases the
    builtin on py3.11+)."""
    if timeout_s is None or timeout_s <= 0:
        return fut.result()
    done, _ = _futures_wait([fut], timeout=timeout_s)
    if not done:
        raise DeadlineExceeded(
            f"{what or 'future'} still pending after {timeout_s:g}s")
    return fut.result()


def wait_settled(fut, timeout_s: float | None) -> bool:
    """Block until ``fut`` settles (result OR exception — never raises
    either), bounded by ``timeout_s``; False if still pending at expiry.
    The backpressure-wait twin of :func:`wait_future`: callers that only
    need "is the slot free yet" must not hang on a wedged slot. A future a
    pool's ``shutdown(cancel_futures=True)`` cancelled is settled: it never
    notifies ``concurrent.futures.wait``, so it is answered here."""
    if fut.done():
        return True
    if timeout_s is None or timeout_s <= 0:
        fut.exception()     # blocks without raising the work's error
        return True
    done, _ = _futures_wait([fut], timeout=timeout_s)
    return bool(done)


def sleep_cancellable(seconds: float, token: CancelToken | None = None,
                      what: str = "") -> None:
    """Sleep ``seconds`` unless the token (given, or the ambient run
    context's) is cancelled first — then raise :class:`Cancelled`. The
    primitive injected stalls/slows are built on, so chaos tests always
    terminate: a stall is breakable by the watchdog and bounded by its
    own duration."""
    if token is None:
        ctx = _CTX
        token = ctx.token if ctx is not None else None
    if token is None:
        time.sleep(max(0.0, seconds))
        return
    if token.wait(max(0.0, seconds)):
        token.check(what)   # raises Cancelled with the cancel reason


# ---------------------------------------------------------------------------
# the lane watchdog
# ---------------------------------------------------------------------------

class Watchdog:
    """Daemon thread that turns lane heartbeats into stall diagnostics.

    ``beat(lane)`` is called from inside ``OverlapStats.add`` /
    ``add_pair_launch`` (via the ambient :func:`beat`) — the same calls
    that accumulate lane walls, so liveness and accounting cannot drift.
    The poll loop tracks the age of the NEWEST heartbeat across all lanes
    (per-lane idleness is normal — the write lane goes quiet once writes
    finish; a run where *no* lane beats is wedged):

      age >= soft_stall_s   one ``watchdog.stall`` trace event + warning
                            per stall episode (re-armed when progress
                            resumes)
      age >= hard_stall_s   cancel the run token (any cancel-aware stall
                            raises Cancelled out of the wedge -> its item
                            quarantines), dump EVERY thread's stack via
                            ``faulthandler`` into a crash-safe
                            ``stalls.json``, keep polling; the cancel
                            level drops again on the next heartbeat

    All breaches are retained in ``self.breaches`` (the stall ledger);
    ``stop()`` persists them even when the hard path never fired.
    """

    def __init__(self, soft_stall_s: float, hard_stall_s: float,
                 token: CancelToken, poll_s: float = 1.0,
                 out_dir: str | None = None, run_id: str | None = None,
                 log=None, heartbeat_trace_min_s: float = 1.0):
        self.soft_s = float(soft_stall_s)
        self.hard_s = float(hard_stall_s)
        self.poll_s = max(0.01, float(poll_s))
        self.token = token
        self.out_dir = out_dir
        self.run_id = run_id
        self.log = log or (lambda m: None)
        self.breaches: list[dict] = []
        self.stalls_path = os.path.join(out_dir, "stalls.json") if out_dir else None
        self._hb_trace_min_s = float(heartbeat_trace_min_s)
        self._lock = threading.Lock()
        self._beats: dict[str, float] = {}
        self._hb_emitted: dict[str, float] = {}
        self._t0 = time.monotonic()
        self._soft_fired = False
        self._hard_fired = False
        self._suspended = 0
        self._t_resume = self._t0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- heartbeat sink (any thread, hot path) ----------------------------

    def beat(self, lane: str) -> None:
        now = time.monotonic()
        emit = False
        with self._lock:
            self._beats[lane] = now
            # throttled lane.heartbeat instants: liveness in the journal
            # without a line per OverlapStats.add call
            if now - self._hb_emitted.get(lane, 0.0) >= self._hb_trace_min_s:
                self._hb_emitted[lane] = now
                emit = True
        if emit:
            tr = telemetry.current()
            if tr is not None:
                tr.instant("lane.heartbeat", lane=lane)

    def lane_ages(self) -> dict[str, float]:
        """Seconds since each lane's last heartbeat (the ledger payload)."""
        now = time.monotonic()
        with self._lock:
            return {ln: round(now - ts, 3) for ln, ts in self._beats.items()}

    def suspend(self) -> None:
        """Pause breach detection (re-entrant). The barrier stages
        (merge accumulate, Poisson mesh) are single opaque device/numpy
        calls: no cooperative mechanism can observe progress inside them,
        so 'no heartbeat' there is expected, not a stall — those phases
        are covered by the overall run budget instead."""
        with self._lock:
            self._suspended += 1

    def resume(self) -> None:
        """End one ``suspend``. The suspended time is not silence: the age
        clock restarts, and a breach fires again on a new stall."""
        with self._lock:
            self._suspended = max(0, self._suspended - 1)
            self._t_resume = time.monotonic()
            self._soft_fired = False
            self._hard_fired = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="sl3d-watchdog")
        self._thread.start()

    def stop(self) -> None:
        """Stop polling and persist the stall ledger (if any breaches).
        Idempotent; runs in the pipeline's ``finally``."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(1.0, 4 * self.poll_s))
            self._thread = None
        if self.breaches and self.stalls_path:
            self._write_stalls()

    # -- poll loop ---------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self._poll()
            except Exception:   # the watchdog must never kill the run
                pass

    def _poll(self) -> None:
        now = time.monotonic()
        with self._lock:
            if self._suspended:
                return
            last = max(self._beats.values(), default=self._t0)
            last = max(last, self._t_resume)
        age = now - last
        if age < self.soft_s:
            if self._hard_fired and self.token.cancelled:
                # progress resumed after a hard breach: lower the cancel
                # level so the rest of the run proceeds normally
                self.token.clear()
                self.log("[watchdog] progress resumed; cancel level "
                         "lowered")
            self._soft_fired = False
            self._hard_fired = False
            return
        if age >= self.hard_s > 0 and not self._hard_fired:
            self._hard_fired = True
            self._breach("hard", age)
            self.token.cancel(
                f"watchdog hard breach: no lane heartbeat for "
                f"{age:.1f}s (hard_stall_s={self.hard_s:g})")
            self.log(f"[watchdog] HARD STALL: no lane heartbeat for "
                     f"{age:.1f}s — cancelling the stalled item and "
                     f"dumping thread stacks"
                     + (f" -> {self.stalls_path}" if self.stalls_path
                        else ""))
            if self.stalls_path:
                self._write_stalls()
        elif not self._soft_fired and self.soft_s > 0:
            self._soft_fired = True
            self._breach("soft", age)
            self.log(f"[watchdog] WARNING: possible stall — no lane "
                     f"heartbeat for {age:.1f}s "
                     f"(soft_stall_s={self.soft_s:g})")

    def _breach(self, level: str, age: float) -> None:
        rec = {"level": level, "age_s": round(age, 3),
               "t_unix": round(time.time(), 3),
               "lane_ages": self.lane_ages()}
        self.breaches.append(rec)
        tr = telemetry.current()
        if tr is not None:
            tr.instant("watchdog.stall", level=level,
                       age_s=rec["age_s"], lanes=rec["lane_ages"])

    def _thread_stacks(self) -> list[str]:
        # faulthandler writes through a raw fd (it is designed to work
        # mid-crash), so a StringIO won't do — stage through a real file
        import tempfile

        try:
            with tempfile.TemporaryFile(mode="w+",
                                        encoding="utf-8",
                                        errors="replace") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
                f.seek(0)
                return f.read().splitlines()
        except Exception:
            return ["<faulthandler dump failed>"]

    def _write_stalls(self) -> None:
        """Crash-safe (tmp+rename) stall ledger next to failures.json."""
        payload = {"schema": STALLS_SCHEMA, "run_id": self.run_id,
                   "soft_stall_s": self.soft_s,
                   "hard_stall_s": self.hard_s,
                   "breaches": self.breaches,
                   "thread_stacks": self._thread_stacks()}
        tmp = self.stalls_path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=2)
                f.write("\n")
            os.replace(tmp, self.stalls_path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# ambient run context (the faults._PLAN / telemetry._TRACER pattern)
# ---------------------------------------------------------------------------

@dataclass
class RunContext:
    """Deadline/cancel state for one run, installed process-wide so deep
    call sites (injected stalls, lane waits) need no plumbed-through
    arguments. ``run_deadline`` is the overall ``pipeline.run_budget_s``
    (None = unbounded) checked at stage boundaries and executor loops —
    the ABORT path; the token + watchdog are the per-item STALL-BREAK
    path (quarantine, continue)."""

    token: CancelToken = field(default_factory=CancelToken)
    watchdog: Watchdog | None = None
    run_deadline: Deadline | None = None

    def check_run_budget(self, what: str = "pipeline run") -> None:
        if self.run_deadline is not None:
            self.run_deadline.check(what)

    def abort(self, reason: str = "externally aborted") -> None:
        """Abort the run this context governs from outside (the serving
        drain's lever): the run deadline becomes one already expired and
        the token is cancelled, so the next stage boundary or cancellable
        wait leaves through the normal DeadlineExceeded path, failures.json
        included, instead of being killed mid-write."""
        d = Deadline(0.0, reason)
        d.t_end = float("-inf")
        self.run_deadline = d
        self.token.cancel(reason)


_CTX: RunContext | None = None


def current() -> RunContext | None:
    """The active run context, or None when the deadline layer is off.
    Hot paths fetch once and guard with ``is not None`` — the disabled
    path is exactly one module-global None check."""
    return _CTX


def activate(ctx: RunContext | None) -> RunContext | None:
    """Install ``ctx`` process-wide; returns the PREVIOUS context so a
    nested scope (bench arms, tests) can restore it on exit."""
    global _CTX
    prev = _CTX
    _CTX = ctx
    return prev


def deactivate(restore: RunContext | None = None) -> None:
    global _CTX
    _CTX = restore


def beat(lane: str) -> None:
    """Lane heartbeat from the hot accounting path (``OverlapStats.add``).
    One None check when no watchdog is armed."""
    ctx = _CTX
    if ctx is not None and ctx.watchdog is not None:
        ctx.watchdog.beat(lane)


def watchdog_suspend() -> None:
    """Pause the ambient watchdog across a barrier stage (see
    :meth:`Watchdog.suspend`); no-op when none is armed."""
    ctx = _CTX
    if ctx is not None and ctx.watchdog is not None:
        ctx.watchdog.suspend()


def watchdog_resume() -> None:
    """End the ambient watchdog's pause (see :meth:`Watchdog.resume`); no-op
    when none is armed."""
    ctx = _CTX
    if ctx is not None and ctx.watchdog is not None:
        ctx.watchdog.resume()
