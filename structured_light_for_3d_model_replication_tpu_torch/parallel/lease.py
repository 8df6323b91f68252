"""Lease bookkeeping for the multiprocess coordinator.

The coordinator never *pushes* work or *trusts* workers: an item is GRANTED
under a lease (worker + generation + expiry), the lease is RENEWED by the
worker's heartbeat, and an expired lease is STOLEN — the generation bumps,
so a late ``complete`` from the original holder is recognized and rejected
(the result may still be content-correct and cached; only the *ledger
credit* goes to the new holder). This table is the single source of truth
for who owns what; it is deliberately dumb — no I/O, no sockets, injectable
clock — so every expiry/steal/late-complete rule is unit-testable with a
fake clock.

Invariants:
  - at most one ACTIVE lease per item;
  - ``complete`` is accepted iff (item, worker, generation) all match the
    active lease — anything else is a stale echo;
  - a steal bumps the item's generation forever (generations never reset,
    even across re-grants), so no ABA confusion between steal cycles;
  - ``renew`` touches every lease a worker holds — the heartbeat is
    per-worker, not per-item, so a worker deep in one long item keeps its
    whole grant set alive (the OverlapStats.add hook beats on every stage
    transition, which is far more often than lease_s).

A copy of the JAX package's ``parallel/lease.py``: the same rules, so a
ledger either package's coordinator writes replays the same in the other.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

__all__ = ["Lease", "LeaseTable", "LocalityIndex"]


@dataclass
class Lease:
    """One active grant: ``item`` is leased to ``worker`` until
    ``expires_at`` (clock units of the table's injected clock), under
    ``gen`` — the item's steal generation at grant time."""

    item: str
    worker: str
    gen: int
    expires_at: float


class LeaseTable:
    """Thread-safe lease ledger with an injectable monotonic clock."""

    def __init__(self, lease_s: float, clock=time.monotonic):
        if lease_s <= 0:
            raise ValueError(f"lease_s must be > 0, got {lease_s!r}")
        self.lease_s = float(lease_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._active: dict[str, Lease] = {}      # item -> lease
        self._gen: dict[str, int] = {}           # item -> generation
        self._steals: dict[str, int] = {}        # item -> steal count

    # ---- grant / renew / complete ---------------------------------------

    def grant(self, item: str, worker: str) -> Lease:
        """Lease ``item`` to ``worker`` at the item's current generation.
        Granting an item with an active lease is a coordinator bug."""
        with self._lock:
            if item in self._active:
                raise RuntimeError(
                    f"item {item!r} already leased to "
                    f"{self._active[item].worker!r}")
            lease = Lease(item=item, worker=worker,
                          gen=self._gen.get(item, 0),
                          expires_at=self._clock() + self.lease_s)
            self._active[item] = lease
            return lease

    def renew(self, worker: str) -> int:
        """Heartbeat: push every lease ``worker`` holds out by a full
        ``lease_s`` from now. Returns how many leases were renewed (0 is
        the worker's signal that everything it held was stolen)."""
        with self._lock:
            now = self._clock()
            n = 0
            for lease in self._active.values():
                if lease.worker == worker:
                    lease.expires_at = now + self.lease_s
                    n += 1
            return n

    def complete(self, item: str, worker: str, gen: int) -> bool:
        """Settle ``item``: True iff the active lease matches (worker,
        gen) exactly — the lease is then released. False means the echo is
        stale (lease stolen, worker dropped, or double-complete); the
        caller must NOT credit it."""
        with self._lock:
            lease = self._active.get(item)
            if lease is None or lease.worker != worker or lease.gen != gen:
                return False
            del self._active[item]
            return True

    # ---- expiry / steal / drop ------------------------------------------

    def expired(self) -> list[Lease]:
        """Every active lease whose expiry has passed (snapshot; stealing
        is the caller's explicit second step so it can journal first)."""
        with self._lock:
            now = self._clock()
            return [lease for lease in self._active.values()
                    if lease.expires_at <= now]

    def steal(self, item: str) -> int:
        """Revoke ``item``'s active lease and bump its generation; returns
        the new generation (the one the next grant will carry). Idempotent
        on an already-stolen item — the generation still bumps, which is
        harmless (monotonic) and keeps the call safe under races between
        the expiry sweep and an observed-dead drop."""
        with self._lock:
            self._active.pop(item, None)
            g = self._gen.get(item, 0) + 1
            self._gen[item] = g
            self._steals[item] = self._steals.get(item, 0) + 1
            return g

    def drop_worker(self, worker: str) -> list[str]:
        """Revoke every lease ``worker`` holds (observed-dead fast path —
        no need to wait out lease_s when the coordinator reaped the
        worker's exit). Bumps each item's generation exactly like a steal.
        Returns the released items, oldest grant first."""
        with self._lock:
            items = [lease.item for lease in self._active.values()
                     if lease.worker == worker]
            for item in items:
                del self._active[item]
                g = self._gen.get(item, 0) + 1
                self._gen[item] = g
                self._steals[item] = self._steals.get(item, 0) + 1
            return items

    # ---- introspection ---------------------------------------------------

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def holder(self, item: str) -> str | None:
        with self._lock:
            lease = self._active.get(item)
            return lease.worker if lease is not None else None

    def steals(self, item: str) -> int:
        """How many times ``item``'s lease has been revoked — the
        coordinator's max_steals circuit breaker reads this."""
        with self._lock:
            return self._steals.get(item, 0)

    def gen(self, item: str) -> int:
        """``item``'s current steal generation (the one the next grant
        will carry) — journaled by the fleet supervisor's observed-dead
        steal so replay sees the same fence the live table enforces."""
        with self._lock:
            return self._gen.get(item, 0)

    def worker_items(self, worker: str) -> list[str]:
        """Items ``worker`` currently holds leases on. The fleet
        supervisor reads this before retiring a worker — a retire with
        zero held leases drains for free; anything held steals away on
        reap exactly like a death."""
        with self._lock:
            return [lease.item for lease in self._active.values()
                    if lease.worker == worker]


class LocalityIndex:
    """Which blob names each worker's L1 already holds, and the grant
    policy that reads it.

    Workers piggyback inventory diffs (names of payloads they just put)
    on their heartbeats/next requests; the coordinator folds them in with
    :meth:`update` and asks :meth:`choose` at grant time. The policy is
    deliberately mild: a *pair* item whose two cleaned-view payloads are
    BOTH in the requesting worker's inventory jumps the FIFO queue
    (locality hit — registration reads straight from L1, zero fabric
    fetches); anything else falls back to plain FIFO order (miss), so a
    cold worker — empty inventory — still gets the front of the queue and
    can never starve. Locality only reorders *which eligible item this
    worker takes first*; it never withholds work, and it is entirely
    orthogonal to the lease/generation machinery above (a stolen pair
    regrants through the same policy at its bumped generation).

    Like :class:`LeaseTable`: no I/O, thread-safe, unit-testable.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._inv: dict[str, set[str]] = {}      # worker -> blob names
        self.hits = 0
        self.misses = 0

    def update(self, worker: str, names) -> None:
        """Fold an inventory diff (iterable of blob names) into
        ``worker``'s holdings. Diffs are additive — content-addressed
        payloads are immutable, so stale entries are impossible; an
        evicted blob just costs one wasted preference."""
        if not names:
            return
        with self._lock:
            self._inv.setdefault(worker, set()).update(names)

    def holds(self, worker: str, name: str) -> bool:
        with self._lock:
            return name in self._inv.get(worker, ())

    def drop_worker(self, worker: str) -> None:
        with self._lock:
            self._inv.pop(worker, None)

    def choose(self, worker: str, candidates) -> tuple[int, bool]:
        """Pick which of ``candidates`` to grant ``worker``.

        ``candidates`` is an ordered list of ``(item_id, needed_names)``
        where ``needed_names`` is the tuple of blob names the item will
        read (``None`` for items with no fabric inputs — view items).
        Returns ``(index, locality_hit)``: the first candidate whose
        every needed name is in ``worker``'s inventory, else index 0
        (FIFO head). Only a candidate with needs counts toward the
        hit/miss counters — granting a view item is not a locality
        decision."""
        with self._lock:
            inv = self._inv.get(worker, set())
            scored = None
            for i, (_item, needs) in enumerate(candidates):
                if needs and all(n in inv for n in needs):
                    scored = i
                    break
            if scored is not None:
                self.hits += 1
                return scored, True
            if candidates and candidates[0][1]:
                self.misses += 1
            return 0, False

    def counters(self) -> dict[str, int]:
        with self._lock:
            return {"locality_hits": self.hits,
                    "locality_misses": self.misses}
