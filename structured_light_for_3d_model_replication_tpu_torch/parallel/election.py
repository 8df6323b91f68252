"""Leader election for the multi-gateway serving group.

N ``serve`` gateways share one root; exactly one may own the engine
(admission, lanes, assembler) at a time. The primitive is the shape of
:class:`~.lease.LeaseTable` — time-bounded ownership with a monotonic
counter that fences stale holders — lifted to the filesystem so it spans
processes:

  lease file   ``<root>/leader.json`` (schema ``sl3d-leader-v1``): the
               current leader's identity, address and wall-clock expiry,
               written atomically (tmp + fsync + rename, ``io.atomic``), so
               a reader sees the previous lease or the new one, never a
               torn line.
  epoch        a monotonic integer that bumps on every TAKEOVER (never on
               self-renewal): the fencing token. The leader stamps every
               ledger append and request record with it, and
               :meth:`LeaderLease.fence` refuses a write once a newer epoch
               is on disk, so a deposed leader waking from a stall cannot
               interleave credit into the new leader's segment. Replay
               (:func:`..admission.replay_serving`) applies the same rule
               offline: a record with an epoch older than the newest seen
               is ignored.
  lock file    ``leader.json.lock``: an flock held only across the
               read-check-write of acquire/renew, so two standbys racing an
               expired lease cannot both bump to the same epoch. flock is
               per open-file-description, so two handles in ONE process
               (an in-process pair of gateways) exclude each other too.

Expiry uses WALL time (``time.time``): monotonic clocks are not comparable
across processes. The clock is injectable for tests. This targets gateways
on one host or a shared POSIX filesystem with coherent flock; the fence and
the replay rule hold even where lease timing is sloppy.

The port's copy of the JAX package's ``parallel/election.py``: the same
file, schema and epochs, so one root's lease is readable by both packages.

Chaos sites: ``election.acquire`` / ``election.renew`` fire BEFORE the
flock is taken (a stalled renew must not wedge the standby's takeover: the
stall is how a test makes a zombie leader).
"""
from __future__ import annotations

import fcntl
import json
import os
import time

from structured_light_for_3d_model_replication_tpu_torch.io.atomic import (
    atomic_write,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import faults

__all__ = ["LeaderLease", "FencedWrite", "LEADER_SCHEMA"]

LEADER_SCHEMA = "sl3d-leader-v1"


class FencedWrite(RuntimeError):
    """A write stamped with epoch E was refused because the lease file
    already shows epoch > E: the writer was deposed while it wasn't
    looking. The only correct reaction is to self-demote — the scan now
    belongs to the new leader, whose replay restores it from the ledger
    prefix this writer DID get journaled."""


class LeaderLease:
    """One gateway's handle on the shared leader lease.

    ``epoch > 0`` iff this handle currently believes it is the leader;
    :meth:`renew` and :meth:`fence` are where that belief gets corrected
    against disk. All methods are safe to call from any thread; the
    flock'd read-modify-write serializes across processes."""

    def __init__(self, path: str, owner: str, lease_s: float = 5.0,
                 clock=time.time, info: dict | None = None):
        self.path = path
        self.owner = str(owner)
        self.lease_s = float(lease_s)
        self.info = dict(info or {})     # advertised address etc.
        self.epoch = 0                   # our held epoch (0 = not leader)
        self._clock = clock
        self._lock_path = path + ".lock"
        # fence() stat-cache: re-read the lease file only when it changed
        # (one os.stat per append on the hot path, not a read+parse)
        self._seen_stat: tuple | None = None
        self._seen: dict | None = None

    # ---- file plumbing ---------------------------------------------------

    def _read(self) -> dict | None:
        """Parse the lease file; None when absent or torn (a torn lease is
        treated as free — atomic_write makes torn effectively impossible,
        but a hand-damaged file must not wedge the group forever)."""
        try:
            with open(self.path, encoding="utf-8") as f:
                cur = json.load(f)
        except (OSError, ValueError):
            return None
        if cur.get("schema") != LEADER_SCHEMA:
            return None
        return cur

    def _write(self, rec: dict) -> None:
        with atomic_write(self.path) as tmp:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(rec, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
        self._seen_stat = None           # our own write invalidates the cache

    class _Flock:
        def __init__(self, lock_path: str):
            self._path = lock_path
            self._f = None

        def __enter__(self):
            self._f = open(self._path, "a")
            fcntl.flock(self._f.fileno(), fcntl.LOCK_EX)
            return self

        def __exit__(self, *exc):
            try:
                fcntl.flock(self._f.fileno(), fcntl.LOCK_UN)
            finally:
                self._f.close()
            return False

    def _locked(self) -> "LeaderLease._Flock":
        return LeaderLease._Flock(self._lock_path)

    def _rec(self, epoch: int, now: float) -> dict:
        rec = {"schema": LEADER_SCHEMA, "epoch": int(epoch),
               "owner": self.owner, "pid": os.getpid(),
               "lease_s": self.lease_s,
               "renewed_unix": round(now, 6),
               "expires_unix": round(now + self.lease_s, 6)}
        rec.update(self.info)
        return rec

    # ---- protocol --------------------------------------------------------

    def acquire(self) -> bool:
        """Try to become (or stay) leader. Succeeds when the lease is
        free, expired, or already ours; a takeover from another owner
        bumps the epoch, re-acquiring our own lease keeps it. On success
        ``self.epoch`` holds the fencing token."""
        faults.fire("election.acquire", item=self.owner)
        with self._locked():
            cur = self._read()
            now = self._clock()
            if (cur is not None and cur.get("owner") != self.owner
                    and float(cur.get("expires_unix", 0.0)) > now):
                return False             # live lease held by someone else
            epoch = int(cur.get("epoch", 0)) if cur is not None else 0
            if cur is None or cur.get("owner") != self.owner:
                epoch += 1               # takeover: bump the fencing token
            self._write(self._rec(epoch, now))
            self.epoch = epoch
            return True

    def renew(self) -> bool:
        """Extend our lease. False — and ``epoch`` drops to 0 — when the
        file no longer shows our (owner, epoch): someone stole an expired
        lease while we stalled. The caller must demote; its in-flight
        appends will be fenced regardless (belt and suspenders)."""
        faults.fire("election.renew", item=self.owner)
        with self._locked():
            cur = self._read()
            if (cur is None or cur.get("owner") != self.owner
                    or int(cur.get("epoch", 0)) != self.epoch
                    or self.epoch <= 0):
                self.epoch = 0
                return False
            self._write(self._rec(self.epoch, self._clock()))
            return True

    def release(self) -> None:
        """Voluntary step-down (graceful stop): expire the lease NOW so a
        standby takes over on its next poll instead of waiting out the
        lease. Only touches the file while it is still ours."""
        with self._locked():
            cur = self._read()
            if (cur is not None and cur.get("owner") == self.owner
                    and int(cur.get("epoch", 0)) == self.epoch
                    and self.epoch > 0):
                cur["expires_unix"] = round(self._clock(), 6)
                self._write(cur)
        self.epoch = 0

    def current(self) -> dict | None:
        """The lease file as last written (atomic rename: no lock needed
        to read). None when no leader has ever been elected."""
        return self._read()

    def fence(self) -> None:
        """The write barrier: raise :class:`FencedWrite` when the lease
        file shows an epoch newer than ours. Called before every ledger
        append by the serving layer; one ``os.stat`` per call, the parse
        only re-runs when the file actually changed."""
        try:
            st = os.stat(self.path)
        except OSError:
            return                       # no lease file -> nothing newer
        key = (st.st_mtime_ns, st.st_size, st.st_ino)
        if key != self._seen_stat:
            self._seen = self._read()
            self._seen_stat = key
        cur = self._seen
        if cur is not None and int(cur.get("epoch", 0)) > self.epoch:
            raise FencedWrite(
                f"epoch {self.epoch} fenced by epoch "
                f"{int(cur.get('epoch', 0))} "
                f"(leader {cur.get('owner')!r})")

    def superseded(self) -> bool:
        """Non-raising :meth:`fence`: True when a newer epoch exists on
        disk. The fleet supervisor polls this at the top of every tick so
        a deposed leader's autoscaler stops DECIDING (spawn/retire are
        side effects no fence on the ledger append can un-run) the moment
        the takeover lands, not just when its next journal write fails."""
        try:
            self.fence()
        except FencedWrite:
            return True
        return False
