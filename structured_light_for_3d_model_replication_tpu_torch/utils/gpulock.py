"""One-card-client-at-a-time advisory lock for the port's tooling.

Two processes that each size their work for the whole card (a benchmark, a
``warmup``, a long ``serve``) slow each other down and can run the card out
of memory. This module gives such entry points one advisory ``flock`` on
``<root>/.gpu_lock``, the JAX package's ``utils/tpulock.py`` discipline
under a GPU name.

flock, not a pidfile: the kernel releases the lock the instant the
holder's fd closes — including SIGKILL of the whole process group — so
there is no stale-lock state to reap.

Holders spawning card-using children set ``SL3D_GPU_LOCK_HELD=<holder pid>``
in the child environment; children then skip acquisition instead of
deadlocking against their parent's lock. A pid-valued claim is *watched*:
the child starts a daemon thread that periodically tries the flock itself
(non-blocking), and the moment the claim goes free — the holder died while
the child still runs — the child re-takes it on its own fd so the tree
keeps excluding other card clients. The value ``1`` is accepted too but
arms no watcher.
"""
from __future__ import annotations

import fcntl
import os
import threading
import time

__all__ = ["acquire_gpu_lock", "probe_gpu_lock", "held_by_parent",
           "HOLD_ENV"]

HOLD_ENV = "SL3D_GPU_LOCK_HELD"


def probe_gpu_lock(root: str) -> tuple[bool, str]:
    """Report the lock's state without contending for it.

    Returns (held, detail). Uses a shared (LOCK_SH) non-blocking probe —
    it fails iff someone holds the exclusive claim, and two concurrent
    probes never conflict with each other; the instant of SH hold cannot
    be observed by another probe, only by an exactly-simultaneous
    exclusive acquire (vanishingly small window vs probing with LOCK_EX).
    """
    path = os.path.join(root, ".gpu_lock")
    if not os.path.exists(path):
        return False, "never taken here"
    with open(path, "a+") as f:
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_SH | fcntl.LOCK_NB)
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)
            return False, "free"
        except OSError:
            f.seek(0)
            return True, f.read().strip() or "unknown holder"


def held_by_parent() -> bool:
    """True when an ancestor process already holds the lock for us."""
    return os.environ.get(HOLD_ENV, "") not in ("", "0")


def _watch_holder(f, holder_pid: int, poll: float) -> None:
    """Daemon-thread body: if the claim-holding ancestor dies while we
    run, its flock is gone and a new card client could start concurrently
    with us — what the lock exists to prevent.

    The probe is the flock itself, not pid liveness: a non-blocking
    LOCK_EX attempt fails while ANY claim exists (the parent's, or a
    sibling orphan's that already re-claimed) and succeeds the moment the
    file goes free — immune to pid reuse and to zombies (a zombie has
    closed its fds, releasing the flock, yet still answers kill(pid,0)).
    ``holder_pid`` is only used to warn when the named holder is provably
    gone but the lock is held by someone else (a raced external claimant:
    concurrency already happened; make it visible for the post-mortem)."""
    import sys

    warned = False
    while True:
        time.sleep(poll)
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except ValueError:
            return  # our own lock file was closed: this client is done
        except OSError:
            # claim still held somewhere — normal while the parent lives
            if not warned and not _pid_alive(holder_pid):
                print(f"[gpulock] WARNING: claim holder pid {holder_pid} "
                      f"is gone but .gpu_lock is held elsewhere — a new "
                      f"client may be running concurrently with this "
                      f"orphaned one (pid {os.getpid()})", file=sys.stderr)
                warned = True
            continue
        try:  # claim re-established in THIS process; leave a breadcrumb
            f.seek(0)
            f.truncate()
            f.write(f"pid {os.getpid()} (orphan re-claim) since "
                    f"{time.strftime('%H:%M:%S')}\n")
            f.flush()
        except OSError:
            pass
        print(f"[gpulock] claim holder pid {holder_pid} gone — re-taken "
              f"by orphaned child pid {os.getpid()}", file=sys.stderr)
        return


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:
        return True  # EPERM etc: assume alive (conservative)


def acquire_gpu_lock(root: str, timeout: float = 0.0, poll: float = 5.0):
    """Try to take the root's card claim lock.

    Returns the open file object (hold it for the claim's lifetime; the
    lock dies with the fd) or ``None`` if another process still held it
    after ``timeout`` seconds. ``timeout=0`` means one non-blocking try.
    A caller whose parent set ``SL3D_GPU_LOCK_HELD=1`` gets a no-lock
    sentinel open file immediately (the parent's claim covers it).
    """
    path = os.path.join(root, ".gpu_lock")
    f = open(path, "a+")
    if held_by_parent():
        # parent's flock covers this process tree; when the value names
        # the holder's pid, watch it so an orphaned child re-claims
        val = os.environ.get(HOLD_ENV, "")
        if val.isdigit() and int(val) > 1:
            threading.Thread(target=_watch_holder,
                             args=(f, int(val), 10.0), daemon=True).start()
        return f
    deadline = time.monotonic() + timeout
    while True:
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            try:  # who-holds breadcrumb for humans; lock truth is the flock
                f.seek(0)
                f.truncate()
                f.write(f"pid {os.getpid()} since {time.strftime('%H:%M:%S')}\n")
                f.flush()
            except OSError:
                pass
            return f
        except OSError:
            if time.monotonic() >= deadline:
                f.close()
                return None
            time.sleep(min(poll, max(0.1, deadline - time.monotonic())))
