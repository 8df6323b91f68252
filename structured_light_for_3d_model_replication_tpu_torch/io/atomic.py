"""Crash-safe artifact publishing: tmp + fsync + rename, plus the startup
sweep for the tmp files a ``kill -9`` leaves behind.

A writer stages its bytes into ``<path>.tmp`` and publishes with an atomic
``os.replace`` after an fsync, so an interrupt at any byte offset leaves
either the previous complete artifact or a ``.tmp`` orphan, never a
half-written final file. The fixed ``.tmp`` suffix is what makes orphans
sweepable: ``run_pipeline`` and the stage cache call :func:`sweep_tmp` on
startup so a crashed run's debris never masquerades as data.
"""
from __future__ import annotations

import contextlib
import os

__all__ = ["atomic_write", "commit", "discard", "sweep_tmp"]

_TMP_SUFFIXES = (".tmp", ".tmp.npz")


def commit(tmp: str, path: str, sync: bool = True) -> None:
    """Publish a fully-written tmp file as ``path`` (fsync + atomic rename)."""
    if sync:
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    os.replace(tmp, path)


def discard(tmp: str) -> None:
    """Best-effort removal of an abandoned tmp file."""
    try:
        os.remove(tmp)
    except OSError:
        pass


@contextlib.contextmanager
def atomic_write(path: str, sync: bool = True):
    """Yield the staging path for ``path``; commit on clean exit, discard on
    any exception (then re-raise)."""
    tmp = path + ".tmp"
    try:
        yield tmp
    except BaseException:
        discard(tmp)
        raise
    commit(tmp, path, sync=sync)


def sweep_tmp(folder: str, log=None, recursive: bool = False) -> list[str]:
    """Remove stale ``*.tmp`` (and numpy's ``*.tmp.npz``) orphans under
    ``folder``; returns the removed paths. Safe on a missing folder."""
    removed: list[str] = []
    if not os.path.isdir(folder):
        return removed
    if recursive:
        walker = ((r, fs) for r, _, fs in os.walk(folder))
    else:
        walker = [(folder, os.listdir(folder))]
    for root, files in walker:
        for f in files:
            if f.endswith(_TMP_SUFFIXES):
                p = os.path.join(root, f)
                try:
                    os.remove(p)
                    removed.append(p)
                except OSError:
                    continue
    if removed and log is not None:
        log(f"[sweep] removed {len(removed)} stale .tmp file(s) under "
            f"{folder} (interrupted earlier run)")
    return removed
