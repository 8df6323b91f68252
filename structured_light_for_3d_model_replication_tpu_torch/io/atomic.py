"""Crash-safe artifact publishing: tmp + fsync + rename.

A writer stages its bytes into ``<path>.tmp`` and publishes with an atomic
``os.replace`` after an fsync, so an interrupt at any byte offset leaves
either the previous complete artifact or a ``.tmp`` orphan, never a
half-written final file.
"""
from __future__ import annotations

import contextlib
import os

__all__ = ["atomic_write", "commit", "discard"]


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
