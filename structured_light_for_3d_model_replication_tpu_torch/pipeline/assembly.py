"""Incremental assembly: the coordinator-side fold lane.

A coordinated pod (``parallel/coordinator.py``) turns every worker into a
cache-warmer; the assembly pass afterwards is one single-process
``run_pipeline`` over the warmed stage cache. Without this module that
pass does all of the accumulate work after the last item settled. This
module folds completed work into running merged-cloud state WHILE the pod
is still running: cleaned views fold in index order the moment their blobs
land in the L2 blobstore, and each finalized pair transform folds into the
running ``T_accum`` chain the moment its chain prefix is resolved — the
streamed registrar's readiness rule (pair i is safe to chain only when
views ``0..i`` are all accounted for, so its chain position is final),
lifted to the coordinator. When the last item settles, only the
postprocess tail (voxel/outlier + Poisson + mesh) remains.

Parity argument (incremental ≡ barrier ≡ single-process): the fold moves
a view with the port's own accumulate arithmetic,
``models.reconstruction._apply_transforms`` (``((r0 x + r1 y) + r2 z) +
t`` per row) on CPU tensors, which is bit-equal to ``finalize_chain``'s
batch on the CPU and on the card (no fused multiply-add in those ops; the
JAX package folds with its numpy twin ``p @ R.T + t``, whose rounding the
port's merge never matches), and the SAME chain matmul order, over
payloads addressed by the SAME content-addressed keys the assembly pass
would read. The assembly pass then ``validate``s the folded
prefix against its own view order, output digests, and pair transforms —
any view the single-process rules would quarantine, any identity-fallback
pair (never cached, so never folded), any divergence at all truncates the
prefix — and ``finalize_chain`` seeds from the surviving prefix only.
Bytes cannot differ from the barrier arm because every folded quantity is
re-derivable (and re-derived on mismatch) from the assembly pass's own
state. ``merge.incremental`` is therefore a pure SCHEDULE knob, never
cache-key material.

Failure containment: the fold lane is an optimization and must never turn
a good run into a failed one — every fold error short of an injected
crash is logged and the affected suffix falls back to the assembly pass
(which recomputes it exactly as if the lane never ran). An
``InjectedCrash`` poisons the lane: the prefold is discarded wholesale.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

import torch

from structured_light_for_3d_model_replication_tpu_torch.utils import faults

__all__ = ["Prefold", "IncrementalAssembler"]


@dataclass
class Prefold:
    """The folded prefix handed from the pod phase to the assembly pass.

    ``transforms[k]`` maps view k into the frame of view 0 (``[0]`` is
    identity), ``merged_p``/``merged_c`` are the transformed per-view
    clouds, ``digests[k]`` is view k's cleaned-cloud OUTPUT digest (the
    validation anchor), ``T_pairs[k]`` the raw pair transform that folded
    view ``k+1``. ``events`` are ``(kind, idx, dur_s)`` fold records the
    assembly pass replays into the telemetry journal (no tracer is active
    during the pod phase — coordinated dispatch happens before
    ``run_pipeline`` opens one). ``settled_unix`` is wall time at
    last-item-settled: the anchor the assembly-tail gauge measures from.
    """

    digests: list = field(default_factory=list)
    transforms: list = field(default_factory=list)
    merged_p: list = field(default_factory=list)
    merged_c: list = field(default_factory=list)
    T_pairs: list = field(default_factory=list)
    events: list = field(default_factory=list)
    settled_unix: float | None = None
    offered_views: int = 0   # folded count before validation (for report)

    def validate(self, order, digests_by_view, T_pairs, log=print):
        """Trim to the prefix consistent with the assembly pass's ACTUAL
        view order, output digests, and pair transforms; None when fewer
        than 2 views survive (a 0/1-view prefix saves nothing).

        The prefix rule mirrors the fold rule: view k is trusted only if
        the pass kept view k at chain position k (``order[k] == k`` — a
        quarantined view shifts every later position, truncating here),
        its digest matches what was folded, and the pass's pair transform
        equals the folded one bit-for-bit (an identity-fallback pair was
        never cached, so the fold stalled before it by construction)."""
        k = 0
        lim = min(len(self.transforms), len(order))
        while k < lim:
            if order[k] != k or digests_by_view.get(k) != self.digests[k]:
                break
            if k > 0 and not np.array_equal(
                    np.asarray(T_pairs[k - 1], np.float32),
                    self.T_pairs[k - 1]):
                break
            k += 1
        if k < 2:
            if self.transforms:
                log(f"[assembly] prefold discarded (validated prefix {k} "
                    f"of {len(self.transforms)} folded view(s))")
            return None
        if k == len(self.transforms):
            return self
        log(f"[assembly] prefold trimmed to {k} of "
            f"{len(self.transforms)} folded view(s)")
        return Prefold(
            digests=self.digests[:k], transforms=self.transforms[:k],
            merged_p=self.merged_p[:k], merged_c=self.merged_c[:k],
            T_pairs=self.T_pairs[:k - 1],
            events=[e for e in self.events
                    if (e[0] == "view" and e[1] < k)
                    or (e[0] == "pair" and e[1] <= k - 2)],
            settled_unix=self.settled_unix,
            offered_views=self.offered_views)


class IncrementalAssembler:
    """Coordinator-side fold lane: one worker thread (the registrar's
    1-thread-pool idiom — all fold state is single-threaded) that consumes
    item-settled and blob-landed notifications and folds views in chain
    order as their payloads become readable from the local stage cache.

    A completed item whose payload is NOT readable (a degraded fabric push
    — ``BlobClient.push`` is best-effort) simply stalls the fold at that
    view; later notifications retry, and whatever never folds is
    recomputed by the assembly pass. Nothing here is load-bearing for
    correctness.
    """

    def __init__(self, cfg, view_keys, cache, device, log=print):
        from concurrent.futures import ThreadPoolExecutor

        from structured_light_for_3d_model_replication_tpu_torch.pipeline import (
            stages,
        )
        from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (  # noqa: E501
            StageCache,
        )

        self.cfg = cfg
        self.cache = cache
        self.log = log
        # the run's device: pair keys carry its engine tag (the fold
        # itself runs on the CPU)
        self.device = torch.device(device)
        self.view_keys = list(view_keys)
        self.n = len(self.view_keys)
        self._digest = StageCache.digest_arrays
        self._pair_key = stages._pair_key
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="sl3d-assembly")
        self._futs: list = []
        self._closed = False
        self._crashed = False
        # fold state below is mutated only on the fold worker
        self._view_done: set[int] = set()
        self._pair_done: set[int] = set()
        self._clouds: dict[int, tuple] = {}
        self._digests: dict[int, str] = {}
        self._transforms: list = []
        self._merged_p: list = []
        self._merged_c: list = []
        self._T_pairs: list = []
        self._events: list = []
        self._folded = 0   # views folded == len(self._transforms)

    # ---- public API (any thread) ----------------------------------------

    def note_item(self, iid: str) -> None:
        """An item settled successfully (``view:i`` / ``pair:i``) — from
        ``op_complete``, the resume ledger, or the pre-done cache scan."""
        self._submit(self._note, iid)

    def note_blob(self, name: str) -> None:
        """A blob landed in the L2 store (``BlobServer`` ``on_blob``) —
        the earliest wake-up: for fabric-pushed payloads it fires before
        the worker even reports the item complete, and it un-stalls folds
        that previously read a miss."""
        self._submit(self._fold)

    def _submit(self, fn, *args) -> None:
        if self._closed:
            return
        try:
            self._futs.append(self._pool.submit(fn, *args))
        except RuntimeError:
            pass   # raced a shutdown: the assembly pass covers the rest

    def close(self) -> None:
        """Drain the fold worker. Idempotent. Fold errors were already
        contained per-future; an injected crash poisons the lane (the
        prefold is discarded) rather than failing the run here — the
        assembly pass recomputes everything the lane never delivered."""
        if self._closed:
            return
        self._closed = True
        self._pool.shutdown(wait=True)
        for f in self._futs:
            e = f.exception()
            if isinstance(e, faults.InjectedCrash):
                self._crashed = True
                self.log("[assembly] fold lane hit an injected crash — "
                         "prefold discarded; the assembly pass recomputes")
            elif e is not None:
                self.log(f"[assembly] WARNING: fold error "
                         f"({type(e).__name__}: {e}); the affected suffix "
                         f"falls back to the assembly pass")

    def prefold(self, settled_unix: float) -> Prefold:
        """Snapshot the folded prefix (call after ``close``)."""
        pf = Prefold(settled_unix=float(settled_unix))
        if self._crashed:
            return pf
        pf.digests = list(self._digests.get(i)
                          for i in range(self._folded))
        pf.transforms = list(self._transforms)
        pf.merged_p = list(self._merged_p)
        pf.merged_c = list(self._merged_c)
        pf.T_pairs = list(self._T_pairs)
        pf.events = list(self._events)
        pf.offered_views = self._folded
        return pf

    # ---- fold-worker internals -------------------------------------------

    def _note(self, iid: str) -> None:
        kind, _, num = iid.partition(":")
        try:
            idx = int(num)
        except ValueError:
            return
        if kind == "view":
            self._view_done.add(idx)
        elif kind == "pair":
            self._pair_done.add(idx)
        else:
            return
        self._fold()

    def _fold(self) -> None:
        # fold readiness rule: view k folds when views 0..k have settled
        # and loaded AND pair k-1's transform is readable — the chain
        # prefix is then resolved, so k's accumulated transform is final
        while self._folded < self.n:
            k = self._folded
            if k not in self._view_done:
                return
            if k >= 1 and (k - 1) not in self._pair_done:
                return
            t0 = time.perf_counter()
            if not self._load_view(k):
                return
            pts, cols = self._clouds[k]
            if k == 0:
                self._transforms.append(np.eye(4, dtype=np.float32))
                self._merged_p.append(pts)
                self._merged_c.append(cols)
                self._events.append(
                    ("view", 0, round(time.perf_counter() - t0, 6)))
                self._folded = 1
                continue
            t1 = time.perf_counter()
            T = self._pair_T(k - 1)
            if T is None:
                return
            t_accum = (self._transforms[-1] @ T).astype(np.float32)
            self._transforms.append(t_accum)
            self._T_pairs.append(T)
            self._merged_p.append(_move(pts, t_accum))
            self._merged_c.append(cols)
            self._events.append(("view", k, round(t1 - t0, 6)))
            self._events.append(
                ("pair", k - 1, round(time.perf_counter() - t1, 6)))
            self._folded += 1
            self._clouds.pop(k, None)   # moved cloud kept, raw no longer

    def _load_view(self, i: int) -> bool:
        if i in self._clouds:
            return True
        hit = self.cache.get("view", self.view_keys[i])
        if hit is None:
            return False
        pts = np.asarray(hit["points"], np.float32)
        cols = np.asarray(hit["colors"], np.uint8)
        self._clouds[i] = (pts, cols)
        self._digests[i] = self._digest(points=pts, colors=cols)
        return True

    def _pair_T(self, pid: int):
        key = self._pair_key(self.cache, self.cfg, self.device, self._digests[pid],
                             self._digests[pid + 1], pid)
        hit = self.cache.get("pair", key)
        if hit is None:
            return None
        return np.asarray(hit["T"], np.float32)


def _move(points: np.ndarray, T: np.ndarray) -> np.ndarray:
    """One view moved by its accumulated transform with
    ``finalize_chain``'s arithmetic, on the CPU."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )

    P = torch.from_numpy(np.ascontiguousarray(points, np.float32))[None]
    return recon._apply_transforms(P, torch.from_numpy(np.asarray(T, np.float32))[None])[0] \
        .numpy()
