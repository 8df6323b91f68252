"""Content-addressed stage cache for the fused scan-to-print pipeline.

Every pipeline stage is a pure function of (input bytes, config subtree), so
its output can be keyed by a digest of exactly those inputs and reused across
runs: an interrupted or re-invoked ``pipeline`` resumes from the first
stage whose inputs actually changed, paying zero decode/clean/merge/mesh
compute for everything upstream of the edit.

Key scheme (sha256, hex):

  view stage   H(schema | stage | calib bytes | frame-file names+bytes |
                 json(decode+triangulate+projector+clean config, steps,
                 engine))
  pair stage   H(schema | stage | the two views' cleaned-cloud OUTPUT
                 digests | json(merge cfg numerics, chain pair id)) — one
                 entry per registered pair, so a rerun with ONE dirty view
                 re-registers only its <=2 adjacent pairs. Schedule knobs
                 (merge.stream, merge.pair_batch) never enter the key:
                 streamed and barrier runs produce identical bytes and
                 share entries.
  merge stage  H(schema | stage | per-view OUTPUT digests | json(merge cfg))
  mesh stage   H(schema | stage | merged OUTPUT digest | json(mesh cfg))

The port's key material carries ``"engine": "torch"`` and the device type
(``"device": "cuda"`` or ``"cpu"``) where the JAX package puts its
``parallel.backend``: the two packages' float outputs differ in their last
bits, and so do the port's kernels and their plain CPU versions, so one
``.slscan-cache`` written by both packages, or on both devices, never hands
one's arrays to the other. Schema, file names and payload layout are the
JAX package's.

Chaining through *output* digests (not input keys) means a view recomputed
to identical bytes still hits the merge cache, and any upstream change —
frames, calibration, or the relevant config subtree — dirties every stage
downstream of it and nothing else. Payloads are ``.npz`` files under
``<out>/.slscan-cache/<stage>-<key16>.npz``; a corrupt or half-written entry
reads as a miss (the write is tmp+rename, so interrupts cannot corrupt a
published entry).

Resilience contract:

  - every payload carries a ``__digest__`` of its own arrays; reads verify
    it (``verify=True``) and a mismatch — bit rot, a torn-write survivor —
    EVICTS the entry and reads as a miss, so a corrupt entry can never
    poison downstream stages
  - ``put`` is best-effort: a failed write (disk full, injected
    ``cache.put`` fault) cleans up its tmp file, logs, and returns — the
    cache is an optimization, never allowed to kill a computed result
  - init sweeps orphaned ``*.tmp`` files (a ``kill -9`` mid-``put`` leaves
    one behind; they are never valid entries)
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from structured_light_for_3d_model_replication_tpu_torch.io.atomic import sweep_tmp
from structured_light_for_3d_model_replication_tpu_torch.utils import (
    deadline as dl,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import faults
from structured_light_for_3d_model_replication_tpu_torch.utils import telemetry

__all__ = ["StageCache", "TenantCache", "config_subtree"]

# bump when a stage's numeric contract changes (payload layout, op
# semantics): stale entries then read as misses instead of wrong hits
# (v2: payloads carry a __digest__ for read-time verification)
_SCHEMA = "slscan-cache-v2"


def config_subtree(cfg, sections: tuple[str, ...]) -> str:
    """Canonical JSON of the config sections a stage's numbers depend on —
    the 'relevant config subtree' part of every cache key."""
    import dataclasses

    return json.dumps(
        {s: dataclasses.asdict(getattr(cfg, s)) for s in sections},
        sort_keys=True)


class StageCache:
    """Filesystem-backed content-addressed cache with hit/miss accounting.

    ``enabled=False`` turns every lookup into a miss and every put into a
    no-op — one code path for cached and uncached runs.
    """

    def __init__(self, root: str, enabled: bool = True, log=None,
                 verify: bool = True):
        self.root = root
        self.enabled = enabled
        self.verify = verify
        self._log = log or (lambda m: None)
        self.hits: list[str] = []
        self.misses: list[str] = []
        self.evicted: list[str] = []
        self.put_errors: list[str] = []
        if enabled:
            os.makedirs(root, exist_ok=True)
            # a kill -9 mid-put leaves a .tmp orphan; never a valid entry
            sweep_tmp(root, log=self._log)

    # -- keys ------------------------------------------------------------

    def key(self, stage: str, *, files: list[str] | None = None,
            digests: list[str] | None = None,
            arrays: dict[str, np.ndarray] | None = None,
            config_json: str = "") -> str:
        h = hashlib.sha256()
        h.update(_SCHEMA.encode())
        h.update(stage.encode())
        for path in files or []:
            h.update(os.path.basename(path).encode())
            with open(path, "rb") as f:
                h.update(f.read())
        for d in digests or []:
            h.update(d.encode())
        for name in sorted(arrays or {}):
            a = np.ascontiguousarray(arrays[name])
            h.update(name.encode())
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        h.update(config_json.encode())
        return h.hexdigest()

    def keys_parallel(self, stage: str, file_lists: list[list[str]],
                      config_json: str = "", io_workers: int = 1,
                      timeout_s: float | None = None) -> list[str]:
        """Per-item ``key(stage, files=...)`` for a whole batch, hashed on a
        thread pool (``key`` is pure, so order-preserving submission is
        safe). Keying a 24-view 1080p run reads ~2 GB of frame bytes; doing
        it serially stalls the batched executor's first launch behind the
        hash wall. ``timeout_s`` bounds the WHOLE keying pass (one shared
        monotonic deadline): a hung filesystem read raises
        :class:`~.utils.deadline.DeadlineExceeded` instead of wedging the
        run before its first stage. NOTE: executor/batching knobs
        (``parallel.compute_batch``, ``shard_views``, ``io_workers``) must
        NEVER enter ``config_json`` — every execution schedule produces
        identical bytes, so cached views must hit across schedule
        changes."""
        if io_workers > 1 and len(file_lists) > 1:
            from concurrent.futures import ThreadPoolExecutor

            deadline = dl.Deadline.after(timeout_s, "stage-cache keying")
            with ThreadPoolExecutor(
                    max_workers=min(io_workers, len(file_lists)),
                    thread_name_prefix="sl3d-cachekey") as pool:
                futs = [pool.submit(self.key, stage, files=fl,
                                    config_json=config_json)
                        for fl in file_lists]
                try:
                    out = []
                    for i, f in enumerate(futs):
                        rem = (deadline.remaining()
                               if deadline is not None else None)
                        if rem is not None and rem <= 0:
                            # spent budget means expired, never unbounded
                            raise dl.DeadlineExceeded(
                                f"{stage} cache keying exceeded its "
                                f"{timeout_s:g}s budget at key {i}")
                        out.append(dl.wait_future(
                            f, rem, what=f"{stage} cache key {i}"))
                    return out
                except dl.DeadlineExceeded:
                    # don't leave the pool's __exit__ blocked on the same
                    # wedge the deadline just reported
                    pool.shutdown(wait=False, cancel_futures=True)
                    raise
        deadline = dl.Deadline.after(timeout_s, "stage-cache keying")
        out = []
        for fl in file_lists:
            if deadline is not None:
                deadline.check(f"{stage} cache keying")
            out.append(self.key(stage, files=fl, config_json=config_json))
        return out

    @staticmethod
    def digest_arrays(**arrays) -> str:
        """Content digest of a stage OUTPUT — what downstream keys chain on."""
        h = hashlib.sha256()
        for name in sorted(arrays):
            a = np.ascontiguousarray(arrays[name])
            h.update(name.encode())
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    # -- payloads --------------------------------------------------------

    def _path(self, stage: str, key: str) -> str:
        return os.path.join(self.root, f"{stage}-{key[:16]}.npz")

    def _miss(self, stage: str) -> None:
        self.misses.append(stage)
        tr = telemetry.current()
        if tr is not None:
            tr.instant("cache.miss", stage=stage)

    def _hit(self, stage: str) -> None:
        self.hits.append(stage)
        tr = telemetry.current()
        if tr is not None:
            tr.instant("cache.hit", stage=stage)

    def _evict(self, path: str, stage: str, why: str) -> None:
        """Remove a bad entry so it cannot poison a later read."""
        try:
            os.remove(path)
        except OSError:
            pass
        self.evicted.append(stage)
        tr = telemetry.current()
        if tr is not None:
            tr.instant("cache.evict", stage=stage, why=why)
        self._log(f"[cache] {stage}: evicted {os.path.basename(path)} "
                  f"({why}); recomputing")

    def get(self, stage: str, key: str) -> dict | None:
        """Load a stage payload; None on any miss (absent, disabled,
        unreadable, or digest-mismatched — the last two also evict the
        entry). Hits are logged — the resume trail the operator reads."""
        if not self.enabled:
            self._miss(stage)
            return None
        path = self._path(stage, key)
        try:
            faults.fire("cache.get", item=f"{stage}:{key[:16]}")
        except faults.InjectedCrash:
            raise
        except Exception:
            # an injected lookup failure behaves like the corrupt-entry
            # path: evict whatever is there and read as a miss
            self._evict(path, stage, "injected lookup fault")
            self._miss(stage)
            return None
        if not os.path.exists(path):
            self._miss(stage)
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                if "__key__" not in z.files or str(z["__key__"]) != key:
                    self._miss(stage)  # 16-hex-prefix collision
                    return None
                out = {k: z[k] for k in z.files
                       if k not in ("__key__", "__digest__")}
                recorded = (str(z["__digest__"])
                            if "__digest__" in z.files else None)
        except faults.InjectedCrash:
            raise
        except Exception as e:  # half-written/corrupt entry == miss
            self._evict(path, stage, f"unreadable: {e}")
            self._miss(stage)
            return None
        if self.verify:
            # recorded=None is a pre-digest entry (older schema bump
            # should catch this, but stay safe): treat as unverifiable
            if recorded is None or self.digest_arrays(**out) != recorded:
                self._evict(path, stage, "payload digest mismatch "
                            "(bit rot or torn write)")
                self._miss(stage)
                return None
        self._hit(stage)
        self._log(f"[cache] {stage}: hit ({os.path.basename(path)})")
        return out

    def put(self, stage: str, key: str, **arrays) -> None:
        """Publish a stage payload (tmp + atomic rename). Best-effort: any
        write failure cleans up the tmp file and logs instead of raising —
        losing a cache entry must never lose the computed result."""
        if not self.enabled:
            return
        path = self._path(stage, key)
        tmp = path + ".tmp"
        try:
            faults.fire("cache.put", item=f"{stage}:{key[:16]}")
            np.savez(tmp, __key__=np.asarray(key),
                     __digest__=np.asarray(self.digest_arrays(**arrays)),
                     **arrays)
            # np.savez appends .npz to names without it
            if not os.path.exists(tmp) and os.path.exists(tmp + ".npz"):
                tmp = tmp + ".npz"
            os.replace(tmp, path)
        except faults.InjectedCrash:
            raise
        except Exception as e:
            self.put_errors.append(stage)
            tr = telemetry.current()
            if tr is not None:
                tr.instant("cache.put_error", stage=stage,
                           error=type(e).__name__)
            self._log(f"[cache] {stage}: put failed ({e}); continuing "
                      f"uncached")
        finally:
            for leftover in (tmp, tmp + ".npz"):
                if leftover != path and os.path.exists(leftover):
                    try:
                        os.remove(leftover)
                    except OSError:
                        pass

    def stats(self) -> dict:
        return {"hits": len(self.hits), "misses": len(self.misses),
                "hit_stages": list(self.hits),
                "miss_stages": list(self.misses),
                "evicted": len(self.evicted),
                "put_errors": len(self.put_errors)}


def _safe_tenant(tenant: str) -> str:
    """Filesystem-safe tenant id: restricted charset, bounded length, no
    dot-prefix (so a tenant can never escape or shadow the namespace
    root). An empty result is a caller bug, not a default identity."""
    import re

    t = re.sub(r"[^A-Za-z0-9._-]", "_", str(tenant))[:64].lstrip(".")
    if not t:
        raise ValueError(f"unusable tenant id {tenant!r}")
    return t


class TenantCache(StageCache):
    """Per-tenant namespace view over a SHARED content-addressed store (the
    JAX package's class: the same marker layout, so either package's
    service reads the other's namespaces).

    Payload bytes live once in the shared store directory — identical
    frame bytes submitted by two tenants hash to the same content key and
    share ONE ``.npz`` entry (cross-tenant dedup is free because the key
    scheme never includes identity, only content). What is per-tenant is
    the *namespace*: a directory of zero-byte ``<stage>-<key16>.ref``
    markers recording which store entries this tenant has read or
    written. ``evict_tenant`` drops a tenant's refs and deletes only the
    payloads no other tenant still references — so evicting tenant A can
    never cold tenant B's entries, and a tenant's cache footprint is
    exactly its ref set. Tenants never share *outputs* (every request
    owns its out_dir); they share only content-keyed intermediates.
    """

    def __init__(self, store_root: str, tenant: str,
                 ns_root: str | None = None, enabled: bool = True,
                 log=None, verify: bool = True):
        super().__init__(store_root, enabled=enabled, log=log,
                         verify=verify)
        self.tenant = _safe_tenant(tenant)
        self.ns_root = ns_root or (store_root.rstrip(os.sep) + "-ns")
        self.ns_dir = os.path.join(self.ns_root, self.tenant)
        if enabled:
            os.makedirs(self.ns_dir, exist_ok=True)

    def _ref_path(self, stage: str, key: str) -> str:
        return os.path.join(self.ns_dir, f"{stage}-{key[:16]}.ref")

    def _touch_ref(self, stage: str, key: str) -> None:
        if not self.enabled:
            return
        try:
            with open(self._ref_path(stage, key), "a", encoding="utf-8"):
                pass
        except OSError:
            pass    # a lost ref marker only risks early eviction, never data

    def get(self, stage: str, key: str) -> dict | None:
        hit = super().get(stage, key)
        if hit is not None:
            # reads ref too: a dedup hit on another tenant's entry must
            # keep the payload alive past THAT tenant's eviction
            self._touch_ref(stage, key)
        return hit

    def put(self, stage: str, key: str, **arrays) -> None:
        super().put(stage, key, **arrays)
        self._touch_ref(stage, key)

    def refs(self) -> list[str]:
        """This tenant's referenced entry names (``<stage>-<key16>``)."""
        try:
            return sorted(f[:-4] for f in os.listdir(self.ns_dir)
                          if f.endswith(".ref"))
        except OSError:
            return []

    @staticmethod
    def tenants(ns_root: str) -> list[str]:
        try:
            return sorted(d for d in os.listdir(ns_root)
                          if os.path.isdir(os.path.join(ns_root, d)))
        except OSError:
            return []

    @classmethod
    def evict_tenant(cls, store_root: str, tenant: str,
                     ns_root: str | None = None, log=None) -> dict:
        """Drop ``tenant``'s namespace and garbage-collect store payloads
        nobody else references. Returns {"refs_dropped", "payloads_deleted",
        "payloads_kept"} — kept means another tenant still holds a ref."""
        log = log or (lambda m: None)
        ns_root = ns_root or (store_root.rstrip(os.sep) + "-ns")
        t = _safe_tenant(tenant)
        ns_dir = os.path.join(ns_root, t)
        mine = set()
        try:
            mine = {f[:-4] for f in os.listdir(ns_dir)
                    if f.endswith(".ref")}
        except OSError:
            pass
        others: set[str] = set()
        for other in cls.tenants(ns_root):
            if other == t:
                continue
            try:
                others.update(f[:-4]
                              for f in os.listdir(os.path.join(ns_root,
                                                               other))
                              if f.endswith(".ref"))
            except OSError:
                continue
        deleted = kept = 0
        for name in sorted(mine):
            if name in others:
                kept += 1
                continue
            try:
                os.remove(os.path.join(store_root, name + ".npz"))
                deleted += 1
            except OSError:
                pass    # already gone (or never published): nothing to GC
        import shutil

        shutil.rmtree(ns_dir, ignore_errors=True)
        log(f"[cache] evicted tenant {t}: {len(mine)} ref(s) dropped, "
            f"{deleted} payload(s) deleted, {kept} kept (still shared)")
        return {"refs_dropped": len(mine), "payloads_deleted": deleted,
                "payloads_kept": kept}
