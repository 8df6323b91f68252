"""Content-addressed blob fabric: the stage cache's network L2.

Coordinated workers on one host share one disk, so a shared stage cache is
free; across hosts it is not. This module makes the content-addressed store
a two-level cache:

  L1  the worker's local ``StageCache`` directory (write-through, always
      consulted first, with the stage cache's own semantics)
  L2  a blob service co-hosted with the coordinator, speaking the same
      newline-JSON control framing as the lease protocol with raw
      length-announced payload bytes after the header line

Entries are immutable and content-addressed (``<stage>-<key16>.npz``), so
there is no consistency problem to solve: a name either resolves to the
right bytes or to a miss. Corruption cannot cross the wire undetected —
every transfer carries a sha256 of the raw blob bytes, verified on BOTH
ends (the server rejects a torn push before publishing; the client drops a
torn fetch), and a fetched blob is then promoted into L1 and re-read
through ``StageCache.get``'s normal ``__key__``/``__digest__`` verification.
A corrupt or torn blob is therefore always a *miss* — never a wrong answer
— and a miss just means the item recomputes, which the cache-warmer
parity construction already tolerates.

Protocol (one connection, sequential request/response):

  ``{"op": "hello", "secret": S}``                 -> ``{"ok": true}``
  ``{"op": "get", "name": N}``                     -> ``{"ok": true,
      "size": n, "sha256": d}`` + n raw bytes, or ``{"ok": false}`` (miss)
  ``{"op": "put", "name": N, "size": n, "sha256": d}`` + n raw bytes
      -> ``{"ok": true, "deduped": bool}``

When the coordinator's shared secret is set, the first request on every
connection must be a matching ``hello``; anything else answers
``{"error": "unauthorized"}`` and nothing is served.

Fault sites: ``blob.fetch`` / ``blob.push`` fire client-side per transfer
(transient faults absorb into one retry; anything else degrades to a
miss / unpushed blob — the fabric is an optimization, never a failure
source). ``worker.sock`` fires per control frame and is where the
``net.slowlink(T)`` kind delays traffic.

A copy of the JAX package's ``pipeline/blobstore.py``: the same wire
messages, names and counters, so a worker of either package reads and
writes a blob store the other package serves.
"""
from __future__ import annotations

import hashlib
import json
import os
import socket
import threading

from structured_light_for_3d_model_replication_tpu_torch.parallel import netutil
from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (
    StageCache,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import (
    deadline as dl,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import faults

__all__ = ["BlobServer", "BlobClient", "FabricCache"]

# blobs are whole .npz stage payloads; cap a single transfer well above
# any real payload but below "a corrupted size field just allocated 8 GB"
_MAX_BLOB = 1 << 31


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _safe_name(name: str) -> bool:
    """Blob names are exactly the store's entry basenames
    (``<stage>-<key16>``) — no separators, no dotfiles, no traversal."""
    return bool(name) and all(c.isalnum() or c in "-_" for c in name) \
        and len(name) <= 128


class BlobServer:
    """Serve a ``StageCache`` directory over TCP (daemon accept loop, one
    thread per connection — the coordinator ``_Server`` shape). Co-hosted
    with the coordinator and backed by the SAME directory the assembly
    pass reads, so every blob a worker pushes is already where the
    single-process pipeline expects it."""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0,
                 secret: str = "", log=None, on_blob=None):
        self.root = root
        self.secret = secret
        self._log = log or (lambda m: None)
        # on_blob(name): called after a pushed blob COMMITS to the store
        # (post os.replace — the bytes are readable). The incremental
        # assembler's earliest wake-up signal; must be cheap/non-blocking
        # (it runs on the per-connection server thread) and must never
        # raise into the protocol loop.
        self._on_blob = on_blob
        os.makedirs(root, exist_ok=True)
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.2)
        self.host, self.port = self._sock.getsockname()[:2]
        self._lock = threading.Lock()
        self._counters = {"fetches": 0, "misses": 0, "pushes": 0,
                          "dedups": 0, "rejects": 0, "bytes_fetched": 0,
                          "bytes_pushed": 0, "bytes_deduped": 0}
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="sl3d-blobstore", daemon=True)
        self._thread.start()

    @property
    def endpoint(self) -> str:
        return netutil.format_endpoint(self.host, self.port)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def names(self) -> list[str]:
        """Current inventory of the backing store (entry names without the
        ``.npz`` suffix) — the coordinator's own holdings."""
        try:
            return sorted(f[:-4] for f in os.listdir(self.root)
                          if f.endswith(".npz"))
        except OSError:
            return []

    def close(self) -> None:
        self._done.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)

    # -- internals -------------------------------------------------------

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] += n

    def _accept_loop(self) -> None:
        while not self._done.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        authed = not self.secret
        try:
            conn.settimeout(60.0)
            f = conn.makefile("rwb")
            while not self._done.is_set():
                line = f.readline()
                if not line:
                    return
                try:
                    req = json.loads(line)
                except ValueError:
                    _reply(f, {"error": "bad request"})
                    return
                op = req.get("op")
                if op == "hello":
                    if self.secret and req.get("secret") != self.secret:
                        _reply(f, {"error": "unauthorized"})
                        return
                    authed = True
                    _reply(f, {"ok": True})
                    continue
                if not authed:
                    _reply(f, {"error": "unauthorized"})
                    return
                if op == "get":
                    self._op_get(f, req)
                elif op == "put":
                    self._op_put(f, req)
                else:
                    _reply(f, {"error": f"unknown op {op!r}"})
        except (OSError, ValueError):
            pass    # client went away / torn frame: their retry, our shrug
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _op_get(self, f, req: dict) -> None:
        name = req.get("name", "")
        path = os.path.join(self.root, name + ".npz")
        if not _safe_name(name) or not os.path.exists(path):
            self._bump("misses")
            _reply(f, {"ok": False})
            return
        try:
            with open(path, "rb") as blob:
                data = blob.read()
        except OSError:
            self._bump("misses")
            _reply(f, {"ok": False})
            return
        _reply(f, {"ok": True, "size": len(data), "sha256": _sha256(data)})
        f.write(data)
        f.flush()
        self._bump("fetches")
        self._bump("bytes_fetched", len(data))

    def _op_put(self, f, req: dict) -> None:
        name = req.get("name", "")
        size = int(req.get("size", -1))
        if not _safe_name(name) or not 0 <= size <= _MAX_BLOB:
            _reply(f, {"error": "bad put header"})
            return
        data = f.read(size)
        if len(data) != size or _sha256(data) != req.get("sha256"):
            # torn or corrupted in flight: NEVER publish; the pusher's L1
            # still has the real bytes and assembly recomputes at worst
            self._bump("rejects")
            _reply(f, {"error": "digest mismatch"})
            return
        path = os.path.join(self.root, name + ".npz")
        if os.path.exists(path):
            self._bump("dedups")
            self._bump("bytes_deduped", size)
            _reply(f, {"ok": True, "deduped": True})
            return
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as out:
                out.write(data)
            os.replace(tmp, path)
        except OSError as e:
            try:
                os.remove(tmp)
            except OSError:
                pass
            _reply(f, {"error": f"store write failed: {e}"})
            return
        self._bump("pushes")
        self._bump("bytes_pushed", size)
        if self._on_blob is not None:
            try:
                self._on_blob(name)
            except Exception:
                pass   # a notification hook must never break the protocol
        _reply(f, {"ok": True, "deduped": False})


def _reply(f, obj: dict) -> None:
    f.write((json.dumps(obj) + "\n").encode())
    f.flush()


class BlobClient:
    """Worker-side L2 channel: one persistent connection, lazy dial with
    the connect deadline, one silent reconnect per call. Every public
    method degrades to a miss / no-op on failure — the fabric must never
    turn a computable item into a failed one."""

    def __init__(self, endpoint: str, secret: str = "",
                 connect_timeout_s: float = 20.0,
                 io_timeout_s: float = 60.0):
        self.host, self.port = netutil.parse_endpoint(endpoint)
        self.secret = secret
        self.connect_timeout_s = float(connect_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self._sock: socket.socket | None = None
        self._file = None
        self._lock = threading.Lock()

    def _connect(self) -> None:
        deadline = dl.Deadline.after(self.connect_timeout_s,
                                     "blobstore connect")
        last: Exception | None = None
        while True:
            if deadline is not None and deadline.remaining() <= 0:
                raise dl.DeadlineExceeded(
                    f"blobstore at {self.host}:{self.port} unreachable "
                    f"within {self.connect_timeout_s:g}s ({last})")
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=1.0)
                break
            except OSError as e:
                last = e
                dl.sleep_cancellable(0.2)
        self._sock.settimeout(self.io_timeout_s)
        self._file = self._sock.makefile("rwb")
        if self.secret:
            rep = self._roundtrip({"op": "hello", "secret": self.secret})
            if not rep.get("ok"):
                raise ConnectionError(
                    f"blobstore hello rejected: {rep.get('error')}")

    def _roundtrip(self, req: dict, body: bytes = b"") -> dict:
        faults.fire("worker.sock", item=f"blob:{req.get('op')}")
        self._file.write((json.dumps(req) + "\n").encode())
        if body:
            self._file.write(body)
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise ConnectionError("blobstore closed the connection")
        return json.loads(line)

    def _reset(self) -> None:
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = None
        self._file = None

    def close(self) -> None:
        with self._lock:
            self._reset()

    def fetch(self, name: str) -> bytes | None:
        """Blob bytes by name, or None on ANY miss: absent, unreachable,
        torn, or digest-mismatched. A transient ``blob.fetch`` fault (and
        one socket hiccup) absorbs into a single retry."""
        for attempt in (1, 2):
            try:
                faults.fire("blob.fetch", item=name)
                with self._lock:
                    if self._file is None:
                        self._connect()
                    rep = self._roundtrip({"op": "get", "name": name})
                    if not rep.get("ok"):
                        return None
                    size = int(rep.get("size", -1))
                    if not 0 <= size <= _MAX_BLOB:
                        raise ConnectionError("bad fetch header")
                    data = self._file.read(size)
                if len(data) == size and _sha256(data) == rep.get("sha256"):
                    return data
                # torn/corrupt in flight — treat exactly like a socket
                # error: drop the connection, maybe retry, else miss
                raise ConnectionError("fetched blob failed digest check")
            except faults.InjectedCrash:
                raise
            except dl.DeadlineExceeded:
                return None     # unreachable within budget: miss, not fatal
            except Exception as e:
                self._reset()
                if attempt == 1 and _retryable(e):
                    continue
                return None
        return None

    def push(self, name: str, data: bytes) -> str | None:
        """Publish blob bytes; returns "pushed", "deduped", or None on
        failure (best-effort — L1 still holds the payload)."""
        for attempt in (1, 2):
            try:
                faults.fire("blob.push", item=name)
                with self._lock:
                    if self._file is None:
                        self._connect()
                    rep = self._roundtrip(
                        {"op": "put", "name": name, "size": len(data),
                         "sha256": _sha256(data)}, body=data)
                if rep.get("ok"):
                    return "deduped" if rep.get("deduped") else "pushed"
                return None
            except faults.InjectedCrash:
                raise
            except dl.DeadlineExceeded:
                return None     # unreachable within budget: no-op, not fatal
            except Exception as e:
                self._reset()
                if attempt == 1 and _retryable(e):
                    continue
                return None
        return None


def _retryable(e: Exception) -> bool:
    """One retry for injected transients and ordinary socket trouble;
    injected *permanent* faults must not retry (that is their contract)."""
    if isinstance(e, faults.InjectedFault):
        return faults.is_transient(e)
    return isinstance(e, (OSError, ConnectionError, ValueError))


class FabricCache(StageCache):
    """Two-level stage cache: local disk is the write-through L1 (all the
    stage cache's semantics — verification, eviction, atomic publish), the blob
    fabric is L2.

    ``get``: L1 first; on miss, fetch by name from L2, promote the raw
    bytes into L1 (tmp + rename), and re-read through the NORMAL verifying
    ``StageCache.get`` — so a fetched blob passes the same
    ``__key__``/``__digest__`` checks as a local entry, and a corrupt one
    evicts and stays a miss. The journal then shows the true story: one
    ``cache.miss`` (L1) followed by one ``cache.hit`` (promoted).

    ``put``: write-through — L1 publish via ``StageCache.put``, then push
    the published file's bytes to L2 so dependents on OTHER hosts can
    fetch it. Names published or promoted since the last drain accumulate
    in a pending set the worker piggybacks on its next heartbeat — the
    inventory protocol behind locality-aware grants.
    """

    def __init__(self, root: str, client: BlobClient | None,
                 enabled: bool = True, log=None, verify: bool = True,
                 stats=None):
        super().__init__(root, enabled=enabled, log=log, verify=verify)
        self._client = client
        self._stats = stats      # OverlapStats (add_fabric) or None
        self._plock = threading.Lock()
        self._pending: set[str] = set()

    def _note(self, name: str) -> None:
        with self._plock:
            self._pending.add(name)

    def drain_inventory(self) -> list[str]:
        """Names newly held since the last drain (heartbeat payload)."""
        with self._plock:
            out = sorted(self._pending)
            self._pending.clear()
            return out

    def requeue_inventory(self, names) -> None:
        """Put a drained diff back (the carrying request never arrived) so
        the next heartbeat retries it — diffs are additive, so replays
        cannot corrupt the coordinator's index."""
        with self._plock:
            self._pending.update(names)

    def local_names(self) -> list[str]:
        """Full L1 inventory — the bootstrap diff a worker sends on
        ``hello`` (resumed workers may hold entries from a prior run)."""
        try:
            return sorted(f[:-4] for f in os.listdir(self.root)
                          if f.endswith(".npz"))
        except OSError:
            return []

    def get(self, stage: str, key: str) -> dict | None:
        hit = super().get(stage, key)
        if hit is not None or not self.enabled or self._client is None:
            return hit
        name = f"{stage}-{key[:16]}"
        data = self._client.fetch(name)
        if data is None:
            return None
        path = self._path(stage, key)
        tmp = path + ".fetch.tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return None
        if self._stats is not None:
            self._stats.add_fabric(fetched=len(data))
        hit = super().get(stage, key)    # full verify; corrupt -> evict+miss
        if hit is not None:
            self._note(name)
        return hit

    def put(self, stage: str, key: str, **arrays) -> None:
        super().put(stage, key, **arrays)
        if not self.enabled:
            return
        path = self._path(stage, key)
        if not os.path.exists(path):
            return    # best-effort L1 put failed; nothing to push
        name = f"{stage}-{key[:16]}"
        self._note(name)
        if self._client is None:
            return
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return
        status = self._client.push(name, data)
        if self._stats is not None and status is not None:
            if status == "deduped":
                self._stats.add_fabric(deduped=len(data))
            else:
                self._stats.add_fabric(pushed=len(data))
