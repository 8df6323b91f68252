"""The coordinated-run worker: one crash domain, leased work, cache puts.

Spawned by ``parallel/coordinator.run_coordinated`` as ``python -m
structured_light_for_3d_model_replication_tpu_torch worker --spec <json>``
(one process per host fault domain). The loop is deliberately dumb: ask
the coordinator for the next leased item, run the EXACT single-process item
program (``stages._load_fired`` → ``_compute_fired`` (decode, triangulate,
compaction) → ``_clean_arrays`` for views; ``prep_view`` +
``register_prep_pairs`` for pairs), publish the result to the
content-addressed StageCache (atomic tmp+rename put — the natural
cross-process handoff), and report ``complete``. The coordinator's assembly
pass then finds the bytes under the same keys a clean single-process run
would compute — workers never touch merged artifacts, so they cannot break
byte parity; the worst a dead worker costs is recompute.

Device: the spec names it (the coordinator's resolved device) and every
stage call gets it; a spec asking for ``cuda`` on a host without CUDA
exits non-zero with ``resolve_device``'s error before it joins, having
computed nothing. On CUDA the worker makes its context and loads the
kernel library before its first lease, so a cold first launch never eats
into one; it logs its launch counts and peak device memory at exit.

Liveness: the lease renews from *inside* ``OverlapStats.add`` via the
``profiling.set_heartbeat_hook`` ambient hook — the same can't-drift
call site the deadline watchdog beats from, so progress accounting and
lease renewal can never disagree. A worker wedged inside one stage stops
beating and loses its leases; there is deliberately NO background beat
thread that would keep a zombie's leases alive.

Host-scope fault kinds (utils/faults.py) get real semantics here:

  worker.kill        -> os._exit(137) mid-item (SIGKILL'd host)
  worker.preempt(T)  -> grace sleep, then os._exit(143) (spot preemption)
  net.partition(T)   -> drop the coordinator link for T seconds but KEEP
                        computing (compute is local; only coordination is
                        partitioned), then reconnect and report late — the
                        lease may have been stolen, exercising the
                        late-complete/"stolen" protocol arm.
  net.slowlink(T)    -> (at site ``worker.sock``) every control frame on
                        the coordinator/blobstore wire straggles T seconds;
                        nothing raises, throughput just sags.

Pod fabric: a spec carrying ``connect``/``secret`` dials a real TCP
endpoint (netutil grammar — `worker --spec <out>/.coord/join.json`
joins a listening coordinator from another shell or machine), and one
carrying ``blob``/``cache_root`` warms a PRIVATE L1 StageCache with the
coordinator-hosted blobstore as L2 (pipeline/blobstore.py). Heartbeats
and ``next`` requests piggyback inventory diffs (which blob names this
L1 holds) so pair grants can prefer the worker that already has both
endpoint views.
"""
from __future__ import annotations

import json
import os
import socket
import time

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.config import Config
from structured_light_for_3d_model_replication_tpu_torch.parallel import netutil
from structured_light_for_3d_model_replication_tpu_torch.utils import deadline as dl
from structured_light_for_3d_model_replication_tpu_torch.utils import faults
from structured_light_for_3d_model_replication_tpu_torch.utils import profiling as prof
from structured_light_for_3d_model_replication_tpu_torch.utils import telemetry as tel
from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["CoordClient", "run_worker"]


class CoordClient:
    """Persistent newline-JSON connection to the coordinator. Every call
    is synchronous request/response; socket errors propagate — the caller
    decides between reconnect (partition) and exit (dead coordinator)."""

    def __init__(self, port: int, worker: str, connect_timeout_s: float,
                 io_timeout_s: float = 60.0, connect: str = "",
                 secret: str = ""):
        # ONE resolved endpoint, shared grammar with the coordinator bind
        # and the blobstore (parallel/netutil.py) — `connect` wins, bare
        # `port` keeps the loopback default. IPv6 literals must be
        # bracketed ("[::1]:9100") and survive the round trip.
        self.host, self.port = netutil.parse_endpoint(connect,
                                                      default_port=port)
        self.worker = worker
        self.secret = secret
        self.connect_timeout_s = connect_timeout_s
        self.io_timeout_s = io_timeout_s
        self.addr = ""      # this side of the socket, once connected
        self._sock: socket.socket | None = None
        self._f = None

    def connect(self) -> None:
        """Bounded connect: retry until the coordinator answers or the
        deadline passes — a vanished coordinator must strand no worker."""
        deadline = dl.Deadline.after(self.connect_timeout_s,
                                     "coordinator connect")
        last: Exception | None = None
        while True:
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=1.0)
                self._sock.settimeout(self.io_timeout_s)
                self._f = self._sock.makefile("rw", encoding="utf-8")
                name = self._sock.getsockname()
                self.addr = netutil.format_endpoint(name[0], name[1])
                return
            except OSError as e:
                last = e
                if deadline is not None and deadline.remaining() <= 0:
                    raise dl.DeadlineExceeded(
                        f"worker {self.worker}: no coordinator at "
                        f"{netutil.format_endpoint(self.host, self.port)} "
                        f"within {self.connect_timeout_s:g}s "
                        f"({type(e).__name__}: {e})") from last
                time.sleep(0.1)

    def request(self, obj: dict) -> dict:
        if self._f is None:
            raise ConnectionError("not connected")
        # per-frame wire site: `worker.sock:net.slowlink(T)` delays every
        # control frame here (heartbeats still land — late, not lost)
        faults.fire("worker.sock", item=f"coord:{obj.get('op')}")
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()
        line = self._f.readline()
        if not line:
            raise ConnectionError("coordinator closed the connection")
        resp = json.loads(line)
        if resp.get("error") == "unauthorized":
            raise PermissionError(
                f"worker {self.worker}: coordinator at "
                f"{netutil.format_endpoint(self.host, self.port)} rejected "
                f"the handshake (bad or missing coordinator.secret)")
        return resp

    def hello(self, pid: int, inventory=None, generation: int = 0) -> dict:
        req = {"op": "hello", "worker": self.worker, "pid": pid,
               "addr": self.addr}
        if generation:
            req["generation"] = int(generation)
        if self.secret:
            req["secret"] = self.secret
        if inventory:
            req["inventory"] = list(inventory)
        return self.request(req)

    def next(self, inventory=None) -> dict:
        req = {"op": "next", "worker": self.worker}
        if inventory:
            req["inventory"] = list(inventory)
        return self.request(req)

    def beat(self, inventory=None) -> dict:
        req = {"op": "beat", "worker": self.worker}
        if inventory:
            req["inventory"] = list(inventory)
        return self.request(req)

    def complete(self, item: str, gen: int) -> str:
        return self.request({"op": "complete", "worker": self.worker,
                             "item": item, "gen": gen}).get("ok", "")

    def failed(self, item: str, gen: int, exc: BaseException) -> None:
        self.request({"op": "failed", "worker": self.worker, "item": item,
                      "gen": gen, "error": str(exc),
                      "error_type": type(exc).__name__,
                      "transient": faults.is_transient(exc)})

    def close(self) -> None:
        for x in (self._f, self._sock):
            try:
                if x is not None:
                    x.close()
            except OSError:
                pass
        self._f = self._sock = None


class _WorkerCtx:
    """Everything one worker process holds: config, device, calib, cache,
    retry policy, a scanner per calibration, the shared OverlapStats whose
    add() renews the lease."""

    def __init__(self, cfg: Config, spec: dict, client: CoordClient,
                 heartbeat_s: float, device: torch.device, blob_endpoint: str = ""):
        from structured_light_for_3d_model_replication_tpu_torch.io import (
            matfile,
        )
        from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (
            StageCache,
        )

        self.cfg = cfg
        self.spec = spec
        self.client = client
        self.heartbeat_s = heartbeat_s
        self.device = device
        self.worker = spec["worker"]
        self.generation = int(spec.get("generation", 0))
        self.steps = tuple(spec["steps"])
        # a spec may carry no scan-level calib: each item then names its own
        self.calib = (matfile.load_calibration(spec["calib"])
                      if spec.get("calib") else None)
        self._calibs: dict[str, object] = {}
        self._load_calibration = matfile.load_calibration
        self.stats = prof.OverlapStats()
        root = spec.get("cache_root") or os.path.join(spec["out"],
                                                      ".slscan-cache")
        if blob_endpoint or spec.get("connect"):
            # fabric mode: private L1 root + the blobstore as L2. A blob
            # endpoint advertising a wildcard bind resolves to the host
            # we actually dialed the coordinator on
            from structured_light_for_3d_model_replication_tpu_torch.pipeline.blobstore import (
                BlobClient,
                FabricCache,
            )

            bclient = None
            if blob_endpoint:
                bhost, bport = netutil.parse_endpoint(blob_endpoint)
                if bhost in ("0.0.0.0", "::"):
                    bhost = client.host
                bclient = BlobClient(
                    netutil.format_endpoint(bhost, bport),
                    secret=spec.get("secret", ""),
                    connect_timeout_s=cfg.coordinator.connect_timeout_s)
            self.cache = FabricCache(
                root, bclient, enabled=True,
                verify=cfg.pipeline.verify_cache, log=lambda *_: None,
                stats=self.stats)
        else:
            self.cache = StageCache(
                root, enabled=True,
                verify=cfg.pipeline.verify_cache, log=lambda *_: None)
        self._scanners: dict[tuple, object] = {}   # (calib, camera size) -> scanner
        self._last_beat = 0.0

    def inventory(self) -> list[str] | None:
        """Pending inventory diff to piggyback on the next control frame
        (None off-fabric or when nothing new was published)."""
        drain = getattr(self.cache, "drain_inventory", None)
        if drain is None:
            return None
        return drain() or None

    def heartbeat(self, stage: str) -> None:
        """The ``OverlapStats.add`` hook: renew every lease this worker
        holds, rate-limited, NEVER raising — a beat that fails (partition,
        dying coordinator) simply lets the lease age toward a steal, which
        is the correct outcome for both. Fabric heartbeats carry the
        inventory diff; a failed beat requeues it (diffs are additive,
        replay-safe)."""
        now = time.monotonic()
        if now - self._last_beat < self.heartbeat_s / 2.0:
            return
        self._last_beat = now
        inv = self.inventory()
        try:
            self.client.beat(inventory=inv)
        except Exception:
            if inv:
                self.cache.requeue_inventory(inv)

    def calib_for(self, path: str):
        """The item's calibration: the spec-level one when the item names
        none, else loaded once per distinct path."""
        if not path:
            if self.calib is None:
                raise RuntimeError(
                    f"worker {self.worker}: item carries no calib and the "
                    f"spec has none either")
            return self.calib
        c = self._calibs.get(path)
        if c is None:
            c = self._calibs[path] = self._load_calibration(path)
        return c

    def scanner(self, src: str, calib, ckey: str = ""):
        """The SLScanner of one calibration and camera size on the
        worker's device (None for the scanner-free arms), built once."""
        from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
        from structured_light_for_3d_model_replication_tpu_torch.pipeline import (
            stages,
        )

        first = imio.list_frame_files(src)[0]
        hdr = imio.probe_packed(first)
        size = ((int(hdr["width"]), int(hdr["height"])) if hdr is not None
                else imio.load_gray(first).shape[::-1])
        key = (ckey, size)
        if key not in self._scanners:
            self._scanners[key] = stages._build_scanner([src], calib, self.cfg,
                                                        self.device)
        return self._scanners[key]

    def retries(self, lane: str):
        def on_retry(n, e):
            self.stats.add_retry(lane)
        return on_retry


def _do_view(ctx: _WorkerCtx, ispec: dict) -> None:
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    src, key, idx = ispec["src"], ispec["key"], ispec["index"]
    cpath = ispec.get("calib") or ""
    calib = ctx.calib_for(cpath)
    cfg = ctx.cfg
    policy = stages._retry_policy(cfg)
    # the scanner-free arms triangulate against the tail's calib on its device
    tail = stages._Tail("batch", None, ctx.device, clean_steps=ctx.steps,
                        write_plys=False, calib=calib)
    t0 = time.perf_counter()
    frames, texture = stages._retry_stage(
        "load", lambda: stages._load_fired(src, cfg), policy,
        ctx.retries("load"))
    ctx.stats.add("load", time.perf_counter() - t0, view=idx)
    t0 = time.perf_counter()
    pts, cols = stages._retry_stage(
        "compute",
        lambda: stages._compute_fired(ctx.scanner(src, calib, cpath), frames, cfg,
                                      src, texture=texture, tail=tail),
        policy, ctx.retries("compute"))
    ctx.stats.add("compute", time.perf_counter() - t0, items=1, view=idx)
    t0 = time.perf_counter()
    pts, cols, counts = stages._retry_stage(
        "clean",
        lambda: stages._clean_arrays(pts, cols, cfg, ctx.steps, device=ctx.device,
                                     stats=ctx.stats),
        policy, ctx.retries("clean"))
    ctx.stats.add("clean", time.perf_counter() - t0, view=idx)
    t0 = time.perf_counter()
    ctx.cache.put("view", key, points=pts, colors=cols,
                  counts=np.asarray(json.dumps(counts)))
    ctx.stats.add("write", time.perf_counter() - t0, view=idx)


def _do_pair(ctx: _WorkerCtx, ispec: dict) -> None:
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
    from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (
        StageCache,
    )

    cfg = ctx.cfg
    pid, dst, src = ispec["pid"], ispec["dst"], ispec["src"]
    hd = ctx.cache.get("view", ispec["key_dst"])
    hs = ctx.cache.get("view", ispec["key_src"])
    if hd is None or hs is None:
        raise RuntimeError(
            f"pair {dst}->{src}: endpoint view(s) missing from the stage "
            f"cache (dep gating should have prevented this grant)")
    pts_d = np.asarray(hd["points"], np.float32)
    cols_d = np.asarray(hd["colors"], np.uint8)
    pts_s = np.asarray(hs["points"], np.float32)
    cols_s = np.asarray(hs["colors"], np.uint8)
    # the streamed registrar's key: endpoint OUTPUT digests + merge
    # numerics + engine tag + chain position (stages._pair_key)
    key = stages._pair_key(ctx.cache, cfg, ctx.device,
                           StageCache.digest_arrays(points=pts_d, colors=cols_d),
                           StageCache.digest_arrays(points=pts_s, colors=cols_s), pid)
    if ctx.cache.get("pair", key) is not None:
        return      # already warm (another worker, or a previous run)
    policy = stages._retry_policy(cfg)
    on_retry = ctx.retries("register")
    # same injection site + retry envelope as the streaming register lane
    faults.retry_call(
        lambda: faults.fire("register.pair", item=f"{dst}->{src}"),
        policy, on_retry=on_retry)
    voxel = float(cfg.merge.voxel_size)
    t0 = time.perf_counter()
    prep_s = recon.prep_view(pts_s, voxel, cfg.merge.sample_before, device=ctx.device)
    ctx.heartbeat("register")
    prep_d = recon.prep_view(pts_d, voxel, cfg.merge.sample_before, device=ctx.device)
    ctx.heartbeat("register")
    T, gf, fi, ir = faults.retry_call(
        lambda: recon.register_prep_pairs(
            [(prep_s, prep_d)], [pid], cfg.merge, voxel,
            feat_bf16=cfg.parallel.force_bf16_features),
        policy, on_retry=on_retry)
    ctx.stats.add("register", time.perf_counter() - t0, view=dst)
    ctx.cache.put("pair", key, T=np.asarray(T[0], np.float32),
                  gfit=np.float32(gf[0]), ifit=np.float32(fi[0]),
                  irmse=np.float32(ir[0]))


def _run_item(ctx: _WorkerCtx, kind: str, iid: str, ispec: dict) -> None:
    # the per-item host-fault site: specs match on "<worker>:<item>", so
    # `worker.item~w0:worker.kill` kills exactly worker w0's first item
    faults.fire("worker.item", item=f"{ctx.worker}:{iid}")
    if kind == "view":
        _do_view(ctx, ispec)
    else:
        _do_pair(ctx, ispec)


def _warm_device(dev: torch.device) -> None:
    """A CUDA worker's context and kernel library, made before its first
    lease: a cold first launch in a fresh process (context creation, the
    library load) then never runs inside a lease."""
    if dev.type != "cuda":
        return
    from structured_light_for_3d_model_replication_tpu_torch.ops import _build

    torch.zeros(1, device=dev)
    _build.load_library()
    torch.cuda.synchronize(dev)


def _exit_line(worker: str, dev: torch.device) -> str:
    """The worker's last log line: its kernels' launch counts and, on
    CUDA, its peak device memory."""
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return (f"[worker {worker}] exit: launches "
            f"{json.dumps(kernels.launch_counts(), sort_keys=True)} "
            f"peak_device_bytes {peak}")


def run_worker(spec_path: str, log=print) -> int:
    """The ``worker`` entry: join the coordinator, drain leased items
    until shutdown, on the spec's device. Exit codes: 0 clean, 137
    injected kill, 143 injected preemption, 1 protocol/connect failure;
    a device the host lacks raises before anything else."""
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    from structured_light_for_3d_model_replication_tpu_torch import load_config

    dev = resolve_device(spec.get("device"))
    cfg = load_config(spec["config"])
    worker = spec["worker"]
    generation = int(spec.get("generation", 0))
    # host tag: rank+pid into every artifact filename this process writes
    # (trace journal, metrics) — N workers share out_dir safely
    tel.set_host_tag(f"{worker}-{os.getpid()}")
    faults.configure_from(cfg.faults)
    _warm_device(dev)
    client = CoordClient(spec["port"], worker,
                         cfg.coordinator.connect_timeout_s,
                         connect=spec.get("connect", ""),
                         secret=spec.get("secret", ""))
    # connect BEFORE the tracer opens so the journal meta can advertise
    # this worker's wire address (the `report` host column)
    client.connect()
    tracer = prev_tr = None
    if cfg.observability.trace:
        tracer = tel.Tracer(
            os.path.join(spec["out"],
                         tel.host_scoped(cfg.observability.trace_file)),
            run_id=tel.new_run_id(),
            meta={"tool": "worker", "host": tel.host_tag(),
                  "worker": worker, "pid": os.getpid(),
                  "generation": generation or None,
                  "addr": client.addr or None,
                  "backend": cfg.parallel.backend, "engine": "torch",
                  "device": str(dev), "host_cpus": os.cpu_count()})
        prev_tr = tel.activate(tracer)

    # inventory bootstrap: a resumed fabric worker may already hold L1
    # entries from a prior attempt — advertise them in the handshake
    boot: list[str] = []
    root = spec.get("cache_root")
    if root and os.path.isdir(root):
        boot = sorted(f[:-4] for f in os.listdir(root)
                      if f.endswith(".npz"))
    try:
        hello = client.hello(os.getpid(), inventory=boot,
                             generation=generation)
    except PermissionError as e:
        log(f"[worker {worker}] {e}")
        if tracer is not None:
            tel.deactivate(prev_tr)
            tracer.close()
        client.close()
        return 1
    heartbeat_s = float(hello.get("heartbeat_s",
                                  cfg.coordinator.heartbeat_s))
    blob_endpoint = hello.get("blob") or spec.get("blob", "")
    ctx = _WorkerCtx(cfg, spec, client, heartbeat_s, dev,
                     blob_endpoint=blob_endpoint)
    prev_hook = prof.set_heartbeat_hook(ctx.heartbeat)
    log(f"[worker {netutil.worker_tag(worker, generation)}] joined run "
        f"{hello.get('run_id')} "
        f"(pid {os.getpid()}, addr {client.addr or '?'}, device {dev}, "
        f"lease {hello.get('lease_s')}s"
        + (f", blob {blob_endpoint}" if blob_endpoint else "") + ")")
    rc = 0
    try:
        while True:
            inv = ctx.inventory()
            try:
                resp = client.next(inventory=inv)
            except (OSError, ConnectionError, ValueError):
                if inv:
                    ctx.cache.requeue_inventory(inv)
                # coordinator gone mid-run: bounded reconnect, then give up
                client.close()
                try:
                    client.connect()
                    client.hello(os.getpid(), inventory=_full_inv(ctx))
                    continue
                except Exception:
                    log(f"[worker {worker}] coordinator unreachable; "
                        f"exiting")
                    rc = 1
                    break
            if resp.get("shutdown"):
                log(f"[worker {worker}] shutdown received; exiting clean")
                break
            if "grant" not in resp:
                time.sleep(float(resp.get("wait", 0.2)))
                continue
            grant = resp["grant"]
            iid, gen = grant["id"], int(grant["gen"])
            kind, ispec = grant["kind"], grant["spec"]
            if tracer is not None:
                tracer.instant("worker.grant", item=iid, gen=gen)
            try:
                _run_item(ctx, kind, iid, ispec)
            except faults.WorkerKilled:
                # simulated SIGKILL: no complete, no cleanup, no flush —
                # the lease MUST expire and the item MUST be stolen
                os._exit(137)
            except faults.WorkerPreempted as e:
                log(f"[worker {worker}] preemption notice: exiting in "
                    f"{e.grace_s:g}s grace")
                time.sleep(max(0.0, e.grace_s))
                os._exit(143)
            except faults.NetPartition as e:
                _partitioned(ctx, e, kind, iid, gen, ispec, tracer, log)
                continue
            except faults.InjectedCrash:
                os._exit(134)
            except Exception as e:
                # a load, compute or kernel failure: the item recomputes in
                # the coordinator's assembly pass, where it raises again
                log(f"[worker {worker}] item {iid} failed: "
                    f"{type(e).__name__}: {e}")
                if tracer is not None:
                    tracer.instant("worker.failed", item=iid,
                                   error=type(e).__name__)
                try:
                    client.failed(iid, gen, e)
                except Exception:
                    pass    # lease expiry covers an unreportable failure
                continue
            status = client.complete(iid, gen)
            if tracer is not None:
                tracer.instant("worker.complete", item=iid, status=status)
            if status == "stolen":
                log(f"[worker {worker}] item {iid} completed late — "
                    f"lease was stolen; result stays in cache")
    finally:
        prof.set_heartbeat_hook(prev_hook)
        client.close()
        if tracer is not None:
            tel.deactivate(prev_tr)
            tracer.close(os.path.join(
                spec["out"],
                tel.host_scoped(cfg.observability.metrics_file)))
        log(_exit_line(worker, dev))
    return rc


def _full_inv(ctx: _WorkerCtx) -> list[str] | None:
    """Full L1 inventory for a (re)handshake — the coordinator's index for
    this worker may be gone (restart) or stale (lost diffs)."""
    names = getattr(ctx.cache, "local_names", None)
    return names() or None if names is not None else None


def _partitioned(ctx: _WorkerCtx, e, kind: str, iid: str, gen: int,
                 ispec: dict, tracer, log) -> None:
    """net.partition semantics: coordination is cut for ``duration_s`` but
    compute is local — finish the item anyway, reconnect, report late. The
    coordinator may answer "stolen" (lease expired during the partition);
    the content-addressed cache makes the double-compute harmless."""
    w = ctx.worker
    log(f"[worker {w}] PARTITIONED from coordinator for "
        f"{e.duration_s:g}s (item {iid} continues locally)")
    ctx.client.close()
    time.sleep(max(0.0, e.duration_s))
    err: Exception | None = None
    try:
        if kind == "view":
            _do_view(ctx, ispec)
        else:
            _do_pair(ctx, ispec)
    except Exception as ie:
        err = ie
    ctx.client.connect()
    ctx.client.hello(os.getpid(), inventory=_full_inv(ctx))
    if err is not None:
        ctx.client.failed(iid, gen, err)
        return
    status = ctx.client.complete(iid, gen)
    if tracer is not None:
        tracer.instant("worker.complete", item=iid, status=status,
                       after_partition=True)
    log(f"[worker {w}] reconnected; late complete of {iid} -> {status}")
