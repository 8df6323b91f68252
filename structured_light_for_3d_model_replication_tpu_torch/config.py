"""Typed configuration for the scan-to-print path.

The port's own copy of the JAX package's config dataclasses, cut to what
the port's commands read. Field names and defaults are the same, so one
JSON config file loads in both packages:

  - ``projector``, ``checkerboard``, ``decode``, ``triangulate``,
    ``clean``, ``merge``, ``mesh``, ``acquire``, ``faults``, ``deadlines``
    and ``observability`` are whole copies (with their env overrides); an
    unknown key there is an error, as in the JAX package;
  - ``parallel`` carries ``backend``, ``force_bf16_features``,
    ``compute_batch``, ``io_workers`` and ``prefetch_depth``; ``pipeline``,
    ``coordinator`` and ``serving`` carry every key, and ``scan_root`` is
    carried too. The other keys of ``parallel`` configure the JAX
    package's device mesh, which the port does not have: they load without
    effect, and the loader logs each one set away from the JAX package's
    default, once a process (``_DROPPED``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any

__all__ = ["ProjectorConfig", "CheckerboardConfig", "DecodeConfig", "TriangulateConfig",
           "CleanConfig", "MergeConfig", "MeshConfig", "ParallelConfig",
           "PipelineConfig", "ObservabilityConfig", "DeadlinesConfig",
           "FaultsConfig", "CoordinatorConfig", "AcquireConfig", "ServingConfig",
           "Config", "load_config", "jax_dict"]


@dataclass
class ProjectorConfig:
    """Projector geometry."""

    width: int = 1920
    height: int = 1080
    screen_offset_x: int = 1920  # projector is the second monitor
    brightness: int = 200        # white level of projected patterns
    downsample: int = 1          # pattern downsample factor


@dataclass
class CheckerboardConfig:
    """Calibration target: inner corners and square size."""

    rows: int = 7
    cols: int = 7
    square_size_mm: float = 35.0


@dataclass
class DecodeConfig:
    """Gray-code decode."""

    n_cols: int = 1920
    n_rows: int = 1080
    n_sets_col: int = 11     # how many FIRST column bit-planes to use
    n_sets_row: int = 11     # how many FIRST row bit-planes to use
    thresh_mode: str = "otsu"  # 'otsu' | 'manual'
    shadow_val: float = 40.0
    contrast_val: float = 10.0


@dataclass
class TriangulateConfig:
    """Ray-plane triangulation."""

    row_mode: int = 1          # 0=columns only, 1=epipolar filter, 2=merge col+row clouds
    epipolar_tol: float = 2.0  # mm
    # 'table' = gather stored plane equations; 'quadratic' = closed-form
    # per-pixel plane evaluation (the fused decode+triangulate kernel)
    plane_eval: str = "table"
    # export-path triangulation through the NumPy twin: the maps decoded on
    # the device, the points bit-equal to the NumPy reference path
    bitexact: bool = False


@dataclass
class CleanConfig:
    """Per-view cleaning: background plane -> largest cluster -> radius
    outlier -> statistical outlier."""

    remove_background_plane: bool = True
    plane_ransac_dist: float = 2.0
    plane_ransac_trials: int = 512
    outlier_nb_neighbors: int = 20
    outlier_std_ratio: float = 2.0
    cluster_eps: float = 5.0
    cluster_min_points: int = 200
    radius_nb_points: int = 100
    radius: float = 5.0


@dataclass
class MergeConfig:
    """360-degree merge. ``method='sequential'`` chain-aligns view i onto
    view i-1; ``'posegraph'`` adds a first<->last loop closure and a global
    pose-graph solve (``merge_360_posegraph``). ``stream``, ``pair_batch``
    and ``incremental`` are schedule knobs (never stage-cache key material);
    ``incremental`` folds a coordinated run's settled views and pairs into
    the merge while its workers still run (``pipeline/assembly.py``)."""

    voxel_size: float = 3.0
    icp_dist_ratio: float = 1.5
    icp_iters: int = 30
    ransac_trials: int = 4096
    outlier_nb: int = 20
    outlier_std: float = 2.0
    sample_before: int = 0       # uniform sample every k-th point before register (0=off)
    sample_after: int = 0
    final_voxel: float = 0.5
    method: str = "sequential"   # 'sequential' | 'posegraph'
    # streaming merge (run_pipeline): register pair (i, i+1) the moment both
    # views are cleaned, overlapping registration with the reconstruction of
    # later views; false = the barrier merge. Both arms give the same bytes.
    stream: bool = True
    pair_batch: int = 4          # pairs per registration launch group
    incremental: bool = False


@dataclass
class MeshConfig:
    """Meshing. ``mode='watertight'`` solves screened Poisson;
    ``mode='surface'`` triangulates the points themselves (the ball-pivoting
    analog of ``ops/surface_recon.py``)."""

    mode: str = "watertight"     # 'watertight' (Poisson) | 'surface' (ball-pivot analog)
    # Poisson grid = 2^depth cells an axis: <= 9 solves dense; 10 and above
    # run the brick-refined solver on the card, and depth 10 steps down to
    # 9 on the CPU unless density_cap=false
    depth: int = 10
    # clamp depth to ~log2(sqrt(N)) + 1 (a grid finer than the sampling is
    # pure cost); false honours the requested depth
    density_cap: bool = True
    density_trim_quantile: float = 0.02
    # hybrid normal search radius in world units; 0 = pure k-NN
    normal_radius: float = 0.0
    normal_max_nn: int = 30
    orientation: str = "radial"  # 'radial' | 'tangent' | 'centroid'
    smooth_iters: int = 0
    smooth_method: str = "taubin"  # 'taubin' | 'laplacian'
    simplify_target_faces: int = 0  # 0 = no decimation
    simplify_method: str = "quadric"  # 'quadric' (QEM) | 'cluster' (vertex grid)
    close_holes_max_edges: int = 0  # fill boundary loops up to this size (0=off)
    surface_alpha_factor: float = 2.5  # mode='surface': ball radius / avg NN dist
    surface_k: int = 12               # mode='surface': neighbor fan size


@dataclass
class AcquireConfig:
    """Capture rig: the phone rendezvous server, settle times, the
    turntable and the retry budgets of the acquisition path."""

    http_host: str = "0.0.0.0"
    http_port: int = 5000
    long_poll_hold_s: float = 2.0
    capture_timeout_s: float = 20.0
    disconnect_after_s: float = 5.0
    settle_ms_scan: int = 200
    settle_ms_calib: int = 250
    serial_port: str = ""        # empty = the first serial port found
    serial_baud: int = 115200
    rotate_timeout_s: float = 30.0
    turns: int = 12
    degrees_per_turn: float = 30.0
    simulate: bool = False       # no hardware: virtual projector, simulated turntable
    # transient-failure retry budgets: http_retries re-runs a failed phone
    # HTTP request; rotate_retries re-issues a rotation after a missed DONE
    # or a serial error, re-opening the port between attempts;
    # capture_retries re-runs a whole per-view capture sequence before
    # auto-scan records the view as failed and goes on with the sweep
    http_retries: int = 2
    http_backoff_s: float = 0.2
    rotate_retries: int = 1
    capture_retries: int = 1
    # pack each captured view to the bit-plane container (frames.slbp) as
    # soon as its sequence lands; pack_keep_raw keeps the PNGs beside it
    pack_frames: bool = False
    pack_keep_raw: bool = False


@dataclass
class ParallelConfig:
    """Execution knobs: the backend, the merge's feature precision and the
    reconstruct lanes."""

    # 'jax': the port's device path (the name is the JAX package's, so one
    # JSON config serves both packages); 'numpy': the host reference path,
    # decode and triangulate through the NumPy twins (no scanner, no batch)
    backend: str = "jax"
    # bf16 FPFH feature-distance products with f32 output (tensor cores on
    # the card); geometry stays f32. Off by default: the JAX package
    # measured global fitness 0.818 -> 0.608 with it on a TPU
    force_bf16_features: bool = False
    # host I/O threads for frame decode and the reconstruct lanes' prefetch
    # pool; <=1 (with compute_batch <= 1) runs the serial lane. Env
    # override: SL3D_IO_WORKERS.
    io_workers: int = field(
        default_factory=lambda: int(os.environ.get("SL3D_IO_WORKERS", "4")))
    # frame stacks the prefetcher may hold ahead of the compute stage (the
    # batched lane holds compute_batch + prefetch_depth; each 46x1080p stack
    # is ~95 MB of host memory). Env override: SL3D_PREFETCH_DEPTH.
    prefetch_depth: int = field(
        default_factory=lambda: int(os.environ.get("SL3D_PREFETCH_DEPTH", "2")))
    # views per device launch for batch reconstruct; <=1 runs one view per
    # launch. Env override: SL3D_COMPUTE_BATCH.
    compute_batch: int = field(
        default_factory=lambda: int(os.environ.get("SL3D_COMPUTE_BATCH", "8")))


@dataclass
class PipelineConfig:
    """The scan-to-print command (``pipeline``): ingest format, the stage
    cache, the failure domain (retries, quarantine, the view floor, the run
    budget) and the per-view side output."""

    # content-addressed stage cache under <out>/.slscan-cache: reruns skip
    # every stage whose inputs (frames, calib, config subtree) are unchanged
    cache: bool = True
    # also write each cleaned per-view cloud as <out>/views/<name>.ply (on
    # the writeback queue; always binary)
    write_view_plys: bool = False
    # the final merged.ply in the reference's ASCII layout (%.4f, lossy);
    # intermediate artifacts stay binary
    ascii_output: bool = False
    # proceed to merge when at least max(2, min_views) views survive
    # reconstruction (failed views are quarantined and the run completes
    # DEGRADED with a failure manifest); below the floor the run aborts
    min_views: int = 2
    # bounded retry + exponential backoff for TRANSIENT per-view faults: up
    # to max_retries extra attempts, sleeping retry_backoff_s * 2^(n-1)
    # capped at retry_backoff_max_s; permanent failures skip to quarantine
    max_retries: int = 2
    retry_backoff_s: float = 0.05
    retry_backoff_max_s: float = 1.0
    # full jitter on those sleeps (uniform in [0, delay]), seeded from the
    # armed fault plan so chaos runs stay reproducible
    retry_jitter: bool = True
    # verify stage-cache payloads against their recorded digest on read; a
    # corrupt entry is evicted and recomputed
    verify_cache: bool = True
    # overall wall-clock budget for one run, seconds (0 = unbounded; env
    # SL3D_RUN_BUDGET_S), checked at stage boundaries and lane scheduling
    # steps: exceeding it ABORTS the run with an aborted failure manifest
    run_budget_s: float = field(
        default_factory=lambda: float(os.environ.get("SL3D_RUN_BUDGET_S", "0")))
    # the batched lane's drain compacts and cleans each batch's views on the
    # device and copies the results to the host once; the cleaned device
    # buffers feed the register lane's prep without a re-upload. Outputs
    # are byte-identical to the discrete drain (batched lane only)
    fused_clean: bool = False
    # load each view as a packed bit-plane stack (frames.slbp where present,
    # packed at load otherwise) and decode from the bits on the device;
    # outputs are byte-identical to raw ingest (batched lane only)
    packed_ingest: bool = False


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes", "on")


@dataclass
class ObservabilityConfig:
    """Run-scoped flight recorder (``utils/telemetry.py``), off by default.
    When on, ``pipeline`` writes an append-only crash-safe ``trace.jsonl``
    event journal plus a ``metrics.json`` registry snapshot into its out
    dir."""

    # env override SL3D_TRACE=1
    trace: bool = field(default_factory=lambda: _env_flag("SL3D_TRACE"))
    trace_file: str = "trace.jsonl"
    metrics_file: str = "metrics.json"


@dataclass
class DeadlinesConfig:
    """Per-lane deadlines + the lane watchdog (``utils/deadline.py``): a
    wedged load, device dispatch, write or pair registration never hangs a
    run. Enabled by default (env SL3D_NO_DEADLINES=1 disables); the budgets
    are far above any healthy lane wall."""

    enabled: bool = field(default_factory=lambda: not _env_flag("SL3D_NO_DEADLINES"))
    # per-lane budgets for each bounded wait, seconds (0 = unbounded); a
    # breach abandons THAT item (quarantined, the run goes on DEGRADED)
    load_s: float = 300.0      # frame-stack load wait per view
    compute_s: float = 900.0   # decode+triangulate (incl. device sync)
    write_s: float = 300.0     # one artifact writeback wait
    register_s: float = 900.0  # streaming-merge register-lane drain
    drain_s: float = 600.0     # whole writeback drain budget
    cache_s: float = 300.0     # stage-cache keying (frame-byte hashing)
    # the watchdog: no lane heartbeat for soft_stall_s -> a warning and a
    # trace event; for hard_stall_s -> cancel the stalled item and dump all
    # thread stacks into stalls.json. 0 disables a level.
    watchdog_poll_s: float = 1.0
    soft_stall_s: float = 60.0
    hard_stall_s: float = 300.0


@dataclass
class CoordinatorConfig:
    """The multiprocess coordinator (``parallel/coordinator.py``): one
    scan's view and pair items leased to N worker processes under a
    lease/heartbeat protocol. ``workers=0`` with an empty ``listen`` (the
    default) is a single-process run. Workers only warm the
    content-addressed stage cache and the coordinator's assembly pass is the
    single-process pipeline over it, so the output bytes are the
    single-process run's."""

    # worker processes to spawn (0 = single-process, coordinator disabled)
    workers: int = 0
    # a granted item's lease; it renews on every OverlapStats.add heartbeat,
    # so only a killed, preempted, wedged or partitioned worker lets one
    # expire, and the item is then stolen and granted to a survivor
    lease_s: float = 45.0
    # worker -> coordinator heartbeat cadence (well under lease_s)
    heartbeat_s: float = 2.0
    # times one item may be stolen before it is left to the assembly pass
    max_steals: int = 3
    # coordinator TCP port (loopback only); 0 = ephemeral
    port: int = 0
    # worker -> coordinator connect deadline
    connect_timeout_s: float = 20.0
    # the pod fabric (parallel/netutil.py endpoint grammar): the
    # coordinator's bind endpoint ("host:port", "[v6]:port", ":port"); set,
    # it co-hosts the blob store, spawned workers get private L1 cache roots
    # and external workers may join over TCP
    listen: str = ""
    # worker side: the coordinator endpoint to dial (empty: loopback `port`)
    connect: str = ""
    # shared secret of the hello handshake (coordinator and blob store)
    secret: str = ""


@dataclass
class FaultsConfig:
    """Deterministic fault injection (``utils/faults.py``). Disabled by
    default; the SL3D_FAULTS / SL3D_FAULTS_SEED env vars override it."""

    # comma list of `site[~substr]:kind[@n][xM][%p]` rules
    spec: str = ""
    seed: int = 0


@dataclass
class ServingConfig:
    """The persistent multi-tenant scan service (``pipeline/serving.py``,
    the ``serve`` command): a stdlib-HTTP gateway admits scans through the
    multi-scan lease/ledger protocol (``parallel/admission.py``), engine
    lanes warm the shared content-addressed stage cache with views drawn
    from several scans at once (one device launch may hold several
    tenants' views), and each request is assembled by the single-process
    ``run_pipeline`` over the warmed cache, so every response is the solo
    ``pipeline`` run's bytes. The JAX package's section, key for key."""

    # gateway bind address (plaintext HTTP; loopback by default)
    host: str = "127.0.0.1"
    # 0 = ephemeral (the bound port is logged and written to serve.json)
    port: int = 8089
    # scans admitted to the engine at once; queued scans wait weighted-fair
    max_active_scans: int = 4
    # per-tenant caps on active and queued scans (over the queue quota: 429)
    tenant_active_quota: int = 2
    tenant_queue_quota: int = 8
    # total queue depth across tenants (429 when full)
    queue_depth: int = 64
    # engine item lease (s): a lane that stops beating loses its grants
    lease_s: float = 30.0
    # default per-request SLO (s) when a submit carries no budget_s; 0 = none
    default_budget_s: float = 0.0
    # default tenant weight of the weighted-fair admission and grants
    default_weight: float = 1.0
    # engine lanes drawing view grants (each runs one launch at a time)
    engine_lanes: int = 1
    # the per-view clean steps (comma list); service-wide, since steps are
    # view-cache key material
    clean_steps: str = "background,cluster,radius,statistical"
    # engine idle poll (s)
    poll_s: float = 0.05
    # persist every accepted submit (request record, fsync) before its
    # answer, and resume from the records and the ledger on start
    durable: bool = True
    # graceful-stop budget (s) before in-flight scans are checkpointed
    drain_budget_s: float = 30.0
    # shed a queued scan that waited longer than this (s); 0 = off
    max_queue_wait_s: float = 0.0
    # per-tenant circuit breaker: consecutive failed scans that open it
    # (0 = off), and the cooldown before one half-open probe
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    # gateway HA: members over one root elect a leader through
    # <root>/leader.json; the rest serve reads and redirect submits
    ha_enabled: bool = False
    # leader lease (s): the failover bound
    ha_lease_s: float = 5.0
    # leader renew cadence (s); 0 = ha_lease_s / 3
    ha_renew_s: float = 0.0
    # follower takeover poll (s); 0 = ha_lease_s / 5
    ha_poll_s: float = 0.0
    # elastic fleet (parallel/fleet.py): the leader spawns and retires
    # worker processes against live admission signals
    fleet_enabled: bool = False
    fleet_min_workers: int = 0
    fleet_max_workers: int = 4
    # supervisor tick (s)
    fleet_poll_s: float = 0.5
    # one worker per this many grantable views
    fleet_scale_up_queue: int = 4
    # retire to the floor only after this long idle (s)
    fleet_scale_in_idle_s: float = 5.0
    # respawn backoff (s), doubling per death up to the max
    fleet_backoff_s: float = 0.5
    fleet_backoff_max_s: float = 30.0
    # deaths of one rank inside the window that mark it flapping (0 = off)
    fleet_flap_threshold: int = 3
    fleet_flap_window_s: float = 60.0
    # fleet bridge bind endpoint (netutil grammar); empty = loopback,
    # workers then warm the shared store on this host's disk
    fleet_listen: str = ""
    # shared secret of the fleet workers' hello
    fleet_secret: str = ""
    # front-door auth: per-tenant API keys (sha256 at rest in
    # <root>/tenants.json, written by the `tenant` command)
    auth_enabled: bool = False
    # tenants file; empty = <root>/tenants.json
    auth_tenants_file: str = ""
    # default per-tenant submits per window (0 = unlimited)
    auth_rate_limit: int = 0
    auth_rate_window_s: float = 60.0


@dataclass
class Config:
    """Root configuration of the scan-to-print path."""

    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    checkerboard: CheckerboardConfig = field(default_factory=CheckerboardConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    triangulate: TriangulateConfig = field(default_factory=TriangulateConfig)
    clean: CleanConfig = field(default_factory=CleanConfig)
    merge: MergeConfig = field(default_factory=MergeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    acquire: AcquireConfig = field(default_factory=AcquireConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    faults: FaultsConfig = field(default_factory=FaultsConfig)
    coordinator: CoordinatorConfig = field(default_factory=CoordinatorConfig)
    deadlines: DeadlinesConfig = field(default_factory=DeadlinesConfig)
    observability: ObservabilityConfig = field(default_factory=ObservabilityConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    scan_root: str = ""   # dated scan folder; empty = ./scans/<date>

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


# The JAX package's keys the port loads without effect, with the JAX
# package's defaults: a section name maps to its dropped keys; a name
# mapping to a plain value is a dropped top-level key.
_DROPPED: dict[str, Any] = {
    "parallel": {"data_axis": 0, "model_axis": 1, "merge_mesh": False,
                 "shard_views": True},
}
_SECTIONS = {"Config": None, "ParallelConfig": "parallel", "PipelineConfig": "pipeline"}
_logged: set[str] = set()


def _note_dropped(name: str, value: Any, default: Any, log, seen: dict) -> None:
    """Record a dropped key's value in ``seen`` (by dotted name) and log it
    once a process, when set away from its default."""
    seen[name] = value
    if value != default and name not in _logged:
        _logged.add(name)
        log(f"[config] {name}={value!r} is not ported; the port ignores it "
            f"(default {default!r})")


def _drop(cls: type, data: dict[str, Any], log, seen: dict) -> dict[str, Any]:
    """``data`` without the keys ``cls`` does not carry: those of
    ``_DROPPED`` are logged (when set away from the default), any other is
    an error, as in the JAX package."""
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - known
    section = _SECTIONS.get(cls.__name__, "")
    dropped = _DROPPED if section is None else _DROPPED.get(section, {})
    if any(k not in dropped for k in unknown):
        raise ValueError(
            f"Unknown key(s) in config section {cls.__name__}: {sorted(unknown)}; "
            f"valid keys: {sorted(known)}")
    for k in sorted(unknown):
        if section is None and isinstance(dropped[k], dict):
            for leaf, v in (data[k] or {}).items():
                if leaf in dropped[k]:
                    _note_dropped(f"{k}.{leaf}", v, dropped[k][leaf], log, seen)
        else:
            _note_dropped(f"{section}.{k}" if section else k, data[k], dropped[k], log,
                          seen)
    return {k: v for k, v in data.items() if k in known}


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr)


def _from_dict(cls: type, data: dict[str, Any], log=_stderr,
               seen: dict | None = None) -> Any:
    import typing

    seen = {} if seen is None else seen
    hints = typing.get_type_hints(cls)
    data = _drop(cls, data, log, seen)
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        ftype = hints.get(f.name)
        if isinstance(v, dict) and dataclasses.is_dataclass(ftype):
            kwargs[f.name] = _from_dict(ftype, v, log, seen)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def _coerce(cur: Any, value: Any) -> Any:
    """Coerce an override value to the type of the current field value."""
    if dataclasses.is_dataclass(cur):
        raise ValueError(
            f"Cannot override a whole config section with {value!r}; "
            f"use a dotted leaf key like section.field=value")
    if value is None or cur is None:
        return value
    if isinstance(cur, bool):
        if isinstance(value, str):
            low = value.strip().lower()
            if low in ("1", "true", "yes", "on"):
                return True
            if low in ("0", "false", "no", "off"):
                return False
            raise ValueError(f"Cannot interpret {value!r} as a boolean")
        return bool(value)
    if isinstance(cur, int):
        as_float = float(value)
        if as_float != int(as_float):
            raise ValueError(f"Expected an integer, got {value!r}")
        return int(as_float)
    return type(cur)(value)


def load_config(path: str | None = None,
                overrides: dict[str, Any] | None = None) -> Config:
    """Load a Config from JSON, with optional dotted-key overrides
    (``{"decode.thresh_mode": "manual"}``). A key the port does not carry
    (``_DROPPED``) loads without effect, logged to stderr once a process
    when set away from the JAX package's default; ``jax_dict`` gives it
    back."""
    cfg = Config()
    seen: dict[str, Any] = {}
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"Config file not found: {path}")
        with open(path) as f:
            cfg = _from_dict(Config, json.load(f), seen=seen)
    for key, value in (overrides or {}).items():
        parts = key.split(".")
        table = _DROPPED
        for p in parts[:-1]:
            table = table.get(p) if isinstance(table, dict) else None
        if isinstance(table, dict) and not isinstance(table.get(parts[-1], {}), dict):
            default = table[parts[-1]]
            _note_dropped(key, _coerce(default, value), default, _stderr, seen)
            continue
        obj: Any = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        cur = getattr(obj, leaf)  # raises AttributeError on unknown keys
        setattr(obj, leaf, _coerce(cur, value))
    cfg._dropped = seen
    return cfg


# The JAX package's key order where the port's differs: the top-level
# sections and ``parallel``, whose dropped keys sit between the port's.
_JAX_ORDER: dict[str, tuple[str, ...]] = {
    "": ("projector", "checkerboard", "decode", "triangulate", "clean", "merge",
         "mesh", "acquire", "parallel", "pipeline", "faults", "coordinator",
         "deadlines", "observability", "serving", "scan_root"),
    "parallel": ("data_axis", "model_axis", "backend", "force_bf16_features",
                 "merge_mesh", "io_workers", "prefetch_depth", "compute_batch",
                 "shard_views"),
}


def jax_dict(cfg: Config) -> dict[str, Any]:
    """The resolved configuration as the JAX package's ``Config.to_dict``
    gives it for the same file and overrides (the ``config`` command's
    JSON): the port's keys, and each dropped key at the value the loader
    read (else the JAX package's default), in the JAX package's order."""
    seen = getattr(cfg, "_dropped", {})
    ours = cfg.to_dict()
    out: dict[str, Any] = {}
    for top, order in _JAX_ORDER.items():   # a key missing here would drop silently
        keys = set(ours) if top == "" else set(ours[top]) | set(_DROPPED[top])
        if not keys <= set(order):
            raise AssertionError(f"_JAX_ORDER[{top!r}] lacks {sorted(keys - set(order))}")
    for top in _JAX_ORDER[""]:
        dropped = _DROPPED.get(top)
        if top not in ours:
            out[top] = ({k: seen.get(f"{top}.{k}", v) for k, v in dropped.items()}
                        if isinstance(dropped, dict) else seen.get(top, dropped))
            continue
        if not isinstance(ours[top], dict):   # a carried top-level key
            out[top] = ours[top]
            continue
        sec = dict(ours[top])
        for k, v in (dropped or {}).items():
            sec[k] = seen.get(f"{top}.{k}", v)
        out[top] = {k: sec[k] for k in _JAX_ORDER.get(top, sec)}
    return out
