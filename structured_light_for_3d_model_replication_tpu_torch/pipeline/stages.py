"""File-level stages: scan folders -> per-view colored PLY -> cleaned views
-> merged cloud -> mesh, and the whole chain in one process.

``run_pipeline`` is the port's main path (the JAX package's ``sl3d
pipeline``): capture folders -> per-view clouds -> the masked clean chain
-> 360-degree merge -> Poisson mesh -> ``merged.ply`` + ``model.stl``, the
clouds handed stage to stage in memory. It is serial: the JAX package's
streaming registrar, stage cache, retries, quarantine, deadlines and
telemetry are not ported; a failing view aborts the run with a
``failures.json``.

``clean_cloud`` / ``clean_batch`` (``sl3d clean``), ``merge_views``
(``sl3d merge-360``) and ``mesh_cloud`` (``sl3d mesh``) are the file-level
stages.

``reconstruct`` is the port's user entry point of the scan path (the JAX
package's ``sl3d reconstruct``): it resolves the scan sources, builds one
SLScanner on the device, and runs one of three lanes:

  serial   one view per device launch (``parallel.compute_batch <= 1`` or a
           single source)
  batched  ``compute_batch`` views per launch, frames stacked [V, F, H, W]
  packed   the batched lane fed packed bit-planes (``pipeline.packed_ingest``):
           ~8x fewer bytes to the device, byte-identical PLYs

Outputs follow the JAX package's path contract: ``<output>/<view>.ply`` for
batch/files mode, ``output`` itself (or ``<target>.ply``) for single mode.
Errors propagate; per-view retry and quarantine are not ported yet.
"""
from __future__ import annotations

import json
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.config import Config
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import atomic, matfile, ply
from structured_light_for_3d_model_replication_tpu_torch.models import meshing
from structured_light_for_3d_model_replication_tpu_torch.models import (
    reconstruction as recon,
)
from structured_light_for_3d_model_replication_tpu_torch.models.scanner import (
    SLScanner,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc
from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
from structured_light_for_3d_model_replication_tpu_torch.ops import normals as nrm
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    triangulate as tri,
)
from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["BatchReport", "reconstruct", "reconstruct_source",
           "sort_ply_paths_by_angle", "merge_views", "CLEAN_STEPS", "clean_cloud",
           "clean_batch", "mesh_cloud", "PipelineReport", "run_pipeline"]

CLEAN_STEPS = pc.CLEAN_STEPS

_DEG_RE = re.compile(r"(\d+(?:\.\d+)?)\s*deg", re.IGNORECASE)


@dataclass
class BatchReport:
    """What one reconstruct run wrote, and how."""

    outputs: list[str] = field(default_factory=list)
    points: list[int] = field(default_factory=list)  # per output
    failed: list[tuple[str, str]] = field(default_factory=list)  # (input, error)
    lane: str = ""          # serial | batched | packed
    launches: int = 0       # device forward calls (one per batch)
    device: str = ""
    elapsed_s: float = 0.0

    @property
    def summary(self) -> str:
        return (f"{len(self.outputs)} view(s) on {self.device} in "
                f"{self.elapsed_s:.2f}s ({self.lane} lane, {self.launches} "
                f"launch(es))")


def _scan_sources(target: str, mode: str, need: int, log=None) -> list[str]:
    """``target`` -> scan sources: ``single`` is the folder itself, ``batch``
    every sub-folder with at least ``need`` frames (the others are logged
    and skipped), ``files`` a comma-separated list."""
    if mode == "single":
        return [target]
    if mode == "batch":
        out = []
        for s in sorted(os.path.join(target, d) for d in os.listdir(target)
                        if os.path.isdir(os.path.join(target, d))):
            try:
                n = imio.count_frames(s)
            except (FileNotFoundError, NotADirectoryError, IOError):
                if log is not None:
                    log(f"[reconstruct] skipping {s}: no frame images found")
                continue
            if n >= need:
                out.append(s)
            elif log is not None:
                log(f"[reconstruct] skipping {s}: {n} frames < {need} "
                    f"required (partial capture?)")
        return out
    if mode == "files":
        return [p.strip() for p in target.split(",") if p.strip()]
    raise ValueError(f"unknown reconstruct mode {mode!r} (single|batch|files)")


def _item_name(src) -> str:
    return os.path.basename(os.path.normpath(src)) or "cloud"


def _out_path_for(src, mode: str, output: str | None) -> str:
    if mode == "single" and output:
        return output
    if output:
        return os.path.join(output, f"{_item_name(src)}.ply")
    return os.path.normpath(src) + ".ply"


def _forward_kw(cfg: Config) -> dict:
    d = cfg.decode
    return dict(thresh_mode=d.thresh_mode, shadow_val=d.shadow_val,
                contrast_val=d.contrast_val)


def _build_scanner(sources, calib: dict, cfg: Config, device=None) -> SLScanner:
    """One SLScanner for the run; the camera size comes from the first
    source (packed header or first frame)."""
    if cfg.triangulate.bitexact:
        raise ValueError("triangulate.bitexact is not ported yet")
    first = imio.list_frame_files(sources[0])
    hdr = imio.probe_packed(first[0])
    if hdr is not None:
        cam_size = (int(hdr["width"]), int(hdr["height"]))
    else:
        probe = imio.load_gray(first[0])
        cam_size = (probe.shape[1], probe.shape[0])
    return SLScanner(
        calib, cam_size, proj_size=(cfg.decode.n_cols, cfg.decode.n_rows),
        row_mode=cfg.triangulate.row_mode,
        epipolar_tol=cfg.triangulate.epipolar_tol,
        n_sets_col=cfg.decode.n_sets_col, n_sets_row=cfg.decode.n_sets_row,
        downsample=cfg.projector.downsample,
        plane_eval=cfg.triangulate.plane_eval, device=device)


def reconstruct_source(source, calib: dict, cfg: Config, scanner=None,
                       device=None) -> tuple[np.ndarray, np.ndarray]:
    """One scan source -> compact (points [M, 3] f32, colors [M, 3] u8)."""
    scanner = scanner or _build_scanner([source], calib, cfg, device)
    frames, _ = imio.load_stack(source, io_workers=cfg.parallel.io_workers)
    return tri.compact_cloud(scanner.forward(frames, **_forward_kw(cfg)))


def _write_view(src, pts, cols, mode, output, report, log) -> None:
    out_path = _out_path_for(src, mode, output)
    ply.write_ply(out_path, pts, cols)
    log(f"[reconstruct] {_item_name(src)}: {len(pts):,} points -> {out_path}")
    report.outputs.append(out_path)
    report.points.append(len(pts))


def _reconstruct_serial(sources, cfg, scanner, report, emit):
    """One view a launch; ``emit(src, points, colors)`` takes each compact
    cloud (a PLY write, or the pipeline's clean + collect)."""
    for src in sources:
        pts, cols = reconstruct_source(src, None, cfg, scanner)
        report.launches += 1
        emit(src, pts, cols)


def _load_packed(src, cfg: Config) -> imio.PackedStack:
    """A packed source loads its container; a raw source packs at load."""
    if imio.packed_file(src) is not None:
        return imio.load_packed_stack(src)
    frames, texture = imio.load_stack(src, io_workers=cfg.parallel.io_workers)
    return imio.pack_stack(frames, texture=texture)


def _reconstruct_batched(sources, cfg, scanner, report, emit, packed: bool):
    """``compute_batch`` views per device launch, each compact cloud to
    ``emit(src, points, colors)``. Stacks of one batch must share a shape; a
    change of shape closes the batch early."""
    batch_n = max(1, cfg.parallel.compute_batch)
    kw = _forward_kw(cfg)

    def load(src):
        if packed:
            return _load_packed(src, cfg)
        return imio.load_stack(src, io_workers=cfg.parallel.io_workers)[0]

    def run(batch):
        if packed:
            stacks = [s for _, s in batch]
            cloud = scanner.forward_views_packed(
                np.stack([s.planes for s in stacks]),
                np.stack([s.white for s in stacks]),
                np.stack([s.black for s in stacks]),
                n_frames=stacks[0].n_frames, **kw)
        else:
            cloud = scanner.forward_views(np.stack([f for _, f in batch]), **kw)
        report.launches += 1
        for j, (src, _) in enumerate(batch):
            pts, cols = tri.compact_cloud(tri.CloudResult(
                cloud.points[j], cloud.colors[j], cloud.valid[j]))
            emit(src, pts, cols)

    with ThreadPoolExecutor(max_workers=max(1, cfg.parallel.io_workers)) as pool:
        for i in range(0, len(sources), batch_n):
            chunk = sources[i:i + batch_n]
            batch: list = []
            for src, stack in zip(chunk, pool.map(load, chunk)):
                if batch and stack.shape != batch[0][1].shape:
                    run(batch)
                    batch = []
                batch.append((src, stack))
            run(batch)


def _lane(cfg: Config, n_sources: int) -> str:
    """batched (packed with ``pipeline.packed_ingest``) for several sources
    at ``compute_batch`` > 1, else serial."""
    if cfg.parallel.compute_batch > 1 and n_sources > 1:
        return "packed" if cfg.pipeline.packed_ingest else "batched"
    return "serial"


def _reconstruct_lane(sources, cfg, scanner, report, emit) -> None:
    """Run the lane ``reconstruct`` and ``run_pipeline`` share."""
    lane = _lane(cfg, len(sources))
    if lane == "serial":
        _reconstruct_serial(sources, cfg, scanner, report, emit)
    else:
        _reconstruct_batched(sources, cfg, scanner, report, emit, packed=lane == "packed")


def reconstruct(calib_path: str, target: str, mode: str = "single",
                output: str | None = None, cfg: Config | None = None,
                device=None, log=print) -> BatchReport:
    """Scan folder(s) -> per-view colored PLY, on ``device`` (None -> cuda).

    ``output``: for single mode a .ply path (default ``<target>.ply``); for
    batch/files mode a directory (default: beside each source).
    """
    cfg = cfg or Config()
    dev = resolve_device(device)
    calib = matfile.load_calibration(calib_path)
    need = gc.frames_per_view(cfg.decode.n_cols, cfg.decode.n_rows,
                              cfg.projector.downsample)
    sources = _scan_sources(target, mode, need, log=log)
    if not sources:
        raise ValueError(f"no scan sources found under {target!r} (mode={mode})")
    scanner = _build_scanner(sources, calib, cfg, dev)
    if output and mode != "single":
        os.makedirs(output, exist_ok=True)
    report = BatchReport(device=str(dev), lane=_lane(cfg, len(sources)))
    t0 = time.perf_counter()

    def emit(src, pts, cols):
        _write_view(src, pts, cols, mode, output, report, log)

    _reconstruct_lane(sources, cfg, scanner, report, emit)
    report.elapsed_s = time.perf_counter() - t0
    log(f"[reconstruct] {report.summary}")
    return report


def sort_ply_paths_by_angle(paths: list[str]) -> list[str]:
    """Order merge inputs by the ``"<n>deg"`` tag in the filename, untagged
    files after them in lexical order."""

    def key(p):
        m = _DEG_RE.search(os.path.basename(p))
        return (0, float(m.group(1)), p) if m else (1, 0.0, p)

    return sorted(paths, key=key)


def merge_views(input_folder: str, output_ply: str, cfg: Config | None = None,
                log=print, device=None, timings: dict | None = None):
    """Folder of per-view PLYs -> one registered 360-degree cloud PLY, on
    ``device`` (None -> cuda). A view that cannot be read is dropped with a
    warning as long as max(2, pipeline.min_views) readable views remain.
    Returns (points, colors, transforms)."""
    cfg = cfg or Config()
    dev = resolve_device(device)
    out_abs = os.path.abspath(output_ply)
    paths = sort_ply_paths_by_angle([
        p for f in os.listdir(input_folder)
        if f.lower().endswith(".ply")
        and os.path.abspath(p := os.path.join(input_folder, f)) != out_abs])
    if len(paths) < 2:
        raise ValueError(f"need >= 2 PLY views in {input_folder}, found {len(paths)}")
    log(f"[merge] {len(paths)} views: " + ", ".join(os.path.basename(p) for p in paths))

    def read_one(p):
        try:
            return ply.read_ply(p), None
        except Exception as e:  # a torn or corrupt view is dropped below
            return None, e

    with ThreadPoolExecutor(max_workers=max(1, min(cfg.parallel.io_workers,
                                                   len(paths)))) as pool:
        datas = list(pool.map(read_one, paths))
    dropped = [(p, e) for p, (d, e) in zip(paths, datas) if d is None]
    for p, e in dropped:
        log(f"[merge] WARNING: dropping unreadable view {os.path.basename(p)}: {e}")
    floor = max(2, cfg.pipeline.min_views)
    if len(paths) - len(dropped) < floor:
        raise ValueError(
            f"merge: only {len(paths) - len(dropped)}/{len(paths)} views readable, "
            f"below the pipeline.min_views={floor} floor (unreadable: "
            f"{[os.path.basename(p) for p, _ in dropped]})")
    clouds = []
    for d, _ in datas:
        if d is None:
            continue
        c = d.get("colors")
        if c is None:
            c = np.zeros_like(d["points"], dtype=np.uint8)
        clouds.append((np.asarray(d["points"], np.float32), np.asarray(c, np.uint8)))
    points, colors, transforms = recon.merge_360(clouds, cfg.merge, log=log,
                                                 timings=timings, device=dev)
    ply.write_ply(output_ply, points, colors)
    log(f"[merge] wrote {output_ply} ({len(points):,} points)")
    return points, colors, transforms


# ---------------------------------------------------------------------------
# clean
# ---------------------------------------------------------------------------

def _clean_arrays(pts: np.ndarray, cols: np.ndarray, cfg: Config,
                  steps=CLEAN_STEPS, log=None, device=None,
                  timings: dict | None = None):
    """The masked clean chain on one in-memory cloud, on ``device`` (None ->
    cuda): the cloud padded to its 2048-multiple bucket with rows at 1e9
    (valid = the first n rows), ``ops/pointcloud.clean_chain``, survivors
    taken once at the end. Returns (points', colors', counts {"input": n,
    step: survivors}). A step that leaves no point aborts the chain there
    (later steps are not counted). ``timings`` gets ``clean_<step>_s``."""
    log = log or (lambda m: None)
    n = len(pts)
    counts = {"input": n}
    params = pc.chain_params(cfg.clean, tuple(steps))
    if not params:
        return pts, cols, counts
    dev = resolve_device(device)
    bucket = recon._bucket_pad(n)
    pts_pad = np.full((bucket, 3), knnlib.FAR, np.float32)
    pts_pad[:n] = pts
    valid = torch.arange(bucket, device=dev) < n
    masks, cnts = pc.clean_chain(torch.from_numpy(pts_pad).to(dev), valid, cfg.clean,
                                 tuple(steps), timings=timings)
    masks = masks[:, :n].cpu().numpy()
    cnts = cnts.cpu().numpy()
    final = masks[-1]
    for i, (step, _) in enumerate(params):
        counts[step] = int(cnts[i])
        log(f"[clean] {step}: {int(cnts[i]):,} points remain")
        if int(cnts[i]) == 0:
            log("[clean] WARNING: all points removed; aborting chain")
            final = masks[i]
            break
    return pts[final], cols[final], counts


def _read_cloud(path: str):
    data = ply.read_ply(path)
    pts = np.asarray(data["points"], np.float32)
    cols = data.get("colors")
    return pts, (np.asarray(cols, np.uint8) if cols is not None
                 else np.zeros_like(pts, dtype=np.uint8))


def clean_cloud(input_ply: str, output_ply: str, cfg: Config | None = None,
                steps=CLEAN_STEPS, log=print, device=None) -> dict:
    """The clean chain on one cloud PLY (background plane -> largest
    cluster -> radius outlier -> statistical outlier, each selectable), on
    ``device`` (None -> cuda). Returns the per-step counts."""
    cfg = cfg or Config()
    pts, cols = _read_cloud(input_ply)
    pts, cols, counts = _clean_arrays(pts, cols, cfg, tuple(steps), log=log, device=device)
    ply.write_ply(output_ply, pts, cols)
    log(f"[clean] wrote {output_ply} ({len(pts):,} points)")
    return counts


def clean_batch(input_folder: str, output_folder: str, cfg: Config | None = None,
                steps=CLEAN_STEPS, log=print, device=None) -> BatchReport:
    """Clean every PLY of a folder into ``output_folder`` (reads on the I/O
    pool); a cloud that fails is logged and listed in ``report.failed``,
    the others go on."""
    cfg = cfg or Config()
    dev = resolve_device(device)
    paths = sorted(os.path.join(input_folder, f) for f in os.listdir(input_folder)
                   if f.lower().endswith(".ply"))
    if not paths:
        raise ValueError(f"no .ply files in {input_folder!r}")
    os.makedirs(output_folder, exist_ok=True)
    report = BatchReport(lane="clean", device=str(dev))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, min(cfg.parallel.io_workers,
                                                   len(paths)))) as pool:
        for src, fut in [(p, pool.submit(_read_cloud, p)) for p in paths]:
            name = os.path.basename(src)
            try:
                pts, cols = fut.result()
                pts, cols, _ = _clean_arrays(pts, cols, cfg, tuple(steps), device=dev)
                out_path = os.path.join(output_folder, name)
                ply.write_ply(out_path, pts, cols)
            except Exception as e:  # per-item tolerance: the batch goes on
                log(f"[clean] {name} FAILED: {e}")
                report.failed.append((src, str(e)))
                continue
            log(f"[clean] {name}: {len(pts):,} points -> {out_path}")
            report.outputs.append(out_path)
            report.points.append(len(pts))
    report.elapsed_s = time.perf_counter() - t0
    log(f"[clean] {len(report.outputs)} cloud(s) cleaned, {len(report.failed)} "
        f"failed, on {dev} in {report.elapsed_s:.2f}s")
    return report


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

def _mesh_arrays(pts: np.ndarray, cfg: Config, log=print, normals=None, device=None,
                 timings: dict | None = None):
    """Cloud arrays -> (verts, faces, normals) on ``device``: normals
    estimated (k = mesh.normal_max_nn) and oriented (mesh.orientation)
    when not given, then ``meshing.reconstruct_mesh``. ``timings`` gets
    ``normals_s`` and the meshing stages."""
    tm = timings if timings is not None else {}
    dev = resolve_device(device)
    if normals is None:
        t0 = time.perf_counter()
        p = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev)
        v = torch.ones(len(pts), dtype=torch.bool, device=dev)
        nr = nrm.estimate_normals(p, v, k=cfg.mesh.normal_max_nn,
                                  radius=cfg.mesh.normal_radius or None)
        normals = nrm.orient_normals(p, nr, v, mode=cfg.mesh.orientation).cpu().numpy()
        tm["normals_s"] = time.perf_counter() - t0
        log(f"[mesh] estimated normals (k={cfg.mesh.normal_max_nn}, "
            f"{cfg.mesh.orientation} orientation)")
    verts, faces = meshing.reconstruct_mesh(pts, None, normals, cfg=cfg.mesh, log=log,
                                            device=dev, timings=tm)
    return np.asarray(verts), np.asarray(faces), normals


def _write_mesh(output_path: str, verts, faces, log=print) -> None:
    if output_path.lower().endswith(".stl"):
        meshing.mesh_to_stl(output_path, verts, faces)
    else:
        ply.write_mesh_ply(output_path, verts, faces)
    log(f"[mesh] wrote {output_path} ({len(verts):,} verts, {len(faces):,} faces)")


def mesh_cloud(input_ply: str, output_path: str, cfg: Config | None = None,
               save_normals_path: str | None = None, log=print, device=None,
               timings: dict | None = None):
    """Cloud PLY -> mesh (.stl, or a mesh .ply by extension) on ``device``
    (None -> cuda); the PLY's own normals are used when it has them.
    ``save_normals_path`` also writes the cloud with the normals used.
    ``timings`` gets the meshing stages' walls and ``write_s``."""
    cfg = cfg or Config()
    tm = timings if timings is not None else {}
    data = ply.read_ply(input_ply)
    pts = np.asarray(data["points"], np.float32)
    verts, faces, normals = _mesh_arrays(pts, cfg, log=log, normals=data.get("normals"),
                                         device=device, timings=tm)
    if save_normals_path:
        ply.write_ply(save_normals_path, pts, data.get("colors"), normals)
        log(f"[mesh] normals debug cloud -> {save_normals_path}")
    t0 = time.perf_counter()
    _write_mesh(output_path, verts, faces, log=log)
    tm["write_s"] = time.perf_counter() - t0
    return verts, faces


# ---------------------------------------------------------------------------
# the scan-to-print pipeline
# ---------------------------------------------------------------------------

@dataclass
class PipelineReport:
    """What one scan-to-print run did."""

    merged_ply: str | None = None
    stl_path: str | None = None
    views_computed: int = 0
    merged_points: int = 0
    mesh_verts: int = 0
    mesh_faces: int = 0
    device: str = ""
    clean_counts: list[dict] = field(default_factory=list)  # per view, angle order
    transforms: list = field(default_factory=list)  # view i -> view 0, angle order
    walls_s: dict = field(default_factory=dict)   # per stage, host wall
    elapsed_s: float = 0.0

    @property
    def summary(self) -> str:
        return (f"{self.views_computed} views, {self.merged_points:,} merged points, "
                f"{self.mesh_faces:,} faces on {self.device} in {self.elapsed_s:.1f}s")


def _write_json_atomic(path: str, payload: dict) -> None:
    with atomic.atomic_write(path) as tmp, open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


def run_pipeline(calib_path: str, target: str, out_dir: str, cfg: Config | None = None,
                 steps=CLEAN_STEPS, merged_name: str = "merged.ply",
                 stl_name: str = "model.stl", log=print, device=None) -> PipelineReport:
    """Scan-to-print on ``device`` (None -> cuda): every view folder under
    ``target`` (with enough frames, in ``<n>deg`` angle order) ->
    ``reconstruct``'s lane -> ``_clean_arrays`` -> ``merge_360`` over the
    cleaned clouds -> ``_mesh_arrays`` -> ``<out_dir>/merged.ply`` and
    ``<out_dir>/model.stl``. An exception aborts the run and leaves
    ``<out_dir>/failures.json``; fewer than max(2, pipeline.min_views) views
    is such an abort."""
    cfg = cfg or Config()
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    manifest = os.path.join(out_dir, "failures.json")
    if os.path.exists(manifest):  # a previous run's, not this one's
        os.remove(manifest)
    report = PipelineReport(device=str(dev))
    if cfg.merge.stream:
        log("[pipeline] merge.stream: the streaming register lane is not ported; "
            "the barrier merge runs (the JAX package's two arms give the same bytes)")
    if cfg.pipeline.cache:
        log("[pipeline] pipeline.cache: the stage cache is not ported; every stage "
            "is computed")
    try:
        return _run_pipeline_impl(calib_path, target, out_dir, cfg, tuple(steps),
                                  merged_name, stl_name, log, dev, report)
    except Exception as e:
        _write_json_atomic(manifest, {
            "aborted": True, "degraded": False, "reason": f"{type(e).__name__}: {e}",
            "clean_counts": report.clean_counts,
            "failures": [{"stage": "pipeline", "error_type": type(e).__name__,
                          "error": str(e)}]})
        log(f"[pipeline] ABORTED ({type(e).__name__}: {e}); manifest -> {manifest}")
        raise


def _run_pipeline_impl(calib_path, target, out_dir, cfg: Config, steps, merged_name,
                       stl_name, log, dev, report: PipelineReport) -> PipelineReport:
    t_start = time.perf_counter()
    walls = report.walls_s
    calib = matfile.load_calibration(calib_path)
    need = gc.frames_per_view(cfg.decode.n_cols, cfg.decode.n_rows, cfg.projector.downsample)
    sources = sort_ply_paths_by_angle(_scan_sources(target, "batch", need, log=log))
    floor = max(2, cfg.pipeline.min_views)
    if len(sources) < floor:
        raise ValueError(f"pipeline: {len(sources)} scan view(s) under {target!r}, below "
                         f"the pipeline.min_views={floor} floor")
    scanner = _build_scanner(sources, calib, cfg, dev)
    index = {src: i for i, src in enumerate(sources)}
    collected: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    counts: dict[int, dict] = {}
    clean_tm: dict[str, float] = {}
    clean_s = 0.0
    view_dir = os.path.join(out_dir, "views") if cfg.pipeline.write_view_plys else None
    if view_dir:
        os.makedirs(view_dir, exist_ok=True)

    def emit(src, pts, cols):
        nonlocal clean_s
        t0 = time.perf_counter()
        pts, cols, c = _clean_arrays(pts, cols, cfg, steps, device=dev, timings=clean_tm)
        clean_s += time.perf_counter() - t0
        if view_dir:
            ply.write_ply(_out_path_for(src, "batch", view_dir), pts, cols)
        i = index[src]
        collected[i], counts[i] = (pts, cols), c
        log(f"[pipeline] {_item_name(src)}: {c['input']:,} -> {len(pts):,} points "
            f"after {', '.join(s for s in c if s != 'input') or 'no clean'}")

    batch = BatchReport(device=str(dev))
    t0 = time.perf_counter()
    _reconstruct_lane(sources, cfg, scanner, batch, emit)
    walls["reconstruct_s"] = time.perf_counter() - t0 - clean_s
    walls.update(clean_tm)
    order = sorted(collected)
    report.views_computed = len(order)
    report.clean_counts = [counts[i] for i in order]

    tm: dict = {}
    t0 = time.perf_counter()
    points, colors, report.transforms = recon.merge_360(
        [collected[i] for i in order], cfg.merge, log=log, timings=tm, device=dev)
    walls.update({f"merge_{k}": v for k, v in tm.items()})
    walls["merge_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    merged_path = os.path.join(out_dir, merged_name)
    ply.write_ply(merged_path, points, colors)
    walls["write_merged_s"] = time.perf_counter() - t0
    log(f"[pipeline] merged cloud -> {merged_path} ({len(points):,} points)")
    report.merged_ply, report.merged_points = merged_path, len(points)

    mesh_tm: dict = {}
    t0 = time.perf_counter()
    verts, faces, _ = _mesh_arrays(points, cfg, log=log, device=dev, timings=mesh_tm)
    walls.update({f"mesh_{k}": v for k, v in mesh_tm.items()})
    walls["mesh_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stl_path = os.path.join(out_dir, stl_name)
    meshing.mesh_to_stl(stl_path, verts, faces)
    walls["write_stl_s"] = time.perf_counter() - t0
    log(f"[pipeline] model -> {stl_path} ({len(verts):,} verts, {len(faces):,} faces)")
    report.stl_path, report.mesh_verts, report.mesh_faces = stl_path, len(verts), len(faces)
    report.elapsed_s = time.perf_counter() - t_start
    log(f"[pipeline] {report.summary}")
    return report
