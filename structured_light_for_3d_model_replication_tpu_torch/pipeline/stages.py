"""File-level stages: scan folders -> per-view colored PLY -> merged cloud.

``merge_views`` is the port's entry point of the merge path (the JAX
package's ``sl3d merge-360``): a folder of per-view PLYs, ordered by their
``<n>deg`` tag, registered and merged into one cloud (``merge_360``).

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

import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from structured_light_for_3d_model_replication_tpu_torch.config import Config
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import matfile, ply
from structured_light_for_3d_model_replication_tpu_torch.models.scanner import (
    SLScanner,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    triangulate as tri,
)
from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["BatchReport", "reconstruct", "reconstruct_source",
           "sort_ply_paths_by_angle", "merge_views"]

_DEG_RE = re.compile(r"(\d+(?:\.\d+)?)\s*deg", re.IGNORECASE)


@dataclass
class BatchReport:
    """What one reconstruct run wrote, and how."""

    outputs: list[str] = field(default_factory=list)
    points: list[int] = field(default_factory=list)  # per output
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


def _reconstruct_serial(sources, cfg, scanner, mode, output, report, log):
    for src in sources:
        pts, cols = reconstruct_source(src, None, cfg, scanner)
        report.launches += 1
        _write_view(src, pts, cols, mode, output, report, log)


def _load_packed(src, cfg: Config) -> imio.PackedStack:
    """A packed source loads its container; a raw source packs at load."""
    if imio.packed_file(src) is not None:
        return imio.load_packed_stack(src)
    frames, texture = imio.load_stack(src, io_workers=cfg.parallel.io_workers)
    return imio.pack_stack(frames, texture=texture)


def _reconstruct_batched(sources, cfg, scanner, mode, output, report, log,
                         packed: bool):
    """``compute_batch`` views per device launch. Stacks of one batch must
    share a shape; a change of shape closes the batch early."""
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
            _write_view(src, pts, cols, mode, output, report, log)

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
    batched = cfg.parallel.compute_batch > 1 and len(sources) > 1
    report = BatchReport(device=str(dev), lane=(
        ("packed" if cfg.pipeline.packed_ingest else "batched") if batched
        else "serial"))
    t0 = time.perf_counter()
    if batched:
        _reconstruct_batched(sources, cfg, scanner, mode, output, report, log,
                             packed=cfg.pipeline.packed_ingest)
    else:
        _reconstruct_serial(sources, cfg, scanner, mode, output, report, log)
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
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )

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
