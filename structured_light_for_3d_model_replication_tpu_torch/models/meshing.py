"""Point cloud -> printable mesh (the JAX package's ``models/meshing.py``):
normals, then either the watertight mode — screened Poisson
(``ops/poisson.py`` dense up to depth 9, ``ops/poisson_bricks.py`` above),
Surface Nets extraction and the low-density trim — or the surface mode,
the ball-pivoting analog of ``ops/surface_recon.py``; then the optional
host post-ops of ``ops/meshproc.py``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.config import MeshConfig
from structured_light_for_3d_model_replication_tpu_torch.ops import meshproc
from structured_light_for_3d_model_replication_tpu_torch.ops import normals as nrmlib
from structured_light_for_3d_model_replication_tpu_torch.ops import poisson
from structured_light_for_3d_model_replication_tpu_torch.ops import poisson_bricks
from structured_light_for_3d_model_replication_tpu_torch.ops import surface_nets
from structured_light_for_3d_model_replication_tpu_torch.ops import surface_recon
from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["reconstruct_mesh", "mesh_to_stl"]


def reconstruct_mesh(points, valid=None, normals=None, cfg: MeshConfig | None = None,
                     log=print, device=None, timings: dict | None = None):
    """Cloud -> mesh on ``device`` (None -> cuda). Returns host (vertices
    [V, 3] f32, faces [F, 3] i32). Normals, when estimated here, are
    oriented outward (radial), so chi < iso inside and faces wind outward.
    ``mode='surface'`` triangulates the points themselves
    (``surface_recon.ball_pivot_surface`` with ``surface_k`` and
    ``surface_alpha_factor``). ``timings`` gets the stage walls
    (poisson_base_s, bricks_s, extract_s, trim_s, or surface_s; host wall,
    synchronized by the host transfers that end each stage)."""
    cfg = cfg or MeshConfig()
    tm = timings if timings is not None else {}
    if cfg.mode not in ("watertight", "surface"):
        raise ValueError(f"mesh.mode must be 'watertight' or 'surface', got {cfg.mode!r}")
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    v = (torch.ones(pts.shape[0], dtype=torch.bool, device=dev) if valid is None
         else torch.as_tensor(np.asarray(valid, bool), device=dev))
    if normals is None:
        nr = nrmlib.estimate_normals(pts, v, k=cfg.normal_max_nn,
                                     radius=cfg.normal_radius or None)
        nr = nrmlib.orient_normals(pts, nr, v, mode="radial")
        log(f"[mesh] normals estimated (hybrid r={cfg.normal_radius}, "
            f"max_nn={cfg.normal_max_nn}, radial orient)")
    else:
        nr = torch.as_tensor(np.asarray(normals, np.float32), device=dev)

    if cfg.mode == "surface":
        # interpolates the points, keeps sharp detail, leaves holes where the
        # sampling is sparse
        t0 = time.perf_counter()
        verts, faces = surface_recon.ball_pivot_surface(
            pts, v, nr, k=cfg.surface_k, alpha_factor=cfg.surface_alpha_factor)
        tm["surface_s"] = time.perf_counter() - t0
        log(f"[mesh] ball-pivot surface: {len(verts):,} verts, {len(faces):,} faces")
    else:
        verts, faces = _watertight(pts, nr, v, cfg, log, dev, tm)
    return _post_ops(verts, faces, cfg, log)


def _watertight(pts, nr, v, cfg: MeshConfig, log, dev, tm: dict):
    """Poisson, extraction and the density trim -> host (verts, faces)."""
    res = _poisson_dispatch(pts, nr, v, cfg.depth, log, density_cap=cfg.density_cap,
                            timings=tm)
    t0 = time.perf_counter()
    if isinstance(res, poisson_bricks.BrickPoissonResult):
        verts, faces = poisson_bricks.extract_surface_bricks(res)
        # the trim's density comes from the coarse base solve (the bricks
        # never build a fine one)
        dens_res = res.coarse
    else:
        verts, faces = surface_nets.extract_surface(
            res.chi, float(res.iso), origin=res.origin.cpu().numpy(), cell=float(res.cell))
        dens_res = res
    tm["extract_s"] = time.perf_counter() - t0
    log(f"[mesh] surface nets: {len(verts):,} verts, {len(faces):,} faces")

    if cfg.density_trim_quantile and cfg.density_trim_quantile > 0:
        # low-support crop: sample the splat density at the vertices and drop
        # the lowest quantile
        t0 = time.perf_counter()
        coords = ((torch.as_tensor(verts, device=dev) - dens_res.origin) / dens_res.cell)
        dens = poisson.trilinear_sample(dens_res.density, coords).cpu().numpy()
        thresh = np.quantile(dens, cfg.density_trim_quantile)
        verts, faces = meshproc.filter_faces_by_vertex_mask(verts, faces, dens >= thresh)
        tm["trim_s"] = time.perf_counter() - t0
        log(f"[mesh] density trim q={cfg.density_trim_quantile}: "
            f"{len(verts):,} verts remain")
    return verts, faces


def _post_ops(verts, faces, cfg: MeshConfig, log):
    """The optional host post-ops: hole filling, smoothing, decimation."""
    if cfg.close_holes_max_edges > 0:
        verts, faces, n = meshproc.fill_holes(verts, faces, cfg.close_holes_max_edges)
        log(f"[mesh] closed {n} holes (<= {cfg.close_holes_max_edges} edges)")
    if cfg.smooth_iters > 0:
        if cfg.smooth_method == "taubin":
            verts = meshproc.taubin_smooth(verts, faces, cfg.smooth_iters)
        else:
            verts = meshproc.laplacian_smooth(verts, faces, cfg.smooth_iters)
        log(f"[mesh] {cfg.smooth_method} smoothing x{cfg.smooth_iters}")
    if cfg.simplify_target_faces and len(faces) > cfg.simplify_target_faces:
        if cfg.simplify_method == "quadric":
            verts, faces = meshproc.quadric_decimate(verts, faces, cfg.simplify_target_faces)
        else:
            # a clustering cell from the face budget
            bbox = verts.max(0) - verts.min(0)
            area = 2 * (bbox[0] * bbox[1] + bbox[1] * bbox[2] + bbox[0] * bbox[2])
            cell = float(np.sqrt(area / max(cfg.simplify_target_faces, 1)))
            for _ in range(8):
                nv, nf = meshproc.vertex_cluster_decimate(verts, faces, cell)
                if len(nf) <= cfg.simplify_target_faces or len(nf) == 0:
                    break
                cell *= 1.3
            verts, faces = nv, nf
        log(f"[mesh] decimated ({cfg.simplify_method}) to {len(faces):,} faces")
    return verts, faces


def _poisson_dispatch(pts: torch.Tensor, nr: torch.Tensor, v: torch.Tensor, depth: int,
                      log, density_cap: bool = True, timings: dict | None = None):
    """Dense Poisson up to depth 9; above, the brick-refined solver on a
    depth-9-at-most dense base. Depth 10 on the CPU steps down to dense 9
    unless ``density_cap`` is false. The density cap first lowers the depth
    to ~log2(sqrt(N)) + 1. (The JAX package's slab-sharded depth-10 solve
    over several devices is not ported: one card takes the bricks.)"""
    tm = timings if timings is not None else {}
    n = int(v.sum())
    cap = max(4, int(np.ceil(np.log2(max(n, 2)) / 2)) + 1)
    if cap < depth:
        if density_cap:
            log(f"[mesh] poisson depth {depth} -> {cap}: {n} points cannot fill a "
                f"{1 << depth}^3 grid (cap ~ log2(sqrt(N))+1; set "
                f"mesh.density_cap=false to force depth {depth})")
            depth = cap
        else:
            log(f"[mesh] density cap disabled: honoring depth {depth} for {n} points "
                f"(cap would have chosen {cap})")
    if depth == 10 and pts.device.type != "cuda" and density_cap:
        log("[mesh] WARNING: depth 10 on the CPU steps down to depth 9 dense (set "
            "mesh.density_cap=false to force the brick-refined depth-10 solve)")
        depth = 9
    t0 = time.perf_counter()
    if depth <= 9:
        res = poisson.poisson_solve(pts, nr, v, depth=depth)
        log(f"[mesh] poisson depth={depth} iso={float(res.iso):.4f}")
        tm["poisson_base_s"] = time.perf_counter() - t0
        return res
    res = poisson_bricks.poisson_solve_bricks(
        pts, nr, v, depth=depth, base_depth=min(9, cap, depth - 1), log=log,
        timings=tm)
    tm["bricks_s"] = time.perf_counter() - t0 - tm.get("poisson_base_s", 0.0)
    log(f"[mesh] poisson depth={depth} brick-refined ({res.n_bricks} bricks) "
        f"iso={res.iso:.4f}")
    return res


def mesh_to_stl(path: str, vertices, faces) -> None:
    from structured_light_for_3d_model_replication_tpu_torch.io import stl

    stl.write_stl(path, vertices, faces)
