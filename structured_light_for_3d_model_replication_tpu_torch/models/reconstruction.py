"""360-degree multi-view merge (the JAX package's ``models/reconstruction.py``,
host-list path).

Clouds sorted by turntable angle chain-align view i onto view i-1: per
view, voxel downsample + normals + FPFH (``prep_view``); per pair, RANSAC
global init and point-to-plane ICP (``register_prep_pairs``); then the
chained transforms move every view into view 0's frame, and the merged
cloud goes through the final voxel and the statistical outlier pass
(``finalize_chain``).

Shapes follow the JAX package so the two index spaces agree: a view's raw
points pad to a multiple of 8192, its voxel survivors to a multiple of 2048
(its bucket), and a pair runs at the larger of its two buckets. RANSAC
draws are indices into that space, so the reference's draws can be fed to
the port unchanged (``samples``), and a pair's draws depend only on
(seed, pair id).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.config import MergeConfig
from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
from structured_light_for_3d_model_replication_tpu_torch.ops import normals as nrmlib
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.ops import registration as reg
from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["merge_360", "prep_view", "prep_view_device", "prep_from_reference",
           "register_prep_pairs",
           "finalize_chain", "transform_views_batched", "chamfer_distance",
           "FEAT_K", "NORMALS_K", "FEAT_RADIUS_SCALE"]

# feature prep: one kNN of FEAT_K feeds both the normals (nearest NORMALS_K)
# and FPFH (radius FEAT_RADIUS_SCALE * voxel), as in the JAX package
FEAT_K = 32
NORMALS_K = 30
FEAT_RADIUS_SCALE = 5.0


@dataclass
class _Prep:
    points: torch.Tensor    # [B, 3] f32, B a multiple of 2048
    valid: torch.Tensor     # [B] bool, a prefix
    normals: torch.Tensor   # [B, 3] f32
    features: torch.Tensor  # [B, 33] f32


def prep_from_reference(prep, device=None) -> _Prep:
    """A JAX-package ``_Prep`` (or anything with the same four array
    fields) -> the port's, on ``device`` (None -> cuda)."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return _Prep(t(prep.points, torch.float32), t(prep.valid, torch.bool),
                 t(prep.normals, torch.float32), t(prep.features, torch.float32))


def _bucket_pad(max_count: int, slots: int | None = None, multiple: int = 2048) -> int:
    """A survivor count rounded up to the bucket, clamped to the slots."""
    b = -(-max(max_count, 1) // multiple) * multiple
    return b if slots is None else min(b, slots)


def _compact_order_counts(valid: torch.Tensor):
    """Per row of ``valid`` [V, S] bool: the slot order that puts the valid
    slots first, each group in slot order (the order host boolean masking
    gives), and the valid counts [V]."""
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    return order, valid.sum(dim=1)


def _prep_features(p: torch.Tensor, v: torch.Tensor, feat_radius: float):
    idx, d2 = knnlib.knn(p, v, FEAT_K)
    nr = nrmlib.estimate_normals(p, v, k=NORMALS_K, idx_d2=(idx, d2))
    feat = reg.fpfh_features(p, nr, v, radius=feat_radius, k=FEAT_K, idx_d2=(idx, d2))
    return nr, feat


def prep_view(points, voxel: float, sample_before: int = 0, device=None) -> _Prep:
    """Per-view registration prep at shapes derived from this view alone:
    raw points padded to a multiple of 8192 (pad rows at 1e9, invalid),
    voxel downsample, survivors sliced to their 2048-multiple bucket, then
    normals and FPFH."""
    dev = resolve_device(device)
    reg.exact_f32_products()
    p = np.asarray(points, np.float32)
    if sample_before and sample_before > 1:
        p = p[::sample_before]
    n = len(p)
    n_raw = -(-max(n, 1) // 8192) * 8192
    pts = np.full((n_raw, 3), 1e9, np.float32)
    pts[:n] = p
    pts_t = torch.from_numpy(pts).to(dev)
    valid = torch.arange(n_raw, device=dev) < n
    p_all, _, v_all = pc.voxel_downsample(
        pts_t, torch.zeros((n_raw, 3), dtype=torch.uint8, device=dev), valid, voxel)
    cnt = int(v_all.sum())
    bucket = _bucket_pad(cnt, n_raw)
    p_c = p_all[:bucket].contiguous()
    v_c = torch.arange(bucket, device=dev) < cnt
    nr, feat = _prep_features(p_c, v_c, float(np.float32(FEAT_RADIUS_SCALE * voxel)))
    return _Prep(p_c, v_c, nr, feat)


def prep_view_device(points: torch.Tensor, count: int, voxel: float) -> _Prep:
    """``prep_view`` of a cloud already on the card: the first ``count``
    rows of ``points`` [B, 3] (the fused clean's output, prefix order) are
    the view's points. The tail is set to 1e9 and the array re-padded to
    the multiple of 8192 the host prep pads to, so every shape and every
    bit matches ``prep_view(host points)``. Work runs on the caller's
    current stream."""
    reg.exact_f32_products()
    dev = points.device
    n = int(count)
    n_raw = -(-max(n, 1) // 8192) * 8192
    p = points[:n_raw].to(torch.float32)
    rows = torch.arange(p.shape[0], device=dev)
    p = torch.where((rows < n)[:, None], p, torch.full_like(p, 1e9))
    if n_raw > p.shape[0]:
        p = torch.cat([p, torch.full((n_raw - p.shape[0], 3), 1e9, dtype=torch.float32,
                                     device=dev)])
    p = p.contiguous()
    valid = torch.arange(n_raw, device=dev) < n
    p_all, _, v_all = pc.voxel_downsample(
        p, torch.zeros((n_raw, 3), dtype=torch.uint8, device=dev), valid, voxel)
    cnt = int(v_all.sum())
    bucket = _bucket_pad(cnt, n_raw)
    p_c = p_all[:bucket].contiguous()
    v_c = torch.arange(bucket, device=dev) < cnt
    nr, feat = _prep_features(p_c, v_c, float(np.float32(FEAT_RADIUS_SCALE * voxel)))
    return _Prep(p_c, v_c, nr, feat)


def _pair_group_bucket(count: int, batch: int) -> int:
    """Launch-group size: ``batch`` for full groups, a ragged tail on the
    next power of two."""
    if count >= batch:
        return batch
    b = 1
    while b < count:
        b *= 2
    return min(b, batch)


def _prep_to_bucket(prep: _Prep, bucket: int):
    """Zero-pad one view's prep to a pair bucket (pad rows invalid)."""
    pad = bucket - prep.points.shape[0]
    if pad == 0:
        return prep.points, prep.valid, prep.normals, prep.features

    def z(a):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

    return z(prep.points), z(prep.valid), z(prep.normals), z(prep.features)


def register_prep_pairs(pairs, pair_ids, cfg: MergeConfig, voxel: float,
                        samples=None):
    """Register (prep_src, prep_dst) pairs: grouped by pair bucket (the
    larger of the two views' buckets), ``cfg.pair_batch`` pairs a launch
    group (a ragged tail padded on the power-of-two ladder with copies of
    its last pair). ``pair_ids`` are each pair's global chain position, the
    seed of its draws; ``samples`` an optional {pair index: [trials, 3]} of
    given draws. Returns host (T [P, 4, 4], gfit, ifit, irmse) in input
    order."""
    n_pairs = len(pairs)
    batch = max(1, int(cfg.pair_batch))
    T = np.zeros((n_pairs, 4, 4), np.float32)
    gf, fi, ir = (np.zeros(n_pairs, np.float32) for _ in range(3))
    kw = dict(max_dist=voxel * 1.5, icp_max_dist=voxel * float(cfg.icp_dist_ratio),
              trials=cfg.ransac_trials, icp_iters=cfg.icp_iters)
    by_bucket: dict[int, list[int]] = {}
    for i, (s, d) in enumerate(pairs):
        by_bucket.setdefault(max(s.points.shape[0], d.points.shape[0]), []).append(i)
    for bucket in sorted(by_bucket):
        idxs = by_bucket[bucket]
        for s0 in range(0, len(idxs), batch):
            chunk = idxs[s0:s0 + batch]
            launch = chunk + [chunk[-1]] * (_pair_group_bucket(len(chunk), batch) - len(chunk))
            stacks = [[] for _ in range(7)]
            for i in launch:
                sp, sv, _, sf = _prep_to_bucket(pairs[i][0], bucket)
                dp, dv, dn, df = _prep_to_bucket(pairs[i][1], bucket)
                for k, a in enumerate((sp, sv, sf, dp, dv, df, dn)):
                    stacks[k].append(a)
            out = reg.register_pairs(
                *(torch.stack(s) for s in stacks), pair_ids=[pair_ids[i] for i in launch],
                samples=None if samples is None else [samples[i] for i in launch], **kw)
            T_l, gf_l, fi_l, ir_l = (o.detach().cpu().numpy() for o in out)
            for j, i in enumerate(chunk):
                T[i], gf[i], fi[i], ir[i] = T_l[j], gf_l[j], fi_l[j], ir_l[j]
    return T, gf, fi, ir


def transform_views_batched(points_list, transforms, device=None):
    """Apply per-view transforms as one padded [V, S, 3] batch on
    ``device``: x' = ((r0 x + r1 y) + r2 z) + t per row, in that order on
    every device. Returns the moved f32 arrays in input order."""
    n = len(points_list)
    if n == 0:
        return []
    dev = resolve_device(device)
    slots = _bucket_pad(max(len(p) for p in points_list))
    P = np.zeros((n, slots, 3), np.float32)
    for i, p in enumerate(points_list):
        P[i, :len(p)] = np.asarray(p, np.float32)
    P = torch.from_numpy(P).to(dev)
    T = torch.from_numpy(np.stack([np.asarray(t, np.float32) for t in transforms])).to(dev)
    R, t = T[:, None, :3, :3], T[:, None, :3, 3]
    out = ((R[..., 0] * P[..., 0:1] + R[..., 1] * P[..., 1:2])
           + R[..., 2] * P[..., 2:3]) + t
    out = out.cpu().numpy()
    return [out[i, :len(points_list[i])] for i in range(n)]


def finalize_chain(clouds, T_pairs, gfit_all, ifit_all, irmse_all,
                   cfg: MergeConfig | None = None, log=print,
                   timings: dict | None = None, device=None, step_callback=None):
    """Chain-accumulate the pair transforms (host f32 matmuls), move views
    1..n-1 into view 0's frame in one batch, concatenate, and run the final
    voxel/outlier pass. Returns (points, colors, transforms).
    ``step_callback(i, new_points, new_colors, total)`` gets each newly
    folded view's moved arrays and the running point count, view 0 first
    as a seed call with ``i == 0``; it changes nothing of the merge."""
    cfg = cfg or MergeConfig()
    tm = timings if timings is not None else {}
    n = len(clouds)
    transforms = [np.eye(4, dtype=np.float32)]
    t0 = time.perf_counter()
    t_accum = transforms[0].copy()
    for i in range(1, n):
        gfit = float(gfit_all[i - 1])
        if gfit < 0.05:
            log(f"[merge_360] WARNING view {i}: global fitness {gfit:.3f} < 0.05 "
                f"— alignment may fail")
        log(f"[merge_360] view {i}: global fit {gfit:.3f} | ICP fit "
            f"{float(ifit_all[i - 1]):.3f} rmse {float(irmse_all[i - 1]):.3f}")
        t_accum = (t_accum @ np.asarray(T_pairs[i - 1], np.float32)).astype(np.float32)
        transforms.append(t_accum.copy())
    moved = transform_views_batched([clouds[i][0] for i in range(1, n)],
                                    transforms[1:], device=device)
    if step_callback is not None:
        total = len(clouds[0][0])
        step_callback(0, np.asarray(clouds[0][0], np.float32),
                      np.asarray(clouds[0][1], np.uint8), total)
        for i in range(1, n):
            total += len(moved[i - 1])
            step_callback(i, moved[i - 1], np.asarray(clouds[i][1], np.uint8), total)
    points = np.concatenate([np.asarray(clouds[0][0], np.float32)] + moved)
    colors = np.concatenate([np.asarray(c, np.uint8) for _, c in clouds])
    tm["accumulate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    points, colors = _postprocess_merged(points, colors, cfg, tm, device=device)
    tm["postprocess_s"] = time.perf_counter() - t0
    return points, colors, transforms


def _postprocess_merged(points, colors, cfg: MergeConfig, tm: dict | None = None,
                        device=None):
    """Final voxel -> uniform sample -> statistical outlier, the cloud
    staying on the device between the stages: after the voxel pass the
    survivors are a slot prefix, cut at the next multiple of 8192."""
    tm = tm if tm is not None else {}
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    cols = torch.as_tensor(np.asarray(colors, np.uint8), device=dev)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    if cfg.final_voxel and cfg.final_voxel > 0:
        t0 = time.perf_counter()
        p, c, v = pc.voxel_downsample(pts, cols, valid, float(cfg.final_voxel))
        n_keep = int(v.sum())
        n_pad = min(-(-max(n_keep, 1) // 8192) * 8192, p.shape[0])
        pts, cols, valid = p[:n_pad], c[:n_pad], v[:n_pad]
        tm["final_voxel_s"] = time.perf_counter() - t0
    if cfg.sample_after and cfg.sample_after > 1:
        pts, cols, valid = (a[::cfg.sample_after] for a in (pts, cols, valid))
    if cfg.outlier_nb > 0:
        t0 = time.perf_counter()
        cell = float(cfg.final_voxel) if cfg.final_voxel and cfg.final_voxel > 0 else None
        valid = valid & pc.statistical_outlier_mask(
            pts.contiguous(), valid, cfg.outlier_nb, cfg.outlier_std, voxelized_cell=cell)
        tm["outlier_s"] = time.perf_counter() - t0
    return pts[valid].cpu().numpy(), cols[valid].cpu().numpy()


def merge_360(clouds, cfg: MergeConfig | None = None, log=print,
              timings: dict | None = None, device=None, step_callback=None):
    """Merge ordered per-view clouds [(points [N, 3] f32, colors [N, 3] u8),
    ...] into one 360-degree cloud on ``device`` (None -> cuda). Returns
    (points, colors, transforms); transforms[i] maps view i into view 0's
    frame. ``timings`` is filled with preprocess_s / register_s /
    accumulate_s / postprocess_s (host wall, synchronized by the host
    transfers that end each stage). ``step_callback``: as in
    ``finalize_chain``."""
    cfg = cfg or MergeConfig()
    if cfg.method != "sequential":
        raise NotImplementedError(
            f"merge.method={cfg.method!r} is not ported (ROADMAP A5, legacy merge "
            f"modes: merge_360_posegraph); use 'sequential'")
    dev = resolve_device(device)
    voxel = float(cfg.voxel_size)
    tm = timings if timings is not None else {}
    n = len(clouds)
    if n == 1:
        points, colors = _postprocess_merged(clouds[0][0], clouds[0][1], cfg, tm, dev)
        return points, colors, [np.eye(4, dtype=np.float32)]
    t0 = time.perf_counter()
    preps = [prep_view(p, voxel, cfg.sample_before, dev) for p, _ in clouds]
    tm["preprocess_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    T_all, gfit, ifit, irmse = register_prep_pairs(
        [(preps[i], preps[i - 1]) for i in range(1, n)], list(range(n - 1)), cfg, voxel)
    tm["register_s"] = time.perf_counter() - t0
    return finalize_chain(clouds, T_all, gfit, ifit, irmse, cfg, log=log,
                          timings=tm, device=dev, step_callback=step_callback)


def chamfer_distance(a, b, device=None) -> float:
    """Symmetric mean nearest-neighbour distance between clouds [Na, 3] and
    [Nb, 3], through the nn1 kernel (centered on the common midpoint)."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(a, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(b, np.float32), device=dev)
    mid = 0.5 * (a.mean(0) + b.mean(0))
    a, b = (a - mid).contiguous(), (b - mid).contiguous()

    def one_way(x, y):
        _, d2 = reg._nn1_dispatch(x[None], y[None])
        return float(torch.sqrt(torch.clamp_min(d2, 0.0)).mean())

    return 0.5 * (one_way(a, b) + one_way(b, a))
