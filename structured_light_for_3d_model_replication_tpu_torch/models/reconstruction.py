"""360-degree multi-view merge (the JAX package's ``models/reconstruction.py``).

Clouds sorted by turntable angle chain-align view i onto view i-1: per
view, voxel downsample + normals + FPFH; per pair, RANSAC global init and
point-to-plane ICP; then the chained transforms move every view into view
0's frame, and the merged cloud goes through the final voxel and the
statistical outlier pass. ``merge_360`` has two arms, as in the JAX
package:

  host-list    per-view preps (``prep_view``), pairs at their own buckets
               (``register_prep_pairs``), the moved views gathered on the
               host (``finalize_chain``): the arm the streamed pipeline
               shares byte for byte, and the one the barrier pipeline runs;
  device       one stacked prep of every view at one shared bucket
               (``_preprocess_views``, or ``_preprocess_views_device`` for
               a ``DeviceClouds`` stack), every chain pair in one
               ``_register_chain_batched`` call with position keys, the
               transforms applied to the padded stack on the device
               (``_accumulate_views``) and the stack handed to the
               postprocess with its valid mask. It runs on the card where
               ``_device_accumulate_ok`` holds; its output is not
               byte-identical to the host-list arm's.

``preprocess_for_registration`` is the public one-cloud prep (the
reference's ``preprocess_point_cloud``): a masked cloud compacted, voxel
downsampled and padded to ``pad_to`` rows, then ``prep_view``'s features.

``merge_360_posegraph`` registers the odometry edges and a first<->last
loop closure in one ``_register_chain_batched`` call and solves the pose
graph (``ops/posegraph.py``).

``mesh=`` (a ``parallel/mesh.DeviceMesh``, ``parallel.merge_mesh``) takes
the host-list arm, as in the JAX package: the pairs shard over the mesh
(``registration.register_pairs_sharded``, each pair at the lane count of
the unsharded arm, so the same transforms), the accumulate over the views
(``transform_views_batched``) and the final voxel + outlier pass over
z-slabs (``ops/pointcloud_sharded``, ``_postprocess_dispatch``).

Shapes follow the JAX package so the two index spaces agree: a view's raw
points pad to a multiple of 8192, its voxel survivors to a multiple of 2048
(its bucket), and a pair runs at the larger of its two buckets (the shared
bucket in the device arm). RANSAC draws are indices into that space, so the
reference's draws can be fed to the port unchanged (``samples``), and a
pair's draws depend only on (seed, pair id).
"""
from __future__ import annotations

import os
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

__all__ = ["merge_360", "merge_360_posegraph", "DeviceClouds", "compact_views_device",
           "stack_views_device", "prep_view", "prep_view_device", "prep_from_reference",
           "preprocess_for_registration",
           "device_clouds_from_reference", "register_prep_pairs",
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


@dataclass
class DeviceClouds:
    """Per-view clouds on the device, one shared padded slot count S:
    ``points`` [V, S, 3] f32, ``valid`` [V, S] bool (each view's points a
    slot prefix), ``colors`` [V, S, 3] u8, and the per-view counts on the
    host (``counts``, so the merge's gate needs no device sync). The
    handoff into ``merge_360``'s device arm without a per-view host pack
    and re-upload."""
    points: torch.Tensor
    valid: torch.Tensor
    colors: torch.Tensor
    counts: np.ndarray | None = None

    def to_host_list(self):
        """The host (points, colors) list every other entry point takes."""
        p = self.points.detach().to("cpu", torch.float32).numpy()
        v = self.valid.cpu().numpy()
        c = self.colors.cpu().numpy()
        return [(p[i][v[i]], c[i][v[i]]) for i in range(p.shape[0])]


def _device_of(x, device) -> torch.device:
    """A tensor input stays on its device unless ``device`` is given."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def compact_views_device(points, valid, colors, device=None) -> DeviceClouds:
    """A decoded view stack ([V, H*W] slots) -> DeviceClouds: each view's
    valid slots first, in slot order, on one shared 2048-multiple bucket
    (clamped to the slots). One gray channel becomes three. The only host
    traffic is the [V] counts."""
    dev = _device_of(points, device)
    pts = torch.as_tensor(points if isinstance(points, torch.Tensor)
                          else np.asarray(points), dtype=torch.float32).to(dev)
    v = torch.as_tensor(valid if isinstance(valid, torch.Tensor)
                        else np.asarray(valid), dtype=torch.bool).to(dev)
    c = torch.as_tensor(colors if isinstance(colors, torch.Tensor)
                        else np.asarray(colors), dtype=torch.uint8).to(dev)
    if c.shape[-1] == 1:
        c = c.expand(-1, -1, 3)
    order, cnts_dev = _compact_order_counts(v)
    cnts = cnts_dev.cpu().numpy().astype(int)
    o = order[:, :_bucket_pad(int(cnts.max()), pts.shape[1])]
    return DeviceClouds(torch.gather(pts, 1, o[..., None].expand(-1, -1, 3)),
                        torch.gather(v, 1, o),
                        torch.gather(c, 1, o[..., None].expand(-1, -1, 3)), cnts)


def stack_views_device(clouds, device=None) -> DeviceClouds:
    """Compact per-view clouds [(points [Ni, 3], colors [Ni, 3]), ...] ->
    one DeviceClouds stack on the shared bucket: host arrays packed once
    and uploaded once, device tensors padded where they are."""
    counts = np.asarray([len(p) for p, _ in clouds], int)
    bucket = _bucket_pad(int(counts.max()) if len(counts) else 1)
    dev = _device_of(clouds[0][0] if clouds else None, device)
    if all(isinstance(p, np.ndarray) for p, _ in clouds):
        pts_h = np.zeros((len(clouds), bucket, 3), np.float32)
        cols_h = np.zeros((len(clouds), bucket, 3), np.uint8)
        for i, (p, c) in enumerate(clouds):
            pts_h[i, :len(p)] = np.asarray(p, np.float32)
            cols_h[i, :len(p)] = np.asarray(c, np.uint8)
        pts, cols = torch.from_numpy(pts_h).to(dev), torch.from_numpy(cols_h).to(dev)
    else:
        def pad(a, dtype):
            a = torch.as_tensor(a, dtype=dtype).to(dev)
            return torch.cat([a, a.new_zeros((bucket - a.shape[0], 3))])

        pts = torch.stack([pad(p, torch.float32) for p, _ in clouds])
        cols = torch.stack([pad(c, torch.uint8) for _, c in clouds])
    valid = (torch.as_tensor(counts, device=dev)[:, None]
             > torch.arange(bucket, device=dev)[None, :])
    return DeviceClouds(pts, valid, cols, counts)


def device_clouds_from_reference(dc, device=None) -> DeviceClouds:
    """A JAX-package ``DeviceClouds`` (or anything with the same fields,
    as arrays) -> the port's, on ``device`` (None -> cuda)."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    counts = None if dc.counts is None else np.asarray(dc.counts, int)
    return DeviceClouds(t(dc.points, torch.float32), t(dc.valid, torch.bool),
                        t(dc.colors, torch.uint8), counts)


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


def _feat_knn_selector(device: torch.device) -> str:
    """The k-NN selector of feature prep (the JAX package's): the binned
    selection at 0.95 per-row recall on the card, where a missed neighbour
    only swaps in a slightly farther one and FPFH's 11-bin histograms do not
    resolve the difference; the exact top-k on the CPU. SLSCAN_FEAT_EXACT=1
    forces the exact selector. M depends on k and the recall alone (capped
    at the bucket), so a view's features do not depend on the bucket it is
    padded into."""
    if os.environ.get("SLSCAN_FEAT_EXACT") == "1":
        return "topk"
    return "topk" if device.type == "cpu" else "approx:0.95"


def _prep_features(p: torch.Tensor, v: torch.Tensor, feat_radius: float):
    idx, d2 = knnlib.knn(p, v, FEAT_K, selector=_feat_knn_selector(p.device))
    nr = nrmlib.estimate_normals(p, v, k=NORMALS_K, idx_d2=(idx, d2))
    feat = reg.fpfh_features(p, nr, v, radius=feat_radius, k=FEAT_K, idx_d2=(idx, d2))
    return nr, feat


def _voxel_survivors(p: np.ndarray, voxel: float, dev: torch.device):
    """A compact host cloud's voxel means on ``dev``: the rows padded to a
    multiple of 8192 (pad rows at 1e9, invalid), voxel downsampled, the
    survivors a prefix. Returns (means [n_raw, 3], survivor count, n_raw)."""
    n = len(p)
    n_raw = -(-max(n, 1) // 8192) * 8192
    pts = np.full((n_raw, 3), 1e9, np.float32)
    pts[:n] = p
    pts_t = torch.from_numpy(pts).to(dev)
    valid = torch.arange(n_raw, device=dev) < n
    p_all, _, v_all = pc.voxel_downsample(
        pts_t, torch.zeros((n_raw, 3), dtype=torch.uint8, device=dev), valid, voxel)
    return p_all, int(v_all.sum()), n_raw


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
    p_all, cnt, n_raw = _voxel_survivors(p, voxel, dev)
    bucket = _bucket_pad(cnt, n_raw)
    p_c = p_all[:bucket].contiguous()
    v_c = torch.arange(bucket, device=dev) < cnt
    nr, feat = _prep_features(p_c, v_c, float(np.float32(FEAT_RADIUS_SCALE * voxel)))
    return _Prep(p_c, v_c, nr, feat)


def _host_array(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def preprocess_for_registration(points, colors, valid, voxel_size: float,
                                pad_to: int | None = None, device=None) -> _Prep:
    """Voxel downsample -> normals -> FPFH (r = 5 * voxel) of one cloud, the
    reference's ``preprocess_point_cloud``, with ``points`` [N, 3] and its
    ``valid`` [N] mask (numpy or tensors; ``colors`` is not read). The valid
    rows are compacted on the host, voxel downsampled as ``prep_view``
    does, and the survivors padded to ``pad_to`` rows (default the next
    multiple of 2048) at 1e9, invalid, before the feature stages, so their
    cost follows the downsampled count. A ``pad_to`` below the survivor
    count raises ValueError. On the valid rows the result is
    ``prep_view``'s of the same points. ``device``: None keeps a tensor
    input's device, else cuda."""
    dev = _device_of(points, device)
    reg.exact_f32_products()
    p = _host_array(points, np.float32)
    if valid is not None:
        p = p[_host_array(valid, bool)]
    p_all, cnt, _ = _voxel_survivors(p, voxel_size, dev)
    total = pad_to if pad_to is not None else _bucket_pad(cnt)
    if cnt > total:
        raise ValueError(
            f"pad_to={total} is smaller than the downsampled cloud ({cnt} "
            f"points); raise pad_to or the voxel size")
    p_c = torch.cat([p_all[:cnt], torch.full((total - cnt, 3), 1e9, dtype=torch.float32,
                                             device=dev)]).contiguous()
    v_c = torch.arange(total, device=dev) < cnt
    nr, feat = _prep_features(p_c, v_c, float(np.float32(FEAT_RADIUS_SCALE * voxel_size)))
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


def _prep_to_bucket(prep: _Prep, bucket: int):
    """Zero-pad one view's prep to a pair bucket (pad rows invalid)."""
    pad = bucket - prep.points.shape[0]
    if pad == 0:
        return prep.points, prep.valid, prep.normals, prep.features

    def z(a):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

    return z(prep.points), z(prep.valid), z(prep.normals), z(prep.features)


def register_prep_pairs(pairs, pair_ids, cfg: MergeConfig, voxel: float,
                        samples=None, feat_bf16: bool | None = None, mesh=None,
                        batch: int | None = None):
    """Register (prep_src, prep_dst) pairs: grouped by pair bucket (the
    larger of the two views' buckets), ``batch`` pairs a launch group
    (None: ``cfg.pair_batch``), whose ICP always runs on ``batch`` lanes (a
    short group, a ragged tail or a worker's one pair, padded with copies of
    its last pair), so a pair gives the same bytes in every group of one
    ``batch``. ``pair_ids`` are each pair's global chain position, the seed
    of its draws; ``samples`` an optional {pair index: [trials, 3]} of
    given draws; ``feat_bf16`` as in ``registration.register_pairs``.
    ``mesh``: a group holds ``batch`` pairs per mesh slot and shards over
    the mesh (``register_pairs_sharded``), each slot's ICP still on
    ``batch`` lanes: the same bytes.
    Returns host (T [P, 4, 4], gfit, ifit, irmse) in input order."""
    n_pairs = len(pairs)
    batch = max(1, int(batch if batch is not None else cfg.pair_batch))
    group = batch * (mesh.size if mesh is not None else 1)
    T = np.zeros((n_pairs, 4, 4), np.float32)
    gf, fi, ir = (np.zeros(n_pairs, np.float32) for _ in range(3))
    kw = dict(max_dist=voxel * 1.5, icp_max_dist=voxel * float(cfg.icp_dist_ratio),
              trials=cfg.ransac_trials, icp_iters=cfg.icp_iters, feat_bf16=feat_bf16)
    by_bucket: dict[int, list[int]] = {}
    for i, (s, d) in enumerate(pairs):
        by_bucket.setdefault(max(s.points.shape[0], d.points.shape[0]), []).append(i)
    for bucket in sorted(by_bucket):
        idxs = by_bucket[bucket]
        for s0 in range(0, len(idxs), group):
            chunk = idxs[s0:s0 + group]
            stacks = [[] for _ in range(7)]
            for i in chunk:
                sp, sv, _, sf = _prep_to_bucket(pairs[i][0], bucket)
                dp, dv, dn, df = _prep_to_bucket(pairs[i][1], bucket)
                for k, a in enumerate((sp, sv, sf, dp, dv, df, dn)):
                    stacks[k].append(a)
            args = [torch.stack(s) for s in stacks]
            ckw = dict(kw, pair_ids=[pair_ids[i] for i in chunk], icp_lanes=batch,
                       samples=None if samples is None else [samples[i] for i in chunk])
            out = (reg.register_pairs(*args, **ckw) if mesh is None
                   else reg.register_pairs_sharded(mesh, *args, **ckw))
            T_l, gf_l, fi_l, ir_l = (o.detach().cpu().numpy() for o in out)
            for j, i in enumerate(chunk):
                T[i], gf[i], fi[i], ir[i] = T_l[j], gf_l[j], fi_l[j], ir_l[j]
    return T, gf, fi, ir


# ---------------------------------------------------------------------------
# The device-accumulate arm: one stacked prep, one batched chain register
# ---------------------------------------------------------------------------

def _sample_every(p, c, every):
    """Uniform pre-registration subsampling (``sample_before``)."""
    if every and every > 1:
        return p[::every], c[::every]
    return p, c


def _voxel_stack(pts: torch.Tensor, valid: torch.Tensor, voxel: float):
    """Voxel downsample each view of [V, S, 3] / [V, S] -> (p_stack [V, B,
    3], v_stack [V, B]) on one shared 2048-multiple bucket B (survivors a
    slot prefix, the rest zeros), after one sync for the [V] counts."""
    zeros = torch.zeros((pts.shape[1], 3), dtype=torch.uint8, device=pts.device)
    outs = [pc.voxel_downsample(pts[i], zeros, valid[i], voxel) for i in range(pts.shape[0])]
    cnts = torch.stack([v.sum() for _, _, v in outs]).cpu().numpy().astype(int)
    n_pad = _bucket_pad(int(cnts.max()), pts.shape[1])
    p_stack = torch.stack([p[:n_pad] for p, _, _ in outs])
    v_stack = (torch.as_tensor(cnts, device=pts.device)[:, None]
               > torch.arange(n_pad, device=pts.device)[None, :])
    return p_stack, v_stack


def _voxel_pack_views(clouds, voxel: float, sample_before: int, keep_raw: bool = False,
                      device=None):
    """The voxel half of ``_preprocess_views``: every view's raw points
    padded to one multiple of 8192 (pad rows at 1e9, invalid), packed on
    the host and uploaded once, then ``_voxel_stack``. Returns (p_stack,
    v_stack, raw): raw = the uploaded (points [V, n_raw, 3], valid [V,
    n_raw]) with ``keep_raw``, else None."""
    dev = resolve_device(device)
    sampled = [_sample_every(np.asarray(p, np.float32), np.asarray(c, np.uint8),
                             sample_before) for p, c in clouds]
    n_raw = -(-max(len(p) for p, _ in sampled) // 8192) * 8192
    pts = np.full((len(sampled), n_raw, 3), 1e9, np.float32)
    valid = np.zeros((len(sampled), n_raw), bool)
    for k, (p, _) in enumerate(sampled):
        pts[k, :len(p)] = p
        valid[k, :len(p)] = True
    pts_d, valid_d = torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev)
    p_stack, v_stack = _voxel_stack(pts_d, valid_d, voxel)
    return p_stack, v_stack, ((pts_d, valid_d) if keep_raw else None)


def _features_stack(p_stack: torch.Tensor, v_stack: torch.Tensor, voxel: float):
    radius = float(np.float32(FEAT_RADIUS_SCALE * voxel))
    preps = []
    for i in range(p_stack.shape[0]):
        p = p_stack[i].contiguous()
        nr, feat = _prep_features(p, v_stack[i], radius)
        preps.append(_Prep(p, v_stack[i], nr, feat))
    return preps


def _preprocess_views(clouds, voxel: float, sample_before: int, keep_raw: bool = False,
                      device=None):
    """Prep every view at ONE shared bucket: the voxel stack
    (``_voxel_pack_views``), then normals and FPFH a view. Returns preps,
    or (preps, raw) with ``keep_raw`` (the uploaded raw stacks, which the
    device arm moves and postprocesses without a host round trip)."""
    reg.exact_f32_products()
    p_stack, v_stack, raw = _voxel_pack_views(clouds, voxel, sample_before, keep_raw,
                                              device)
    preps = _features_stack(p_stack, v_stack, voxel)
    return (preps, raw) if keep_raw else preps


def _preprocess_views_device(dc: DeviceClouds, voxel: float):
    """``_preprocess_views`` of a DeviceClouds stack: no host pack, no
    upload. Returns (preps, (dc.points, dc.valid)); the preps' valid points
    equal the host list's bit for bit (invalid slots sort last in the voxel
    pass and add nothing)."""
    reg.exact_f32_products()
    p_stack, v_stack = _voxel_stack(dc.points, dc.valid, voxel)
    return _features_stack(p_stack, v_stack, voxel), (dc.points, dc.valid)


def _register_chain_batched(preps, cfg: MergeConfig, voxel: float, loop_closure: bool,
                            feat_bf16: bool | None = None, samples=None, mesh=None):
    """Every chain pair (i-1 <- i), and with ``loop_closure`` (0 <- n-1) as
    the last row, in ONE ``registration.register_pairs`` call on the preps'
    shared bucket: pair ids are positions in that batch (0..P-1), the
    JAX package's position keys. ``samples`` [P, trials, 3]: given draws.
    ``mesh``: the call shards over the mesh, every slot's ICP on P lanes
    (the unsharded call's), so the same transforms.
    Returns host (T [P, 4, 4], gfit [P], ifit [P], irmse [P])."""
    srcs = preps[1:] + ([preps[-1]] if loop_closure else [])
    dsts = preps[:-1] + ([preps[0]] if loop_closure else [])
    args = (torch.stack([p.points for p in srcs]), torch.stack([p.valid for p in srcs]),
            torch.stack([p.features for p in srcs]), torch.stack([p.points for p in dsts]),
            torch.stack([p.valid for p in dsts]), torch.stack([p.features for p in dsts]),
            torch.stack([p.normals for p in dsts]))
    kw = dict(max_dist=voxel * 1.5, icp_max_dist=voxel * float(cfg.icp_dist_ratio),
              trials=cfg.ransac_trials, icp_iters=cfg.icp_iters, samples=samples,
              feat_bf16=feat_bf16)
    out = (reg.register_pairs(*args, **kw) if mesh is None
           else reg.register_pairs_sharded(mesh, *args, icp_lanes=len(srcs), **kw))
    return tuple(o.detach().cpu().numpy().astype(np.float32) for o in out)


def _full_postprocess(cfg: MergeConfig) -> bool:
    """The config runs the whole final voxel -> outlier chain with no
    subsample in between (the shape the device arm's postprocess takes)."""
    return (bool(cfg.final_voxel and cfg.final_voxel > 0) and cfg.outlier_nb > 0
            and not (cfg.sample_after and cfg.sample_after > 1))


def _device_accumulate_ok(cfg: MergeConfig, step_callback, n_views: int, slots: int,
                          n_actual: int, device: torch.device,
                          why: list | None = None) -> bool:
    """The ONE gate of the device arm (the JAX package's): an accelerator
    (``device.type == 'cuda'``), no per-step host clouds (a step callback),
    no ``sample_before``, the full postprocess chain, the raw stack and
    its moved copy under 1 GiB, and slot occupancy >= 1/2 (one huge view
    must not pad every view's slots). Appends the first refusal's reason
    to ``why``."""
    checks = (
        (device.type == "cuda", f"device {device.type}, not an accelerator"),
        (step_callback is None, "a step callback wants the per-step host clouds"),
        (not cfg.sample_before or cfg.sample_before <= 1,
         f"merge.sample_before={cfg.sample_before}"),
        (_full_postprocess(cfg), "the postprocess is not the full voxel -> outlier chain"),
        (n_views * slots * 12 <= (1 << 30),
         f"{n_views} x {slots} slots exceed the 1 GiB stack bound"),
        (n_actual >= 0.5 * n_views * slots,
         f"occupancy {n_actual}/{n_views * slots} under 1/2"))
    for ok, reason in checks:
        if not ok:
            if why is not None:
                why.append(reason)
            return False
    return True


def _apply_transforms(P: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """P [V, S, 3] moved by T [V, 4, 4]: ((r0 x + r1 y) + r2 z) + t per row,
    in that order on every device."""
    R, t = T[:, None, :3, :3], T[:, None, :3, 3]
    return ((R[..., 0] * P[..., 0:1] + R[..., 1] * P[..., 1:2]) + R[..., 2] * P[..., 2:3]) + t


def _accumulate_views(raw_p: torch.Tensor, transforms) -> torch.Tensor:
    """The device arm's accumulate: every view of the raw stack [V, S, 3]
    moved by its chained transform in one batch, on the stack's device, in
    ``transform_views_batched``'s row order."""
    T = torch.from_numpy(np.stack([np.asarray(t, np.float32) for t in transforms]))
    return _apply_transforms(raw_p, T.to(raw_p.device))


def _chain(T_pairs, gfit_all, ifit_all, irmse_all, log, seed=None):
    """Host f32 chain of the pair transforms (view i into view 0's frame),
    logging each pair's fitness as the JAX package does. ``seed``: the
    chain's first transforms, already accumulated (an incremental
    assembly's validated prefix); the chain goes on from its last."""
    transforms = ([np.asarray(t, np.float32) for t in seed] if seed
                  else [np.eye(4, dtype=np.float32)])
    for i in range(1, len(T_pairs) + 1):
        gfit = float(gfit_all[i - 1])
        if gfit < 0.05:
            log(f"[merge_360] WARNING view {i}: global fitness {gfit:.3f} < 0.05 "
                f"— alignment may fail")
        log(f"[merge_360] view {i}: global fit {gfit:.3f} | ICP fit "
            f"{float(ifit_all[i - 1]):.3f} rmse {float(irmse_all[i - 1]):.3f}")
        if i < len(transforms):
            continue   # folded before the last item settled
        transforms.append((transforms[-1] @ np.asarray(T_pairs[i - 1], np.float32))
                          .astype(np.float32))
    return transforms


def transform_views_batched(points_list, transforms, device=None, mesh=None):
    """Apply per-view transforms as one padded [V, S, 3] batch on
    ``device``: x' = ((r0 x + r1 y) + r2 z) + t per row, in that order on
    every device. ``mesh``: the view axis (padded to a multiple of the
    slot count with empty views) shards over the mesh, each slot moving
    its views on its device: the same bytes. Returns the moved f32 arrays
    in input order."""
    n = len(points_list)
    if n == 0:
        return []
    vb = n if mesh is None else -(-n // mesh.size) * mesh.size
    slots = _bucket_pad(max(len(p) for p in points_list))
    P = np.zeros((vb, slots, 3), np.float32)
    for i, p in enumerate(points_list):
        P[i, :len(p)] = np.asarray(p, np.float32)
    T = torch.from_numpy(np.stack([np.asarray(transforms[min(i, n - 1)], np.float32)
                                   for i in range(vb)]))
    if mesh is None:
        dev = resolve_device(device)
        out = _apply_transforms(torch.from_numpy(P).to(dev), T.to(dev)).cpu().numpy()
    else:
        from structured_light_for_3d_model_replication_tpu_torch.parallel import (
            mesh as meshlib,
        )

        moved = [_apply_transforms(p, t) for p, t in
                 zip(meshlib.batch_sharding(mesh, P), meshlib.batch_sharding(mesh, T))]
        out = meshlib.gather_shards(moved, "cpu").numpy()
    return [out[i, :len(points_list[i])] for i in range(n)]


def finalize_chain(clouds, T_pairs, gfit_all, ifit_all, irmse_all,
                   cfg: MergeConfig | None = None, log=print,
                   timings: dict | None = None, device=None, step_callback=None,
                   prefold=None, mesh=None):
    """Chain-accumulate the pair transforms (host f32 matmuls), move views
    1..n-1 into view 0's frame in one batch, concatenate, and run the final
    voxel/outlier pass. Returns (points, colors, transforms).
    ``step_callback(i, new_points, new_colors, total)`` gets each newly
    folded view's moved arrays and the running point count, view 0 first
    as a seed call with ``i == 0``; it changes nothing of the merge.

    ``prefold``: an incremental assembly's folded prefix
    (``pipeline.assembly.Prefold``, already validated against this run's
    view order, digests and pair transforms). Its transforms and moved
    views stand for the first ``len(prefold.transforms)`` views and only
    the suffix is chained and moved here; the fold moved its views with
    ``_apply_transforms`` on the CPU, bit-equal to this batch on any
    device, so the merged bytes do not depend on how much was folded.
    ``mesh``: the move shards over the views and the final pass over
    z-slabs (``_postprocess_dispatch``)."""
    cfg = cfg or MergeConfig()
    tm = timings if timings is not None else {}
    n = len(clouds)
    t0 = time.perf_counter()
    start = 1
    seed = None
    if prefold is not None and 2 <= len(prefold.transforms) <= n:
        seed = prefold.transforms
        start = len(seed)
    transforms = _chain(T_pairs[:n - 1], gfit_all, ifit_all, irmse_all, log, seed=seed)
    moved = ([np.asarray(p, np.float32) for p in prefold.merged_p[1:start]]
             if seed is not None else [])
    moved += transform_views_batched([clouds[i][0] for i in range(start, n)],
                                     transforms[start:], device=device, mesh=mesh)
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
    points, colors = _postprocess_dispatch(points, colors, cfg, tm, mesh, log, device)
    tm["postprocess_s"] = time.perf_counter() - t0
    return points, colors, transforms


def _postprocess_dispatch(points, colors, cfg: MergeConfig, tm: dict, mesh, log,
                          device=None, valid=None):
    """The slab-sharded final pass over ``mesh`` when the config runs the
    full voxel -> outlier chain (``ops/pointcloud_sharded``), else the
    single-device pass; also that pass, logged, where the cloud cannot be
    slabbed (``SlabRefused``: too thin, too wide, or too many uncertified
    rows). Any other error propagates. ``tm["postprocess_arm"]`` says which
    ran ("slab-sharded", "single-device" or "single-device (refused: ...)")."""
    if mesh is not None and _full_postprocess(cfg):
        from structured_light_for_3d_model_replication_tpu_torch.ops import (
            pointcloud_sharded as pcs,
        )

        try:
            out = pcs.postprocess_merged_sharded(
                mesh, points, colors, valid, float(cfg.final_voxel), cfg.outlier_nb,
                cfg.outlier_std)
            tm["postprocess_arm"] = "slab-sharded"
            return out
        except pcs.SlabRefused as e:
            log(f"[merge] sharded postprocess unavailable ({e}); single-device pass")
            tm["postprocess_arm"] = f"single-device (refused: {e})"
    else:
        tm["postprocess_arm"] = "single-device"
    return _postprocess_merged(points, colors, cfg, tm, device=device, valid=valid)


def _postprocess_merged(points, colors, cfg: MergeConfig, tm: dict | None = None,
                        device=None, valid=None):
    """Final voxel -> uniform sample -> statistical outlier, the cloud
    staying on the device between the stages: after the voxel pass the
    survivors are a slot prefix, cut at the next multiple of 8192.
    ``points`` / ``colors`` are host arrays, or device tensors with their
    ``valid`` mask (the device arm's padded stack); returns host arrays."""
    tm = tm if tm is not None else {}
    dev = resolve_device(device)
    pts = (points if isinstance(points, torch.Tensor)
           else torch.as_tensor(np.asarray(points, np.float32), device=dev))
    cols = (colors if isinstance(colors, torch.Tensor)
            else torch.as_tensor(np.asarray(colors, np.uint8), device=dev))
    if valid is None:
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


def _merge_host_list(clouds, cfg: MergeConfig, log, tm: dict, dev: torch.device,
                     step_callback=None, feat_bf16: bool | None = None, mesh=None):
    """The host-list arm: per-view ``prep_view``, ``register_prep_pairs``
    with chain-position ids, ``finalize_chain`` — the computation the
    streamed pipeline runs in another schedule, byte for byte."""
    voxel = float(cfg.voxel_size)
    n = len(clouds)
    t0 = time.perf_counter()
    preps = [prep_view(p, voxel, cfg.sample_before, dev) for p, _ in clouds]
    tm["preprocess_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    T_all, gfit, ifit, irmse = register_prep_pairs(
        [(preps[i], preps[i - 1]) for i in range(1, n)], list(range(n - 1)), cfg, voxel,
        feat_bf16=feat_bf16, mesh=mesh)
    tm["register_s"] = time.perf_counter() - t0
    return finalize_chain(clouds, T_all, gfit, ifit, irmse, cfg, log=log,
                          timings=tm, device=dev, step_callback=step_callback, mesh=mesh)


def merge_360(clouds, cfg: MergeConfig | None = None, log=print,
              timings: dict | None = None, device=None, step_callback=None,
              feat_bf16: bool | None = None, mesh=None):
    """Merge ordered per-view clouds [(points [N, 3] f32, colors [N, 3] u8),
    ...], or a ``DeviceClouds`` stack, into one 360-degree cloud on
    ``device`` (None -> cuda; a DeviceClouds stack stays on its own
    device). Returns host (points, colors, transforms); transforms[i] maps
    view i into view 0's frame.

    The arm (module docstring) is the JAX package's choice: the device arm
    where ``_device_accumulate_ok`` holds (on the card, no step callback,
    the full postprocess, occupancy >= 1/2), else the host-list arm (a
    DeviceClouds stack through ``to_host_list``). ``timings`` is filled
    with preprocess_s / register_s / accumulate_s / postprocess_s (host
    wall, synchronized by the host transfers that end each stage), ``arm``
    ('device' or 'host-list') and, where the gate refused, ``refused``.
    ``step_callback``: as in ``finalize_chain`` (it closes the gate).
    ``feat_bf16``: as in ``registration.register_pairs``. ``mesh``: a
    DeviceMesh shards the merge (module docstring; it closes the gate)."""
    cfg = cfg or MergeConfig()
    voxel = float(cfg.voxel_size)
    tm = timings if timings is not None else {}
    # a mesh refuses the device arm first (the JAX package's gate)
    why = [] if mesh is None else [f"a {mesh.size}-slot mesh shards the merge"]
    dc = clouds if isinstance(clouds, DeviceClouds) else None
    if dc is not None:
        dev = dc.points.device if device is None else resolve_device(device)
        v_cnt, slots = dc.points.shape[0], dc.points.shape[1]
        cnts = (dc.counts if dc.counts is not None
                else dc.valid.sum(1).cpu().numpy().astype(int))
        if why or not (v_cnt > 1 and _device_accumulate_ok(cfg, step_callback, v_cnt, slots,
                                                           int(np.sum(cnts)), dev, why)):
            clouds, dc = dc.to_host_list(), None
    else:
        dev = resolve_device(device)
    n = dc.points.shape[0] if dc is not None else len(clouds)
    if n == 1:
        tm["arm"] = "host-list"
        points, colors = _postprocess_dispatch(clouds[0][0], clouds[0][1], cfg, tm, mesh,
                                               log, dev)
        return points, colors, [np.eye(4, dtype=np.float32)]
    if dc is None and not why:
        n_raw_est = -(-max(len(p) for p, _ in clouds) // 8192) * 8192
        _device_accumulate_ok(cfg, step_callback, n, n_raw_est,
                              sum(len(p) for p, _ in clouds), dev, why)
    if why:
        tm["arm"], tm["refused"] = "host-list", why[0]
        return _merge_host_list(clouds, cfg, log, tm, dev, step_callback, feat_bf16, mesh)
    tm["arm"] = "device"
    t0 = time.perf_counter()
    if dc is not None:
        preps, (raw_p, raw_v) = _preprocess_views_device(dc, voxel)
    else:
        preps, (raw_p, raw_v) = _preprocess_views(clouds, voxel, cfg.sample_before,
                                                  keep_raw=True, device=dev)
    tm["preprocess_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    T_all, gfit, ifit, irmse = _register_chain_batched(preps, cfg, voxel, False,
                                                       feat_bf16=feat_bf16)
    tm["register_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    transforms = _chain(T_all, gfit, ifit, irmse, log)
    points = _accumulate_views(raw_p, transforms).reshape(-1, 3)
    if dc is not None:
        colors = dc.colors.reshape(-1, 3)
    else:
        cols = np.zeros((n, raw_p.shape[1], 3), np.uint8)
        for i, (_, c) in enumerate(clouds):
            cols[i, :len(c)] = np.asarray(c, np.uint8)
        colors = torch.from_numpy(cols).to(dev).reshape(-1, 3)
    tm["accumulate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    points, colors = _postprocess_merged(points, colors, cfg, tm, dev,
                                         valid=raw_v.reshape(-1))
    tm["postprocess_s"] = time.perf_counter() - t0
    return points, colors, transforms


def merge_360_posegraph(clouds, cfg: MergeConfig | None = None, log=print,
                        pg_iters: int = 20, step_callback=None, device=None,
                        feat_bf16: bool | None = None, timings: dict | None = None,
                        mesh=None):
    """Multiway pose-graph merge (the JAX package's): every view prepped at
    one shared bucket (``_preprocess_views``); the n - 1 odometry edges
    (i-1 <- i) and the loop closure (0 <- n-1) registered in one
    ``_register_chain_batched`` call; the closure kept only at ICP fitness
    >= 0.05; edges weighted by ICP fitness; ``optimize_pose_graph`` over
    ``pg_iters`` steps from the odometry chain. The poses move EVERY view
    (view 0's need not stay the identity), ``step_callback(i, points,
    colors, total)`` gets each moved view, then the final voxel / outlier
    pass. Fewer than 3 views: ``merge_360``. Returns host (points, colors,
    transforms), transforms[i] world-from-view-i (world = view 0's
    frame before the solve). ``mesh``: the edges, the move and the final
    pass shard over it, as in ``merge_360``."""
    from structured_light_for_3d_model_replication_tpu_torch.ops import posegraph as pglib

    cfg = cfg or MergeConfig()
    tm = timings if timings is not None else {}
    n = len(clouds)
    if n < 3:
        return merge_360(clouds, cfg, log=log, timings=tm, device=device,
                         step_callback=step_callback, feat_bf16=feat_bf16, mesh=mesh)
    dev = resolve_device(device)
    voxel = float(cfg.voxel_size)
    t0 = time.perf_counter()
    preps = _preprocess_views(clouds, voxel, cfg.sample_before, device=dev)
    tm["preprocess_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    T_all, gfit, ifit, irmse = _register_chain_batched(preps, cfg, voxel, True,
                                                       feat_bf16=feat_bf16, mesh=mesh)
    tm["register_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ei, ej, edge_T, edge_w = [], [], [], []
    init = [np.eye(4, dtype=np.float32)]
    for i in range(1, n):
        log(f"[posegraph] edge {i - 1}<-{i}: global fit {float(gfit[i - 1]):.3f} | ICP fit "
            f"{float(ifit[i - 1]):.3f} rmse {float(irmse[i - 1]):.3f}")
        ei.append(i - 1)
        ej.append(i)
        edge_T.append(T_all[i - 1])
        edge_w.append(max(float(ifit[i - 1]), 1e-3))
        init.append((init[-1] @ T_all[i - 1]).astype(np.float32))
    lc_fit = float(ifit[n - 1])
    log(f"[posegraph] loop closure 0<-{n - 1}: global fit {float(gfit[n - 1]):.3f} | "
        f"ICP fit {lc_fit:.3f} rmse {float(irmse[n - 1]):.3f}")
    tm["loop_closure"] = lc_fit >= 0.05
    if tm["loop_closure"]:
        ei.append(0)
        ej.append(n - 1)
        edge_T.append(T_all[n - 1])
        edge_w.append(max(lc_fit, 1e-3))
    else:
        log("[posegraph] WARNING: loop closure rejected (fitness < 0.05); "
            "result equals the odometry chain")
    res = pglib.optimize_pose_graph(np.stack(init), ei, ej, np.stack(edge_T), edge_w,
                                    iters=pg_iters, device=dev)
    log(f"[posegraph] residual rmse {float(res.initial_rmse):.4f} -> "
        f"{float(res.residual_rmse[-1]):.4f} over {pg_iters} iters")
    transforms = list(res.poses.cpu().numpy().astype(np.float32))
    tm["solve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moved = transform_views_batched([p for p, _ in clouds], transforms, device=dev,
                                    mesh=mesh)
    cols = [np.asarray(c, np.uint8) for _, c in clouds]
    if step_callback is not None:
        total = 0
        for i in range(n):
            total += len(moved[i])
            step_callback(i, moved[i], cols[i], total)
    tm["accumulate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    points, colors = _postprocess_dispatch(np.concatenate(moved), np.concatenate(cols),
                                           cfg, tm, mesh, log, dev)
    tm["postprocess_s"] = time.perf_counter() - t0
    return points, colors, transforms


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
