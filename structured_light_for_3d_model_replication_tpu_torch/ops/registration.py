"""Rigid registration: FPFH features, batched-hypothesis RANSAC, point-to-plane
ICP (the JAX package's ``ops/registration.py``; its hash-grid ICP arm, a
host-only engine there, and its sharded pair batch are not ported).

  - Correspondences: a dense feature-distance product, chunked over source
    rows, with Open3D's mutual filter; ``feat_bf16``
    (``parallel.force_bf16_features``) takes the product on bf16 inputs with
    f32 output.
  - RANSAC: T three-point hypotheses solved by batched Kabsch and scored at
    once by the ``ransac_score`` kernel; the best is refined by iterated
    weighted Kabsch. The draws come from a ``torch.Generator`` seeded by
    ``(seed, pair_id)`` alone, so a pair's result never depends on the pairs
    it is launched with; ``samples`` injects given draws instead.
  - ICP: point-to-plane Gauss-Newton with the JAX package's direction-aware
    convergence stop, run for a whole group of pairs at once: one ``nn1``
    launch and one batched step update per step serve every lane of the
    group, at a fixed lane count (``lanes``, padded with copies), with the
    converged pairs masked, so a pair's transform never depends on the
    pairs it is launched with either.
  - ``icp_point_to_plane`` and ``ransac_global_registration`` are the
    standalone one-pair entry points; on the card they launch ``nn1`` (and
    ``ransac_score``) at every size.

Transforms are 4x4 float32 acting on column vectors. Every f32 product runs
in full f32 (``exact_f32_products``): TF32 keeps ~3 digits, the JAX package
pins Precision.HIGHEST on the same products.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["RegistrationResult", "exact_f32_products", "transform_points", "compose",
           "kabsch", "fpfh_features", "pair_generator", "icp_point_to_plane",
           "ransac_global_registration", "register_pairs"]


class RegistrationResult(NamedTuple):
    transform: torch.Tensor  # [4, 4]
    fitness: torch.Tensor    # inlier fraction of the valid source points
    rmse: torch.Tensor       # inlier RMSE


def exact_f32_products() -> None:
    """Full-f32 matrix products and convolutions on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=torch.float32, device=device)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """pts [..., N, 3] -> R pts + t for T [..., 4, 4]."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Transform equivalent to applying b, then a."""
    return a @ b


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [.., 3] axis-angle -> [.., 3, 3] rotation."""
    theta = torch.sqrt((w * w).sum(-1, keepdim=True) + 1e-24)[..., None]
    k = _skew(w / theta[..., 0])
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(theta) * k + (1 - torch.cos(theta)) * (k @ k)


def kabsch(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """Least-squares rigid transform aligning p -> q ([.., M, 3], optional
    weights [.., M]) -> [.., 4, 4]; the SVD's rotation polished by two
    Newton-Schulz sweeps."""
    if w is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    ws = torch.clamp_min(w.sum(-1, keepdim=True), 1e-12)
    cp = (p * w[..., None]).sum(-2) / ws
    cq = (q * w[..., None]).sum(-2) / ws
    pc = (p - cp[..., None, :]) * w[..., None]
    qc = q - cq[..., None, :]
    h = pc.transpose(-1, -2) @ qc
    u, _, vt = torch.linalg.svd(h)
    v, ut = vt.transpose(-1, -2), u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    r = (v * d[..., None, :]) @ ut
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    for _ in range(2):
        r = 0.5 * (r @ (3.0 * eye3 - r.transpose(-1, -2) @ r))
    t = cq - (r @ cp[..., None])[..., 0]
    out = torch.zeros(r.shape[:-2] + (4, 4), dtype=r.dtype, device=r.device)
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def _nn1_dispatch(cur: torch.Tensor, dst_parked: torch.Tensor):
    """1-NN of cur [P, N, 3] in dst [P, M, 3] (invalid rows parked at FAR):
    the nn1 kernel on CUDA, its plain version on the CPU. The distances are
    exact differences, what the JAX package reports after its exact_d2
    recompute."""
    return kernels.nn1(cur.contiguous(), dst_parked.contiguous())


def _park(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[..., None], pts, _f32(knnlib.FAR, pts.device))


# ---------------------------------------------------------------------------
# Point-to-plane ICP
# ---------------------------------------------------------------------------

def _icp_step_update(T, cur, q, nrm, ok, nv):
    """One Gauss-Newton step of the 6x6 point-to-plane normal equations,
    batched over a leading pair axis."""
    w = ok.to(torch.float32)
    r = ((cur - q) * nrm).sum(-1)
    jac = torch.cat([torch.linalg.cross(cur, nrm, dim=-1), nrm], -1)     # [P, N, 6]
    a = (jac * w[..., None]).transpose(-1, -2) @ jac
    b = -(jac * (w * r)[..., None]).sum(-2)
    eye6 = torch.eye(6, dtype=a.dtype, device=a.device)
    x = torch.linalg.solve(a + 1e-6 * eye6, b)
    dT = torch.eye(4, dtype=T.dtype, device=T.device).repeat(T.shape[0], 1, 1)
    dT[:, :3, :3] = _exp_so3(x[:, :3])
    dT[:, :3, 3] = x[:, 3:]
    rmse = torch.sqrt((w * r * r).sum(-1) / torch.clamp_min(w.sum(-1), 1.0))
    fitness = w.sum(-1) / nv
    return compose(dT, T), fitness, rmse


def _icp_core(src, src_valid, dst_pts, dst_valid, dst_normals, T0, max_dist,
              iters: int, lanes: int | None = None):
    """Convergence-stopped point-to-plane ICP for P pairs ([P, N, 3] ...):
    at most ``iters`` steps a pair, Open3D's criteria with the JAX package's
    direction-aware rmse leg (a step that neither improved rmse beyond 1e-6
    nor left the 2e-3 * rmse noise band, with fitness unchanged, ends the
    pair). Pairs stop independently. Every step runs over all the lanes,
    ``max(P, lanes)`` of them (the last pair copied into the extra ones),
    and a converged lane keeps its state under a mask: on the card the
    batched products, reductions and solves choose their schedule by the
    batch's shape, so a shrinking active set, or another group size, would
    round a pair by its group mates. At one lane count a pair gives the
    same bits in any group, or alone. Returns (T [P, 4, 4], fitness [P],
    rmse [P]) of the last step, as the JAX while_loop does."""
    dev = src.device
    p = src.shape[0]
    n_lanes = max(p, int(lanes or p))
    if n_lanes > p:
        pad = torch.tensor(list(range(p)) + [p - 1] * (n_lanes - p), device=dev)
        src, src_valid, dst_pts, dst_valid, dst_normals, T0 = (
            x.index_select(0, pad)
            for x in (src, src_valid, dst_pts, dst_valid, dst_normals, T0))
    nv = torch.clamp_min(src_valid.sum(-1).to(torch.float32), 1.0)
    dst_parked = _park(dst_pts, dst_valid)
    md2 = _f32(max_dist, dev) * _f32(max_dist, dev)
    T = T0.to(torch.float32).clone()
    neg1 = torch.full((n_lanes,), -1.0, dtype=torch.float32, device=dev)
    pf, pr, fit, rmse = neg1.clone(), neg1.clone(), neg1.clone(), neg1.clone()
    it = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    active = torch.full((n_lanes,), iters > 0, dtype=torch.bool, device=dev)
    while bool(active.any()):
        cur = transform_points(T, src)
        j, d2 = _nn1_dispatch(cur, dst_parked)
        jj = j.long()[..., None].expand(-1, -1, 3)
        q = torch.gather(dst_pts, 1, jj)
        nrm = torch.gather(dst_normals, 1, jj)
        ok = src_valid & (d2 <= md2) & torch.isfinite(d2)
        T_new, f_new, r_new = _icp_step_update(T, cur, q, nrm, ok, nv)
        pf, pr = torch.where(active, fit, pf), torch.where(active, rmse, pr)
        fit, rmse = torch.where(active, f_new, fit), torch.where(active, r_new, rmse)
        T = torch.where(active[:, None, None], T_new, T)
        it = it + active.to(torch.int32)
        tol_r = torch.clamp_min(2e-3 * rmse, 1e-6)
        moved = ((fit - pf).abs() > 1e-6) | ((pr - rmse) > 1e-6) \
            | ((rmse - pr).abs() > tol_r)
        active = active & (it < iters) & ((it == 0) | moved)
    return T[:p], fit[:p], rmse[:p]


def _as(x, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                           dtype=dtype).to(dev)


def _valid_or_all(valid, n: int, dev) -> torch.Tensor:
    if valid is None:
        return torch.ones(n, dtype=torch.bool, device=dev)
    return _as(valid, torch.bool, dev)


def icp_point_to_plane(src_pts, src_valid, dst_pts, dst_valid, dst_normals,
                       init_transform=None, max_dist: float = 4.5, iters: int = 30,
                       device=None) -> RegistrationResult:
    """Point-to-plane ICP of src onto dst on ``device`` (None -> cuda): up
    to ``iters`` Gauss-Newton steps, stopped by the merge's convergence
    criteria (``_icp_core``, the JAX package's accelerator arms). The 1-NN
    of every step is the ``nn1`` kernel at any dst size on the card (the
    JAX package's 131,072-row gate guards Mosaic's VMEM, which the card
    does not have), its plain version on the CPU. ``*_valid`` None means
    every row."""
    dev = resolve_device(device)
    exact_f32_products()
    src = _as(src_pts, torch.float32, dev)
    dst = _as(dst_pts, torch.float32, dev)
    T0 = (torch.eye(4, dtype=torch.float32, device=dev) if init_transform is None
          else _as(init_transform, torch.float32, dev))
    T, fit, rmse = _icp_core(src[None], _valid_or_all(src_valid, src.shape[0], dev)[None],
                             dst[None], _valid_or_all(dst_valid, dst.shape[0], dev)[None],
                             _as(dst_normals, torch.float32, dev)[None], T0[None],
                             max_dist, iters)
    return RegistrationResult(T[0], fit[0], rmse[0])


# ---------------------------------------------------------------------------
# FPFH features
# ---------------------------------------------------------------------------

def _fpfh(points, normals, valid, idx, d2, radius, k: int):
    """FPFH [N, 33] from a fixed-k neighbourhood: Darboux-frame angles
    (alpha, phi, theta) of each neighbour pair in 3 x 11 bins (SPFH),
    then FPFH_i = SPFH_i + sum_j w_j SPFH_j / sum_j w_j with w = 1/d."""
    idx = idx[:, :k].long()
    d2 = d2[:, :k]
    r32 = _f32(radius, points.device)
    nb_ok = (d2 <= r32 * r32) & valid[idx] & valid[:, None] & (d2 > 0)
    q = points[idx]
    u = normals[:, None, :].expand_as(q)
    nrm_q = normals[idx]
    dn = (q - points[:, None, :]) / torch.sqrt(torch.clamp_min(d2, 1e-20))[..., None]
    v = torch.linalg.cross(dn, u, dim=-1)
    v_n = v / torch.clamp_min(torch.sqrt((v * v).sum(-1, keepdim=True)), 1e-12)
    w = torch.linalg.cross(u, v_n, dim=-1)
    alpha = (v_n * nrm_q).sum(-1)
    phi = (u * dn).sum(-1)
    theta = torch.atan2((w * nrm_q).sum(-1), (u * nrm_q).sum(-1))
    okf = nb_ok.to(torch.float32)

    def hist11(x, lo, hi):
        b = torch.clamp(((x - lo) / (hi - lo) * 11).to(torch.int32), 0, 10).long()
        oh = torch.nn.functional.one_hot(b, 11).to(torch.float32)
        return (oh * okf[..., None]).sum(1)

    spfh = torch.cat([hist11(alpha, -1.0, 1.0), hist11(phi, -1.0, 1.0),
                      hist11(theta, -np.pi, np.pi)], dim=-1)
    spfh = spfh / torch.clamp_min(okf.sum(-1, keepdim=True), 1.0)
    wgt = torch.where(nb_ok, 1.0 / torch.sqrt(torch.clamp_min(d2, 1e-12)),
                      torch.zeros((), device=d2.device))
    wsum = torch.clamp_min(wgt.sum(-1, keepdim=True), 1e-12)
    fpfh = spfh + (spfh[idx] * wgt[..., None]).sum(1) / wsum
    return torch.where(valid[:, None], fpfh, torch.zeros((), device=fpfh.device))


def fpfh_features(points, normals, valid, radius: float, k: int = 64,
                  idx_d2=None) -> torch.Tensor:
    """FPFH [N, 33] over a radius-bounded k-neighbourhood; ``idx_d2``:
    precomputed ascending (idx [N, >=k], d2 [N, >=k])."""
    idx, d2 = idx_d2 if idx_d2 is not None else knnlib.knn(points, valid, k)
    return _fpfh(points.to(torch.float32), normals.to(torch.float32), valid,
                 idx, d2, radius, k)


# ---------------------------------------------------------------------------
# Global registration: feature matching + batched RANSAC
# ---------------------------------------------------------------------------

def _bf16_products(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """a @ bt of bf16 inputs with f32 output: on the card one bf16 GEMM on
    the tensor cores (f32 accumulation, f32 result); on the CPU the inputs
    widened and multiplied in f32. Products of bf16 values are exact in
    f32, so the two differ only in the order of the sums."""
    if a.is_cuda:
        return torch.mm(a, bt, out_dtype=torch.float32)
    return a.to(torch.float32) @ bt.to(torch.float32)


def _feature_correspondences(sf, df, sv, dv, mutual: bool, block: int = 2048,
                             feat_bf16: bool = False):
    """Nearest-feature correspondences src -> dst over dense feature-distance
    blocks of ``block`` source rows. With ``mutual`` a correspondence
    survives only if its dst point's nearest valid src feature points back,
    unless that leaves fewer than 10 (then the one-directional set).
    ``feat_bf16``: the cross product on bf16-rounded features with f32
    output (``_bf16_products``); the norms stay f32, as in the JAX
    package, and near-tied correspondences may differ from the f32 ones."""
    ns = sf.shape[0]
    dev = sf.device
    inf = torch.tensor(float("inf"), device=dev)
    df2 = (df * df).sum(-1)
    dft = df.to(torch.bfloat16).T if feat_bf16 else df.T
    corr_j = torch.empty(ns, dtype=torch.int64, device=dev)
    bmin = torch.full((df.shape[0],), float("inf"), device=dev)
    barg = torch.zeros(df.shape[0], dtype=torch.int64, device=dev)
    for s in range(0, ns, block):
        f, v = sf[s:s + block], sv[s:s + block]
        cross = _bf16_products(f.to(torch.bfloat16), dft) if feat_bf16 else f @ dft
        d2 = (f * f).sum(-1, keepdim=True) + df2[None, :] - 2.0 * cross
        d2 = torch.where(dv[None, :], d2, inf)
        corr_j[s:s + block] = torch.argmin(d2, dim=1)
        cmin, carg = torch.where(v[:, None], d2, inf).min(dim=0)
        better = cmin < bmin
        bmin = torch.where(better, cmin, bmin)
        barg = torch.where(better, carg + s, barg)
    corr_ok = sv
    if mutual:
        ok_mut = corr_ok & (barg[corr_j] == torch.arange(ns, device=dev))
        corr_ok = torch.where(ok_mut.sum() >= 10, ok_mut, corr_ok)
    return corr_j, corr_ok


def pair_generator(seed: int, pair_id: int) -> torch.Generator:
    """The RANSAC draws' generator: a pure function of (seed, pair id)."""
    state = np.random.SeedSequence([int(seed), int(pair_id)]).generate_state(2)
    g = torch.Generator()
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


def _draw_samples(corr_ok: torch.Tensor, trials: int,
                  generator: torch.Generator) -> torch.Tensor:
    """[trials, 3] correspondence indices, with replacement, uniform over
    the live correspondences (drawn on the host: the same draws on every
    device)."""
    probs = corr_ok.detach().to("cpu", torch.float64)
    if probs.sum() == 0:
        probs = torch.ones_like(probs)
    return torch.multinomial(probs, trials * 3, replacement=True,
                             generator=generator).view(trials, 3)


def _edges(x):
    def nrm(a):
        return torch.sqrt((a * a).sum(-1))
    return torch.stack([nrm(x[:, 0] - x[:, 1]), nrm(x[:, 1] - x[:, 2]),
                        nrm(x[:, 0] - x[:, 2])], -1)


def _ransac_rows(R9, tt, t2, Rt, src_c, cs9, dst_cc):
    """The scoring kernel's rows from the JAX ``ransac_score`` arguments:
    H [T, 16] = [R^T t, -R9, -t, t^2/2] and P [N, 16] = [s, c (x) s, c, 1],
    so that |R s + t - c|^2 = sc + 2 H.P (pallas_kernels.py ransac_score)."""
    f32 = torch.float32
    hm = torch.cat([Rt.to(f32), -R9.to(f32), -tt.to(f32),
                    0.5 * t2.to(f32)[:, None]], dim=1).contiguous()
    pm = torch.cat([src_c.to(f32), cs9.to(f32), dst_cc.to(f32),
                    torch.ones_like(src_c[:, :1], dtype=f32)], dim=1).contiguous()
    return hm, pm


def _score_args(src, dst_c, corr_ok, T):
    """kernels.ransac_score's inputs (hm, pm, sc) for hypotheses T [T, 4, 4]:
    both clouds centered on the live correspondences' means, so the
    expansion of |R s + t - c|^2 cancels at ~|coord - mean|^2 * eps instead
    of at the rig's working distance."""
    wv = corr_ok.to(torch.float32)
    n_ok = torch.clamp_min(corr_ok.sum(), 1).to(torch.float32)
    mu_s = (wv @ src) / n_ok
    mu_c = (wv @ dst_c) / n_ok
    src_c = src - mu_s
    dst_cc = dst_c - mu_c
    cs9 = (dst_cc[:, :, None] * src_c[:, None, :]).reshape(-1, 9)
    R = T[:, :3, :3]
    tt = T[:, :3, 3] - mu_c[None, :] + (R @ mu_s)
    Rt = (R.transpose(-1, -2) @ tt[..., None])[..., 0]
    sc = torch.where(corr_ok, (src_c * src_c).sum(-1) + (dst_cc * dst_cc).sum(-1),
                     torch.tensor(float("inf"), device=src.device))
    hm, pm = _ransac_rows(R.reshape(-1, 9), tt, (tt * tt).sum(-1), Rt, src_c, cs9, dst_cc)
    return hm, pm, sc.contiguous()


def _ransac_core(src, src_valid, dst, dst_valid, corr_j, corr_ok, max_dist,
                 edge_sim, *, trials: int, refine_iters: int, samples=None,
                 generator: torch.Generator | None = None):
    """Batched-hypothesis RANSAC + iterated weighted-Kabsch refine for one
    pair. ``samples`` [trials, 3] correspondence indices (else drawn from
    ``generator``). Fitness and rmse follow Open3D: nearest neighbours of
    ALL valid transformed source points within max_dist."""
    dev = src.device
    if samples is None:
        if generator is None:
            raise ValueError("_ransac_core: give samples or a seeded generator")
        samples = _draw_samples(corr_ok, trials, generator)
    samp = (samples if isinstance(samples, torch.Tensor)
            else torch.from_numpy(np.array(samples))).to(dev).long()
    corr_j = corr_j.long()
    md2 = _f32(max_dist, dev) * _f32(max_dist, dev)
    dst_c = dst[corr_j]
    p, q = src[samp], dst_c[samp]                                  # [T, 3, 3]
    ep, eq = _edges(p), _edges(q)
    ratio = torch.minimum(ep, eq) / torch.clamp_min(torch.maximum(ep, eq), 1e-9)
    edge_pass = (ratio > _f32(edge_sim, dev)).all(-1)
    T = kabsch(p, q)
    moved_s = transform_points(T, p)
    dist_pass = (((moved_s - q) ** 2).sum(-1) <= md2).all(-1)

    counts = kernels.ransac_score(*_score_args(src, dst_c, corr_ok, T), float(md2))
    scores = torch.where(edge_pass & dist_pass, counts, torch.full_like(counts, -1))
    best = torch.argmax(scores)
    d2_b = ((transform_points(T[best], src) - dst_c) ** 2).sum(-1)
    w = ((d2_b <= md2) & corr_ok).to(torch.float32)
    for _ in range(max(int(refine_iters), 1)):
        T_ref = kabsch(src, dst_c, w)
        d2r = ((transform_points(T_ref, src) - dst_c) ** 2).sum(-1)
        inl_r = (d2r <= md2) & corr_ok
        w = torch.where(inl_r.any(), inl_r.to(torch.float32), w)
    _, d2n = _nn1_dispatch(transform_points(T_ref, src)[None],
                           _park(dst, dst_valid)[None])
    d2n = d2n[0]
    inl_n = src_valid & (d2n <= md2) & torch.isfinite(d2n)
    nv = torch.clamp_min(src_valid.sum().to(torch.float32), 1.0)
    fitness = inl_n.sum() / nv
    rmse = torch.sqrt(torch.where(inl_n, d2n, torch.zeros((), device=dev)).sum()
                      / torch.clamp_min(inl_n.sum(), 1))
    return T_ref, fitness, rmse


def ransac_global_registration(src_pts, src_feat, src_valid, dst_pts, dst_feat, dst_valid,
                               max_dist: float, trials: int = 4096, edge_sim: float = 0.9,
                               seed: int = 0, mutual: bool = True, refine_iters: int = 3,
                               feat_bf16: bool | None = None, samples=None,
                               device=None) -> RegistrationResult:
    """Feature-matched RANSAC alignment of one pair on ``device`` (None ->
    cuda): FPFH nearest-feature correspondences with the mutual filter,
    ``trials`` three-point hypotheses scored at once (the ``ransac_score``
    kernel on the card), the edge-length and distance checkers, the
    iterated inlier refine, and Open3D's fitness over every valid source
    point (``nn1``). The draws come from ``pair_generator(seed, 0)``;
    ``samples`` [trials, 3] gives them instead. ``feat_bf16`` True takes
    the bf16 feature product; None or False keeps f32."""
    dev = resolve_device(device)
    exact_f32_products()
    src = _as(src_pts, torch.float32, dev)
    dst = _as(dst_pts, torch.float32, dev)
    sv = _valid_or_all(src_valid, src.shape[0], dev)
    dv = _valid_or_all(dst_valid, dst.shape[0], dev)
    corr_j, corr_ok = _feature_correspondences(
        _as(src_feat, torch.float32, dev), _as(dst_feat, torch.float32, dev), sv, dv,
        mutual, feat_bf16=bool(feat_bf16))
    T, fit, rmse = _ransac_core(
        src, sv, dst, dv, corr_j, corr_ok, max_dist, edge_sim, trials=trials,
        refine_iters=refine_iters, samples=samples,
        generator=None if samples is not None else pair_generator(seed, 0))
    return RegistrationResult(T, fit, rmse)


# ---------------------------------------------------------------------------
# A group of pairs: RANSAC per pair, ICP for all at once
# ---------------------------------------------------------------------------

def register_pairs(src_pts, src_valid, src_feat, dst_pts, dst_valid, dst_feat,
                   dst_normals, max_dist: float, icp_max_dist: float,
                   trials: int = 4096, icp_iters: int = 30,
                   edge_sim: float = 0.9, seed: int = 0, mutual: bool = True,
                   refine_iters: int = 3, pair_ids=None, samples=None,
                   feat_bf16: bool | None = None, icp_lanes: int | None = None):
    """Register P independent (src, dst) pairs: FPFH correspondences +
    RANSAC global init per pair, then point-to-plane ICP for the group.
    Arrays share one padded shape: src_pts [P, N, 3], src_valid [P, N],
    src_feat [P, N, 33], dst_* likewise, dst_normals [P, M, 3]. ``pair_ids``
    [P] seed each pair's draws (default 0..P-1); ``samples`` optional
    [P, trials, 3] draws to use instead; ``feat_bf16`` True takes the bf16
    feature product (None or False: f32); ``icp_lanes`` the ICP's lane
    count when it is more than P (``_icp_core``). Returns (T [P, 4, 4], global
    fitness [P], icp fitness [P], icp rmse [P]) as tensors."""
    exact_f32_products()
    p = src_pts.shape[0]
    ids = list(range(p)) if pair_ids is None else [int(i) for i in pair_ids]
    T0, gfit = [], []
    for i in range(p):
        corr_j, corr_ok = _feature_correspondences(src_feat[i], dst_feat[i],
                                                   src_valid[i], dst_valid[i], mutual,
                                                   feat_bf16=bool(feat_bf16))
        smp = None if samples is None else samples[i]
        T_i, gf_i, _ = _ransac_core(
            src_pts[i], src_valid[i], dst_pts[i], dst_valid[i], corr_j, corr_ok,
            max_dist, edge_sim, trials=trials, refine_iters=refine_iters,
            samples=smp, generator=None if smp is not None else pair_generator(seed, ids[i]))
        T0.append(T_i)
        gfit.append(gf_i)
    T, fit, rmse = _icp_core(src_pts, src_valid, dst_pts, dst_valid, dst_normals,
                             torch.stack(T0), icp_max_dist, icp_iters, lanes=icp_lanes)
    return T, torch.stack(gfit), fit, rmse
