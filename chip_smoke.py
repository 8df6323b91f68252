#!/usr/bin/env python3
"""On-card check of the PyTorch + CUDA port: the scan and merge paths.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); builds the kernels from
``structured_light_for_3d_model_replication_tpu_torch/ops/csrc`` first.
Imports nothing of JAX. Phases, each of which exits non-zero on failure:

1. the card (``nvidia-smi`` name and power limit) and the kernels' build time;
2. kernels at full geometry: a 1920x1080 camera and projector scene
   (``utils/synthetic.sphere_on_background``), 46 frames, V = 8 views made
   from one render with per-view seeded noise. Each kernel is held against
   its plain PyTorch version on the same card tensors — decode maps and
   masks bit-equal (and the packed decode equal to the raw one), the fused
   kernel with at most 2e-3 of valid flags flipped, |dp| < 1e-2 mm where
   both are valid and the texture equal — and timed with CUDA events
   (warm, median); decoded points are held against the renderer's ground
   truth (median error < 1.5 mm, 99th percentile < 5 mm);
3. the main path: ``reconstruct(mode="batch", compute_batch=4)`` over 8
   views written as .slbp containers, once per arm — plane_eval=table
   (decode kernel), plane_eval=quadratic (fused kernel), packed ingest
   (packed decode kernel). Launch counts are zeroed before each arm and must
   rise for that arm's kernel; the packed arm's PLYs must equal the table
   arm's byte for byte;
4. merge kernels at the merge path's shapes, on the flagship merge scene
   (``utils/synthetic.three_spheres``: 24 turntable views 15 degrees apart
   about (0, 0, 400), a 480x360 camera, a 512x256 projector, rendered once,
   reconstructed by the port's ``reconstruct`` into per-view PLYs): nn1 on
   the ICP group's [4, bucket] preps and at chamfer size (the merged cloud
   after the 0.5 mm voxel against a jittered copy), ransac_score on pair
   1 -> 0's 4096 hypotheses, knn_mean on 32768 rows of the merged cloud,
   slab_mean_knn on the whole sorted merged cloud (tile 64, wblk 8192).
   nn1 and ransac_score must equal their plain versions exactly, the k-NN
   means match counts exactly and means within rtol 1e-5 (sum order);
5. the merge path: ``merge_views`` over the 24 PLYs with the default
   ``Config()`` (4096 trials), three times (cold, warm, warm under
   torch.profiler). Launch counts zeroed before each run, read after: nn1,
   ransac_score and slab_mean_knn must each have launched. The merged
   points are held against the true sphere surfaces at 1.5x the JAX
   package's errors on the same views (this scene's poses drift in both
   packages and are printed, not gated). A second arm with a 1.5 mm final
   voxel (merged cloud <= 32768 points) must launch knn_mean and not
   slab_mean_knn. A third, the pose scene (``synthetic.lumpy_views`` at the
   same 24 poses, a surface that registers), holds the recovered transforms
   against the true turntable poses at 1.5x the JAX package's errors.

Then one ``{"kernels": [...]}`` JSON line (times from phases 2 and 4,
bounds from this run's shapes, and each kernel's launches from one run of
the main path, named in ``launches_run``: its own arm of phase 3, the cold
flagship merge, or for knn_mean the small arm) and, last, the
``{"ok": true, "device": ...}`` line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

V = 8                 # views per kernel launch in phase 2
CAM = PROJ = (1920, 1080)
MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
OPS_PER_S = 67e12           # H100 SXM 32-bit non-tensor rate
RECON_VIEWS = 8
RECON_BATCH = 4
SOURCE = "structured_light_for_3d_model_replication_tpu_torch/ops/csrc/decode.cu"
CLOUD_SOURCE = "structured_light_for_3d_model_replication_tpu_torch/ops/csrc/cloud.cu"
PALLAS = "structured_light_for_3d_model_replication_tpu/ops/pallas_kernels.py"
MERGE_VIEWS, MERGE_STEP = 24, 15.0
MERGE_PIVOT = (0.0, 0.0, 400.0)
MERGE_CAM, MERGE_PROJ = (480, 360), (512, 256)
SMALL_FINAL_VOXEL = 1.5     # coarse enough for a merged cloud <= 32768 points
# Ground-truth gates: 1.5x the errors of the JAX package's merge_360 on the
# same views, run on the CPU by tools/torch_merge_reference.py (PERF.md
# section 5). The flagship scene is feature-poor (the 70 mm sphere fills
# every view) and both packages' chained poses drift far on it, so it is
# gated on the merged points' distance to the true surfaces only; the poses
# are gated on the lumpy pose scene, which registers.
FLAGSHIP_JAX = {"surf_median_mm": 0.32119189678192406, "surf_p99_mm": 36.932940099747526}
POSE_JAX = {"rot_max_deg": 0.14608264300570387, "trans_max_mm": 0.952752147717066,
            "rot_median_deg": 0.10449975284444288, "trans_median_mm": 0.6840317819437964}
GATE = 1.5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def clocks() -> str:
    """SM clock (now and max), power draw and temperature: compute-bound
    kernel times follow the SM clock, which a card may lower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time for the work on this card: bytes over the memory rate or
    operations over the 32-bit rate, the larger (ms)."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def render_views(rng_seed: int = 0):
    """One 1080p render, V views by per-view seeded noise in [-8, 8]."""
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    rig = syn.default_rig(cam_size=CAM, proj_size=PROJ)
    base, gt = syn.render_scene(rig, syn.sphere_on_background())
    views = []
    for v in range(V):
        noise = np.random.default_rng(rng_seed + v).integers(
            -8, 9, base.shape, dtype=np.int8)
        views.append(np.clip(base.astype(np.int16) + noise, 0, 255).astype(np.uint8))
    return rig, np.ascontiguousarray(np.stack(views)), gt


def kernel_phase(dev, rig, frames_np, gt):
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.models.scanner import (
        SLScanner,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        graycode as gc,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

    v, f, h, w = frames_np.shape
    hw = h * w
    frames = torch.from_numpy(frames_np).to(dev)
    thr = torch.tensor([[40.0 + i, 10.0 + (i % 3)] for i in range(v)],
                       dtype=torch.float32, device=dev)
    plan = gc.decode_plan(f, n_cols=PROJ[0], n_rows=PROJ[1], n_sets_col=11,
                          n_sets_row=11, downsample=1)
    kw = plan._asdict()
    n_bits = plan.n_use_col + plan.n_use_row
    rows = []

    # K1: raw decode
    k1 = kernels.decode_maps(frames, thr, **kw)
    p1 = kernels.decode_maps_plain(frames, thr, **kw)
    torch.cuda.synchronize()
    err1 = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(k1, p1))
    check(err1 == 0, f"decode_maps differs from its plain version (max {err1})")
    lit = torch.from_numpy(gt["lit"]).to(dev) & k1[2][0]
    exact = ((k1[0][0] == torch.from_numpy(gt["proj_col"]).to(dev))
             & (k1[1][0] == torch.from_numpy(gt["proj_row"]).to(dev)) & lit)
    gt_share = float(exact.sum()) / max(1, int(lit.sum()))
    nbytes = v * f * hw + thr.numel() * 4 + v * hw * 9
    rows.append(dict(
        name="decode_maps", fn=lambda: kernels.decode_maps(frames, thr, **kw),
        plain=lambda: kernels.decode_maps_plain(frames, thr, **kw),
        err=err1, bound=bound(nbytes, v * hw * (4 + 4 * n_bits + 4)),
        extra={"gt_exact_share_of_lit": gt_share}))

    # K2: packed decode, from host-packed containers of the same views
    stacks = [imio.pack_stack(frames_np[i]) for i in range(v)]
    planes = torch.from_numpy(np.stack([s.planes for s in stacks])).to(dev)
    white = torch.from_numpy(np.stack([s.white for s in stacks])).to(dev)
    black = torch.from_numpy(np.stack([s.black for s in stacks])).to(dev)
    pkw = dict(kw, n_pairs=stacks[0].n_pairs)
    k2 = kernels.decode_packed_maps(planes, white, black, thr, **pkw)
    p2 = kernels.decode_packed_maps_plain(planes, white, black, thr, **pkw)
    torch.cuda.synchronize()
    err2 = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(k2, p2))
    check(err2 == 0, f"decode_packed_maps differs from its plain version (max {err2})")
    check(all(bool(torch.equal(a, b)) for a, b in zip(k2, k1)),
          "decode_packed_maps differs from decode_maps on the same scene")
    pb = planes.shape[1]
    nbytes = v * (pb + 2) * hw + thr.numel() * 4 + v * hw * 9
    rows.append(dict(
        name="decode_packed_maps",
        fn=lambda: kernels.decode_packed_maps(planes, white, black, thr, **pkw),
        plain=lambda: kernels.decode_packed_maps_plain(planes, white, black, thr, **pkw),
        err=err2, bound=bound(nbytes, v * hw * (2 + 3 * n_bits + 4)), extra={}))

    # K3: fused decode + quadratic triangulate, row_mode 1
    sc = SLScanner(rig.calibration(), CAM, PROJ, row_mode=1,
                   plane_eval="quadratic", device=dev)
    scalars = kernels.scan_scalars(sc.oc, sc.poly_col, sc.poly_row, sc.epipolar_tol)
    fkw = dict(kw, n_cols=PROJ[0], n_rows=PROJ[1], row_mode=1)
    k3 = kernels.scan_fused(frames, thr, scalars, sc.rays, **fkw)
    p3 = kernels.scan_fused_plain(frames, thr, scalars, sc.rays, **fkw)
    torch.cuda.synchronize()
    flip = float((k3[1] != p3[1]).float().mean())
    both = k3[1] & p3[1]
    err3 = float((k3[0] - p3[0]).abs()[both].max())
    check(flip < 2e-3, f"scan_fused valid flips {flip} >= 2e-3")
    check(err3 < 1e-2, f"scan_fused max |dp| {err3} mm >= 1e-2")
    check(bool(torch.equal(k3[2], p3[2])), "scan_fused texture differs")
    gt_pts = torch.from_numpy(gt["points"].reshape(-1, 3).astype(np.float32)).to(dev)
    keep = k3[1][0] & torch.from_numpy(gt["lit"].reshape(-1)).to(dev)
    gerr = (k3[0][0][keep] - gt_pts[keep]).norm(dim=-1).cpu().numpy()
    check(gerr.size > 0.1 * hw, f"only {gerr.size} valid lit points")
    check(np.median(gerr) < 1.5 and np.percentile(gerr, 99) < 5.0,
          f"points vs ground truth: median {np.median(gerr)}, "
          f"p99 {np.percentile(gerr, 99)} mm")
    # per pixel: decode, 2 x (quadratic + normalize: ~26), hit ~15, dist ~8
    nbytes = v * f * hw + thr.numel() * 4 + 32 * 4 + hw * 12 + v * hw * 14
    rows.append(dict(
        name="scan_fused",
        fn=lambda: kernels.scan_fused(frames, thr, scalars, sc.rays, **fkw),
        plain=lambda: kernels.scan_fused_plain(frames, thr, scalars, sc.rays, **fkw),
        err=err3, bound=bound(nbytes, v * hw * (4 + 4 * n_bits + 75)),
        extra={"valid_flip_share": flip, "valid_points_view0": int(k3[1][0].sum()),
               "gt_err_median_mm": float(np.median(gerr)),
               "gt_err_p99_mm": float(np.percentile(gerr, 99))}))

    # the one-pixel-a-thread instantiations, taken when a buffer is not
    # 16-byte aligned: held against the 4-pixel ones above on view 0
    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:]
        return buf.view(t.shape).copy_(t)

    u1 = kernels.decode_maps(unaligned(frames[:1]), thr[:1], **kw)
    u2 = kernels.decode_packed_maps(unaligned(planes[:1]), white[:1], black[:1],
                                    thr[:1], **pkw)
    u3 = kernels.scan_fused(unaligned(frames[:1]), thr[:1], scalars, sc.rays, **fkw)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(a, b[:1])) for a, b in zip(u1, k1)),
          "decode_maps: unaligned (1 pixel a thread) differs from aligned")
    check(all(bool(torch.equal(a, b[:1])) for a, b in zip(u2, k2)),
          "decode_packed_maps: unaligned differs from aligned")
    both = u3[1] & k3[1][:1]
    check(float((u3[1] != k3[1][:1]).float().mean()) < 2e-3
          and float((u3[0] - k3[0][:1]).abs()[both].max()) < 1e-2
          and bool(torch.equal(u3[2], k3[2][:1])),
          "scan_fused: unaligned differs from aligned")
    del u1, u2, u3, both

    # the pallas_call sites (the views variants, :673 and :1019, are the
    # same kernels with a view grid axis)
    replaces = {"decode_maps": f"{PALLAS}:637", "decode_packed_maps": f"{PALLAS}:987",
                "scan_fused": f"{PALLAS}:823"}
    out = []
    for r in rows:
        ms = time_ms(r["fn"], reps=20)
        plain_ms = time_ms(r["plain"], reps=5, warm=1)
        b_ms, b_by = r["bound"]
        line = {"name": r["name"], "route": "cuda", "source": SOURCE,
                "replaces": replaces[r["name"]], "launches": 0,
                "max_abs_err": r["err"], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "views": v, "shape": [v, f, h, w]}
        print(json.dumps(dict(line, **r["extra"])), flush=True)
        out.append(line)
    del frames, planes, white, black, k1, p1, k2, p2, k3, p3
    torch.cuda.empty_cache()
    return out, stacks


def reconstruct_phase(dev, rig, stacks, card: str) -> dict[str, tuple[int, str]]:
    """Phase 3. Returns each scan kernel's launches in its own arm's run:
    {name: (count, run)}."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile, ply
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    arms = [("table", "decode_maps", {"plane_eval": "table"}, False),
            ("quadratic", "scan_fused", {"plane_eval": "quadratic"}, False),
            ("packed", "decode_packed_maps", {"plane_eval": "table"}, True)]
    launches = {}
    with tempfile.TemporaryDirectory(prefix="slscan_smoke_") as root:
        data = os.path.join(root, "scans")
        calib = os.path.join(root, "calib.npz")
        matfile.save_calibration(calib, rig.calibration())
        for i in range(RECON_VIEWS):
            imio.save_packed_stack(os.path.join(data, f"view_{i * 45:03d}deg"),
                                   stacks[i % len(stacks)])
        outs = {}
        for arm, kernel, tri_kw, packed in arms:
            cfg = Config()
            cfg.decode.n_cols, cfg.decode.n_rows = PROJ
            cfg.parallel.compute_batch = RECON_BATCH
            cfg.pipeline.packed_ingest = packed
            for k, val in tri_kw.items():
                setattr(cfg.triangulate, k, val)
            out_dir = os.path.join(root, f"out_{arm}")
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            report = stages.reconstruct(calib, data, mode="batch", output=out_dir,
                                        cfg=cfg, device=dev, log=lambda m: None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            check(counts[kernel] > 0, f"{arm} arm never launched {kernel}: {counts}")
            check(len(report.outputs) == RECON_VIEWS,
                  f"{arm} arm wrote {len(report.outputs)} of {RECON_VIEWS} views")
            launches[kernel] = (counts[kernel], f"reconstruct, {arm} arm")
            for p in report.outputs:
                cloud = ply.read_ply(p)
                pts = cloud["points"]
                check(pts.shape[0] > 0.05 * CAM[0] * CAM[1] and pts.shape[1] == 3
                      and bool(np.isfinite(pts).all()), f"{arm}: bad cloud {p}")
            outs[arm] = {os.path.basename(p): p for p in report.outputs}
            print(json.dumps({"arm": arm, "kernel": kernel, "launches": counts,
                              "views": len(report.outputs), "wall_s": wall,
                              "views_per_s": len(report.outputs) / wall,
                              "points_per_view": report.points[:2],
                              "lane": report.lane, "card": card}), flush=True)
        for name, p in outs["table"].items():
            with open(p, "rb") as a, open(outs["packed"][name], "rb") as b:
                check(a.read() == b.read(), f"packed PLY {name} differs from table")
            n_t = ply.read_ply(p)["points"].shape[0]
            n_q = ply.read_ply(outs["quadratic"][name])["points"].shape[0]
            check(abs(n_t - n_q) <= 1e-3 * n_t,
                  f"{name}: quadratic {n_q} vs table {n_t} points")
        for packed in (False, True):
            stage_breakdown(dev, data, calib, packed, card)
    return launches


def stage_breakdown(dev, data: str, calib: str, packed: bool, card: str) -> None:
    """Host wall of each step of one batch of the table arm (raw or packed
    ingest), synchronized after each: load (disk + unpack), upload (host ->
    card), forward (thresholds, decode kernel, triangulation), compact
    (mask + card -> host), write (PLY)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile, ply
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        triangulate as tri,
    )
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    sources = sorted(os.path.join(data, d) for d in os.listdir(data))[:RECON_BATCH]
    cfg = Config()
    cfg.decode.n_cols, cfg.decode.n_rows = PROJ
    scanner = stages._build_scanner(sources, matfile.load_calibration(calib), cfg, dev)
    wall = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    if packed:
        ps = step("load", lambda: [imio.load_packed_stack(s) for s in sources])
        planes, white, black = step("upload", lambda: [
            torch.from_numpy(np.stack([getattr(p, k) for p in ps])).to(dev)
            for k in ("planes", "white", "black")])
        cloud = step("forward", lambda: scanner.forward_views_packed(
            planes, white, black, n_frames=ps[0].n_frames))
    else:
        fr = step("load", lambda: [imio.load_stack(s)[0] for s in sources])
        frames = step("upload", lambda: torch.from_numpy(np.stack(fr)).to(dev))
        cloud = step("forward", lambda: scanner.forward_views(frames))
    clouds = step("compact", lambda: [tri.compact_cloud(tri.CloudResult(
        cloud.points[j], cloud.colors[j], cloud.valid[j])) for j in range(len(sources))])
    with tempfile.TemporaryDirectory(prefix="slscan_ply_") as out:
        step("write", lambda: [ply.write_ply(os.path.join(out, f"{j}.ply"), *c)
                               for j, c in enumerate(clouds)])
    total = sum(wall.values())
    print(json.dumps({"breakdown": "packed" if packed else "table",
                      "views": len(sources), "wall_s": wall, "total_s": total,
                      "views_per_s": len(sources) / total, "card": card}), flush=True)


def render_merge_views(root: str):
    """The flagship merge scene, 24 turntable views rendered once and stored
    as .slbp containers under root/scans, with root/calib.npz. Returns
    (data dir, calib path, poses)."""
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    rig = syn.default_rig(cam_size=MERGE_CAM, proj_size=MERGE_PROJ)
    scene = syn.three_spheres()
    poses = syn.turntable_poses(MERGE_VIEWS, MERGE_STEP, np.array(MERGE_PIVOT))
    data = os.path.join(root, "scans")
    for i, (R, t) in enumerate(poses):
        frames, _ = syn.render_scene(rig, scene.transformed(R, t))
        imio.save_packed_stack(os.path.join(data, f"view_{round(i * MERGE_STEP):03d}deg"),
                               imio.pack_stack(frames))
    calib = os.path.join(root, "calib.npz")
    matfile.save_calibration(calib, rig.calibration())
    return data, calib, poses


def reconstruct_merge_views(dev, data: str, calib: str, out: str) -> str:
    """The port's reconstruct (manual thresholds, row_mode 1) -> one PLY a view."""
    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    cfg = Config()
    cfg.decode.n_cols, cfg.decode.n_rows = MERGE_PROJ
    cfg.decode.thresh_mode = "manual"
    cfg.parallel.compute_batch = 8
    stages.reconstruct(calib, data, mode="batch", output=out, cfg=cfg, device=dev,
                       log=lambda m: None)
    return out


def write_pose_views(root: str):
    """The pose scene: ``synthetic.lumpy_views`` (a lumpy surface of radius
    ~75 mm about the pivot, 65 % of it seen a view, 0.05 mm noise) at the
    flagship's 24 turntable poses, one PLY a view under root/pose_views.
    Returns (ply dir, poses)."""
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    poses = syn.turntable_poses(MERGE_VIEWS, MERGE_STEP, np.array(MERGE_PIVOT))
    out = os.path.join(root, "pose_views")
    os.makedirs(out, exist_ok=True)
    for i, pts in enumerate(syn.lumpy_views(poses, center=MERGE_PIVOT)):
        ply.write_ply(os.path.join(out, f"view_{round(i * MERGE_STEP):03d}deg.ply"),
                      pts, np.full(pts.shape, 128, np.uint8))
    return out, poses


def pose_accuracy(transforms, poses) -> dict:
    """Recovered transforms against the true turntable poses: rotation
    error (degrees) and translation error (mm), largest and median."""
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    rot, trans = syn.pose_errors(transforms, syn.turntable_transforms(poses))
    return {"rot_max_deg": float(rot.max()), "trans_max_mm": float(trans.max()),
            "rot_median_deg": float(np.median(rot)),
            "trans_median_mm": float(np.median(trans))}


def merge_accuracy(transforms, points, poses) -> dict:
    """pose_accuracy, and the merged points' distance to the true sphere
    surfaces of the flagship scene (view 0's frame)."""
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    surf = syn.sphere_surface_distance(points, syn.three_spheres())
    return dict(pose_accuracy(transforms, poses),
                surf_median_mm=float(np.median(surf)),
                surf_p99_mm=float(np.percentile(surf, 99)), points=int(len(points)))


def _read_views(ply_dir: str):
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    paths = stages.sort_ply_paths_by_angle(
        [os.path.join(ply_dir, f) for f in os.listdir(ply_dir) if f.endswith(".ply")])
    return [ply.read_ply(p)["points"] for p in paths]


def merge_kernel_phase(dev, ply_dir: str, poses, card: str) -> list[dict]:
    """Phase 4: each merge kernel against its plain version, at the merge
    path's shapes, timed with CUDA events."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        registration as reg,
    )
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    views = _read_views(ply_dir)
    truth = syn.turntable_transforms(poses)
    voxel = 3.0
    rows = []

    # nn1 at the ICP group's shape: pairs (i -> i-1), i = 1..4, src moved by
    # the true relative pose, dst parked where invalid
    preps = [recon.prep_view(views[i], voxel, device=dev) for i in range(5)]
    bucket = max(p.points.shape[0] for p in preps)
    src, dst = [], []
    for i in range(1, 5):
        sp, _, _, _ = recon._prep_to_bucket(preps[i], bucket)
        dp, dv, _, _ = recon._prep_to_bucket(preps[i - 1], bucket)
        rel = np.linalg.inv(truth[i - 1]) @ truth[i]
        src.append(reg.transform_points(torch.tensor(rel, dtype=torch.float32, device=dev), sp))
        dst.append(reg._park(dp, dv))
    q4, b4 = torch.stack(src).contiguous(), torch.stack(dst).contiguous()

    def nn1_row(name, q, b, reps):
        """Indices and distances must equal the plain version's exactly: the
        same IEEE operations in the same order, ties to the lowest index.
        9 operations a (query, base) pair: 3 sub, 3 mul, 2 add, 1 compare."""
        k_out = kernels.nn1(q, b)
        p_out, plain_ms = _timed_once(lambda: kernels.nn1_plain(q, b))
        torch.cuda.synchronize()
        mism = int((k_out[0] != p_out[0]).sum())
        err = float((k_out[1] - p_out[1]).abs().max())
        check(mism == 0 and err == 0.0,
              f"{name}: {mism} indices and max |dd2| {err} off the plain version")
        nq, nb = q.shape[1], b.shape[1]
        extra = {"case": name, "shape": [q.shape[0], nq, nb]}
        if name == "icp_group":  # a yardstick only: [P, Nq, Nb] fits here, not at chamfer size
            extra["cdist_min_ms"] = time_ms(lambda: torch.cdist(q, b).min(dim=-1), reps=5)
        return dict(name="nn1", fn=lambda: kernels.nn1(q, b), reps=reps, plain_ms=plain_ms,
                    err=err, bound=bound((q.numel() + b.numel()) * 4 + q.shape[0] * nq * 8,
                                         q.shape[0] * nq * nb * 9), extra=extra)

    rows.append(nn1_row("icp_group", q4, b4, reps=20))

    # ransac_score: pair 1 -> 0's hypotheses, built as _ransac_core builds
    # them; 34 operations a (hypothesis, correspondence): 16 mul, 15 add in
    # the dot, the scale, the add of sc and the compare
    sp, sv, _, sf = recon._prep_to_bucket(preps[1], bucket)
    dp, dv, _, df = recon._prep_to_bucket(preps[0], bucket)
    reg.exact_f32_products()
    corr_j, corr_ok = reg._feature_correspondences(sf, df, sv, dv, True)
    samp = reg._draw_samples(corr_ok, 4096, reg.pair_generator(0, 0)).to(dev)
    dst_c = dp[corr_j]
    T = reg.kabsch(sp[samp], dst_c[samp])
    hm, pm, sc = reg._score_args(sp, dst_c, corr_ok, T)
    md2 = float(np.float32(voxel * 1.5) ** 2)
    k_cnt = kernels.ransac_score(hm, pm, sc, md2)
    p_cnt, plain_ms = _timed_once(lambda: kernels.ransac_score_plain(hm, pm, sc, md2))
    err = int((k_cnt - p_cnt).abs().max())
    check(err == 0, f"ransac_score: counts off the plain version by {err}")
    nt, nn = hm.shape[0], pm.shape[0]
    rows.append(dict(name="ransac_score", fn=lambda: kernels.ransac_score(hm, pm, sc, md2),
                     reps=20, plain_ms=plain_ms, err=err,
                     bound=bound(nt * 16 * 4 + nn * 17 * 4 + nt * 4, nt * nn * 34),
                     extra={"shape": [nt, nn], "best_count": int(k_cnt.max())}))

    # the merged cloud at the true poses, after the 0.5 mm voxel
    moved = recon.transform_views_batched(views[1:], truth[1:], device=dev)
    pts = torch.from_numpy(np.concatenate([views[0]] + moved)).to(dev)
    ones = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    p, _, v = pc.voxel_downsample(pts, torch.zeros_like(pts, dtype=torch.uint8), ones, 0.5)
    n_keep = int(v.sum())
    n_pad = min(-(-n_keep // 8192) * 8192, p.shape[0])
    cloud, valid = p[:n_pad].contiguous(), v[:n_pad]
    pts_s, _, r = pc._slab_inputs(cloud, valid, 0.5, 8192)
    L = pts_s.shape[0]
    win = 2 * 8192

    def mean_row(name, k_fn, p_fn, n_q, n_c, extra):
        k_out = k_fn()
        p_out, plain_ms = _timed_once(p_fn)
        torch.cuda.synchronize()
        cnt_err = int((k_out[1] - p_out[1]).abs().max())
        check(cnt_err == 0, f"{name}: counts off the plain version by {cnt_err}")
        if len(k_out) == 3:
            check(bool(torch.equal(k_out[2], p_out[2])), f"{name}: window ends differ")
        ok = k_out[1] >= 20
        rel = ((k_out[0] - p_out[0]).abs() / p_out[0].abs().clamp_min(1e-9))[ok]
        err = float((k_out[0] - p_out[0]).abs()[ok].max())
        check(float(rel.max()) <= 1e-5, f"{name}: mean off by rtol {float(rel.max())}")
        # bytes: the rows once, mean + count (+ window end) out; operations:
        # what the function needs of a (query, candidate) pair, its d2 (3
        # sub, 3 mul, 2 add) and one selection compare, as nn1 (the
        # kernels' 31 bisection passes are their algorithm's cost, not the
        # function's)
        return dict(name=name, fn=k_fn, reps=5, plain_ms=plain_ms, err=err,
                    bound=bound(n_q * 12 + n_q * 4 * len(k_out), n_q * n_c * 9),
                    extra=dict(extra, certified_share=float(ok.float().mean())))

    q32 = pts_s[:32768].contiguous()
    rows.append(mean_row("knn_mean", lambda: kernels.knn_mean(q32, 20),
                         lambda: kernels.knn_mean_plain(q32, 20), 32768, 32768,
                         {"shape": [32768, 3], "k": 20}))
    rows.append(mean_row("slab_mean_knn",
                         lambda: kernels.slab_mean_knn(pts_s, r, 20, tile=64, wblk=8192),
                         lambda: kernels.slab_mean_knn_plain(pts_s, r, 20, 64, 8192),
                         L, win, {"shape": [L, 3], "k": 20, "tile": 64, "wblk": 8192,
                                  "r": r, "merged_after_voxel": n_keep}))

    # nn1 at chamfer size: the merged cloud against a jittered copy of itself
    cq = cloud[valid][None].contiguous()
    jitter = torch.from_numpy(np.random.default_rng(0).normal(
        0.0, 0.05, tuple(cq.shape)).astype(np.float32)).to(dev)
    cb = (cq + jitter).contiguous()
    rows.append(nn1_row("chamfer", cq, cb, reps=3))

    replaces = {"nn1": f"{PALLAS}:442", "ransac_score": f"{PALLAS}:1446",
                "knn_mean": f"{PALLAS}:1337", "slab_mean_knn": f"{PALLAS}:1211"}
    out = []
    for r_ in rows:
        ms = time_ms(r_["fn"], reps=r_["reps"])
        b_ms, b_by = r_["bound"]
        line = {"name": r_["name"], "route": "cuda", "source": CLOUD_SOURCE,
                "replaces": replaces[r_["name"]], "launches": 0,
                "max_abs_err": r_["err"], "ms": ms, "plain_ms": r_["plain_ms"],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        print(json.dumps(dict(line, card=card, clocks=clocks(), **r_["extra"])), flush=True)
        out.append(line)
    del preps, q4, b4, pts, p, cloud, pts_s, cq, cb
    torch.cuda.empty_cache()
    # one line per kernel: nn1's ICP-group case carries the table's numbers
    seen, lines = set(), []
    for line in out:
        if line["name"] not in seen:
            seen.add(line["name"])
            lines.append(line)
    return lines


def _timed_once(fn):
    """One call of fn between CUDA events: (its result, ms)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _device_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _device_busy(prof) -> dict:
    """Device time of a profiled run: the sum of its kernels' device times
    (one stream, so no overlap; the aten ops that launched them are left
    out, they carry the same time again), and the eight largest by name."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return {"busy_ms": sum(r[1] for r in rows) if rows else None,
            "top": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in rows[:8]]}


def merge_phase(dev, ply_dir: str, poses, pose_dir: str, root: str,
                card: str) -> dict[str, tuple[int, str]]:
    """Phase 5: merge_views over the 24 flagship PLYs three times (the
    first run pays one-time costs: scipy's import, CUDA modules loaded on
    first use; the third runs under torch.profiler for the device's busy
    time), the small arm, then the pose scene. Returns {kernel: (launches,
    run)}: nn1, ransac_score and slab_mean_knn as the cold flagship run
    launched them, knn_mean as the small arm did."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    launches = {}
    for arm, views, final_voxel in (("flagship", ply_dir, None),
                                    ("flagship_warm", ply_dir, None),
                                    ("flagship_profiled", ply_dir, None),
                                    ("small", ply_dir, SMALL_FINAL_VOXEL),
                                    ("pose", pose_dir, None)):
        cfg = Config()
        if final_voxel is not None:
            cfg.merge.final_voxel = final_voxel
        tm: dict = {}
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        prof = _device_profile() if arm == "flagship_profiled" else None
        t0 = time.perf_counter()
        if prof is not None:
            prof.__enter__()
        points, colors, transforms = stages.merge_views(
            views, os.path.join(root, f"merged_{arm}.ply"), cfg=cfg, device=dev,
            timings=tm, log=lambda m: None)
        torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        if prof is not None:
            tm["device"] = _device_busy(prof)
        check(points.ndim == 2 and points.shape[1] == 3 and len(points) > 0
              and bool(np.isfinite(points).all()) and len(colors) == len(points),
              f"{arm}: bad merged cloud {points.shape}")
        check(len(transforms) == MERGE_VIEWS, f"{arm}: {len(transforms)} transforms")
        if arm == "pose":
            acc = dict(pose_accuracy(transforms, poses), points=int(len(points)))
            gates = POSE_JAX
        else:
            acc = merge_accuracy(transforms, points, poses)
            gates = FLAGSHIP_JAX
        print(json.dumps({"merge": arm, "wall_s": wall, "timings_s": tm,
                          "launches": counts, "accuracy": acc, "card": card}), flush=True)
        for key, ref in gates.items():
            check(acc[key] <= GATE * ref,
                  f"{arm} merge {key} {acc[key]} > {GATE} x the JAX package's {ref}")
        if arm.startswith("flagship"):
            for k in ("nn1", "ransac_score", "slab_mean_knn"):
                check(counts[k] > 0, f"{arm} merge never launched {k}: {counts}")
        if arm == "flagship":
            for k in ("nn1", "ransac_score", "slab_mean_knn"):
                launches[k] = (counts[k], "merge-360, flagship (cold)")
        if arm == "small":
            check(len(points) <= 32768, f"small arm kept {len(points)} > 32768 points")
            check(counts["knn_mean"] > 0 and counts["slab_mean_knn"] == 0,
                  f"small arm launches {counts}")
            launches["knn_mean"] = (counts["knn_mean"],
                                    f"merge-360, small arm (final voxel {final_voxel})")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a card",
              file=sys.stderr)
        return 2
    from structured_light_for_3d_model_replication_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f}s -> {os.path.relpath(lib)}",
          flush=True)
    t0 = time.perf_counter()
    rig, frames_np, gt = render_views()
    print(f"render: {frames_np.shape} in {time.perf_counter() - t0:.1f}s", flush=True)
    lines, stacks = kernel_phase(dev, rig, frames_np, gt)
    del frames_np
    launches = reconstruct_phase(dev, rig, stacks, card)
    del stacks
    with tempfile.TemporaryDirectory(prefix="slscan_merge_") as root:
        t0 = time.perf_counter()
        data, calib, poses = render_merge_views(root)
        ply_dir = reconstruct_merge_views(dev, data, calib, os.path.join(root, "views"))
        print(f"merge views: {MERGE_VIEWS} rendered and reconstructed in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        pose_dir, _ = write_pose_views(root)
        lines += merge_kernel_phase(dev, ply_dir, poses, card)
        launches.update(merge_phase(dev, ply_dir, poses, pose_dir, root, card))
    for line in lines:
        line["launches"], line["launches_run"] = launches[line["name"]]
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
