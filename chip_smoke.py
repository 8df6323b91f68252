#!/usr/bin/env python3
"""On-card check of the PyTorch + CUDA port: scan, merge and scan-to-print.

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
   against the true turntable poses at 1.5x the JAX package's errors;
6. radius_count at the clean chain's shape, on the pipeline scene
   (``utils/synthetic.pipeline_scene``: the three spheres on a floor plane,
   24 turntable views at 768x576, a 512x256 projector, stored as .slbp):
   its largest view padded to its 61,440-row bucket, at r = cluster_eps and
   r = radius, equal to the plain version exactly, timed with CUDA events
   beside the plain version and a cdist yardstick;
7. the main path: ``run_pipeline`` over those 24 views with the default
   ``Config()`` (manual thresholds, the scene's projector size, the cleaned
   views also written out), cold, then again under torch.profiler. Launch
   counts zeroed before each run, read after: radius_count 2 a view, nn1,
   ransac_score and slab_mean_knn at least once. Gated on the JAX package's
   run of the same views (``PIPELINE_JAX``, from
   ``tools/torch_pipeline_reference.py``): per-view clean counts within
   2 %, each chain pair's landing error (``pair_landing``: median, p99)
   within 1.5x wherever the JAX package's is under 1 mm, the merged point count
   within 10 %, the STL with a face a merged point at least, its open and
   non-manifold edges within 1.5x and the merged points' distance to it
   within 1.5x. The merged cloud's and the STL's distance to the true
   surfaces are printed beside the JAX package's: two chain pairs join
   views of different spheres, and no transform is right there. Then the
   true-pose arm: the pipeline's cleaned views merged under the true poses
   and meshed, gated at 1.5x the JAX package's errors against the true
   surfaces and the merged cloud (``PIPELINE_JAX["true_pose"]``); and the
   mesh arm: ``mesh_cloud`` (depth 10, brick-refined) on ~188k points of the
   three spheres' union, gated at 1.5x the JAX package's errors on the same
   cloud (``MESH_JAX``) against the true spheres and the input cloud.

Then one ``{"kernels": [...]}`` JSON line (times from phases 2, 4 and 6,
bounds from this run's shapes, and each kernel's launches from one run of
the main path, named in ``launches_run``: its own arm of phase 3, the cold
flagship merge, for knn_mean the small arm, for radius_count the cold
pipeline) and, last, the ``{"ok": true, "device": ...}`` line.
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
PIPE_VIEWS = 24
PIPE_CAM, PIPE_PROJ = (768, 576), (512, 256)
# the pipeline phase's config: the default Config() with the scene's
# projector size and manual thresholds (synthetic frames have no ambient
# variation for Otsu to split)
PIPE_OVERRIDES = {"decode.n_cols": PIPE_PROJ[0], "decode.n_rows": PIPE_PROJ[1],
                  "decode.thresh_mode": "manual", "pipeline.write_view_plys": True}
# A chain pair whose two cleaned views hold the same surface lands view i
# within a fraction of a millimetre of the truth. A landing statistic
# (median, p99) is gated where the JAX package's is under this: above it,
# the pair joins views of different spheres (no transform is right), or
# view i holds a sphere that view i - 1 lacks, whose place a turn about the
# shared sphere's centre leaves open (its p99).
LANDED_MM = 1.0
PIPE_RADIUS_VIEW = 7   # 105 degrees: the largest view (60,563 points, bucket 61,440)
# Pipeline gates: the JAX package's run_pipeline of the same 24 views on the
# CPU (tools/torch_pipeline_reference.py, mesh.density_cap=false so the CPU
# takes the card's depth-10 brick solve): per-view counts after each clean
# step, the merged cloud's and the STL's distance to the true surfaces
# (printed beside the port's), the cloud's extent, the STL's distance to its
# merged cloud and its edges, each chain pair's landing error, and the
# true-pose arm's numbers.
PIPELINE_JAX = {
    "merged_surf_median_mm": 38.32221603393555,
    "merged_surf_p99_mm": 66.37399028778076,
    "merged_points": 121715,
    "merged_extent_mm": 202.08316040039062,
    "pair_landing_mm": [
        [0.26094515885259284, 0.6118204009616058], [32.38966473575448, 56.265832145638385],
        [0.19085677717519545, 0.4966497544404599], [0.18222076660168796, 0.48032119660958833],
        [64.08946967539998, 100.05801665690389], [0.2309864436740412, 0.543583025235896],
        [0.3514772925330334, 9.451912277727606], [0.21170979264255152, 0.5538122917832056],
        [0.20382908645925113, 0.5214087511674997], [0.19641371901218463, 0.47109686817222723],
        [0.19223422249270072, 0.4721417007414134], [0.19073522348445238, 0.4771790691804057],
        [0.19108863852353863, 0.4949946224444346], [0.19379468900724817, 0.4859008207752706],
        [0.23729699660039216, 0.6994937961083856], [0.2025409076007776, 0.4800090951628434],
        [0.21120663031319253, 0.49928303932477647], [0.21742070927328427, 0.5297073086953697],
        [0.22619319304345709, 0.5328645940934962], [0.23588870750413804, 0.5503405660776811],
        [0.24446104041987837, 0.5751242184737599], [0.24926854508504448, 0.5847840640049141],
        [0.36475059573553636, 19.148433747377442],
    ],
    "true_pose": {
        "merged_points": 175539, "merged_surf_median_mm": 0.23257017602953667,
        "merged_surf_p99_mm": 0.545444266564161, "merged_extent_mm": 157.18994140625,
        "stl": {"faces": 2863752, "surf_median_mm": 0.07480118549023729,
                "surf_p99_mm": 1.5433279607896007, "to_merged_median_mm": 0.23582669458954156,
                "to_merged_p99_mm": 3.8504302762574407,
                "from_merged_median_mm": 0.1437089613732353,
                "from_merged_p99_mm": 0.5337078583295153,
                "boundary_edges": 8800, "nonmanifold_edges": 9158}},
    "stl": {"faces": 1711852, "surf_median_mm": 36.5284423828125,
            "surf_p99_mm": 71.30273246765137,
            "to_merged_median_mm": 0.29920921621752694,
            "to_merged_p99_mm": 6.882514665086437,
            "from_merged_median_mm": 0.187049118308529,
            "from_merged_p99_mm": 0.7256029794684776,
            "boundary_edges": 12780, "nonmanifold_edges": 6504},
    # per view in angle order: input, background, cluster, radius, statistical
    "clean_counts": [
        [54971, 32799, 16908, 16808, 16451],
        [52427, 31211, 13848, 13766, 13340],
        [51981, 31455, 13948, 13934, 13384],
        [50156, 29802, 14148, 14129, 13580],
        [51948, 31399, 14034, 14024, 13407],
        [56186, 35098, 14618, 14582, 14234],
        [59753, 38067, 18237, 18169, 17765],
        [60563, 38952, 32284, 32237, 31248],
        [59701, 38376, 20279, 20224, 19639],
        [58264, 37164, 20547, 20513, 19935],
        [56414, 35434, 20878, 20841, 20269],
        [53594, 32662, 21026, 20976, 20375],
        [49952, 29011, 20909, 20866, 20259],
        [47084, 26835, 20801, 20755, 20175],
        [46128, 26741, 20605, 20556, 19967],
        [45707, 26700, 20398, 20350, 19775],
        [45917, 26696, 20131, 20080, 19546],
        [47493, 27329, 19838, 19774, 19246],
        [51614, 30174, 19594, 19542, 19056],
        [55621, 32939, 19352, 19304, 18821],
        [58043, 35110, 19217, 19160, 18684],
        [59691, 36681, 19099, 19045, 18559],
        [59764, 36720, 19008, 18955, 18448],
        [57758, 34699, 26894, 26810, 25986]],
}
PIPE_STEPS = ("input", "background", "cluster", "radius", "statistical")
MESH_POINTS = 200_000
# The mesh arm's gates: the JAX package's mesh_cloud of mesh_cloud() on the
# CPU at depth 10 (tools/torch_pipeline_reference.py --mesh).
MESH_JAX = {
    "surf_median_mm": 0.041278764902799026,
    "surf_p99_mm": 3.0775032337983745,
    "to_merged_median_mm": 0.3172093226289097,
    "to_merged_p99_mm": 3.1958672256731617,
    "from_merged_median_mm": 0.06465328910326502,
    "from_merged_p99_mm": 0.12543843958863254,
    "boundary_edges": 8345,
    "nonmanifold_edges": 2898}


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


def render_pipeline_views(root: str):
    """The scan-to-print scene (``synthetic.pipeline_scene``): 24 turntable
    views at 768x576 stored as .slbp containers under root/scans, with
    root/calib.npz. Returns (data dir, calib path, scene)."""
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    rig, scene, poses = syn.pipeline_scene(cam_size=PIPE_CAM, proj_size=PIPE_PROJ,
                                           n_views=PIPE_VIEWS)
    data = os.path.join(root, "scans")
    for i, (R, t) in enumerate(poses):
        frames, _ = syn.render_scene(rig, scene.transformed(R, t))
        imio.save_packed_stack(
            os.path.join(data, f"view_{round(i * 360 / PIPE_VIEWS):03d}deg"),
            imio.pack_stack(frames))
    calib = os.path.join(root, "calib.npz")
    matfile.save_calibration(calib, rig.calibration())
    return data, calib, scene


def stl_accuracy(stl_path: str, scene, merged: np.ndarray) -> dict:
    """An STL against the scene and against the cloud it was meshed from:
    its vertices' distance to the true surfaces (median, 99th percentile,
    over the file's three corners a face), the vertices' distance to the
    merged cloud and the merged points' distance to the vertices (how
    faithfully the mesh follows its input, whatever the registration did),
    and its edges with vertices welded by exact coordinates:
    ``boundary_edges`` (used by one face) and ``nonmanifold_edges`` (by more
    than two). A closed mesh has neither."""
    from scipy.spatial import cKDTree

    from structured_light_for_3d_model_replication_tpu_torch.io import stl
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    verts, _, _ = stl.read_stl(stl_path)
    surf = syn.surface_distance(verts, scene)
    to_cloud = cKDTree(merged).query(verts, workers=-1)[0]
    from_cloud = cKDTree(verts).query(merged, workers=-1)[0]
    _, inv = np.unique(verts, axis=0, return_inverse=True)
    f = inv.reshape(-1, 3).astype(np.int64)
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    _, uses = np.unique(e[:, 0] * (int(f.max()) + 1) + e[:, 1], return_counts=True)
    return {"faces": int(len(f)), "verts": int(inv.max()) + 1 if len(f) else 0,
            "surf_median_mm": float(np.median(surf)),
            "surf_p99_mm": float(np.percentile(surf, 99)),
            "to_merged_median_mm": float(np.median(to_cloud)),
            "to_merged_p99_mm": float(np.percentile(to_cloud, 99)),
            "from_merged_median_mm": float(np.median(from_cloud)),
            "from_merged_p99_mm": float(np.percentile(from_cloud, 99)),
            "boundary_edges": int((uses == 1).sum()),
            "nonmanifold_edges": int((uses > 2).sum())}


def read_clouds(ply_dir: str) -> list[tuple[np.ndarray, np.ndarray]]:
    """The (points, colors) of every PLY of a folder, in angle order."""
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    paths = stages.sort_ply_paths_by_angle(
        [os.path.join(ply_dir, f) for f in os.listdir(ply_dir) if f.endswith(".ply")])
    datas = [ply.read_ply(p) for p in paths]
    return [(d["points"], d["colors"]) for d in datas]


def pair_landing(views, transforms, poses, scene) -> list[list[float]]:
    """Per chain pair i (view i onto view i - 1): view i's points moved by
    the estimated pair transform inv(T[i-1]) T[i], then by view i - 1's
    true pose, and their distance to the true surfaces: [median, p99] mm.
    A pose that slides a sphere along itself, which one view pair of a
    sphere cannot pin down, lands it just as well as the true one."""
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    truth = syn.turntable_transforms(poses)
    out = []
    for i in range(1, len(views)):
        T = (np.linalg.inv(np.asarray(transforms[i - 1], np.float64))
             @ np.asarray(transforms[i], np.float64))
        M = truth[i - 1] @ T
        d = syn.surface_distance(np.asarray(views[i], np.float64) @ M[:3, :3].T + M[:3, 3],
                                 scene)
        out.append([float(np.median(d)), float(np.percentile(d, 99))])
    return out


def true_pair_transforms(poses) -> np.ndarray:
    """The true chain pair transforms (view i onto view i - 1), f32 [V-1, 4, 4]."""
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    truth = syn.turntable_transforms(poses)
    return np.stack([np.linalg.inv(truth[i - 1]) @ truth[i]
                     for i in range(1, len(truth))]).astype(np.float32)


def cloud_accuracy(points: np.ndarray, stl_path: str, scene) -> dict:
    """A merged cloud against the true surfaces, and the STL meshed from it
    (``stl_accuracy``), with the cloud's largest extent: the Poisson grid's
    cell is that extent over 2^depth, so distances between a mesh and its
    cloud compare across clouds as shares of it."""
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    surf = syn.surface_distance(points, scene)
    return {"merged_points": int(len(points)),
            "merged_surf_median_mm": float(np.median(surf)),
            "merged_surf_p99_mm": float(np.percentile(surf, 99)),
            "merged_extent_mm": float((points.max(0) - points.min(0)).max()),
            "stl": stl_accuracy(stl_path, scene, points)}


def mesh_cloud():
    """The meshing arm's input: ~188k points on the outer surface of the
    three spheres' union (0.05 mm noise, seed 0), a closed surface whose
    distance is known; at this count the density cap keeps depth 10. Returns
    (points f32 [N, 3], scene)."""
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    scene = syn.three_spheres()
    return syn.sphere_union_cloud(scene, MESH_POINTS), scene


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


def radius_phase(dev, data: str, calib: str, card: str) -> list[dict]:
    """Phase 6: radius_count at the clean chain's shape: the scene's largest
    view, reconstructed, padded to its 2048-multiple bucket with rows parked
    at knn.FAR (valid = its points), at r = clean.cluster_eps and r =
    clean.radius. The kernel must equal its plain version exactly."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    cfg = load_config(None, PIPE_OVERRIDES)
    view = sorted(os.listdir(data))[PIPE_RADIUS_VIEW]
    pts, _ = stages.reconstruct_source(os.path.join(data, view),
                                       matfile.load_calibration(calib), cfg, device=dev)
    n = len(pts)
    bucket = recon._bucket_pad(n)
    check(bucket <= 65536, f"{view}: {n} points, bucket {bucket} > 65536")
    padded = np.full((bucket, 3), knnlib.FAR, np.float32)
    padded[:n] = pts
    valid = torch.arange(bucket, device=dev) < n
    parked = knnlib._parked(torch.from_numpy(padded).to(dev), valid).contiguous()
    out = []
    for case, r in (("cluster_eps", cfg.clean.cluster_eps), ("radius", cfg.clean.radius)):
        k_cnt = kernels.radius_count(parked, r)
        p_cnt, plain_ms = _timed_once(lambda: kernels.radius_count_plain(parked, r))
        torch.cuda.synchronize()
        err = int((k_cnt - p_cnt).abs().max())
        check(err == 0, f"radius_count ({case}): counts off the plain version by {err}")
        ms = time_ms(lambda: kernels.radius_count(parked, r), reps=20)
        # the yardstick: one PyTorch expression for the same counts
        lib_ms = time_ms(lambda: (torch.cdist(parked, parked) <= r).sum(1) - 1, reps=3, warm=1)
        # 9 operations a (query, base) pair: 3 sub, 3 mul, 2 add, 1 compare
        b_ms, b_by = bound(bucket * 12 + bucket * 4, bucket * bucket * 9)
        line = {"name": "radius_count", "route": "cuda", "source": CLOUD_SOURCE,
                "replaces": f"{PALLAS}:529", "launches": 0, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms}
        valid_cnt = k_cnt[:n].double()
        print(json.dumps(dict(line, case=case, r=r, shape=[bucket, 3], points=n, view=view,
                              mean_count=float(valid_cnt.mean()), card=card,
                              clocks=clocks())), flush=True)
        out.append(line)
    del parked, valid
    torch.cuda.empty_cache()
    return out[:1]


def pipeline_phase(dev, data: str, calib: str, scene, root: str,
                   card: str) -> dict[str, tuple[int, str]]:
    """Phase 7: ``run_pipeline`` over the 24 views at the default Config()
    (the scene's projector size, manual thresholds, the cleaned views also
    written out), cold, then again under torch.profiler for the device's
    busy time. Launch counts are zeroed before each run and read after:
    radius_count 2 a view (cluster and radius steps), nn1, ransac_score and
    slab_mean_knn at least once. Gated on the JAX package's run of the same
    views (``PIPELINE_JAX``), after both runs: per-view counts after each
    clean step within 2 %; each chain pair's landing error
    (``pair_landing``: median, p99) within 1.5x the JAX package's wherever
    that is under LANDED_MM; the merged point count
    within 10 %; the STL with at least a face a merged point, its open and
    non-manifold edges within 1.5x, and its distance from the merged points
    (median, p99, as shares of the cloud's extent) within 1.5x. Then the
    true-pose arm and the mesh arm. Returns {"radius_count": (launches,
    run)} of the cold run."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    _, _, poses = syn.pipeline_scene(cam_size=PIPE_CAM, proj_size=PIPE_PROJ,
                                     n_views=PIPE_VIEWS)
    results = []
    for arm in ("cold", "profiled"):
        cfg = load_config(None, PIPE_OVERRIDES)
        out = os.path.join(root, f"pipeline_{arm}")
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        prof = _device_profile() if arm == "profiled" else None
        t0 = time.perf_counter()
        if prof is not None:
            prof.__enter__()
        report = stages.run_pipeline(calib, data, out, cfg=cfg, device=dev,
                                     log=lambda m: None)
        torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        merged = ply.read_ply(report.merged_ply)["points"]
        check(merged.ndim == 2 and len(merged) > 0 and bool(np.isfinite(merged).all()),
              f"pipeline {arm}: bad merged cloud {merged.shape}")
        views = read_clouds(os.path.join(out, "views"))
        check(len(views) == PIPE_VIEWS and len(report.transforms) == PIPE_VIEWS,
              f"pipeline {arm}: {len(views)} cleaned views, {len(report.transforms)} "
              f"transforms")
        acc = cloud_accuracy(merged, report.stl_path, scene)
        land = pair_landing([p for p, _ in views], report.transforms, poses, scene)
        line = {"pipeline": arm, "wall_s": wall, "walls_s": report.walls_s,
                "launches": counts, "accuracy": acc, "pair_landing_mm": land,
                "clean_counts": [[c.get(k, 0) for k in PIPE_STEPS]
                                 for c in report.clean_counts],
                "card": card, "clocks": clocks()}
        if prof is not None:
            line["device"] = _device_busy(prof)
        print(json.dumps(line), flush=True)
        results.append((arm, counts, acc, line["clean_counts"], land))
    ref = PIPELINE_JAX
    for arm, counts, acc, clean, land in results:
        check(counts["radius_count"] == 2 * PIPE_VIEWS,
              f"pipeline {arm}: radius_count launched {counts['radius_count']} times, "
              f"not 2 a view")
        for k in ("nn1", "ransac_score", "slab_mean_knn"):
            check(counts[k] > 0, f"pipeline {arm} never launched {k}: {counts}")
        check(len(clean) == len(ref["clean_counts"]), f"pipeline {arm}: {len(clean)} views")
        for i, (mine, theirs) in enumerate(zip(clean, ref["clean_counts"])):
            for step, a, b in zip(PIPE_STEPS, mine, theirs):
                check(abs(a - b) <= 0.02 * b, f"pipeline {arm}: view {i} {step} count {a} "
                                              f"vs the JAX package's {b}")
        # Registration, pair by pair. A cleaned view holds one sphere (the
        # cluster step keeps the largest cluster), so a pair is determined
        # up to a turn of that sphere about its centre, and a pair whose
        # views hold different spheres has no right transform: there the
        # choice follows the preps' last bits, and the merged cloud's and
        # the STL's distances to the truth follow it (PERF.md section 5).
        # They are printed; the true-pose arm gates them on the same views.
        for i, (mine, theirs) in enumerate(zip(land, ref["pair_landing_mm"]), 1):
            for what, a, b in zip(("median", "p99"), mine, theirs):
                check(b >= LANDED_MM or a <= GATE * b,
                      f"pipeline {arm}: pair {i} lands view {i} {a} mm off the truth "
                      f"({what}), > {GATE} x the JAX package's {b}")
        check(abs(acc["merged_points"] - ref["merged_points"]) <= 0.1 * ref["merged_points"],
              f"pipeline {arm}: {acc['merged_points']} merged points vs the JAX "
              f"package's {ref['merged_points']}")
        stl = acc["stl"]
        check(stl["faces"] >= acc["merged_points"],
              f"pipeline {arm}: STL of {stl['faces']} faces for {acc['merged_points']} "
              f"merged points")
        for key in ("boundary_edges", "nonmanifold_edges"):
            check(stl[key] <= GATE * ref["stl"][key],
                  f"pipeline {arm}: STL {key} {stl[key]} > {GATE} x the JAX "
                  f"package's {ref['stl'][key]}")
        for key in ("from_merged_median_mm", "from_merged_p99_mm"):
            mine = stl[key] / acc["merged_extent_mm"]
            theirs = ref["stl"][key] / ref["merged_extent_mm"]
            check(mine <= GATE * theirs,
                  f"pipeline {arm}: merged points {stl[key]} mm from the STL ({key}), "
                  f"{mine} of the cloud's extent > {GATE} x the JAX package's {theirs}")
    true_pose_arm(dev, os.path.join(root, "pipeline_cold", "views"), poses, scene, root,
                  card)
    mesh_arm(dev, root, card)
    return {"radius_count": (results[0][1]["radius_count"], "pipeline (cold)")}


def true_pose_arm(dev, view_dir: str, poses, scene, root: str, card: str) -> None:
    """The pipeline's merge postprocess and meshing on its own cleaned views
    placed by the true poses (``finalize_chain`` with the true pair
    transforms: final voxel and outlier pass, then ``mesh_cloud``), gated at
    1.5x the JAX package's errors on its cleaned views placed the same way
    (``PIPELINE_JAX["true_pose"]``): the merged cloud's and the STL's
    distance to the true surfaces, the STL's distance to its cloud both
    ways, its edges; the merged point count within 10 % and the faces at
    least 1/1.5 of the JAX package's."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    cfg = load_config(None, PIPE_OVERRIDES)
    clouds = read_clouds(view_dir)
    ones = np.ones(len(clouds) - 1, np.float32)
    src, out = os.path.join(root, "true_pose.ply"), os.path.join(root, "true_pose.stl")
    tm: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    points, colors, _ = recon.finalize_chain(clouds, true_pair_transforms(poses), ones,
                                             ones, 0 * ones, cfg.merge, log=lambda m: None,
                                             timings=tm, device=dev)
    ply.write_ply(src, points, colors)
    stages.mesh_cloud(src, out, cfg=cfg, device=dev, log=lambda m: None, timings=tm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc = cloud_accuracy(points, out, scene)
    print(json.dumps({"pipeline": "true poses", "wall_s": wall, "walls_s": tm,
                      "accuracy": acc, "card": card}), flush=True)
    ref = PIPELINE_JAX["true_pose"]
    check(abs(acc["merged_points"] - ref["merged_points"]) <= 0.1 * ref["merged_points"],
          f"true-pose arm: {acc['merged_points']} merged points vs the JAX package's "
          f"{ref['merged_points']}")
    check(acc["stl"]["faces"] >= ref["stl"]["faces"] / GATE,
          f"true-pose arm: STL of {acc['stl']['faces']} faces vs the JAX package's "
          f"{ref['stl']['faces']}")
    for key in ("merged_surf_median_mm", "merged_surf_p99_mm"):
        check(acc[key] <= GATE * ref[key],
              f"true-pose arm: {key} {acc[key]} > {GATE} x the JAX package's {ref[key]}")
    for key in ("surf_median_mm", "surf_p99_mm", "to_merged_median_mm", "to_merged_p99_mm",
                "from_merged_median_mm", "from_merged_p99_mm", "boundary_edges",
                "nonmanifold_edges"):
        check(acc["stl"][key] <= GATE * ref["stl"][key],
              f"true-pose arm: STL {key} {acc['stl'][key]} > {GATE} x the JAX "
              f"package's {ref['stl'][key]}")


def mesh_arm(dev, root: str, card: str) -> None:
    """The meshing stage against a known surface: ``mesh_cloud`` (the
    ``mesh`` entry point: normals, depth-10 brick Poisson, extraction, trim)
    on ``mesh_cloud()``'s points at the default Config(), gated at 1.5x the
    JAX package's errors on the same cloud (``MESH_JAX``): the STL's
    distance to the true spheres, to the input cloud both ways, and its
    open and non-manifold edges."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    cloud, scene = mesh_cloud()
    src, out = os.path.join(root, "mesh_cloud.ply"), os.path.join(root, "mesh_arm.stl")
    ply.write_ply(src, cloud)
    tm: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages.mesh_cloud(src, out, cfg=Config(), device=dev, log=lambda m: None, timings=tm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc = stl_accuracy(out, scene, cloud)
    print(json.dumps({"mesh": "sphere union", "points": int(len(cloud)), "wall_s": wall,
                      "walls_s": tm, "stl": acc, "card": card}), flush=True)
    for key, ref in MESH_JAX.items():
        check(acc[key] <= GATE * ref,
              f"mesh arm: STL {key} {acc[key]} > {GATE} x the JAX package's {ref}")


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
    with tempfile.TemporaryDirectory(prefix="slscan_pipeline_") as root:
        t0 = time.perf_counter()
        data, calib, scene = render_pipeline_views(root)
        print(f"pipeline views: {PIPE_VIEWS} rendered in {time.perf_counter() - t0:.1f}s",
              flush=True)
        lines += radius_phase(dev, data, calib, card)
        launches.update(pipeline_phase(dev, data, calib, scene, root, card))
    for line in lines:
        line["launches"], line["launches_run"] = launches[line["name"]]
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
