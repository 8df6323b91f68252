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
   masks bit-equal (and the packed decode equal to the raw one; the packed
   decode also on one and on eight plane bytes, one view, 1080x1001 and
   1079x1001 pixels, stacks truncated to 16 and 8 pairs and downsample 2),
   the fused kernel with at most 2e-3 of valid flags flipped, |dp| < 1e-2
   mm where both are valid and the texture equal, also at row_mode 0, on
   one view and at 1080x1000 (a ragged last tile of the bulk kernel) — and
   timed with CUDA events (warm, median) and by their device time; decoded
   points are held against the renderer's ground truth (median error <
   1.5 mm, 99th percentile < 5 mm);
3. the main path: ``reconstruct(mode="batch", compute_batch=4)`` over 8
   views written as .slbp containers, once per arm — plane_eval=table
   (decode kernel), plane_eval=quadratic (fused kernel), packed ingest
   (packed decode kernel). Launch counts are zeroed before each arm, and
   the arm must launch its kernel once a batch and nothing else (a batch
   that fell back to per-view compute would not); the packed arm's PLYs
   must equal the table arm's byte for byte;
4. merge kernels at the merge path's shapes, on the flagship merge scene
   (``utils/synthetic.three_spheres``: 24 turntable views 15 degrees apart
   about (0, 0, 400), a 480x360 camera, a 512x256 projector, rendered once,
   reconstructed by the port's ``reconstruct`` into per-view PLYs): nn1 on
   the ICP group's [4, bucket] preps and at chamfer size (the merged cloud
   after the 0.5 mm voxel against a jittered copy), ransac_score on pair
   1 -> 0's 4096 hypotheses, knn_mean on 32768 rows of the merged cloud,
   slab_mean_knn on the whole sorted merged cloud (tile 64, wblk 8192).
   nn1 and ransac_score must equal their plain versions exactly
   (ransac_score also at T = 37 and N = 2100, at N = 1, with every
   correspondence dead, at T = 1 and with P not 16-byte aligned), the k-NN
   means match counts (and window ends) exactly and means within rtol 1e-5
   (sum order). Both k-NN means also meet the cases a selection kernel gets
   wrong, every row gated: k = 1, 33, 40, 64 (lists of two segments), 128
   (four) and 129 (the bisection kernels: above kernels.SELECT_MAX_K), every
   row duplicated (exact ties at the k-th distance), a cloud with fewer
   than k real rows within the cutoff, each case also at two and four
   segments; knn_mean also k = 32, a ragged L, L < k and the same cloud in
   a seeded random row order (timed beside the x-sorted one). Each k-NN
   mean call is checked to launch the kernel its k takes (select_kernel,
   by torch.profiler's records, which also give its device time). nn1
   also on a lattice (exact ties: idx the lowest index at the least
   distance), a base parked whole at knn.FAR (idx 0) and a ragged shape.
   The redesigned kernels' rows carry the profiler's device time
   (``device_ms``) and the previous kernel's time (``ms_before``). Beside
   each kernel, one PyTorch
   expression for the same function is timed as a yardstick
   (``library_ms``; the port never calls it);
5. the merge path: ``merge_views`` over the 24 PLYs with the default
   ``Config()`` (4096 trials), three times (cold, warm, warm under
   torch.profiler), each taking ``merge_360``'s device arm (one stacked
   prep, one batched chain register, the accumulate and postprocess on the
   card); every run prints its arm and the gate's reason where it refused.
   Launch counts zeroed before each run, read after: nn1,
   ransac_score and slab_mean_knn must each have launched. The merged
   points are held against the true sphere surfaces at 1.5x the JAX
   package's errors on the same views (this scene's poses drift in both
   packages and are printed, not gated). A second arm with a 1.5 mm final
   voxel (merged cloud <= 32768 points) must launch knn_mean and not
   slab_mean_knn. A third, the pose scene (``synthetic.lumpy_views`` at the
   same 24 poses, a surface that registers), holds the recovered transforms
   against the true turntable poses at 1.5x the JAX package's errors. Then
   the host-list arm (``prep_view``, ``register_prep_pairs``,
   ``finalize_chain``: the streamed pipeline's computation) on the same
   flagship and pose clouds under the same gates; printed beside the
   device arm: per-view rotation and translation differences, the chamfer
   distance between the two merged clouds, each arm's split and launches,
   and (profiled) the bytes copied between the card and the host;
6. radius_count at the clean chain's shape, on the pipeline scene
   (``utils/synthetic.pipeline_scene``: the three spheres on a floor plane,
   24 turntable views at 768x576, a 512x256 projector, stored as .slbp):
   its largest view padded to its 61,440-row bucket, at r = cluster_eps and
   r = radius, equal to the plain version exactly, timed with CUDA events
   beside the plain version and a cdist yardstick; at both radii also the
   view's own 60,563 rows (a ragged N) and a cloud of duplicated rows,
   equal on every row; the cluster step's k-NN (k = 16) on that bucket,
   timed beside torch.topk on the float distances; the k-NN's tie order on
   a lattice (idx equal to a stable argsort on the CPU on every row); then
   slab_mean_knn at the statistical step's shape (that bucket, its
   spacing-derived cell, k = 20), gated as in phase 4;
7. the main path: ``run_pipeline`` over those 24 views with the default
   ``Config()`` (manual thresholds, the scene's projector size, the cleaned
   views also written out) and its default schedule (the streamed merge,
   the stage cache on, each run in a fresh directory, no failure), cold,
   then again under torch.profiler. Launch
   counts zeroed before each run, read after: decode_maps once a batch,
   radius_count 2 a view, nn1, ransac_score and slab_mean_knn at least
   once. Gated on the JAX package's
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
   mesh arm: ``mesh_cloud`` (depth 9, the dense solve: MESH_DEPTH) on ~188k
   points of the three spheres' union, gated at 1.5x the JAX package's
   errors on the same cloud at the same depth (``MESH_JAX``) against the
   true spheres and the input cloud;
8. the schedule (``schedule_phase``) on the same 24 views, beside phase 7's
   cold run: the barrier arm (``merge.stream=false``) byte-identical to it,
   both walls and the register lane's wall beside the critical path
   printed; a warm rerun in its directory (no view computed, no kernel
   launched, byte-identical); a dirty rerun (one bit of view 11 flipped
   at a pixel the clean chain keeps: one view computed, its cleaned cloud
   changed, exactly 2 pair-cache misses, the merge recomputed); a fault
   arm (view 11 fails permanently: DEGRADED, 23 views
   merged, view 11 alone quarantined, the re-pair 10 -> 12 registered); a
   budget arm (``pipeline.run_budget_s=1``: the run aborts with a manifest
   and the register thread and every reconstruct-lane thread end). Every
   arm but the fault arm ends with no failure;
9. the executor: (a) ``reconstruct`` over 6 views of the phase-2 render
   (run right after phase 3, while the render is in memory), written once
   as PNG frame folders with libpng's adaptive row filters (loading
   decodes PNGs with the port's native stack decoder where it is built,
   else cv2, else PIL, else the port's own reader; the phase prints which)
   and once as .slbp, in
   four arms: serial (io_workers 1, compute_batch 1), pipelined (io_workers
   4, compute_batch 1), batched (compute_batch 4, io_workers 4,
   prefetch_depth 2: two batches and a ragged tail of 2) and packed (the
   batched lane on the .slbp views). Every arm's PLYs must equal the serial
   arm's byte for byte, the decode kernel launch once a view in the
   per-view arms and once a batch (3) in the batched arms and nothing else
   launch, no view fail and no lane thread outlive its run; each arm
   prints its wall, views/s, the lanes (load, transfer, compute, write)
   against the critical path, the bytes uploaded from pinned memory and
   the peak device memory. (b) ``run_pipeline`` over phase 7's 24 views
   with ``pipeline.fused_clean=true`` and the flight recorder on:
   merged.ply, model.stl and the view PLYs byte-identical to phase 7's
   cold run (so tracing changes no output), decode_maps once a batch,
   radius_count 2 a view, nn1, ransac_score and slab_mean_knn as many
   launches as the cold run, no failure, and the cloud bytes between the
   card and the host at least 3x fewer than the cold run's (both printed);
10. the command surface: (a) right after phase 9(a), ``reconstruct`` with
   ``triangulate.bitexact=true`` over 4 views of the phase-2 render
   (decode on the card, the maps triangulated by the NumPy twin on the
   host) and with ``parallel.backend=numpy`` (decode and triangulation on
   the host): every PLY byte-identical between the arms, decode_maps once
   a view and nothing else in the bit-exact arm, no kernel in the numpy
   arm, both in the per-view pipelined lane; views/s and the host
   triangulation seconds a view printed. (b) ``native: built <path>`` or
   ``native: unavailable: <what>``; when built, two of phase 9(a)'s PNG
   folders loaded by the native stack decoder equal the Python reader's
   arrays byte for byte (seconds a view printed both ways), and phase 7's
   merged.ply and model.stl, written natively, hold the Python writers'
   records (the PLY header differs by one comment line; the STL normals,
   float32 against float64-normalized, within 1e-4). (c) the port's
   ``report`` over phase 9(b)'s traced run: ``--validate`` exits 0, the
   report renders, ``--prometheus`` prints the metrics, ``--chrome-trace``
   writes a trace with a track for the prefetch, drain and register
   threads (lane and track counts printed). (d) after phase 5, its flagship
   merge again through ``merge-360 --artifacts`` (a step callback closes
   the device arm's gate): merged.ply byte-identical to phase 5's
   host-list arm's, one ``merge_step_NN.ply`` a chain step after the base
   view and ``progress.json``, nn1 and ransac_score launched as often as
   in that host-list run;
11. the legacy merge and mesh modes and the standalone registration, each
   gated at 1.5x the JAX package's errors on the same inputs on the CPU:
   (a) after phase 10(d), ``merge_views`` with ``merge.method=posegraph``
   over the pose scene (poses gated) and the 24 flagship views (surface
   distance gated), the loop-closure decision equal to the JAX package's
   (``POSEGRAPH_JAX``); (c) ``ransac_global_registration`` and
   ``icp_point_to_plane`` on pose views 1 -> 0, and ``icp_point_to_plane``
   with a dst of more than 131,072 rows (the flagship cloud against its
   noisy copy under ``BIG_ICP_MOTION``): ransac_score and nn1 launched, the
   recovered transforms gated (``STANDALONE_JAX``), times printed; (e)
   phase 5's flagship merge with ``parallel.force_bf16_features=true``:
   fitness printed beside the f32 run, the same arm and kernels launched;
   (b) after phase 10(b), ``mesh_cloud`` with ``mesh.mode=surface`` over
   the mesh arm's ~188k points: faces within 1 % of the JAX package's, the
   STL's distance to the true spheres within 1.5x (``SURFACE_JAX``), the
   time printed; (d) ``run_pipeline`` with ``merge.method=posegraph`` and
   ``mesh.mode=surface`` over phase 7's 24 views with its view cache
   copied in: the notice that merge.stream is ignored, merge_mode
   posegraph, no failure, the merged cloud's distance to the truth printed
   beside phase 7's;
12. the capture path: (a)-(c) right after phase 3. (a) CALIB_POSES
   chessboard poses (``synthetic.calibration_poses``: 6 x 9 inner corners,
   10 mm squares, 400-600 mm away, tilted up to 20 degrees) lit by phase
   2's 46-frame stack through its rig, captured by the port's
   ``CaptureSequencer.capture_calibration`` (a virtual projector; the camera
   writes the render of the frame shown, ``on_pose`` moves the board), then
   the port's ``calibrate <dir> --output calib.mat`` and ``inspect-calib``:
   every pose detected, and each error against the true rig (both
   intrinsics, the angle of R, T, the stereo RMS) within 1.5x the JAX
   package's on the same renders or a floor (0.05 px, 0.01 deg, 0.05 mm),
   printed beside it (``CALIB_JAX``, tools/torch_calib_reference.py). (b)
   ``reconstruct`` of phase 3's 8 .slbp views with the recovered calib.mat
   in the table and quadratic lanes: the lane's kernel once a batch and
   nothing else, every view's distance to the true surfaces (median, p99)
   within 1.5x the JAX package's, printed beside a true-calibration run.
   (c) ``undistort_stack`` of one 46x1080x1920 stack (k1 -0.28): equal to
   the CPU's result but for at most 1e-4 of the pixels, each off by one;
   zero distortion returns the stack; the time printed. (d) after phase
   11(d), ``auto_scan_360`` of phase 7's 24 views over the HTTP rendezvous
   (the port's CaptureServer, a fake-phone thread uploading the PNG of
   phase 7's raw render of the frame shown, a simulated turntable,
   pack_frames): 24 ``view_folder_name`` folders each holding a
   frames.slbp byte-equal to phase 7's, 24 progress events; then
   ``run_pipeline`` over them: merged.ply and model.stl byte-identical to
   phase 7's cold run, its kernel launches as phase 7's; the capture wall,
   the median round trip a frame and the pipeline wall printed;
13. the coordinated pipeline (``coordinated_phase``, after phase 12(d)):
   first phase 7's 23 chain pairs, prepped from its cached cleaned views,
   registered in groups of ``merge.pair_batch`` and each alone (a worker's
   pair item): T, fitnesses and rmse byte-equal to each other and to
   phase 7's cached pair entries (``pair_group_gate``); then
   ``run_pipeline`` with ``coordinator.workers`` over phase 7's 24 views
   and config on the card, in fresh directories, each arm's merged.ply and
   model.stl byte-identical to phase 7's cold run. (a) loopback, 2 worker
   processes (each with its own CUDA context): 24 view and 23 pair items
   completed with no steal and nothing lost; this process (the assembly
   pass) launches none of decode_maps, scan_fused, decode_packed_maps,
   radius_count, ransac_score or nn1; the workers' exit lines (``.coord/
   worker<r>.log``) sum to decode_maps 24 and radius_count 48, with
   ransac_score and nn1 launched; each worker's peak device memory and the
   wall beside phase 7's cold wall printed. (b) the pod fabric
   (``coordinator.listen``, a secret, one spawned worker warming a private
   L1 root, ``merge.incremental``, the flight recorder) joined by an
   external ``worker --spec <out>/.coord/join.json`` started here: it
   completes an item and exits 0, the fold lane folds a view, the port's
   ``report --validate`` exits 0 and the journals' fabric bytes equal the
   blob server's counters (pushes, fetches, bytes and the assembly tail
   printed). (c) chaos, on the first SERVE_SUBSET (8) views held to their
   own solo run (``subset_reference``, run first):
   ``SL3D_FAULTS=worker.item~w0:worker.kill@3`` under an 8 s lease and 1 s
   heartbeats: w0 exits 137, the ledger holds a steal and no item
   completed before the kill is granted again;
14. the scan service (``serving_phase``, after phase 13), phase 7's config:
   (a) a solo gateway over HTTP with auth on, two tenants minted by
   ``tenant add``, one submitting phase 7's 24 views and one phase 8's
   dirty copy together: both served byte-identical to phase 7's cold run
   and phase 8's dirty run, at least one cross-tenant launch, no view
   failure or engine exception line, no view computed in either assembly,
   a 401 without a key and a 429 over the rate limit; then a rescan
   planned after the store is warm (24 views deduped, no view kernel, the
   same bytes) and /usage equal to the ledger's fold. (b)-(d) on the 8
   views of ``subset_reference``, each byte-identical to its solo run: (b)
   a ``serve.crash`` at the assembly boundary, then a new service over the
   root resumes with no view computed; (c) two HA gateways (2 s lease): the
   leader's renew stalls once it credited a view, the follower takes over
   at epoch 2 and warms at most the views epoch 1 did not credit, and the
   old leader's next append is fenced; (d) the elastic fleet (1 to 2
   worker processes on the card beside the engine lane): a fleet worker
   completes a view, the ledger holds the spawns, each worker's exit line
   (launches, peak memory) printed, no worker process left. (e) ``warmup``
   and ``doctor`` as subprocesses: both exit 0, warmup finds the library
   built and prints each kernel's first launch, doctor prints the card's
   name and power limit. Each arm prints its wall, its launches, the peak
   device memory and each request's queue / warm / assembly split.
15. the large-cloud k-NN engines (``flagship_phase`` right after phase 3,
   ``feature_prep_phase`` after phase 7): (a) the knn_binmin kernel (each
   query row's nearest column in each of M strided bins, the partial reduce
   of the binned selection) equal to its plain version bit for bit at
   feature prep's shape (phase 7's largest prep, every row, k = 32, recall
   0.95), at the merged cloud's normals shape (mesh_cloud(), 16,384 rows,
   k = 30, recall 0.99) and at a 1080p view's cluster shape (its bucket,
   the background step's survivors valid, 4,096 rows, k = 16, recall 0.99),
   each row's recall against the exact arm printed, the mean at least the
   target and every miss one-sided; timed at the 1080p shape beside its
   plain version and torch.cdist + torch.topk, and at the main path's own
   call, a 32,768-row contiguous chunk of that view's parked cloud, each
   with the share of pairs the tensor-core screen sent to the exact confirm
   and the rows it sent to the exact sweep; and equal bit for bit on
   ``binmin_edge_cases``: exact duplicates, near-ties inside the screen's
   margin, a cloud 1e4 mm from the origin, a tile of parked query rows and
   all-parked bins, N not a multiple of M, M = 128 and 4096, self-exclusion
   on and off, non-finite points; before them the tensor cores'
   accumulation error on the screen's own mma.sync, within the margin's
   kernels.BINMIN_ACC (``binmin_accumulation_probe``); the bound from the
   design's work (``binmin_bound``). (b) ``run_pipeline`` over
   FLAGSHIP_VIEWS of phase 3's 1080p .slbp views with the default Config()
   at the render's projector size, cold: knn_binmin launched, per-view
   clean counts within 1 % of the JAX package's on the same views and the
   cleaned points' distance to the true sphere within 1.5x
   (``FLAGSHIP_CLEAN_JAX``, tools/torch_flagship_reference.py); each clean
   step's wall a view (the cluster step's k-NN apart from its label
   rounds), the merge and mesh walls, the peak device memory, the launches,
   the screen's counts (rows screened, rows on the exact sweep, the confirm
   share), the merged cloud's and the STL's distance to the sphere, the
   exact arm's k-NN on 65,536 rows scaled to the view, and view 0's cluster
   k-NN split into its knn_binmin calls and their stage-2 keyed top-k,
   printed. (c) phase 7 runs
   the binned selection in feature prep (approx:0.95) and in the merged
   cloud's normals: knn_binmin launched in both of its runs, and the
   ``feature_group_gate``: one view's features prepped alone equal the same
   view padded into the device arm's shared bucket (beside phase 7's merged
   cloud: the views share one 2048-row bucket).
16. the sharded arms (``sharded_phase``, after phase 14) on meshes of
   SHARDS (4) repeated cuda:0 (one card: the pipeline's ``views_mesh`` and
   ``merge_mesh`` stay None, so phases 1-15 ran unsharded): (a) phase 3's 8
   views at 1080p through ``forward_views(mesh=)`` (table, quadratic) and
   ``forward_views_packed(mesh=)``: the unsharded bytes, the arm's kernel
   launched once a shard and nothing else; (b) the scan step at a (2, 2)
   mesh: ``forward_views``' cloud byte for byte, n_valid and the bounding
   box equal to numpy's, the centroid within 1e-6 of the extent; (c)
   ``merge_360(mesh=)`` over phase 7's 24 cleaned views: the unsharded
   host-list arm's transforms bit for bit, the slabs' voxel pass equal to
   the single device's (cells equal, means within 1e-4 mm), every row kept
   by one arm alone within 1e-5 of the threshold from it (exact k-NN), the
   distance to the truth within 1.5x; the JAX test scene of (v) over 2 and
   4 slabs with at most 4 rows unmatched; (d) Poisson on the mesh arm's
   188,067 points: depth 9 on 4 slabs against the dense solve at 200 CG
   steps (chi 1e-3, density 1e-4), depth 10 with 350 CG steps on 4 and on 2 slabs
   (chi[::16]^3 within 1e-4, iso within 1e-5), each solve's wall, CG ms a
   step and peak memory printed; (e) a child process joins a one-process
   NCCL group: platform gpu, psum 1. Each arm prints its wall, peak device
   memory and launches.

Then one ``{"kernels": [...]}`` JSON line (times from phases 2, 4, 6 and 15,
bounds from this run's shapes, and each kernel's launches from one run of
the main path, named in ``launches_run``: the cold streamed pipeline for
every kernel it launches, else its own arm of phase 3, the cold flagship
merge, for knn_mean the small arm) and, last, the
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
# one 32-bit instruction a lane a clock: 132 SMs x 128 lanes at the 1980 MHz
# boost clock. OPS_PER_S counts an FMA as two operations; distances that
# must not contract into FMAs issue one instruction an operation, so this
# rate, not OPS_PER_S, is what the pair kernels can reach
LANE_INSTR_PER_S = 132 * 128 * 1.98e9
TC_BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core rate
# knn_binmin's work a screened (row, column) pair: one mma.sync.m16n8k16
# (4096 flops) a 128 pairs in each of its two passes; and the CUDA-core lane
# instructions its design cannot do without: pass 1's FMNMX (1), pass 2's
# OR of the sign bits by three-input LOP3 (0.5), the two passes' MMA issues
# (2 x 32 lanes / 128 pairs = 0.5) and B-fragment loads (2 x 2 LDS a warp
# step of 512 pairs = 0.25). A confirm or an exact-sweep pair: the 9
# operations of the difference d2, one instruction each
BINMIN_SCREEN_FLOPS = 2 * 4096 / 128
BINMIN_SCREEN_INSTR = 1 + 0.5 + 0.5 + 0.25
BINMIN_EXACT_INSTR = 9
# Phase 15(a)'s accumulation probe: tiles a family of operands
PROBE_TILES = 4096
RECON_VIEWS = 8
RECON_BATCH = 4
EXEC_VIEWS = 6        # phase 9(a): a batch of 4 and a ragged tail of 2 (cut from 10 for phase 16)
EXEC_BATCH = 4
# phase 10(a): the numpy arm decodes and triangulates each 1080p view on the
# host (~1 s a view on one core) and writes ~1M points a view
BITEXACT_VIEWS = 4
NATIVE_LOAD_VIEWS = 2   # phase 10(b): PNG folders of phase 9(a) loaded both ways
LANE_THREADS = ("sl3d-prefetch", "sl3d-drain", "sl3d-plywrite", "sl3d-register")
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
# The redesigned kernels' times before the redesign (CUDA events around one
# call, median), from the chip run of commit 7802f6a (PERF.md section 6;
# NVIDIA H100 80GB HBM3, 700.00 W): printed beside this run's times.
MS_BEFORE = {"knn_mean": 21.12, "nn1 icp_group": 0.0843, "nn1 chamfer": 15.02,
             "ransac_score": 0.0947, "scan_fused": 0.6463,
             "slab_mean_knn k=40": 54.81, "knn_mean k=40": 21.06}
BEFORE_FROM = "previous kernel, chip run of commit 7802f6a (PERF.md section 6)"
BEFORE_FROM_K40 = ("bisection kernel, chip runs of commits 7802f6a (slab_mean_knn) and "
                   "b796fbe (knn_mean) (PERF.md section 6)")
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
# The mesh arm meshes at depth 9 (the dense solve): at depth 10 its host
# extraction alone took 67 s of the script; phase 7 and the true-pose arm
# still run the depth-10 brick solve.
MESH_DEPTH = 9
# The mesh arm's gates: the JAX package's mesh_cloud of mesh_cloud() on the
# CPU at MESH_DEPTH (tools/torch_pipeline_reference.py --mesh).
MESH_JAX = {
    "surf_median_mm": 0.01822814154343888,
    "surf_p99_mm": 11.480059209312035,
    "to_merged_median_mm": 0.31726678052317286,
    "to_merged_p99_mm": 12.107095797276253,
    "from_merged_median_mm": 0.12398399907564436,
    "from_merged_p99_mm": 0.23348048184432754,
    "boundary_edges": 0,
    "nonmanifold_edges": 424}


# Phase 11's gates: the JAX package's errors on the same inputs on the CPU.
# POSEGRAPH_JAX: its merge_360_posegraph of the pose scene and the flagship
# views (tools/torch_merge_reference.py --method posegraph), with its loop-
# closure decision; STANDALONE_JAX: its ransac_global_registration and
# icp_point_to_plane on phase 11(c)'s inputs (--standalone); SURFACE_JAX: its
# mesh_cloud(mode='surface') of mesh_cloud()'s points
# (tools/torch_pipeline_reference.py --mesh --mesh-mode surface).
POSEGRAPH_JAX = {
    "pose": {"rot_max_deg": 0.03241526204213792, "trans_max_mm": 0.4240676461287093,
             "rot_median_deg": 0.017146736606979924,
             "trans_median_mm": 0.2528480328508235, "loop_closure": True},
    "flagship": {"surf_median_mm": 113.74800818585553, "surf_p99_mm": 224.90183808359023,
                 "loop_closure": True}}
STANDALONE_JAX = {
    "lumpy ransac": {"rot_deg": 0.34077346345985354, "trans_mm": 2.3457899767767403},
    "lumpy icp": {"rot_deg": 0.004177404294689227, "trans_mm": 0.0292038824674947},
    "large icp": {"rot_deg": 0.0013489626678874114, "trans_mm": 0.008671122000002075}}
SURFACE_JAX = {"faces": 511057, "surf_median_mm": 0.03402390588220783,
               "surf_p99_mm": 0.12912492856332847}

# Phase 12, the capture path. (a) CALIB_POSES chessboard poses
# (``synthetic.calibration_poses``: 6 x 9 inner corners, 10 mm squares,
# 400-600 mm from the camera, tilted up to 20 degrees) rendered through phase
# 2's rig lit by its 46-frame stack, captured by the port's sequencer and
# solved by its ``calibrate`` command. A 35 mm board (7 x 10 squares, 245 x
# 350 mm) does not fit the band the camera and the projector share on this
# rig (0.47 z - 80 mm tall: 85 mm at 350 mm, 203 mm at 600 mm), so the
# squares are 10 mm and the nearest board 400 mm away.
# Phase 15(b): run_pipeline over the first FLAGSHIP_VIEWS of phase 3's 1080p
# .slbp views (one render, per-view noise: the views share one pose).
FLAGSHIP_VIEWS = 3     # cut from 4 for phase 16's time
# Phase 15(a): knn_binmin's query rows at the 1080p cluster shape and at the
# merged cloud's normals shape (at the feature-prep shape every row); 15(b):
# the exact arm's query subset, its time scaled to the view
BINMIN_ROWS_VIEW = 4096
BINMIN_ROWS_NORMALS = 16384
# Phase 15(a): the points of binmin_edge_cases' clouds (2048 query rows each)
BINMIN_CASE_POINTS = 200_000
EXACT_ROWS = 65536
BINMIN_REPLACES = ("structured_light_for_3d_model_replication_tpu/ops/knn.py:188 "
                   "(not a pallas_call: lax.approx_min_k, also knn.py:260 and "
                   "pointcloud.py:418)")
FLAGSHIP_CLEAN_GATE = 0.01   # per-view clean counts within 1 % of the JAX package's
# The JAX package's clean chain on the CPU over the same views and config
# (tools/torch_flagship_reference.py): per view, the counts after each
# clean step (PIPE_STEPS) and the cleaned points' distance to the true
# sphere (median, p99, mm). The views' noise flips no decoded bit, so the
# four are one cloud.
FLAGSHIP_CLEAN_JAX = {
    "clean_counts": [[1061700, 203258, 196387, 196380, 186670]] * 4,
    "surf_mm": [[0.058363519555086896, 0.15746744417063696]] * 4}


def flagship_view_name(i: int) -> str:
    """Phase 3's name of its i-th .slbp view."""
    return f"view_{i * 45:03d}deg"


CALIB_POSES = 10
CALIB_BOARD = (6, 9, 10.0)            # inner corners (rows, cols), square mm
CALIB_DEPTHS = (400.0, 600.0)
CALIB_SET = ["--set", "checkerboard.rows=6", "--set", "checkerboard.cols=9",
             "--set", "checkerboard.square_size_mm=10"]
# Each error of the recovered calibration against the true rig is gated at
# GATE x the JAX package's on the same renders, or at this floor, the larger.
CALIB_FLOOR = {"px": 0.05, "deg": 0.01, "mm": 0.05}
# (c) the undistort stack's lens
UNDISTORT_DIST = (-0.28, 0.12, 1e-3, -5e-4, -0.02)
# (d) auto-scan over the HTTP rendezvous: phase 7's 24 views, a simulated
# turntable turning in this many seconds
CAPTURE_TURN_S = 0.05
# The JAX package on the CPU on the same renders (tools/torch_calib_reference.py):
# its calibrate command's errors against the true rig, and its reconstruct
# of phase 2's view 0 with that calibration (the points' distance to the
# true surfaces, mm), in each plane_eval lane and with the true calibration.
CALIB_JAX = {
    "calib": {"cam_fx_px": 0.799363334282134, "cam_fy_px": 0.785528799997337,
              "cam_cx_px": 2.244808369263069, "cam_cy_px": 0.7057144901959873,
              "proj_fx_px": 15.013744106946433, "proj_fy_px": 15.830017679457342,
              "proj_cx_px": 37.26694369223253, "proj_cy_px": 34.087673598010724,
              "R_deg": 1.302878556941357, "T_mm": 0.4863608246536598, "rms_px": 0.4477},
    "recon": {"table": [2.704376220703125, 9.27215576171875, 1061700],
              "quadratic": [2.704345703125, 9.272156372070313, 1061700],
              "true": [0.15185546875, 0.44482421875, 1061700]}}


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


def device_ms(fn, reps: int, kernel: str, tries: int = 3) -> float:
    """Mean device time (ms) of the CUDA kernel whose name holds ``kernel``
    over reps calls of fn, from torch.profiler's kernel records. The
    profiler may miss the launches just after it starts, at times every
    launch of a window of three: each window opens with 16 launches of a
    small other kernel that take those losses, the mean is over the records
    it kept, and a window with none is profiled again, up to ``tries``
    windows. For a kernel shorter than its wrapper's host path (tens of
    microseconds), the events around one call time that path, not the
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    pad = torch.zeros(1024, device="cuda")
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(16):
                pad.add_(1.0)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for e in prof.key_averages():
            if kernel in e.key:
                t = getattr(e, "self_device_time_total", None)
                us += t if t is not None else e.self_cuda_time_total
                count += e.count
        if count:
            break
    check(0 < count <= reps, f"profiler saw {count} launches of {kernel} in {reps} calls, "
                             f"{tries} windows")
    return us / count / 1e3


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time for the work on this card: bytes over the memory rate or
    operations over the 32-bit rate, the larger (ms)."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def issue_ceiling(instructions: int) -> float:
    """ms for that many lane instructions at LANE_INSTR_PER_S (no FMA)."""
    return instructions / LANE_INSTR_PER_S * 1e3


def binmin_bound(n: int, r: int, m: int, st: dict) -> dict:
    """knn_binmin's least time for one call (ms) from the screen's counts
    ``st`` of that call (binmin_stats): the bytes (the cloud and the rows
    read once, the [r, m] winners written once) over the memory rate; the
    tensor cores' screen, BINMIN_SCREEN_FLOPS a screened pair, over the
    dense bf16 rate; the CUDA cores' instructions, BINMIN_SCREEN_INSTR a
    screened pair and BINMIN_EXACT_INSTR a confirm or exact-sweep pair, at
    the issue rate. ``bound_ms`` is the largest, ``bound_unit`` which; the
    CUDA-core yardstick is the old sweep's work, 9 operations every pair at
    the 32-bit rate, as rows 6-10 count."""
    pairs = st["screened_rows"] * n
    terms = {"bytes": (n * 12 + r * 4 + r * m * 8) / MEM_BYTES_PER_S * 1e3,
             "tensor cores": pairs * BINMIN_SCREEN_FLOPS / TC_BF16_FLOPS_PER_S * 1e3,
             "CUDA-core issue": issue_ceiling(pairs * BINMIN_SCREEN_INSTR + BINMIN_EXACT_INSTR
                                              * (st["confirms"] + st["exact_pairs"]))}
    unit = max(terms, key=terms.get)
    return {"bound_ms": terms[unit], "bound_by": "bytes" if unit == "bytes" else "operations",
            "bound_unit": unit, "bound_terms_ms": terms,
            "cuda_core_yardstick_ms": r * n * 9 / OPS_PER_S * 1e3}


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
        extra={"gt_exact_share_of_lit": gt_share,
               "device_ms": device_ms(lambda: kernels.decode_maps(frames, thr, **kw), 20,
                                      "decode_maps_kernel")}))

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
        err=err2, bound=bound(nbytes, v * hw * (2 + 3 * n_bits + 4)),
        extra={"device_ms": device_ms(
            lambda: kernels.decode_packed_maps(planes, white, black, thr, **pkw), 20,
            "decode_packed_kernel")}))
    # the packed decode where its index map or bit extraction can go wrong,
    # each bit-equal to the plain version: seeded random planes of one plane
    # byte (8 pairs) and of eight (62 pairs, two 31-bit axes), one view,
    # H*W a multiple of 4 but not of 16 (1080 x 1001) and of neither (1079 x
    # 1001: one pixel a thread), stacks truncated to 16 and to 8 of the 22
    # pairs (the missing pairs decode as 0: the row axis, then both) and
    # downsample 2
    g = np.random.default_rng(2)

    def rand_planes(n_planes):
        return torch.from_numpy(g.integers(0, 256, (2, n_planes, h, w), dtype=np.uint8)).to(dev)

    def cut(t, hh, ww):
        return t[..., :hh, :ww].contiguous()

    wb2 = (white[:2], black[:2], thr[:2])
    for case, pl_, wh_, bl_, th_, ckw in (
            ("Pb=1", rand_planes(1), *wb2,
             dict(n_pairs=8, n_bits_col=5, n_bits_row=3, n_use_col=5, n_use_row=3)),
            ("Pb=8", rand_planes(8), *wb2,
             dict(n_pairs=62, n_bits_col=31, n_bits_row=31, n_use_col=31, n_use_row=31)),
            ("V=1", planes[:1], white[:1], black[:1], thr[:1], pkw),
            ("1080x1001", cut(planes[:2], 1080, 1001), cut(white[:2], 1080, 1001),
             cut(black[:2], 1080, 1001), thr[:2], pkw),
            ("1079x1001", cut(planes[:2], 1079, 1001), cut(white[:2], 1079, 1001),
             cut(black[:2], 1079, 1001), thr[:2], pkw),
            ("truncated to 16 pairs", planes[:, :2].contiguous(), white, black, thr,
             dict(pkw, n_pairs=16)),
            ("truncated to 8 pairs", planes[:, :1].contiguous(), white, black, thr,
             dict(pkw, n_pairs=8)),
            ("downsample 2", planes, white, black, thr, dict(pkw, downsample=2))):
        ko = kernels.decode_packed_maps(pl_, wh_, bl_, th_, **ckw)
        po = kernels.decode_packed_maps_plain(pl_, wh_, bl_, th_, **ckw)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, b)) for a, b in zip(ko, po))
        check(same, f"decode_packed_maps {case}: differs from its plain version")
        print(json.dumps({"kernel": "decode_packed_maps", "case": case,
                          "shape": list(pl_.shape), "n_pairs": ckw["n_pairs"], "bit_equal": same,
                          "ms": time_ms(lambda: kernels.decode_packed_maps(pl_, wh_, bl_, th_,
                                                                           **ckw), reps=10)}),
              flush=True)
        del ko, po

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
               "gt_err_p99_mm": float(np.percentile(gerr, 99)),
               "device_ms": device_ms(
                   lambda: kernels.scan_fused(frames, thr, scalars, sc.rays, **fkw), 20,
                   "scan_fused_bulk_kernel"),
               "ms_before": MS_BEFORE["scan_fused"], "ms_before_from": BEFORE_FROM}))
    # the bulk kernel's other shapes, each against the plain version under
    # the same tolerances: row_mode 0 (no row frames streamed, more stages),
    # one view, and a width whose pixel count is not a whole number of the
    # kernel's 1024-pixel tiles (1080 x 1000: a ragged last tile)
    rays_hw = sc.rays.view(h, w, 3)
    for case, fr, th, ry, rkw in (
            ("row_mode 0", frames, thr, sc.rays, dict(fkw, row_mode=0)),
            ("V=1", frames[:1], thr[:1], sc.rays, fkw),
            ("ragged tile 1080x1000", frames[:2, :, :, :1000].contiguous(), thr[:2],
             rays_hw[:, :1000].reshape(-1, 3).contiguous(), fkw)):
        ko = kernels.scan_fused(fr, th, scalars, ry, **rkw)
        po = kernels.scan_fused_plain(fr, th, scalars, ry, **rkw)
        torch.cuda.synchronize()
        c_flip = float((ko[1] != po[1]).float().mean())
        c_both = ko[1] & po[1]
        c_err = float((ko[0] - po[0]).abs()[c_both].max())
        check(c_flip < 2e-3 and c_err < 1e-2 and bool(torch.equal(ko[2], po[2])),
              f"scan_fused {case}: valid flips {c_flip}, max |dp| {c_err} mm, "
              f"texture equal {bool(torch.equal(ko[2], po[2]))}")
        print(json.dumps({"kernel": "scan_fused", "case": case, "shape": list(fr.shape),
                          "valid_flip_share": c_flip, "max_abs_err": c_err,
                          "valid_points": int(ko[1].sum()),
                          "ms": time_ms(lambda: kernels.scan_fused(fr, th, scalars, ry, **rkw),
                                        reps=10)}), flush=True)
        del ko, po, c_both

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

    # the pallas_call sites; the views variants (:673, :1019) are the same
    # kernels with a view grid axis, named in replaces_views, so the kernels
    # line covers all ten sites
    replaces = {"decode_maps": f"{PALLAS}:637", "decode_packed_maps": f"{PALLAS}:987",
                "scan_fused": f"{PALLAS}:823"}
    views_sites = {"decode_maps": f"{PALLAS}:673", "decode_packed_maps": f"{PALLAS}:1019"}
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
        if r["name"] in views_sites:
            line["replaces_views"] = views_sites[r["name"]]
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
            # one launch a batch: a batch that fell back to per-view compute
            # would launch more, or another kernel
            n_batches = -(-RECON_VIEWS // RECON_BATCH)
            check(counts[kernel] == n_batches and sum(counts.values()) == n_batches,
                  f"{arm} arm launched {counts}, not {kernel} once for each of "
                  f"{n_batches} batches")
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


def _write_png_views(data: str, frames_np, n_views: int) -> list[int]:
    """n_views capture folders of numbered PNG frames, view i holding
    frames_np[i % V]. The port's writer filters each row as libpng's
    default heuristic does (adaptive), so the reader meets the filter mix
    a capture written by libpng holds; each distinct view is encoded once,
    on a pool, and copied for its repeats. Returns the rows written with
    each filter (None, Sub, Up, Average, Paeth) over the distinct views."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from structured_light_for_3d_model_replication_tpu_torch.io import png

    folders = [os.path.join(data, f"view_{i * 36:03d}deg") for i in range(n_views)]
    jobs = []
    for i in range(min(n_views, len(frames_np))):
        os.makedirs(folders[i])
        for k, frame in enumerate(frames_np[i]):
            jobs.append((os.path.join(folders[i], f"{k + 1:02d}.png"), frame))
    with ThreadPoolExecutor(max_workers=8) as pool:
        kinds = list(pool.map(lambda job: png.write_png(*job), jobs))
    for i in range(len(frames_np), n_views):
        shutil.copytree(folders[i % len(frames_np)], folders[i])
    return np.bincount(np.concatenate(kinds), minlength=5).tolist()


def _png_reader() -> str:
    """The frame loader's PNG decoder on this machine: the native stack
    decoder where it is built, else the first Python reader."""
    from structured_light_for_3d_model_replication_tpu_torch.io import native

    return "native (io/csrc/slio.cpp)" if native.available() else _python_png_reader()


def _python_png_reader() -> str:
    """The Python PNG decoder ``io/images.load_gray`` takes here."""
    for mod in ("cv2", "PIL"):
        try:
            __import__(mod)
            return mod
        except ImportError:
            pass
    return "io/png.py"


def _lane_threads() -> list[str]:
    """Live threads of the reconstruct lanes and the register lane."""
    import threading

    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(LANE_THREADS))


def executor_phase(dev, rig, frames_np, card: str) -> None:
    """Phase 9(a): ``reconstruct`` over EXEC_VIEWS views of the phase-2
    render, written once as PNG frame folders with libpng's adaptive row
    filters (loading decodes them with cv2, else PIL, else the port's own
    reader; the phase prints which) and
    once as .slbp containers, in four arms: serial, pipelined, batched
    (compute_batch 4: a full batch and a ragged tail of 2) and packed
    (the batched lane on the .slbp views). Gates: every arm's PLYs equal the
    serial arm's byte for byte; the decode kernel launches once a view in
    the per-view arms and once a batch in the batched arms, and nothing
    else; no failure; no lane thread outlives a run. Each arm prints its
    wall, views/s, the OverlapStats lanes against the critical path, the
    bytes uploaded from pinned memory and the peak device memory."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    with tempfile.TemporaryDirectory(prefix="slscan_exec_") as root:
        t0 = time.perf_counter()
        calib = os.path.join(root, "calib.npz")
        matfile.save_calibration(calib, rig.calibration())
        png_dir, slbp_dir = os.path.join(root, "png"), os.path.join(root, "slbp")
        filters = _write_png_views(png_dir, frames_np, EXEC_VIEWS)
        for i in range(EXEC_VIEWS):
            imio.save_packed_stack(os.path.join(slbp_dir, f"view_{i * 36:03d}deg"),
                                   imio.pack_stack(frames_np[i % len(frames_np)]))
        print(f"executor views: {EXEC_VIEWS} written as PNG and .slbp in "
              f"{time.perf_counter() - t0:.1f}s; PNG rows by filter (None, Sub, Up, "
              f"Average, Paeth): {filters}; PNG reader: {_png_reader()}", flush=True)
        n_batches = -(-EXEC_VIEWS // EXEC_BATCH)
        outs = {}
        for arm, over, data, kernel, want in (
                ("serial", {"parallel.io_workers": 1, "parallel.compute_batch": 1},
                 png_dir, "decode_maps", EXEC_VIEWS),
                ("pipelined", {"parallel.io_workers": 4, "parallel.compute_batch": 1},
                 png_dir, "decode_maps", EXEC_VIEWS),
                ("batched", {"parallel.io_workers": 4, "parallel.compute_batch": EXEC_BATCH,
                             "parallel.prefetch_depth": 2}, png_dir, "decode_maps",
                 n_batches),
                ("packed", {"parallel.io_workers": 4, "parallel.compute_batch": EXEC_BATCH,
                            "parallel.prefetch_depth": 2, "pipeline.packed_ingest": True},
                 slbp_dir, "decode_packed_maps", n_batches)):
            cfg = load_config(None, {"decode.n_cols": PROJ[0], "decode.n_rows": PROJ[1],
                                     **over})
            out = os.path.join(root, f"out_{arm}")
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            report = stages.reconstruct(calib, data, mode="batch", output=out, cfg=cfg,
                                        device=dev, log=lambda m: None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            o = report.overlap or {}
            print(json.dumps({
                "executor": arm, "lane": report.lane, "wall_s": wall,
                "views_per_s": len(report.outputs) / wall, "launches": counts,
                "lanes_s": {k: o.get(f"{k}_s") for k in ("load", "transfer", "compute",
                                                          "clean", "write")},
                "critical_path_s": o.get("critical_path_s"),
                "serial_sum_s": o.get("serial_sum_s"),
                "max_queue_depth": o.get("max_queue_depth"),
                "bytes_pinned": o.get("transfer_bytes_pinned"),
                "bytes_frames": o.get("transfer_bytes_frames"),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "card": card, "clocks": clocks()}), flush=True)
            check(report.lane == arm, f"executor {arm}: ran the {report.lane} lane")
            check(report.failures == [] and len(report.outputs) == EXEC_VIEWS,
                  f"executor {arm}: {len(report.outputs)} of {EXEC_VIEWS} views, failures "
                  f"{[f.as_dict() for f in report.failures]}")
            check(counts[kernel] == want and sum(counts.values()) == want,
                  f"executor {arm}: launched {counts}, not {kernel} {want} times")
            check(arm == "serial" or (o.get("transfer_bytes_pinned") or 0) > 0,
                  f"executor {arm}: nothing uploaded from pinned memory")
            t_end = time.monotonic() + 10.0   # idle pool threads exit within moments
            while _lane_threads() and time.monotonic() < t_end:
                time.sleep(0.01)
            check(not _lane_threads(), f"executor {arm}: lane threads {_lane_threads()} "
                                       f"outlived the run by 10 s")
            outs[arm] = out
        names = sorted(os.listdir(outs["serial"]))
        check(len(names) == EXEC_VIEWS, f"executor: serial arm wrote {names}")
        for arm, out in outs.items():
            check(sorted(os.listdir(out)) == names, f"executor {arm}: {os.listdir(out)}")
            for name in names:
                with open(os.path.join(out, name), "rb") as a, \
                        open(os.path.join(outs["serial"], name), "rb") as b:
                    check(a.read() == b.read(),
                          f"executor {arm}: {name} differs from the serial arm's")
        native_load_phase(png_dir, card)


def bitexact_phase(dev, rig, frames_np, card: str) -> None:
    """Phase 10(a): ``reconstruct`` on the card with
    ``triangulate.bitexact=true`` over BITEXACT_VIEWS views of the phase-2
    render (.slbp), then the same views with ``parallel.backend=numpy``
    (decode and triangulation on the host). Gates: every PLY of the
    bit-exact arm equals the numpy arm's byte for byte; the bit-exact arm
    launches decode_maps once a view and nothing else, the numpy arm no
    kernel; both take the per-view pipelined lane; no failure. Prints each
    arm's views/s and the bit-exact arm's host triangulation seconds a view
    (maps fetched from the card and triangulated by the NumPy twin)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile, ply
    from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import triangulate as tri
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    with tempfile.TemporaryDirectory(prefix="slscan_bitexact_") as root:
        calib = os.path.join(root, "calib.npz")
        matfile.save_calibration(calib, rig.calibration())
        data = os.path.join(root, "scans")
        for i in range(BITEXACT_VIEWS):
            imio.save_packed_stack(os.path.join(data, f"view_{i * 90:03d}deg"),
                                   imio.pack_stack(frames_np[i % len(frames_np)]))
        outs, walls = {}, {}
        for arm, over, want in (("bitexact", {"triangulate.bitexact": True}, BITEXACT_VIEWS),
                                ("numpy", {"parallel.backend": "numpy"}, 0)):
            cfg = load_config(None, {"decode.n_cols": PROJ[0], "decode.n_rows": PROJ[1],
                                     **over})
            out = os.path.join(root, f"out_{arm}")
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            report = stages.reconstruct(calib, data, mode="batch", output=out, cfg=cfg,
                                        device=dev, log=lambda m: None)
            torch.cuda.synchronize()
            walls[arm] = time.perf_counter() - t0
            counts = kernels.launch_counts()
            check(report.failures == [] and len(report.outputs) == BITEXACT_VIEWS,
                  f"bitexact {arm}: {len(report.outputs)} of {BITEXACT_VIEWS} views, "
                  f"failures {[f.as_dict() for f in report.failures]}")
            check(report.lane == "pipelined", f"bitexact {arm}: ran the {report.lane} lane")
            check(counts["decode_maps"] == want and sum(counts.values()) == want,
                  f"bitexact {arm}: launched {counts}, not decode_maps {want} times")
            for p in report.outputs:
                pts = ply.read_ply(p)["points"]
                check(pts.shape[0] > 0.05 * CAM[0] * CAM[1] and bool(np.isfinite(pts).all()),
                      f"bitexact {arm}: bad cloud {p}")
            outs[arm] = out
            print(json.dumps({"bitexact": arm, "lane": report.lane, "wall_s": walls[arm],
                              "views_per_s": BITEXACT_VIEWS / walls[arm], "launches": counts,
                              "points_per_view": report.points, "card": card}), flush=True)
        names = sorted(os.listdir(outs["numpy"]))
        check(len(names) == BITEXACT_VIEWS and names == sorted(os.listdir(outs["bitexact"])),
              f"bitexact: PLYs {names}")
        for name in names:
            with open(os.path.join(outs["bitexact"], name), "rb") as a, \
                    open(os.path.join(outs["numpy"], name), "rb") as b:
                check(a.read() == b.read(), f"bitexact: {name} differs from the numpy arm's")
        calib_d = matfile.load_calibration(calib)
        host_s = []
        for i in range(BITEXACT_VIEWS):
            frames = frames_np[i % len(frames_np)]
            dec = gc.decode_stack(frames, n_cols=PROJ[0], n_rows=PROJ[1], device=dev)
            texture = np.repeat(frames[0][..., None], 3, axis=-1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tri.triangulate(dec.col_map, dec.row_map, dec.mask, texture, calib_d,
                            bitexact=True)
            host_s.append(time.perf_counter() - t0)
        print(json.dumps({"bitexact": "host triangulation", "views": BITEXACT_VIEWS,
                          "s_per_view": host_s, "median_s": float(np.median(host_s)),
                          "card": card}), flush=True)


def native_load_phase(png_dir: str, card: str) -> None:
    """Phase 10(b), loads: prints ``native: built <path>`` or ``native:
    unavailable: <what is missing>``; when built, the first
    NATIVE_LOAD_VIEWS PNG folders of phase 9(a) loaded through the native
    stack decoder must equal the Python reader's arrays (cv2 where present)
    byte for byte; prints both loads' seconds a view."""
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import native

    path, missing = native.status()
    print(f"native: built {os.path.relpath(path)}" if path else
          f"native: unavailable: {missing}", flush=True)
    if path is None:
        return
    t_native, t_python = [], []
    for view in sorted(os.listdir(png_dir))[:NATIVE_LOAD_VIEWS]:
        files = imio.list_frame_files(os.path.join(png_dir, view))
        t0 = time.perf_counter()
        w, h, _ = native.probe_png(files[0])
        stack = native.load_gray_stack(files, w, h)
        t_native.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ref = np.stack([imio.load_gray(f) for f in files])
        t_python.append(time.perf_counter() - t0)
        check(stack is not None and stack.shape == ref.shape
              and stack.tobytes() == ref.tobytes(),
              f"native: {view} differs from {_python_png_reader()}'s arrays")
    print(json.dumps({"native_load": NATIVE_LOAD_VIEWS, "frames_per_view": len(files),
                      "native_s_per_view": t_native, "python_s_per_view": t_python,
                      "python_reader": _python_png_reader(), "card": card}), flush=True)


def native_write_phase(cold_out: str, card: str) -> None:
    """Phase 10(b), writes: phase 7's merged.ply and model.stl were written
    by the native writers (>= 100,000 points, >= 50,000 faces). Gates: the
    PLY's records equal the Python writer's bytes for the same arrays and
    its header differs by the ``comment slio native writer`` line alone;
    the STL rewritten natively from its own triangles is the same file, and
    against the Python writer its vertex and attribute bytes are equal and
    its float32 normals within 1e-4 of the float64-normalized ones (the
    80-byte headers differ). Prints both writers' seconds."""
    from structured_light_for_3d_model_replication_tpu_torch.io import native, ply, stl

    if not native.available():
        print("native: unavailable, phase 7 wrote with the Python writers", flush=True)
        return
    timing = {}
    with tempfile.TemporaryDirectory(prefix="slscan_native_") as tmp:
        merged = os.path.join(cold_out, "merged.ply")
        with open(merged, "rb") as f:
            raw = f.read()
        d = ply.read_ply(merged)
        t0 = time.perf_counter()
        ply._write_ply_py(os.path.join(tmp, "py.ply"), d["points"], d.get("colors"), None,
                          True)
        timing["ply_python_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ply.write_ply(os.path.join(tmp, "nat.ply"), d["points"], d.get("colors"))
        timing["ply_native_s"] = time.perf_counter() - t0
        with open(os.path.join(tmp, "py.ply"), "rb") as f:
            ref = f.read()
        with open(os.path.join(tmp, "nat.ply"), "rb") as f:
            check(f.read() == raw, "native: merged.ply rewritten natively differs")
        head, body = raw.split(b"end_header\n", 1)
        rhead, rbody = ref.split(b"end_header\n", 1)
        check(len(d["points"]) >= 100_000 and b"comment slio native writer\n" in head,
              "native: phase 7's merged.ply was not written natively")
        check(body == rbody and head.replace(b"comment slio native writer\n", b"") == rhead,
              "native: merged.ply's records or header differ from the Python writer's")
        model = os.path.join(cold_out, "model.stl")
        with open(model, "rb") as f:
            raw = f.read()
        verts, faces, _ = stl.read_stl(model)
        check(len(faces) >= 50_000 and raw.startswith(b"slio native stl"),
              "native: phase 7's model.stl was not written natively")
        t0 = time.perf_counter()
        stl.write_stl(os.path.join(tmp, "nat.stl"), verts, faces)
        timing["stl_native_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stl.write_stl(os.path.join(tmp, "py.stl"), verts, faces,
                      normals=stl.face_normals(verts, faces))
        timing["stl_python_s"] = time.perf_counter() - t0
        with open(os.path.join(tmp, "nat.stl"), "rb") as f:
            check(f.read() == raw, "native: model.stl rewritten natively differs")
        with open(os.path.join(tmp, "py.stl"), "rb") as f:
            ref = f.read()
        rec = np.dtype([("normal", "<f4", 3), ("v", "<f4", 9), ("attr", "<u2")])
        a, b = np.frombuffer(raw[84:], rec), np.frombuffer(ref[84:], rec)
        dn = float(np.abs(a["normal"] - b["normal"]).max())
        check(raw[80:84] == ref[80:84] and a["v"].tobytes() == b["v"].tobytes()
              and a["attr"].tobytes() == b["attr"].tobytes() and dn < 1e-4,
              f"native: model.stl differs from the Python writer's (normals by {dn})")
    print(json.dumps({"native_write": {"points": int(len(d["points"])),
                                       "faces": int(len(faces)), **timing,
                                       "stl_normal_max_diff": dn}, "card": card}), flush=True)


def report_phase(out: str, card: str) -> None:
    """Phase 10(c): the port's ``report`` over phase 9(b)'s traced run:
    ``--validate`` exits 0, the report renders, ``--prometheus`` prints the
    run's metrics, ``--chrome-trace`` writes a trace with a track for each
    executor thread (prefetch, drain, register). Prints the lane and track
    counts."""
    import contextlib
    import io

    from structured_light_for_3d_model_replication_tpu_torch import cli

    def run(*argv) -> tuple[int, str]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["report", out, *argv])
        return rc, buf.getvalue()

    rc, text = run("--validate")
    check(rc == 0 and "journal valid" in text, f"report --validate: rc {rc}: {text[-500:]}")
    rc, text = run()
    check(rc == 0 and text.startswith("flight recorder report") and "clean close" in text,
          f"report: rc {rc}: {text[-500:]}")
    print(text, flush=True)
    rc, prom = run("--prometheus")
    check(rc == 0 and "# TYPE sl3d_run_wall_seconds gauge" in prom,
          f"report --prometheus: rc {rc}: {prom[-500:]}")
    trace = os.path.join(out, "trace.json")
    rc, text = run("--chrome-trace", trace)
    check(rc == 0 and os.path.isfile(trace), f"report --chrome-trace: rc {rc}: {text}")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    tracks = sorted(e["args"]["name"] for e in events if e.get("name") == "thread_name")
    lanes = sorted({t.split(" [")[0] for t in tracks})
    for th in ("sl3d-prefetch", "sl3d-drain", "sl3d-register"):
        check(any(f"[{th}" in t for t in tracks), f"report: no track of a {th} thread in "
                                                   f"{tracks}")
    print(json.dumps({"report": "chrome trace", "lanes": lanes, "n_lanes": len(lanes),
                      "tracks": tracks, "n_tracks": len(tracks),
                      "prometheus_lines": len(prom.splitlines()), "card": card}), flush=True)


def artifacts_phase(dev, ply_dir: str, root: str, host: dict, card: str) -> None:
    """Phase 10(d): phase 5's flagship merge again through ``merge-360
    --artifacts``, whose step callback closes the device arm's gate: the
    host-list arm. Gates: merged.ply equals phase 5's host-list arm's byte
    for byte; one ``merge_step_NN.ply`` a chain step after the base view and
    ``progress.json``; nn1 and ransac_score launch as many times as in that
    host-list run."""
    import contextlib
    import io

    import torch

    from structured_light_for_3d_model_replication_tpu_torch import cli
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

    art = os.path.join(root, "artifacts")
    out = os.path.join(root, "merged_artifacts.ply")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["merge-360", ply_dir, out, "--artifacts", art,
                       "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(rc == 0, f"merge-360 --artifacts: exit {rc}")
    with open(out, "rb") as a, open(os.path.join(root, "merged_flagship_host.ply"), "rb") as b:
        check(a.read() == b.read(), "merge-360 --artifacts: merged.ply differs from "
                                    "phase 5's host-list arm")
    names = sorted(os.listdir(art))
    want = [f"merge_step_{i:02d}.ply" for i in range(1, MERGE_VIEWS)] + ["progress.json"]
    check(names == want, f"merge-360 --artifacts: wrote {names}")
    with open(os.path.join(art, "progress.json")) as f:
        steps = [e["step"] for e in json.load(f)]
    check(steps == list(range(1, MERGE_VIEWS)), f"merge-360 --artifacts: progress {steps}")
    for k in ("nn1", "ransac_score"):
        check(counts[k] == host["counts"][k],
              f"merge-360 --artifacts: {k} launched {counts[k]} times, phase 5's host-list "
              f"arm {host['counts'][k]}")
    print(json.dumps({"artifacts": "merge-360", "wall_s": wall, "launches": counts,
                      "files": len(names), "card": card}), flush=True)


def _cloud_bytes(overlap: dict) -> int:
    """The cloud path's device<->host bytes: all of them less the frame
    uploads."""
    return (overlap.get("transfer_bytes_h2d", 0) - overlap.get("transfer_bytes_frames", 0)
            + overlap.get("transfer_bytes_d2h", 0))


def fused_phase(dev, data: str, calib: str, root: str, cold: dict, card: str) -> None:
    """Phase 9(b): ``run_pipeline`` over the 24 views with
    ``pipeline.fused_clean=true`` and the flight recorder on
    (``observability.trace``, read by phase 10(c)) in a fresh directory,
    beside phase 7's cold run. Gates: merged.ply, model.stl and every view PLY byte-identical
    to the cold run's; decode_maps once a batch, radius_count 2 a view, nn1,
    ransac_score and slab_mean_knn as many launches as the cold run; no
    failure. Prints both runs' walls and cloud bytes between the card and
    the host."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    cfg = load_config(None, {**PIPE_OVERRIDES, "pipeline.fused_clean": True,
                             "observability.trace": True})
    out = os.path.join(root, "pipeline_fused")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = stages.run_pipeline(calib, data, out, cfg=cfg, device=dev, log=lambda m: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    o, oc = report.overlap or {}, cold["report"].overlap or {}
    print(json.dumps({
        "fused": "pipeline", "wall_s": wall, "cold_wall_s": cold["wall_s"],
        "cloud_bytes": _cloud_bytes(o), "cold_cloud_bytes": _cloud_bytes(oc),
        "d2h": o.get("transfer_bytes_d2h"), "cold_d2h": oc.get("transfer_bytes_d2h"),
        "fused_view": o.get("kernels", {}).get("fused_view"),
        "lanes_s": {k: o.get(f"{k}_s") for k in ("load", "transfer", "compute", "clean",
                                                  "write", "register")},
        "critical_path_s": o.get("critical_path_s"),
        "cold_lanes_s": {k: oc.get(f"{k}_s") for k in ("load", "transfer", "compute",
                                                        "clean", "write", "register")},
        "cold_critical_path_s": oc.get("critical_path_s"),
        "walls_s": report.walls_s, "launches": counts,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "card": card, "clocks": clocks()}), flush=True)
    check(report.failures == [] and report.views_computed == PIPE_VIEWS,
          f"fused: {report.views_computed} views computed, failures "
          f"{[f.as_dict() for f in report.failures]}")
    cold_out = cold["out"]
    for name in ("merged.ply", "model.stl"):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(cold_out, name), "rb") as b:
            check(a.read() == b.read(), f"fused: {name} differs from phase 7's cold run")
    views = sorted(os.listdir(os.path.join(cold_out, "views")))
    check(views == sorted(os.listdir(os.path.join(out, "views"))) and len(views) == PIPE_VIEWS,
          "fused: the view PLYs differ in number from phase 7's")
    for name in views:
        with open(os.path.join(out, "views", name), "rb") as a, \
                open(os.path.join(cold_out, "views", name), "rb") as b:
            check(a.read() == b.read(), f"fused: view {name} differs from phase 7's")
    n_batches = -(-PIPE_VIEWS // cfg.parallel.compute_batch)
    check(counts["decode_maps"] == n_batches and counts["radius_count"] == 2 * PIPE_VIEWS,
          f"fused: launched {counts}")
    for k in ("nn1", "ransac_score", "slab_mean_knn"):
        check(counts[k] == cold["counts"][k],
              f"fused: {k} launched {counts[k]} times, the cold run {cold['counts'][k]}")
    check(_cloud_bytes(o) * 3 <= _cloud_bytes(oc),
          f"fused: {_cloud_bytes(o)} cloud bytes, not 3x fewer than the cold run's "
          f"{_cloud_bytes(oc)}")


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


def render_pipeline_views(root: str, raw: list | None = None):
    """The scan-to-print scene (``synthetic.pipeline_scene``): 24 turntable
    views at 768x576 stored as .slbp containers under root/scans (the
    white frame as their texture, as a capture packs it), with
    root/calib.npz; each view's raw frames appended to ``raw`` when given.
    Returns (data dir, calib path, scene)."""
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
            imio.pack_stack(frames, texture=np.repeat(frames[0][:, :, None], 3, axis=2)))
        if raw is not None:
            raw.append(frames)
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


def pose_accuracy_chord(transforms, poses) -> dict:
    """pose_accuracy with ``transform_error``'s chord angle, which resolves
    the hundredths of a degree the posegraph merge reaches (the trace's
    arccos rounds angles under ~0.03 degrees of a float32 rotation)."""
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    errs = [transform_error(T, truth)
            for T, truth in zip(transforms, syn.turntable_transforms(poses))]
    rot = np.array([e["rot_deg"] for e in errs])
    trans = np.array([e["trans_mm"] for e in errs])
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


# Phase 11(c)'s large ICP: the flagship cloud (``flagship_cloud``, 182,828
# rows, above the JAX package's 131,072-row Mosaic gate) with 0.05 mm of
# seeded noise, moved by the inverse of this known transform (degrees about
# y, mm): ICP must bring it back.
BIG_ICP_MOTION = (2.0, (1.0, -0.5, 0.8))


def known_transform(deg: float, t) -> np.ndarray:
    """A rotation of ``deg`` degrees about y and a translation, 4x4 f32."""
    a = np.radians(deg)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    T[:3, 3] = t
    return T


def big_icp_inputs(cloud: np.ndarray):
    """(src, dst, T): dst the cloud, src its noisy copy that T maps onto it."""
    T = known_transform(*BIG_ICP_MOTION)
    noisy = cloud + np.random.default_rng(0).normal(0, 0.05, cloud.shape)
    src = ((noisy - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    return src, np.asarray(cloud, np.float32), T


def transform_error(T, truth) -> dict:
    """Rotation (degrees) and translation (mm) error of one 4x4 transform.
    The angle comes from the chord, 2 asin(|R - R_true|_F / (2 sqrt 2)),
    which resolves the small angles a trace's arccos rounds to zero."""
    T = np.asarray(T, np.float64)
    truth = np.asarray(truth, np.float64)
    chord = np.linalg.norm(T[:3, :3] - truth[:3, :3]) / (2 * np.sqrt(2))
    return {"rot_deg": float(np.degrees(2 * np.arcsin(min(chord, 1.0)))),
            "trans_mm": float(np.linalg.norm(T[:3, 3] - truth[:3, 3]))}


def flagship_cloud(dev, views, truth):
    """The flagship views merged at the true poses, after the 0.5 mm voxel
    (182,828 points): (cloud f32 [n, 3] padded to a multiple of 8192, valid,
    its slab input sorted by x (L = 188,416), the slab radius r)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc

    moved = recon.transform_views_batched(views[1:], truth[1:], device=dev)
    pts = torch.from_numpy(np.concatenate([views[0]] + moved)).to(dev)
    ones = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    p, _, v = pc.voxel_downsample(pts, torch.zeros_like(pts, dtype=torch.uint8), ones, 0.5)
    n_pad = min(-(-int(v.sum()) // 8192) * 8192, p.shape[0])
    cloud, valid = p[:n_pad].contiguous(), v[:n_pad]
    pts_s, _, r = pc._slab_inputs(cloud, valid, 0.5, 8192)
    return cloud, valid, pts_s, r


def _read_views(ply_dir: str):
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    paths = stages.sort_ply_paths_by_angle(
        [os.path.join(ply_dir, f) for f in os.listdir(ply_dir) if f.endswith(".ply")])
    return [ply.read_ply(p)["points"] for p in paths]


def mean_row(name, k_fn, p_fn, k, n_q, n_c, extra, every_row=False, real=None, kernel=None):
    """A k-NN-mean kernel against its plain version on the same inputs:
    counts (and window ends) bit-equal, means within rtol 1e-5 (the sums
    differ in order only) on the certified rows (count >= k), or on every
    row where ``every_row`` (rows with fewer than k within r, parked rows).
    The shares printed are over the ``real`` rows (all rows if None): the
    padding rows of a slab input coincide and count each other. Where
    ``kernel`` is named, the call must launch it (torch.profiler's kernel
    records; ``device_ms`` fails otherwise) and its device time is kept."""
    import torch

    if kernel is not None:
        extra = dict(extra, kernel=kernel, device_ms=device_ms(k_fn, 5, kernel))
    k_out = k_fn()
    p_out, plain_ms = _timed_once(p_fn)
    torch.cuda.synchronize()
    cnt_err = int((k_out[1] - p_out[1]).abs().max())
    check(cnt_err == 0, f"{name}: counts off the plain version by {cnt_err}")
    if len(k_out) == 3:
        check(bool(torch.equal(k_out[2], p_out[2])), f"{name}: window ends differ")
    ok = torch.ones_like(k_out[1], dtype=torch.bool) if every_row else k_out[1] >= k
    if real is None:
        real = torch.ones_like(ok)
    rel = ((k_out[0] - p_out[0]).abs() / p_out[0].abs().clamp_min(1e-9))[ok]
    err = float((k_out[0] - p_out[0]).abs()[ok].max())
    check(float(rel.max()) <= 1e-5, f"{name}: mean off by rtol {float(rel.max())}")
    # bytes: the rows once, mean + count (+ window end) out; operations:
    # what the function needs of a (query, candidate) pair, its d2 (3 sub,
    # 3 mul, 2 add) and one selection compare, as nn1 (the bisection
    # kernels' 31 extra passes are their algorithm's cost, not the
    # function's); the issue ceiling takes 10 a pair, one to act on the compare
    return dict(name=name.split(" ")[0], fn=k_fn, reps=5, plain_ms=plain_ms, err=err,
                bound=bound(n_q * 12 + n_q * 4 * len(k_out), n_q * n_c * 9),
                extra=dict(extra, case=name, issue_ceiling_ms=issue_ceiling(n_q * n_c * 10),
                           certified_share=float((k_out[1] >= k)[real].float().mean()),
                           fewer_than_k_share=float((p_out[1] < k)[real].float().mean())))


def select_kernel(kind: str, k: int) -> str:
    """The kernel a k-NN mean of k launches, by the name torch.profiler
    records: a selection kernel with 1, 2 or 4 list segments (k <= 32, 64,
    128), the bisection kernel above; kind "slab" or "knn"."""
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

    if k > kernels.SELECT_MAX_K:
        return "slab_knn_mean_kernel" if kind == "slab" else "knn_mean_kernel"
    return f"{kind}_select_kernel<{1 if k <= 32 else 2 if k <= 64 else 4}>"


def slab_library(pts_s, r: float, k: int, tile: int = 64, wblk: int = 8192):
    """The yardstick for slab_mean_knn (timed, never used by the port): per
    tile, torch.cdist to its 2 * wblk window (difference distances, no
    matrix-product expansion) and torch.topk of the k smallest, meaned;
    256 tiles a chunk. No self-exclusion or cutoff: the bulk of the work."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

    starts = kernels._slab_starts(pts_s, r, tile, wblk)
    span = torch.arange(2 * wblk, device=pts_s.device)
    out = []
    for s in range(0, starts.shape[0], 256):
        c0 = starts[s:s + 256]
        cand = pts_s[c0[:, None] + span[None, :]]
        q = pts_s[s * tile:(s + c0.shape[0]) * tile].view(-1, tile, 3)
        d = torch.cdist(q, cand, compute_mode="donot_use_mm_for_euclid_dist")
        out.append(torch.topk(d, k, dim=-1, largest=False).values.mean(-1).reshape(-1))
    return torch.cat(out)


def knn_library(pts, k: int):
    """The yardstick for knn_mean: torch.cdist over the whole cloud in 4096-row
    chunks and torch.topk of the k smallest, meaned."""
    import torch

    return torch.cat([torch.topk(torch.cdist(pts[s:s + 4096], pts,
                                             compute_mode="donot_use_mm_for_euclid_dist"),
                                 k, dim=-1, largest=False).values.mean(-1)
                      for s in range(0, pts.shape[0], 4096)])


def knn_float_topk(points, valid, k: int):
    """The yardstick for knn.knn at the cluster step's shape: torch.topk
    over the float difference distances of each [block, N] query block, the
    selection whose tie order is free (timed, never used by the port)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib

    n = points.shape[0]
    pts = knnlib._parked(points, valid)
    cols = torch.arange(n, device=pts.device)
    block = max(1, (1 << 26) // n)
    out = []
    for s in range(0, n, block):
        d2 = knnlib.sq_dist(pts[s:s + block, None, :], pts[None, :, :])
        rows = torch.arange(s, s + d2.shape[0], device=pts.device)
        d2.masked_fill_(rows[:, None] == cols[None, :], float("inf"))
        out.append(torch.topk(d2, k, dim=1, largest=False, sorted=True).indices)
    return torch.cat(out)


def knn_tie_check(dev, card: str) -> None:
    """The port's k-NN on exact ties, on the card: 3,000 lattice points
    (integer coordinates in [0, 6), seed 0), k = 16. The indices must equal
    a stable argsort of the distances on the CPU on every row: the lowest
    index first among equal distances."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib

    lat = torch.from_numpy(np.random.default_rng(0).integers(0, 6, (3000, 3)).astype(np.float32))
    ones = torch.ones(3000, dtype=torch.bool)
    idx, d2 = knnlib.knn(lat.to(dev), ones.to(dev), 16)
    dd = knnlib.sq_dist(lat[:, None, :], lat[None, :, :])
    dd.fill_diagonal_(float("inf"))
    ref = torch.sort(dd, dim=1, stable=True)
    rows_equal = float((idx.cpu() == ref.indices[:, :16].to(torch.int32)).all(1).float().mean())
    check(rows_equal == 1.0, f"knn lattice: indices equal a stable argsort on {rows_equal} of rows")
    check(torch.equal(d2.cpu(), ref.values[:, :16]), "knn lattice: distances differ")
    kth = ref.values[:, 15:16]
    tied = (dd == kth).sum(1) > (ref.values[:, :16] == kth).sum(1)
    print(json.dumps({"knn": "lattice ties", "rows": 3000, "k": 16, "idx_rows_equal": rows_equal,
                      "kth_tied_beyond_k_share": float(tied.float().mean()), "card": card}),
          flush=True)


def ransac_library(hm, pm, sc, md2: float):
    """The yardstick for ransac_score: one matrix product in full f32 (TF32
    off) and the compare."""
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return ((sc + 2 * hm @ pm.T) <= md2).sum(1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def merge_kernel_phase(dev, ply_dir: str, poses, card: str) -> list[dict]:
    """Phase 4: each merge kernel against its plain version, at the merge
    path's shapes, timed with CUDA events."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
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
        # 10 issued a pair: the 9 operations and the select on the compare
        extra = {"case": name, "shape": [q.shape[0], nq, nb],
                 "issue_ceiling_ms": issue_ceiling(q.shape[0] * nq * nb * 10)}
        lib_ms = None
        if name == "icp_group":  # a yardstick only: [P, Nq, Nb] fits here, not at chamfer size
            lib_ms = time_ms(lambda: torch.cdist(q, b).min(dim=-1), reps=5)
        if f"nn1 {name}" in MS_BEFORE:
            extra.update(device_ms=device_ms(lambda: kernels.nn1(q, b), reps, "nn1_kernel"),
                         ms_before=MS_BEFORE[f"nn1 {name}"], ms_before_from=BEFORE_FROM)
        return dict(name="nn1", fn=lambda: kernels.nn1(q, b), reps=reps, plain_ms=plain_ms,
                    library_ms=lib_ms,
                    err=err, bound=bound((q.numel() + b.numel()) * 4 + q.shape[0] * nq * 8,
                                         q.shape[0] * nq * nb * 9), extra=extra)

    rows.append(nn1_row("icp_group", q4, b4, reps=20))
    # nn1 where a reduction across lanes can go wrong, idx and d2 bit-equal
    # to the plain version in each: a lattice (integer coordinates, exact
    # ties; idx must be the lowest index at the least distance), a base
    # parked whole at knn.FAR (one d2 for every row; idx must be 0) and a
    # ragged shape (nq and nb multiples of neither 32 nor a block)
    g = np.random.default_rng(0)
    lat_b = torch.from_numpy(g.integers(0, 6, (1, 3000, 3)).astype(np.float32)).to(dev)
    lat_q = torch.from_numpy((g.integers(0, 12, (1, 2500, 3)) / 2).astype(np.float32)).to(dev)
    rows.append(nn1_row("lattice", lat_q, lat_b, reps=20))
    d = knnlib.sq_dist(lat_q[0][:, None, :], lat_b[0][None, :, :])
    least = d.min(1).values
    cols = torch.arange(d.shape[1], device=dev)
    lowest = torch.where(d == least[:, None], cols, d.shape[1]).min(1).values
    check(torch.equal(kernels.nn1(lat_q, lat_b)[0][0].long(), lowest),
          "nn1 lattice: an index is not the lowest at the least distance")
    rows[-1]["extra"]["tied_share"] = float(((d == least[:, None]).sum(1) > 1).float().mean())
    del d
    far = torch.full((1, 777, 3), knnlib.FAR, dtype=torch.float32, device=dev)
    rows.append(nn1_row("all_far", q4[:1, :1000].contiguous(), far, reps=20))
    check(bool((kernels.nn1(q4[:1, :1000].contiguous(), far)[0] == 0).all()),
          "nn1 all_far: an index is not 0")
    rows.append(nn1_row("ragged", q4[:, :1001].contiguous(), b4[:, :999].contiguous(), reps=20))

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
                     library_ms=time_ms(lambda: ransac_library(hm, pm, sc, md2), reps=20),
                     bound=bound(nt * 16 * 4 + nn * 17 * 4 + nt * 4, nt * nn * 34),
                     # issue ceiling: 35 a pair, the 34 operations and the count's add
                     extra={"shape": [nt, nn], "best_count": int(k_cnt.max()),
                            "issue_ceiling_ms": issue_ceiling(nt * nn * 35),
                            "device_ms": device_ms(
                                lambda: kernels.ransac_score(hm, pm, sc, md2), 20,
                                "ransac_score_kernel"),
                            "ms_before": MS_BEFORE["ransac_score"],
                            "ms_before_from": BEFORE_FROM}))
    # the edges of the block and span split, counts equal to the plain
    # version's: T and N both ragged (37 hypotheses, 2100 correspondences),
    # one correspondence, every correspondence dead (all counts 0), one
    # hypothesis, and P not 16-byte aligned (the 4-byte staging copies)
    pm_odd = torch.empty(pm.numel() + 1, dtype=torch.float32, device=dev)[1:].view(pm.shape)
    pm_odd.copy_(pm)
    for case, h_, p_, s_ in (
            ("T=37 N=2100", hm[:37], torch.cat([pm, pm[:52]]), torch.cat([sc, sc[:52]])),
            ("N=1", hm, pm[:1], sc[:1]),
            ("all dead", hm, pm, torch.full_like(sc, float("inf"))),
            ("T=1", hm[:1], pm, sc),
            ("P unaligned", hm, pm_odd, sc)):
        h_, s_ = h_.contiguous(), s_.contiguous()
        kc = kernels.ransac_score(h_, p_, s_, md2)
        pc_ = kernels.ransac_score_plain(h_, p_, s_, md2)
        c_err = int((kc - pc_).abs().max())
        check(c_err == 0, f"ransac_score {case}: counts off the plain version by {c_err}")
        if case == "all dead":
            check(int(kc.abs().max()) == 0, "ransac_score all dead: a count is not 0")
        print(json.dumps({"kernel": "ransac_score", "case": case,
                          "shape": [h_.shape[0], p_.shape[0]], "max_abs_err": c_err,
                          "best_count": int(kc.max())}), flush=True)
    del pm_odd

    cloud, valid, pts_s, r = flagship_cloud(dev, views, truth)
    n_keep = int(valid.sum())
    L = pts_s.shape[0]
    win = 2 * 8192

    def knn_row(case, x, k):
        """knn_mean on x [L, 3] against its plain version, every row gated,
        the call checked to launch the kernel its k takes."""
        return mean_row(f"knn_mean {case}", lambda: kernels.knn_mean(x, k),
                        lambda: kernels.knn_mean_plain(x, k), k, x.shape[0], x.shape[0],
                        {"shape": list(x.shape), "k": k}, every_row=True,
                        real=x[:, 0] < knnlib.FAR, kernel=select_kernel("knn", k))

    q32 = pts_s[:32768].contiguous()
    row = knn_row("x-sorted", q32, 20)
    row["library_ms"] = time_ms(lambda: knn_library(q32, 20), reps=3, warm=1)
    row["extra"].update(ms_before=MS_BEFORE["knn_mean"], ms_before_from=BEFORE_FROM)
    rows.append(row)
    row = mean_row("slab_mean_knn",
                   lambda: kernels.slab_mean_knn(pts_s, r, 20, tile=64, wblk=8192),
                   lambda: kernels.slab_mean_knn_plain(pts_s, r, 20, 64, 8192),
                   20, L, win, {"shape": [L, 3], "k": 20, "tile": 64, "wblk": 8192,
                                "r": r, "merged_after_voxel": n_keep},
                   real=pts_s[:, 0] < pc._SLAB_FAR, kernel=select_kernel("slab", 20))
    row["library_ms"] = time_ms(lambda: slab_library(pts_s, r, 20), reps=3, warm=1)
    rows.append(row)
    # The cases a selection kernel gets wrong, each on every row, each call
    # checked to launch the kernel its k takes: k = 1; k = 33, 40, 64 (two
    # list segments), 128 (four) and 129 (the bisection kernel) on the same
    # cloud; every row duplicated (exact ties at the k-th distance, the twin
    # at d2 = 0 beside the query's own slot); a sparse cloud (most rows have
    # fewer than k within r, so t = r2b + 1 and the tie term carries them)
    for kk in (1, 33, 40, 64, 128, 129):
        row = mean_row(f"slab_mean_knn k={kk}",
                       lambda kk=kk: kernels.slab_mean_knn(pts_s, r, kk, tile=64, wblk=8192),
                       lambda kk=kk: kernels.slab_mean_knn_plain(pts_s, r, kk, 64, 8192),
                       kk, L, win, {"shape": [L, 3], "k": kk, "r": r}, every_row=True,
                       real=pts_s[:, 0] < pc._SLAB_FAR, kernel=select_kernel("slab", kk))
        if kk == 40:  # the row of k > 32 in PERF.md, with its yardstick
            row["library_ms"] = time_ms(lambda: slab_library(pts_s, r, 40), reps=3, warm=1)
            row["extra"].update(ms_before=MS_BEFORE["slab_mean_knn k=40"],
                                ms_before_from=BEFORE_FROM_K40)
        rows.append(row)
    real = cloud[valid]
    # a seeded eighth of the rows: ~1/8 of a row's neighbours within r remain
    keep = torch.randperm(real.shape[0], generator=torch.Generator(device=dev).manual_seed(0),
                          device=dev)[:real.shape[0] // 8]
    for case, sub in (("duplicated rows", torch.cat([real[:40000], real[:40000]])),
                      ("sparse", real[torch.sort(keep).values].contiguous())):
        ps, _, rs = pc._slab_inputs(sub, torch.ones(sub.shape[0], dtype=torch.bool, device=dev),
                                    0.5, 8192)
        for kk in (20, 33, 40, 64, 128):
            row = mean_row(
                f"slab_mean_knn {case} k={kk}",
                lambda ps=ps, rs=rs, kk=kk: kernels.slab_mean_knn(ps, rs, kk, tile=64, wblk=8192),
                lambda ps=ps, rs=rs, kk=kk: kernels.slab_mean_knn_plain(ps, rs, kk, 64, 8192),
                kk, ps.shape[0], win, {"shape": list(ps.shape), "k": kk, "r": rs},
                every_row=True, real=ps[:, 0] < pc._SLAB_FAR, kernel=select_kernel("slab", kk))
            if case == "sparse":
                few = row["extra"]["fewer_than_k_share"]
                check(few > 0.5, f"sparse slab case, k = {kk}: only {few} of the real rows "
                                 f"have fewer than k within r")
            rows.append(row)

    # knn_mean where a selection over the whole cloud can go wrong, every row
    # gated, each call checked to launch the kernel its k takes: k = 1,
    # k = 32 (the list's last lane), k = 33, 40, 64 (two list segments), 128
    # (four), 129 (the bisection kernel); every row duplicated (exact ties at
    # the k-th distance, the twin at d2 = 0 beside the query's own slot), a
    # ragged L (the small arm's merged size), L < k (t = r2b + 1, the tie
    # term carries every row), a cloud of parked rows with 8 real rows (fewer
    # than k within the cutoff), each at k = 20 and at two and four
    # segments; and the x-sorted cloud in a seeded random row order, timed
    # beside it: the sweep's start rotation pays off on ordered clouds only
    parked = torch.full((4096, 3), knnlib.FAR, dtype=torch.float32, device=dev)
    parked[::512] = q32[:8]
    perm = torch.randperm(q32.shape[0], generator=torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    shuffled = q32[perm].contiguous()
    cases = [(f"k={kk}", q32, kk) for kk in (1, 32, 33, 40, 64, 128, 129)]
    for case, x in (("duplicated rows", torch.cat([q32[:16384], q32[:16384]])),
                    ("ragged", q32[:25533].contiguous()), ("L<k", q32[:7].contiguous()),
                    ("mostly parked", parked)):
        cases += [(case, x, kk) for kk in (20, 40, 128)]
    for case, x, kk in cases + [("random order", shuffled, 20)]:
        row = knn_row(case, x, kk)
        if case == "mostly parked":
            few = row["extra"]["fewer_than_k_share"]
            check(few == 1.0, f"knn_mean mostly parked, k = {kk}: {few} of the real rows have "
                              f"fewer than k")
        if case == "k=40":
            row["library_ms"] = time_ms(lambda: knn_library(q32, 40), reps=3, warm=1)
            row["extra"].update(ms_before=MS_BEFORE["knn_mean k=40"],
                                ms_before_from=BEFORE_FROM_K40)
        rows.append(row)
    del parked, shuffled

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
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": r_.get("library_ms")}
        print(json.dumps(dict(line, card=card, clocks=clocks(), **r_["extra"])), flush=True)
        out.append(line)
    del preps, q4, b4, cloud, pts_s, cq, cb, q32, lat_q, lat_b, far
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
    (the aten ops that launched them are left out, they carry the same time
    again; kernels on the drain, register and default streams may overlap,
    so the sum can exceed the busy wall), and the eight largest by name."""
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
            "knn_binmin_ms": sum(ms for k, ms, _ in rows if "knn_binmin" in k),
            "top": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in rows[:8]]}


def _memcpy_bytes(prof, root: str) -> dict:
    """Bytes copied between the host and the card in a profiled run: the sum
    of the trace's memcpy records (``args.bytes``) by direction."""
    path = os.path.join(root, "memcpy_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    out = {"h2d": 0, "d2h": 0, "records": 0}
    for e in events:
        if e.get("cat") != "gpu_memcpy":
            continue
        name, b = e.get("name", ""), int(e.get("args", {}).get("bytes", 0))
        out["records"] += 1
        if "HtoD" in name:
            out["h2d"] += b
        elif "DtoH" in name:
            out["d2h"] += b
    return out


def _fits(logs) -> dict:
    """Mean global and ICP fitness over a merge's logged pairs."""
    g, i = [], []
    for m in logs:
        if "global fit" in m and "ICP fit" in m:
            g.append(float(m.split("global fit ")[1].split()[0]))
            i.append(float(m.split("ICP fit ")[1].split()[0]))
    return {"pairs": len(g), "gfit_mean": float(np.mean(g)) if g else None,
            "ifit_mean": float(np.mean(i)) if i else None}


def merge_phase(dev, ply_dir: str, poses, pose_dir: str, root: str, card: str):
    """Phase 5: merge_views over the 24 flagship PLYs three times (the
    first run pays one-time costs: scipy's import, CUDA modules loaded on
    first use; the third runs under torch.profiler for the device's busy
    time and the copy bytes), the small arm, then the pose scene. On the
    card ``merge_360`` takes its device arm (the flagship runs must); each
    run prints the arm and, where the gate refused it, why. Then the
    host-list arm (``_merge_host_list``: ``prep_view``,
    ``register_prep_pairs``, ``finalize_chain``, what the streamed pipeline
    and ``merge-360 --artifacts`` run) on the same flagship and pose clouds,
    under the same gates, the flagship profiled; printed beside the device
    arm: per-view rotation and translation differences, the chamfer
    distance between the merged clouds, each arm's split, launches and
    copy bytes. Returns ({kernel: (launches, run)}: nn1, ransac_score and
    slab_mean_knn as the cold flagship run launched them, knn_mean as the
    small arm did; {"device": the cold flagship run, "host": the host-list
    flagship run}: their logs' fitness, launches, transforms, points)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    launches, runs = {}, {}
    arms = [("flagship", ply_dir, None), ("flagship_warm", ply_dir, None),
            ("flagship_profiled", ply_dir, None), ("small", ply_dir, SMALL_FINAL_VOXEL),
            ("pose", pose_dir, None), ("flagship_host", ply_dir, None),
            ("pose_host", pose_dir, None)]
    for arm, views, final_voxel in arms:
        cfg = Config()
        if final_voxel is not None:
            cfg.merge.final_voxel = final_voxel
        tm: dict = {}
        logs: list[str] = []
        host = arm.endswith("_host")
        clouds = read_clouds(views) if host else None
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        prof = _device_profile() if arm in ("flagship_profiled", "flagship_host") else None
        t0 = time.perf_counter()
        if prof is not None:
            prof.__enter__()
        if host:
            points, colors, transforms = recon._merge_host_list(clouds, cfg.merge, logs.append,
                                                                tm, dev)
            tm["arm"] = "host-list"
        else:
            points, colors, transforms = stages.merge_views(
                views, os.path.join(root, f"merged_{arm}.ply"), cfg=cfg, device=dev,
                timings=tm, log=logs.append)
        torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        if prof is not None:
            tm["device"] = _device_busy(prof)
            tm["copy_bytes"] = _memcpy_bytes(prof, root)
        check(points.ndim == 2 and points.shape[1] == 3 and len(points) > 0
              and bool(np.isfinite(points).all()) and len(colors) == len(points),
              f"{arm}: bad merged cloud {points.shape}")
        check(len(transforms) == MERGE_VIEWS, f"{arm}: {len(transforms)} transforms")
        if arm.startswith("pose"):
            acc = dict(pose_accuracy(transforms, poses), points=int(len(points)))
            gates = POSE_JAX
        else:
            acc = merge_accuracy(transforms, points, poses)
            gates = FLAGSHIP_JAX
        print(json.dumps({"merge": arm, "arm": tm.get("arm"), "refused": tm.get("refused"),
                          "wall_s": wall, "timings_s": tm, "launches": counts,
                          "fits": _fits(logs), "accuracy": acc, "card": card}), flush=True)
        for key, ref in gates.items():
            check(acc[key] <= GATE * ref,
                  f"{arm} merge {key} {acc[key]} > {GATE} x the JAX package's {ref}")
        if arm.startswith("flagship"):
            check(tm.get("arm") == ("host-list" if host else "device"),
                  f"{arm}: merge_360 ran its {tm.get('arm')} arm ({tm.get('refused')})")
            for k in ("nn1", "ransac_score", "slab_mean_knn"):
                check(counts[k] > 0, f"{arm} merge never launched {k}: {counts}")
        if arm in ("flagship", "flagship_host"):
            runs["host" if host else "device"] = {
                "logs": logs, "counts": counts, "transforms": transforms, "points": points,
                "timings": tm, "wall_s": wall}
        if arm == "flagship_host":
            ply.write_ply(os.path.join(root, "merged_flagship_host.ply"), points, colors)
        if arm == "flagship":
            for k in ("nn1", "ransac_score", "slab_mean_knn"):
                launches[k] = (counts[k], "merge-360, flagship (cold, device arm)")
        if arm == "small":
            check(len(points) <= 32768, f"small arm kept {len(points)} > 32768 points")
            check(counts["knn_mean"] > 0 and counts["slab_mean_knn"] == 0,
                  f"small arm launches {counts}")
            launches["knn_mean"] = (counts["knn_mean"],
                                    f"merge-360, small arm (final voxel {final_voxel})")
    d, h = runs["device"], runs["host"]
    rot, trans = syn.pose_errors(d["transforms"], h["transforms"])
    print(json.dumps({"merge": "device arm vs host-list arm (flagship)",
                      "rot_diff_deg": rot.tolist(), "trans_diff_mm": trans.tolist(),
                      "chamfer_mm": recon.chamfer_distance(d["points"], h["points"], device=dev),
                      "points": [int(len(d["points"])), int(len(h["points"]))],
                      "wall_s": [d["wall_s"], h["wall_s"]],
                      "launches": [d["counts"], h["counts"]], "card": card}), flush=True)
    return launches, runs


def radius_phase(dev, data: str, calib: str, card: str) -> list[dict]:
    """Phase 6: radius_count at the clean chain's shape: the scene's largest
    view, reconstructed, padded to its 2048-multiple bucket with rows parked
    at knn.FAR (valid = its points), at r = clean.cluster_eps and r =
    clean.radius; at both radii also the view's own rows unpadded (a ragged
    N) and a cloud of duplicated rows. The kernel must equal its plain
    version exactly on every row. Then slab_mean_knn at the statistical
    step's shape on the same bucket, gated as in phase 4 on every row."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
    from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
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
        # issue ceiling: 10 a pair, the 9 operations and the count's add
        print(json.dumps(dict(line, case=case, r=r, shape=[bucket, 3], points=n, view=view,
                              mean_count=float(valid_cnt.mean()), card=card,
                              issue_ceiling_ms=issue_ceiling(bucket * bucket * 10),
                              clocks=clocks())), flush=True)
        out.append(line)
        # a ragged N (the view's own rows, a multiple of no block size) and
        # a cloud of duplicated rows (every row's twin at d2 = 0, beside its
        # own slot), equal on every row
        real = parked[:n]
        twins = torch.cat([real[:30001], real[:30001]])
        for sub, what in ((real, "ragged"), (twins, "duplicated rows")):
            k_sub = kernels.radius_count(sub, r)
            torch.cuda.synchronize()
            err = int((k_sub - kernels.radius_count_plain(sub, r)).abs().max())
            check(err == 0, f"radius_count ({case}, {what}, N = {sub.shape[0]}): counts off "
                            f"the plain version by {err}")
            print(json.dumps({"name": "radius_count", "case": f"{case}, {what}", "r": r,
                              "shape": list(sub.shape), "max_abs_err": err,
                              "ms": time_ms(lambda: kernels.radius_count(sub, r), reps=20),
                              "card": card}), flush=True)
    # the cluster step's k-NN (k = 16 over the bucket, the view's rows valid)
    # beside torch.topk on the float distances, whose tie order is free
    pts_v = torch.from_numpy(padded).to(dev)
    ms = time_ms(lambda: knnlib.knn(pts_v, valid, 16), reps=3, warm=1)
    print(json.dumps({"knn": "cluster step shape", "shape": [bucket, 3], "points": n, "k": 16,
                      "ms": ms, "float_topk_ms": time_ms(lambda: knn_float_topk(pts_v, valid, 16),
                                                         reps=3, warm=1),
                      "card": card}), flush=True)
    knn_tie_check(dev, card)
    # the statistical step's slab_mean_knn at this view's shape: the clean
    # chain's bucket (invalid rows parked), its spacing-derived cell, k = 20
    cell = 0.75 * pc._estimate_spacing(pts_v, valid)
    ps, _, rs = pc._slab_inputs(pts_v, valid, cell, 8192)
    row = mean_row("slab_mean_knn per view",
                   lambda: kernels.slab_mean_knn(ps, rs, 20, tile=64, wblk=8192),
                   lambda: kernels.slab_mean_knn_plain(ps, rs, 20, 64, 8192),
                   20, ps.shape[0], 2 * 8192, {"shape": list(ps.shape), "k": 20, "r": rs,
                                               "points": n, "view": view}, every_row=True,
                   real=ps[:, 0] < pc._SLAB_FAR)
    print(json.dumps(dict(row["extra"], name="slab_mean_knn", max_abs_err=row["err"],
                          ms=time_ms(row["fn"], reps=20), plain_ms=row["plain_ms"],
                          bound_ms=row["bound"][0], card=card)), flush=True)
    del parked, valid, pts_v, ps
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
    true-pose arm and the mesh arm. Both runs take the default schedule
    (streamed merge, stage cache on) in fresh directories and must end with no
    failure. Returns the cold run's {"out", "wall_s", "report", "counts"}."""
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
    cold = {}
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
        check(report.merge_mode == "streamed" and report.views_computed == PIPE_VIEWS,
              f"pipeline {arm}: {report.merge_mode} merge, {report.views_computed} views "
              f"computed (the default schedule streams, from a fresh directory)")
        check(report.failures == [] and report.degraded is False,
              f"pipeline {arm}: failures {[f.as_dict() for f in report.failures]}")
        if arm == "cold":
            cold = {"out": out, "wall_s": wall, "report": report, "counts": counts}
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
                "overlap": _overlap(report), "launches": counts, "accuracy": acc,
                "pair_landing_mm": land,
                "clean_counts": [[c.get(k, 0) for k in PIPE_STEPS]
                                 for c in report.clean_counts],
                "card": card, "clocks": clocks()}
        if prof is not None:
            line["device"] = _device_busy(prof)
        print(json.dumps(line), flush=True)
        results.append((arm, counts, acc, line["clean_counts"], land))
    ref = PIPELINE_JAX
    n_batches = -(-PIPE_VIEWS // load_config(None, PIPE_OVERRIDES).parallel.compute_batch)
    for arm, counts, acc, clean, land in results:
        check(counts["decode_maps"] == n_batches,
              f"pipeline {arm}: decode_maps launched {counts['decode_maps']} times, not "
              f"once for each of {n_batches} batches")
        check(counts["radius_count"] == 2 * PIPE_VIEWS,
              f"pipeline {arm}: radius_count launched {counts['radius_count']} times, "
              f"not 2 a view")
        # knn_binmin: feature prep's binned selection (approx:0.95) and the
        # merged cloud's normals (above knn._BRUTE_MAX rows)
        for k in ("nn1", "ransac_score", "slab_mean_knn", "knn_binmin"):
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
    return cold


def _overlap(report) -> dict:
    """The schedule's numbers of a pipeline report: the register lane's wall
    beside the critical path, the pair launches, the cache's hits and
    misses."""
    o = report.overlap or {}
    return {"merge_mode": report.merge_mode, "register_s": o.get("register_s"),
            "critical_path_s": o.get("critical_path_s"),
            "pairs_dispatched": o.get("pairs_dispatched"),
            "pair_launches": o.get("pair_launches"),
            "cache_hits": (report.cache or {}).get("hits"),
            "cache_misses": (report.cache or {}).get("misses")}


def _seed_cache(src_out: str, dst_out: str, names) -> None:
    """Copy the named stage-cache entries of one run into a fresh directory."""
    import shutil

    dst = os.path.join(dst_out, ".slscan-cache")
    os.makedirs(dst)
    for name in names:
        shutil.copy(os.path.join(src_out, ".slscan-cache", name), os.path.join(dst, name))


def kept_pixel(calib: str, cleaned_ply: str, cam) -> tuple[int, int]:
    """(row, column) of the camera pixel whose ray carries the cleaned
    view's point nearest the cloud's median: a pixel of the surface the
    clean chain keeps."""
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile, ply
    from structured_light_for_3d_model_replication_tpu_torch.ops import triangulate as tri

    pts = ply.read_ply(cleaned_ply)["points"]
    x = pts[np.argmin(np.linalg.norm(pts - np.median(pts, axis=0), axis=1))]
    rays, oc, _, _ = tri.prep_calib(matfile.load_calibration(calib), cam[1], cam[0], "cpu")
    d = x - oc.numpy()
    pix = int(np.argmax(rays.numpy() @ (d / np.linalg.norm(d))))
    return pix // cam[0], pix % cam[0]


def _register_threads() -> int:
    import threading

    return sum(t.name.startswith("sl3d-register") for t in threading.enumerate())


def schedule_phase(dev, data: str, calib: str, root: str, cold: dict,
                   card: str) -> None:
    """Phase 8: the default schedule's other arms on the pipeline scene,
    beside phase 7's cold (streamed) run, whose bytes its profiled run must
    repeat. barrier: merge.stream=false in a
    fresh directory, merged.ply and model.stl byte-identical to the cold
    run's; warm: a rerun in the cold run's directory computes no view and
    launches no kernel, byte-identical; dirty: one bit of one pattern
    frame of view 11 flipped in a copy of the dataset (``kept_pixel``: a
    pixel whose point the cold run's clean chain kept), a fresh directory
    seeded with the cold run's view and pair entries: one view computed,
    its cleaned cloud changed, exactly its 2 pairs missed, the merge
    recomputed, one decode_maps and 2 radius_count launches; fault: a fresh directory
    seeded with every view entry but view 11's and
    faults.spec = compute.view~<view 11>:permanent: DEGRADED with 23 views
    merged, view 11 alone quarantined (PermanentFault), the re-pair 10 -> 12
    registered, the STL written; budget: pipeline.run_budget_s = 1 in a
    fresh directory raises, leaves an aborted failures.json, and the
    register thread ends within deadlines.register_s. Every arm but the fault
    arm has no failure."""
    import shutil

    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
    from structured_light_for_3d_model_replication_tpu_torch.utils import faults

    def outputs(out):
        return {f: open(os.path.join(out, f), "rb").read() for f in ("merged.ply",
                                                                     "model.stl")}

    def run(arm, out, data_=data, logs=None, **over):
        cfg = load_config(None, {**PIPE_OVERRIDES, **over})
        plan = faults.configure_from(cfg.faults)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            report = stages.run_pipeline(calib, data_, out, cfg=cfg, device=dev,
                                         log=logs.append if logs is not None
                                         else (lambda m: None))
            torch.cuda.synchronize()
        finally:
            faults.reset()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        print(json.dumps({"schedule": arm, "wall_s": wall, "walls_s": report.walls_s,
                          "overlap": _overlap(report), "launches": counts,
                          "views_computed": report.views_computed,
                          "views_cached": report.views_cached,
                          "failures": [f.as_dict() for f in report.failures],
                          "injected": plan.counts() if plan is not None else {},
                          "card": card, "clocks": clocks()}), flush=True)
        if arm != "fault":
            check(report.failures == [] and report.degraded is False,
                  f"schedule {arm}: failures {[f.as_dict() for f in report.failures]}")
        return report, counts, wall

    want = outputs(cold["out"])
    check(outputs(os.path.join(root, "pipeline_profiled")) == want,
          "schedule: phase 7's two streamed runs wrote different bytes")
    entries = os.listdir(os.path.join(cold["out"], ".slscan-cache"))
    plan_cfg = load_config(None, PIPE_OVERRIDES)
    _, sources, keys, _ = stages._view_plan(
        calib, data, plan_cfg, tuple(stages.CLEAN_STEPS),
        stages.StageCache(os.path.join(root, "keys"), enabled=False), lambda m: None, dev)
    n_batches = -(-PIPE_VIEWS // plan_cfg.parallel.compute_batch)
    view11 = os.path.basename(sources[11])
    entry11 = f"view-{keys[11][:16]}.npz"
    check(entry11 in entries, f"schedule: no cold-run view entry {entry11} for {view11}")

    # barrier: the same bytes as the streamed cold run
    out = os.path.join(root, "schedule_barrier")
    report, counts, wall = run("barrier", out, **{"merge.stream": False})
    check(report.merge_mode == "barrier", f"schedule barrier: {report.merge_mode}")
    check(counts["decode_maps"] == n_batches, f"schedule barrier: decode_maps launched "
                                              f"{counts['decode_maps']} times")
    check(outputs(out) == want, "schedule barrier: merged.ply / model.stl differ from the "
                                "streamed cold run's")
    print(json.dumps({"schedule": "streamed vs barrier", "streamed_wall_s": cold["wall_s"],
                      "streamed": _overlap(cold["report"]),
                      "barrier_wall_s": wall, "barrier": _overlap(report),
                      "card": card}), flush=True)

    # warm: a rerun in the cold run's directory computes nothing
    report, counts, _ = run("warm", cold["out"])
    check((report.views_computed, report.views_cached) == (0, PIPE_VIEWS),
          f"schedule warm: {report.views_computed} views computed, "
          f"{report.views_cached} cached")
    check(not any(counts.values()), f"schedule warm: kernels launched {counts}")
    check(outputs(cold["out"]) == want, "schedule warm: outputs differ from the cold run's")

    # dirty: one bit of one pattern frame of view 11 flipped
    dirty = os.path.join(root, "scans_dirty")
    shutil.copytree(data, dirty)
    ps = imio.load_packed_stack(os.path.join(dirty, view11))
    # the coarsest bit of a pixel whose point the clean chain kept: it
    # decodes to another column, so the view's cleaned bytes change
    cleaned11 = os.path.join(cold["out"], "views", f"{view11}.ply")
    r, c = kept_pixel(calib, cleaned11, PIPE_CAM)
    planes = ps.planes.copy()
    planes[0, r, c] ^= 1
    imio.save_packed_stack(os.path.join(dirty, view11),
                           imio.PackedStack(planes, ps.white, ps.black, ps.n_frames,
                                            ps.texture))
    out = os.path.join(root, "schedule_dirty")
    _seed_cache(cold["out"], out, [e for e in entries if e.split("-")[0] in ("view",
                                                                              "pair")])
    report, counts, _ = run("dirty", out, data_=dirty)
    misses = report.cache["miss_stages"]
    check(report.views_computed == 1, f"schedule dirty: {report.views_computed} views "
                                      f"computed")
    with open(cleaned11, "rb") as a, open(os.path.join(out, "views", f"{view11}.ply"),
                                          "rb") as b:
        check(a.read() != b.read(), f"schedule dirty: the flipped bit at ({r}, {c}) left "
                                    f"{view11}'s cleaned cloud as it was")
    # the view's two pairs, and only they, re-registered; the merge recomputed
    check(misses.count("pair") == 2 and report.merge_status == "computed",
          f"schedule dirty: {misses.count('pair')} pair misses, merge "
          f"{report.merge_status}")
    check(counts["decode_maps"] == 1 and counts["radius_count"] == 2
          and counts["ransac_score"] > 0, f"schedule dirty: launched {counts}")

    # fault: view 11 fails permanently, the run completes DEGRADED
    out = os.path.join(root, "schedule_fault")
    _seed_cache(cold["out"], out, [e for e in entries
                                   if e.startswith("view-") and e != entry11])
    logs: list[str] = []
    report, counts, _ = run("fault", out, logs=logs,
                            **{"faults.spec": f"compute.view~{view11}:permanent"})
    check(counts["decode_maps"] == 0, f"schedule fault: decode_maps launched "
                                      f"{counts['decode_maps']} times")
    check(report.degraded and len(report.transforms) == PIPE_VIEWS - 1,
          f"schedule fault: degraded {report.degraded}, {len(report.transforms)} views "
          f"merged")
    recs = [(f.view, f.stage, f.error_type) for f in report.failures]
    check(recs == [(view11, "compute", "PermanentFault")], f"schedule fault: {recs}")
    manifest = json.load(open(os.path.join(out, "failures.json")))
    check([(f["view"], f["error_type"]) for f in manifest["failures"]]
          == [(view11, "PermanentFault")] and manifest["degraded"] is True,
          f"schedule fault: manifest {manifest}")
    check(os.listdir(os.path.join(out, "quarantine")) == [f"{view11}.json"],
          f"schedule fault: quarantine {os.listdir(os.path.join(out, 'quarantine'))}")
    check(any("pair 10->12 (chain position 10)" in m for m in logs),
          "schedule fault: no re-pair 10 -> 12")
    check(os.path.getsize(os.path.join(out, "model.stl")) > 84, "schedule fault: no STL")

    # budget: the run aborts with a manifest; the register thread ends
    out = os.path.join(root, "schedule_budget")
    cfg = load_config(None, {**PIPE_OVERRIDES, "pipeline.run_budget_s": 1})
    t0 = time.perf_counter()
    try:
        stages.run_pipeline(calib, data, out, cfg=cfg, device=dev, log=lambda m: None)
        fail("schedule budget: the run did not abort")
    except Exception as e:   # the abort under test
        aborted = f"{type(e).__name__}: {e}"
    t_abort = time.perf_counter() - t0
    t_end = time.monotonic() + cfg.deadlines.register_s
    while _lane_threads() and time.monotonic() < t_end:
        time.sleep(0.01)
    t_threads = time.perf_counter() - t0 - t_abort
    torch.cuda.synchronize()
    manifest = json.load(open(os.path.join(out, "failures.json")))
    print(json.dumps({"schedule": "budget", "abort_s": t_abort, "reason": aborted,
                      "lane_threads_end_s": t_threads,
                      "register_threads": _register_threads(),
                      "lane_threads": _lane_threads(), "card": card}), flush=True)
    check(manifest["aborted"] is True
          and [(f["stage"], f["error_type"]) for f in manifest["failures"]]
          == [("pipeline", "DeadlineExceeded")], f"schedule budget: manifest {manifest}")
    check(_register_threads() == 0, "schedule budget: the register thread outlived "
                                    "deadlines.register_s")
    check(not _lane_threads(), f"schedule budget: lane threads {_lane_threads()} outlived "
                               f"deadlines.register_s")


def exact_keys(pts, rows, k: int):
    """The exact arm's k smallest (d2 bits << 32 | index) keys of the given
    rows of a parked cloud, ascending: ``knn.knn(exact=True)``'s per-block
    work (``knn._smallest_keys``, and a top-k over every key of the rows
    where a tie crosses the cut), on those rows only."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib

    n = pts.shape[0]
    cols = torch.arange(n, device=pts.device)
    block = max(1, (1 << 26) // n)
    out = []
    for s in range(0, rows.shape[0], block):
        r = rows[s:s + block].long()
        d2 = knnlib._sq_dist_block(pts[r], pts)
        d2.masked_fill_(r[:, None] == cols[None, :], float("inf"))
        key, cross = knnlib._smallest_keys(d2, k)
        if bool(cross.any()):
            key[cross] = torch.topk(knnlib._keys(d2[cross], cols), k, dim=1, largest=False,
                                    sorted=True).values
        out.append(key)
    return torch.cat(out)


def binmin_stats_delta(before: dict) -> dict:
    """knn_binmin's screen counts since ``before`` (kernels.binmin_stats)."""
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

    now = kernels.binmin_stats()
    return {k: now[k] - before.get(k, 0) for k in now}


def _confirm_share(st: dict, n: int) -> float | None:
    """Confirms over the (screened row, column) pairs, n columns a row."""
    pairs = st["screened_rows"] * n
    return st["confirms"] / pairs if pairs else None


def binmin_case(what: str, pts, rows, k: int, recall: float, card: str, extra: dict,
                timed: bool = False, chunk_rows=None) -> dict:
    """knn_binmin on parked points and query rows at M = kernels.binmin_bins(N,
    k, recall): d2 and idx equal to the plain version bit for bit; the
    binned selection (the k smallest (d2, index) keys of a row's M winners,
    as knn._knn_binned takes them) against the exact arm's on those rows:
    each row's recall (the mean at least ``recall``) and each rank's
    distance at or above the exact one (misses only overestimate). The
    screen's counts of the call (rows screened, rows on the exact sweep,
    confirms and their share of the screened pairs). With ``timed``, the
    kernel line: CUDA events (ms) around the wrapper as the main path calls
    it (the screen's terms taken once a cloud, as ``knn._knn_binned`` takes
    them; ``terms_ms`` their own events), torch.profiler's device time (the
    kernel and its prep pass), the plain version, the library call
    (torch.cdist then torch.topk over the same rows) and ``binmin_bound``
    from the call's screen counts; with
    ``chunk_rows`` the same times, counts and bound for the main path's own
    call on those rows (its plain version is left out: linear in the rows,
    it would take 8x the 4,096-row case's seconds)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib

    n, r = pts.shape[0], rows.shape[0]
    m = kernels.binmin_bins(n, k, recall)
    before = kernels.binmin_stats()
    kd, ki = kernels.knn_binmin(pts, rows, m)
    screen = binmin_stats_delta(before)
    (pd, pi), plain_ms = _timed_once(lambda: kernels.knn_binmin_plain(pts, rows, m))
    torch.cuda.synchronize()
    equal = bool(torch.equal(kd.view(torch.int32), pd.view(torch.int32))
                 and torch.equal(ki, pi))
    bad = int(((kd.view(torch.int32) != pd.view(torch.int32)) | (ki != pi)).sum())
    check(equal, f"knn_binmin ({what}): {bad} of {r * m} (row, bin) winners differ from "
                 f"the plain version")
    del pd, pi
    sel = torch.topk(knnlib._keys(kd, ki.long()), k, dim=1, largest=False, sorted=True).values
    ex = exact_keys(pts, rows, k)
    hit = ((sel & 0xFFFFFFFF)[:, :, None] == (ex & 0xFFFFFFFF)[:, None, :]).any(2)
    rec = hit.sum(1).double() / k
    # d2 bit patterns order as the floats: each rank at or above the exact one
    one_sided = bool(((sel >> 32) >= (ex >> 32)).all())
    mean = float(rec.mean())
    check(mean >= recall, f"knn_binmin ({what}): mean recall {mean} < {recall}")
    check(one_sided, f"knn_binmin ({what}): a selected distance below the exact one")
    out = {"knn_binmin": what, "n": n, "rows": r, "k": k, "recall_target": recall, "bins": m,
           "mean_recall": mean, "min_recall": float(rec.min()),
           "rows_below_target": float((rec < recall).double().mean()),
           "bit_equal": equal, "one_sided": one_sided, "plain_ms": plain_ms,
           "screen": screen, "confirm_share": _confirm_share(screen, n)}
    del kd, ki, sel, ex, hit
    terms = kernels.binmin_screen_terms(pts) if timed or chunk_rows is not None else None
    if timed:
        fn = lambda: kernels.knn_binmin(pts, rows, m, True, terms)  # noqa: E731
        ms = time_ms(fn, reps=5)
        dev_ms = device_ms(fn, 5, "knn_binmin_kernel")
        prep_ms = device_ms(fn, 5, "binmin_prep_kernel")
        lib_ms = time_ms(lambda: torch.topk(torch.cdist(
            pts[rows.long()], pts, compute_mode="donot_use_mm_for_euclid_dist"), k, dim=1,
            largest=False), reps=2, warm=1)
        torch.cuda.empty_cache()
        out.update({"name": "knn_binmin", "route": "cuda", "source": CLOUD_SOURCE,
                    "replaces": BINMIN_REPLACES, "launches": 0, "max_abs_err": 0.0,
                    "ms": ms, "device_ms": dev_ms, "prep_device_ms": prep_ms,
                    "terms_ms": time_ms(lambda: kernels.binmin_screen_terms(pts), reps=5),
                    "library_ms": lib_ms,
                    "library": "torch.cdist + torch.topk over the same rows",
                    **binmin_bound(n, r, m, screen), "clocks": clocks()})
    if chunk_rows is not None:
        c = chunk_rows.shape[0]
        before = kernels.binmin_stats()
        kernels.knn_binmin(pts, chunk_rows, m)
        chunk_screen = binmin_stats_delta(before)
        fn = lambda: kernels.knn_binmin(pts, chunk_rows, m, True, terms)  # noqa: E731
        cb = binmin_bound(n, c, m, chunk_screen)
        out.update({"chunk_rows": c, "chunk_first_row": int(chunk_rows[0]),
                    "chunk_ms": time_ms(fn, reps=5),
                    "chunk_device_ms": device_ms(fn, 5, "knn_binmin_kernel"),
                    "chunk_prep_device_ms": device_ms(fn, 5, "binmin_prep_kernel"),
                    **{"chunk_" + k: v for k, v in cb.items()},
                    "chunk_screen": chunk_screen,
                    "chunk_confirm_share": _confirm_share(chunk_screen, n)})
        torch.cuda.empty_cache()
    print(json.dumps(dict(out, **extra, card=card)), flush=True)
    return out


def binmin_accumulation_probe(dev, card: str) -> dict:
    """Phase 15(a): the tensor cores' f32 accumulation of bf16 products, on
    the screen's own mma.sync (kernels.binmin_mma_probe), held against the
    float64 sum. Each output's error over the sum's absolute terms (|c| +
    sum |a_k b_k|), the worst of each family printed and gated at
    kernels.BINMIN_ACC, the bound the screen's margin takes (cloud.cu's
    note). Families of PROBE_TILES tiles, seeded: "random" (exponents in
    [-12, 12], signs random), "wide" (exponents in [-40, 40]), "one large"
    (a term near 1, the other 15 of one sign at 2^-24..2^-4 of it, full
    mantissas: what alignment by truncation drops adds up), "cancelling"
    (two terms that cancel exactly, beside 14 small ones of one sign), and
    "screen" (pass 2's operands: a cloud's q' and -2c' in bf16 hi + lo, the
    (1 - alpha) norm, rows and columns centred); each with c = 0 (pass
    1), c = minus the f32 sum (pass 2's -tau' at the winner: the result
    cancels to the error) and c = 2^12 of the products' size (a large
    accumulator)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

    g = torch.Generator().manual_seed(1517)
    t = PROBE_TILES

    def rand(shape, lo, hi, signed=True):
        mant = 1 + torch.randint(0, 128, shape, generator=g).float() / 128   # exact in bf16
        v = torch.ldexp(mant, torch.randint(lo, hi + 1, shape, generator=g).float())
        if signed:
            v = v * (torch.randint(0, 2, shape, generator=g) * 2 - 1)
        return v

    def split(v):
        h = v.bfloat16().float()
        return h, (v - h).bfloat16().float()

    families = {"random": (rand((t, 16, 16), -12, 12), rand((t, 8, 16), -12, 12)),
                "wide": (rand((t, 16, 16), -40, 40), rand((t, 8, 16), -40, 40))}
    a = rand((t, 16, 16), -24, -4, signed=False)
    a[:, :, 0] = rand((t, 16), 0, 0, signed=False)
    families["one large"] = (a, rand((t, 8, 16), -1, 0, signed=False))
    a = rand((t, 16, 16), -24, -4, signed=False)
    a[:, :, 0] = rand((t, 16), -2, 2)
    a[:, :, 1] = -a[:, :, 0]
    b = rand((t, 8, 16), -1, 0, signed=False)
    b[:, :, 1] = b[:, :, 0]
    families["cancelling"] = (a, b)
    # pass 2's operands: K slots 2kq, 2kq + 1 (hi) and 2kq + 8, 2kq + 9 (lo)
    # of coordinate kq < 3, slots 14, 15 the (1 - alpha) norm's hi and lo
    cloud = torch.randn((t, 24, 3), generator=g) * torch.ldexp(
        torch.ones(t, 1, 1), torch.randint(-4, 12, (t, 1, 1), generator=g).float())
    q, c = cloud[:, :16], cloud[:, 16:]
    cn = (c * c).sum(2) * (1 - kernels.BINMIN_ALPHA)
    a = torch.zeros((t, 16, 16))
    b = torch.zeros((t, 8, 16))
    for k in range(3):
        qh, ql = split(q[:, :, k])
        ch, cl = split(-2 * c[:, :, k])
        a[:, :, 2 * k], a[:, :, 2 * k + 1], a[:, :, 2 * k + 8], a[:, :, 2 * k + 9] = qh, qh, ql, ql
        b[:, :, 2 * k], b[:, :, 2 * k + 1], b[:, :, 2 * k + 8], b[:, :, 2 * k + 9] = ch, cl, ch, cl
    a[:, :, 14] = a[:, :, 15] = 1.0
    b[:, :, 14], b[:, :, 15] = split(cn)
    families["screen"] = (a, b)
    out, worst = {}, 0.0
    for name, (a, b) in families.items():
        a = a.bfloat16().to(dev)
        b = b.bfloat16().to(dev)
        prods = torch.einsum("tmk,tnk->tmnk", a.double(), b.double())
        exact, size = prods.sum(3), prods.abs().sum(3)
        for cname, cc in (("c = 0", torch.zeros_like(exact)),
                          ("c = -sum", -exact),
                          ("c large", size * 4096 * torch.sign(torch.randn(
                              exact.shape, generator=g)).to(dev, torch.float64))):
            cf = cc.float()
            d = kernels.binmin_mma_probe(a, b, cf)
            ref = exact + cf.double()
            rel = ((d.double() - ref).abs() / (size + cf.double().abs()).clamp(min=1e-300))
            w = float(rel.max())
            out[f"{name}, {cname}"] = w
            worst = max(worst, w)
    res = {"binmin_accumulation_probe": out, "worst": worst,
           "worst_log2": float(np.log2(worst)) if worst else None, "bound": kernels.BINMIN_ACC,
           "outputs": len(out) * t * 128, "card": card}
    print(json.dumps(res), flush=True)
    check(worst <= kernels.BINMIN_ACC,
          f"binmin_accumulation_probe: the tensor cores' accumulation error {worst} of the "
          f"absolute sum exceeds the margin's BINMIN_ACC = {kernels.BINMIN_ACC}")
    return res


def binmin_edge_cases(dev, card: str) -> None:
    """Phase 15(a)'s adversarial cases for the tensor-core screen: each
    knn_binmin call equal to its plain version bit for bit (d2 and idx; a
    NaN distance counts as equal to a NaN): exact duplicate points (ties
    to the lowest index), near-ties inside the screen's margin (columns of
    one bin at squared distances a fraction of the margin apart), a cloud
    1e4 mm from the origin, a tile of parked query rows and bins whose
    every column is parked (N not a multiple of M), M at BINMIN_MIN_BINS and
    at 4096, self-exclusion on and off, and non-finite points (never a
    winner; a NaN in a bin's first column stays, as the plain version keeps
    it). Prints each case's screen counts and time."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib

    rng = np.random.default_rng(1517)
    n = BINMIN_CASE_POINTS
    cloud = (rng.normal(size=(n, 3)) * 60.0).astype(np.float32)
    cases = []
    # duplicates: every point about three times, self-exclusion on and off
    dup = cloud[:n // 3][rng.integers(0, n // 3, n)]
    cases += [("duplicates", dup, rng.choice(len(dup), 2048, replace=False), 128, ex)
              for ex in (True, False)]
    # near-ties: 8 columns of one bin a fraction of the margin apart for each query
    near = cloud.copy()
    m_near = 1024
    qrows = rng.choice(len(near), 2048, replace=False)
    mx, my, mz, _ = kernels.binmin_screen_terms(torch.from_numpy(near)).tolist()
    mu = np.array([mx, my, mz])
    taken = set(qrows.tolist())
    for r in qrows:
        q = near[r].astype(np.float64)
        eps = kernels.binmin_margin(float(((q - mu) ** 2).sum()), 2 * 60.0 ** 2 * 3)
        b = int(rng.integers(m_near))
        js = [j for j in b + m_near * rng.choice(len(near) // m_near, 8, replace=False)
              if j not in taken]
        taken.update(js)
        for i, j in enumerate(js):
            d = rng.normal(size=3)
            near[j] = (q + d / np.linalg.norm(d) * np.sqrt(400.0 + (i % 4) * eps / 8)
                       ).astype(np.float32)
    cases.append(("near-ties", near, qrows, m_near, True))
    cases.append(("offset 1e4 mm", cloud + np.float32(1e4),
                  rng.choice(len(cloud), 2048, replace=False), 2048, True))
    # parked: 30 % of the points and every column of bins 5, 6 and 300; N % M != 0
    parked = cloud[:n // 2 + 3].copy()
    m_park = 512
    gone = rng.random(len(parked)) < 0.3
    gone[np.isin(np.arange(len(parked)) % m_park, [5, 6, 300])] = True
    parked[gone] = knnlib.FAR
    prow = np.concatenate([np.flatnonzero(gone)[:256], np.flatnonzero(~gone)[:1792]])
    cases += [("parked rows and bins", parked, prow, m_park, ex) for ex in (True, False)]
    cases += [(f"M = {mm}", cloud, rng.choice(len(cloud), 2048, replace=False), mm, True)
              for mm in (kernels.BINMIN_MIN_BINS, 4096)]
    bad = cloud[:n // 4].copy()
    bad[rng.choice(len(bad), 40, replace=False)] = np.inf
    bad[rng.choice(len(bad), 40, replace=False), 1] = np.nan
    bad[:128:7, 2] = np.nan                       # NaN in some bins' first column
    cases.append(("non-finite", bad, np.concatenate([np.arange(0, 128), rng.choice(
        len(bad), 1920, replace=False)]), 128, True))
    t_all = time.perf_counter()
    for what, pts_np, rows_np, m, ex in cases:
        pts = torch.from_numpy(np.ascontiguousarray(pts_np, np.float32)).to(dev)
        rows = torch.from_numpy(np.asarray(rows_np, np.int32)).to(dev)
        before = kernels.binmin_stats()
        (kd, ki), ms = _timed_once(lambda: kernels.knn_binmin(pts, rows, m, ex))
        screen = binmin_stats_delta(before)
        pd, pi = kernels.knn_binmin_plain(pts, rows, m, ex)
        nan = torch.isnan(pd)
        same = bool(torch.equal(torch.isnan(kd), nan)
                    and torch.equal(kd.view(torch.int32)[~nan], pd.view(torch.int32)[~nan])
                    and torch.equal(ki, pi))
        diff = int(((kd.view(torch.int32) != pd.view(torch.int32)) & ~nan).sum()
                   + (ki != pi).sum())
        print(json.dumps({"knn_binmin_case": what, "n": len(pts_np), "rows": len(rows_np),
                          "bins": m, "exclude_self": ex, "bit_equal": same, "ms": ms,
                          "screen": screen, "confirm_share": _confirm_share(screen, len(pts_np)),
                          "card": card}), flush=True)
        check(same, f"knn_binmin ({what}, exclude_self={ex}): {diff} (row, bin) winners "
                    f"differ from the plain version")
        del pts, rows, kd, ki, pd, pi
    torch.cuda.empty_cache()
    print(json.dumps({"knn_binmin_cases": len(cases),
                      "wall_s": time.perf_counter() - t_all, "card": card}), flush=True)


def cluster_knn_split(parked, k: int, recall: float) -> dict:
    """knn._knn_binned's loop over one view's parked cluster cloud, timed
    apart by CUDA events: each chunk's knn_binmin call (the kernel, its prep
    pass and the wrapper's host sync; the screen's terms once, as the
    pipeline takes them) and the stage-2 keyed
    torch.topk over its [chunk, M] winners; the result equal bit for bit to
    knn_dense_approx's on the same cloud."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib

    n = parked.shape[0]
    m = kernels.binmin_bins(n, k, recall)
    kk = min(k, m)
    chunk = max(1, knnlib._BINNED_CUDA // m)
    rows = torch.arange(n, dtype=torch.int32, device=parked.device)
    marks, keys = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    terms = kernels.binmin_screen_terms(parked)
    for s in range(0, n, chunk):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        d2, idx = kernels.knn_binmin(parked, rows[s:s + chunk], m, True, terms)
        ev[1].record()
        keys.append(torch.topk(knnlib._keys(d2, idx.to(torch.int64)), kk, dim=1, largest=False,
                               sorted=True).values)
        ev[2].record()
        marks.append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kern = [a.elapsed_time(b) for a, b, _ in marks]
    topk = [b.elapsed_time(c) for _, b, c in marks]
    mine = knnlib._unkey(torch.cat(keys), k, n)
    valid = parked[:, 0] < knnlib.FAR / 2
    ref = knnlib.knn_dense_approx(parked, valid, k, recall_target=recall)
    check(torch.equal(mine[0], ref[0]) and torch.equal(mine[1].view(torch.int32),
                                                       ref[1].view(torch.int32)),
          "cluster_knn_split: the timed loop differs from knn_dense_approx")
    return {"chunks": len(marks), "chunk_rows": chunk, "wall_s": wall,
            "knn_binmin_ms": sum(kern), "topk_ms": sum(topk),
            "knn_binmin_chunk_ms_median": float(np.median(kern)),
            "topk_chunk_ms_median": float(np.median(topk))}


def flagship_phase(dev, rig, stacks, card: str) -> list[dict]:
    """Phase 15, right after phase 3 (its packed stacks in memory). (b)
    ``run_pipeline`` over the first FLAGSHIP_VIEWS 1080p views (.slbp, the
    default Config() at the render's projector size, the cleaned views
    written out), cold: every clean step's wall a view (the cluster step's
    k-NN, core count and label rounds apart), the merge and mesh walls, the
    peak device memory and the launches; gated on knn_binmin launched, the
    per-view clean counts within 1 % of the JAX package's on the same views
    (``FLAGSHIP_CLEAN_JAX``) and the cleaned points' distance to the true
    sphere (median, p99) within 1.5x; the merged cloud's and the STL's
    printed. (a) knn_binmin at the cluster step's shape of one such view
    (the background step's survivors of its 2048-row bucket, k = 16, recall
    0.99, BINMIN_ROWS_VIEW query rows: the kernels line's case) and at the
    merged cloud's normals shape (mesh_cloud(), k = 30, recall 0.99,
    BINMIN_ROWS_NORMALS rows), held by ``binmin_case``; then the exact
    arm on EXACT_ROWS rows of the view, scaled to it, beside the binned
    arm's k-NN wall in (b). Returns the knn_binmin kernel line."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile, ply
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
    from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    check(FLAGSHIP_CLEAN_JAX is not None and
          len(FLAGSHIP_CLEAN_JAX["clean_counts"]) >= FLAGSHIP_VIEWS,
          "FLAGSHIP_CLEAN_JAX holds no reference for the flagship views")
    binmin_accumulation_probe(dev, card)
    binmin_edge_cases(dev, card)
    scene = syn.sphere_on_background()
    with tempfile.TemporaryDirectory(prefix="slscan_flagship_") as root:
        data = os.path.join(root, "scans")
        calib = os.path.join(root, "calib.npz")
        matfile.save_calibration(calib, rig.calibration())
        for i in range(FLAGSHIP_VIEWS):
            imio.save_packed_stack(os.path.join(data, flagship_view_name(i)), stacks[i])
        cfg = Config()
        cfg.decode.n_cols, cfg.decode.n_rows = PROJ
        cfg.pipeline.write_view_plys = True
        out = os.path.join(root, "out")
        per_view: list[dict] = []
        real = pc.clean_chain

        def recording(points, valid, clean_cfg, steps=pc.CLEAN_STEPS, samples=None,
                      timings=None):
            tm: dict = {}
            res = real(points, valid, clean_cfg, steps, samples=samples, timings=tm)
            per_view.append(tm)
            if timings is not None:
                for key, val in tm.items():
                    timings[key] = timings.get(key, 0) + val
            return res

        kernels.reset_launch_counts()
        screen0 = kernels.binmin_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pc.clean_chain = recording
        try:
            t0 = time.perf_counter()
            report = stages.run_pipeline(calib, data, out, cfg=cfg, device=dev,
                                         log=lambda m: None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            pc.clean_chain = real
        counts = kernels.launch_counts()
        screen = binmin_stats_delta(screen0)
        peak = torch.cuda.max_memory_allocated()
        check(report.failures == [] and report.views_computed == FLAGSHIP_VIEWS,
              f"flagship pipeline: {report.views_computed} views computed, failures "
              f"{[f.as_dict() for f in report.failures]}")
        check(counts["knn_binmin"] > 0, f"flagship pipeline never launched knn_binmin: {counts}")
        clean = [[c.get(k, 0) for k in PIPE_STEPS] for c in report.clean_counts]
        views = read_clouds(os.path.join(out, "views"))
        surf = []
        for p, _ in views:
            d = syn.sphere_surface_distance(p, scene)
            surf.append([float(np.median(d)), float(np.percentile(d, 99))])
        merged = ply.read_ply(report.merged_ply)["points"]
        md = syn.sphere_surface_distance(merged, scene)
        acc = stl_accuracy(report.stl_path, scene, merged)
        print(json.dumps({"flagship_pipeline": "cold", "views": FLAGSHIP_VIEWS,
                          "wall_s": wall, "walls_s": report.walls_s,
                          "clean_walls_s_per_view": per_view, "clean_counts": clean,
                          "clean_counts_jax": FLAGSHIP_CLEAN_JAX["clean_counts"][:FLAGSHIP_VIEWS],
                          "surf_mm": surf,
                          "surf_mm_jax": FLAGSHIP_CLEAN_JAX["surf_mm"][:FLAGSHIP_VIEWS],
                          "merged_points": int(len(merged)),
                          "merged_surf_median_mm": float(np.median(md)),
                          "merged_surf_p99_mm": float(np.percentile(md, 99)), "stl": acc,
                          "peak_device_bytes": int(peak), "launches": counts,
                          "knn_binmin_screen": screen, "card": card,
                          "clocks": clocks()}), flush=True)
        for i, (mine, theirs) in enumerate(zip(clean, FLAGSHIP_CLEAN_JAX["clean_counts"])):
            for step, a, b in zip(PIPE_STEPS, mine, theirs):
                check(abs(a - b) <= FLAGSHIP_CLEAN_GATE * b,
                      f"flagship view {i} {step} count {a} vs the JAX package's {b}")
        for i, (mine, theirs) in enumerate(zip(surf, FLAGSHIP_CLEAN_JAX["surf_mm"])):
            for what, a, b in zip(("median", "p99"), mine, theirs):
                check(a <= GATE * b, f"flagship view {i}: cleaned points {a} mm from the "
                                     f"sphere ({what}), > {GATE} x the JAX package's {b}")
        # (a) the cluster step's input of view 0: its bucket, the background
        # step's survivors valid, the rest parked
        pts, _ = stages.reconstruct_source(os.path.join(data, flagship_view_name(0)),
                                           matfile.load_calibration(calib), cfg, device=dev)
        n = len(pts)
        bucket = recon._bucket_pad(n)
        padded = np.full((bucket, 3), knnlib.FAR, np.float32)
        padded[:n] = pts
        pts_t = torch.from_numpy(padded).to(dev)
        valid = torch.arange(bucket, device=dev) < n
        _, inl = pc.segment_plane(pts_t, valid, cfg.clean.plane_ransac_dist,
                                  cfg.clean.plane_ransac_trials)
        survivors = torch.nonzero(valid & ~inl).flatten()
        parked = knnlib._parked(pts_t, valid & ~inl).contiguous()
        del pts_t, inl
        rows = survivors[torch.linspace(0, survivors.shape[0] - 1, BINMIN_ROWS_VIEW,
                                        device=dev).long()].to(torch.int32)
        # the main path's own call: the pipeline's contiguous chunk
        # (knn._knn_binned) holding the most survivors
        chunk = knnlib._BINNED_CUDA // kernels.binmin_bins(bucket, 16, 0.99)
        per_chunk = torch.bincount(survivors // chunk)
        c0 = int(torch.argmax(per_chunk)) * chunk
        chunk_rows = torch.arange(c0, min(c0 + chunk, bucket), dtype=torch.int32, device=dev)
        line = binmin_case("cluster step, 1080p view", parked, rows, 16, 0.99, card,
                           {"view_points": n, "survivors": int(survivors.shape[0]),
                            "chunk_survivors": int(per_chunk.max())},
                           timed=True, chunk_rows=chunk_rows)
        split = cluster_knn_split(parked, 16, 0.99)
        print(json.dumps({"cluster_knn_split": "view 0", "n": bucket, **split,
                          "pipeline_knn_s_per_view": [tm.get("clean_cluster_knn_s")
                                                      for tm in per_view],
                          "card": card}), flush=True)
        # the exact arm on EXACT_ROWS survivor rows, scaled to the view's N
        sub = survivors[torch.linspace(0, survivors.shape[0] - 1, EXACT_ROWS,
                                       device=dev).long()]
        _, ex_ms = _timed_once(lambda: exact_keys(parked, sub, 16))
        knn_s = [tm.get("clean_cluster_knn_s") for tm in per_view]
        print(json.dumps({"cluster_knn": "approx against exact", "n": bucket,
                          "exact_rows": EXACT_ROWS, "exact_subset_ms": ex_ms,
                          "exact_scaled_s": ex_ms / 1e3 * bucket / EXACT_ROWS,
                          "binned_knn_s_per_view": knn_s, "card": card}), flush=True)
        del parked, survivors, rows, sub, chunk_rows
        torch.cuda.empty_cache()
    # the merged cloud's normals shape: mesh_cloud(), k = 30, recall 0.99
    mc, _ = mesh_cloud()
    pts = torch.from_numpy(np.ascontiguousarray(mc, np.float32)).to(dev)
    rows = torch.linspace(0, len(mc) - 1, BINMIN_ROWS_NORMALS, device=dev).long()
    binmin_case("merged cloud normals", pts, rows.to(torch.int32),
                Config().mesh.normal_max_nn, 0.99, card, {})
    del pts, rows
    torch.cuda.empty_cache()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms", "bound_unit",
            "bound_terms_ms", "cuda_core_yardstick_ms", "chunk_ms", "chunk_device_ms",
            "chunk_bound_ms")
    return [{k: line[k] for k in keys}]


def feature_prep_phase(dev, cold: dict, card: str) -> None:
    """Phase 15(a) at feature prep's shape and 15(c), after phase 7: every
    cleaned view of phase 7's cold run prepped alone (``prep_view``, the
    host-list arm); knn_binmin at the largest prep's shape (its bucket,
    every row, k = FEAT_K, recall 0.95), held by ``binmin_case``; then the
    ``feature_group_gate``: the smallest view's prep alone equals, bit for
    bit on its valid rows (points, normals, features), the same view padded
    into the device arm's shared bucket (``_preprocess_views_device``)
    beside phase 7's merged cloud, and that arm launched knn_binmin."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib

    voxel = load_config(None, PIPE_OVERRIDES).merge.voxel_size
    views = read_clouds(os.path.join(cold["out"], "views"))
    preps = [recon.prep_view(p, voxel, device=dev) for p, _ in views]
    sizes = [int(p.valid.sum()) for p in preps]
    big, small = int(np.argmax(sizes)), int(np.argmin(sizes))
    p = preps[big]
    binmin_case("feature prep, largest view", knnlib._parked(p.points, p.valid).contiguous(),
                torch.arange(p.points.shape[0], dtype=torch.int32, device=dev),
                recon.FEAT_K, 0.95, card,
                {"view": big, "prep_points": sizes[big],
                 "phase7_launches": cold["counts"].get("knn_binmin", 0)})
    alone = preps[small]
    # the shared bucket: phase 7's views all fit one 2048-row bucket, so the
    # group's other member is its merged cloud, several buckets larger
    merged = ply.read_ply(cold["report"].merged_ply)
    kernels.reset_launch_counts()
    dc = recon.stack_views_device([views[small], (merged["points"], merged["colors"])],
                                  device=dev)
    grouped, _ = recon._preprocess_views_device(dc, voxel)
    launched = kernels.launch_counts()["knn_binmin"]
    g = grouped[0]
    n = sizes[small]
    same = {"bucket_alone": int(alone.points.shape[0]), "bucket_grouped": int(g.points.shape[0]),
            "valid": n == int(g.valid.sum()),
            "points": bool(torch.equal(alone.points[:n], g.points[:n])),
            "normals": bool(torch.equal(alone.normals[:n], g.normals[:n])),
            "features": bool(torch.equal(alone.features[:n], g.features[:n]))}
    print(json.dumps({"feature_group_gate": same, "view": small, "points": n,
                      "knn_binmin_launches": launched, "card": card}), flush=True)
    check(same["bucket_alone"] < same["bucket_grouped"],
          f"feature_group_gate: view {small} alone and grouped share a bucket: {same}")
    check(launched > 0, "feature_group_gate: the device arm's prep never launched knn_binmin")
    check(all(same[k] for k in ("valid", "points", "normals", "features")),
          f"feature_group_gate: view {small}'s features depend on its bucket: {same}")
    del preps, grouped, dc
    torch.cuda.empty_cache()


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
    ``mesh`` entry point: normals, the dense Poisson solve at MESH_DEPTH,
    extraction, trim) on ``mesh_cloud()``'s points at the default Config()
    with ``mesh.depth=MESH_DEPTH``, gated at 1.5x the
    JAX package's errors on the same cloud (``MESH_JAX``): the STL's
    distance to the true spheres, to the input cloud both ways, and its
    open and non-manifold edges."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    cloud, scene = mesh_cloud()
    src, out = os.path.join(root, "mesh_cloud.ply"), os.path.join(root, "mesh_arm.stl")
    ply.write_ply(src, cloud)
    tm: dict = {}
    cfg = load_config(None, {"mesh.depth": MESH_DEPTH})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages.mesh_cloud(src, out, cfg=cfg, device=dev, log=lambda m: None, timings=tm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc = stl_accuracy(out, scene, cloud)
    print(json.dumps({"mesh": "sphere union", "depth": MESH_DEPTH,
                      "points": int(len(cloud)), "wall_s": wall,
                      "walls_s": tm, "stl": acc, "card": card}), flush=True)
    for key, ref in MESH_JAX.items():
        check(acc[key] <= GATE * ref,
              f"mesh arm: STL {key} {acc[key]} > {GATE} x the JAX package's {ref}")


def posegraph_phase(dev, ply_dir: str, pose_dir: str, poses, root: str, card: str) -> None:
    """Phase 11(a): ``merge_views`` with ``merge.method='posegraph'``
    (``merge_360_posegraph``: every view prepped at one bucket, 23 odometry
    edges and the loop closure in one batched register, the pose graph
    solved on the card) over the pose scene and the 24 flagship views.
    Gates at 1.5x the JAX package's errors on the same views
    (``POSEGRAPH_JAX``, tools/torch_merge_reference.py --method posegraph):
    the poses on the pose scene (``pose_accuracy_chord``), the merged
    points' distance to the true
    spheres on the flagship; the loop closure kept or rejected as the JAX
    package decided; nn1 and ransac_score launched."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    for scene, views in (("pose", pose_dir), ("flagship", ply_dir)):
        cfg = Config()
        cfg.merge.method = "posegraph"
        logs: list[str] = []
        tm: dict = {}
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        points, _, transforms = stages.merge_views(
            views, os.path.join(root, f"posegraph_{scene}.ply"), cfg=cfg, device=dev,
            timings=tm, log=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        acc = (pose_accuracy_chord(transforms, poses) if scene == "pose"
               else merge_accuracy(transforms, points, poses))
        acc["loop_closure"] = bool(tm.get("loop_closure"))
        print(json.dumps({"posegraph": scene, "wall_s": wall, "timings_s": tm,
                          "launches": counts, "fits": _fits(logs),
                          "residual": [m for m in logs if "residual rmse" in m],
                          "accuracy": acc, "card": card}), flush=True)
        ref = POSEGRAPH_JAX[scene]
        check(acc["loop_closure"] == ref["loop_closure"],
              f"posegraph {scene}: loop closure kept={acc['loop_closure']}, the JAX "
              f"package's {ref['loop_closure']}")
        for key, r in ref.items():
            if key != "loop_closure":
                check(acc[key] <= GATE * r, f"posegraph {scene}: {key} {acc[key]} > {GATE} x "
                                            f"the JAX package's {r}")
        check(len(transforms) == MERGE_VIEWS and counts["nn1"] > 0
              and counts["ransac_score"] > 0, f"posegraph {scene}: launched {counts}")


def standalone_phase(dev, ply_dir: str, pose_dir: str, poses, card: str) -> None:
    """Phase 11(c): the standalone ``ransac_global_registration`` and
    ``icp_point_to_plane`` on pose views 1 -> 0 after ``prep_view`` (voxel
    3 mm, max distance 4.5 mm, 4096 trials, 30 ICP steps), and
    ``icp_point_to_plane`` of the flagship cloud at the true poses
    (``flagship_cloud``: more than 131,072 rows) against its noisy copy moved
    by ``BIG_ICP_MOTION`` (``big_icp_inputs``). Gates: ransac_score and nn1
    launched (counted), and each recovered transform within 1.5x the JAX
    package's error on the same inputs on the CPU (``STANDALONE_JAX``,
    tools/torch_merge_reference.py --standalone)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import normals as nrmlib
    from structured_light_for_3d_model_replication_tpu_torch.ops import registration as reg
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    voxel = 3.0
    clouds = read_clouds(pose_dir)
    truth = true_pair_transforms(poses)[0]
    src, dst = (recon.prep_view(clouds[i][0], voxel, device=dev) for i in (1, 0))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = reg.ransac_global_registration(src.points, src.features, src.valid, dst.points,
                                       dst.features, dst.valid, max_dist=voxel * 1.5,
                                       device=dev)
    torch.cuda.synchronize()
    t_ransac = time.perf_counter() - t0
    icp = reg.icp_point_to_plane(src.points, src.valid, dst.points, dst.valid, dst.normals,
                                 init_transform=g.transform, max_dist=voxel * 1.5,
                                 device=dev)
    torch.cuda.synchronize()
    t_icp = time.perf_counter() - t0 - t_ransac
    counts = kernels.launch_counts()
    lumpy = {"ransac": transform_error(g.transform.cpu().numpy(), truth),
             "icp": transform_error(icp.transform.cpu().numpy(), truth)}
    print(json.dumps({"standalone": "lumpy pair 1 -> 0", "ransac_s": t_ransac,
                      "icp_s": t_icp, "fitness": [float(g.fitness), float(icp.fitness)],
                      "launches": counts, "errors": lumpy, "card": card}), flush=True)
    check(counts["ransac_score"] >= 1 and counts["nn1"] >= 2,
          f"standalone: launched {counts}")
    views = [p for p, _ in read_clouds(ply_dir)]
    cloud, valid, _, _ = flagship_cloud(dev, views, syn.turntable_transforms(poses))
    s_pts, d_pts, T = big_icp_inputs(cloud[valid].cpu().numpy())
    check(len(d_pts) > 131072, f"standalone: the large ICP's dst has {len(d_pts)} rows")
    d_t = torch.from_numpy(d_pts).to(dev)
    ones = torch.ones(len(d_pts), dtype=torch.bool, device=dev)
    nr = nrmlib.estimate_normals(d_t, ones, k=30)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big = reg.icp_point_to_plane(s_pts, None, d_t, None, nr, max_dist=voxel * 1.5,
                                 device=dev)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t0
    big_counts = kernels.launch_counts()
    big_err = transform_error(big.transform.cpu().numpy(), T)
    print(json.dumps({"standalone": "large ICP", "rows": int(len(d_pts)), "icp_s": t_big,
                      "fitness": float(big.fitness), "launches": big_counts,
                      "errors": big_err, "card": card}), flush=True)
    check(big_counts["nn1"] >= 1, f"standalone large ICP: launched {big_counts}")
    for name, err in (("lumpy ransac", lumpy["ransac"]), ("lumpy icp", lumpy["icp"]),
                      ("large icp", big_err)):
        ref = STANDALONE_JAX[name]
        for key in ("rot_deg", "trans_mm"):
            check(err[key] <= GATE * ref[key], f"standalone {name}: {key} {err[key]} > "
                                               f"{GATE} x the JAX package's {ref[key]}")


def bf16_phase(dev, ply_dir: str, root: str, f32: dict, card: str) -> None:
    """Phase 11(e): phase 5's flagship merge with
    ``parallel.force_bf16_features=true`` (the feature products as one bf16
    GEMM with f32 output). Printed beside phase 5's cold f32 run: the mean
    global and ICP fitness. Gates: no failure, the same arm, the same
    kernels launched, and ransac_score once a pair as in the f32 run (nn1
    follows the ICP steps, which the correspondences move; printed)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    cfg = Config()
    cfg.parallel.force_bf16_features = True
    logs: list[str] = []
    tm: dict = {}
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    points, _, transforms = stages.merge_views(
        ply_dir, os.path.join(root, "merged_bf16.ply"), cfg=cfg, device=dev, timings=tm,
        log=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(json.dumps({"bf16": "flagship", "wall_s": wall, "f32_wall_s": f32["wall_s"],
                      "fits": _fits(logs), "f32_fits": _fits(f32["logs"]),
                      "timings_s": tm, "launches": counts, "f32_launches": f32["counts"],
                      "points": int(len(points)), "card": card}), flush=True)
    check(len(transforms) == MERGE_VIEWS and len(points) > 0
          and bool(np.isfinite(points).all()), "bf16: bad merge")
    check(tm.get("arm") == f32["timings"].get("arm"),
          f"bf16: arm {tm.get('arm')}, the f32 run's {f32['timings'].get('arm')}")
    check({k for k, n in counts.items() if n} == {k for k, n in f32["counts"].items() if n}
          and counts["ransac_score"] == f32["counts"]["ransac_score"],
          f"bf16: launched {counts}, the f32 run {f32['counts']}")


def surface_phase(dev, root: str, card: str) -> None:
    """Phase 11(b): ``mesh_cloud`` with ``mesh.mode='surface'`` (ball
    pivoting) on ``mesh_cloud()``'s ~188k points of the three spheres'
    union. Gates: the face count within 1 % of the JAX package's and the
    STL's distance to the true spheres within 1.5x its (``SURFACE_JAX``,
    tools/torch_pipeline_reference.py --mesh --mesh-mode surface)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    cloud, scene = mesh_cloud()
    src, out = os.path.join(root, "surface_cloud.ply"), os.path.join(root, "surface.stl")
    ply.write_ply(src, cloud)
    cfg = Config()
    cfg.mesh.mode = "surface"
    tm: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages.mesh_cloud(src, out, cfg=cfg, device=dev, log=lambda m: None, timings=tm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc = stl_accuracy(out, scene, cloud)
    print(json.dumps({"surface": "sphere union", "points": int(len(cloud)), "wall_s": wall,
                      "walls_s": tm, "stl": acc, "card": card}), flush=True)
    ref = SURFACE_JAX
    check(abs(acc["faces"] - ref["faces"]) <= 0.01 * ref["faces"],
          f"surface: {acc['faces']} faces, the JAX package's {ref['faces']}")
    for key in ("surf_median_mm", "surf_p99_mm"):
        check(acc[key] <= GATE * ref[key],
              f"surface: STL {key} {acc[key]} > {GATE} x the JAX package's {ref[key]}")


def legacy_pipeline_phase(dev, data: str, calib: str, scene, root: str, cold: dict,
                          card: str) -> None:
    """Phase 11(d): ``run_pipeline`` with ``merge.method='posegraph'`` and
    ``mesh.mode='surface'`` over phase 7's 24 views, phase 7's view cache
    copied in (only the merge and the mesh recompute). Gates: the notice
    that merge.stream is ignored, merge_mode 'posegraph', every view cached
    and no failure. The merged cloud's distance to the true surfaces is
    printed beside phase 7's (this scene's chain cannot be merged right by
    either package: PERF.md section 5)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    cfg = load_config(None, {**PIPE_OVERRIDES, "merge.method": "posegraph",
                             "mesh.mode": "surface"})
    out = os.path.join(root, "pipeline_posegraph")
    entries = os.listdir(os.path.join(cold["out"], ".slscan-cache"))
    _seed_cache(cold["out"], out, [e for e in entries if e.startswith("view-")])
    logs: list[str] = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = stages.run_pipeline(calib, data, out, cfg=cfg, device=dev, log=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def surf(path):
        d = syn.surface_distance(ply.read_ply(path)["points"], scene)
        return [float(np.median(d)), float(np.percentile(d, 99))]

    print(json.dumps({"pipeline": "posegraph + surface", "wall_s": wall,
                      "walls_s": report.walls_s, "merge_mode": report.merge_mode,
                      "merged_points": report.merged_points,
                      "merged_surf_mm": surf(report.merged_ply),
                      "cold_merged_surf_mm": surf(cold["report"].merged_ply),
                      "stl_faces": report.mesh_faces, "card": card}), flush=True)
    check(any("merge.stream is ignored" in m for m in logs),
          "pipeline posegraph: no notice that merge.stream is ignored")
    check(report.merge_mode == "posegraph" and report.merge_status == "computed"
          and report.views_cached == PIPE_VIEWS and report.failures == []
          and not report.degraded,
          f"pipeline posegraph: {report.merge_mode} {report.merge_status}, "
          f"{report.views_cached} views cached, failures "
          f"{[f.as_dict() for f in report.failures]}")


def render_calibration(rig):
    """Phase 12(a)'s boards and their 46-frame renders through ``rig``
    (four threads). Returns (boards, renders)."""
    from concurrent.futures import ThreadPoolExecutor

    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    boards = syn.calibration_poses(rig, *CALIB_BOARD, n=CALIB_POSES,
                                   near=CALIB_DEPTHS[0], far=CALIB_DEPTHS[1])
    with ThreadPoolExecutor(4) as pool:
        renders = list(pool.map(lambda b: syn.render_chessboard(rig, b), boards))
    return boards, renders


def calib_errors(calib: dict, rms: float, rig) -> dict:
    """A calibration against the true rig: each intrinsic's difference (px),
    the angle of R_hat R^T (degrees), |T_hat - T| (mm) and the stereo RMS
    (px)."""
    out = {}
    for name, K, truth in (("cam", calib["cam_K"], rig.cam_K),
                           ("proj", calib["proj_K"], rig.proj_K)):
        K = np.asarray(K, np.float64)
        for key, (i, j) in (("fx", (0, 0)), ("fy", (1, 1)), ("cx", (0, 2)), ("cy", (1, 2))):
            out[f"{name}_{key}_px"] = float(abs(K[i, j] - truth[i, j]))
    R = np.asarray(calib["R"], np.float64)
    c = (np.trace(R @ rig.R.T) - 1.0) / 2.0
    out["R_deg"] = float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
    out["T_mm"] = float(np.linalg.norm(np.asarray(calib["T"], np.float64).reshape(3)
                                       - rig.T))
    out["rms_px"] = float(rms)
    return out


def calib_limit(key: str, theirs: float) -> float:
    """GATE x the JAX package's error, or the floor of the error's unit."""
    return max(GATE * theirs, CALIB_FLOOR[key.rsplit("_", 1)[1]])


def run_cli(main, argv: list[str]) -> tuple[int, str]:
    """A CLI's ``main(argv)`` with its standard output captured."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def pose_rows(calibrate_out: str) -> list[str]:
    """The per-pose rows of the calibrate command's table (one a detected
    pose)."""
    return [ln for ln in calibrate_out.splitlines()
            if ln.startswith("pose") and ln.split()[0] != "pose"]


def stereo_rms(calibrate_out: str) -> float:
    """The stereo RMS the calibrate command printed."""
    line = next(ln for ln in calibrate_out.splitlines()
                if ln.startswith("[calib] stereo RMS"))
    return float(line.split()[3])


def surface_errors(ply_path: str) -> list[float]:
    """A reconstructed view's points against phase 2's true surfaces:
    [median, p99] distance (mm) and the point count."""
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    pts = ply.read_ply(ply_path)["points"]
    d = syn.surface_distance(pts, syn.sphere_on_background())
    return [float(np.median(d)), float(np.percentile(d, 99)), int(len(pts))]


def calibration_phase(dev, rig, frames_np, stacks, card: str) -> None:
    """Phase 12(a)-(c), right after phase 3 (the phase-2 render in memory).
    (a) the port's sequencer captures CALIB_POSES boards lit by the
    46-frame stack (a virtual projector; the camera writes the render of
    the frame shown as PNG), then ``calibrate <dir> --output calib.mat`` and
    ``inspect-calib calib.mat``. Gates: every pose detected; each error
    against the true rig within GATE x the JAX package's (``CALIB_JAX``) or
    its floor. (b) ``reconstruct`` of phase 3's 8 .slbp views with the
    recovered calib.mat in the table and quadratic lanes: the lane's kernel
    once a batch and nothing else, and every view's points within GATE x
    the JAX package's distance to the true surfaces (median, p99); printed
    beside a table-lane run with the true calibration. (c)
    ``undistort_stack`` of one 46x1080x1920 stack: the card's result equal
    to the CPU's but for at most 1e-4 of the pixels, each off by one, the
    identity under zero distortion, and its time (CUDA events, warm
    median)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch import cli
    from structured_light_for_3d_model_replication_tpu_torch.acquire.projector import (
        VirtualProjector,
    )
    from structured_light_for_3d_model_replication_tpu_torch.acquire.sequencer import (
        CaptureSequencer,
    )
    from structured_light_for_3d_model_replication_tpu_torch.calib import undistort as ud
    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    with tempfile.TemporaryDirectory(prefix="slscan_calib_") as root:
        # (a) capture and calibrate
        t0 = time.perf_counter()
        _, renders = render_calibration(rig)
        t_render = time.perf_counter() - t0
        proj = VirtualProjector(*PROJ)
        pose = {}

        def on_pose(i: int) -> None:
            pose.update(frames=renders[i], start=len(proj.shown))

        def capture(path: str) -> None:
            imio.save_image(path, pose["frames"][len(proj.shown) - 1 - pose["start"]])

        seq = CaptureSequencer(proj, capture, proj_size=PROJ, log=lambda m: None)
        pose_root = os.path.join(root, "poses")
        t0 = time.perf_counter()
        dirs = seq.capture_calibration(pose_root, CALIB_POSES, on_pose=on_pose)
        t_capture = time.perf_counter() - t0
        n_frames = renders[0].shape[0]
        check(len(dirs) == CALIB_POSES and all(
            len(os.listdir(d)) == n_frames for d in dirs),
            f"calibration capture: {[len(os.listdir(d)) for d in dirs]} frames a pose")
        del renders, pose["frames"]
        calib_mat = os.path.join(root, "calib.mat")
        t0 = time.perf_counter()
        rc, text = run_cli(cli.main, ["calibrate", pose_root, "--output", calib_mat,
                                      *CALIB_SET])
        t_solve = time.perf_counter() - t0
        check(rc == 0, f"calibrate exited {rc}")
        rows = pose_rows(text)
        print("\n".join(text.splitlines()[:CALIB_POSES + 2]), flush=True)
        check(len(rows) == CALIB_POSES,
              f"calibrate: {len(rows)} of {CALIB_POSES} poses detected")
        rc, summary = run_cli(cli.main, ["inspect-calib", calib_mat])
        check(rc == 0 and summary.startswith("=== Calibration summary ==="),
              f"inspect-calib exited {rc}: {summary!r}")
        print(summary, end="", flush=True)
        errs = calib_errors(matfile.load_calibration(calib_mat), stereo_rms(text), rig)
        print(json.dumps({"calibration": "port vs JAX on the same renders",
                          "errors": errs, "jax_errors": CALIB_JAX["calib"],
                          "render_s": t_render, "capture_s": t_capture,
                          "calibrate_s": t_solve, "card": card}), flush=True)
        for key, v in errs.items():
            lim = calib_limit(key, CALIB_JAX["calib"][key])
            check(v <= lim, f"calibration: {key} {v} > {lim} (GATE x the JAX "
                            f"package's {CALIB_JAX['calib'][key]}, or the floor)")

        # (b) reconstruct with the recovered calibration
        data = os.path.join(root, "scans")
        for i in range(RECON_VIEWS):
            imio.save_packed_stack(os.path.join(data, f"view_{i * 45:03d}deg"),
                                   stacks[i % len(stacks)])
        true_calib = os.path.join(root, "true.npz")
        matfile.save_calibration(true_calib, rig.calibration())
        n_batches = -(-RECON_VIEWS // RECON_BATCH)
        arms = [("table", "decode_maps", calib_mat), ("quadratic", "scan_fused", calib_mat),
                ("true", "decode_maps", true_calib)]
        errors = {}
        for arm, kernel, calib_path in arms:
            cfg = Config()
            cfg.decode.n_cols, cfg.decode.n_rows = PROJ
            cfg.parallel.compute_batch = RECON_BATCH
            cfg.triangulate.plane_eval = "quadratic" if arm == "quadratic" else "table"
            out_dir = os.path.join(root, f"out_{arm}")
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            report = stages.reconstruct(calib_path, data, mode="batch", output=out_dir,
                                        cfg=cfg, device=dev, log=lambda m: None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            check(counts[kernel] == n_batches and sum(counts.values()) == n_batches,
                  f"recovered-calibration {arm} arm launched {counts}, not {kernel} once "
                  f"for each of {n_batches} batches")
            check(len(report.outputs) == RECON_VIEWS,
                  f"recovered-calibration {arm} arm wrote {len(report.outputs)} views")
            errors[arm] = [surface_errors(p) for p in sorted(report.outputs)]
            print(json.dumps({"reconstruct": f"{arm} lane", "calib": os.path.basename(
                calib_path), "launches": counts, "wall_s": wall,
                "surface_mm [median, p99, points] a view": errors[arm],
                "jax_view0": CALIB_JAX["recon"][arm], "card": card}), flush=True)
        for arm in ("table", "quadratic"):
            ref = CALIB_JAX["recon"][arm]
            for i, (med, p99, n) in enumerate(errors[arm]):
                check(n > 0.05 * CAM[0] * CAM[1], f"{arm}: view {i} holds {n} points")
                check(med <= GATE * ref[0] and p99 <= GATE * ref[1],
                      f"recovered-calibration {arm}: view {i} median {med} / p99 {p99} mm "
                      f"from the true surfaces > {GATE} x the JAX package's {ref[:2]}")

    # (c) undistort one stack on the card and on the CPU
    stack = frames_np[0]
    on_card = torch.from_numpy(stack).to(dev)
    got = ud.undistort_stack(on_card, rig.cam_K, UNDISTORT_DIST, device=dev).cpu().numpy()
    ref = ud.undistort_stack(stack, rig.cam_K, UNDISTORT_DIST, device="cpu").numpy()
    diff = np.abs(got.astype(np.int16) - ref)
    off = float((diff > 0).mean())
    same = ud.undistort_stack(on_card, rig.cam_K, np.zeros(5), device=dev)
    ident = bool(torch.equal(same, on_card))
    ms = time_ms(lambda: ud.undistort_stack(on_card, rig.cam_K, UNDISTORT_DIST,
                                            device=dev), reps=5)
    changed = float((got != stack).mean())
    print(json.dumps({"undistort": list(stack.shape), "dist": UNDISTORT_DIST,
                      "ms": ms, "pixels_off_by_one_vs_cpu": off,
                      "max_abs_diff_vs_cpu": int(diff.max()),
                      "pixels_changed_by_the_lens": changed,
                      "zero_distortion_identity": ident, "card": card}), flush=True)
    check(diff.max() <= 1 and off <= 1e-4,
          f"undistort: card vs CPU max diff {int(diff.max())}, {off} of pixels differ")
    check(ident, "undistort: zero distortion changed the stack")
    check(changed > 0.1, f"undistort: the lens changed only {changed} of the pixels")


def capture_phase(dev, data: str, calib: str, raw: list, root: str, cold: dict,
                  card: str) -> None:
    """Phase 12(d): ``auto_scan_360`` of phase 7's 24 views over the real
    HTTP rendezvous: the port's CaptureServer, a virtual projector, the
    sequencer (no settle, pack_frames) and a simulated turntable
    (CAPTURE_TURN_S a turn); a fake-phone thread long-polls /poll_command
    and uploads, for each fresh command, the PNG (cv2) of phase 7's raw
    render of the frame shown at the turntable's view. Then
    ``run_pipeline`` over the captured root in a fresh directory with phase
    7's config. Gates: 24 folders named by ``view_folder_name``, each
    holding only a frames.slbp byte-equal to phase 7's; 24 progress events,
    the last with remaining_s 0; merged.ply and model.stl byte-identical to
    phase 7's cold run; decode_maps once a batch, radius_count 2 a view,
    nn1, ransac_score and slab_mean_knn at least once."""
    import threading
    import urllib.request

    import cv2
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.acquire.autoscan import (
        auto_scan_360,
        view_folder_name,
    )
    from structured_light_for_3d_model_replication_tpu_torch.acquire.projector import (
        VirtualProjector,
    )
    from structured_light_for_3d_model_replication_tpu_torch.acquire.sequencer import (
        CaptureSequencer,
    )
    from structured_light_for_3d_model_replication_tpu_torch.acquire.server import (
        CaptureServer,
    )
    from structured_light_for_3d_model_replication_tpu_torch.acquire.turntable import (
        SimulatedTurntable,
    )
    from structured_light_for_3d_model_replication_tpu_torch.acquire.viewer import (
        StageRecorder,
    )
    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    step = 360.0 / PIPE_VIEWS
    n_frames = raw[0].shape[0]
    srv = CaptureServer("127.0.0.1", 0).start()
    base = f"http://127.0.0.1:{srv.port}"
    proj = VirtualProjector(*PIPE_PROJ)
    table = SimulatedTurntable(CAPTURE_TURN_S)
    stop = threading.Event()
    phone_errors: list[BaseException] = []

    def phone() -> None:
        last = None
        try:
            while not stop.is_set():
                try:
                    with urllib.request.urlopen(base + "/poll_command", timeout=10) as r:
                        cmd = json.loads(r.read())
                except OSError:
                    continue
                if cmd["action"] != "capture" or cmd["id"] == last:
                    continue
                last = cmd["id"]
                view = int(round(table.angle / step)) % PIPE_VIEWS
                frame = raw[view][(len(proj.shown) - 1) % n_frames]
                ok, png = cv2.imencode(".png", frame)
                check(ok, "fake phone: PNG encode failed")
                req = urllib.request.Request(
                    f"{base}/upload?id={cmd['id']}", data=png.tobytes(),
                    headers={"Content-Type": "image/png"}, method="POST")
                with urllib.request.urlopen(req, timeout=10) as r:
                    json.loads(r.read())
        except BaseException as e:   # re-raised by the phase below
            phone_errors.append(e)

    round_trips: list[float] = []

    def capture(path: str) -> None:
        t0 = time.perf_counter()
        srv.trigger_capture(path, timeout=20.0)
        round_trips.append(time.perf_counter() - t0)

    seq = CaptureSequencer(proj, capture, proj_size=PIPE_PROJ, scan_settle_ms=0,
                           pack_frames=True, log=lambda m: None)
    captured = os.path.join(root, "captured")
    art = os.path.join(root, "capture_artifacts")
    thread = threading.Thread(target=phone, name="fake-phone", daemon=True)
    thread.start()
    t0 = time.perf_counter()
    try:
        res = auto_scan_360(seq, table, captured, turns=PIPE_VIEWS, step_deg=step,
                            rotate_timeout=5.0,
                            progress=StageRecorder(art).autoscan_progress,
                            log=lambda m: None)
    finally:
        stop.set()
        srv.stop()
        thread.join(timeout=30)
    capture_wall = time.perf_counter() - t0
    check(not thread.is_alive(), "fake phone: the thread did not end")
    if phone_errors:
        raise phone_errors[0]
    names = [view_folder_name("scan", i * step) for i in range(PIPE_VIEWS)]
    check([os.path.basename(d) for d in res.view_dirs] == names
          and not res.failures and not res.rotation_warnings,
          f"auto-scan: views {[os.path.basename(d) for d in res.view_dirs]}, failures "
          f"{[f.as_dict() for f in res.failures]}, warnings {res.rotation_warnings}")
    for i, name in enumerate(names):
        got = os.path.join(captured, name)
        check(os.listdir(got) == ["frames.slbp"], f"auto-scan: {name} holds "
                                                  f"{os.listdir(got)}")
        with open(os.path.join(got, "frames.slbp"), "rb") as a, open(os.path.join(
                data, f"view_{round(i * step):03d}deg", "frames.slbp"), "rb") as b:
            check(a.read() == b.read(), f"auto-scan: {name}/frames.slbp differs from "
                                        f"phase 7's")
    with open(os.path.join(art, "progress.json")) as f:
        events = json.load(f)
    check(len(events) == PIPE_VIEWS and all(e["stage"] == "autoscan" for e in events)
          and events[-1]["remaining_s"] == 0.0,
          f"auto-scan: {len(events)} progress events, the last {events[-1:]}")

    cfg = load_config(None, PIPE_OVERRIDES)
    out = os.path.join(root, "pipeline_captured")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = stages.run_pipeline(calib, captured, out, cfg=cfg, device=dev,
                                 log=lambda m: None)
    torch.cuda.synchronize()
    pipe_wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(json.dumps({"auto-scan": f"{PIPE_VIEWS} views over HTTP",
                      "captures": len(round_trips), "capture_wall_s": capture_wall,
                      "median_round_trip_s": float(np.median(round_trips)),
                      "p99_round_trip_s": float(np.percentile(round_trips, 99)),
                      "pipeline_wall_s": pipe_wall,
                      "phase7_cold_wall_s": cold["wall_s"], "launches": counts,
                      "phase7_launches": cold["counts"], "card": card}), flush=True)
    check(len(round_trips) == PIPE_VIEWS * n_frames,
          f"auto-scan: {len(round_trips)} captures, not {PIPE_VIEWS * n_frames}")
    check(report.failures == [] and not report.degraded,
          f"captured pipeline: failures {[f.as_dict() for f in report.failures]}")
    for name in ("merged.ply", "model.stl"):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(cold["out"], name), "rb") as b:
            check(a.read() == b.read(), f"captured pipeline: {name} differs from phase "
                                        f"7's cold run")
    n_batches = -(-PIPE_VIEWS // cfg.parallel.compute_batch)
    check(counts["decode_maps"] == n_batches,
          f"captured pipeline: decode_maps launched {counts['decode_maps']} times, not "
          f"once for each of {n_batches} batches")
    check(counts["radius_count"] == 2 * PIPE_VIEWS,
          f"captured pipeline: radius_count launched {counts['radius_count']} times")
    for k in ("nn1", "ransac_score", "slab_mean_knn"):
        check(counts[k] > 0, f"captured pipeline never launched {k}: {counts}")


# phase 13: the coordinated pipeline. (c)'s lease is short enough to steal
# quickly and still longer than any opaque stage call of a warm worker
COORD_WORKERS = 2
COORD_LEASE_S = 8.0
COORD_VIEW_KERNELS = ("decode_maps", "scan_fused", "decode_packed_maps", "radius_count",
                      "ransac_score", "nn1")
PORT_PKG = "structured_light_for_3d_model_replication_tpu_torch"


def worker_exit(log_path: str) -> dict | None:
    """A worker log's exit line: {"launches": {kernel: n}, "peak_bytes": n};
    None for a worker that was killed (it writes none)."""
    import re

    with open(log_path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    for line in reversed(lines):
        m = re.search(r"exit: launches (\{.*\}) peak_device_bytes (\d+)", line)
        if m:
            return {"launches": json.loads(m.group(1)), "peak_bytes": int(m.group(2))}
    return None


def _ledger(out: str) -> list[dict]:
    with open(os.path.join(out, "ledger.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _start_external(out: str, done) -> dict:
    """A thread that waits for the coordinator's ``<out>/.coord/join.json``
    and starts ``python -m <port> worker --spec`` on it, its output in
    ``<out>/.coord/ext0.log``. Returns {"thread", "proc" (once started)}."""
    import threading

    ext: dict = {}

    def join() -> None:
        path = os.path.join(out, ".coord", "join.json")
        deadline = time.monotonic() + 300.0
        while not os.path.exists(path):
            if done.is_set() or time.monotonic() > deadline:
                return
            time.sleep(0.05)
        time.sleep(0.2)   # the coordinator's json.dump has finished
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [here] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        with open(os.path.join(out, ".coord", "ext0.log"), "wb") as logf:
            ext["proc"] = subprocess.Popen(
                [sys.executable, "-m", PORT_PKG, "worker", "--spec", path],
                stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=here)

    ext["thread"] = threading.Thread(target=join, name="chip-smoke-ext0", daemon=True)
    ext["thread"].start()
    return ext


def pair_group_gate(dev, data: str, calib: str, cold: dict, card: str) -> None:
    """Phase 13's first gate: phase 7's 23 chain pairs, prepped from its
    cached cleaned views as a worker preps them, registered in groups of
    ``merge.pair_batch`` (the streamed lane's schedule) and each alone (a
    worker's pair item): T, gfit, ifit and irmse byte-equal, and equal to
    the pair entries phase 7's streamed lane cached. A pair that rounded by
    its group would show here, not as a cold merge in the arms below."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
    from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (
        StageCache,
    )

    cfg = load_config(None, PIPE_OVERRIDES)
    cache = StageCache(os.path.join(cold["out"], ".slscan-cache"), log=lambda m: None)
    _, _, keys, _ = stages._view_plan(calib, data, cfg, stages.CLEAN_STEPS, cache,
                                      lambda m: None, dev)
    views = [cache.get("view", k) for k in keys]
    check(len(views) == PIPE_VIEWS and all(v is not None for v in views),
          "pair group gate: phase 7's cleaned views are not all cached")
    pts = [np.asarray(v["points"], np.float32) for v in views]
    digs = [StageCache.digest_arrays(points=p, colors=np.asarray(v["colors"], np.uint8))
            for p, v in zip(pts, views)]
    voxel = float(cfg.merge.voxel_size)
    preps = [recon.prep_view(p, voxel, cfg.merge.sample_before, device=dev) for p in pts]
    pairs = [(preps[i + 1], preps[i]) for i in range(len(preps) - 1)]
    kw = dict(feat_bf16=cfg.parallel.force_bf16_features)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    group, t_group = timed(lambda: recon.register_prep_pairs(
        pairs, list(range(len(pairs))), cfg.merge, voxel, **kw))
    alone, t_alone = timed(lambda: [recon.register_prep_pairs([pr], [i], cfg.merge, voxel,
                                                              **kw)
                                    for i, pr in enumerate(pairs)])
    names = ("T", "gfit", "ifit", "irmse")
    for i in range(len(pairs)):
        for k, name in enumerate(names):
            check(np.asarray(alone[i][k][0]).tobytes() == np.asarray(group[k][i]).tobytes(),
                  f"pair group gate: pair {i}'s {name} alone differs from its group's")
        hit = cache.get("pair", stages._pair_key(cache, cfg, dev, digs[i], digs[i + 1], i))
        check(hit is not None, f"pair group gate: phase 7 cached no pair {i}")
        for k, name in enumerate(names):
            check(np.asarray(hit[name], np.float32).tobytes()
                  == np.asarray(group[k][i], np.float32).tobytes(),
                  f"pair group gate: pair {i}'s {name} differs from phase 7's streamed lane")
    print(json.dumps({"pair_group_gate": len(pairs), "pair_batch": cfg.merge.pair_batch,
                      "grouped_s": t_group, "alone_s": t_alone, "card": card}), flush=True)


def coordinated_phase(dev, data: str, calib: str, root: str, cold: dict, subset: dict,
                      card: str) -> None:
    """Phase 13: first ``pair_group_gate`` (a pair's bytes alone, in its
    group and in phase 7's pair cache), then ``run_pipeline`` with
    ``coordinator.workers`` over phase
    7's 24 views (phase 7's config, device cuda) in fresh directories, each
    arm's merged.ply and model.stl byte-identical to phase 7's cold run.
    (a) loopback, 2 spawned workers: the ledger completes 24 view and 23
    pair items with no steal and nothing lost; this process (the assembly
    pass) launches none of COORD_VIEW_KERNELS; the workers' launch counts
    (their logs' exit lines) sum to decode_maps 24 and radius_count 48,
    with ransac_score and nn1 launched; each worker's peak device memory and
    the wall beside phase 7's cold wall printed. (b) the pod fabric:
    ``coordinator.listen=127.0.0.1:0``, a secret, 1 spawned worker,
    ``merge.incremental`` and the flight recorder on, plus an external
    worker started here from ``<out>/.coord/join.json``: it completes at
    least one item and exits 0, the spawned worker warms its private L1
    root, the fold lane folds at least one view, the port's ``report
    --validate`` exits 0 over the directory and the journals' fabric bytes
    equal the blob server's counters; pushes, fetches, bytes and the
    assembly tail printed. (c) chaos: ``SL3D_FAULTS=worker.item~w0:
    worker.kill@3``, a COORD_LEASE_S lease and 1 s heartbeats: w0 exits
    137, the ledger holds a steal, and no item completed before the kill is
    granted again; this arm runs on the SERVE_SUBSET views
    (``subset_reference``) and is held to their solo run's bytes."""
    import threading

    import torch

    from structured_light_for_3d_model_replication_tpu_torch.cli import main as cli_main
    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import (
        report as replib,
    )
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
    from structured_light_for_3d_model_replication_tpu_torch.utils import faults

    with open(os.path.join(cold["out"], "merged.ply"), "rb") as f:
        cold_ply = f.read()
    with open(os.path.join(cold["out"], "model.stl"), "rb") as f:
        cold_stl = f.read()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    pair_group_gate(dev, data, calib, cold, card)

    def run(arm: str, sets: dict, external: bool = False, data_: str = data,
            want: tuple = (cold_ply, cold_stl)):
        cfg = load_config(None, {**PIPE_OVERRIDES, **sets})
        out = os.path.join(root, f"coord_{arm}")
        ext, done = None, threading.Event()
        if external:
            ext = _start_external(out, done)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            report = stages.run_pipeline(calib, data_, out, cfg=cfg, device=dev,
                                         log=lambda m: None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            done.set()
            if ext is not None:
                ext["thread"].join(timeout=10.0)
                proc = ext.get("proc")
                if proc is not None:
                    try:
                        proc.wait(timeout=60.0)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
        counts = kernels.launch_counts()
        for name, mine in zip(("merged.ply", "model.stl"), want):
            with open(os.path.join(out, name), "rb") as f:
                check(f.read() == mine,
                      f"coordinated {arm}: {name} differs from its solo run")
        check(report.failures == [] and not report.degraded,
              f"coordinated {arm}: failures {[f.as_dict() for f in report.failures]}")
        c = report.coordinator or {}
        check(c.get("device") == str(dev), f"coordinated {arm}: ran on {c.get('device')}")
        workers = {}
        for name in sorted(os.listdir(os.path.join(out, ".coord"))):
            if name.endswith(".log"):
                workers[name[:-4]] = worker_exit(os.path.join(out, ".coord", name))
        killed = {f"worker{w[1:]}" for w, rc in c.get("worker_exit_codes", {}).items()
                  if rc == 137}
        for w, v in workers.items():
            check(v is not None or w in killed,
                  f"coordinated {arm}: {w}'s log has no exit line")
        line = {"coordinated": arm, "wall_s": wall, "cold_wall_s": cold["wall_s"],
                "coordination_wall_s": c.get("coordination_wall_s"),
                "assembly": c.get("assembly"), "item_states": c.get("item_states"),
                "completed_by_worker": c.get("completed_by_worker"),
                "steals": c.get("steals"), "exit_codes": c.get("worker_exit_codes"),
                "assembly_launches": counts,
                "workers": {w: v and {"launches": v["launches"],
                                      "peak_device_gb": round(v["peak_bytes"] / 1e9, 3)}
                            for w, v in workers.items()},
                "walls_s": report.walls_s, "card": card}
        if ext is not None:
            line["external_exit"] = ext["proc"].returncode if "proc" in ext else None
        print(json.dumps(line), flush=True)
        return out, report, c, counts, workers, ext

    # (a) loopback
    n_items = 2 * PIPE_VIEWS - 1
    out, report, c, counts, workers, _ = run("loopback",
                                             {"coordinator.workers": COORD_WORKERS})
    check(c["item_states"] == {"completed": n_items} and c["steals"] == 0,
          f"coordinated loopback: items {c['item_states']}, steals {c['steals']}")
    events = _ledger(out)
    done_items = {e["item"] for e in events if e["type"] == "complete"}
    check(sum(i.startswith("view:") for i in done_items) == PIPE_VIEWS
          and sum(i.startswith("pair:") for i in done_items) == PIPE_VIEWS - 1,
          f"coordinated loopback: the ledger completes {sorted(done_items)}")
    check(not any(e["type"] in ("steal", "lost") for e in events),
          "coordinated loopback: the ledger holds a steal or a lost item")
    for k in COORD_VIEW_KERNELS:
        check(counts[k] == 0, f"coordinated loopback: the assembly pass launched {k} "
                              f"{counts[k]} times (a view or pair was not a cache hit)")
    total = {k: sum(w["launches"].get(k, 0) for w in workers.values())
             for k in kernels.launch_counts()}
    check(len(workers) == COORD_WORKERS, f"coordinated loopback: worker logs {list(workers)}")
    check(total["decode_maps"] == PIPE_VIEWS and total["radius_count"] == 2 * PIPE_VIEWS,
          f"coordinated loopback: the workers launched decode_maps "
          f"{total['decode_maps']} and radius_count {total['radius_count']} times, not "
          f"{PIPE_VIEWS} and {2 * PIPE_VIEWS}")
    check(total["ransac_score"] > 0 and total["nn1"] > 0,
          f"coordinated loopback: the workers never registered a pair: {total}")
    print(f"coordinated (a) loopback: {c['coordination_wall_s']:.2f} s coordinating, "
          f"{c['total_wall_s']:.2f} s in all against phase 7's cold "
          f"{cold['wall_s']:.2f} s; workers' launches {json.dumps(total)}; peak device "
          + ", ".join(f"{w} {v['peak_bytes'] / 1e9:.3f} GB" for w, v in workers.items()),
          flush=True)

    # (b) the pod fabric, an external worker and the incremental assembly
    out, report, c, counts, workers, ext = run("fabric", {
        "coordinator.workers": 1, "coordinator.listen": "127.0.0.1:0",
        "coordinator.secret": "chip-smoke-pod", "merge.incremental": True,
        "observability.trace": True}, external=True)
    check("proc" in ext and ext["proc"].returncode == 0,
          f"coordinated fabric: the external worker exited "
          f"{ext['proc'].returncode if 'proc' in ext else 'never started'}")
    check(c["completed_by_worker"].get("ext0", 0) >= 1,
          f"coordinated fabric: the external worker completed nothing "
          f"({c['completed_by_worker']})")
    l1 = os.path.join(out, ".slscan-cache.w0")
    check(os.path.isdir(l1) and any(f.endswith(".npz") for f in os.listdir(l1)),
          "coordinated fabric: the spawned worker warmed no private L1 root")
    asm = report.assembly or {}
    check(asm.get("folded_views", 0) >= 1 and asm.get("used_views", 0) >= 1,
          f"coordinated fabric: the fold lane folded nothing ({asm})")
    rc, text = run_cli(cli_main, ["report", out, "--validate"])
    check(rc == 0, f"coordinated fabric: report --validate exited {rc}:\n{text}")
    rows = replib.merge_host_timeline(out)
    moved = {k: sum(int(r.get(k) or 0) for r in rows if r.get("ev") == "fabric.bytes")
             for k in ("fetched", "pushed", "deduped")}
    fb = c["fabric"]
    check((moved["fetched"], moved["pushed"], moved["deduped"])
          == (fb["bytes_fetched"], fb["bytes_pushed"], fb["bytes_deduped"]),
          f"coordinated fabric: the journals' fabric bytes {moved} against the blob "
          f"server's {fb}")
    print(f"coordinated (b) fabric: blob pushes {fb['pushes']} ({fb['bytes_pushed']} B), "
          f"fetches {fb['fetches']} ({fb['bytes_fetched']} B), dedups {fb['dedups']}; "
          f"locality hits {c.get('locality_hits')} misses {c.get('locality_misses')}; "
          f"completed {c['completed_by_worker']}; folded {asm['folded_views']} views, "
          f"{asm['used_views']} seeded the merge; assembly tail "
          f"{c['assembly']['tail_s']:.3f} s; {len(rows)} journal rows, "
          f"{len(replib.host_journals(out))} journals valid", flush=True)

    # (c) chaos: w0 killed on its third item under a short lease, on the subset
    os.environ["SL3D_FAULTS"] = "worker.item~w0:worker.kill@3"
    try:
        out, report, c, counts, workers, _ = run("chaos", {
            "coordinator.workers": COORD_WORKERS, "coordinator.lease_s": COORD_LEASE_S,
            "coordinator.heartbeat_s": 1.0}, data_=subset["data"],
            want=(subset["ply"], subset["stl"]))
    finally:
        os.environ.pop("SL3D_FAULTS", None)
        faults.reset()
    check(c["worker_exit_codes"].get("w0") == 137,
          f"coordinated chaos: w0 exited {c['worker_exit_codes']}")
    events = _ledger(out)
    steals = [e for e in events if e["type"] == "steal"]
    check(len(steals) >= 1, "coordinated chaos: the ledger holds no steal")
    first_done: dict = {}
    for i, e in enumerate(events):
        if e["type"] == "complete":
            first_done.setdefault(e["item"], i)
    again = sorted({e["item"] for i, e in enumerate(events)
                    if e["type"] == "grant" and i > first_done.get(e["item"], len(events))})
    check(not again, f"coordinated chaos: completed items granted again: {again}")
    print(f"coordinated (c) chaos: w0 exited 137; {len(steals)} steal(s) "
          f"({', '.join(e['item'] for e in steals)}); {c['item_states']}; wall "
          f"{c['total_wall_s']:.2f} s; phase 13 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


SERVE_SUBSET = 8        # phase 14(b)-(d): the first 8 of phase 7's views, full width
SERVE_HA_LEASE_S = 2.0
SERVE_HA_SLOW_S = 0.5   # compute.view:slow a view in 14(c), both gateways
SERVE_WAIT_S = 300.0


def subset_reference(dev, data: str, calib: str, root: str, card: str) -> dict:
    """The first SERVE_SUBSET of phase 7's views copied to root/scans_subset
    and one solo ``run_pipeline`` of them (phase 7's config, in the phase):
    what phase 13(c) and phase 14(b)-(d) are held to. Returns {"data",
    "ply", "stl", "wall_s"}."""
    import shutil

    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    sub = os.path.join(root, "scans_subset")
    views = sorted(n for n in os.listdir(data) if os.path.isdir(os.path.join(data, n)))
    for name in views[:SERVE_SUBSET]:
        shutil.copytree(os.path.join(data, name), os.path.join(sub, name))
    out = os.path.join(root, "subset_solo")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = stages.run_pipeline(calib, sub, out, cfg=load_config(None, PIPE_OVERRIDES),
                                 device=dev, log=lambda m: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not report.failures and report.views_computed == SERVE_SUBSET,
          f"subset solo: {report.views_computed} views computed, failures "
          f"{[f.as_dict() for f in report.failures]}")
    ref = {"data": sub, "wall_s": wall}
    for key, name in (("ply", "merged.ply"), ("stl", "model.stl")):
        with open(os.path.join(out, name), "rb") as f:
            ref[key] = f.read()
    print(json.dumps({"subset solo": SERVE_SUBSET, "wall_s": wall,
                      "merged_points": report.merged_points, "card": card}), flush=True)
    return ref


def _serve_splits(ledger_path: str) -> dict:
    """Each request's queue (submit -> admit), warm (admit -> warmed) and
    assembly (warmed -> finish) seconds from the ledger's timestamps."""
    marks: dict = {}
    with open(ledger_path, encoding="utf-8") as f:
        for line in f:
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if ev.get("type") in ("submit", "admit", "warmed", "finish") and "scan" in ev:
                marks.setdefault(ev["scan"], {}).setdefault(ev["type"], ev["t"])
    out = {}
    for sid, m in marks.items():
        if {"submit", "admit", "warmed", "finish"} <= set(m):
            out[sid] = {"queue_s": round(m["admit"] - m["submit"], 3),
                        "warm_s": round(m["warmed"] - m["admit"], 3),
                        "assembly_s": round(m["finish"] - m["warmed"], 3)}
    return out


def _engine_trouble(logs: list[str]) -> list[str]:
    """Engine exception, view failure and fallback lines of a service log."""
    return [m for m in logs if m.startswith("[serve] engine ") or "view FAILED" in m
            or "degraded to per-view" in m]


def _wait_done(svc, sid: str, what: str) -> dict:
    from structured_light_for_3d_model_replication_tpu_torch.parallel.admission import (
        TERMINAL,
    )

    t0 = time.monotonic()
    d = None
    while time.monotonic() - t0 < SERVE_WAIT_S:
        d = svc.status(sid)
        if d is not None and d["state"] in TERMINAL:
            break
        time.sleep(0.05)
    check(d is not None and d["state"] == "done", f"serve {what}: {sid} ended {d}")
    return d


def _served_bytes(svc, sid: str, want: tuple, what: str) -> None:
    for art, mine in (("ply", want[0]), ("stl", want[1])):
        path, err = svc.result_path(sid, art)
        check(bool(path), f"serve {what}: no {art} for {sid}: {err}")
        with open(path, "rb") as f:
            check(f.read() == mine, f"serve {what}: {sid}'s {art} differs from its solo run")


def serving_phase(dev, data: str, calib: str, root: str, cold: dict, subset: dict,
                  card: str) -> None:
    """Phase 14: the scan service (``pipeline/serving.py``) on the card,
    phase 7's config with ``serving.port=0``. Each arm zeroes the kernels'
    launch counts and the peak device memory first and prints its wall, its
    launches, the peak and each request's queue / warm / assembly split from
    the ledger. (a) a solo gateway over HTTP with auth on: two tenants
    minted by ``tenant add`` (ta limited to one submit a window), ta submits
    phase 7's 24 views and tb phase 8's dirty copy together; both done, the
    served merged.ply and model.stl byte-identical to phase 7's cold run and
    phase 8's dirty run, at least one cross-tenant launch, no view failure,
    no engine exception or fallback line, each assembly computing no view;
    an unauthenticated submit is a 401, ta's second a 429; then tb submits
    phase 7's views again, planned after the store is warm: 24 views
    deduped, none computed, the bytes phase 7's; /usage equals
    ``fold_usage`` over the ledger. (b)-(d) on the SERVE_SUBSET views
    (``subset_reference``): (b) ``serve.crash`` at the assembly boundary of
    the scan, then a new ScanService over the root resumes it with no view
    computed and its bytes; (c) two HA gateways, a SERVE_HA_LEASE_S lease:
    once the leader credited a view, its renew stalls; the follower takes
    over at epoch 2, computes at most the views epoch 1 did not credit, the
    bytes are the subset's, and the old leader's next append is fenced and
    it demotes; (d) the elastic fleet (min 1, max 2 workers on the card,
    compute_batch 1 so the lane and the workers share the grants): the
    bytes, a fleet worker completed a view, the ledger holds the spawns,
    each worker's exit line (launches, peak memory) printed, no worker
    process left after close. (e) ``warmup`` and ``doctor`` as
    subprocesses: both exit 0, warmup finds the library built and prints
    each kernel's first launch, doctor prints the card's name and power
    limit."""
    import threading
    import urllib.error
    import urllib.request

    import torch

    from structured_light_for_3d_model_replication_tpu_torch.cli import main as cli_main
    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.parallel import admission
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import serving
    from structured_light_for_3d_model_replication_tpu_torch.utils import faults

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    cold_b = (read(os.path.join(cold["out"], "merged.ply")),
              read(os.path.join(cold["out"], "model.stl")))
    dirty_b = (read(os.path.join(root, "schedule_dirty", "merged.ply")),
               read(os.path.join(root, "schedule_dirty", "model.stl")))
    sub_b = (subset["ply"], subset["stl"])
    t_phase = time.perf_counter()

    def cfg(**sets):
        base = {**PIPE_OVERRIDES, "serving.port": 0}
        base.update({k.replace("__", "."): v for k, v in sets.items()})
        return load_config(None, base)

    def arm_start():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def arm_line(arm: str, t0: float, root_: str, scans=None, **extra):
        torch.cuda.synchronize()
        splits = _serve_splits(os.path.join(root_, "ledger.jsonl"))
        line = {"serve": arm, "wall_s": time.perf_counter() - t0,
                "launches": kernels.launch_counts(),
                "peak_device_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
                "requests": {k: v for k, v in splits.items() if scans is None or k in scans},
                **extra, "card": card}
        print(json.dumps(line), flush=True)
        return line

    def post(url, payload, key=None):
        req = urllib.request.Request(
            url + "/submit", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **({"X-API-Key": key} if key
                                                              else {})})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(url):
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.read()

    # (a) solo gateway over HTTP, auth on
    root_a = os.path.join(root, "serve_a")
    keys = {}
    for tenant, extra in (("ta", ["--rate-limit", "1"]), ("tb", [])):
        rc, text = run_cli(cli_main, ["tenant", "add", root_a, tenant, *extra,
                                      "--device", dev.type])
        check(rc == 0, f"serve (a): tenant add {tenant} exited {rc}")
        keys[tenant] = text.strip().rsplit(" ", 1)[-1]
    logs: list[str] = []
    t0 = arm_start()
    httpd, svc = serving.start_gateway(
        root_a, cfg=cfg(serving__auth_enabled=True, serving__max_active_scans=4),
        log=logs.append, device=dev)
    threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    dirty = os.path.join(root, "scans_dirty")
    try:
        code, body = post(url, {"tenant": "ta", "target": data, "calib": calib})
        check(code == 401 and body.get("reason") == "auth-required",
              f"serve (a): unauthenticated submit answered {code} {body}")
        sids = {}
        for tenant, target in (("ta", data), ("tb", dirty)):
            code, body = post(url, {"tenant": tenant, "target": target, "calib": calib},
                              key=keys[tenant])
            check(code == 200, f"serve (a): {tenant}'s submit answered {code} {body}")
            sids[tenant] = body["scan_id"]
        code, body = post(url, {"tenant": "ta", "target": data, "calib": calib},
                          key=keys["ta"])
        check(code == 429 and body.get("reason") == "rate-limited",
              f"serve (a): ta's second submit answered {code} {body}")
        for tenant, want in (("ta", cold_b), ("tb", dirty_b)):
            d = _wait_done(svc, sids[tenant], "(a)")
            _served_bytes(svc, sids[tenant], want, "(a)")
            check(get(f"{url}/result/{sids[tenant]}?artifact=stl") == want[1],
                  f"serve (a): /result of {sids[tenant]} differs")
            check(d["report"]["views_computed"] == 0,
                  f"serve (a): {sids[tenant]}'s assembly computed "
                  f"{d['report']['views_computed']} views")
        reg = svc.registry
        cross = reg.counter_value("sl3d_serve_cross_tenant_launches_total")
        check(cross >= 1, "serve (a): no cross-tenant launch")
        warmed = {t: reg.counter_value("sl3d_serve_views_warmed_total", tenant=t)
                  for t in ("ta", "tb")}
        fails = {t: reg.counter_value("sl3d_serve_view_failures_total", tenant=t)
                 for t in ("ta", "tb")}
        check(not any(fails.values()) and not _engine_trouble(logs),
              f"serve (a): view failures {fails}: {_engine_trouble(logs)[:5]}")
        arm_line("(a) two tenants", t0, root_a, scans=set(sids.values()),
                 cross_tenant_launches=cross,
                         launches_total=reg.counter_value("sl3d_serve_launches_total"),
                         launch_views=reg.counter_value("sl3d_serve_launch_views_total"),
                         views_warmed=warmed)
        dedup0 = reg.counter_value("sl3d_serve_views_dedup_total", tenant="tb")
        t0 = arm_start()
        code, body = post(url, {"tenant": "tb", "target": data, "calib": calib,
                                "scan_id": "again"}, key=keys["tb"])
        check(code == 200, f"serve (a): tb's second submit answered {code} {body}")
        d = _wait_done(svc, body["scan_id"], "(a) dedup")
        _served_bytes(svc, body["scan_id"], cold_b, "(a) dedup")
        dedup = reg.counter_value("sl3d_serve_views_dedup_total", tenant="tb") - dedup0
        again = reg.counter_value("sl3d_serve_views_warmed_total", tenant="tb") - warmed["tb"]
        check(dedup == PIPE_VIEWS and again == 0 and d["report"]["views_computed"] == 0,
              f"serve (a) dedup: {dedup} deduped, {again} warmed, "
              f"{d['report']['views_computed']} computed")
        counts = kernels.launch_counts()
        check(counts["decode_maps"] == 0 and counts["radius_count"] == 0,
              f"serve (a) dedup: view kernels launched {counts}")
        usage = json.loads(get(f"{url}/usage"))
        rs = admission.replay_serving(os.path.join(root_a, "ledger.jsonl"))
        check(usage == {"schema": "sl3d-usage-v1", "tenants": admission.fold_usage(rs)},
              f"serve (a): /usage {usage} is not the ledger's fold")
        arm_line("(a) dedup", t0, root_a, scans={body["scan_id"]}, deduped=dedup,
                 usage=usage["tenants"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()

    # (b) durable restart: a crash at the assembly boundary, then resume
    root_b = os.path.join(root, "serve_b")
    payload = {"tenant": "ta", "target": subset["data"], "calib": calib, "scan_id": "job1"}
    t0 = arm_start()
    c = cfg(faults__spec="serve.crash~assembly:crash")
    faults.configure_from(c.faults)
    svc = serving.ScanService(root_b, cfg=c, log=lambda m: None, device=dev)
    try:
        svc.start()
        ok, body = svc.submit(payload)
        check(ok, f"serve (b): submit {body}")
        t_end = time.monotonic() + SERVE_WAIT_S
        while svc.phase != "crashed" and time.monotonic() < t_end:
            time.sleep(0.05)
        check(svc.phase == "crashed", f"serve (b): no crash ({svc.status('ta-job1')})")
    finally:
        svc.close()
        faults.reset()
    crashed_s = time.perf_counter() - t0
    logs = []
    svc = serving.ScanService(root_b, cfg=cfg(), log=logs.append, device=dev)
    try:
        svc.start()
        d = _wait_done(svc, "ta-job1", "(b)")
        _served_bytes(svc, "ta-job1", sub_b, "(b)")
        check(d["report"]["views_computed"] == 0 and not _engine_trouble(logs),
              f"serve (b): resumed assembly computed {d['report']['views_computed']} "
              f"views; {_engine_trouble(logs)[:5]}")
        arm_line("(b) crash + resume", t0, root_b, crashed_after_s=crashed_s,
                 resumed=svc.registry.counter_value("sl3d_serve_resumed_total"))
    finally:
        svc.close()

    # (c) HA failover: the leader's renew stalls once part of the scan is credited
    root_c = os.path.join(root, "serve_c")
    ha = dict(serving__ha_enabled=True, serving__ha_lease_s=SERVE_HA_LEASE_S,
              serving__ha_poll_s=0.2, parallel__compute_batch=2)
    slow = f"compute.view:slow({SERVE_HA_SLOW_S})x1000"
    faults.configure(slow)
    logs_a, logs_b = [], []
    t0 = arm_start()
    def gateway(log):
        httpd, svc = serving.start_gateway(root_c, cfg=cfg(**ha), log=log, device=dev)
        threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                         daemon=True).start()
        return httpd, svc

    httpd_a, a = gateway(logs_a.append)
    httpd_b = b = None
    try:
        t_end = time.monotonic() + 60.0
        while a.role != "leader" and time.monotonic() < t_end:
            time.sleep(0.05)
        check(a.role == "leader", f"serve (c): the first gateway is {a.role}")
        httpd_b, b = gateway(logs_b.append)
        ok, body = a.submit({"tenant": "ta", "target": subset["data"], "calib": calib,
                             "scan_id": "ha"})
        check(ok, f"serve (c): submit {body}")
        ledger = os.path.join(root_c, "ledger.jsonl")
        t_end = time.monotonic() + SERVE_WAIT_S
        while time.monotonic() < t_end and not any(
                e["type"] == "complete" for e in _ledger_events(ledger)):
            time.sleep(0.05)
        faults.configure(f"{slow},election.renew~{a.run_id}:stall({3 * SERVE_HA_LEASE_S})")
        t_arm = time.perf_counter()
        t_end = time.monotonic() + 60.0
        while b.role != "leader" and time.monotonic() < t_end:
            time.sleep(0.05)
        check(b.role == "leader" and b.epoch == 2,
              f"serve (c): the follower is {b.role} at epoch {b.epoch}")
        takeover_s = time.perf_counter() - t_arm
        d = _wait_done(b, "ta-ha", "(c)")
        _served_bytes(b, "ta-ha", sub_b, "(c)")
        t_end = time.monotonic() + 60.0
        while a.role != "follower" and time.monotonic() < t_end:
            time.sleep(0.05)
        events = _ledger_events(ledger)
        credited = {e["item"] for e in events
                    if e["type"] == "complete" and e.get("epoch") == 1}
        stale = admission.replay_serving(ledger)["stale_ignored"]
        b_warmed = b.registry.counter_value("sl3d_serve_views_warmed_total", tenant="ta")
        fenced = [m for m in logs_a if "fenced" in m]
        check(a.role == "follower" and fenced,
              f"serve (c): the old leader is {a.role}; fenced lines {fenced}")
        check(b_warmed <= SERVE_SUBSET - len(credited) and d["report"]["views_computed"] == 0,
              f"serve (c): the new leader warmed {b_warmed} views with {len(credited)} "
              f"credited at epoch 1; its assembly computed {d['report']['views_computed']}")
        trouble = [m for m in _engine_trouble(logs_a + logs_b) if "fenced" not in m]
        check(not trouble, f"serve (c): {trouble[:5]}")
        arm_line("(c) HA failover", t0, root_c, takeover_s=takeover_s,
                 credited_epoch1=len(credited), new_leader_warmed=b_warmed,
                 stale_ignored=stale, fenced=fenced[0])
    finally:
        faults.reset()
        for h in (httpd_b, httpd_a):
            if h is not None:
                h.shutdown()
                h.server_close()
        if b is not None:
            b.close()
        a.close()

    # (d) the elastic fleet on the card
    root_d = os.path.join(root, "serve_d")
    logs = []
    t0 = arm_start()
    svc = serving.ScanService(root_d, cfg=cfg(
        serving__fleet_enabled=True, serving__fleet_min_workers=1,
        serving__fleet_max_workers=2, serving__fleet_poll_s=0.2,
        parallel__compute_batch=1), log=logs.append, device=dev)
    pids: set = set()
    try:
        svc.start()
        t_end = time.monotonic() + 180.0
        while not svc.fleet.state()["hellos"] and time.monotonic() < t_end:
            time.sleep(0.1)
        check(bool(svc.fleet.state()["hellos"]), "serve (d): no fleet worker said hello")
        ok, body = svc.submit({"tenant": "ta", "target": subset["data"], "calib": calib})
        check(ok, f"serve (d): submit {body}")
        d = _wait_done(svc, body["scan_id"], "(d)")
        _served_bytes(svc, body["scan_id"], sub_b, "(d)")
        st = svc.fleet.state()
        pids = set(st["pids"].values()) | {h["pid"] for h in st["hellos"].values()}
    finally:
        svc.close()
    events = _ledger_events(os.path.join(root_d, "ledger.jsonl"))
    spawns = [e for e in events if e["type"] == "fleet" and e["action"] in
              ("spawn", "respawn")]
    by_worker: dict = {}
    for e in events:
        if e["type"] == "complete":
            by_worker[e["worker"]] = by_worker.get(e["worker"], 0) + 1
    check(spawns and sum(n for w, n in by_worker.items() if w.startswith("fw")) >= 1,
          f"serve (d): spawns {len(spawns)}, completes by worker {by_worker}")
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    check(not alive, f"serve (d): fleet worker(s) {alive} outlived the service")
    workers = {}
    fleet_dir = os.path.join(root_d, "fleet")
    for name in sorted(os.listdir(fleet_dir)):
        if name.endswith(".log"):
            v = worker_exit(os.path.join(fleet_dir, name))
            check(v is not None, f"serve (d): {name} has no exit line")
            workers[name[:-4]] = {"launches": v["launches"],
                                  "peak_device_gb": round(v["peak_bytes"] / 1e9, 3)}
    check(d["report"]["views_computed"] == 0 and not _engine_trouble(logs),
          f"serve (d): assembly computed {d['report']['views_computed']}; "
          f"{_engine_trouble(logs)[:5]}")
    arm_line("(d) elastic fleet", t0, root_d, spawns=[(e["action"], e["rank"], e["gen"])
                                                      for e in spawns],
             completes_by_worker=by_worker, workers=workers)

    # (e) warmup and doctor as subprocesses on the card
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    cmds = {"warmup": ["warmup", "--cam", f"{PIPE_CAM[0]}x{PIPE_CAM[1]}",
                       "--proj", f"{PIPE_PROJ[0]}x{PIPE_PROJ[1]}",
                       "--views", str(SERVE_SUBSET), "--compute-batch", str(SERVE_SUBSET),
                       "--merge-views", str(SERVE_SUBSET)],
            "doctor": ["doctor", "--probe-timeout", "120"]}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-m", PORT_PKG, *cmd], cwd=here,
                                    env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, cmd in cmds.items()}   # both at once: two processes, one card
    lines = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            lines[name] = (out, time.perf_counter() - t0)
            print(out, end="", flush=True)
            check(proc.returncode == 0, f"serve (e): {name} exited {proc.returncode}:\n"
                                        f"{out[-2000:]}{err[-2000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = lines["warmup"][0]
    check("kernel library found built" in text and "first launch" in text,
          "serve (e): warmup did not find the library built or printed no first launch")
    text = lines["doctor"][0]
    check(torch.cuda.get_device_name(0) in text and card in text,
          f"serve (e): doctor does not print the card ({card})")
    print(json.dumps({"serve": "(e) warmup + doctor", "warmup_s": lines["warmup"][1],
                      "doctor_s": lines["doctor"][1], "card": card}), flush=True)
    print(f"serve: phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)


def _ledger_events(path: str) -> list[dict]:
    out = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
    except OSError:
        pass
    return out


# ---------------------------------------------------------------------------
# Phase 16: the sharded arms on a mesh of repeated cuda:0
# ---------------------------------------------------------------------------

SHARDS = 4                      # slots of the repeated-device mesh
SHARD_DEPTH_DENSE = 9           # 16(d): the dense solve the sharded one is held to
SHARD_DEPTH = 10                # 16(d): the slab-sharded depth-10 solve
SHARD_CG = 350
# 16(d): depth 9 against the dense solve at the JAX package's own test's CG
# count (tests/test_poisson_sharded.py): at 350 steps the dense solve and the
# sharded code on ONE slab already differ by 2.6e-3 in a few cells, the f32
# reduction order amplified by the late CG steps
# (tools/torch_sharded_poisson_noise.py; PERF.md section 6)
SHARD_CG_DENSE = 200
PP_CASE_POINTS = 11_940         # 16(c): the JAX test scene of (v), 60 far rows beside


def _peak_gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def _start_window() -> float:
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def _end_window(t0: float) -> tuple[float, dict, float]:
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, {k: n for k, n in kernels.launch_counts().items() if n}, _peak_gib()


def _same(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def sharded_forward_phase(dev, rig, stacks, card: str) -> None:
    """16(a) + (b). (a) phase 3's 8 views at 1080p through ``forward_views``
    (table and quadratic) and ``forward_views_packed`` with ``mesh=`` a mesh
    of SHARDS repeated cuda:0: the unsharded call's bytes, and the arm's
    kernel launched once a shard and nothing else. (b) the scan step at a
    (2, 2) mesh: the cloud equals ``forward_views`` (table, manual
    thresholds) byte for byte, decode launched once a slot; its n_valid and
    bounding box equal numpy's over that cloud, its centroid within 1e-6
    of numpy's float64 mean (relative to the cloud's extent)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.models.scanner import SLScanner
    from structured_light_for_3d_model_replication_tpu_torch.parallel import mesh as meshlib
    from structured_light_for_3d_model_replication_tpu_torch.parallel.scan import (
        build_sharded_scan_step,
    )

    calib = rig.calibration()
    mesh = meshlib.make_mesh(devices=[dev] * SHARDS)
    frames = np.stack([imio.unpack_stack(s)[0] for s in stacks])
    planes, white, black = (np.stack([getattr(s, k) for s in stacks])
                            for k in ("planes", "white", "black"))
    n_frames = stacks[0].n_frames
    arms = [("table", {"plane_eval": "table"}, "decode_maps", False),
            ("quadratic", {"plane_eval": "quadratic"}, "scan_fused", False),
            ("packed", {"plane_eval": "table"}, "decode_packed_maps", True)]
    for arm, kw, kernel, packed in arms:
        scanner = SLScanner(calib, CAM, PROJ, device=dev, **kw)

        def run(m):
            if packed:
                return scanner.forward_views_packed(planes, white, black, n_frames=n_frames,
                                                    mesh=m)
            return scanner.forward_views(frames, mesh=m)

        whole = run(None)
        t0 = _start_window()
        sharded = run(mesh)
        wall, counts, peak = _end_window(t0)
        check(counts == {kernel: SHARDS},
              f"16(a) {arm}: sharded forward launched {counts}, not {kernel} once for "
              f"each of {SHARDS} shards")
        check(_same(sharded, whole), f"16(a) {arm}: the sharded cloud differs from the "
                                     f"unsharded call's")
        print(json.dumps({"sharded": f"16(a) forward, {arm}", "views": int(frames.shape[0]),
                          "shards": SHARDS, "wall_s": wall, "peak_gib": peak,
                          "launches": counts, "valid": int(whole.valid.sum()),
                          "card": card}), flush=True)
        del whole, sharded
    scanner = SLScanner(calib, CAM, PROJ, device=dev)
    v = frames.shape[0]
    cw, ch = CAM
    step = build_sharded_scan_step(meshlib.make_mesh(2, 2, devices=[dev] * 4),
                                   proj_size=PROJ, row_mode=1)
    t0 = _start_window()
    cloud, stats = step(frames, scanner.rays.reshape(ch, cw, 3), scanner.oc,
                        scanner.plane_col, scanner.plane_row,
                        np.full(v, 40.0, np.float32), np.full(v, 10.0, np.float32))
    wall, counts, peak = _end_window(t0)
    whole = scanner.forward_views(frames, thresh_mode="manual")
    check(counts == {"decode_maps": 4}, f"16(b) scan step launched {counts}")
    check(_same(cloud, whole), "16(b) the scan step's cloud differs from forward_views'")
    valid = whole.valid.cpu().numpy().reshape(-1)
    pts = whole.points.cpu().numpy().reshape(-1, 3)[valid]
    ext = float((pts.max(0) - pts.min(0)).max())
    got = {k: t.cpu().numpy() for k, t in stats.items()}
    check(int(got["n_valid"]) == int(valid.sum()), f"16(b) n_valid {got['n_valid']}")
    check(np.array_equal(got["bb_min"], pts.min(0)) and np.array_equal(got["bb_max"],
                                                                       pts.max(0)),
          f"16(b) bounding box {got['bb_min']} {got['bb_max']}")
    cen = pts.astype(np.float64).mean(0)
    check(np.abs(got["centroid"] - cen).max() <= 1e-6 * ext,
          f"16(b) centroid {got['centroid']} vs numpy's {cen}")
    print(json.dumps({"sharded": "16(b) scan step (2, 2)", "views": v, "wall_s": wall,
                      "peak_gib": peak, "launches": counts, "n_valid": int(valid.sum()),
                      "centroid_err_mm": float(np.abs(got["centroid"] - cen).max()),
                      "card": card}), flush=True)


def _cell_sorted(pts: np.ndarray, origin: np.ndarray, cell: float) -> np.ndarray:
    """Voxel means sorted by their cell (a mean lies in its cell)."""
    ijk = np.floor((pts - origin) / np.float32(cell)).astype(np.int64)
    order = np.lexsort((ijk[:, 2], ijk[:, 1], ijk[:, 0]))
    return pts[order], ijk[order]


def _unmatched(a: np.ndarray, b: np.ndarray, tol: float = 1e-3):
    """Rows of a with no row of b within tol, and the reverse."""
    from scipy.spatial import cKDTree

    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a64[cKDTree(b64).query(a64, workers=-1)[0] > tol],
            b64[cKDTree(a64).query(b64, workers=-1)[0] > tol])


def sharded_merge_phase(dev, root: str, scene, card: str) -> None:
    """16(c). ``merge_360(mesh=)`` over phase 7's 24 cleaned views with the
    mesh of SHARDS repeated cuda:0, beside the unsharded host-list arm (the
    arm a mesh takes) of the same views: the pair transforms bit-equal; the
    final voxel pass slab by slab (``shard_points_by_slab`` + the slot's
    voxelize) equal to the single-device one (the same cells, means within
    1e-4 mm); every row kept by one arm alone (no row of the other within
    1e-3 mm) has an exact mean k-NN distance (cKDTree over the voxelized
    cloud) within 1e-5 x the threshold of the exact threshold; the merged
    cloud's distance to the truth (median, p99) within 1.5x the unsharded
    arm's. Then the JAX test scene of (v) (PP_CASE_POINTS points in an
    80 mm cube and 60 far rows) over 2 and SHARDS slabs against the
    single-device pass: at most 4 rows unmatched."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import (
        MergeConfig,
        load_config,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        pointcloud_sharded as pcs,
    )
    from structured_light_for_3d_model_replication_tpu_torch.parallel import mesh as meshlib
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )
    from scipy.spatial import cKDTree

    cfg = load_config(None, PIPE_OVERRIDES).merge
    clouds = read_clouds(os.path.join(root, "pipeline_cold", "views"))
    mesh = meshlib.make_mesh(devices=[dev] * SHARDS)
    quiet = lambda m: None  # noqa: E731
    tm_u: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_u, _, T_u = recon.merge_360(clouds, cfg, log=quiet, timings=tm_u, device=dev,
                                  step_callback=lambda *a: None)
    torch.cuda.synchronize()
    wall_u = time.perf_counter() - t0
    tm_s: dict = {}
    t0 = _start_window()
    p_s, c_s, T_s = recon.merge_360(clouds, cfg, log=quiet, timings=tm_s, device=dev,
                                    mesh=mesh)
    wall, counts, peak = _end_window(t0)
    check(tm_s["arm"] == "host-list" and tm_u["arm"] == "host-list",
          f"16(c) arms {tm_s['arm']} / {tm_u['arm']}")
    check(tm_s.get("postprocess_arm") == "slab-sharded",
          f"16(c) the sharded merge's final pass: {tm_s.get('postprocess_arm')}")
    check(len(T_s) == len(T_u) and all(np.array_equal(a, b) for a, b in zip(T_s, T_u)),
          "16(c) the sharded merge's transforms differ from the unsharded arm's")
    for k in ("nn1", "ransac_score"):
        check(counts.get(k, 0) > 0, f"16(c) the sharded merge never launched {k}: {counts}")
    check(len(p_s) == len(c_s) and len(p_s) > 0 and bool(np.isfinite(p_s).all()),
          f"16(c) bad sharded merged cloud {p_s.shape}")
    # the final voxel pass, slab by slab against the single device's
    moved = recon.transform_views_batched([p for p, _ in clouds[1:]], T_s[1:], device=dev)
    merged = np.concatenate([np.asarray(clouds[0][0], np.float32)] + moved)
    cell = float(cfg.final_voxel)
    pts_sh, cols_sh, val_sh, origin, _ = pcs.shard_points_by_slab(merged, None, None, SHARDS,
                                                                  cell)
    slabs = []
    for d in range(SHARDS):
        p, _, v = pcs._voxelize(*(torch.from_numpy(a[d]).to(dev)
                                  for a in (pts_sh, cols_sh, val_sh)),
                                cell, torch.from_numpy(origin))
        slabs.append(p[v].cpu().numpy())
    one = torch.from_numpy(merged).to(dev)
    p1, _, v1 = pc.voxel_downsample(one, torch.zeros_like(one, dtype=torch.uint8),
                                    torch.ones(len(one), dtype=torch.bool, device=dev), cell)
    vox = p1[v1].cpu().numpy()
    a, ka = _cell_sorted(np.concatenate(slabs), origin, cell)
    b, kb = _cell_sorted(vox, origin, cell)
    check(a.shape == b.shape and np.array_equal(ka, kb),
          f"16(c) the slabs voxelize to {len(a)} cells, the single device to {len(b)}")
    vox_err = float(np.abs(a - b).max())
    check(vox_err <= 1e-4, f"16(c) voxel means differ by {vox_err} mm")
    # rows kept by one arm alone sit on the threshold
    only_s, only_u = _unmatched(p_s, p_u)
    k = int(cfg.outlier_nb)
    tree = cKDTree(vox.astype(np.float64))
    md = tree.query(vox.astype(np.float64), k=k + 1, workers=-1)[0][:, 1:].mean(1)
    thr = md.mean() + float(cfg.outlier_std) * md.std()
    worst = 0.0
    for rows in (only_s, only_u):
        if len(rows):
            mdr = tree.query(rows, k=k + 1, workers=-1)[0][:, 1:].mean(1)
            worst = max(worst, float(np.abs(mdr - thr).max() / thr))
    check(worst <= 1e-5, f"16(c) {len(only_s)} + {len(only_u)} rows kept by one arm alone, "
                         f"up to {worst} x the threshold from it")
    acc = {}
    for name, pts in (("sharded", p_s), ("unsharded", p_u)):
        surf = syn.surface_distance(pts, scene)
        acc[name] = [float(np.median(surf)), float(np.percentile(surf, 99))]
    for i, what in enumerate(("median", "p99")):
        check(acc["sharded"][i] <= GATE * acc["unsharded"][i],
              f"16(c) sharded merge {acc['sharded'][i]} mm from the truth ({what}), > "
              f"{GATE} x the unsharded arm's {acc['unsharded'][i]}")
    print(json.dumps({"sharded": "16(c) merge_360(mesh=)", "views": len(clouds),
                      "shards": SHARDS, "wall_s": wall, "unsharded_wall_s": wall_u,
                      "postprocess_arm": tm_s.get("postprocess_arm"),
                      "walls_s": {k2: v2 for k2, v2 in tm_s.items()
                                  if isinstance(v2, float)},
                      "unsharded_walls_s": {k2: v2 for k2, v2 in tm_u.items()
                                            if isinstance(v2, float)},
                      "peak_gib": peak, "launches": counts, "merged_points": int(len(p_s)),
                      "unsharded_points": int(len(p_u)), "voxel_cells": int(len(a)),
                      "voxel_mean_err_mm": vox_err,
                      "kept_by_one_arm": [int(len(only_s)), int(len(only_u))],
                      "worst_share_from_threshold": worst, "truth_mm": acc,
                      "card": card}), flush=True)
    # the JAX test scene of (v)
    rng = np.random.default_rng(31)
    case = np.concatenate([rng.uniform(0, 80, (PP_CASE_POINTS, 3)),
                           rng.uniform(200, 260, (60, 3))]).astype(np.float32)
    cols = rng.integers(0, 256, (len(case), 3)).astype(np.uint8)
    ref = recon._postprocess_merged(case, cols, MergeConfig(
        final_voxel=2.0, outlier_nb=20, outlier_std=2.0), {}, device=dev)[0]
    for n_dev in (2, SHARDS):
        t0 = _start_window()
        got = pcs.postprocess_merged_sharded([dev] * n_dev, case, cols, None, 2.0, 20, 2.0)[0]
        wall, counts, peak = _end_window(t0)
        a_only, b_only = _unmatched(got, ref)
        check(len(a_only) + len(b_only) <= 4,
              f"16(c) test scene over {n_dev} slabs: {len(a_only)} + {len(b_only)} rows "
              f"unmatched")
        print(json.dumps({"sharded": f"16(c) postprocess, test scene, {n_dev} slabs",
                          "points": int(len(case)), "kept": int(len(got)),
                          "unmatched": int(len(a_only) + len(b_only)), "wall_s": wall,
                          "peak_gib": peak, "launches": counts, "card": card}), flush=True)


def sharded_poisson_phase(dev, card: str) -> None:
    """16(d). Poisson on the mesh arm's cloud (``mesh_cloud()``, normals as
    ``mesh_cloud`` estimates them): depth SHARD_DEPTH_DENSE on SHARDS slabs
    against the dense solve, both SHARD_CG_DENSE steps (chi within 1e-3,
    density within 1e-4, the same grid frame), then depth SHARD_DEPTH with
    SHARD_CG steps on SHARDS and on 2 slabs: ``chi[::16, ::16, ::16]``
    within 1e-4, iso within 1e-5. Each solve's wall, CG ms a step and peak
    device memory printed."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import MeshConfig
    from structured_light_for_3d_model_replication_tpu_torch.ops import normals as nrmlib
    from structured_light_for_3d_model_replication_tpu_torch.ops import poisson
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        poisson_sharded as ps,
    )

    cloud, _ = mesh_cloud()
    mcfg = MeshConfig()
    pts = torch.from_numpy(cloud).to(dev)
    v = torch.ones(len(cloud), dtype=torch.bool, device=dev)
    nr = nrmlib.orient_normals(pts, nrmlib.estimate_normals(
        pts, v, k=mcfg.normal_max_nn, radius=mcfg.normal_radius or None), v, mode="radial")

    def solve(depth, n, cg):
        tm: dict = {}
        t0 = _start_window()
        res = (poisson.poisson_solve(pts, nr, v, depth=depth, cg_iters=cg) if n == 0
               else ps.poisson_solve_sharded(pts, nr, v, depth=depth, devices=[dev] * n,
                                             cg_iters=cg, timings=tm))
        wall, counts, peak = _end_window(t0)
        line = {"sharded": f"16(d) poisson depth {depth}",
                "slabs": n or "dense", "points": int(len(cloud)), "cg_iters": cg,
                "wall_s": wall, "peak_gib": peak, "launches": counts,
                "iso": float(res.iso), "card": card}
        if tm:
            line.update(timings=tm, cg_ms_per_step=1e3 * tm["cg_s"] / cg)
        print(json.dumps(line), flush=True)
        check(peak < 78.0, f"16(d) depth {depth} on {n} slabs peaked at {peak} GiB")
        return res

    dense = solve(SHARD_DEPTH_DENSE, 0, SHARD_CG_DENSE)
    sh = solve(SHARD_DEPTH_DENSE, SHARDS, SHARD_CG_DENSE)
    d_chi = float((sh.chi - dense.chi).abs().max())
    d_den = float((sh.density - dense.density).abs().max())
    check(d_chi <= 1e-3 and d_den <= 1e-4,
          f"16(d) depth {SHARD_DEPTH_DENSE}: chi {d_chi}, density {d_den} off the dense solve")
    check(torch.equal(sh.origin, dense.origin) and float(sh.cell) == float(dense.cell),
          f"16(d) depth {SHARD_DEPTH_DENSE}: another grid frame")
    del dense, sh
    torch.cuda.empty_cache()
    r4 = solve(SHARD_DEPTH, SHARDS, SHARD_CG)
    sub4, iso4 = r4.chi[::16, ::16, ::16].clone(), float(r4.iso)
    check(bool(torch.isfinite(r4.chi).all()) and float(r4.chi.abs().sum()) > 0,
          f"16(d) depth {SHARD_DEPTH}: chi not finite or all zero")
    del r4
    torch.cuda.empty_cache()
    r2 = solve(SHARD_DEPTH, 2, SHARD_CG)
    d_sub = float((r2.chi[::16, ::16, ::16] - sub4).abs().max())
    d_iso = abs(float(r2.iso) - iso4)
    del r2
    torch.cuda.empty_cache()
    check(d_sub <= 1e-4 and d_iso <= 1e-5,
          f"16(d) depth {SHARD_DEPTH}: {SHARDS} against 2 slabs differ by chi {d_sub}, "
          f"iso {d_iso}")
    print(json.dumps({"sharded": f"16(d) depth {SHARD_DEPTH} split parity",
                      "chi_sub16_max_diff": d_sub, "iso_diff": d_iso,
                      "depth9_chi_max_diff": d_chi, "depth9_density_max_diff": d_den,
                      "card": card}), flush=True)


NCCL_CHILD = """
import json, sys
import torch
from structured_light_for_3d_model_replication_tpu_torch.parallel import mesh as meshlib
from structured_light_for_3d_model_replication_tpu_torch.parallel import multihost
assert multihost.initialize(sys.argv[1], 1, 0, connect_timeout_s=120)
s = multihost.process_summary()
mesh = multihost.global_mesh()
out = meshlib.psum(mesh, [torch.ones((), device="cuda")])
s["psum"] = float(out[0])
s["backend"] = torch.distributed.get_backend()
torch.distributed.destroy_process_group()
print(json.dumps(s), flush=True)
"""


def nccl_phase(card: str) -> None:
    """16(e). A child process joins a one-process NCCL group on cuda:0
    (``multihost.initialize("127.0.0.1:<free>", 1, 0)``): its summary says
    platform gpu, and a psum over ``global_mesh()`` is 1."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + os.pathsep + env.get(
        "PYTHONPATH", "")
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-c", NCCL_CHILD, f"127.0.0.1:{port}"],
                             env=env, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        fail("16(e) the NCCL child did not end within 300 s")
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"16(e) NCCL child exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    check(summary["platform"] == "gpu" and summary["psum"] == 1.0
          and summary["backend"] == "nccl" and summary["process_count"] == 1,
          f"16(e) NCCL child reported {summary}")
    print(json.dumps({"sharded": "16(e) nccl", "wall_s": wall, "summary": summary,
                      "card": card}), flush=True)


def sharded_phase(dev, rig, stacks, root: str, scene, card: str) -> None:
    """Phase 16: the sharded arms on meshes of repeated cuda:0 (one card
    has one distinct device, so the pipeline's own ``views_mesh`` and
    ``merge_mesh`` stay None and phases 1-15 run unsharded)."""
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.parallel import mesh as meshlib

    check(meshlib.views_mesh() is None and meshlib.merge_mesh(None) is None,
          "16: one card, yet a views or merge mesh resolved")
    t0 = time.perf_counter()
    sharded_forward_phase(dev, rig, stacks, card)
    sharded_merge_phase(dev, root, scene, card)
    sharded_poisson_phase(dev, card)
    torch.cuda.empty_cache()
    nccl_phase(card)
    print(f"sharded: phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a card",
              file=sys.stderr)
        return 2
    from structured_light_for_3d_model_replication_tpu_torch.ops import _build

    dev = torch.device("cuda")
    t_start = time.perf_counter()
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
    launches = reconstruct_phase(dev, rig, stacks, card)
    lines += flagship_phase(dev, rig, stacks, card)
    calibration_phase(dev, rig, frames_np, stacks, card)
    executor_phase(dev, rig, frames_np, card)
    bitexact_phase(dev, rig, frames_np, card)
    del frames_np
    with tempfile.TemporaryDirectory(prefix="slscan_merge_") as root:
        t0 = time.perf_counter()
        data, calib, poses = render_merge_views(root)
        ply_dir = reconstruct_merge_views(dev, data, calib, os.path.join(root, "views"))
        print(f"merge views: {MERGE_VIEWS} rendered and reconstructed in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        pose_dir, _ = write_pose_views(root)
        lines += merge_kernel_phase(dev, ply_dir, poses, card)
        merge_launches, merge_runs = merge_phase(dev, ply_dir, poses, pose_dir, root, card)
        launches.update(merge_launches)
        artifacts_phase(dev, ply_dir, root, merge_runs["host"], card)
        posegraph_phase(dev, ply_dir, pose_dir, poses, root, card)
        standalone_phase(dev, ply_dir, pose_dir, poses, card)
        bf16_phase(dev, ply_dir, root, merge_runs["device"], card)
    with tempfile.TemporaryDirectory(prefix="slscan_pipeline_") as root:
        t0 = time.perf_counter()
        raw: list = []
        data, calib, scene = render_pipeline_views(root, raw)
        print(f"pipeline views: {PIPE_VIEWS} rendered in {time.perf_counter() - t0:.1f}s",
              flush=True)
        lines += radius_phase(dev, data, calib, card)
        cold = pipeline_phase(dev, data, calib, scene, root, card)
        launches.update({k: (n, "pipeline (cold, streamed)")
                         for k, n in cold["counts"].items() if n})
        feature_prep_phase(dev, cold, card)
        schedule_phase(dev, data, calib, root, cold, card)
        fused_phase(dev, data, calib, root, cold, card)
        report_phase(os.path.join(root, "pipeline_fused"), card)
        native_write_phase(cold["out"], card)
        surface_phase(dev, root, card)
        legacy_pipeline_phase(dev, data, calib, scene, root, cold, card)
        capture_phase(dev, data, calib, raw, root, cold, card)
        del raw
        subset = subset_reference(dev, data, calib, root, card)
        coordinated_phase(dev, data, calib, root, cold, subset, card)
        serving_phase(dev, data, calib, root, cold, subset, card)
        sharded_phase(dev, rig, stacks, root, scene, card)
    del stacks
    for line in lines:
        line["launches"], line["launches_run"] = launches[line["name"]]
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f}s "
          f"(build included)", flush=True)
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
