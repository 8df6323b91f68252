#!/usr/bin/env python3
"""On-card check of the PyTorch + CUDA port of the scan path.

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
   arm's byte for byte.

Then one ``{"kernels": [...]}`` JSON line (launches from phase 3, times
from phase 2, bounds from this run's shapes) and, last, the
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
PALLAS = "structured_light_for_3d_model_replication_tpu/ops/pallas_kernels.py"


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


def reconstruct_phase(dev, rig, stacks, card: str) -> dict[str, int]:
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile, ply
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    arms = [("table", "decode_maps", {"plane_eval": "table"}, False),
            ("quadratic", "scan_fused", {"plane_eval": "quadratic"}, False),
            ("packed", "decode_packed_maps", {"plane_eval": "table"}, True)]
    launches = {k.__name__: 0 for k in kernels.KERNELS}
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
            for name, n in counts.items():
                launches[name] += n
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
    for line in lines:
        line["launches"] = launches[line["name"]]
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
