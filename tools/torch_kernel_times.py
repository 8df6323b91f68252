#!/usr/bin/env python3
"""Time the port's redesigned kernels on the card, and check them against
their plain versions, for one checkout of the port.

    python3 tools/torch_kernel_times.py [--root DIR] [--ptxas]

``--root`` is the directory that holds the port's package (default: this
checkout), so two commits can be compared on one card in one call: unpack
the other commit into a directory that ``.gitignore`` lists and run this
script on it and on this checkout in turns (A, B, B, A). ``--ptxas`` also
compiles that checkout's kernel sources with ``-Xptxas -v`` and prints the
registers, shared memory and spills of the kernels timed here.

Shapes are the main path's:
- ransac_score at T = 4096 hypotheses over N = 2048 correspondences (one
  registered pair of the flagship merge; the inputs are made from a seed,
  as the CPU tests make them); counts equal to the plain version's;
- scan_fused at V = 8 views of 46 frames at 1920x1080, row_mode 1
  (chip_smoke.py's phase 2 scene), and on the same views cut to 1920x1056
  rows (a whole number of tile rounds on 132 SMs); chip_smoke.py's
  tolerances (valid flips < 2e-3, |dp| < 1e-2 mm, texture equal);
- decode_maps and decode_packed_maps on the same 8 views (the packed planes
  of 22 pairs, 3 plane bytes a pixel, as the packed lane reads them),
  bit-equal to their plain versions;
- slab_mean_knn on the flagship merged cloud (chip_smoke.flagship_cloud:
  L = 188,416 rows, a 16,384-row window, tile 64) at k = 40 and k = 128,
  counts and window ends bit-equal, means within rtol 1e-5 on every row;
- knn_mean on the first 32,768 rows of that sorted cloud (chip_smoke.py's
  phase 4 shape) at k = 40 and k = 128, the same checks.
Each kernel: the median of 20 calls between CUDA events (the wrapper's host
path included; 5 for the slab kernel), and its device time from
torch.profiler's kernel records (``chip_smoke.device_ms``). Prints the card
line, then one JSON line per kernel and case; exits non-zero if a check
fails or there is no card.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "structured_light_for_3d_model_replication_tpu_torch"
TIMED = ("ransac_score", "scan_fused", "decode_maps", "decode_packed", "slab", "knn_")


def ptxas(build) -> None:
    """Registers, shared memory and spills of the timed kernels, per source."""
    out_dir = os.path.join(os.path.dirname(build.library_path()), "ptxas")
    os.makedirs(out_dir, exist_ok=True)
    for src in build.sources():
        obj = os.path.join(out_dir, os.path.basename(src) + ".o")
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", src,
                               "-o", obj], capture_output=True, text=True)
        lines = (proc.stdout + proc.stderr).splitlines()
        keep, name = [], None
        for ln in lines:
            if "Compiling entry function" in ln:
                name = ln
            if name and any(k in name for k in TIMED):
                keep.append(ln.strip())
        print(f"ptxas {os.path.basename(src)} rc={proc.returncode}", flush=True)
        for ln in keep:
            print("  " + ln, flush=True)


def ransac_inputs(t: int, n: int, seed: int = 0):
    """H, P and sc as registration._score_args builds them, from a seed:
    small rotations about the identity and jittered correspondences, a
    tenth of them dead (+inf)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    dst = (src + rng.normal(0, 2.0, (n, 3))).astype(np.float32)
    src_c, dst_cc = src - src.mean(0), dst - dst.mean(0)
    cs9 = (dst_cc[:, :, None] * src_c[:, None, :]).reshape(n, 9).astype(np.float32)
    ang = rng.normal(0, 0.05, (t, 3))
    rot = []
    for a in ang:
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        q = np.linalg.qr(np.eye(3) + k)[0]
        rot.append(q * np.sign(np.linalg.det(q)))
    R = np.stack(rot).astype(np.float32)
    tt = rng.normal(0, 1.0, (t, 3)).astype(np.float32)
    Rt = np.einsum("tij,ti->tj", R, tt).astype(np.float32)
    sc = ((src_c ** 2).sum(-1) + (dst_cc ** 2).sum(-1)).astype(np.float32)
    sc[rng.random(n) < 0.1] = np.inf
    return (R.reshape(t, 9), tt, (tt * tt).sum(-1).astype(np.float32), Rt, src_c, cs9, dst_cc,
            sc)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="directory holding the port's package")
    ap.add_argument("--ptxas", action="store_true", help="print -Xptxas -v for the timed kernels")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    check_pkg = os.path.join(root, PORT, "ops", "kernels.py")
    if not os.path.isfile(check_pkg):
        print(f"no port at {root}", file=sys.stderr)
        return 2
    # chip_smoke's helpers from this checkout (imported first, so another
    # root's chip_smoke.py is not found), the port from root
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: CUDA is not available; this needs a card", file=sys.stderr)
        return 2
    from structured_light_for_3d_model_replication_tpu_torch.ops import _build
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import registration as reg
    from structured_light_for_3d_model_replication_tpu_torch.models.scanner import SLScanner
    from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

    loaded = os.path.dirname(os.path.abspath(kernels.__file__))
    if not loaded.startswith(root):
        print(f"imported the port from {loaded}, not {root}", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    srcs = sorted(os.path.basename(p) for p in glob.glob(os.path.join(loaded, "csrc", "*.cu")))
    print(f"root {root}: {srcs}", flush=True)
    _build.build()
    if args.ptxas:
        ptxas(_build)
    dev = torch.device("cuda")
    ok = True

    # ransac_score at the merge path's shape
    t, n = 4096, 2048
    a = ransac_inputs(t, n)
    hm, pm = reg._ransac_rows(*(torch.from_numpy(x).to(dev) for x in a[:7]))
    sc = torch.from_numpy(a[7]).to(dev)
    md2 = 20.25
    got = kernels.ransac_score(hm, pm, sc, md2)
    want = kernels.ransac_score_plain(hm, pm, sc, md2)
    err = int((got - want).abs().max())
    ok &= err == 0
    line = {"name": "ransac_score", "shape": [t, n], "max_abs_err": err,
            "ms": cs.time_ms(lambda: kernels.ransac_score(hm, pm, sc, md2), reps=20),
            "device_ms": cs.device_ms(lambda: kernels.ransac_score(hm, pm, sc, md2), 20,
                                      "ransac_score"),
            "best_count": int(got.max()), "card": card, "clocks": cs.clocks()}
    print(json.dumps(line), flush=True)

    # scan_fused at phase 2's geometry
    rig, frames_np, _ = cs.render_views()
    v, f, h, w = frames_np.shape
    frames = torch.from_numpy(frames_np).to(dev)
    thr = torch.tensor([[40.0 + i, 10.0 + (i % 3)] for i in range(v)], dtype=torch.float32,
                       device=dev)
    plan = gc.decode_plan(f, n_cols=cs.PROJ[0], n_rows=cs.PROJ[1], n_sets_col=11,
                          n_sets_row=11, downsample=1)
    scn = SLScanner(rig.calibration(), cs.CAM, cs.PROJ, row_mode=1, plane_eval="quadratic",
                    device=dev)
    scalars = kernels.scan_scalars(scn.oc, scn.poly_col, scn.poly_row, scn.epipolar_tol)
    fkw = dict(plan._asdict(), n_cols=cs.PROJ[0], n_rows=cs.PROJ[1], row_mode=1)
    k3 = kernels.scan_fused(frames, thr, scalars, scn.rays, **fkw)
    p3 = kernels.scan_fused_plain(frames, thr, scalars, scn.rays, **fkw)
    flip = float((k3[1] != p3[1]).float().mean())
    both = k3[1] & p3[1]
    dp = float((k3[0] - p3[0]).abs()[both].max())
    tex_eq = bool(torch.equal(k3[2], p3[2]))
    ok &= flip < 2e-3 and dp < 1e-2 and tex_eq
    del p3
    line = {"name": "scan_fused", "shape": [v, f, h, w], "valid_flip_share": flip,
            "max_abs_err": dp, "texture_equal": tex_eq,
            "ms": cs.time_ms(lambda: kernels.scan_fused(frames, thr, scalars, scn.rays, **fkw),
                             reps=20),
            "device_ms": cs.device_ms(
                lambda: kernels.scan_fused(frames, thr, scalars, scn.rays, **fkw), 20,
                "scan_fused"),
            "card": card, "clocks": cs.clocks()}
    print(json.dumps(line), flush=True)

    # the same views cut to 1920 x 1056: 1980 tiles of 1024 pixels, 15 for
    # each of 132 blocks, where 1080 rows give 2025 (16 for 45 blocks, 15
    # for the rest). Bytes fall by 1056 / 1080; a time that falls by about
    # 15 / 16 is held back by the last round of tiles
    rows = 1056
    fc = frames[:, :, :rows].contiguous()
    rc = scn.rays.view(h, w, 3)[:rows].reshape(-1, 3).contiguous()
    line = {"name": "scan_fused", "case": f"{w}x{rows}", "shape": [v, f, rows, w],
            "ms": cs.time_ms(lambda: kernels.scan_fused(fc, thr, scalars, rc, **fkw), reps=20),
            "device_ms": cs.device_ms(lambda: kernels.scan_fused(fc, thr, scalars, rc, **fkw),
                                      20, "scan_fused"),
            "card": card, "clocks": cs.clocks()}
    print(json.dumps(line), flush=True)
    del fc, rc

    # decode_maps and decode_packed_maps on the same views
    kw = plan._asdict()
    stacks = [imio.pack_stack(frames_np[i]) for i in range(v)]
    planes = torch.from_numpy(np.stack([s.planes for s in stacks])).to(dev)
    white = torch.from_numpy(np.stack([s.white for s in stacks])).to(dev)
    black = torch.from_numpy(np.stack([s.black for s in stacks])).to(dev)
    pkw = dict(kw, n_pairs=stacks[0].n_pairs)
    for name, kernel, fn, plain, x in (
            ("decode_maps", "decode_maps", lambda: kernels.decode_maps(frames, thr, **kw),
             lambda: kernels.decode_maps_plain(frames, thr, **kw), frames),
            ("decode_packed_maps", "decode_packed",
             lambda: kernels.decode_packed_maps(planes, white, black, thr, **pkw),
             lambda: kernels.decode_packed_maps_plain(planes, white, black, thr, **pkw),
             planes)):
        got, want = fn(), plain()
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
        ok &= same
        # bytes: each input once (white and black beside the packed planes),
        # col, row (4 bytes each) and mask (1) out
        nbytes = x.numel() + (2 * v * h * w if x is planes else 0) + thr.numel() * 4
        line = {"name": name, "shape": list(x.shape), "bit_equal": same,
                "bound_ms": (nbytes + v * h * w * 9) / cs.MEM_BYTES_PER_S * 1e3,
                "ms": cs.time_ms(fn, reps=20), "device_ms": cs.device_ms(fn, 20, kernel),
                "card": card, "clocks": cs.clocks()}
        print(json.dumps(line), flush=True)
    del frames, planes, white, black, got, want

    # slab_mean_knn on the flagship merged cloud, above one list entry a lane
    with tempfile.TemporaryDirectory(prefix="slscan_times_") as tmp:
        data, calib, poses = cs.render_merge_views(tmp)
        views = cs._read_views(cs.reconstruct_merge_views(dev, data, calib,
                                                          os.path.join(tmp, "views")))
    _, _, pts_s, r = cs.flagship_cloud(dev, views, syn.turntable_transforms(poses))
    for k in (40, 128):
        got = kernels.slab_mean_knn(pts_s, r, k, tile=64, wblk=8192)
        want = kernels.slab_mean_knn_plain(pts_s, r, k, 64, 8192)
        cnt_eq = bool(torch.equal(got[1], want[1])) and bool(torch.equal(got[2], want[2]))
        rel = float(((got[0] - want[0]).abs() / want[0].abs().clamp_min(1e-9)).max())
        ok &= cnt_eq and rel <= 1e-5
        fn = lambda k=k: kernels.slab_mean_knn(pts_s, r, k, tile=64, wblk=8192)  # noqa: E731
        line = {"name": "slab_mean_knn", "k": k, "shape": list(pts_s.shape), "r": r,
                "counts_equal": cnt_eq, "mean_rtol": rel,
                "ms": cs.time_ms(fn, reps=5), "device_ms": cs.device_ms(fn, 5, "slab_"),
                "card": card, "clocks": cs.clocks()}
        print(json.dumps(line), flush=True)
    # knn_mean on chip_smoke.py's 32,768 x-sorted rows of the same cloud
    q32 = pts_s[:32768].contiguous()
    for k in (40, 128):
        got, want = kernels.knn_mean(q32, k), kernels.knn_mean_plain(q32, k)
        cnt_eq = bool(torch.equal(got[1], want[1]))
        rel = float(((got[0] - want[0]).abs() / want[0].abs().clamp_min(1e-9)).max())
        ok &= cnt_eq and rel <= 1e-5
        fn = lambda k=k: kernels.knn_mean(q32, k)  # noqa: E731
        line = {"name": "knn_mean", "k": k, "shape": list(q32.shape), "counts_equal": cnt_eq,
                "mean_rtol": rel, "ms": cs.time_ms(fn, reps=5),
                "device_ms": cs.device_ms(fn, 5, "knn_"), "card": card, "clocks": cs.clocks()}
        print(json.dumps(line), flush=True)
    if not ok:
        print("torch_kernel_times: a kernel disagrees with its plain version", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
