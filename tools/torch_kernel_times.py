#!/usr/bin/env python3
"""Time the port's ransac_score and scan_fused kernels on the card, and
check them against their plain versions, for one checkout of the port.

    python3 tools/torch_kernel_times.py [--root DIR] [--ptxas]

``--root`` is the directory that holds the port's package (default: this
checkout), so two commits can be compared on one card in one call: unpack
the other commit into a directory that ``.gitignore`` lists and run this
script on it and on this checkout in turns (A, B, B, A). ``--ptxas`` also
compiles that checkout's kernel sources with ``-Xptxas -v`` and prints the
registers, shared memory and spills of the two kernels.

Shapes are the main path's: ransac_score at T = 4096 hypotheses over
N = 2048 correspondences (one registered pair of the flagship merge; the
inputs are made from a seed, as the CPU tests make them), scan_fused at
V = 8 views of 46 frames at 1920x1080, row_mode 1 (chip_smoke.py's phase 2
scene). Each kernel: the median of 20 calls between CUDA events (the
wrapper's host path included), and its device time from torch.profiler's
kernel records (``chip_smoke.device_ms``); scan_fused also on the same
views cut to 1920x1056 rows (a whole number of tile rounds on 132 SMs).
ransac_score's counts must equal the plain version's; scan_fused must meet
chip_smoke.py's tolerances (valid flips < 2e-3, |dp| < 1e-2 mm, texture
equal). Prints the card line, then one JSON line per kernel and case;
exits non-zero if a check fails or there is no card.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "structured_light_for_3d_model_replication_tpu_torch"


def ptxas(build) -> None:
    """Registers, shared memory and spills of the two kernels, per source."""
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
            if name and ("ransac_score" in name or "scan_fused" in name):
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
    ap.add_argument("--ptxas", action="store_true", help="print -Xptxas -v for the two kernels")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    check_pkg = os.path.join(root, PORT, "ops", "kernels.py")
    if not os.path.isfile(check_pkg):
        print(f"no port at {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)  # chip_smoke's helpers, from this checkout
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: CUDA is not available; this needs a card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from structured_light_for_3d_model_replication_tpu_torch.ops import _build
    from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
    from structured_light_for_3d_model_replication_tpu_torch.ops import registration as reg
    from structured_light_for_3d_model_replication_tpu_torch.models.scanner import SLScanner
    from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc

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
    if not ok:
        print("torch_kernel_times: a kernel disagrees with its plain version", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
