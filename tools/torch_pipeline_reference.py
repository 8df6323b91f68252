#!/usr/bin/env python3
"""Reference numbers of the scan-to-print scene, for the port's on-card gates.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/torch_pipeline_reference.py \
        [--out DIR] [--port]
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/torch_pipeline_reference.py \
        --registration VIEWS_DIR

Renders ``chip_smoke.py``'s pipeline scene (``synthetic.pipeline_scene``:
three spheres on a floor plane, 24 turntable views at 768x576, a 512x256
projector, stored as .slbp containers) and runs the JAX package's
``run_pipeline`` over it on the CPU: the default ``Config()`` with the
scene's projector size, manual thresholds, the cleaned views written out and
``mesh.density_cap=false``, so that the CPU takes the depth-10 brick Poisson
solve the card takes. The serial executor runs (``compute_batch=1``,
``io_workers=1``), so the clean step's per-view counts come in view order.
The JAX package's ``merge_360`` over the written views gives the pipeline's
transforms again (``merge_reproduced``: the same merged cloud), and with them
each chain pair's landing error (``chip_smoke.pair_landing``). Then the
true-pose arm: the cleaned views placed by the true poses
(``finalize_chain``), meshed by ``mesh_cloud``.

Prints one JSON line with the per-view counts after each clean step, the
merged cloud's distance to the true surfaces (median, p99), its extent, the
STL's distance to them and to the merged cloud and its edge counts
(``chip_smoke.cloud_accuracy``), the pair landings, the true-pose arm's
numbers and the stage walls; ``chip_smoke.PIPELINE_JAX`` holds these
numbers. ``--port`` runs the port's ``run_pipeline`` and true-pose arm on
the same views on the CPU too (the card's arithmetic in its plain
versions). Takes about an hour and a few GB of memory (two 512^3 base
solves).

``--registration VIEWS_DIR`` takes the cleaned views of a kept run
(``<out>/views``, from either package or the card) and registers its chain
pairs four ways on the CPU: each package on its own preps with its own
draws, the port on the JAX package's preps with the JAX package's draws,
and the JAX package on the port's preps. It prints, a pair a line, each
way's fitness and landing error and the pair's mutual feature
correspondences in both packages, then the merged cloud's distance to the
truth for each way's chain, and for the pairs that do not land, the same
for three more RANSAC seeds (pair ids offset by 1000 a seed). Some minutes.

``--mesh`` instead meshes ``chip_smoke.mesh_cloud()`` (points on the three
spheres' union, a closed surface with a known distance) with the JAX
package's ``mesh_cloud`` at ``chip_smoke.MESH_DEPTH`` (``density_cap=false``)
and prints the STL's distance to the true spheres, to the input
cloud and its edges: ``chip_smoke.MESH_JAX``. ``--mesh --mesh-mode
surface`` meshes the same cloud with ``mesh.mode='surface'`` (ball
pivoting) instead: ``chip_smoke.SURFACE_JAX``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

# schedule and bookkeeping knobs only: the serial executor (view order), no
# stage cache, no stall watchdog (a view's clean can outlast its budget on
# the CPU)
_JAX_ONLY = {"mesh.density_cap": False, "parallel.compute_batch": 1,
             "parallel.io_workers": 1, "pipeline.cache": False,
             "deadlines.enabled": False}


def _quiet(*_a) -> None:
    pass


def _scene():
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    _, scene, poses = syn.pipeline_scene(cam_size=chip_smoke.PIPE_CAM,
                                         proj_size=chip_smoke.PIPE_PROJ,
                                         n_views=chip_smoke.PIPE_VIEWS)
    return scene, poses


def summary(out_dir: str, clouds, transforms, merged, true_pose: dict,
            clean_counts, walls, elapsed_s: float) -> dict:
    scene, poses = _scene()
    acc = chip_smoke.cloud_accuracy(merged, os.path.join(out_dir, "model.stl"), scene)
    return dict(acc, pair_landing_mm=chip_smoke.pair_landing(
        [p for p, _ in clouds], transforms, poses, scene), true_pose=true_pose,
        clean_counts=clean_counts, walls_s=walls, elapsed_s=elapsed_s)


def run_jax(data: str, calib: str, out: str) -> dict:
    from structured_light_for_3d_model_replication_tpu.config import load_config
    from structured_light_for_3d_model_replication_tpu.models import (
        reconstruction as rec,
    )
    from structured_light_for_3d_model_replication_tpu.pipeline import stages
    from structured_light_for_3d_model_replication_tpu_torch.io import ply

    cfg = load_config(None, dict(chip_smoke.PIPE_OVERRIDES, **_JAX_ONLY))
    counts: list[dict] = []
    walls: dict[str, float] = {"clean": 0.0}
    clean_arrays = stages._clean_arrays

    def recording(pts, cols, cfg_, steps=stages._CLEAN_STEPS, **kw):
        t0 = time.perf_counter()
        out_ = clean_arrays(pts, cols, cfg_, steps, **kw)
        walls["clean"] += time.perf_counter() - t0
        counts.append(out_[2])
        return out_

    stages._clean_arrays = recording
    try:
        report = stages.run_pipeline(calib, data, out, cfg=cfg, log=_quiet)
    finally:
        stages._clean_arrays = clean_arrays
    merged = ply.read_ply(os.path.join(out, "merged.ply"))["points"]
    clouds = chip_smoke.read_clouds(os.path.join(out, "views"))
    points, _, transforms = rec.merge_360(clouds, cfg.merge, log=_quiet)

    def finalize(clouds_, T):
        ones = np.ones(len(T), np.float32)
        return rec.finalize_chain(clouds_, T, ones, ones, 0 * ones, cfg.merge,
                                  log=_quiet)[:2]

    def mesh(src, stl):
        stages.mesh_cloud(src, stl, cfg=cfg, log=_quiet)

    return dict(summary(out, clouds, transforms, merged,
                        true_pose_arm(out, clouds, finalize, mesh),
                        counts, walls, report.elapsed_s),
                merge_reproduced=bool(np.array_equal(np.asarray(points), merged)))


def run_port(data: str, calib: str, out: str) -> dict:
    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.io import ply
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as rec,
    )
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    cfg = load_config(None, dict(chip_smoke.PIPE_OVERRIDES, **{"mesh.density_cap": False}))
    report = stages.run_pipeline(calib, data, out, cfg=cfg, device="cpu", log=_quiet)
    merged = ply.read_ply(report.merged_ply)["points"]
    clouds = chip_smoke.read_clouds(os.path.join(out, "views"))

    def finalize(clouds_, T):
        ones = np.ones(len(T), np.float32)
        return rec.finalize_chain(clouds_, T, ones, ones, 0 * ones, cfg.merge,
                                  log=_quiet, device="cpu")[:2]

    def mesh(src, stl):
        stages.mesh_cloud(src, stl, cfg=cfg, log=_quiet, device="cpu")

    return summary(out, clouds, report.transforms, merged,
                   true_pose_arm(out, clouds, finalize, mesh),
                   report.clean_counts, report.walls_s, report.elapsed_s)


def true_pose_arm(out: str, clouds, finalize, mesh) -> dict:
    """``chip_smoke.true_pose_arm`` with one package's finalize and mesh."""
    from structured_light_for_3d_model_replication_tpu_torch.io import ply

    scene, poses = _scene()
    src, stl = os.path.join(out, "true_pose.ply"), os.path.join(out, "true_pose.stl")
    t0 = time.perf_counter()
    points, colors = finalize(clouds, chip_smoke.true_pair_transforms(poses))
    ply.write_ply(src, np.asarray(points), np.asarray(colors))
    mesh(src, stl)
    return dict(chip_smoke.cloud_accuracy(np.asarray(points), stl, scene),
                wall_s=time.perf_counter() - t0)


def registration(view_dir: str) -> None:
    """The ``--registration`` report (module docstring)."""
    import jax
    import jax.numpy as jnp

    from structured_light_for_3d_model_replication_tpu.config import Config as JConfig
    from structured_light_for_3d_model_replication_tpu.models import reconstruction as jrec
    from structured_light_for_3d_model_replication_tpu.ops import registration as jreg
    from structured_light_for_3d_model_replication_tpu_torch.config import Config
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as rec,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import (
        registration as reg,
    )
    from structured_light_for_3d_model_replication_tpu_torch.utils import (
        synthetic as syn,
    )

    scene, poses = _scene()
    clouds = chip_smoke.read_clouds(view_dir)
    views = [p for p, _ in clouds]
    n = len(views)
    jcfg, pcfg = JConfig().merge, Config().merge
    voxel = float(pcfg.voxel_size)
    jp = [jrec.prep_view(v, voxel) for v in views]
    tp = [rec.prep_view(v, voxel, device="cpu") for v in views]
    tpj = [rec.prep_from_reference(p, "cpu") for p in jp]
    jpt = [jrec._Prep(*(jnp.asarray(getattr(p, k).numpy())
                        for k in ("points", "valid", "normals", "features"))) for p in tp]

    def bucket_args(pair, mod):
        b = max(pair[0].points.shape[0], pair[1].points.shape[0])
        return b, mod._prep_to_bucket(pair[0], b), mod._prep_to_bucket(pair[1], b)

    def jax_draws(pair, pid):
        b, (_, sv, _, sf), (_, dv, _, df) = bucket_args(pair, jrec)
        _, ok = jreg._feature_correspondences(sf, df, sv, dv, True)
        p = ok.astype(jnp.float32) / jnp.maximum(ok.sum(), 1)
        key = jax.random.fold_in(jax.random.PRNGKey(0), pid)
        return np.asarray(jax.random.choice(key, b, (jcfg.ransac_trials, 3), p=p))

    def mutual(pair, mod, corr):
        _, (_, sv, _, sf), (_, dv, _, df) = bucket_args(pair, mod)
        cj, ok = corr(sf, df, sv, dv, True)
        cj, ok = np.asarray(cj), np.asarray(ok)
        return set(zip(np.nonzero(ok)[0].tolist(), cj[ok].tolist()))

    def run(kind, pairs, ids, samples=None):
        if kind == "jax":
            return jrec.register_prep_pairs(pairs, ids, jcfg, voxel)
        return rec.register_prep_pairs(pairs, ids, pcfg, voxel, samples=samples)

    def chain(T_pairs):
        out = [np.eye(4)]
        for T in T_pairs:
            out.append(out[-1] @ np.asarray(T, np.float64))
        return out

    def landing(T, i):
        return chip_smoke.pair_landing([views[i - 1], views[i]], [np.eye(4), T],
                                       poses[i - 1:i + 1], scene)[0]

    idx = list(range(1, n))
    ids = [i - 1 for i in idx]
    ways = {
        "jax": run("jax", [(jp[i], jp[i - 1]) for i in idx], ids),
        "port": run("port", [(tp[i], tp[i - 1]) for i in idx], ids),
        "port_on_jax_preps_and_draws": run(
            "port", [(tpj[i], tpj[i - 1]) for i in idx], ids,
            samples={k: jax_draws((jp[i], jp[i - 1]), i - 1) for k, i in enumerate(idx)}),
        "jax_on_port_preps": run("jax", [(jpt[i], jpt[i - 1]) for i in idx], ids),
    }
    for k, i in enumerate(idx):
        mj = mutual((jp[i], jp[i - 1]), jrec, jreg._feature_correspondences)
        mt = mutual((tp[i], tp[i - 1]), rec, reg._feature_correspondences)
        line = {"pair": i, "mutual_jax": len(mj), "mutual_port": len(mt),
                "mutual_common": len(mj & mt)}
        for name, (T, gf, fi, _) in ways.items():
            line[name] = {"gfit": float(gf[k]), "ifit": float(fi[k]),
                          "landing_mm": landing(T[k], i)}
        print(json.dumps(line), flush=True)
    for name, (T, gf, fi, ir) in ways.items():
        merged = (rec.finalize_chain(clouds, T, gf, fi, ir, pcfg, log=_quiet, device="cpu")[0]
                  if name.startswith("port") else
                  np.asarray(jrec.finalize_chain(clouds, T, gf, fi, ir, jcfg, log=_quiet)[0]))
        d = syn.surface_distance(merged, scene)
        print(json.dumps({"merged": name, "points": int(len(merged)),
                          "surf_median_mm": float(np.median(d)),
                          "surf_p99_mm": float(np.percentile(d, 99))}), flush=True)
    bad = [i for k, i in enumerate(idx) if landing(ways["jax"][0][k], i)[0] >= chip_smoke.LANDED_MM]
    for i in bad:
        for seed in range(1, 4):
            pid = i - 1 + 1000 * seed
            line = {"pair": i, "seed": seed}
            for kind, pair in (("jax", (jp[i], jp[i - 1])), ("port", (tp[i], tp[i - 1]))):
                T, gf, _, _ = run(kind, [pair], [pid])
                line[kind] = {"gfit": float(gf[0]), "landing_mm": landing(T[0], i)}
            print(json.dumps(line), flush=True)


def run_mesh_jax(root: str, port: bool, mode: str = "watertight") -> None:
    from structured_light_for_3d_model_replication_tpu.config import load_config
    from structured_light_for_3d_model_replication_tpu.pipeline import stages
    from structured_light_for_3d_model_replication_tpu_torch.io import ply

    cloud, scene = chip_smoke.mesh_cloud()
    src = os.path.join(root, "cloud.ply")
    ply.write_ply(src, cloud)
    over = {"mesh.density_cap": False, "mesh.mode": mode}
    if mode == "watertight":
        over["mesh.depth"] = chip_smoke.MESH_DEPTH
    runs = [("jax_cpu", lambda out: stages.mesh_cloud(
        src, out, cfg=load_config(None, over), log=_quiet))]
    if port:
        from structured_light_for_3d_model_replication_tpu_torch.config import (
            load_config as port_config,
        )
        from structured_light_for_3d_model_replication_tpu_torch.pipeline import (
            stages as port_stages,
        )

        runs.append(("port_cpu", lambda out: port_stages.mesh_cloud(
            src, out, cfg=port_config(None, over),
            log=_quiet, device="cpu")))
    for name, fn in runs:
        out = os.path.join(root, f"{name}.stl")
        t0 = time.perf_counter()
        fn(out)
        print(json.dumps({"mesh": name, "mode": mode, "wall_s": time.perf_counter() - t0,
                          "points": int(len(cloud)),
                          "stl": chip_smoke.stl_accuracy(out, scene, cloud)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="keep the rendered views and outputs here")
    ap.add_argument("--port", action="store_true",
                    help="also run the port's pipeline on the CPU")
    ap.add_argument("--registration", default=None, metavar="VIEWS_DIR",
                    help="only the registration report on a kept run's cleaned views")
    ap.add_argument("--mesh", action="store_true",
                    help="the meshing reference (chip_smoke.MESH_JAX) instead")
    ap.add_argument("--mesh-mode", choices=["watertight", "surface"], default="watertight",
                    help="with --mesh: the mesh mode (surface: chip_smoke.SURFACE_JAX)")
    args = ap.parse_args()
    if args.mesh:
        with tempfile.TemporaryDirectory(prefix="slscan_mref_") as tmp:
            run_mesh_jax(args.out or tmp, args.port, args.mesh_mode)
        return 0
    if args.registration:
        registration(args.registration)
        return 0
    with tempfile.TemporaryDirectory(prefix="slscan_pref_") as tmp:
        root = args.out or tmp
        t0 = time.perf_counter()
        data, calib, _ = chip_smoke.render_pipeline_views(root)
        print(f"render: {time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
        runs = [("jax_cpu", run_jax)] + ([("port_cpu", run_port)] if args.port else [])
        for name, fn in runs:
            t0 = time.perf_counter()
            res = fn(data, calib, os.path.join(root, name))
            print(json.dumps({"pipeline": name, "wall_s": time.perf_counter() - t0,
                              **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
