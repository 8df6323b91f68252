"""The port's merge path against the JAX package, on the CPU.

The scene is tests/test_registration.py:148's: four turntable views (0, 30,
60, 90 degrees) of a lumpy object, each seeing the front 65 %, with 0.05 mm
noise, made with numpy from a seed. Tolerances:

- prep_view: same bucket and valid prefix, voxel means within 1e-4 mm,
  normals |n . n_ref| >= 1 - 1e-4 and features within 1e-4 on >= 99 % of
  rows (near-tied neighbours may swap: the two packages select on different
  f32 forms of the same distance);
- register_prep_pairs on the JAX package's own preps with its own
  jax.random.choice draws injected: transforms within 1e-4, global fitness
  equal, ICP fitness within 1e-3;
- merge_360 end to end with the port's own draws: each pair's relative
  rotation within 0.5 degrees and translation within 1 mm of the JAX
  package's, and the chamfer distance between the two merged clouds below
  1 mm (the RANSAC draws differ, so the poses agree to registration noise,
  not to rounding);
- transform_views_batched against the numpy twin _transform_view_np:
  within 1e-4 mm (one f32 rounding of a ~100 mm coordinate is ~1e-5 mm; the
  port fixes its own summation order, numpy's matmul may fuse);
- the outlier pass on a cloud above 32768 rows against the JAX package's
  statistical_outlier_mask_np: a CPU tensor takes that twin (equal bit for
  bit); the card's arm (the slab engine + cKDTree complement, run on the
  CPU) differs on at most 2 rows (f32 vs f64 ties at the threshold, the
  JAX package's own bound, tests/test_pointcloud_ops.py:342), with the
  voxel cell given and with it estimated from the spacing;
- the spacing estimate against the JAX package's _estimate_spacing: rtol
  1e-5 (it selects on the expanded distance and recomputes, the port on
  exact differences).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import config as jconfig
from structured_light_for_3d_model_replication_tpu.models import reconstruction as jrec
from structured_light_for_3d_model_replication_tpu.ops import pointcloud as jpc
from structured_light_for_3d_model_replication_tpu.ops import registration as jreg
from structured_light_for_3d_model_replication_tpu.utils import synthetic as jsyn
from structured_light_for_3d_model_replication_tpu_torch import cli, config
from structured_light_for_3d_model_replication_tpu_torch.io import ply
from structured_light_for_3d_model_replication_tpu_torch.models import reconstruction as rec
from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

QUIET = dict(log=lambda *a: None)
ANGLES = (0, 30, 60, 90)
MERGE_KW = dict(voxel_size=2.0, ransac_trials=2048, icp_iters=25, final_voxel=1.0,
                outlier_nb=20)


def _rand_cloud(rng, n):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 50 * (1 + 0.25 * np.sin(4 * d[:, 0]) * np.cos(3 * d[:, 1]))
    return (d * r[:, None]).astype(np.float32)


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(0)
    base = _rand_cloud(rng, 6000)
    out = []
    for ang in ANGLES:
        world = base @ np.asarray(jsyn.rotate_y(ang), np.float32).T
        vis = world[:, 2] < np.percentile(world[:, 2], 65)
        cl = world[vis] + rng.normal(0, 0.05, (int(vis.sum()), 3)).astype(np.float32)
        out.append((cl.astype(np.float32), np.full((int(vis.sum()), 3), 128, np.uint8)))
    return out


@pytest.fixture(scope="module")
def jax_merge(clouds):
    return jrec.merge_360(clouds, jconfig.MergeConfig(**MERGE_KW), **QUIET)


def _rel_errors(Ta, Tb):
    """Per chain pair (i-1 <- i): rotation (degrees) and translation (mm)
    difference of the relative transforms."""
    out = []
    for i in range(1, len(Ta)):
        ra = np.linalg.inv(Ta[i - 1]) @ Ta[i]
        rb = np.linalg.inv(Tb[i - 1]) @ Tb[i]
        c = (np.trace(ra[:3, :3].T @ rb[:3, :3]) - 1) / 2
        out.append((np.degrees(np.arccos(np.clip(c, -1, 1))),
                    np.linalg.norm(ra[:3, 3] - rb[:3, 3])))
    return np.asarray(out)


def test_prep_view_matches_jax(clouds):
    pts = clouds[1][0]
    jp = jrec.prep_view(pts, 2.0)
    tp = rec.prep_view(pts, 2.0, device="cpu")
    assert tp.points.shape == jp.points.shape and tp.points.shape[0] % 2048 == 0
    v = np.asarray(jp.valid)
    np.testing.assert_array_equal(tp.valid.numpy(), v)
    np.testing.assert_allclose(tp.points.numpy()[v], np.asarray(jp.points)[v], atol=1e-4)
    dots = np.abs((tp.normals.numpy() * np.asarray(jp.normals)).sum(-1))[v]
    assert (dots >= 1 - 1e-4).mean() >= 0.99
    close = np.abs(tp.features.numpy() - np.asarray(jp.features)).max(axis=1)[v] <= 1e-4
    assert close.mean() >= 0.99


def test_register_prep_pairs_with_the_reference_draws(clouds):
    cfg = jconfig.MergeConfig(**MERGE_KW)
    jpreps = [jrec.prep_view(p, 2.0) for p, _ in clouds]
    pairs = [(jpreps[i], jpreps[i - 1]) for i in range(1, len(jpreps))]
    T_j, gf_j, fi_j, _ = jrec.register_prep_pairs(pairs, [0, 1, 2], cfg, 2.0)
    samples = {}
    for i, (s, d) in enumerate(pairs):
        bucket = max(s.points.shape[0], d.points.shape[0])
        _, sv, _, sf = jrec._prep_to_bucket(s, bucket)
        _, dv, _, df = jrec._prep_to_bucket(d, bucket)
        _, ok = jreg._feature_correspondences(sf, df, sv, dv, True)
        probs = ok.astype(jnp.float32) / jnp.maximum(ok.sum(), 1)
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        samples[i] = np.asarray(jax.random.choice(key, bucket, (cfg.ransac_trials, 3), p=probs))
    port_pairs = [(rec.prep_from_reference(s, "cpu"), rec.prep_from_reference(d, "cpu"))
                  for s, d in pairs]
    T, gf, fi, _ = rec.register_prep_pairs(port_pairs, [0, 1, 2],
                                           config.MergeConfig(**MERGE_KW), 2.0,
                                           samples=samples)
    np.testing.assert_allclose(T, np.asarray(T_j), atol=1e-4)
    np.testing.assert_array_equal(gf, np.asarray(gf_j))
    np.testing.assert_allclose(fi, np.asarray(fi_j), atol=1e-3)
    assert (fi > 0.8).all()


def test_merge_360_matches_jax(clouds, jax_merge):
    jp, _, jT = jax_merge
    tm = {}
    kernels.reset_launch_counts()
    p, c, T = rec.merge_360(clouds, config.MergeConfig(**MERGE_KW), timings=tm,
                            device="cpu", **QUIET)
    assert not any(kernels.launch_counts().values())  # CPU tensors: plain versions
    assert len(T) == len(clouds) and len(p) == len(c) > 1000
    assert set(tm) >= {"preprocess_s", "register_s", "accumulate_s", "postprocess_s"}
    err = _rel_errors(np.asarray(T), np.asarray(jT))
    assert (err[:, 0] <= 0.5).all() and (err[:, 1] <= 1.0).all(), err
    assert rec.chamfer_distance(p, jp, device="cpu") < 1.0
    # and both sit on view 0's surface (the JAX package's own check)
    assert rec.chamfer_distance(p[:20000], clouds[0][0], device="cpu") < 4.0


def test_merge_360_cli_on_cpu(clouds, jax_merge, tmp_path):
    """merge-360 through the CLI: views found by their deg tag, a torn view
    dropped, transforms saved, a JAX-package config JSON read."""
    views = tmp_path / "views"
    views.mkdir()
    for (p, c), ang in zip(clouds, ANGLES):
        ply.write_ply(str(views / f"scan_{ang:03d}deg.ply"), p, c)
    (views / "scan_120deg.ply").write_bytes(b"ply\nformat binary_little_endian 1.0\n")
    jcfg = jconfig.Config()
    for k, v in MERGE_KW.items():
        setattr(jcfg.merge, k, v)
    jcfg.save(str(tmp_path / "cfg.json"))
    out, tjson = tmp_path / "merged.ply", tmp_path / "T.json"
    assert cli.main(["merge-360", str(views), str(out), "--device", "cpu",
                     "--config", str(tmp_path / "cfg.json"),
                     "--save-transforms", str(tjson)]) == 0
    T = np.asarray(json.loads(tjson.read_text()))
    assert T.shape == (4, 4, 4)
    err = _rel_errors(T, np.asarray(jax_merge[2]))
    assert (err[:, 0] <= 0.5).all() and (err[:, 1] <= 1.0).all(), err
    merged = ply.read_ply(str(out))
    assert rec.chamfer_distance(merged["points"], jax_merge[0], device="cpu") < 1.0


def test_merge_views_floor_device_and_method(clouds, tmp_path, monkeypatch):
    for i, ((p, c), ang) in enumerate(zip(clouds[:3], ANGLES)):
        path = tmp_path / f"v_{ang}deg.ply"
        if i == 0:
            ply.write_ply(str(path), p, c)
        else:
            path.write_bytes(b"ply\nbroken")
    with pytest.raises(ValueError, match="min_views"):
        stages.merge_views(str(tmp_path), str(tmp_path / "m.ply"), device="cpu", **QUIET)
    # merge.method='posegraph' runs merge_360_posegraph, and
    # parallel.force_bf16_features forces the bf16 feature product
    good = tmp_path / "good"
    good.mkdir()
    for (p, c), ang in zip(clouds[:3], ANGLES):
        ply.write_ply(str(good / f"v_{ang}deg.ply"), p, c)
    cfg = config.Config()
    cfg.merge.method = "posegraph"
    cfg.parallel.force_bf16_features = True
    seen = []
    monkeypatch.setattr(rec, "merge_360_posegraph", lambda clouds_, mcfg, **kw: (
        seen.append((len(clouds_), mcfg.method, kw["feat_bf16"])), clouds_[0][0],
        clouds_[0][1], [np.eye(4)] * len(clouds_))[1:])
    stages.merge_views(str(good), str(tmp_path / "pg.ply"), cfg=cfg, device="cpu", **QUIET)
    assert seen == [(3, "posegraph", True)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stages.merge_views(str(tmp_path), str(tmp_path / "m.ply"), **QUIET)


def test_merge_config_json_shared_with_jax(tmp_path):
    jcfg = jconfig.Config()
    jcfg.merge.ransac_trials, jcfg.merge.final_voxel = 1024, 0.7
    jcfg.pipeline.min_views = 3
    jcfg.save(str(tmp_path / "jax.json"))
    cfg = config.load_config(str(tmp_path / "jax.json"))
    assert cfg.merge.__dict__ == jcfg.merge.__dict__ and cfg.pipeline.min_views == 3
    assert config.MergeConfig().__dict__ == jconfig.MergeConfig().__dict__
    with pytest.raises(ValueError, match="Unknown key"):
        config._from_dict(config.MergeConfig, {"voxel": 2.0})


def test_transform_views_batched_matches_numpy_twin():
    rng = np.random.default_rng(5)
    views = [rng.normal(0, 60, (n, 3)).astype(np.float32) for n in (10, 3000, 2049)]
    Ts = []
    for _ in views:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        T[:3, 3] = rng.normal(0, 20, 3)
        Ts.append(T)
    got = rec.transform_views_batched(views, Ts, device="cpu")
    for g, p, T in zip(got, views, Ts):
        assert g.dtype == np.float32 and g.shape == p.shape
        np.testing.assert_allclose(g, jrec._transform_view_np(T, p), rtol=0, atol=1e-4)


def _large_voxelized_cloud():
    """~38k voxel means of a 40 mm cube (above the dense limit) and 40 far
    outliers; returns (cloud, number of inliers)."""
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 40, (60_000, 3)).astype(np.float32)
    p, _, v = pc.voxel_downsample(torch.from_numpy(base),
                                  torch.zeros((len(base), 3), dtype=torch.uint8),
                                  torch.ones(len(base), dtype=torch.bool), 1.0)
    pts = p[v].numpy()
    cloud = np.concatenate([pts, rng.uniform(100, 200, (40, 3)).astype(np.float32)])
    assert len(cloud) > pc.DENSE_MAX
    return cloud, len(pts)


def test_outlier_mask_above_the_dense_limit_matches_jax():
    """A CPU tensor takes the cKDTree twin (the JAX package's host arm): equal
    bit for bit. The card's arm (the slab engine and its complement, run
    here on the CPU) with the cell given: at most 2 rows differ."""
    cloud, n_in = _large_voxelized_cloud()
    valid = np.ones(len(cloud), bool)
    m = pc.statistical_outlier_mask(torch.from_numpy(cloud), torch.from_numpy(valid),
                                    20, 2.0, voxelized_cell=1.0).numpy()
    ref = jpc.statistical_outlier_mask_np(cloud, valid, 20, 2.0)
    np.testing.assert_array_equal(m, ref)
    card = pc._engine_mask(torch.from_numpy(cloud), torch.from_numpy(valid), 20, 2.0,
                           1.0).numpy()
    assert not card[n_in:].any()
    assert (card != ref).sum() <= 2


def test_outlier_mask_without_a_cell_estimates_the_spacing(monkeypatch):
    """No cell hint above the dense limit on the card's arm (run here on the
    CPU): the spacing estimate sets the slab engine's cell (the JAX
    package's accelerator arm) and the slab engine, not the cKDTree alone,
    computes the mask; at most 2 rows differ from the JAX package's, as
    with the hint."""
    cloud, n_in = _large_voxelized_cloud()
    valid = np.ones(len(cloud), bool)
    slab_rows = []
    real = kernels.slab_mean_knn

    def spy(pts, *a, **kw):
        slab_rows.append(pts.shape[0])
        return real(pts, *a, **kw)

    monkeypatch.setattr(kernels, "slab_mean_knn", spy)
    m = pc._engine_mask(torch.from_numpy(cloud), torch.from_numpy(valid), 20, 2.0,
                        None).numpy()
    ref = jpc.statistical_outlier_mask_np(cloud, valid, 20, 2.0)
    assert slab_rows and slab_rows[0] >= len(cloud)
    assert not m[n_in:].any()
    assert (m != ref).sum() <= 2


def test_estimate_spacing_matches_jax():
    """The median nearest-neighbour spacing of the subsample, self excluded
    by index: within rtol 1e-5 of the JAX package's (it selects on the
    expanded form and recomputes; near ties may pick another row at the
    same distance up to f32 rounding)."""
    cloud, _ = _large_voxelized_cloud()
    valid = np.ones(len(cloud), bool)
    valid[::7] = False
    got = pc._estimate_spacing(torch.from_numpy(cloud), torch.from_numpy(valid))
    ref = jpc._estimate_spacing(jnp.asarray(cloud), jnp.asarray(valid))
    assert 0.3 < got < 1.5
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert pc._estimate_spacing(torch.from_numpy(cloud), torch.zeros(len(cloud),
                                                                     dtype=torch.bool)) == 1.0


def test_chamfer_identical_is_zero():
    a = _rand_cloud(np.random.default_rng(1), 2000)
    assert rec.chamfer_distance(a, a, device="cpu") == 0.0
