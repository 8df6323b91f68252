"""The port's sharded arms on meshes of repeated CPU devices, against its
unsharded arms and against the JAX package's sharded arms on the
conftest's 8 virtual host devices.

Bars:
  (i)    the view-sharded forward (``forward_views`` / ``forward_views_packed``
         with ``mesh=``) and the executor's sharded bucket: byte-equal to the
         unsharded port; against JAX's ``forward_views_batched(mesh=)``,
         valid equal and points within 1e-3 mm plus 1e-6 of their size (the
         background lies metres away, where one f32 step is 2e-3 mm: the
         tolerance of tests/test_torch_executor.py);
  (ii)   ``build_sharded_scan_step`` at (4, 2), (2, 4), (1, 8) against JAX's,
         the bars of tests/test_parallel_scan.py:55-70 (the points on the
         valid pixels, with (i)'s 1e-6 of their size), and the unsharded
         port's cloud byte for byte;
  (iii)  ``register_pairs_sharded``: bit-equal to ``register_pairs`` at the
         same lane count; the port's and JAX's sharded transforms land the
         source within 0.5 mm (median) at fitness > 0.9;
  (iv)   ``merge_360(mesh=)``: the unsharded port's transforms bit for bit,
         chamfer < 2 x voxel against the unsharded port and JAX's
         ``merge_360(mesh=)``;
  (v)    ``postprocess_merged_sharded`` over 2 and 8 slabs: at most 4 kept
         rows of difference against JAX's and the port's unsharded pass, a
         row matching when the other set has one within 1e-3 mm (the JAX
         package's voxel means sum in f32, the port's in f64: a mean one
         f32 step away would split under rounding to 1e-4, as three do
         here); the refusals raise ``SlabRefused``; only that type falls
         back in ``_postprocess_dispatch``;
  (vi)   ``poisson_solve_sharded``: depth 5 on 8 slabs against JAX's and the
         port's dense solve (chi 1e-3, density 1e-4, origin 1e-5, cell
         equal); 2 against 8 slabs at depth 6 (chi 1e-4, iso 1e-5);
  (vii)  ``transform_views_batched(mesh=)``: the unsharded bytes, and the
         numpy twin within 1e-4 mm.
Every product runs in full f32 (``registration.exact_f32_products``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.config import MergeConfig as JMergeConfig
from structured_light_for_3d_model_replication_tpu.models import reconstruction as jrec
from structured_light_for_3d_model_replication_tpu.models.scanner import (
    SLScanner as JaxScanner,
)
from structured_light_for_3d_model_replication_tpu.ops import normals as jnrm
from structured_light_for_3d_model_replication_tpu.ops import pointcloud_sharded as jpcs
from structured_light_for_3d_model_replication_tpu.ops import poisson_sharded as jps
from structured_light_for_3d_model_replication_tpu.ops import registration as jreg
from structured_light_for_3d_model_replication_tpu.parallel import mesh as jmesh
from structured_light_for_3d_model_replication_tpu.parallel.scan import (
    build_sharded_scan_step as jbuild,
)
from structured_light_for_3d_model_replication_tpu_torch import config
from structured_light_for_3d_model_replication_tpu_torch.config import MergeConfig
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import matfile
from structured_light_for_3d_model_replication_tpu_torch.models import reconstruction as rec
from structured_light_for_3d_model_replication_tpu_torch.models import scanner as sm
from structured_light_for_3d_model_replication_tpu_torch.ops import normals as nrmlib
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud_sharded as pcs
from structured_light_for_3d_model_replication_tpu_torch.ops import poisson
from structured_light_for_3d_model_replication_tpu_torch.ops import poisson_sharded as ps
from structured_light_for_3d_model_replication_tpu_torch.ops import registration as reg
from structured_light_for_3d_model_replication_tpu_torch.parallel import mesh as meshlib
from structured_light_for_3d_model_replication_tpu_torch.parallel.scan import (
    build_sharded_scan_step,
)
from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

CPU = torch.device("cpu")
CAM, PROJ = (64, 48), (64, 32)
MANUAL = dict(thresh_mode="manual", shadow_val=40.0, contrast_val=10.0)


def _cpus(n):
    return meshlib.make_mesh(devices=[CPU] * n)


def _quiet(*_a, **_k):
    pass


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (i), (ii): the view-sharded forward and the scan step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def views():
    rig = syn.default_rig(cam_size=CAM, proj_size=PROJ)
    scene = syn.sphere_on_background(depth=420, radius=70)
    frames = []
    for ang in range(0, 360, 45):    # 8 views: the JAX mesh's device count
        f, _ = syn.render_scene(rig, scene.transformed(syn.rotate_y(ang), np.zeros(3)))
        frames.append(f)
    return rig, np.stack(frames)


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("plane_eval", ["table", "quadratic"])
def test_view_sharded_forward_bit_equal_and_matches_jax(views, plane_eval):
    rig, frames_v = views
    calib = rig.calibration()
    port = sm.SLScanner(calib, CAM, PROJ, plane_eval=plane_eval, device="cpu")
    whole = port.forward_views(frames_v, **MANUAL)
    sharded = port.forward_views(frames_v, mesh=_cpus(4), **MANUAL)
    _assert_same(sharded, whole)
    assert int(sharded.valid.sum()) > 2000
    stacks = [imio.pack_stack(f) for f in frames_v]
    planes, white, black = (np.stack([getattr(s, k) for s in stacks])
                            for k in ("planes", "white", "black"))
    kw = dict(n_frames=frames_v.shape[1], **MANUAL)
    _assert_same(port.forward_views_packed(planes, white, black, mesh=_cpus(8), **kw),
                 port.forward_views_packed(planes, white, black, **kw))
    with pytest.raises(ValueError, match="not a multiple"):
        port.forward_views(frames_v[:6], mesh=_cpus(4), **MANUAL)
    if plane_eval == "table":
        ref = JaxScanner(calib, CAM, PROJ).forward_views_batched(
            jnp.asarray(frames_v), mesh=jmesh.make_mesh(), **MANUAL)
        v_ref = np.asarray(ref.valid)
        np.testing.assert_array_equal(sharded.valid.numpy(), v_ref)
        np.testing.assert_allclose(sharded.points.numpy()[v_ref],
                                   np.asarray(ref.points)[v_ref], rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 8)])
def test_sharded_scan_step_matches_jax(views, shape):
    rig, frames_v = views
    frames_v = frames_v[:4]
    v = frames_v.shape[0]
    cw, ch = CAM
    calib = rig.calibration()
    port = sm.SLScanner(calib, CAM, PROJ, row_mode=1, device="cpu")
    step = build_sharded_scan_step(
        meshlib.make_mesh(*shape, devices=[CPU] * 8), proj_size=PROJ, row_mode=1)
    shadow, contrast = np.full(v, 40.0, np.float32), np.full(v, 10.0, np.float32)
    cloud, stats = step(frames_v, port.rays.reshape(ch, cw, 3), port.oc, port.plane_col,
                        port.plane_row, shadow, contrast)
    jscan = JaxScanner(calib, CAM, PROJ, row_mode=1)
    jstep = jbuild(jmesh.make_mesh(n_data=shape[0], n_model=shape[1]), proj_size=PROJ,
                   row_mode=1)
    jcloud, jstats = jstep(jnp.asarray(frames_v), jnp.asarray(
        np.asarray(jscan.rays).reshape(ch, cw, 3)), jscan.oc, jscan.plane_col,
        jscan.plane_row, jnp.asarray(shadow), jnp.asarray(contrast))
    valid = np.asarray(jcloud.valid)
    np.testing.assert_array_equal(cloud.valid.numpy(), valid)
    np.testing.assert_allclose(cloud.points.numpy()[valid], np.asarray(jcloud.points)[valid],
                               rtol=1e-6, atol=1e-3)
    # the unsharded port's cloud, pixel slot for pixel slot
    whole = port.forward_views(frames_v, **MANUAL)
    _assert_same(cloud, whole)
    assert int(stats["n_valid"]) == int(jstats["n_valid"]) == int(valid.sum())
    pts = cloud.points.numpy().reshape(-1, 3)[valid.reshape(-1)]
    np.testing.assert_allclose(stats["centroid"].numpy(), pts.mean(0), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(stats["centroid"].numpy(), np.asarray(jstats["centroid"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(stats["bb_min"].numpy(), pts.min(0), atol=1e-3)
    np.testing.assert_allclose(stats["bb_max"].numpy(), pts.max(0), atol=1e-3)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_ds")
    rig, scene, poses = syn.pipeline_scene(cam_size=(160, 120), proj_size=(128, 64),
                                           n_views=5, step_deg=15.0)
    for i, (R, t) in enumerate(poses):
        frames, _ = syn.render_scene(rig, scene.transformed(R, t))
        imio.save_packed_stack(str(root / f"view_{i * 15:03d}deg"), imio.pack_stack(frames))
    matfile.save_calibration(str(root / "calib.npz"), rig.calibration())
    return root


@pytest.mark.parametrize("packed", [False, True])
def test_executor_sharded_bucket_writes_the_same_bytes(dataset, tmp_path, monkeypatch,
                                                       packed):
    over = {"decode.n_cols": "128", "decode.n_rows": "64", "decode.thresh_mode": "manual",
            "parallel.compute_batch": 3, "parallel.prefetch_depth": 1,
            "pipeline.packed_ingest": packed}

    def run(out):
        return stages.reconstruct(str(dataset / "calib.npz"), str(dataset), mode="batch",
                                  output=str(out), cfg=config.load_config(None, over),
                                  device="cpu", log=_quiet)

    plain = run(tmp_path / "plain")
    seen = []
    monkeypatch.setattr(stages.meshlib, "views_mesh",
                        lambda pcfg: seen.append(pcfg.shard_views) or _cpus(4))
    sharded = run(tmp_path / "sharded")
    assert seen == [True]
    assert len(plain.outputs) == len(sharded.outputs) == 5
    for a, b in zip(plain.outputs, sharded.outputs):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


# ---------------------------------------------------------------------------
# (iii), (iv), (vii): the sharded pairs, merge and accumulate
# ---------------------------------------------------------------------------

def _lumpy(rng, n):
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = 50 * (1 + 0.25 * np.sin(4 * dirs[:, 0]) * np.cos(3 * dirs[:, 1]))
    return (dirs * r[:, None]).astype(np.float32)


def _move(R, t, p):
    return p @ np.asarray(R, np.float32).T + np.asarray(t, np.float32)


def test_register_pairs_sharded_bit_equal_and_lands_like_jax():
    rng = np.random.default_rng(304)
    base = _lumpy(rng, 1500)
    n = len(base)
    srcs = []
    for ang in (8.0, 14.0, 20.0, 26.0):
        R = np.asarray(syn.rotate_y(ang), np.float32)
        srcs.append(_move(R.T, -R.T @ np.array([3.0, -1.0, 2.0], np.float32), base))
    p = len(srcs)
    vd = torch.ones(n, dtype=torch.bool)

    def feats(x):
        t = torch.from_numpy(x)
        nr = nrmlib.estimate_normals(t, vd, 20)
        return nr, reg.fpfh_features(t, nr, vd, radius=12.0, k=48)

    nd, fd = feats(base)
    sfs = [feats(s)[1] for s in srcs]
    args = (torch.from_numpy(np.stack(srcs)), torch.ones((p, n), dtype=torch.bool),
            torch.stack(sfs), torch.from_numpy(np.stack([base] * p)),
            torch.ones((p, n), dtype=torch.bool), torch.stack([fd] * p),
            torch.stack([nd] * p))
    kw = dict(max_dist=5.0, icp_max_dist=5.0, trials=1024, icp_iters=20)
    T_s, g_s, f_s, r_s = reg.register_pairs_sharded(_cpus(8), *args, icp_lanes=p, **kw)
    T_u, g_u, f_u, r_u = reg.register_pairs(*args, **kw)
    for a, b in ((T_s, T_u), (g_s, g_u), (f_s, f_u), (r_s, r_u)):
        assert a.shape == b.shape and torch.equal(a, b)
    # JAX's sharded pair batch on the same scene (its own features)
    jvd = jnp.ones(n, bool)

    def jfeats(x):
        nr = jnrm.estimate_normals(jnp.asarray(x), jvd, 20)
        return nr, np.asarray(jreg.fpfh_features(jnp.asarray(x), nr, jvd, radius=12.0, k=48))

    jnd, jfd = jfeats(base)
    jargs = (np.stack(srcs), np.ones((p, n), bool), np.stack([jfeats(s)[1] for s in srcs]),
             np.stack([base] * p), np.ones((p, n), bool), np.stack([jfd] * p),
             np.stack([np.asarray(jnd)] * p))
    T_j, _, f_j, _ = jreg.register_pairs_sharded(jmesh.make_mesh(), *jargs, **kw)
    for i in range(p):
        for T, f in ((T_s.numpy(), f_s.numpy()), (np.asarray(T_j), np.asarray(f_j))):
            assert float(f[i]) > 0.9
            landed = _move(T[i, :3, :3], T[i, :3, 3], srcs[i])
            assert np.median(np.linalg.norm(landed - base, axis=1)) < 0.5


@pytest.fixture(scope="module")
def merge_scene():
    rng = np.random.default_rng(73)
    base = np.concatenate([rng.normal(0, 18, (4000, 3)),
                           rng.normal((35, 0, 0), 10, (2000, 3))]).astype(np.float32)
    clouds = []
    for ang in (0.0, 12.0, 24.0, 36.0):
        w = base @ np.asarray(syn.rotate_y(ang), np.float32).T
        vis = w[:, 2] < np.percentile(w[:, 2], 70)
        clouds.append((w[vis].astype(np.float32),
                       np.full((int(vis.sum()), 3), 128, np.uint8)))
    # pair_batch 1: each pair's ICP on one lane in both arms (the lane
    # padding of a sharded group is (iii)'s case)
    kw = dict(voxel_size=2.0, ransac_trials=1024, icp_iters=15, final_voxel=1.0,
              outlier_nb=10, pair_batch=1)
    return clouds, MergeConfig(**kw), JMergeConfig(**kw)


def test_merge_360_mesh_matches_unsharded_and_jax(merge_scene):
    clouds, cfg, jcfg = merge_scene
    tm: dict = {}
    p_m, c_m, T_m = rec.merge_360(clouds, cfg, log=_quiet, device="cpu", mesh=_cpus(8),
                                  timings=tm)
    p_s, c_s, T_s = rec.merge_360(clouds, cfg, log=_quiet, device="cpu")
    assert tm["arm"] == "host-list" and "mesh" in tm["refused"]
    assert len(T_m) == 4 and np.isfinite(p_m).all() and len(p_m) == len(c_m)
    for a, b in zip(T_m, T_s):
        np.testing.assert_array_equal(a, b)
    assert rec.chamfer_distance(p_m, p_s, device="cpu") < 2.0 * cfg.voxel_size
    p_j, _, _ = jrec.merge_360(clouds, jcfg, log=_quiet,
                               mesh=jmesh.make_mesh(n_data=8, n_model=1))
    assert rec.chamfer_distance(p_m, np.asarray(p_j), device="cpu") < 2.0 * cfg.voxel_size


def test_transform_views_batched_mesh_bit_equal_and_matches_numpy():
    rng = np.random.default_rng(5)
    views = [rng.normal(0, 60, (n, 3)).astype(np.float32) for n in (10, 3000, 2049)]
    Ts = []
    for _ in views:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        T[:3, 3] = rng.normal(0, 20, 3)
        Ts.append(T)
    whole = rec.transform_views_batched(views, Ts, device="cpu")
    for n_dev in (2, 4):
        got = rec.transform_views_batched(views, Ts, mesh=_cpus(n_dev))
        for g, w, p, T in zip(got, whole, views, Ts):
            assert g.dtype == np.float32 and g.shape == p.shape
            np.testing.assert_array_equal(g, w)
            np.testing.assert_allclose(g, jrec._transform_view_np(T, p), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# (v): the slab-sharded postprocess
# ---------------------------------------------------------------------------

def _unmatched(a, b, tol: float = 1e-3) -> int:
    """Rows of either cloud with no row of the other within ``tol`` mm: the
    symmetric difference of two kept sets whose voxel means may differ in
    their last bit (rounding both to 1e-4 would split such a pair)."""
    from scipy.spatial import cKDTree

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return int((cKDTree(b).query(a)[0] > tol).sum() + (cKDTree(a).query(b)[0] > tol).sum())


@pytest.fixture(scope="module")
def pp_cloud():
    rng = np.random.default_rng(31)
    cloud = np.concatenate([rng.uniform(0, 80, (11_940, 3)),
                            rng.uniform(200, 260, (60, 3))]).astype(np.float32)
    cols = rng.integers(0, 256, (len(cloud), 3)).astype(np.uint8)
    p, c, v = pc.voxel_downsample(torch.from_numpy(cloud), torch.from_numpy(cols),
                                  torch.ones(len(cloud), dtype=torch.bool), 2.0)
    p, c = p[v], c[v]
    keep = pc.statistical_outlier_mask(p.contiguous(), torch.ones(len(p), dtype=torch.bool),
                                       20, 2.0)
    return cloud, cols, p[keep].numpy()


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_postprocess_matches_jax_and_unsharded(pp_cloud, n_dev):
    cloud, cols, ref = pp_cloud
    p_sh, c_sh = pcs.postprocess_merged_sharded(n_dev, cloud, cols, None, final_voxel=2.0,
                                                outlier_nb=20, outlier_std=2.0)
    assert len(p_sh) == len(c_sh) and p_sh[:, 0].max() < 150.0
    assert _unmatched(p_sh, ref) <= 4 and abs(len(p_sh) - len(ref)) <= 4
    p_j, _ = jpcs.postprocess_merged_sharded(n_dev, cloud, cols, None, final_voxel=2.0,
                                             outlier_nb=20, outlier_std=2.0)
    assert _unmatched(p_sh, p_j) <= 4 and abs(len(p_sh) - len(p_j)) <= 4


def test_sharded_postprocess_refusals():
    rng = np.random.default_rng(60)
    flat = rng.uniform(0, 10, (1000, 3)).astype(np.float32)
    flat[:, 2] = 0.0
    with pytest.raises(pcs.SlabRefused, match="too thin"):
        pcs.shard_points_by_slab(flat, None, None, 8, 5.0)
    thin = rng.uniform(0, 80, (4000, 3)).astype(np.float32)
    thin[:, 2] *= 0.2
    with pytest.raises(pcs.SlabRefused, match="certification radius"):
        pcs.postprocess_merged_sharded(8, thin, None, None, final_voxel=1.0)
    wide = rng.uniform(0, 50, (2000, 3)).astype(np.float32)
    wide[0, 0] = 2000.0     # 2000 cells: the JAX package's packed keys refuse it
    with pytest.raises(ValueError, match="1023"):
        jpcs.shard_points_by_slab(wide, None, None, 4, 1.0)
    pcs.shard_points_by_slab(wide, None, None, 4, 1.0)     # the port's int64 keys hold it
    wide[0, 0] = 2.0e6      # past the port's 2^20 - 1 cells
    with pytest.raises(pcs.SlabRefused, match="1048575"):
        pcs.shard_points_by_slab(wide, None, None, 4, 1.0)
    assert issubclass(pcs.SlabRefused, ValueError)
    # the partition keeps every voxel cell on one slab
    cloud = rng.uniform(0, 50, (5000, 3)).astype(np.float32)
    pts_sh, _, valid_sh, origin, _ = pcs.shard_points_by_slab(cloud, None, None, 4, 2.0)
    owner = {}
    for d in range(4):
        for zc in np.unique(np.floor((pts_sh[d][valid_sh[d]][:, 2] - origin[2]) / 2.0)):
            assert owner.setdefault(zc, d) == d


def test_postprocess_dispatch_falls_back_only_on_a_refusal(monkeypatch):
    rng = np.random.default_rng(61)
    cloud = rng.uniform(0, 60, (3000, 3)).astype(np.float32)
    cols = np.zeros_like(cloud, dtype=np.uint8)
    cfg = MergeConfig(final_voxel=2.0, outlier_nb=10)
    logs = []
    single = rec._postprocess_merged(cloud, cols, cfg, {}, device="cpu")
    tm: dict = {}
    rec._postprocess_dispatch(cloud, cols, cfg, tm, _cpus(4), logs.append, "cpu")
    assert tm["postprocess_arm"] == "slab-sharded"

    def refuse(*_a):
        raise pcs.SlabRefused("too thin to slab")

    monkeypatch.setattr(pcs, "_voxelize", refuse)
    got = rec._postprocess_dispatch(cloud, cols, cfg, tm, _cpus(4), logs.append, "cpu")
    np.testing.assert_array_equal(got[0], single[0])
    assert tm["postprocess_arm"].startswith("single-device (refused")
    assert any("sharded postprocess unavailable" in m for m in logs)

    def boom(*_a):
        raise RuntimeError("a shard's local step failed")

    monkeypatch.setattr(pcs, "_voxelize", boom)
    with pytest.raises(RuntimeError, match="local step failed"):
        rec._postprocess_dispatch(cloud, cols, cfg, {}, _cpus(4), logs.append, "cpu")


# ---------------------------------------------------------------------------
# (vi): the slab-sharded Poisson solve
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sphere():
    rng = np.random.default_rng(20)
    d = rng.normal(size=(4000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (50.0 * d).astype(np.float32), d.astype(np.float32)


def test_poisson_sharded_matches_jax_and_dense(sphere):
    pts, nrm = sphere
    res = ps.poisson_solve_sharded(pts, nrm, depth=5, cg_iters=200, devices=[CPU] * 8)
    dense = poisson.poisson_solve(torch.from_numpy(pts), torch.from_numpy(nrm), depth=5,
                                  cg_iters=200)
    jres = jps.poisson_solve_sharded(pts, nrm, depth=5, cg_iters=200)
    for ref in ((dense.chi, dense.density, dense.origin, dense.cell),
                tuple(np.asarray(x) for x in (jres.chi, jres.density, jres.origin,
                                              jres.cell))):
        chi, density, origin, cell = (np.asarray(x) for x in ref)
        np.testing.assert_allclose(res.chi.numpy(), chi, atol=1e-3)
        np.testing.assert_allclose(res.density.numpy(), density, atol=1e-4)
        np.testing.assert_allclose(res.origin.numpy(), origin, atol=1e-5)
        assert float(res.cell) == float(cell)
    assert res.chi.shape == (32, 32, 32)


def test_poisson_sharded_split_parity_and_divisibility(sphere):
    pts, nrm = sphere
    r2 = ps.poisson_solve_sharded(pts, nrm, depth=6, cg_iters=200, devices=[CPU] * 2)
    r8 = ps.poisson_solve_sharded(pts, nrm, depth=6, cg_iters=200, devices=[CPU] * 8)
    np.testing.assert_allclose(r2.chi.numpy(), r8.chi.numpy(), atol=1e-4)
    assert abs(float(r2.iso) - float(r8.iso)) < 1e-5
    with pytest.raises(ValueError, match="divisible"):
        ps.poisson_solve_sharded(pts[:500], nrm[:500], depth=5, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="> 16"):
        ps.poisson_solve_sharded(pts[:500], nrm[:500], depth=17, devices=[CPU] * 2)
    # the slab Laplacian is the dense stencil's, bit for bit
    u = torch.from_numpy(np.random.default_rng(3).normal(size=(16, 8, 8)).astype(np.float32))
    lap = torch.cat(ps.laplacian_sharded(_cpus(4), list(u.chunk(4))))
    assert torch.equal(lap, poisson._laplacian(u))


def test_jax_devices_are_the_conftest_eight():
    assert len(jax.devices()) == 8
