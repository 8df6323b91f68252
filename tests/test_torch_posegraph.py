"""The port's pose graph and posegraph merge against the JAX package, on the CPU.

Inputs are ``tests/test_posegraph.py``'s, made with numpy from seeds:
random twists (rotation scale 0.8 rad, translation 30 mm), a 179.99-degree
rotation, a 12-view turntable loop with noisy odometry and an exact loop
closure, and four 90-degree views of a lumpy object each seeing its front
70 %. Tolerances:

- ``exp_se3``, ``log_se3`` (also near pi), ``adjoint_se3``: within 1e-5 of
  the JAX package's (near pi the log is compared as the rotation it
  gives, the axis sign being free there);
- ``optimize_pose_graph``: poses within 1e-4, the residual history within
  rel 1e-4 from the second step on, and the drift cut as the JAX test
  asserts. The first step's residual is held within rel 1e-2: it follows
  one f32 LU solve of the normal equations with the gauge anchor's 1e12
  diagonal, whose rounding differs between LAPACK and XLA (here port
  0.005090, JAX package 0.005108, the JAX package's solve in float64
  0.005116);
- ``merge_360_posegraph`` on the JAX package's preps with its draws
  injected: transforms within 1e-5, the same loop-closure decision, and a
  chamfer distance to the JAX package's merged cloud of at most 0.05 mm;
  the JAX test's own bar (the merged cloud within 4 mm chamfer of view 0);
  fewer than 3 views take ``merge_360``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import config as jconfig
from structured_light_for_3d_model_replication_tpu.models import reconstruction as jrec
from structured_light_for_3d_model_replication_tpu.ops import posegraph as jpg
from structured_light_for_3d_model_replication_tpu.ops import registration as jreg
from structured_light_for_3d_model_replication_tpu.utils import synthetic as jsyn
from structured_light_for_3d_model_replication_tpu_torch import config
from structured_light_for_3d_model_replication_tpu_torch.models import reconstruction as rec
from structured_light_for_3d_model_replication_tpu_torch.ops import posegraph as pg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors beside the other test workers: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _twists(n=20, seed=11):
    rng = np.random.default_rng(seed)
    return np.stack([np.concatenate([rng.normal(0, 0.8, 3), rng.normal(0, 30.0, 3)])
                     for _ in range(n)]).astype(np.float32)


def test_exp_log_adjoint_match_jax():
    xi = _twists()
    T = pg.exp_se3(_t(xi)).numpy()
    np.testing.assert_allclose(T, np.asarray(jpg.exp_se3(jnp.asarray(xi))), atol=1e-5)
    np.testing.assert_allclose(pg.log_se3(_t(T)).numpy(),
                               np.asarray(jpg.log_se3(jnp.asarray(T))), atol=1e-5)
    np.testing.assert_allclose(pg.adjoint_se3(_t(T)).numpy(),
                               np.asarray(jpg.adjoint_se3(jnp.asarray(T))), atol=1e-5)
    small = np.asarray([1e-9, 0, 0, 1.0, 2.0, 3.0], np.float32)
    np.testing.assert_allclose(pg.exp_se3(_t(small)).numpy(),
                               np.asarray(jpg.exp_se3(jnp.asarray(small))), atol=1e-5)
    # near pi: the rotation the log gives back
    axis = np.random.default_rng(3).normal(size=3)
    axis /= np.linalg.norm(axis)
    xi_pi = np.concatenate([axis * (np.pi - 1e-4), np.zeros(3)]).astype(np.float32)
    T_pi = pg.exp_se3(_t(xi_pi))
    w = pg.log_se3(T_pi)
    w_j = np.asarray(jpg.log_se3(jnp.asarray(T_pi.numpy())))
    back = pg.exp_se3(torch.cat([w[:3], torch.zeros(3)])).numpy()
    back_j = np.asarray(jpg.exp_se3(jnp.asarray(np.concatenate([w_j[:3], np.zeros(3)]),
                                                jnp.float32)))
    np.testing.assert_allclose(back[:3, :3], back_j[:3, :3], atol=1e-5)
    np.testing.assert_allclose(back[:3, :3], T_pi.numpy()[:3, :3], atol=1e-3)


def _drift_loop():
    """tests/test_posegraph.py:58's 12-view loop: init poses, edges, truth."""
    rng = np.random.default_rng(5)
    n = 12
    step = np.asarray(jpg.exp_se3(jnp.asarray(
        np.concatenate([[0, np.deg2rad(30), 0], [40.0, 0, 5.0]]), jnp.float32)))
    truth = [np.eye(4, dtype=np.float32)]
    for _ in range(1, n):
        truth.append((truth[-1] @ step).astype(np.float32))
    ei, ej, Z, w = [], [], [], []
    for i in range(1, n):
        noise = np.asarray(jpg.exp_se3(jnp.asarray(np.concatenate([
            rng.normal(0, 0.01, 3), rng.normal(0, 0.8, 3)]), jnp.float32)))
        ei.append(i - 1)
        ej.append(i)
        Z.append(np.linalg.inv(truth[i - 1]) @ truth[i] @ noise)
        w.append(1.0)
    ei.append(0)
    ej.append(n - 1)
    Z.append(np.linalg.inv(truth[0]) @ truth[n - 1])
    w.append(2.0)
    init = [np.eye(4, dtype=np.float32)]
    for k in range(n - 1):
        init.append((init[-1] @ Z[k]).astype(np.float32))
    return np.stack(init), ei, ej, np.stack(Z).astype(np.float32), w, truth


def test_optimize_pose_graph_matches_jax_and_corrects_drift():
    init, ei, ej, Z, w, truth = _drift_loop()
    res = pg.optimize_pose_graph(init, ei, ej, Z, w, iters=25, device="cpu")
    ref = jpg.optimize_pose_graph(init, ei, ej, Z, w, iters=25)
    np.testing.assert_allclose(res.poses.numpy(), np.asarray(ref.poses), atol=1e-4)
    hist, hist_j = res.residual_rmse.numpy(), np.asarray(ref.residual_rmse)
    np.testing.assert_allclose(hist[1:], hist_j[1:], rtol=1e-4)
    np.testing.assert_allclose(hist[0], hist_j[0], rtol=1e-2)
    np.testing.assert_allclose(float(res.initial_rmse), float(ref.initial_rmse), rtol=1e-4)
    drift_before = np.linalg.norm(init[-1][:3, 3] - truth[-1][:3, 3])
    drift_after = np.linalg.norm(res.poses[-1, :3, 3].numpy() - truth[-1][:3, 3])
    assert float(res.residual_rmse[-1]) < float(res.initial_rmse)
    assert drift_after < 0.5 * drift_before, (drift_before, drift_after)


@pytest.fixture(scope="module")
def loop_views():
    """tests/test_posegraph.py:96's four 90-degree views."""
    rng = np.random.default_rng(1)
    dirs = rng.normal(size=(6000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = 50 * (1 + 0.25 * np.sin(4 * dirs[:, 0]) * np.cos(3 * dirs[:, 1]))
    base = (dirs * r[:, None]).astype(np.float32)
    clouds = []
    for ang in (0, 90, 180, 270):
        world = (base @ np.asarray(jsyn.rotate_y(ang), np.float32).T).astype(np.float32)
        vis = world[:, 2] < np.percentile(world[:, 2], 70)
        cl = world[vis] + rng.normal(0, 0.05, (int(vis.sum()), 3)).astype(np.float32)
        clouds.append((cl.astype(np.float32), np.full((int(vis.sum()), 3), 128, np.uint8)))
    return clouds


def test_merge_360_posegraph_with_the_reference_draws(loop_views, monkeypatch):
    kw = dict(voxel_size=2.0, ransac_trials=2048, icp_iters=25, final_voxel=0.0,
              outlier_nb=0, method="posegraph")
    jcfg = jconfig.MergeConfig(**kw)
    jpreps = jrec._preprocess_views(loop_views, 2.0, 0)
    jlog, log = [], []
    p_j, _, T_j = jrec.merge_360_posegraph(loop_views, jcfg, log=jlog.append)
    draws = []
    for i, (s, d) in enumerate(zip(jpreps[1:] + [jpreps[-1]], jpreps[:-1] + [jpreps[0]])):
        _, ok = jreg._feature_correspondences(s.features, d.features, s.valid, d.valid, True)
        p = ok.astype(jnp.float32) / jnp.maximum(ok.sum(), 1)
        draws.append(np.asarray(jax.random.choice(jax.random.fold_in(
            jax.random.PRNGKey(0), i), s.points.shape[0], (jcfg.ransac_trials, 3), p=p)))
    monkeypatch.setattr(rec, "_preprocess_views", lambda *a, **k: [
        rec.prep_from_reference(p, "cpu") for p in jpreps])
    monkeypatch.setattr(rec, "_register_chain_batched", functools.partial(
        rec._register_chain_batched, samples=draws))
    steps = []
    tm = {}
    p, c, T = rec.merge_360_posegraph(loop_views, config.MergeConfig(**kw), log=log.append,
                                      device="cpu", timings=tm,
                                      step_callback=lambda i, *a: steps.append(i))
    assert len(T) == 4 and len(p) == len(c) and steps == [0, 1, 2, 3]
    np.testing.assert_allclose(np.stack(T), np.stack(T_j), atol=1e-5)

    def closure(lines):
        return [ln.split(":")[0] for ln in lines if "loop closure" in ln]

    assert tm["loop_closure"] is True and closure(log) == closure(jlog)
    assert rec.chamfer_distance(p, np.asarray(p_j), device="cpu") <= 0.05
    assert rec.chamfer_distance(p[:20000], loop_views[0][0], device="cpu") < 4.0


def test_merge_360_posegraph_below_three_views_is_merge_360(loop_views, monkeypatch):
    seen = []
    monkeypatch.setattr(rec, "merge_360", lambda clouds, cfg, **kw: seen.append(
        len(clouds)) or ("p", "c", "T"))
    assert rec.merge_360_posegraph(loop_views[:2], device="cpu") == ("p", "c", "T")
    assert seen == [2]
