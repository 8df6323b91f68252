"""The port's registration ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages (JAX on
the CPU with its brute 1-NN arm, as its own tests run it). Tolerances:

- kabsch: transforms within 1e-4 (f32 SVDs of two libraries);
- knn: neighbour distances within 1e-3 mm^2, neighbour sets equal on >= 99 %
  of rows (the JAX package selects on the |q|^2+|b|^2-2q.b expansion, the
  port on exact differences: near ties may swap);
- normals: |n . n_ref| >= 1 - 1e-4 on >= 99 % of rows (closed-form
  eigenvector; near-degenerate neighbourhoods may pick another cross product);
- FPFH from the same neighbours and normals: within 1e-4 on >= 99.5 % of rows
  (an angle on a bin edge may land in the next bin);
- feature correspondences from the same features: >= 99 % equal;
- RANSAC with the reference's own jax.random.choice draws injected: transform
  within 1e-4, fitness equal;
- ICP from the same start: the same number of steps, transform within 1e-4;
- voxel downsample: survivor order and colors equal, means within 1e-5
  relative (the port sums in float64, the JAX package in float32);
- ``icp_point_to_plane`` on tests/test_registration.py:37's scene (a lumpy
  cloud and a copy 4 degrees and ~2.6 mm off): transform within 1e-4,
  fitness within 1e-6, rmse within rel 1e-4 or 1e-5 mm (the copy is exact,
  so the rmse sits at float32 rounding, ~3e-6 mm), against the JAX
  package's accelerator arm (``_icp_jit_brute``: dense 1-NN, the
  direction-aware stop the port runs on every device); the JAX test's own
  bar; and a launch of the nn1 wrapper (its plain version on the CPU);
- ``ransac_global_registration`` with the reference's draws injected on
  tests/test_registration.py:54's scene (30 degrees, ~13 mm): transform
  within 1e-4, fitness within 1e-6;
- ``feat_bf16=True`` (tests/test_registration.py:73): the correspondences
  equal the JAX package's bf16 ones but for <= 0.5 % near ties, and the
  JAX test's alignment bar holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.ops import knn as jknn
from structured_light_for_3d_model_replication_tpu.ops import normals as jnrm
from structured_light_for_3d_model_replication_tpu.ops import pointcloud as jpc
from structured_light_for_3d_model_replication_tpu.ops import registration as jreg
from structured_light_for_3d_model_replication_tpu.utils import synthetic as jsyn
from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
from structured_light_for_3d_model_replication_tpu_torch.ops import normals as nrmlib
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.ops import registration as reg


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _lumpy(rng, n):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 50 * (1 + 0.25 * np.sin(4 * d[:, 0]) * np.cos(3 * d[:, 1]))
    return (d * r[:, None]).astype(np.float32)


def _moved(p, ang, t):
    R = np.asarray(jsyn.rotate_y(ang), np.float32)
    return (p @ R.T + np.asarray(t, np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """A lumpy object and a rotated, shifted copy, with JAX normals and FPFH."""
    rng = np.random.default_rng(3)
    dst = _lumpy(rng, 1500)
    src = _moved(dst, -25.0, (-6.0, 2.0, 4.0)) + rng.normal(0, 0.05, dst.shape).astype(np.float32)
    v = jnp.ones(len(dst), bool)
    out = {"src": src, "dst": dst, "valid": np.ones(len(dst), bool)}
    for name, pts in (("src", src), ("dst", dst)):
        idx, d2 = jknn.knn(jnp.asarray(pts), v, 32)
        nr = jnrm.estimate_normals(jnp.asarray(pts), v, k=30, idx_d2=(idx, d2))
        out[name + "_knn"] = (np.asarray(idx), np.asarray(d2))
        out[name + "_nrm"] = np.asarray(nr)
        out[name + "_feat"] = np.asarray(jreg.fpfh_features(
            jnp.asarray(pts), nr, v, radius=12.0, k=32, idx_d2=(idx, d2)))
    return out


def test_kabsch_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.normal(0, 30, (64, 40, 3)).astype(np.float32)
    q = (p @ np.asarray(jsyn.rotate_y(20.0), np.float32).T
         + rng.normal(0, 0.5, p.shape)).astype(np.float32)
    w = (rng.random((64, 40)) > 0.2).astype(np.float32)
    for args in ((p, q), (p, q, w)):
        got = reg.kabsch(*(_t(a) for a in args)).numpy()
        ref = np.asarray(jreg.kabsch(*(jnp.asarray(a) for a in args)))
        np.testing.assert_allclose(got, ref, atol=1e-4)
        R = got[:, :3, :3]
        assert np.abs(np.einsum("tij,tkj->tik", R, R) - np.eye(3)).max() < 1e-5


def test_knn_and_normals_match_jax(pair):
    pts, v = pair["dst"], pair["valid"]
    idx, d2 = knnlib.knn(_t(pts), _t(v), 32)
    jidx, jd2 = pair["dst_knn"]
    np.testing.assert_allclose(d2.numpy(), jd2, atol=1e-3)
    same = np.array([set(a) == set(b) for a, b in zip(idx.numpy(), jidx)])
    assert same.mean() >= 0.99
    nr = nrmlib.estimate_normals(_t(pts), _t(v), k=30, idx_d2=(idx, d2)).numpy()
    dots = np.abs((nr * pair["dst_nrm"]).sum(-1))
    assert (dots >= 1 - 1e-4).mean() >= 0.99


def test_fpfh_matches_jax_on_the_same_neighbours(pair):
    idx, d2 = (_t(a) for a in pair["dst_knn"])
    f = reg.fpfh_features(_t(pair["dst"]), _t(pair["dst_nrm"]), _t(pair["valid"]),
                          radius=12.0, k=32, idx_d2=(idx, d2)).numpy()
    close = np.abs(f - pair["dst_feat"]).max(axis=1) <= 1e-4
    assert close.mean() >= 0.995


def test_feature_correspondences_match_jax(pair):
    sf, df, v = pair["src_feat"], pair["dst_feat"], pair["valid"]
    for mutual in (True, False):
        cj, ok = reg._feature_correspondences(_t(sf), _t(df), _t(v), _t(v), mutual, block=512)
        jcj, jok = jreg._feature_correspondences(jnp.asarray(sf), jnp.asarray(df),
                                                 jnp.asarray(v), jnp.asarray(v), mutual,
                                                 block=512)
        assert (cj.numpy() == np.asarray(jcj)).mean() >= 0.99
        assert (ok.numpy() == np.asarray(jok)).mean() >= 0.99


_jax_ransac = jax.jit(jreg._ransac_core, static_argnames=("trials", "refine_iters", "nn_mode"))
_jax_icp = jax.jit(jreg._icp_core, static_argnames=("iters", "nn_mode"))


def test_ransac_core_with_the_reference_draws(pair):
    src, dst, v = pair["src"], pair["dst"], pair["valid"]
    cj, ok = jreg._feature_correspondences(jnp.asarray(pair["src_feat"]),
                                           jnp.asarray(pair["dst_feat"]),
                                           jnp.asarray(v), jnp.asarray(v), True)
    key = jax.random.PRNGKey(5)
    trials = 512
    probs = ok.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    samp = np.asarray(jax.random.choice(key, len(src), shape=(trials, 3), p=probs))
    T_j, fit_j, rmse_j = _jax_ransac(
        jnp.asarray(src), jnp.asarray(v), jnp.asarray(dst), jnp.asarray(v), cj, ok,
        jnp.float32(4.5), jnp.float32(0.9), key, trials=trials, refine_iters=3,
        nn_mode="brute")
    T, fit, rmse = reg._ransac_core(
        _t(src), _t(v), _t(dst), _t(v), _t(np.asarray(cj)), _t(np.asarray(ok)), 4.5, 0.9,
        trials=trials, refine_iters=3, samples=samp)
    np.testing.assert_allclose(T.numpy(), np.asarray(T_j), atol=1e-4)
    assert float(fit) == float(fit_j) and float(fit) > 0.5
    np.testing.assert_allclose(float(rmse), float(rmse_j), rtol=1e-3)


def test_icp_core_matches_jax_step_for_step(pair, monkeypatch):
    src, dst, v = pair["src"], pair["dst"], pair["valid"]
    R = np.asarray(jsyn.rotate_y(23.5), np.float32)        # near the true 25
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = R
    T0[:3, 3] = (5.0, -1.5, -3.0)
    jn = pair["dst_nrm"]
    calls = []
    orig = reg._nn1_dispatch
    monkeypatch.setattr(reg, "_nn1_dispatch", lambda *a: (calls.append(1), orig(*a))[1])
    T, fit, rmse = reg._icp_core(_t(src)[None], _t(v)[None], _t(dst)[None], _t(v)[None],
                                 _t(jn)[None], _t(T0)[None], 4.5, 30)
    steps = len(calls)
    assert 2 <= steps < 30

    def jax_icp(iters):
        return _jax_icp(jnp.asarray(src), jnp.asarray(v), jnp.asarray(dst), jnp.asarray(v),
                        jnp.asarray(jn), jnp.asarray(T0), jnp.float32(4.5), iters=iters,
                        nn_mode="brute")

    T_j, fit_j, rmse_j = jax_icp(30)
    T_same, _, _ = jax_icp(steps)          # the reference stops after as many steps
    T_less, _, _ = jax_icp(steps - 1)
    np.testing.assert_array_equal(np.asarray(T_same), np.asarray(T_j))
    assert not np.array_equal(np.asarray(T_less), np.asarray(T_j))
    np.testing.assert_allclose(T[0].numpy(), np.asarray(T_j), atol=1e-4)
    np.testing.assert_allclose(float(fit[0]), float(fit_j), atol=1e-3)
    np.testing.assert_allclose(float(rmse[0]), float(rmse_j), rtol=1e-3)


@pytest.mark.parametrize("spread", [40.0, 3000.0])
def test_voxel_downsample_matches_jax(spread):
    """Packed key (grid under 2^10 cells an axis) and the lexicographic key."""
    rng = np.random.default_rng(int(spread))
    pts = rng.uniform(0, spread, (5000, 3)).astype(np.float32)
    pts[:2500] = pts[:2500] * 0.05 + 7.0                       # dense cells
    cols = rng.integers(0, 256, (5000, 3)).astype(np.uint8)
    valid = rng.random(5000) > 0.1
    vs = 1.0 if spread < 100 else 20.0
    p, c, v = (a.numpy() for a in pc.voxel_downsample(_t(pts), _t(cols), _t(valid), vs))
    jp, jc, jv = (np.asarray(a) for a in jpc.voxel_downsample(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), vs))
    np.testing.assert_array_equal(v, jv)
    m = int(v.sum())
    assert 100 < m < 5000 and v[:m].all() and not v[m:].any()
    np.testing.assert_allclose(p[:m], jp[:m], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(c[:m], jc[:m])


def _lumpy_pair(seed, n, ang, t):
    """A lumpy cloud and the copy that ``T = [R(ang) | t]`` maps onto it."""
    rng = np.random.default_rng(seed)
    dst = _lumpy(rng, n)
    R = np.asarray(jsyn.rotate_y(ang), np.float32)
    src = (dst @ R + (-R.T @ np.asarray(t, np.float32))).astype(np.float32)
    return src, dst


def test_icp_point_to_plane_matches_jax(monkeypatch):
    src, dst = _lumpy_pair(2, 4000, 4.0, (1.5, -0.8, 2.0))
    v = jnp.ones(len(dst), bool)
    nr = jnrm.estimate_normals(jnp.asarray(dst), v, 20)
    nr = np.array(jnrm.orient_normals(jnp.asarray(dst), nr, v))
    T_j, fit_j, rmse_j = jreg._icp_jit_brute(jnp.asarray(src), v, jnp.asarray(dst), v,
                                             jnp.asarray(nr), jnp.eye(4), jnp.float32(8.0), 30)
    calls = []
    real = reg.kernels.nn1
    monkeypatch.setattr(reg.kernels, "nn1", lambda *a: (calls.append(1), real(*a))[1])
    res = reg.icp_point_to_plane(src, None, dst, None, nr, max_dist=8.0, iters=30,
                                 device="cpu")
    assert isinstance(res, reg.RegistrationResult) and calls
    np.testing.assert_allclose(res.transform.numpy(), np.asarray(T_j), atol=1e-4)
    np.testing.assert_allclose(float(res.fitness), float(fit_j), atol=1e-6)
    np.testing.assert_allclose(float(res.rmse), float(rmse_j), rtol=1e-4, atol=1e-5)
    T = res.transform.numpy()
    err = np.linalg.norm(src @ T[:3, :3].T + T[:3, 3] - dst, axis=1)
    assert float(res.fitness) > 0.95 and np.median(err) < 0.35


@pytest.fixture(scope="module")
def ransac_scene():
    """tests/test_registration.py:54's pair with the JAX package's normals
    and FPFH (radius 12, k = 48)."""
    src, dst = _lumpy_pair(4, 3000, 30.0, (12.0, 2.0, -6.0))
    v = jnp.ones(len(dst), bool)
    feats = [np.array(jreg.fpfh_features(jnp.asarray(p), jnrm.estimate_normals(
        jnp.asarray(p), v, 20), v, radius=12.0, k=48)) for p in (src, dst)]
    return src, dst, feats[0], feats[1]


def _jax_global_draws(fs, fd, feat_bf16, trials):
    v = jnp.ones(len(fs), bool)
    cj, ok = jreg._feature_correspondences(jnp.asarray(fs), jnp.asarray(fd), v, v, True,
                                           feat_bf16=feat_bf16)
    p = ok.astype(jnp.float32) / jnp.maximum(ok.sum(), 1)
    return np.asarray(cj), np.asarray(ok), np.asarray(
        jax.random.choice(jax.random.PRNGKey(0), len(fs), (trials, 3), p=p))


@pytest.mark.parametrize("feat_bf16", [False, True])
def test_ransac_global_registration_with_the_reference_draws(ransac_scene, feat_bf16):
    src, dst, fs, fd = ransac_scene
    ref = jreg.ransac_global_registration(src, fs, None, dst, fd, None, max_dist=5.0,
                                          trials=2048, feat_bf16=feat_bf16)
    cj, okj, draws = _jax_global_draws(fs, fd, feat_bf16, 2048)
    v = torch.ones(len(src), dtype=torch.bool)
    ct, okt = reg._feature_correspondences(_t(fs), _t(fd), v, v, True, feat_bf16=feat_bf16)
    assert (ct.numpy() != cj).mean() <= 0.005 and (okt.numpy() != okj).mean() <= 0.005
    res = reg.ransac_global_registration(src, fs, None, dst, fd, None, max_dist=5.0,
                                         trials=2048, samples=draws, feat_bf16=feat_bf16,
                                         device="cpu")
    np.testing.assert_allclose(res.transform.numpy(), np.asarray(ref.transform), atol=1e-4)
    np.testing.assert_allclose(float(res.fitness), float(ref.fitness), atol=1e-6)
    # the JAX tests' alignment bar, also with the port's own draws
    for r in (res, reg.ransac_global_registration(src, fs, None, dst, fd, None, max_dist=5.0,
                                                  trials=2048, feat_bf16=feat_bf16,
                                                  device="cpu")):
        T = r.transform.numpy()
        err = np.linalg.norm(src @ T[:3, :3].T + T[:3, 3] - dst, axis=1)
        assert float(r.fitness) > 0.5 and np.median(err) < 5.0


def test_bf16_products_round_the_inputs_only():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.random((50, 33), dtype=np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.random((33, 40), dtype=np.float32)).to(torch.bfloat16)
    got = reg._bf16_products(a, b)
    assert got.dtype == torch.float32
    exact = a.double().numpy() @ b.double().numpy()
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-6)
