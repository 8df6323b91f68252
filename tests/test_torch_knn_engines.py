"""The port's large-cloud k-NN engines against the JAX package, on the CPU.

Clouds are made with numpy from a seed. The large-N arms are reached at
small sizes by lowering ``_BRUTE_MAX`` in both packages for a test
(monkeypatch; no JAX file changes). Tolerances:

- ``knn_dense_approx`` at recall 1.0 on 2,000 rows of tests/test_grid.py's
  cloud with every 11th row invalid, against the JAX package's
  knn_dense_approx program (``_knn_dense_jit``) on 512-row query chunks over
  a 2048-row pad (its wrapper's 8192-column pad makes the CPU's sort-based
  approx_min_k take ~15 s even here): distances within 1e-2 mm of the JAX
  package's (it selects on the |q|^2+|b|^2-2q.b expansion and recomputes),
  no invalid or self neighbour, and the neighbour sets equal on every valid
  row whose k-th and (k+1)-th exact distances differ by more than 1e-4 mm^2
  (closer pairs may swap in the expansion's rounding);
- the binned selection at 0.95 (k = 32, feature prep) and 0.99 (k = 16,
  the cluster step) on a pixel-ordered cloud (a small
  ``sphere_on_background`` render's lit pixels in row order, the order a
  decoded view has) and on the same cloud shuffled: mean recall against
  the exact arm at least the target (1 in pixel order, below 1 shuffled),
  and within 0.01 of it against the JAX package's exact arm (which selects
  on the expansion), every miss one-sided (each rank's distance at or
  above the exact one), and the result equal bit for bit whatever the row
  chunks and with parked padding rows added;
- the slab top-k engine's five selectors at an explicit tile and window on
  a 12,000-row slab (the JAX package's sort-based approx1 arm is slow on
  the CPU): where both packages certify a row, means within 1e-4
  relative; the certified sets differ only at near-ties (the k-th distance
  within 1e-3 of r^2, relative); "nosel" (first k columns, no selection)
  certifies the same rows as the JAX package's, means within 1e-6 relative
  (the k-term sum's order);
- ``statistical_outlier_mask`` above 32,768 rows on the CPU (the cKDTree
  twin): equal bit for bit;
- the clean chain above the lowered brute ceiling (cluster on the grid
  k-NN, radius on the grid count) with the JAX package's plane draws:
  background, cluster and radius counts equal; the statistical count within
  0.5 % (the port's statistical step stays exact below 32,768 rows, where
  the JAX package takes the grid k-NN, whose overestimates move a few rows
  across the threshold);
- the large-N CPU arm (the grid): distances within 1e-5 mm^2 or one f32
  rounding (rtol 1e-6) of the JAX package's;
- the dispatch tables of ``knn``, ``radius_count`` and
  ``statistical_outlier_mask`` for every (device, N, exact, selector), and
  on the CPU the engine each call takes;
- ``_feat_knn_selector`` on cpu and cuda and under SLSCAN_FEAT_EXACT=1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import config as jconfig
from structured_light_for_3d_model_replication_tpu.ops import knn as jknn
from structured_light_for_3d_model_replication_tpu.ops import pointcloud as jpc
from structured_light_for_3d_model_replication_tpu_torch import config
from structured_light_for_3d_model_replication_tpu_torch.models import reconstruction as rec
from structured_light_for_3d_model_replication_tpu_torch.ops import grid as gridlib
from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

FAR = 1e9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers, torch's default thread pool
    oversubscribes the cores: this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _big_cloud(n=12_000):
    """tests/test_grid.py's cloud (seed 3), its first n rows."""
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.normal(0, 30, (50_000, 3)),
                          rng.uniform(-60, 60, (50_000, 3))]).astype(np.float32)
    return pts[:n]


@pytest.fixture(scope="module", params=["pixel", "shuffled"])
def pixel_cloud(request):
    """The lit pixels of a 128x96 sphere_on_background render in row order
    (a decoded view's order) with 0.01 mm of noise from a seed, or the same
    rows shuffled; with each row's 32 nearest by the port's exact arm and by
    the JAX package's (k = 16 takes the first 16 of either)."""
    rig = syn.default_rig(cam_size=(128, 96), proj_size=(128, 64))
    _, gt = syn.render_scene(rig, syn.sphere_on_background())
    pts = gt["points"][gt["lit"]]
    pts = (pts + np.random.default_rng(5).normal(0, 0.01, pts.shape)).astype(np.float32)
    if request.param == "shuffled":
        pts = pts[np.random.default_rng(6).permutation(len(pts))]
    valid = np.ones(len(pts), bool)
    exact = tuple(a.numpy() for a in knnlib.knn(_t(pts), _t(valid), 32, exact=True))
    jidx, _ = jknn.knn(jnp.asarray(pts), jnp.asarray(valid), 32, exact=True)
    return request.param, pts, exact, np.asarray(jidx)


def test_knn_dense_approx_at_recall_one_matches_jax():
    pts = _big_cloud(2000)
    n, k = len(pts), 8
    valid = np.ones(n, bool)
    valid[::11] = False
    idx, d2 = (a.numpy() for a in knnlib.knn_dense_approx(_t(pts), _t(valid), k,
                                                           recall_target=1.0))
    # the JAX package's knn_dense_approx program on 512-row query chunks
    # over a 2048-row pad (its wrapper pads to 8192 columns and 2048-row
    # chunks, whose CPU sort costs ~15 s here)
    p, v = jknn._pad_jax(jnp.asarray(pts), jnp.asarray(valid), 2048)
    jidx, jd2 = (np.asarray(a)[:n] for a in jknn._knn_dense_jit(p, v, k, 512, True, 1.0))
    np.testing.assert_allclose(np.sqrt(d2[valid]), np.sqrt(np.maximum(jd2[valid], 0)),
                               atol=1e-2)
    assert valid[idx[valid]].all()
    assert (idx[valid] != np.arange(n)[valid][:, None]).all()
    # the exact (k+1)-th distance, to find rows whose cut is a near-tie
    _, ex = knnlib.knn(_t(pts), _t(valid), k + 1)
    gap = (ex[:, k] - ex[:, k - 1]).numpy() > 1e-4
    rows = valid & gap
    assert rows.mean() > 0.8
    np.testing.assert_array_equal(np.sort(idx[rows], 1), np.sort(jidx[rows], 1))
    # at recall 1.0 the binned selection is the exact engine's result
    eidx, ed2 = knnlib.knn(_t(pts), _t(valid), k)
    np.testing.assert_array_equal(idx[valid], eidx.numpy()[valid])
    np.testing.assert_array_equal(d2[valid], ed2.numpy()[valid])


@pytest.mark.parametrize("k,recall", [(32, 0.95), (16, 0.99)])
def test_binned_selection_recall_on_a_pixel_ordered_cloud(k, recall, pixel_cloud,
                                                          monkeypatch):
    """Strided bins spread a pixel-ordered cloud's neighbours (index
    offsets within a few image rows) over distinct bins: recall 1 there.
    In a shuffled order the recall is the model's, below 1 and at least the
    target."""
    order, pts, (eidx, ed2), jidx = pixel_cloud
    n = len(pts)
    valid = np.ones(n, bool)
    m = kernels.binmin_bins(n, k, recall)
    assert m < n // 2          # the bins hold several columns each
    sel = f"approx:{recall}"
    idx, d2 = (a.numpy() for a in knnlib.knn(_t(pts), _t(valid), k, selector=sel))
    # the exact arm: the port's (difference distances, held against the JAX
    # package in tests/test_torch_knn.py); the JAX package's own exact arm
    # selects on the expansion, whose f32 rounding at these ~420 mm
    # coordinates (~1e-2 mm^2) reorders near neighbours
    eidx, ed2, jidx = eidx[:, :k], ed2[:, :k], jidx[:, :k]
    hits = (idx[:, :, None] == eidx[:, None, :]).any(2).sum(1)
    mean_recall = float(hits.mean()) / k
    assert mean_recall >= recall, mean_recall
    assert (mean_recall < 1.0) == (order == "shuffled"), mean_recall
    jhits = (idx[:, :, None] == jidx[:, None, :]).any(2).sum(1)
    assert float(jhits.mean()) / k >= recall - 0.01
    # one-sided: each rank's distance at or above the exact one
    assert (d2 >= ed2).all()
    assert (np.diff(d2, axis=1) >= 0).all()
    # independent of the row chunks and of parked padding rows
    monkeypatch.setattr(knnlib, "_BINNED", 1000 * m)
    i2, e2 = knnlib.knn(_t(pts), _t(valid), k, selector=sel)
    np.testing.assert_array_equal(i2.numpy(), idx)
    np.testing.assert_array_equal(e2.numpy(), d2)
    pad = np.concatenate([pts, np.full((1500, 3), FAR, np.float32)])
    i3, e3 = knnlib.knn(_t(pad), _t(np.arange(len(pad)) < n), k, selector=sel)
    np.testing.assert_array_equal(i3.numpy()[:n], idx)
    np.testing.assert_array_equal(e3.numpy()[:n], d2)


def test_binmin_bins_follow_the_recall_model():
    assert kernels.binmin_bins(10 ** 6, 16, 0.99) == 2048
    assert kernels.binmin_bins(10 ** 6, 32, 0.95) == 1024
    assert kernels.binmin_bins(10 ** 6, 30, 0.99) == 4096
    assert kernels.binmin_bins(10 ** 6, 16, 1.0) == 10 ** 6
    assert kernels.binmin_bins(500, 16, 0.99) == 500      # capped: exact
    assert kernels.binmin_bins(10 ** 6, 1, 0.5) == kernels.BINMIN_MIN_BINS
    for k, r in ((16, 0.99), (32, 0.95), (30, 0.99), (20, 0.99)):
        m = kernels.binmin_bins(10 ** 6, k, r)
        assert (1 - 1 / m) ** (k - 1) >= r
    with pytest.raises(ValueError):
        kernels.binmin_bins(100, 4, 0.0)


def test_knn_binmin_plain_bins_and_ties():
    """Each bin's least (d2, column), self at +inf, ties to the lowest
    column, (+inf, b) for a bin holding only the row itself."""
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 0, 0], [5, 5, 5]], np.float32)
    d2, idx = kernels.knn_binmin(_t(pts), torch.arange(5, dtype=torch.int32), 2)
    # bin 0 holds columns 0, 2, 4; bin 1 columns 1, 3 (equal points: 1 wins)
    np.testing.assert_array_equal(idx.numpy(), [[2, 1], [0, 3], [0, 1], [0, 1], [2, 1]])
    assert np.isinf(d2.numpy()[1, 1]) is np.False_ and d2.numpy()[1, 1] == 0.0
    d2, idx = kernels.knn_binmin(_t(pts), torch.arange(5, dtype=torch.int32), 5)
    assert np.isinf(d2.numpy()[np.arange(5), np.arange(5)]).all()
    np.testing.assert_array_equal(idx.numpy()[np.arange(5), np.arange(5)], np.arange(5))
    d2, idx = kernels.knn_binmin(_t(pts), torch.arange(5, dtype=torch.int32), 5,
                                 exclude_self=False)
    assert (d2.numpy()[np.arange(5), np.arange(5)] == 0).all()


def _slab(n=12_000):
    """A 160 x 16 x 4 mm slab about the origin: the JAX engine selects on
    the f32 expansion, whose rounding grows with |q|^2."""
    rng = np.random.default_rng(21)
    return (rng.uniform(-0.5, 0.5, (n, 3)) * np.array([160.0, 16.0, 4.0])).astype(np.float32)


@pytest.mark.parametrize("selector", ["topk", "tournament", "iter", "approx1", "nosel"])
def test_slab_topk_engine_selectors_match_jax(selector):
    pts = _slab()
    valid = np.ones(len(pts), bool)
    valid[::97] = False
    cell, k, tile, window = 0.6, 20, 128, 1024
    md = pc._voxelized_knn_mean_dist(_t(pts), _t(valid), cell, k, tile=tile, window=window,
                                     selector=selector).numpy()
    jmd = np.asarray(jpc._voxelized_knn_mean_dist(
        jnp.asarray(pts), jnp.asarray(valid), jnp.float32(cell), k, tile=tile,
        window=window, selector=selector))
    ours, theirs = np.isfinite(md), np.isfinite(jmd)
    assert not ours[~valid].any()
    if selector == "nosel":
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_allclose(md[ours], jmd[ours], rtol=1e-6)
        return
    assert ours.mean() > 0.8
    both = ours & theirs
    np.testing.assert_allclose(md[both], jmd[both], rtol=1e-4)
    # a row certified by one package only: its k-th distance is a near-tie with r^2
    r2 = np.float32(4.0 * cell) ** 2
    ref = jknn.kdtree_distances_rows(pts, valid, np.flatnonzero(ours ^ theirs), k)
    assert (np.abs(ref[:, -1] ** 2 - r2) <= 1e-3 * r2).all()
    # the selected neighbours are the exact ones
    rows = np.flatnonzero(ours)[::50]
    exact = jknn.kdtree_distances_rows(pts, valid, rows, k).mean(1)
    np.testing.assert_allclose(md[rows], exact, rtol=1e-5)


def test_slab_auto_takes_the_topk_engine_with_a_tile(monkeypatch):
    pts = _slab(6000)
    valid = np.ones(len(pts), bool)
    seen = []
    real = pc._slab_topk_engine
    monkeypatch.setattr(pc, "_slab_topk_engine",
                        lambda *a: seen.append(a[-1]) or real(*a))
    pc._voxelized_knn_mean_dist(_t(pts), _t(valid), 1.0, 8, tile=128)
    assert seen == ["topk"]
    with pytest.raises(ValueError):
        pc._voxelized_knn_mean_dist(_t(pts), _t(valid), 1.0, 8, selector="sorted")


def test_statistical_outlier_mask_host_arm_matches_jax():
    rng = np.random.default_rng(9)
    pts = np.concatenate([rng.normal(0, 20, (34_000, 3)),
                          rng.uniform(-200, 200, (500, 3))]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[::13] = False
    assert len(pts) > pc.DENSE_MAX
    m = pc.statistical_outlier_mask(_t(pts), _t(valid), 20, 2.0, voxelized_cell=1.0)
    jm = np.asarray(jpc.statistical_outlier_mask(jnp.asarray(pts), jnp.asarray(valid), 20,
                                                 2.0))
    np.testing.assert_array_equal(m.numpy(), jm)
    assert 30_000 < m.numpy().sum() < valid.sum()


def _scene_cloud(seed=0):
    """A floor, a sphere, a near blob, scattered outliers (~3,400 rows),
    padded to a 2048 bucket; compact, so the grid's density cell stays
    small."""
    rng = np.random.default_rng(seed)
    floor = np.c_[rng.uniform(-35, 35, (2000, 2)), rng.normal(0, 0.3, 2000)]
    d = rng.normal(size=(1100, 3))
    obj = 14 * d / np.linalg.norm(d, axis=1, keepdims=True) + (0, 0, 18)
    extra = np.concatenate([rng.normal((45, 0, 8), 2.0, (250, 3)),
                            rng.uniform(-45, 45, (30, 3))])
    pts = np.concatenate([floor, obj, extra]).astype(np.float32)
    n = len(pts)
    bucket = -(-n // 2048) * 2048
    pad = np.full((bucket, 3), FAR, np.float32)
    pad[:n] = pts
    return pad, np.arange(bucket) < n


def _jax_draws(valid, trials):
    probs = jnp.asarray(valid, jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return np.asarray(jax.random.choice(jax.random.PRNGKey(0), len(valid),
                                        shape=(trials, 3), p=probs))


def test_clean_chain_above_the_brute_ceiling_matches_jax(monkeypatch):
    monkeypatch.setattr(knnlib, "_BRUTE_MAX", 2048)
    monkeypatch.setattr(jknn, "_BRUTE_MAX", 2048)
    pts, valid = _scene_cloud()
    assert len(pts) > 2048
    jcfg, cfg = jconfig.CleanConfig(), config.CleanConfig()
    for c in (jcfg, cfg):
        c.plane_ransac_trials = 128
        c.cluster_eps, c.cluster_min_points = 4.0, 10
        c.radius, c.radius_nb_points = 4.0, 6
    calls = []
    real = gridlib.grid_knn
    monkeypatch.setattr(gridlib, "grid_knn", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _, c_j = jpc.clean_chain(jnp.asarray(pts), jnp.asarray(valid), jcfg)
    _, c_t = pc.clean_chain(_t(pts), _t(valid), cfg, samples=_jax_draws(valid, 128))
    c_j, c_t = np.asarray(c_j), c_t.numpy()
    assert calls                                      # the cluster step took the grid
    np.testing.assert_array_equal(c_t[:3], c_j[:3])
    assert abs(int(c_t[3]) - int(c_j[3])) <= 0.005 * c_j[3], (c_t, c_j)
    assert valid.sum() > c_t[0] > c_t[1] > c_t[2] >= c_t[3] > 800, c_t


_CPU, _CUDA = torch.device("cpu"), torch.device("cuda")
_KNN_TABLE = [
    # device, N, exact, selector -> engine
    (_CPU, 65_536, False, "topk", "exact"), (_CUDA, 65_536, False, "topk", "exact"),
    (_CPU, 65_536, False, "approx:0.95", "binned"),
    (_CUDA, 65_536, False, "approx:0.95", "binned"),
    (_CPU, 65_537, True, "topk", "exact"), (_CUDA, 1_061_700, True, "topk", "exact"),
    (_CUDA, 1_061_700, True, "approx:0.9", "binned"),
    (_CPU, 65_537, False, "topk", "grid"), (_CPU, 65_537, False, "approx:0.95", "grid"),
    (_CUDA, 65_537, False, "topk", "dense_approx"),
    (_CUDA, 1_061_700, False, "approx:0.95", "dense_approx"),
]


@pytest.mark.parametrize("dev,n,exact,selector,engine", _KNN_TABLE)
def test_knn_dispatch_table(dev, n, exact, selector, engine):
    assert knnlib._knn_engine(dev, n, exact, selector) == engine


@pytest.mark.parametrize("n,exact,selector,engine", [
    (2000, False, "topk", "exact"), (2000, False, "approx:0.99", "binned"),
    (3000, True, "topk", "exact"), (3000, False, "topk", "grid")])
def test_knn_takes_the_engine_of_the_table_on_the_cpu(n, exact, selector, engine,
                                                      monkeypatch):
    monkeypatch.setattr(knnlib, "_BRUTE_MAX", 2048)
    taken = []
    for name, mod in (("exact", knnlib), ("binned", knnlib), ("grid", gridlib)):
        attr = {"exact": "_knn_exact", "binned": "_knn_binned", "grid": "grid_knn"}[name]
        real = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, lambda *a, _n=name, _r=real, **kw:
                            taken.append(_n) or _r(*a, **kw))
    pts = _big_cloud(n)
    idx, d2 = knnlib.knn(_t(pts), _t(np.ones(n, bool)), 8, exact=exact, selector=selector)
    assert taken == [engine] and idx.shape == (n, 8) and d2.shape == (n, 8)
    if engine == "grid":   # the JAX package's host engine, its cell and rings
        monkeypatch.setattr(jknn, "_BRUTE_MAX", 2048)
        jidx, jd2 = jknn.knn(jnp.asarray(pts), jnp.ones(n, bool), 8)
        np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dev,n,engine", [
    (_CPU, 65_536, "kernel"), (_CPU, 65_537, "grid"), (_CUDA, 65_536, "kernel"),
    (_CUDA, 1_061_700, "kernel")])
def test_radius_count_dispatch_table(dev, n, engine):
    assert knnlib._radius_engine(dev, n) == engine


@pytest.mark.parametrize("dev,n,approximate,cell,engine", [
    (_CPU, 32_768, False, None, "engine"), (_CPU, 32_769, False, 1.0, "host_twin"),
    (_CPU, 32_769, True, None, "host_twin"), (_CUDA, 32_769, False, None, "engine"),
    (_CUDA, 1_061_700, False, 0.5, "engine"), (_CUDA, 1_061_700, True, 0.5, "engine"),
    (_CUDA, 1_061_700, True, None, "knn"), (_CUDA, 2000, True, None, "engine"),
    (_CPU, 2000, True, None, "engine")])
def test_statistical_outlier_dispatch_table(dev, n, approximate, cell, engine):
    assert pc._stat_engine(dev, n, approximate, cell) == engine


def test_feat_knn_selector(monkeypatch):
    monkeypatch.delenv("SLSCAN_FEAT_EXACT", raising=False)
    assert rec._feat_knn_selector(_CPU) == "topk"
    assert rec._feat_knn_selector(_CUDA) == "approx:0.95"
    monkeypatch.setenv("SLSCAN_FEAT_EXACT", "1")
    assert rec._feat_knn_selector(_CUDA) == "topk"
    assert rec._feat_knn_selector(_CPU) == "topk"
