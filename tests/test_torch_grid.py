"""The port's grid-hash engine (``ops/grid.py``) against the JAX package's,
on the CPU.

The cloud is tests/test_grid.py's (a Gaussian blob and a uniform box, made
with numpy from seed 3), its first 6,000 rows with every 11th row invalid.
At a fixed cell (4 mm) and occupancy cap:

- ``build_grid``: the slot table, each point's bucket, the valid rows' cell
  indices, the origin and the cell equal bit for bit (the stable sort keeps
  the JAX package's slot order; the int32 hash wraps as XLA's does);
- ``grid_radius_count``: counts equal bit for bit on every valid row, also
  without self-exclusion and over 2 rings;
- ``grid_knn`` and ``grid_query_knn`` (queries in the cloud's box and far
  outside it): distances within 1e-5 mm^2 or one
  f32 rounding (rtol 1e-6: XLA may fuse or reorder the 3-term sum), indices
  equal on every valid row whose k nearest have no near-tie (distances
  closer than 1e-4 mm^2) and no tie at the cut;
- the cell-halving loop of ``build_grid`` (occupancy over the cap) and
  ``knn.radius_count``'s ring-doubling loop above the brute ceiling (lowered
  in both packages by monkeypatch): the same cell, slots and counts;
- the query entry points refuse a grid whose points lie on the card
  ("host-only"), as the JAX package's refuse an accelerator backend.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.ops import grid as jgrid
from structured_light_for_3d_model_replication_tpu.ops import knn as jknn
from structured_light_for_3d_model_replication_tpu_torch.ops import grid as gridlib
from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.normal(0, 30, (50_000, 3)),
                          rng.uniform(-60, 60, (50_000, 3))]).astype(np.float32)
    pts = pts[:6000]
    valid = np.ones(len(pts), bool)
    valid[::11] = False
    return pts, valid


@pytest.fixture(scope="module")
def grids(cloud):
    pts, valid = cloud
    return (gridlib.build_grid(torch.from_numpy(pts), torch.from_numpy(valid), 4.0),
            jgrid.build_grid(jnp.asarray(pts), jnp.asarray(valid), 4.0))


def test_build_grid_matches_jax(cloud, grids):
    _, valid = cloud
    g, jg = grids
    np.testing.assert_array_equal(g.table.numpy(), np.asarray(jg.table))
    np.testing.assert_array_equal(g.cell_of.numpy(), np.asarray(jg.cell_of))
    np.testing.assert_array_equal(g.ijk.numpy()[valid], np.asarray(jg.ijk)[valid])
    np.testing.assert_array_equal(g.origin.numpy(), np.asarray(jg.origin))
    assert float(g.cell) == float(jg.cell)
    assert g.table.shape[1] > 1


@pytest.mark.parametrize("radius,rings,exclude_self", [(3.0, 1, True), (3.0, 1, False),
                                                       (7.5, 2, True)])
def test_grid_radius_count_matches_jax(cloud, grids, radius, rings, exclude_self):
    _, valid = cloud
    g, jg = grids
    c = gridlib.grid_radius_count(g, radius, exclude_self, rings=rings).numpy()
    jc = np.asarray(jgrid.grid_radius_count(jg, radius, exclude_self, rings=rings))
    np.testing.assert_array_equal(c[valid], jc[valid])
    assert c[valid].mean() > 0.5


def _same_off_ties(idx, d2, jidx, rows):
    """Indices equal on the rows with no near-tie among the k and the next."""
    gaps = np.diff(d2, axis=1)
    clean = rows & (gaps > 1e-4).all(1)
    assert clean.mean() > 0.5 * rows.mean()
    np.testing.assert_array_equal(idx[clean], jidx[clean])


@pytest.mark.parametrize("k,rings", [(8, 1), (16, 2)])
def test_grid_knn_matches_jax(cloud, grids, k, rings):
    _, valid = cloud
    g, jg = grids
    idx, d2 = (a.numpy() for a in gridlib.grid_knn(g, k, rings=rings))
    jidx, jd2 = (np.asarray(a) for a in jgrid.grid_knn(jg, k, rings=rings))
    np.testing.assert_allclose(d2[valid], jd2[valid], rtol=1e-6, atol=1e-5)
    assert np.isfinite(d2[valid]).mean() > 0.9
    _same_off_ties(idx, np.where(np.isfinite(d2), d2, 1e30), jidx, valid)


def test_grid_query_knn_matches_jax(cloud, grids):
    g, jg = grids
    rng = np.random.default_rng(4)
    q = np.concatenate([rng.uniform(-70, 70, (2900, 3)),
                        rng.uniform(150, 300, (100, 3))]).astype(np.float32)
    idx, d2 = (a.numpy() for a in gridlib.grid_query_knn(g, torch.from_numpy(q), 4, rings=2))
    jidx, jd2 = (np.asarray(a) for a in jgrid.grid_query_knn(jg, jnp.asarray(q), 4, rings=2))
    np.testing.assert_allclose(d2, jd2, rtol=1e-6, atol=1e-5)
    # far queries see only what hash collisions bring: both packages the same
    fin = np.isfinite(d2).all(1)
    assert fin[:2900].mean() > 0.9
    _same_off_ties(idx, np.where(np.isfinite(d2), d2, 1e30), jidx, fin)


def test_build_grid_halves_the_cell_over_the_occupancy_cap(cloud):
    pts, valid = cloud
    g = gridlib.build_grid(torch.from_numpy(pts), torch.from_numpy(valid), 20.0, occ_cap=24)
    jg = jgrid.build_grid(jnp.asarray(pts), jnp.asarray(valid), 20.0, occ_cap=24)
    assert float(g.cell) == float(jg.cell) < 20.0
    np.testing.assert_array_equal(g.table.numpy(), np.asarray(jg.table))
    assert gridlib.max_occupancy(torch.from_numpy(pts), torch.from_numpy(valid), 20.0) == \
        int(jgrid._max_occupancy(jnp.asarray(pts), jnp.asarray(valid), jnp.float32(20.0)))


def test_radius_count_above_the_brute_ceiling_takes_the_grid(cloud, monkeypatch):
    """A dense core (occupancy over 128 at cell = r): the cell halves and
    the rings double in both packages; counts equal bit for bit."""
    pts, valid = cloud
    core = np.random.default_rng(7).normal(0, 3.0, (1400, 3)).astype(np.float32)
    p = np.concatenate([pts[:3000], core])
    v = np.concatenate([valid[:3000], np.ones(1400, bool)])
    monkeypatch.setattr(knnlib, "_BRUTE_MAX", 2048)
    monkeypatch.setattr(jknn, "_BRUTE_MAX", 2048)
    occ = [gridlib.max_occupancy(torch.from_numpy(p), torch.from_numpy(v), c) for c in (4.0, 2.0)]
    assert occ[0] > 128 >= occ[1]
    c = knnlib.radius_count(torch.from_numpy(p), torch.from_numpy(v), 4.0).numpy()
    jc = np.asarray(jknn.radius_count(jnp.asarray(p), jnp.asarray(v), 4.0))
    np.testing.assert_array_equal(c[v], jc[v])
    exact = knnlib.radius_count_np(p, v, 4.0)
    assert (c[v] == exact[v]).mean() > 0.99


@pytest.mark.parametrize("call", [
    lambda g: gridlib.grid_knn(g, 8),
    lambda g: gridlib.grid_radius_count(g, 4.0),
    lambda g: gridlib.grid_query_knn(g, torch.zeros((4, 3)), 1)])
def test_grid_queries_are_host_only(grids, call):
    on_card = grids[0]._replace(points=types.SimpleNamespace(
        device=torch.device("cuda"), shape=grids[0].points.shape))
    with pytest.raises(RuntimeError, match="host-only"):
        call(on_card)
