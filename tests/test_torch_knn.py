"""The port's exact k-NN (``ops/knn.knn``) against the JAX package, on ties.

Quantized clouds (integer lattices, ``%.4f`` ASCII PLYs) hold many pairs at
exactly equal distances. The JAX package's ``knn`` (``knn_brute``,
``lax.top_k``) orders neighbours by (d2, index), the lowest index first on
exact ties; so must the port. Inputs are made with numpy from a seed.
Tolerances:

- knn on a lattice: indices and distances equal on every row (integer
  coordinates make every distance exact in both packages), and equal to a
  stable argsort of the distances;
- knn on a float cloud with duplicated and invalid rows: on the valid rows,
  indices equal to a stable argsort and distances equal to the rounded
  difference distances;
- estimate_normals on a lattice plane plus a rounded blob: |n . n_jax| >=
  0.999 on every row (the same neighbourhoods, PCA in another float order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.ops import knn as jknn
from structured_light_for_3d_model_replication_tpu.ops import normals as jnrm
from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
from structured_light_for_3d_model_replication_tpu_torch.ops import normals as nrm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops crawl when other test processes hold every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stable_order(pts, valid, k):
    """(idx, d2) of the k nearest other valid rows by a stable argsort of
    the rounded difference distances ((dx*dx + dy*dy) + dz*dz)."""
    p = np.where(valid[:, None], pts, np.float32(knnlib.FAR)).astype(np.float32)
    d = (p[:, None, :] - p[None, :, :]).astype(np.float32)
    d2 = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
          + d[..., 2] * d[..., 2]).astype(np.float32)
    np.fill_diagonal(d2, np.inf)
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(d2, order, axis=1)


def test_knn_lattice_ties_match_jax():
    pts = np.random.default_rng(0).integers(0, 6, (3000, 3)).astype(np.float32)
    v = np.ones(len(pts), bool)
    idx, d2 = (a.numpy() for a in knnlib.knn(torch.from_numpy(pts), torch.from_numpy(v), 16))
    jidx, jd2 = (np.asarray(a) for a in jknn.knn(jnp.asarray(pts), jnp.asarray(v), 16))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(d2, jd2)
    sidx, sd2 = _stable_order(pts, v, 16)
    np.testing.assert_array_equal(idx, sidx)
    np.testing.assert_array_equal(d2, sd2)
    # on most rows the 16th distance is shared by rows left out: the case
    # where the choice of columns, not only their order, follows the ties
    _, d2_all = _stable_order(pts, v, len(pts) - 1)
    beyond = (d2_all == d2[:, -1:]).sum(1) > (d2 == d2[:, -1:]).sum(1)
    assert beyond.mean() > 0.5


@pytest.mark.parametrize("k", [1, 16, 40])
def test_knn_float_cloud_order_is_stable(k):
    """Duplicated rows (ties at zero and at every distance of the copy),
    invalid rows parked far away, and k beyond the tie groups."""
    rng = np.random.default_rng(k)
    pts = rng.normal(0, 20, (700, 3)).astype(np.float32)
    pts[350:] = pts[:350]
    valid = rng.random(len(pts)) > 0.1
    idx, d2 = (a.numpy() for a in knnlib.knn(torch.from_numpy(pts), torch.from_numpy(valid), k))
    sidx, sd2 = _stable_order(pts, valid, k)
    np.testing.assert_array_equal(idx[valid], sidx[valid])
    np.testing.assert_array_equal(d2[valid], sd2[valid])


def test_knn_fewer_rows_than_k():
    pts = np.random.default_rng(2).integers(0, 3, (6, 3)).astype(np.float32)
    v = np.ones(6, bool)
    idx, d2 = (a.numpy() for a in knnlib.knn(torch.from_numpy(pts), torch.from_numpy(v), 8))
    sidx, sd2 = _stable_order(pts, v, 5)
    np.testing.assert_array_equal(idx[:, :5], sidx)
    np.testing.assert_array_equal(d2[:, :5], sd2)
    assert np.isinf(d2[:, 5:]).all() and (idx[:, 6:] == 0).all()


def test_estimate_normals_on_a_quantized_cloud_match_jax():
    """A 60 x 60 lattice plane and 1,500 rounded Gaussian points above it:
    the rounding makes duplicated points and exact ties at the 30th
    neighbour, where the old tie order took other neighbourhoods."""
    rng = np.random.default_rng(1)
    gx, gy = np.meshgrid(np.arange(60), np.arange(60))
    plane = np.stack([gx.ravel(), gy.ravel(), np.zeros(3600)], 1)
    blob = np.round(rng.normal((30, 30, 8), 3.0, (1500, 3)))
    pts = np.concatenate([plane, blob]).astype(np.float32)
    v = np.ones(len(pts), bool)
    n = nrm.estimate_normals(torch.from_numpy(pts), torch.from_numpy(v), 30).numpy()
    jn = np.asarray(jnrm.estimate_normals(jnp.asarray(pts), jnp.asarray(v), 30))
    cos = np.abs((n * jn).sum(1))
    assert (cos[:3600] >= 0.999).all(), np.flatnonzero(cos[:3600] < 0.999)
    assert (cos[3600:] >= 0.999).all(), np.flatnonzero(cos[3600:] < 0.999) + 3600
