"""The port's surface meshing mode (ball-pivoting analog) against the JAX
package, on the CPU.

The cloud is ``tests/test_meshing.py:122``'s: 3000 points on a 50 mm
sphere, made with numpy from a seed (plus a ragged-chunk case and a cloud
with invalid rows). Tolerances:

- ``average_nn_distance``: within rel 1e-6 (both take exact nearest
  neighbours and a float32 mean);
- ``ball_pivot_surface`` with the same normals, and
  ``reconstruct_mesh(mode='surface')``: vertices bit-equal (they are the
  input points), the two face sets (vertex triples) differing by at most
  0.5 % of the JAX package's faces — a candidate whose circumradius or
  empty-ball distance ties its threshold within a float32 rounding may go
  either way (the count is printed); and the JAX test's own asserts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import config as jconfig
from structured_light_for_3d_model_replication_tpu.models import meshing as jmeshing
from structured_light_for_3d_model_replication_tpu.ops import normals as jnormals
from structured_light_for_3d_model_replication_tpu.ops import surface_recon as jsr
from structured_light_for_3d_model_replication_tpu_torch import config
from structured_light_for_3d_model_replication_tpu_torch.models import meshing
from structured_light_for_3d_model_replication_tpu_torch.ops import meshproc
from structured_light_for_3d_model_replication_tpu_torch.ops import surface_recon as sr

QUIET = dict(log=lambda *a: None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors beside the other test workers: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (50.0 * d).astype(np.float32)


def _face_diff(f_port, f_jax):
    a = {tuple(sorted(f)) for f in np.asarray(f_port).tolist()}
    b = {tuple(sorted(f)) for f in np.asarray(f_jax).tolist()}
    print(f"faces: port {len(a)}, JAX {len(b)}, differing {len(a ^ b)}")
    return len(a ^ b)


def test_average_nn_distance_matches_jax():
    pts = _sphere()
    valid = np.ones(len(pts), bool)
    valid[::9] = False
    got = sr.average_nn_distance(torch.from_numpy(pts), torch.from_numpy(valid))
    ref = jsr.average_nn_distance(jnp.asarray(pts), jnp.asarray(valid))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("case", ["sphere", "ragged_chunks_and_invalid_rows"])
def test_ball_pivot_surface_matches_jax(case):
    pts = _sphere()
    valid = np.ones(len(pts), bool)
    chunk = 4096
    if case != "sphere":
        valid[::13] = False
        chunk = 700
    v = jnp.asarray(valid)
    nr = jnormals.orient_normals(jnp.asarray(pts),
                                 jnormals.estimate_normals(jnp.asarray(pts), v, 20), v)
    vj, fj = jsr.ball_pivot_surface(pts, valid, nr, chunk=chunk)
    vt, ft = sr.ball_pivot_surface(torch.from_numpy(pts), torch.from_numpy(valid),
                                   torch.from_numpy(np.array(nr)), chunk=chunk)
    np.testing.assert_array_equal(vt, np.asarray(vj))
    assert ft.dtype == np.int32 and len(ft) > 1500
    assert _face_diff(ft, fj) <= 0.005 * len(fj)


def test_reconstruct_mesh_surface_mode_matches_jax():
    pts = _sphere()
    vj, fj = jmeshing.reconstruct_mesh(pts, cfg=jconfig.MeshConfig(mode="surface"), **QUIET)
    tm = {}
    vt, ft = meshing.reconstruct_mesh(pts, cfg=config.MeshConfig(mode="surface"),
                                      device="cpu", timings=tm, **QUIET)
    assert "surface_s" in tm
    np.testing.assert_array_equal(vt, np.asarray(vj))
    assert _face_diff(ft, fj) <= 0.005 * len(fj)
    # the JAX test's asserts (tests/test_meshing.py:122)
    assert len(ft) > 1500
    np.testing.assert_allclose(np.linalg.norm(vt, axis=1), 50.0, atol=1e-3)
    assert meshproc.mesh_volume(vt, ft) > 0.6 * 4 / 3 * np.pi * 50 ** 3
    with pytest.raises(ValueError, match="watertight' or 'surface"):
        meshing.reconstruct_mesh(pts, cfg=config.MeshConfig(mode="nope"), device="cpu",
                                 **QUIET)
