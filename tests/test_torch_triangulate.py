"""Triangulation and calibration geometry of the PyTorch port against the
JAX package, on the CPU.

Tolerances are the JAX package's own contract (tests/test_synthetic_e2e.py):
validity masks exactly equal and points within 1e-3 mm against the numpy
table path — both sides run float32 in the same operation order, the JAX
jit may contract multiply-adds into FMAs (1-2 ULP). The quadratic path is
held to the JAX jitted quadratic path with the fused-kernel tolerances of
tests/test_pallas_kernels.py (at most 2e-3 of masks flipped by a
borderline compare, |dp| < 1e-2 mm where both are valid). No matrix
products are involved, so TF32 plays no part.
"""
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.calib import geometry as jgeo
from structured_light_for_3d_model_replication_tpu.ops import graycode as jgc
from structured_light_for_3d_model_replication_tpu.ops import triangulate as jtri
from structured_light_for_3d_model_replication_tpu.utils import synthetic as jsyn
from structured_light_for_3d_model_replication_tpu_torch.calib import geometry
from structured_light_for_3d_model_replication_tpu_torch.ops import triangulate as tri
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

CAM, PROJ = (160, 120), (128, 64)


@pytest.fixture(scope="module")
def scene():
    rig = syn.default_rig(cam_size=CAM, proj_size=PROJ)
    frames, gt = syn.render_scene(rig, syn.sphere_on_background(),
                                  noise_sigma=2.0,
                                  rng=np.random.default_rng(4))
    dec = jgc.decode_stack_np(frames, n_cols=PROJ[0], n_rows=PROJ[1],
                              thresh_mode="manual")
    return rig, rig.calibration(), frames, gt, dec


def _maps(dec):
    return (torch.from_numpy(dec.col_map), torch.from_numpy(dec.row_map),
            torch.from_numpy(dec.mask), torch.from_numpy(dec.texture))


def test_renderer_matches_reference_renderer(scene):
    rig, _, frames, gt, _ = scene
    jrig = jsyn.default_rig(cam_size=CAM, proj_size=PROJ)
    jframes, jgt = jsyn.render_scene(jrig, jsyn.sphere_on_background(),
                                     noise_sigma=2.0,
                                     rng=np.random.default_rng(4))
    np.testing.assert_array_equal(frames, jframes)
    for k in ("proj_col", "proj_row", "points", "lit"):
        np.testing.assert_array_equal(gt[k], jgt[k])


def test_pixel_rays_equal():
    K = np.array([[300.5, 0, 80.2], [0, 301.0, 59.7], [0, 0, 1]])
    port = tri.pixel_rays(K, 60, 80, device="cpu").numpy()
    ref = jtri.pixel_rays(np.asarray(K, np.float32), 60, 80, np)
    np.testing.assert_array_equal(port, ref)


def test_calibration_geometry_equal(scene):
    rig = scene[0]
    port = geometry.build_calibration(rig.cam_K, np.zeros(5), rig.proj_K, rig.R,
                                      rig.T, *CAM, *PROJ)
    ref = jgeo.build_calibration(rig.cam_K, np.zeros(5), rig.proj_K, rig.R,
                                 rig.T, *CAM, *PROJ)
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    for a, b in zip(geometry.plane_poly_coefficients(rig.proj_K, rig.R, rig.T, *PROJ),
                    jgeo.plane_poly_coefficients(rig.proj_K, rig.R, rig.T, *PROJ)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("row_mode", [0, 1, 2])
def test_table_path_matches_numpy(scene, row_mode):
    _, calib, _, _, dec = scene
    port = tri.triangulate(*_maps(dec), calib, row_mode=row_mode,
                           plane_eval="table")
    ref = jtri.triangulate_np(dec.col_map, dec.row_map, dec.mask, dec.texture,
                              calib, row_mode=row_mode, plane_eval="table")
    valid = port.valid.numpy()
    np.testing.assert_array_equal(valid, ref.valid)
    assert valid.sum() > 1000
    diff = np.abs(port.points.numpy()[valid] - ref.points[valid])
    assert diff.max() <= 1e-3, diff.max()
    np.testing.assert_array_equal(port.colors.numpy(), ref.colors)


@pytest.mark.parametrize("row_mode", [0, 1, 2])
def test_quadratic_path_matches_jax(scene, row_mode):
    _, calib, _, _, dec = scene
    port = tri.triangulate(*_maps(dec), calib, row_mode=row_mode,
                           plane_eval="quadratic")
    ref = jtri.triangulate(dec.col_map, dec.row_map, dec.mask, dec.texture,
                           calib, row_mode=row_mode, plane_eval="quadratic")
    v_port, v_ref = port.valid.numpy(), np.asarray(ref.valid)
    assert (v_port != v_ref).mean() < 2e-3
    both = v_port & v_ref
    assert both.sum() > 1000
    diff = np.abs(port.points.numpy()[both] - np.asarray(ref.points)[both])
    assert diff.max() < 1e-2, diff.max()


def test_compact_cloud_matches_reference(scene):
    _, calib, _, _, dec = scene
    port = tri.triangulate(*_maps(dec), calib, row_mode=1)
    gray = tri.CloudResult(port.points, port.colors[:, :1], port.valid)
    pts, cols = tri.compact_cloud(gray)
    ref = jtri.triangulate_np(dec.col_map, dec.row_map, dec.mask, dec.texture,
                              calib, row_mode=1)
    rpts, rcols = jtri.compact_cloud(jtri.CloudResult(
        ref.points, ref.colors[:, :1], ref.valid))
    assert pts.shape == rpts.shape and cols.shape == rcols.shape == (len(pts), 3)
    np.testing.assert_allclose(pts, rpts, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(cols, rcols)
