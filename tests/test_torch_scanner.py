"""SLScanner of the PyTorch port against the JAX SLScanner, on the CPU.

The same seeded numpy frames go through both. Tolerances:
  - table and packed paths: valid masks exactly equal, points within
    1e-3 mm (the JAX jit's FMA contraction is 1-2 ULP; the JAX package's
    own contract, tests/test_synthetic_e2e.py);
  - the fused decode+triangulate kernel (here its plain version, which the
    CPU runs) against the JAX jnp quadratic path and the Pallas fused kernel
    in interpret mode: at most 2e-3 of valid flags flipped by borderline
    compares, |dp| < 1e-2 mm where both are valid, texture equal — the
    tolerances of tests/test_pallas_kernels.py.
No matrix products are involved, so TF32 plays no part.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.io import images as jimio
from structured_light_for_3d_model_replication_tpu.models.scanner import (
    SLScanner as JaxScanner,
)
from structured_light_for_3d_model_replication_tpu.ops import pallas_kernels as pk
from structured_light_for_3d_model_replication_tpu_torch.models import scanner as sm
from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc
from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

CAM = PROJ = (256, 64)


def _views(cam, proj, n=2, downsample=1):
    rig = syn.default_rig(cam_size=cam, proj_size=proj)
    frames, _ = syn.render_scene(rig, syn.sphere_on_background(),
                                 downsample=downsample)
    views = []
    for v in range(n):
        noise = np.random.default_rng(100 + v).integers(-8, 9, frames.shape)
        views.append(np.clip(frames.astype(np.int16) + noise, 0, 255).astype(np.uint8))
    return rig, np.stack(views)


@pytest.fixture(scope="module")
def scene():
    return _views(CAM, PROJ)


def _scanners(rig, plane_eval, **kw):
    calib = rig.calibration()
    port = sm.SLScanner(calib, CAM, PROJ, plane_eval=plane_eval, device="cpu", **kw)
    ref = JaxScanner(calib, CAM, PROJ, plane_eval=plane_eval, **kw)
    return port, ref


def _assert_exact(port, ref):
    v_port, v_ref = port.valid.numpy(), np.asarray(ref.valid)
    np.testing.assert_array_equal(v_port, v_ref)
    assert v_port.sum() > 1000
    diff = np.abs(port.points.numpy()[v_port] - np.asarray(ref.points)[v_ref])
    assert diff.max() <= 1e-3, diff.max()
    np.testing.assert_array_equal(port.colors.numpy(), np.asarray(ref.colors))


def _assert_fused_tolerance(pts, valid, tex, ref_pts, ref_valid, ref_tex):
    assert (valid != ref_valid).mean() < 2e-3
    both = valid & ref_valid
    assert both.sum() > 1000
    err = np.abs(pts[both] - ref_pts[both])
    assert err.max() < 1e-2, err.max()
    np.testing.assert_array_equal(tex, ref_tex)


@pytest.mark.parametrize("row_mode", [0, 1, 2])
def test_forward_views_table_matches_jax(scene, row_mode):
    rig, frames_v = scene
    port, ref = _scanners(rig, "table", row_mode=row_mode)
    kw = dict(thresh_mode="manual", shadow_val=40.0, contrast_val=10.0)
    _assert_exact(port.forward_views(frames_v, **kw),
                  ref.forward_views(jnp.asarray(frames_v), **kw))


def test_forward_views_quadratic_matches_jax(scene):
    rig, frames_v = scene
    port, ref = _scanners(rig, "quadratic", row_mode=1)
    assert port._fuse_capable(torch.from_numpy(frames_v))
    kernels.reset_launch_counts()
    out = port.forward_views(frames_v, thresh_mode="otsu")
    r = ref.forward_views(jnp.asarray(frames_v), thresh_mode="otsu")
    _assert_fused_tolerance(out.points.numpy(), out.valid.numpy(),
                            out.colors.numpy(), np.asarray(r.points),
                            np.asarray(r.valid), np.asarray(r.colors))
    # the unfused route (decode + quadratic triangulate) agrees as well
    unfused = port.forward_views(frames_v, thresh_mode="otsu", use_fused=False)
    _assert_fused_tolerance(unfused.points.numpy(), unfused.valid.numpy(),
                            unfused.colors.numpy(), np.asarray(r.points),
                            np.asarray(r.valid), np.asarray(r.colors))


def test_forward_views_packed_matches_jax(scene):
    rig, frames_v = scene
    port, ref = _scanners(rig, "table", row_mode=1)
    stacks = [jimio.pack_stack(f) for f in frames_v]
    planes = np.stack([s.planes for s in stacks])
    white = np.stack([s.white for s in stacks])
    black = np.stack([s.black for s in stacks])
    n = stacks[0].n_frames
    out = port.forward_views_packed(planes, white, black, n_frames=n)
    _assert_exact(out, ref.forward_views_packed(
        jnp.asarray(planes), jnp.asarray(white), jnp.asarray(black), n_frames=n))
    # packed ingest is bit-identical to raw ingest
    raw = port.forward_views(frames_v, use_fused=False)
    for a, b in zip(out, raw):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cam,row_mode,downsample,n_sets", [
    ((256, 64), 1, 1, (11, 11)),
    ((200, 60), 1, 1, (11, 11)),      # unaligned: no (8, 128) tiling needed
    ((256, 64), 0, 2, (7, 5)),
])
def test_fused_plain_matches_pallas_interpret(cam, row_mode, downsample, n_sets):
    rig, frames_v = _views(cam, (256, 64), n=2, downsample=downsample)
    sc = sm.SLScanner(rig.calibration(), cam, (256, 64), row_mode=row_mode,
                      plane_eval="quadratic", n_sets_col=n_sets[0],
                      n_sets_row=n_sets[1], downsample=downsample, device="cpu")
    thr = np.array([[40.0, 10.0], [44.0, 12.0]], np.float32)
    plan = gc.decode_plan(frames_v.shape[1], n_cols=256, n_rows=64,
                          n_sets_col=n_sets[0], n_sets_row=n_sets[1],
                          downsample=downsample)
    pts, valid, tex = kernels.scan_fused(
        torch.from_numpy(frames_v), torch.from_numpy(thr),
        kernels.scan_scalars(sc.oc, sc.poly_col, sc.poly_row, sc.epipolar_tol),
        sc.rays, n_bits_col=plan.n_bits_col, n_bits_row=plan.n_bits_row,
        n_use_col=plan.n_use_col, n_use_row=plan.n_use_row, n_cols=256,
        n_rows=64, row_mode=row_mode, downsample=downsample)
    h, w = cam[1], cam[0]
    rp, rv, rt = pk.scan_points_fused_views(
        jnp.asarray(frames_v), thr, sc.rays.numpy().reshape(h, w, 3),
        sc.oc.numpy(), sc.poly_col.numpy(), sc.poly_row.numpy(),
        sc.epipolar_tol, n_cols=256, n_rows=64, n_use_col=n_sets[0],
        n_use_row=n_sets[1], row_mode=row_mode, downsample=downsample,
        interpret=True)
    _assert_fused_tolerance(pts.numpy(), valid.numpy(), tex.numpy(),
                            np.asarray(rp), np.asarray(rv), np.asarray(rt))


def test_state_from_reference_round_trip(scene):
    rig, frames_v = scene
    port, ref = _scanners(rig, "quadratic", row_mode=1)
    arrays = {k: np.asarray(getattr(ref, k)) for k in sm.BUFFERS}
    state = sm.state_from_reference(arrays)
    assert set(state) == set(port.state_dict())
    # a scanner built from another calibration computes the reference's
    # numbers once it carries the reference's tensors
    other = syn.default_rig(cam_size=CAM, proj_size=PROJ)
    other.T = other.T + np.array([5.0, 0.0, 0.0])
    fresh = sm.SLScanner(other.calibration(), CAM, PROJ, plane_eval="quadratic",
                         device="cpu")
    fresh.load_state_dict(state)
    for k in sm.BUFFERS:
        np.testing.assert_array_equal(getattr(fresh, k).numpy(), arrays[k])
    a = fresh.forward_views(frames_v, thresh_mode="manual")
    b = port.forward_views(frames_v, thresh_mode="manual")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(KeyError):
        sm.state_from_reference({"rays": arrays["rays"]})


def test_forward_single_view_equals_forward_views(scene):
    rig, frames_v = scene
    port, _ = _scanners(rig, "table", row_mode=1)
    one = port.forward(frames_v[1], thresh_mode="manual")
    many = port.forward_views(frames_v, thresh_mode="manual")
    for a, b in zip(one, many):
        assert torch.equal(a, b[1])
    with pytest.raises(ValueError, match="use_fused=True"):
        port.forward_views(frames_v, use_fused=True)


def test_device_none_without_cuda_raises(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sm.SLScanner(scene[0].calibration(), CAM, PROJ)


def test_cpu_tensors_never_count_a_launch(scene):
    rig, frames_v = scene
    kernels.reset_launch_counts()
    for plane_eval in ("table", "quadratic"):
        port, _ = _scanners(rig, plane_eval, row_mode=1)
        port.forward_views(frames_v)
    ps = [jimio.pack_stack(f) for f in frames_v]
    port.forward_views_packed(np.stack([s.planes for s in ps]),
                              np.stack([s.white for s in ps]),
                              np.stack([s.black for s in ps]),
                              n_frames=ps[0].n_frames)
    counts = kernels.launch_counts()
    assert set(counts) >= {"decode_maps", "decode_packed_maps", "scan_fused"}
    assert not any(counts.values()), counts


def test_wrappers_refuse_other_devices():
    frames = torch.zeros((1, 46, 8, 8), dtype=torch.uint8, device="meta")
    thr = torch.zeros((1, 2), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        kernels.decode_maps(frames, thr, n_bits_col=11, n_bits_row=11,
                            n_use_col=11, n_use_row=11)
    with pytest.raises(ValueError, match="different devices"):
        kernels.decode_maps(torch.zeros((1, 46, 8, 8), dtype=torch.uint8), thr,
                            n_bits_col=11, n_bits_row=11, n_use_col=11,
                            n_use_row=11)
