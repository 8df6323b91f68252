"""The device-resident clean handoff (``pipeline.fused_clean``) on the CPU.

``ops/fused_view.fused_clean_views`` and ``recon.prep_view_device`` against
the JAX package's and against the port's own discrete path, and
``run_pipeline`` with the fused drain on and off. Tolerances:

- ``fused_clean_views`` on a seeded batch of three views (valid slots
  scattered over 8192, garbage in the invalid slots; one view too small for
  the cluster step, so the chain aborts at zero): against the JAX
  package's, the counts exact, the colours equal and the points within
  1e-3 mm; against the port's discrete drain (host masking, then
  ``_clean_arrays``), the same bytes and the same clean counts;
- ``prep_view_device`` on a cleaned view's device buffer: bit-identical to
  the port's ``prep_view`` on its host points; against the JAX package's
  ``prep_view_device``, the valid masks equal, the points within 1e-3 mm,
  features within 1e-4 on >= 99 % of rows (``tests/test_torch_merge.py``'s
  rule for ``prep_view``);
- ``run_pipeline`` on four views of the pipeline scene at compute_batch 3
  (a ragged tail), fused on and off: the view PLYs, ``merged.ply`` and
  ``model.stl`` byte-identical, and the cloud path (device<->host bytes
  less the frame uploads) at least 3x fewer bytes with the fused drain
  (the JAX package's bar, tests/test_fused_view.py:152-182);
- a ``clean.fused`` fault injected on one view of a fused batch: the batch
  re-runs per view, that view alone is quarantined and the others' bytes
  are the fault-free run's;
- a fused drain that fails without an injected fault: on the CPU the batch
  re-runs per view and every view is written; on the card the run raises.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.config import Config as JConfig
from structured_light_for_3d_model_replication_tpu.models import reconstruction as jrec
from structured_light_for_3d_model_replication_tpu.ops import fused_view as jfv
from structured_light_for_3d_model_replication_tpu_torch.config import Config, load_config
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import matfile
from structured_light_for_3d_model_replication_tpu_torch.models import reconstruction as rec
from structured_light_for_3d_model_replication_tpu_torch.models.scanner import SLScanner
from structured_light_for_3d_model_replication_tpu_torch.ops import fused_view as fv
from structured_light_for_3d_model_replication_tpu_torch.ops import triangulate as tri
from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
from structured_light_for_3d_model_replication_tpu_torch.utils import faults
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

SLOTS = 8192
CHAIN = ("cluster", "radius", "statistical")   # no random draws: equal across packages
VIEWS = 4
STEP_DEG = 15.0
OVERRIDES = {"decode.n_cols": "128", "decode.n_rows": "64", "decode.thresh_mode": "manual",
             "mesh.depth": "5", "merge.voxel_size": "2.0", "merge.icp_iters": "10",
             "merge.ransac_trials": "512", "merge.pair_batch": "2",
             "parallel.io_workers": "2", "parallel.compute_batch": "3", "pipeline.write_view_plys": "true",
             "clean.cluster_eps": "8.0", "clean.cluster_min_points": "10",
             "clean.radius": "8.0", "clean.radius_nb_points": "6"}
OUTPUTS = ("merged.ply", "model.stl")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors beside the other test workers: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_fault_plan():
    yield
    faults.reset()


def _scaled(c):
    c.cluster_eps, c.cluster_min_points = 5.0, 10
    c.radius, c.radius_nb_points = 5.0, 6
    return c


def _view(rng, n_surface: int, seed: int):
    """One side of a lumpy surface (``synthetic.lumpy_views``: the front 65 %
    of ``tests/test_torch_merge.py``'s object at its point spacing, 0.05 mm
    noise), a blob beside it and scattered outliers."""
    surface = syn.lumpy_views([(np.eye(3), np.zeros(3))], n_points=n_surface, radius=40.0,
                              center=(0.0, 0.0, 0.0), seed=seed)[0] if n_surface >= 8 else \
        rng.uniform(-50, 50, (n_surface, 3))
    blob = rng.normal((120, 0, 0), 2.5, (n_surface // 8, 3))
    out = rng.uniform(-80, 80, (n_surface // 30, 3))
    return np.concatenate([surface, blob, out]).astype(np.float32)


@pytest.fixture(scope="module")
def batch():
    """[3, SLOTS] decode-like output: each view's points scattered over the
    slots in a seeded order, garbage in the invalid slots."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1e3, 1e3, (3, SLOTS, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (3, SLOTS, 1)).astype(np.uint8)
    valid = np.zeros((3, SLOTS), bool)
    for j, n_surface in enumerate((4000, 1500, 4)):   # the last: too few for a cluster
        cloud = _view(rng, n_surface, seed=j)
        slots = np.sort(rng.choice(SLOTS, len(cloud), replace=False))
        pts[j, slots], valid[j, slots] = cloud, True
    return pts, cols, valid


@pytest.fixture(scope="module")
def fused(batch):
    pts, cols, valid = batch
    cfg = _scaled(Config().clean)
    return fv.fused_clean_views(torch.from_numpy(pts), torch.from_numpy(cols),
                                torch.from_numpy(valid), cfg, CHAIN)


def test_fused_clean_views_matches_the_jax_package(batch, fused):
    pts, cols, valid = batch
    jviews, _, _ = jfv.fused_clean_views(jnp.asarray(pts), jnp.asarray(cols),
                                         jnp.asarray(valid), _scaled(JConfig().clean), CHAIN)
    views, d2h, _ = fused
    assert d2h > 0 and [v.count for v in views][2] == 0
    for v, jv in zip(views, jviews):
        assert v.count == jv.count and v.points.shape == jv.points.shape
        np.testing.assert_array_equal(v.colors, jv.colors)
        np.testing.assert_allclose(v.points, jv.points, rtol=0, atol=1e-3)
    assert views[0].count > 2000 and views[1].count > 100


def test_fused_clean_views_equals_the_discrete_drain(batch, fused):
    pts, cols, valid = batch
    cfg = Config()
    _scaled(cfg.clean)
    views, _, _ = fused
    for j, v in enumerate(views):
        p, c = tri.compact_cloud(tri.CloudResult(torch.from_numpy(pts[j]),
                                                 torch.from_numpy(cols[j]),
                                                 torch.from_numpy(valid[j])))
        p, c, counts = stages._clean_arrays(p, c, cfg, CHAIN, device="cpu")
        assert v.counts == counts
        assert v.points.tobytes() == p.tobytes() and v.colors.tobytes() == c.tobytes()
        assert torch.equal(v.dev_points[:v.count], torch.from_numpy(p))
    assert views[2].counts == {"input": 4, "cluster": 0}


def test_prep_view_device_is_prep_view_and_matches_the_jax_package(batch, fused):
    views, _, _ = fused
    v = views[0]
    got = rec.prep_view_device(v.dev_points, v.count, 2.0)
    want = rec.prep_view(v.points, 2.0, device="cpu")
    for a, b in zip((got.points, got.valid, got.normals, got.features),
                    (want.points, want.valid, want.normals, want.features)):
        assert a.shape == b.shape and torch.equal(a, b)
    pts, cols, valid = batch
    jv = jfv.fused_clean_views(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid),
                               _scaled(JConfig().clean), CHAIN)[0][0]
    jp = jrec.prep_view_device(jv.dev_points, jv.count, 2.0)
    vm = np.asarray(jp.valid)
    np.testing.assert_array_equal(got.valid.numpy(), vm)
    np.testing.assert_allclose(got.points.numpy()[vm], np.asarray(jp.points)[vm], atol=1e-3)
    close = np.abs(got.features.numpy() - np.asarray(jp.features)).max(axis=1)[vm] <= 1e-4
    assert close.mean() >= 0.99


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("fused_ds")
    rig, scene, poses = syn.pipeline_scene(cam_size=(160, 120), proj_size=(128, 64),
                                           n_views=VIEWS, step_deg=STEP_DEG)
    for i, (R, t) in enumerate(poses):
        frames, _ = syn.render_scene(rig, scene.transformed(R, t))
        imio.save_packed_stack(str(root / "scans" / f"view_{round(i * STEP_DEG):03d}deg"),
                               imio.pack_stack(frames))
    matfile.save_calibration(str(root / "calib.npz"), rig.calibration())
    return root


def _pipeline(root, out, **extra):
    cfg = load_config(None, {**OVERRIDES, **extra})
    return stages.run_pipeline(str(root / "calib.npz"), str(root / "scans"), str(out),
                               cfg=cfg, device="cpu", log=lambda m: None)


def _cloud_bytes(overlap: dict) -> int:
    return (overlap["transfer_bytes_h2d"] - overlap["transfer_bytes_frames"]
            + overlap["transfer_bytes_d2h"])


@pytest.fixture(scope="module")
def arms(dataset, tmp_path_factory):
    out = {}
    for arm in ("discrete", "fused"):
        d = tmp_path_factory.mktemp(arm)
        out[arm] = (_pipeline(dataset, d, **{"pipeline.fused_clean": str(arm == "fused")}), d)
    return out


def test_the_fused_pipeline_equals_the_discrete_one_with_3x_fewer_bytes(arms):
    (rep_d, out_d), (rep_f, out_f) = arms["discrete"], arms["fused"]
    for rep in (rep_d, rep_f):
        assert rep.failures == [] and rep.views_computed == VIEWS
    for name in OUTPUTS:
        assert (out_d / name).read_bytes() == (out_f / name).read_bytes(), name
    views = sorted(os.listdir(out_d / "views"))
    assert len(views) == VIEWS and views == sorted(os.listdir(out_f / "views"))
    for name in views:
        assert (out_d / "views" / name).read_bytes() == (out_f / "views" / name).read_bytes()
    assert rep_d.clean_counts == rep_f.clean_counts
    assert set(rep_f.walls_s) >= {"clean_cluster_s", "clean_statistical_s"}
    cb_d, cb_f = _cloud_bytes(rep_d.overlap), _cloud_bytes(rep_f.overlap)
    assert cb_f > 0 and cb_d >= 3 * cb_f, (cb_d, cb_f)
    assert rep_f.overlap["kernels"]["fused_view"]["launches"] == 2
    assert "fused_view" not in rep_d.overlap["kernels"]


def test_an_injected_fused_fault_quarantines_only_its_view(dataset, arms, tmp_path):
    victim = "view_015deg"
    faults.configure(f"clean.fused~{victim}:permanent")
    rep = _pipeline(dataset, tmp_path, **{"pipeline.fused_clean": "true"})
    assert [(f.view, f.stage, f.error_type) for f in rep.failures] == [
        (victim, "clean", "PermanentFault")]
    assert rep.degraded and rep.views_computed == VIEWS - 1
    ref = arms["fused"][1] / "views"
    names = sorted(os.listdir(tmp_path / "views"))
    assert names == sorted(n for n in os.listdir(ref) if n != f"{victim}.ply")
    for name in names:
        assert (tmp_path / "views" / name).read_bytes() == (ref / name).read_bytes()


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
def test_a_failed_fused_drain_degrades_on_the_cpu_and_fails_on_the_card(
        dataset, tmp_path, monkeypatch, card):
    def broken(*a, **k):
        raise RuntimeError("fused drain failed")

    monkeypatch.setattr(fv, "fused_clean_views", broken)
    if card:
        # the scanner says cuda; its launch still computes on the CPU. One
        # batch, so the drain starts after the only launch
        forward = SLScanner.forward_views

        def on_cpu(self, frames, **kw):
            with monkeypatch.context() as m:
                m.setattr(SLScanner, "device", property(lambda s: s.rays.device))
                return forward(self, frames, **kw)

        monkeypatch.setattr(SLScanner, "forward_views", on_cpu)
        monkeypatch.setattr(SLScanner, "device", property(lambda self: torch.device("cuda")))
    cfg = load_config(None, {**OVERRIDES, "pipeline.fused_clean": "true",
                             "parallel.compute_batch": str(VIEWS)})
    logs: list[str] = []

    def run():
        return stages.reconstruct(str(dataset / "calib.npz"), str(dataset / "scans"),
                                  mode="batch", output=str(tmp_path), cfg=cfg,
                                  device="cpu", log=logs.append)

    if card:
        with pytest.raises(RuntimeError, match="fused drain failed"):
            run()
        return
    report = run()
    assert report.lane == "batched" and report.failures == []
    assert len(report.outputs) == VIEWS and report.launches == 1 + VIEWS
    assert any("re-running views individually" in m for m in logs)
