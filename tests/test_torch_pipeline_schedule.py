"""The port's default ``run_pipeline`` schedule on the CPU: the stage cache,
retries and quarantine, the run budget and the streaming registrar.

A 4-view dataset of the pipeline scene (``synthetic.pipeline_scene``, as in
``test_torch_pipeline.py``, a 128x64 projector, stored as .slbp containers)
goes through the port with all four clean steps at parameters scaled to
this sampling, ``merge.pair_batch=2`` (the streamed arm's launch groups then
differ from the barrier arm's) and ``merge.icp_iters=10`` (ICP's brute 1-NN
dominates the CPU run). At a 160x120 camera, one cold streamed run in a
fresh directory is the reference of the other arms, which seed fresh
directories with its cache entries. Tolerances:

- within the port, byte for byte: the streamed arm's ``merged.ply`` and
  ``model.stl`` equal the barrier arm's, the warm rerun's (which computes
  nothing: the scanner's forward raises; it also writes the flight
  recorder's journal, 6 cache hits in it) and the transient-fault rerun's;
  with a middle view quarantined (the streamed arm re-pairs around it in
  its catch-up), the streamed arm's equal the barrier arm's;
- one dirty view (one bit of one pattern frame): one view computed and
  its 2 pairs missed (at most 2);
- a permanent ``compute.view`` fault on the last view, at the 200x150
  camera of ``test_torch_pipeline.py``: the quarantined view, its stage,
  its ``error_type`` and ``views_computed`` equal the JAX package's run of
  the same spec (its one pipeline run here), and the two degraded merged
  clouds are within 1 mm chamfer distance (the rule of
  ``test_torch_pipeline.py``; both packages draw the background step's
  planes with the JAX package's ``jax.random.choice``, key 0). A middle
  view is not used there: around it this scene's re-pair joins views of
  different spheres, where no transform is right and the packages differ;
- a ``register.pair`` fault: the identity transform for that pair,
  DEGRADED, and no pair-cache entry for it;
- a cache the same run wrote under the other device's tag: all misses,
  and the same bytes;
- a batched launch that raises: on the CPU its views re-run one at a time
  and all are written; on the card the run raises;
- ``pipeline.run_budget_s``: the run raises, leaves an aborted
  ``failures.json``, and the register thread is gone;
- ``merge.method='posegraph'`` with ``mesh.mode='surface'``: the barrier
  pose-graph merge with the JAX package's notice and merge mode, the same
  bytes through ``merge_views``, and a surface mesh of the JAX package's
  face count (on the same merged cloud) within 0.5 %.
"""
import glob
import json
import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.config import load_config as jload
from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.pipeline import stages as jstages
from structured_light_for_3d_model_replication_tpu.utils import faults as jfaults
from structured_light_for_3d_model_replication_tpu_torch.config import load_config
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import matfile, ply
from structured_light_for_3d_model_replication_tpu_torch.models.scanner import SLScanner
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
from structured_light_for_3d_model_replication_tpu_torch.utils import deadline as dl
from structured_light_for_3d_model_replication_tpu_torch.utils import faults
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

STEPS = ("background", "cluster", "radius", "statistical")
OVERRIDES = {"decode.n_cols": "128", "decode.n_rows": "64", "decode.thresh_mode": "manual",
             "mesh.depth": "5", "merge.voxel_size": "2.0", "merge.icp_iters": "10",
             "merge.pair_batch": "2", "parallel.io_workers": "2",
             "clean.cluster_eps": "8.0", "clean.cluster_min_points": "10",
             "clean.radius": "8.0", "clean.radius_nb_points": "6"}
STEP_DEG = 15.0
QUARANTINED = "view_045deg"
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
    jfaults.reset()


def _render(tmp_path_factory, cam):
    root = tmp_path_factory.mktemp("schedule_ds")
    rig, scene, poses = syn.pipeline_scene(cam_size=cam, proj_size=(128, 64),
                                           n_views=4, step_deg=STEP_DEG)
    for i, (R, t) in enumerate(poses):
        frames, _ = syn.render_scene(rig, scene.transformed(R, t))
        imio.save_packed_stack(str(root / "scans" / f"view_{round(i * STEP_DEG):03d}deg"),
                               imio.pack_stack(frames))
    matfile.save_calibration(str(root / "calib.npz"), rig.calibration())
    return root


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return _render(tmp_path_factory, (160, 120))


def _run(root, out, log=None, **extra):
    cfg = load_config(None, {**OVERRIDES, **extra})
    return stages.run_pipeline(str(root / "calib.npz"), str(root / "scans"), str(out),
                               cfg=cfg, steps=STEPS, device="cpu",
                               log=log if log is not None else (lambda m: None))


def _bytes(out):
    return {f: (out / f).read_bytes() for f in OUTPUTS}


def _seed(src_out, dst_out, stages_=("view", "pair"), skip=()):
    """Copy ``src_out``'s cache entries of ``stages_`` into a fresh
    ``dst_out``, leaving out the entry names in ``skip``."""
    dst = dst_out / ".slscan-cache"
    dst.mkdir(parents=True)
    for path in glob.glob(str(src_out / ".slscan-cache" / "*.npz")):
        name = os.path.basename(path)
        if name.split("-")[0] in stages_ and name not in skip:
            shutil.copy(path, dst / name)


def _view_entries(root):
    """View name -> its view-cache entry's file name."""
    cfg = load_config(None, OVERRIDES)
    cache = stages.StageCache(str(root / "keys"), enabled=False)
    _, sources, keys, _ = stages._view_plan(str(root / "calib.npz"), str(root / "scans"),
                                            cfg, STEPS, cache, lambda m: None,
                                            torch.device("cpu"))
    return {os.path.basename(s): f"view-{k[:16]}.npz" for s, k in zip(sources, keys)}


@pytest.fixture(scope="module")
def cold(dataset, tmp_path_factory):
    out = tmp_path_factory.mktemp("cold")
    report = _run(dataset, out)
    return out, report, _bytes(out)


def test_streamed_cold_run_caches_every_stage(cold):
    out, report, _ = cold
    assert report.merge_mode == "streamed" and report.merge_status == "computed"
    assert (report.views_computed, report.views_cached) == (4, 0)
    assert report.failures == [] and report.degraded is False
    assert report.overlap["pairs_dispatched"] == 3 and report.overlap["register_s"] > 0
    names = [os.path.basename(p).split("-")[0]
             for p in glob.glob(str(out / ".slscan-cache" / "*.npz"))]
    assert sorted(names) == ["merge", "mesh", "pair", "pair", "pair",
                             "view", "view", "view", "view"]
    assert not (out / "failures.json").exists()


def test_streamed_arm_equals_the_barrier_arm(dataset, cold, tmp_path):
    out, _, want = cold
    _seed(out, tmp_path, stages_=("view",))
    report = _run(dataset, tmp_path, **{"merge.stream": "false"})
    assert report.merge_mode == "barrier" and report.merge_status == "computed"
    assert report.views_cached == 4 and report.failures == []
    assert _bytes(tmp_path) == want


def test_warm_rerun_computes_nothing(dataset, cold, tmp_path, monkeypatch):
    out, _, want = cold
    shutil.copytree(out / ".slscan-cache", tmp_path / ".slscan-cache")

    def boom(*a, **k):
        raise AssertionError("a warm rerun must not reach the scanner")

    monkeypatch.setattr(SLScanner, "forward_views", boom)
    monkeypatch.setattr(SLScanner, "forward_views_packed", boom)
    report = _run(dataset, tmp_path, **{"observability.trace": "true"})
    assert (report.views_computed, report.views_cached) == (0, 4)
    assert (report.merge_status, report.mesh_status) == ("cache-hit", "cache-hit")
    assert report.cache["misses"] == 0
    assert _bytes(tmp_path) == want
    # the flight recorder: the journal in the JAX package's schema
    events = [json.loads(ln) for ln in (tmp_path / "trace.jsonl").read_text().splitlines()]
    assert events[0]["type"] == "meta" and events[0]["run_id"] == report.run_id
    assert events[0]["schema"] == "sl3d-trace-v1" and events[-1]["type"] == "end"
    hits = [e["stage"] for e in events if e.get("ev") == "cache.hit"]
    assert sorted(hits) == ["merge", "mesh", "view", "view", "view", "view"]
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    assert {g["name"] for g in metrics["gauges"]} >= {"sl3d_views_cached", "sl3d_degraded"}


def test_one_dirty_view_costs_one_view_and_at_most_two_pairs(dataset, cold, tmp_path):
    out, _, _ = cold
    root = tmp_path / "ds"
    shutil.copytree(dataset, root)
    view = root / "scans" / "view_030deg"
    ps = imio.load_packed_stack(str(view))
    # one pixel of one pattern frame: the coarsest bit where the view is
    # brightest, so the pixel decodes to another column
    r, c = np.unravel_index(np.argmax(ps.white.astype(int) - ps.black), ps.white.shape)
    planes = ps.planes.copy()
    planes[0, r, c] ^= 1
    imio.save_packed_stack(str(view), imio.PackedStack(planes, ps.white, ps.black,
                                                       ps.n_frames, ps.texture))
    _seed(out, tmp_path / "out")
    report = _run(root, tmp_path / "out")
    assert (report.views_computed, report.views_cached) == (1, 3)
    # the view's cleaned bytes changed: its two pairs, and only they, missed
    assert report.cache["miss_stages"].count("pair") == 2
    assert report.failures == []


def test_a_transient_fault_retries_and_gives_the_same_bytes(dataset, cold, tmp_path):
    out, _, want = cold
    entries = _view_entries(dataset)
    _seed(out, tmp_path, skip=(entries["view_015deg"], entries["view_030deg"]))
    faults.configure("compute.view:transient")
    report = _run(dataset, tmp_path)
    # two views missed: the batched lane; the fault poisons the batch, whose
    # views re-run one at a time
    assert report.views_computed == 2 and report.retries == 1
    assert report.failures == [] and report.degraded is False
    assert faults.active_plan().counts() == {"compute.view": 1}
    assert _bytes(tmp_path) == want


def _jax_plane_draws(valid, trials):
    v = jnp.asarray(valid.cpu().numpy(), jnp.float32)
    d = jax.random.choice(jax.random.PRNGKey(0), v.shape[0], shape=(trials, 3),
                          p=v / jnp.maximum(v.sum(), 1.0))
    return torch.from_numpy(np.array(d))


def test_a_quarantined_middle_view_streams_as_the_barrier_arm(dataset, cold, tmp_path):
    out, _, _ = cold
    entries = _view_entries(dataset)
    reports, logs = {}, []
    for arm in ("true", "false"):
        _seed(out, tmp_path / arm, skip=(entries["view_015deg"],))
        faults.configure("compute.view~view_015deg:permanent")
        reports[arm] = _run(dataset, tmp_path / arm, log=logs.append,
                            **{"merge.stream": arm})
    for r in reports.values():
        assert r.degraded and (r.views_computed, r.views_cached) == (0, 3)
        assert [(f.view, f.stage) for f in r.failures] == [("view_015deg", "compute")]
        assert len(r.transforms) == 3
    assert any("pair 0->2 (chain position 0)" in m for m in logs)
    assert _bytes(tmp_path / "true") == _bytes(tmp_path / "false")


def test_a_permanent_compute_fault_quarantines_as_the_jax_package(tmp_path_factory,
                                                                   tmp_path, monkeypatch):
    dataset = _render(tmp_path_factory, (200, 150))
    spec = f"compute.view~{QUARANTINED}:permanent"
    monkeypatch.setattr(pc, "_plane_samples", _jax_plane_draws)
    faults.configure(spec)
    port = _run(dataset, tmp_path / "port")
    jfaults.configure(spec)
    jcfg = jload(None, {**OVERRIDES, "parallel.compute_batch": "1"})
    jrep = jstages.run_pipeline(str(dataset / "calib.npz"), str(dataset / "scans"),
                                str(tmp_path / "jax"), cfg=jcfg, steps=STEPS,
                                log=lambda *a: None)
    assert port.views_computed == jrep.views_computed == 3
    assert port.degraded and jrep.degraded
    key = [(r.view, r.stage, r.error_type) for r in port.failures]
    assert key == [(r.view, r.stage, r.error_type) for r in jrep.failures]
    assert key == [(QUARANTINED, "compute", "PermanentFault")]
    for out in (tmp_path / "port", tmp_path / "jax"):
        manifest = json.loads((out / "failures.json").read_text())
        assert manifest["degraded"] is True and manifest["aborted"] is False
        assert [f["view"] for f in manifest["failures"]] == [QUARANTINED]
        assert os.listdir(out / "quarantine") == [f"{QUARANTINED}.json"]
    assert len(port.transforms) == 3
    a = ply.read_ply(port.merged_ply)["points"]
    b = jply.read_ply(jrep.merged_ply)["points"]
    from scipy.spatial import cKDTree

    assert 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean()) < 1.0


def test_a_register_fault_falls_back_to_identity_and_is_not_cached(dataset, cold,
                                                                    tmp_path):
    out, _, _ = cold
    _seed(out, tmp_path, stages_=("view",))
    faults.configure("register.pair~1->2:permanent")
    logs: list[str] = []
    report = _run(dataset, tmp_path, log=logs.append)
    assert report.degraded and report.views_cached == 4
    assert [(r.stage, r.view, r.error_type) for r in report.failures] == [
        ("register", "pair_1_2", "PermanentFault")]
    np.testing.assert_array_equal(report.transforms[2], report.transforms[1])
    cached = sorted(os.path.basename(p).split("-")[0]
                    for p in glob.glob(str(tmp_path / ".slscan-cache" / "*.npz")))
    assert cached.count("pair") == 2 and "merge" not in cached
    assert any("IDENTITY" in m for m in logs)
    manifest = json.loads((tmp_path / "failures.json").read_text())
    assert manifest["degraded"] is True and manifest["failures"][0]["stage"] == "register"


def test_a_cache_written_on_the_other_device_is_all_misses(dataset, cold, tmp_path,
                                                           monkeypatch):
    """Every key carries the device type: the CPU run's view, pair, merge
    and mesh entries are all misses for a run keyed as on the card."""
    out, _, want = cold
    _seed(out, tmp_path, stages_=("view", "pair", "merge", "mesh"))
    engine = stages._engine_json
    monkeypatch.setattr(stages, "_engine_json",
                        lambda cfg, dev: engine(cfg, torch.device("cuda")))
    report = _run(dataset, tmp_path)
    assert (report.views_computed, report.views_cached) == (4, 0)
    assert (report.merge_status, report.mesh_status) == ("computed", "computed")
    assert report.cache["hits"] == 0
    assert sorted(set(report.cache["miss_stages"])) == ["merge", "mesh", "pair", "view"]
    assert _bytes(tmp_path) == want


@pytest.mark.parametrize("packed", [False, True], ids=["batched", "packed"])
@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
def test_a_failed_batched_launch_degrades_on_the_cpu_and_fails_on_the_card(
        dataset, tmp_path, monkeypatch, packed, card):
    """A batched launch that raises re-runs its views one at a time on the
    CPU, as the JAX package does; on the card (the scanner's device says
    cuda) the error fails the run."""
    forward = SLScanner.forward_views

    def one_view_only(self, frames, **kw):
        if np.asarray(frames).shape[0] > 1:
            raise RuntimeError("launch failed")
        return forward(self, frames, **kw)

    def never(self, *a, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(SLScanner, "forward_views", one_view_only)
    monkeypatch.setattr(SLScanner, "forward_views_packed", never)
    if card:
        monkeypatch.setattr(SLScanner, "device", property(lambda self: torch.device("cuda")))
    cfg = load_config(None, {**OVERRIDES, "pipeline.packed_ingest": str(packed).lower()})
    logs: list[str] = []

    def run():
        return stages.reconstruct(str(dataset / "calib.npz"), str(dataset / "scans"),
                                  mode="batch", output=str(tmp_path), cfg=cfg,
                                  device="cpu", log=logs.append)

    if card:
        with pytest.raises(RuntimeError, match="launch failed"):
            run()
        assert not list(tmp_path.glob("*.ply"))
        return
    report = run()
    assert report.lane == ("packed" if packed else "batched")
    assert len(report.outputs) == 4 and report.failures == []
    assert any("degraded to per-view" in m for m in logs)


def test_the_run_budget_aborts_with_a_manifest(dataset, tmp_path):
    # one view a launch: the budget runs out between views, with cleaned
    # views already fed to the register lane
    with pytest.raises(dl.DeadlineExceeded):
        _run(dataset, tmp_path, **{"pipeline.run_budget_s": "1",
                                   "parallel.compute_batch": "1"})
    manifest = json.loads((tmp_path / "failures.json").read_text())
    assert manifest["aborted"] is True and manifest["run_budget_s"] == 1.0
    assert manifest["failures"][0]["error_type"] == "DeadlineExceeded"
    assert not (tmp_path / "model.stl").exists()
    t_end = time.monotonic() + load_config().deadlines.register_s
    while any(t.name.startswith("sl3d-register") for t in threading.enumerate()):
        assert time.monotonic() < t_end
        time.sleep(0.01)


def test_an_unported_merge_method_still_raises(dataset, cold, tmp_path):
    """merge.method='posegraph' (ported now) takes no streamed arm: with
    merge.stream on, the run logs the JAX package's one-line notice, stamps
    merge_mode 'posegraph' and runs the barrier ``merge_360_posegraph``
    (no pair dispatched, no failure); with mesh.mode='surface' it meshes by
    ball pivoting. ``merge_views`` with method='posegraph' over the same
    cleaned views written as PLYs writes the same bytes. The STL against
    the JAX package's surface mesh of the same merged cloud: its vertices
    are merged points, face counts within 0.5 %. (This scene's merge is not
    held against the JAX package's: a cleaned view holds 600 to 1300 points
    of one sphere, so ICP slides on every pair and rounding decides where,
    and the loop closure joins views 45 degrees apart; with the JAX
    package's preps and draws injected the two packages still part at ICP.
    ``test_torch_posegraph.py`` holds the posegraph merge to the JAX
    package's on a scene that registers.)"""
    out, _, _ = cold
    _seed(out, tmp_path, stages_=("view",))
    logs: list[str] = []
    report = _run(dataset, tmp_path, log=logs.append,
                  **{"merge.method": "posegraph", "merge.stream": "true",
                     "mesh.mode": "surface"})
    assert report.merge_mode == "posegraph" and report.merge_status == "computed"
    assert report.views_cached == 4 and report.failures == [] and report.degraded is False
    assert (report.overlap or {}).get("pairs_dispatched", 0) == 0
    assert [m for m in logs if "merge.stream is ignored" in m] == [
        "[pipeline] NOTICE: merge.method='posegraph' has no streaming arm — merge.stream is "
        "ignored and the barrier pose-graph merge runs after reconstruction"]
    assert any(m.startswith("[posegraph] loop closure 0<-3") for m in logs)
    assert not (tmp_path / "failures.json").exists()
    merged = ply.read_ply(str(tmp_path / "merged.ply"))["points"]
    assert len(merged) == report.merged_points > 1000

    entries = _view_entries(dataset)
    views = tmp_path / "views"
    views.mkdir()
    for name in sorted(entries):
        with np.load(str(out / ".slscan-cache" / entries[name])) as z:
            ply.write_ply(str(views / f"{name}.ply"), np.asarray(z["points"], np.float32),
                          np.asarray(z["colors"], np.uint8))
    cfg = load_config(None, {**OVERRIDES, "merge.method": "posegraph"})
    stages.merge_views(str(views), str(tmp_path / "m.ply"), cfg=cfg, device="cpu",
                       log=lambda m: None)
    assert (tmp_path / "m.ply").read_bytes() == (tmp_path / "merged.ply").read_bytes()

    jstages.mesh_cloud(str(tmp_path / "merged.ply"), str(tmp_path / "jax.stl"),
                       cfg=jload(None, {**OVERRIDES, "mesh.mode": "surface"}),
                       log=lambda *a: None)
    from structured_light_for_3d_model_replication_tpu.io import stl as jstl

    v_t, _, _ = jstl.read_stl(str(tmp_path / "model.stl"))
    v_j, _, _ = jstl.read_stl(str(tmp_path / "jax.stl"))
    assert abs(len(v_t) - len(v_j)) <= 0.005 * len(v_j) and len(v_t) > 300 * 3
    assert {tuple(r) for r in v_t} <= {tuple(r) for r in merged}
