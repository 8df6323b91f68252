"""The bit-exact export and the numpy backend in the port, against the JAX
package, bit for bit (no tolerance anywhere):

- ``triangulate_np`` (the NumPy twin) on seeded random decode maps, at
  row_mode 0, 1 (also with a tight epipolar tolerance that rejects most
  points) and 2, with the plane table and the quadratic plane form;
- ``triangulate(bitexact=True)`` on CPU tensors against the JAX package's
  ``triangulate(bitexact=True)``; with ``plane_eval='quadratic'`` both
  raise ValueError;
- ``decode_stack_np`` on a noisy render (manual, Otsu and otsu_device
  thresholds, cut bit counts, downsample 2, a truncated stack);
- ``reconstruct`` of a 2-view ``synth`` capture (96x72 camera, 64x32
  projector) under ``parallel.backend=numpy`` and under
  ``triangulate.bitexact=true`` with ``device='cpu'``, in the serial and
  pipelined lanes (never the batched one): the PLY bytes equal the JAX
  package's ``reconstruct`` with the same config;
- the view-cache key changes with ``parallel.backend`` and
  ``triangulate.bitexact``; the pair / merge / mesh tag names the backend;
- a bit-exact ``run_pipeline`` runs the per-view lane, and
  ``pipeline.fused_clean`` (a batched-lane option) changes none of its
  bytes;
- the numpy backend's host clean chain: ``clean_chain_np`` masks and
  counts on a seeded cloud (a floor, three blobs, scattered noise), every
  step and step subsets, against the JAX package's ``clean_chain_np``
  (whose draws there hold no degenerate plane hypothesis: a degenerate one
  scores 0 in the port, ROADMAP C2, as a case of its own shows);
  ``clean_cloud`` and a 3-view ``run_pipeline`` under
  ``parallel.backend=numpy``: the cleaned PLYs (and ``clean_cloud``'s
  counts) equal the JAX package's byte for byte. The merge and the mesh
  run on the device in both packages; their parity is
  ``test_torch_pipeline.py``'s.
"""
import json
import os

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import config as jconfig
from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.ops import graycode as jgc
from structured_light_for_3d_model_replication_tpu.ops import pointcloud as jpc
from structured_light_for_3d_model_replication_tpu.ops import triangulate as jtri
from structured_light_for_3d_model_replication_tpu.pipeline import stages as jstages
from structured_light_for_3d_model_replication_tpu.utils import synthetic as jsyn
from structured_light_for_3d_model_replication_tpu_torch import cli
from structured_light_for_3d_model_replication_tpu_torch.config import load_config
from structured_light_for_3d_model_replication_tpu_torch.io import ply
from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.ops import triangulate as tri
from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (
    StageCache,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

DECODE = {"decode.n_cols": "64", "decode.n_rows": "32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maps(seed=0, h=60, w=80):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w)).astype(np.int32),
            rng.integers(0, 128, (h, w)).astype(np.int32),
            rng.random((h, w)) > 0.3,
            rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
            syn.default_rig(cam_size=(w, h)).calibration())


def _same(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("plane_eval", ["table", "quadratic"])
@pytest.mark.parametrize("row_mode,tol", [(0, 2.0), (1, 2.0), (1, 0.05), (2, 2.0)])
def test_numpy_twin_equals_the_jax_twin(row_mode, tol, plane_eval):
    col, row, mask, tex, calib = _maps()
    mine = tri.triangulate_np(col, row, mask, tex, calib, row_mode=row_mode,
                              epipolar_tol=tol, plane_eval=plane_eval)
    _same(mine, jtri.triangulate_np(col, row, mask, tex, calib, row_mode=row_mode,
                                    epipolar_tol=tol, plane_eval=plane_eval))
    if row_mode == 1 and tol < 1:
        assert 0 < mine.valid.sum() < 0.5 * mask.sum()   # the tolerance rejects


@pytest.mark.parametrize("row_mode", [0, 1, 2])
def test_bitexact_on_cpu_tensors_equals_the_jax_package(row_mode):
    col, row, mask, tex, calib = _maps(seed=1)
    mine = tri.triangulate(torch.from_numpy(col), torch.from_numpy(row),
                           torch.from_numpy(mask), torch.from_numpy(tex), calib,
                           row_mode=row_mode, bitexact=True)
    _same(mine, jtri.triangulate(col, row, mask, tex, calib, row_mode=row_mode,
                                 bitexact=True))
    _same(tri.compact_cloud(mine), jtri.compact_cloud(mine))


def test_bitexact_rejects_the_quadratic_plane_form():
    col, row, mask, tex, calib = _maps(h=4, w=4)
    args = (torch.from_numpy(col), torch.from_numpy(row), torch.from_numpy(mask),
            torch.from_numpy(tex), calib)
    with pytest.raises(ValueError, match="bitexact"):
        tri.triangulate(*args, plane_eval="quadratic", bitexact=True)
    with pytest.raises(ValueError, match="bitexact"):
        jtri.triangulate(col, row, mask, tex, calib, plane_eval="quadratic",
                         bitexact=True)


@pytest.mark.parametrize("kw", [
    {"thresh_mode": "manual"}, {"thresh_mode": "otsu"}, {"thresh_mode": "otsu_device"},
    {"thresh_mode": "manual", "n_sets_col": 4, "n_sets_row": 3},
    {"thresh_mode": "otsu", "downsample": 2},
    {"thresh_mode": "manual", "skip_remaining_before_row": True, "frames": 11}],
    ids=["manual", "otsu", "otsu_device", "n_sets", "downsample", "truncated"])
def test_decode_stack_np_equals_the_jax_package(kw):
    kw = dict(kw)
    ds = kw.get("downsample", 1)
    rig = jsyn.default_rig(cam_size=(96, 72), proj_size=(64, 32))
    frames, _ = jsyn.render_scene(rig, jsyn.sphere_on_background(), noise_sigma=3.0,
                                  downsample=ds)
    frames = frames[:kw.pop("frames", len(frames))]
    mine = gc.decode_stack_np(frames, n_cols=64, n_rows=32, **kw)
    _same(mine, jgc.decode_stack_np(frames, n_cols=64, n_rows=32, **kw))
    assert mine.mask.any()


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("bitexact_synth")
    assert cli.main(["synth", str(root), "--views", "2", "--cam", "96x72",
                     "--proj", "64x32"]) == 0
    return root


@pytest.mark.parametrize("io_workers,lane", [("1", "serial"), ("2", "pipelined")])
@pytest.mark.parametrize("arm", [{"parallel.backend": "numpy"},
                                 {"triangulate.bitexact": "true"}],
                         ids=["numpy", "bitexact"])
def test_reconstruct_plys_equal_the_jax_package(capture, tmp_path, arm, io_workers, lane):
    over = {**DECODE, **arm, "parallel.io_workers": io_workers}
    calib = str(capture / "calib.mat")
    report = stages.reconstruct(calib, str(capture), mode="batch",
                                output=str(tmp_path / "port"), cfg=load_config(None, over),
                                device="cpu", log=lambda m: None)
    jreport = jstages.reconstruct(calib, str(capture), mode="batch",
                                  output=str(tmp_path / "jax"),
                                  cfg=jconfig.load_config(None, over), log=lambda m: None)
    assert report.lane == lane and not report.failed and not jreport.failed
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 2
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert min(report.points) > 1000


def test_cache_keys_tell_the_arms_apart(capture, tmp_path):
    cache = StageCache(str(tmp_path / "cache"))
    keys = {}
    for name, over in (("device", {}), ("numpy", {"parallel.backend": "numpy"}),
                       ("bitexact", {"triangulate.bitexact": "true"})):
        cfg = load_config(None, {**DECODE, **over})
        keys[name] = stages._view_plan(str(capture / "calib.mat"), str(capture), cfg,
                                       stages.CLEAN_STEPS, cache, lambda m: None,
                                       torch.device("cpu"))[2]
    assert len({tuple(k) for k in keys.values()}) == 3
    cpu = torch.device("cpu")
    for backend in ("jax", "numpy"):
        tag = stages._engine_json(load_config(None, {"parallel.backend": backend}), cpu)
        assert json.loads(tag) == {"backend": backend, "engine": "torch", "device": "cpu"}


def test_bitexact_pipeline_takes_the_per_view_lane(tmp_path):
    rig, scene, poses = syn.pipeline_scene(cam_size=(96, 72), proj_size=(64, 32),
                                           n_views=3, step_deg=15.0)
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile

    for i, (R, t) in enumerate(poses):
        frames, _ = syn.render_scene(rig, scene.transformed(R, t))
        imio.save_packed_stack(str(tmp_path / "scans" / f"view_{i * 15:03d}deg"),
                               imio.pack_stack(frames))
    matfile.save_calibration(str(tmp_path / "calib.npz"), rig.calibration())
    outs = {}
    for fused in ("false", "true"):
        over = {**DECODE, "decode.thresh_mode": "manual", "triangulate.bitexact": "true",
                "parallel.compute_batch": "2", "pipeline.fused_clean": fused,
                "mesh.depth": "4", "merge.voxel_size": "3.0", "merge.icp_iters": "5",
                "clean.cluster_eps": "12.0", "clean.cluster_min_points": "5",
                "clean.radius": "12.0", "clean.radius_nb_points": "3"}
        out = tmp_path / f"out_{fused}"
        report = stages.run_pipeline(str(tmp_path / "calib.npz"), str(tmp_path / "scans"),
                                     str(out), cfg=load_config(None, over), device="cpu",
                                     log=lambda m: None)
        assert report.views_computed == 3 and not report.failures
        assert (report.overlap or {}).get("launches", 0) == 0   # no batched launch
        outs[fused] = {f: (out / f).read_bytes() for f in ("merged.ply", "model.stl")}
    assert outs["false"] == outs["true"]


def _scene_cloud(seed=0):
    """A floor, three blobs and scattered noise, f32 [N, 3] (mm)."""
    rng = np.random.default_rng(seed)
    floor = np.c_[rng.uniform(-60, 60, (1500, 2)), rng.normal(0, 1.5, 1500)]
    blobs = [rng.normal(c, s, (m, 3)) for c, s, m in
             (((0, 0, 20), 6, 900), ((30, 20, 15), 4, 400), ((-35, -25, 10), 3, 150))]
    noise = rng.uniform(-70, 70, (60, 3))
    return np.concatenate([floor, *blobs, noise]).astype(np.float32)


def _clean_cfg(**kw):
    over = {"clean.cluster_eps": "4.0", "clean.cluster_min_points": "8",
            "clean.radius": "4.0", "clean.radius_nb_points": "5",
            "clean.plane_ransac_trials": "256", **kw}
    return load_config(None, over), jconfig.load_config(None, over)


@pytest.mark.parametrize("steps", [pc.CLEAN_STEPS, ("cluster", "statistical"),
                                   ("background",), ("radius",)],
                         ids=["all", "cluster+statistical", "background", "radius"])
def test_clean_chain_np_equals_the_jax_package(steps):
    pts = _scene_cloud()
    cfg, jcfg = _clean_cfg()
    valid = np.ones(len(pts), bool)
    valid[::97] = False
    # the JAX package's draws hold no degenerate hypothesis here
    tri = np.random.default_rng(0).choice(np.where(valid)[0], size=(256, 3))
    assert (tri[:, 0] != tri[:, 1]).all() and (tri[:, 1] != tri[:, 2]).all() \
        and (tri[:, 0] != tri[:, 2]).all()
    masks, counts = pc.clean_chain_np(pts, valid, cfg.clean, steps)
    jmasks, jcounts = jpc.clean_chain_np(pts, valid, jcfg.clean, steps)
    _same((masks, counts), (jmasks, jcounts))
    assert 0 < counts[-1] < valid.sum()


def test_segment_plane_np_scores_degenerate_triples_zero():
    """Eight points, 64 draws with replacement: repeated rows are drawn.
    The JAX package's twin keeps such a hypothesis (zero normal, every row
    an inlier); the port's scores it 0 and fits the real plane."""
    pts = np.array([[0, 0, 0], [10, 0, 0], [0, 10, 0], [10, 10, 0],
                    [5, 5, 0], [3, 7, 0], [1, 1, 30], [9, 4, 40]], np.float32)
    valid = np.ones(8, bool)
    jplane, jin = jpc.segment_plane_np(pts, valid, 1.0, 64)
    plane, inliers = pc.segment_plane_np(pts, valid, 1.0, 64)
    assert not jplane[:3].any() and jin.all()
    assert abs(np.linalg.norm(plane[:3]) - 1) < 1e-6
    assert inliers.tolist() == [True] * 6 + [False] * 2
    # every hypothesis degenerate: no plane, no inliers
    _, none = pc.segment_plane_np(pts[:1], valid[:1], 1.0, 8)
    assert not none.any()


def test_clean_cloud_on_the_numpy_backend_equals_the_jax_package(tmp_path):
    pts = _scene_cloud(1)
    cols = np.random.default_rng(1).integers(0, 256, pts.shape).astype(np.uint8)
    jply.write_ply(str(tmp_path / "in.ply"), pts, cols)
    cfg, jcfg = _clean_cfg(**{"parallel.backend": "numpy"})
    seen = []
    counts = stages.clean_cloud(str(tmp_path / "in.ply"), str(tmp_path / "port.ply"), cfg,
                                log=lambda m: None, device="cpu",
                                step_callback=lambda *a: seen.append(a[0]))
    jcounts = jstages.clean_cloud(str(tmp_path / "in.ply"), str(tmp_path / "jax.ply"), jcfg,
                                  log=lambda m: None)
    assert counts == jcounts and seen == list(pc.CLEAN_STEPS)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    assert 0 < counts["statistical"] < len(pts)


def test_numpy_backend_pipeline_equals_the_jax_package(tmp_path):
    from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
    from structured_light_for_3d_model_replication_tpu_torch.io import matfile

    rig, scene, poses = syn.pipeline_scene(cam_size=(96, 72), proj_size=(64, 32),
                                           n_views=3, step_deg=15.0)
    for i, (R, t) in enumerate(poses):
        frames, _ = syn.render_scene(rig, scene.transformed(R, t))
        imio.save_packed_stack(str(tmp_path / "scans" / f"view_{i * 15:03d}deg"),
                               imio.pack_stack(frames))
    matfile.save_calibration(str(tmp_path / "calib.npz"), rig.calibration())
    over = {**DECODE, "decode.thresh_mode": "manual", "parallel.backend": "numpy",
            "parallel.io_workers": "1", "pipeline.write_view_plys": "true",
            "pipeline.cache": "false", "mesh.depth": "4", "merge.voxel_size": "3.0",
            "clean.cluster_eps": "12.0", "clean.cluster_min_points": "5",
            "clean.radius": "12.0", "clean.radius_nb_points": "3",
            # at ~500 points a view, 512 draws almost surely repeat a row,
            # which empties every view of the JAX package (ROADMAP C2); 32
            # draw no such triple here
            "clean.plane_ransac_trials": "32"}
    report = stages.run_pipeline(str(tmp_path / "calib.npz"), str(tmp_path / "scans"),
                                 str(tmp_path / "port"), cfg=load_config(None, over),
                                 device="cpu", log=lambda m: None)
    jstages.run_pipeline(str(tmp_path / "calib.npz"), str(tmp_path / "scans"),
                         str(tmp_path / "jax"), cfg=jconfig.load_config(None, over),
                         log=lambda *a: None)
    assert report.views_computed == 3 and not report.failures
    names = sorted(os.listdir(tmp_path / "jax" / "views"))
    assert names == sorted(os.listdir(tmp_path / "port" / "views")) and len(names) == 3
    for name in names:
        assert (tmp_path / "port" / "views" / name).read_bytes() == \
            (tmp_path / "jax" / "views" / name).read_bytes()
    # the merge and the mesh are the device path's (tests/test_torch_pipeline.py)
    assert len(ply.read_ply(str(tmp_path / "port" / "merged.ply"))["points"]) > 500
    assert (tmp_path / "port" / "model.stl").stat().st_size > 84
