"""The port's scan-to-print pipeline against the JAX package, on the CPU.

A 4-view dataset of the pipeline scene (``synthetic.pipeline_scene``: three
spheres on a floor plane, turntable steps of 15 degrees) at a 200x150
camera and a 128x64 projector, stored as .slbp containers (both packages
read them), goes through ``python -m
structured_light_for_3d_model_replication_tpu_torch pipeline ... --device
cpu`` and the JAX package's ``run_pipeline`` with the same config (manual
thresholds, mesh.depth=5, merge voxel 2 mm, the cleaned views written
out): once with ``--steps
statistical`` and once with all four steps at parameters scaled to this
sampling. The background step's plane draws are the JAX package's
(``jax.random.choice``, key 0) in both packages, so the clean chains see the
same hypotheses. Tolerances:

- per-view counts after each clean step equal;
- the merged clouds: the merge's RANSAC draws differ between the packages,
  so the poses agree to registration noise, not to rounding. With all four
  steps (the floor removed) the chamfer distance between the two merged
  clouds is under 1 mm. With the floor kept, registration is ill-posed in
  both packages (a plane slides under rotation about the vertical axis;
  the JAX package's merged points reach a 99th-percentile error of ~140 mm
  here), so the chamfer distance is only held under 10 mm, and the port's
  distance to the true surfaces (median and 99th percentile) under 1.5x
  the JAX package's;
- the STL: readable by the JAX package's io/stl.read_stl; its boundary
  edges and its edges in more than two faces (vertices welded by
  coordinates) at most 1.5x the JAX package's plus 10 (the density trim
  opens holes in both: ~20 of each here); with all four steps its vertices
  within 1 mm (chamfer) of the JAX package's STL's.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.config import load_config as jload
from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.io import stl as jstl
from structured_light_for_3d_model_replication_tpu.pipeline import stages as jstages
from structured_light_for_3d_model_replication_tpu_torch import cli
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import matfile
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

OVERRIDES = {"decode.n_cols": "128", "decode.n_rows": "64", "decode.thresh_mode": "manual",
             "mesh.depth": "5", "merge.voxel_size": "2.0", "pipeline.write_view_plys": "true"}
SCALED = {"clean.cluster_eps": "8.0", "clean.cluster_min_points": "10",
          "clean.radius": "8.0", "clean.radius_nb_points": "6"}
ARMS = {"statistical": ("statistical", {}),
        "all": ("background,cluster,radius,statistical", SCALED)}
STEP_DEG = 15.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU tensors are small: beside the other test workers on the box,
    torch's default thread pool oversubscribes the cores and runs them many
    times slower, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_plane_draws(valid, trials):
    v = jnp.asarray(valid.cpu().numpy(), jnp.float32)
    d = jax.random.choice(jax.random.PRNGKey(0), v.shape[0], shape=(trials, 3),
                          p=v / jnp.maximum(v.sum(), 1.0))
    return torch.from_numpy(np.array(d))


def _jax_run(ds, out, steps, extra):
    cfg = jload(None, {**OVERRIDES, **extra, "pipeline.cache": "false",
                       "parallel.compute_batch": "1", "parallel.io_workers": "1"})
    counts = []
    clean = jstages._clean_arrays

    def recording(*a, **k):
        res = clean(*a, **k)
        counts.append(res[2])
        return res

    jstages._clean_arrays = recording
    try:
        jstages.run_pipeline(str(ds / "calib.npz"), str(ds / "scans"), str(out),
                             cfg=cfg, steps=tuple(steps.split(",")), log=lambda *a: None)
    finally:
        jstages._clean_arrays = clean
    return counts


def _port_run(ds, out, steps, extra, capsys):
    argv = ["pipeline", str(ds / "scans"), "--calib", str(ds / "calib.npz"),
            "--out", str(out), "--steps", steps, "--device", "cpu", "--no-cache",
            "--no-stream", "--pair-batch", "2", "--io-workers", "2"]
    for k, v in {**OVERRIDES, **extra}.items():
        argv += ["--set", f"{k}={v}"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pc, "_plane_samples", _jax_plane_draws)
        assert cli.main(argv) == 0
    return [json.loads(ln[len("[pipeline] clean "):])
            for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[pipeline] clean ")]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline_ds")
    rig, scene, poses = syn.pipeline_scene(cam_size=(200, 150), proj_size=(128, 64),
                                           n_views=4, step_deg=STEP_DEG)
    for i, (R, t) in enumerate(poses):
        frames, _ = syn.render_scene(rig, scene.transformed(R, t))
        imio.save_packed_stack(str(root / "scans" / f"view_{round(i * STEP_DEG):03d}deg"),
                               imio.pack_stack(frames))
    matfile.save_calibration(str(root / "calib.npz"), rig.calibration())
    return root, scene


def _chamfer(a, b):
    from scipy.spatial import cKDTree

    return 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


def _edges(stl_path):
    """(faces, boundary edges, edges in more than two faces), vertices
    welded by exact coordinates."""
    verts, _, _ = jstl.read_stl(stl_path)
    _, inv = np.unique(verts, axis=0, return_inverse=True)
    f = inv.reshape(-1, 3).astype(np.int64)
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    _, uses = np.unique(e[:, 0] * (f.max() + 1) + e[:, 1], return_counts=True)
    return len(f), int((uses == 1).sum()), int((uses > 2).sum())


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_cli_pipeline_matches_the_jax_package(arm, dataset, tmp_path, capsys):
    """One arm run by each package, then its clean counts, merged cloud and
    STL held against the JAX package's (one test an arm: the runs are the
    cost)."""
    root, scene = dataset
    steps, extra = ARMS[arm]
    counts_t = _port_run(root, tmp_path / "port", steps, extra, capsys)
    counts_j = _jax_run(root, tmp_path / "jax", steps, extra)
    out_t, out_j = tmp_path / "port", tmp_path / "jax"

    assert len(counts_t) == len(counts_j) == 4
    assert counts_t == counts_j
    assert all(c["statistical"] > 0.3 * c["input"] for c in counts_t)
    # pipeline.write_view_plys: each cleaned view, under the JAX package's name
    names = sorted(os.listdir(out_t / "views"))
    assert names == sorted(os.listdir(out_j / "views")) and len(names) == 4
    for name, c in zip(names, counts_t):
        pts = jply.read_ply(str(out_t / "views" / name))["points"]
        assert len(pts) == c["statistical"]
        assert len(pts) == len(jply.read_ply(str(out_j / "views" / name))["points"])

    assert not (out_t / "failures.json").exists()
    merged_t = jply.read_ply(str(out_t / "merged.ply"))["points"]
    merged_j = jply.read_ply(str(out_j / "merged.ply"))["points"]
    assert len(merged_t) > 3000
    ch = _chamfer(merged_t, merged_j)
    if arm == "all":
        assert ch < 1.0
    else:
        assert ch < 10.0
        st = syn.surface_distance(merged_t, scene)
        sj = syn.surface_distance(merged_j, scene)
        assert np.median(st) <= 1.5 * np.median(sj)
        assert np.percentile(st, 99) <= 1.5 * np.percentile(sj, 99)

    f_t, b_t, m_t = _edges(str(out_t / "model.stl"))
    _, b_j, m_j = _edges(str(out_j / "model.stl"))
    assert f_t > 100
    assert b_t <= 1.5 * b_j + 10 and m_t <= 1.5 * m_j + 10
    if arm == "all":
        v_t, _, _ = jstl.read_stl(str(out_t / "model.stl"))
        v_j, _, _ = jstl.read_stl(str(out_j / "model.stl"))
        assert _chamfer(v_t, v_j) < 1.0


def test_pipeline_without_cuda_raises_and_leaves_a_manifest(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is CUDA there")
    root, _ = dataset
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["pipeline", str(root / "scans"), "--calib", str(root / "calib.npz"),
                  "--out", str(tmp_path / "o")])
    # an abort inside the run (fewer views than the floor) leaves failures.json
    argv = ["pipeline", str(root / "scans"), "--calib", str(root / "calib.npz"),
            "--out", str(tmp_path / "o2"), "--device", "cpu", "--set", "pipeline.min_views=9"]
    for k, v in OVERRIDES.items():
        argv += ["--set", f"{k}={v}"]
    with pytest.raises(ValueError, match="min_views=9"):
        cli.main(argv)
    manifest = json.loads((tmp_path / "o2" / "failures.json").read_text())
    assert manifest["aborted"] is True and "min_views" in manifest["reason"]
    assert not os.path.exists(tmp_path / "o2" / "model.stl")
