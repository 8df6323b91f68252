"""The port's ``config``, ``patterns`` and ``synth`` commands, the
``StageRecorder`` and ``--artifacts`` on ``clean`` and ``merge-360``,
against the JAX package's CLI and recorder:

- ``config`` prints the JAX package's JSON text, character for character,
  at the defaults, under ``--set`` (port keys and keys the port does not
  carry) and under ``--config``; a key missing from its order raises;
- ``patterns`` writes files byte-equal to the JAX package's
  ``write_patterns`` (both write with cv2);
- ``synth --views 2`` writes the JAX command's layout and frame bytes; its
  ``calib.mat`` holds bit-equal arrays and equal bytes after the 128-byte
  MATLAB header (whose text carries the time of writing);
- the same arrays given to both packages' ``StageRecorder`` write equal
  ``merge_step_NN.ply`` and ``clean_<step>.ply`` bytes and the same
  ``progress.json`` entries but for their times;
- ``clean --artifacts`` and ``merge-360 --artifacts`` (3 views of a lumpy
  surface, a small merge config) write outputs byte-identical to
  runs without the flag, a ``clean_<step>.ply`` a step, a
  ``merge_step_NN.ply`` a chain step after the base view and
  ``progress.json``; the merge's step clouds are the moved views.
"""
import json
import os

import numpy as np
import pytest
import scipy.io
import torch

from structured_light_for_3d_model_replication_tpu import cli as jcli
from structured_light_for_3d_model_replication_tpu.acquire import viewer as jviewer
from structured_light_for_3d_model_replication_tpu_torch import cli
from structured_light_for_3d_model_replication_tpu_torch.acquire import viewer
from structured_light_for_3d_model_replication_tpu_torch.io import ply
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

MERGE_SET = ["--set", "merge.voxel_size=3.0", "--set", "merge.ransac_trials=512",
             "--set", "merge.icp_iters=8", "--set", "merge.final_voxel=1.0",
             "--set", "merge.outlier_nb=20"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _out(main, argv, capsys) -> str:
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    [], ["--set", "parallel.backend=numpy", "--set", "decode.n_cols=64"],
    ["--set", "parallel.shard_views=false", "--set", "serving.port=9",
     "--set", "scan_root=/scans", "--set", "pipeline.fused_clean=true"],
    "file"], ids=["defaults", "set", "dropped", "file"])
def test_config_prints_the_jax_json(argv, tmp_path, capsys):
    if argv == "file":
        path = tmp_path / "c.json"
        path.write_text(json.dumps({"parallel": {"merge_mesh": True, "io_workers": 2},
                                    "acquire": {"turns": 3}, "scan_root": "r",
                                    "triangulate": {"bitexact": True}}))
        argv = ["--config", str(path), "--set", "coordinator.port=4"]
    text = _out(cli.main, ["config", *argv], capsys)
    assert text == _out(jcli.main, ["config", *argv], capsys)
    json.loads(text)


@pytest.mark.parametrize("top,key", [("parallel", "io_workers"), ("parallel", "data_axis"),
                                     ("", "pipeline")])
def test_config_refuses_a_key_its_order_lacks(monkeypatch, top, key):
    """A port key or a dropped key missing from the JAX order would leave
    the ``config`` output silently: ``jax_dict`` raises instead."""
    from structured_light_for_3d_model_replication_tpu_torch import config as pconfig

    order = dict(pconfig._JAX_ORDER)
    order[top] = tuple(k for k in order[top] if k != key)
    monkeypatch.setattr(pconfig, "_JAX_ORDER", order)
    with pytest.raises(AssertionError, match=key):
        pconfig.jax_dict(pconfig.Config())


def test_patterns_equal_the_jax_package(tmp_path, capsys):
    over = ["--set", "projector.width=96", "--set", "projector.height=40",
            "--set", "projector.downsample=2"]
    assert cli.main(["patterns", str(tmp_path / "p"), *over]) == 0
    assert jcli.main(["patterns", str(tmp_path / "j"), *over]) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p")) and len(names) == 2 + 2 * (6 + 5)
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_synth_writes_the_jax_layout_and_bytes(tmp_path, capsys):
    argv = ["--views", "2", "--cam", "64x48", "--proj", "64x32"]
    assert cli.main(["synth", str(tmp_path / "p"), *argv]) == 0
    assert jcli.main(["synth", str(tmp_path / "j"), *argv]) == 0
    files = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "j")
                   for r, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), tmp_path / "p")
                           for r, _, fs in os.walk(tmp_path / "p") for f in fs)
    assert "scan_180deg_scan/24.png" in files and "calib.mat" in files
    for f in files:
        a, b = (tmp_path / "p" / f).read_bytes(), (tmp_path / "j" / f).read_bytes()
        if f == "calib.mat":
            assert a[128:] == b[128:]
            pa, pb = scipy.io.loadmat(tmp_path / "p" / f), scipy.io.loadmat(tmp_path / "j" / f)
            for k in pb:
                if not k.startswith("__"):
                    assert pa[k].tobytes() == pb[k].tobytes(), k
        else:
            assert a == b, f


def _progress(d):
    return [{k: v for k, v in e.items() if k != "t"}
            for e in json.loads((d / "progress.json").read_text())]


def test_the_recorder_equals_the_jax_recorder(tmp_path):
    rng = np.random.default_rng(2)
    views = [(rng.normal(0, 30, (n, 3)).astype(np.float32),
              rng.integers(0, 256, (n, 3)).astype(np.uint8)) for n in (900, 700, 1100, 600)]
    for cap in (200_000, 500):       # the stride caps the preview at 500 points
        mine = viewer.StageRecorder(str(tmp_path / f"p{cap}"), max_points_per_step=cap)
        theirs = jviewer.StageRecorder(str(tmp_path / f"j{cap}"), max_points_per_step=cap)
        total = 0
        for i, (p, c) in enumerate(views):
            total += len(p)
            mine.merge_step(i, p, c, total)
            theirs.merge_step(i, p, c, total)
        for rec in (mine, theirs):
            rec.save_cloud("clean_background", views[0][0], views[0][1])
            rec.save_cloud("clean_radius.ply", views[1][0])
        names = sorted(os.listdir(tmp_path / f"j{cap}"))
        assert names == sorted(os.listdir(tmp_path / f"p{cap}"))
        assert names == ["clean_background.ply", "clean_radius.ply", "merge_step_01.ply",
                         "merge_step_02.ply", "merge_step_03.ply", "progress.json"]
        for name in names[:-1]:
            assert (tmp_path / f"p{cap}" / name).read_bytes() == \
                (tmp_path / f"j{cap}" / name).read_bytes(), name
        assert _progress(tmp_path / f"p{cap}") == _progress(tmp_path / f"j{cap}")


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """3 views of a lumpy surface 30 degrees apart, as PLYs."""
    d = tmp_path_factory.mktemp("lumpy")
    poses = syn.turntable_poses(3, 30.0, np.array([0.0, 0.0, 400.0]))
    for i, pts in enumerate(syn.lumpy_views(poses, n_points=3000)):
        ply.write_ply(str(d / f"view_{i * 30:03d}deg.ply"), pts,
                      np.full((len(pts), 3), 128, np.uint8))
    return d


def test_merge_artifacts_change_nothing(views, tmp_path):
    argv = [str(views), "--device", "cpu", *MERGE_SET]
    assert cli.main(["merge-360", argv[0], str(tmp_path / "a.ply"), *argv[1:]]) == 0
    assert cli.main(["merge-360", argv[0], str(tmp_path / "b.ply"), *argv[1:],
                     "--artifacts", str(tmp_path / "art")]) == 0
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    names = sorted(os.listdir(tmp_path / "art"))
    assert names == [f"merge_step_{i:02d}.ply" for i in (1, 2)] + ["progress.json"]
    steps = _progress(tmp_path / "art")
    sizes = [len(ply.read_ply(str(views / f))["points"]) for f in sorted(os.listdir(views))]
    assert [e["step"] for e in steps] == [1, 2]
    assert [e["points"] for e in steps] == list(np.cumsum(sizes)[1:])
    last = ply.read_ply(str(tmp_path / "art" / "merge_step_02.ply"))["points"]
    assert len(last) == sum(sizes)
    # the base view is folded unmoved
    np.testing.assert_array_equal(last[:sizes[0]],
                                  ply.read_ply(str(views / "view_000deg.ply"))["points"])


def test_clean_artifacts_change_nothing(tmp_path, capsys):
    rng = np.random.default_rng(4)
    plane = np.c_[rng.uniform(-80, 80, (1500, 2)), np.full(1500, 450.0)]
    blob = rng.normal(0, 15, (1200, 3)) + [0, 0, 400]
    stray = rng.uniform(-200, 200, (40, 3)) + [0, 0, 300]
    pts = np.concatenate([plane, blob, stray]).astype(np.float32)
    cols = rng.integers(0, 256, (len(pts), 3)).astype(np.uint8)
    ply.write_ply(str(tmp_path / "in.ply"), pts, cols)
    argv = ["--device", "cpu", "--set", "clean.cluster_eps=8.0",
            "--set", "clean.cluster_min_points=10", "--set", "clean.radius=8.0",
            "--set", "clean.radius_nb_points=4"]
    assert cli.main(["clean", str(tmp_path / "in.ply"), str(tmp_path / "a.ply"), *argv]) == 0
    assert cli.main(["clean", str(tmp_path / "in.ply"), str(tmp_path / "b.ply"), *argv,
                     "--artifacts", str(tmp_path / "art")]) == 0
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    steps = ("background", "cluster", "radius", "statistical")
    assert sorted(os.listdir(tmp_path / "art")) == sorted(
        [f"clean_{s}.ply" for s in steps] + ["progress.json"])
    entries = _progress(tmp_path / "art")
    assert [e["file"] for e in entries] == [f"clean_{s}.ply" for s in steps]
    final = ply.read_ply(str(tmp_path / "a.ply"))["points"]
    assert entries[-1]["points"] == len(final) and 0 < len(final) < len(pts)
    assert (tmp_path / "art" / "clean_statistical.ply").read_bytes() == \
        (tmp_path / "a.ply").read_bytes()
