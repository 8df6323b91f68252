"""The port's ``reconstruct`` against the JAX ``stages.reconstruct``, on the CPU.

A small synthetic dataset (3 turntable views, PNG frames + calib.mat) goes
through both packages. Per-view PLYs must hold the same number of points
with coordinates within 1e-3 mm (the JAX package's contract for device vs
numpy float32, tests/test_synthetic_e2e.py) and equal colors. Within the
port, the packed-ingest, batched and serial lanes write byte-identical
PLYs. Also: the config JSON and the file formats are shared with the JAX
package. No matrix products are involved, so TF32 plays no part.
"""
import os

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import config as jconfig
from structured_light_for_3d_model_replication_tpu.io import images as jimio
from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.pipeline import stages as jstages
from structured_light_for_3d_model_replication_tpu_torch import cli, config
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import matfile, ply
from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

VIEWS = 3
CAM, PROJ = (96, 72), (64, 32)
QUIET = dict(log=lambda m: None)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_ds"))
    rig = syn.default_rig(cam_size=CAM, proj_size=PROJ)
    matfile.save_calibration(os.path.join(root, "calib.mat"), rig.calibration())
    obj, wall = syn.sphere_on_background().objects
    poses = syn.turntable_poses(VIEWS, 360.0 / VIEWS, np.array([0.0, 0.0, 470.0]))
    for i, (R, t) in enumerate(poses):
        frames, _ = syn.render_scene(
            rig, syn.Scene([obj.transformed(R, t), wall]), noise_sigma=2.0,
            rng=np.random.default_rng(i))
        jimio.save_stack(os.path.join(root, f"scan_{i * 120:03d}deg"), frames)
    return root


def _overrides(plane_eval="table"):
    return {"decode.n_cols": PROJ[0], "decode.n_rows": PROJ[1],
            "decode.thresh_mode": "manual", "triangulate.plane_eval": plane_eval,
            "parallel.compute_batch": 2, "parallel.io_workers": 2}


def _run_port(dataset, out, **over):
    cfg = config.load_config(None, dict(_overrides(), **over))
    return stages.reconstruct(os.path.join(dataset, "calib.mat"), dataset,
                              mode="batch", output=str(out), cfg=cfg,
                              device="cpu", **QUIET)


@pytest.mark.parametrize("plane_eval", ["table", "quadratic"])
def test_reconstruct_matches_jax(dataset, tmp_path, plane_eval):
    over = _overrides(plane_eval)
    jcfg = jconfig.load_config(None, dict(over, **{"parallel.backend": "jax"}))
    jrep = jstages.reconstruct(os.path.join(dataset, "calib.mat"), dataset,
                               mode="batch", output=str(tmp_path / "jax"),
                               cfg=jcfg, **QUIET)
    rep = _run_port(dataset, tmp_path / "port", **{"triangulate.plane_eval": plane_eval})
    assert rep.lane == "batched" and rep.launches == 2 and rep.device == "cpu"
    names = sorted(os.path.basename(p) for p in rep.outputs)
    assert names == sorted(os.path.basename(p) for p in jrep.outputs)
    assert len(names) == VIEWS
    for name in names:
        a = ply.read_ply(str(tmp_path / "port" / name))
        b = jply.read_ply(str(tmp_path / "jax" / name))
        assert a["points"].shape == b["points"].shape
        assert len(a["points"]) > 500
        np.testing.assert_allclose(a["points"], b["points"], rtol=0, atol=1e-3)
        np.testing.assert_array_equal(a["colors"], b["colors"])


def test_packed_and_serial_lanes_write_identical_bytes(dataset, tmp_path):
    raw = _run_port(dataset, tmp_path / "raw")
    packed = _run_port(dataset, tmp_path / "packed", **{"pipeline.packed_ingest": True})
    # one view a launch on one I/O thread: the serial lane (at io_workers > 1
    # the per-view pipelined lane takes compute_batch 1)
    serial = _run_port(dataset, tmp_path / "serial", **{"parallel.compute_batch": 1,
                                                        "parallel.io_workers": 1})
    assert (raw.lane, packed.lane, serial.lane) == ("batched", "packed", "serial")
    assert serial.launches == VIEWS
    for p in raw.outputs:
        name = os.path.basename(p)
        data = open(p, "rb").read()
        assert data == (tmp_path / "packed" / name).read_bytes()
        assert data == (tmp_path / "serial" / name).read_bytes()


def test_cli_reconstruct_on_cpu(dataset, tmp_path):
    out = tmp_path / "cli"
    argv = ["reconstruct", dataset, "--calib", os.path.join(dataset, "calib.mat"),
            "--mode", "batch", "--output", str(out), "--device", "cpu",
            "--compute-batch", "2", "--packed-ingest"]
    for k, v in _overrides().items():
        argv += ["--set", f"{k}={v}"]
    assert cli.main(argv) == 0
    assert len(os.listdir(out)) == VIEWS


def test_reconstruct_without_cuda_raises(dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.load_config(None, _overrides())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stages.reconstruct(os.path.join(dataset, "calib.mat"), dataset,
                           mode="batch", output=str(tmp_path), cfg=cfg, **QUIET)


def test_config_json_loads_in_both_packages(tmp_path):
    jcfg = jconfig.Config()
    jcfg.decode.thresh_mode = "manual"
    jcfg.triangulate.plane_eval = "quadratic"
    jcfg.parallel.compute_batch = 3
    jcfg.pipeline.packed_ingest = True
    jcfg.save(str(tmp_path / "jax.json"))
    cfg = config.load_config(str(tmp_path / "jax.json"))
    for section in ("projector", "decode", "triangulate"):
        assert getattr(cfg, section).__dict__ == getattr(jcfg, section).__dict__
    assert (cfg.parallel.compute_batch, cfg.pipeline.packed_ingest) == (3, True)
    # defaults and field names agree; the port's own file loads in the JAX package
    for section, fields in config.Config().to_dict().items():
        jsec = jconfig.Config().to_dict()[section]
        if not isinstance(fields, dict):    # a top-level key (scan_root)
            assert jsec == fields, section
            continue
        assert {k: jsec[k] for k in fields} == fields
    config.Config().save(str(tmp_path / "port.json"))
    assert jconfig.load_config(str(tmp_path / "port.json")).decode == jconfig.DecodeConfig()
    with pytest.raises(ValueError, match="Unknown key"):
        config._from_dict(config.DecodeConfig, {"n_colz": 3})


def test_file_formats_shared_with_jax(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (12, 20, 24), dtype=np.uint8)
    tex = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
    a = imio.save_packed_stack(str(tmp_path / "a"), imio.pack_stack(frames, tex))
    b = jimio.save_packed_stack(str(tmp_path / "b"), jimio.pack_stack(frames, tex))
    assert open(a, "rb").read() == open(b, "rb").read()
    back = imio.load_packed_stack(b)
    np.testing.assert_array_equal(imio.unpack_stack(back)[0],
                                  jimio.unpack_stack(jimio.load_packed_stack(a))[0])
    assert imio.count_frames(str(tmp_path / "b")) == 12
    pts = rng.normal(0, 50, (500, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (500, 3), dtype=np.uint8)
    ply.write_ply(str(tmp_path / "a.ply"), pts, cols)
    jply.write_ply(str(tmp_path / "b.ply"), pts, cols)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    # the reader takes the JAX package's ASCII files too (%.4f, lossy)
    jply.write_ply(str(tmp_path / "c.ply"), pts, cols, binary=False)
    back = ply.read_ply(str(tmp_path / "c.ply"))
    np.testing.assert_allclose(back["points"], pts, atol=1e-4)
    np.testing.assert_array_equal(back["colors"], cols)
