"""The port's ``report`` against the JAX package's, on a port run's journal.

A traced port ``run_pipeline`` (``observability.trace``) on a tiny scene
(the pipeline scene's 4 views at a 96x72 camera and a 64x32 projector,
clean steps scaled to the sampling, stored as .slbp) writes ``trace.jsonl``
and ``metrics.json``. Then, exactly (no tolerance):

- the JAX package's ``validate_journal`` finds no error in it, nor does the
  port's;
- the port's and the JAX package's ``analyze_run`` give equal analyses and
  ``render_report`` equal text, at two widths;
- ``prometheus_text`` of ``metrics.json`` and ``export_chrome_trace`` of
  the journal give equal outputs in both packages, with a lane for each
  executor thread in the trace;
- ``host_journals`` finds the one journal and the merged host timeline has
  one host in both packages;
- the port's ``report`` command exits 0 under ``--validate``, renders,
  prints the metrics under ``--prometheus`` and writes the Chrome trace,
  and exits 1 without a journal.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.pipeline import report as jreport
from structured_light_for_3d_model_replication_tpu.utils import telemetry as jtel
from structured_light_for_3d_model_replication_tpu_torch import cli
from structured_light_for_3d_model_replication_tpu_torch.config import load_config
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import matfile
from structured_light_for_3d_model_replication_tpu_torch.pipeline import report
from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn
from structured_light_for_3d_model_replication_tpu_torch.utils import telemetry as tel

OVERRIDES = {"decode.n_cols": "64", "decode.n_rows": "32", "decode.thresh_mode": "manual",
             "mesh.depth": "4", "merge.voxel_size": "3.0", "merge.icp_iters": "5",
             "parallel.io_workers": "2", "parallel.compute_batch": "2",
             "clean.cluster_eps": "12.0", "clean.cluster_min_points": "5",
             "clean.radius": "12.0", "clean.radius_nb_points": "3",
             "observability.trace": "true"}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("report_ds")
    rig, scene, poses = syn.pipeline_scene(cam_size=(96, 72), proj_size=(64, 32),
                                           n_views=4, step_deg=15.0)
    for i, (R, t) in enumerate(poses):
        frames, _ = syn.render_scene(rig, scene.transformed(R, t))
        imio.save_packed_stack(str(root / "scans" / f"view_{i * 15:03d}deg"),
                               imio.pack_stack(frames))
    matfile.save_calibration(str(root / "calib.npz"), rig.calibration())
    out = root / "out"
    try:
        stages.run_pipeline(str(root / "calib.npz"), str(root / "scans"), str(out),
                            cfg=load_config(None, OVERRIDES), device="cpu",
                            log=lambda m: None)
    finally:
        torch.set_num_threads(n)
    assert (out / "trace.jsonl").is_file() and (out / "metrics.json").is_file()
    return out


def test_the_jax_validator_accepts_the_port_journal(traced):
    path = str(traced / "trace.jsonl")
    assert jreport.validate_journal(path) == []
    assert report.validate_journal(path) == []
    j = jtel.read_journal(path)
    assert j["truncated"] == 0 and j["runs"] == 1
    assert j["events"][-1]["type"] == "end"
    lanes = {e.get("lane") for e in j["events"] if e.get("ev") == "lane"}
    assert {"load", "compute", "clean", "register"} <= lanes
    assert tel.read_journal(path) == j


def test_analysis_and_report_equal_the_jax_package(traced):
    mine = report.analyze_run(str(traced))
    theirs = jreport.analyze_run(str(traced))
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.ended and mine.critical_path_s is not None
    assert mine.meta["backend"] == "jax" and mine.meta["engine"] == "torch"
    for width in (60, 37):
        text = report.render_report(mine, width=width)
        assert text == jreport.render_report(theirs, width=width)
        assert "clean close" in text and "backend jax" in text


@pytest.mark.parametrize("fmt", ["prometheus", "chrome"])
def test_exporters_equal_the_jax_package(traced, tmp_path, fmt):
    if fmt == "prometheus":
        metrics = json.loads((traced / "metrics.json").read_text())
        text = tel.prometheus_text(metrics)
        assert text == jtel.prometheus_text(metrics)
        assert "sl3d_run_wall_seconds" in text
        return
    info = tel.export_chrome_trace(str(traced / "trace.jsonl"), str(tmp_path / "p.json"))
    jinfo = jtel.export_chrome_trace(str(traced / "trace.jsonl"), str(tmp_path / "j.json"))
    assert info == jinfo
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    tracks = [e["args"]["name"] for e in json.loads((tmp_path / "p.json").read_text())
              ["traceEvents"] if e.get("name") == "thread_name"]
    threads = {t.split("[")[1].rstrip("]") for t in tracks}
    assert any(t.startswith("sl3d-drain") for t in threads)
    assert any(t.startswith("sl3d-prefetch") for t in threads)
    assert info["tracks"] == len(tracks) and info["lanes"] >= 5


def test_one_host_journal(traced):
    assert report.host_journals(str(traced)) == jreport.host_journals(str(traced))
    assert len(report.host_journals(str(traced))) == 1
    rows = report.merge_host_timeline(str(traced))
    assert rows == jreport.merge_host_timeline(str(traced))
    assert len({r["host"] for r in rows}) == 1
    assert report.render_host_timeline(rows) == jreport.render_host_timeline(rows)
    assert report.worker_tag("fw0", 2) == "fw0#g2" and report.worker_tag("w1") == "w1"


def test_the_report_command(traced, tmp_path, capsys):
    assert cli.main(["report", str(traced), "--validate"]) == 0
    assert "journal valid" in capsys.readouterr().out
    assert cli.main(["report", str(traced), "--width", "40"]) == 0
    assert capsys.readouterr().out.startswith("flight recorder report")
    assert cli.main(["report", str(traced), "--prometheus"]) == 0
    assert "# TYPE sl3d_run_wall_seconds gauge" in capsys.readouterr().out
    assert cli.main(["report", str(traced), "--chrome-trace", str(tmp_path / "t.json")]) == 0
    assert "chrome trace ->" in capsys.readouterr().out
    assert json.loads((tmp_path / "t.json").read_text())["metadata"]["truncated_lines"] == 0
    assert cli.main(["report", str(tmp_path)]) == 1
    torn = tmp_path / "torn"
    torn.mkdir()
    text = (traced / "trace.jsonl").read_text()
    (torn / "trace.jsonl").write_text(text[:len(text) // 2])
    assert cli.main(["report", str(torn), "--validate"]) == 0
    a = report.analyze_run(str(torn))
    assert not a.ended and a.truncated_lines <= 1
    assert np.isfinite(a.wall_s)
