"""The port's capture commands against the JAX CLI's.

``calibrate`` (``--analyze-only``, ``--poses``, automatic pruning,
``--review`` answered through the viewer) and ``inspect-calib`` print the
JAX CLI's text and write a ``calib.mat`` equal to its (rtol 1e-9) on the
same rendered pose folders (a 640x480 camera and a 128x64 projector: at
320x240 the 6 x 9 board's squares are too small to detect); ``scan`` and
``auto-scan`` run with ``acquire.simulate=true`` against a fake phone, and
``auto-scan`` writes the JAX CLI's folders and ``frames.slbp`` bytes;
``capture-serve`` and ``viewer`` start in a subprocess, answer one request
and exit 0 on SIGINT. The arguments and defaults of the six commands are
the JAX CLI's.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from structured_light_for_3d_model_replication_tpu import cli as jcli  # noqa: E402
from structured_light_for_3d_model_replication_tpu.io import matfile as jmat  # noqa: E402
from structured_light_for_3d_model_replication_tpu_torch import cli  # noqa: E402
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio  # noqa: E402
from structured_light_for_3d_model_replication_tpu_torch.io import matfile  # noqa: E402
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMMANDS = ("calibrate", "inspect-calib", "capture-serve", "viewer", "scan", "auto-scan")
BOARD_SET = ["--set", "checkerboard.rows=6", "--set", "checkerboard.cols=9",
             "--set", "checkerboard.square_size_mm=15", "--set", "projector.width=128",
             "--set", "projector.height=64"]


@pytest.fixture(scope="module", autouse=True)
def _one_cv2_thread():
    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)   # OpenCV's threaded solves reduce in a varying order
    yield
    cv2.setNumThreads(threads)


@pytest.fixture(scope="module")
def poses(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_poses")
    rig = syn.default_rig(cam_size=(640, 480), proj_size=(128, 64))
    for i, board in enumerate(syn.calibration_poses(rig, 6, 9, 15.0, n=5, near=450.0,
                                                    far=650.0)):
        imio.save_stack(str(root / f"pose{i + 1:02d}"), syn.render_chessboard(rig, board))
    return root


def _subparsers(parser: argparse.ArgumentParser) -> dict:
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _jax_parser() -> argparse.ArgumentParser:
    from structured_light_for_3d_model_replication_tpu.pipeline import cli_commands

    parser = argparse.ArgumentParser(prog="sl3d")
    sub = parser.add_subparsers(dest="command")
    cli_commands.register(sub, jcli._add_config_args)
    return parser


def test_the_six_commands_take_the_jax_clis_arguments_and_defaults():
    mine, theirs = _subparsers(cli._parser()), _subparsers(_jax_parser())
    for name in COMMANDS:
        a = {x.dest: (x.option_strings, x.default, x.type, x.nargs, x.required)
             for x in mine[name]._actions if x.dest != "help"}
        b = {x.dest: (x.option_strings, x.default, x.type, x.nargs, x.required)
             for x in theirs[name]._actions if x.dest != "help"}
        assert a == b, name
    out = subprocess.run([sys.executable, "-m", cli.__name__.rsplit(".", 1)[0], "--help"],
                         cwd=str(ROOT), capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0
    for name in COMMANDS:
        assert name in out.stdout


def _run_both(tmp_path, poses, argv_tail, name="calib.mat", setup=None):
    """Run ``calibrate`` of both CLIs on copies of the pose folders:
    [(stdout with the folder masked, loaded calib or None)] port, JAX."""
    out = []
    for tag, main, load in (("port", cli.main, matfile.load_calibration),
                            ("jax", jcli.main, jmat.load_calibration)):
        d = tmp_path / tag
        shutil.copytree(poses, d)
        if setup is not None:
            setup(d)
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["calibrate", str(d), *argv_tail(d), *BOARD_SET])
        assert rc == 0
        path = d / name
        out.append((buf.getvalue().replace(str(d), "<dir>"),
                    load(str(path)) if path.exists() else None))
    return out


def _same_calib(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k], np.float64), np.asarray(b[k], np.float64),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("argv", [["--analyze-only"], [], ["--poses", "pose01,pose02,pose05"],
                                  ["--max-cam-err", "0", "--max-proj-err", "0"]],
                         ids=["analyze-only", "auto", "poses", "fallback"])
def test_calibrate_prints_and_writes_what_the_jax_cli_does(tmp_path, poses, argv):
    (mine, mcal), (theirs, jcal) = _run_both(tmp_path, poses, lambda d: argv)
    assert mine == theirs
    lines = mine.splitlines()
    assert lines[0] == f"{'pose':<20} {'cam px':>8} {'proj px':>8}  quality"
    assert [ln.split()[0] for ln in lines[1:6]] == [f"pose{i:02d}" for i in range(1, 6)]
    if argv == ["--analyze-only"]:
        assert mcal is None and jcal is None and len(lines) == 6
        return
    _same_calib(mcal, jcal)
    if argv[:1] == ["--poses"]:
        assert "using 3/5 poses: pose01, pose02, pose05" in mine
    if argv[:1] == ["--max-cam-err"]:
        assert "using 3/5 poses" in mine


def test_calibrate_review_takes_the_viewers_selection(tmp_path, poses):
    from structured_light_for_3d_model_replication_tpu_torch.acquire import viewer as vw

    def answer(d):
        art = d.parent / f"{d.name}_art"

        def post():
            review = art / vw.POSE_REVIEW_FILE
            deadline = time.monotonic() + 60
            while not review.exists():
                assert time.monotonic() < deadline
                time.sleep(0.02)
            with vw.ViewerServer(str(art), host="127.0.0.1", port=0) as v:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{v.port}/api/poses",
                    data=json.dumps({"keep": ["pose02", "pose03", "pose04", "nope"]}).encode(),
                    method="POST")
                urllib.request.urlopen(req, timeout=10).read()

        threading.Thread(target=post, daemon=True).start()

    (mine, mcal), (theirs, jcal) = _run_both(
        tmp_path, poses, lambda d: ["--review", str(d.parent / f"{d.name}_art"),
                                    "--review-timeout", "60"], setup=answer)
    mine = mine.replace(str(tmp_path / "port_art"), "<art>")
    theirs = theirs.replace(str(tmp_path / "jax_art"), "<art>")
    assert mine == theirs and "using 3/5 poses: pose02, pose03, pose04" in mine
    _same_calib(mcal, jcal)


def test_inspect_calib_prints_what_the_jax_cli_does(tmp_path, poses, capsys):
    rig = syn.default_rig(cam_size=(64, 48), proj_size=(32, 16))
    path = str(tmp_path / "rig.mat")
    matfile.save_calibration(path, rig.calibration())
    assert cli.main(["inspect-calib", path]) == 0
    mine = capsys.readouterr().out
    assert jcli.main(["inspect-calib", path]) == 0
    assert mine == capsys.readouterr().out
    assert mine.startswith("=== Calibration summary ===") and "baseline:" in mine
    pytest.importorskip("matplotlib")
    assert cli.main(["inspect-calib", path, "--plot", str(tmp_path / "rig.png")]) == 0
    assert capsys.readouterr().out.endswith(f"rig plot -> {tmp_path / 'rig.png'}\n")
    assert (tmp_path / "rig.png").stat().st_size > 10_000


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Phone(threading.Thread):
    """Long-polls the capture server and uploads a 16x8 gray PNG (the value
    is the capture's ordinal) for each fresh command."""

    def __init__(self, port: int):
        super().__init__(daemon=True)
        self.base = f"http://127.0.0.1:{port}"
        self.stop_flag = threading.Event()
        self.captures = 0

    def run(self):
        last = None
        while not self.stop_flag.is_set():
            try:
                with urllib.request.urlopen(self.base + "/poll_command", timeout=5) as r:
                    cmd = json.loads(r.read())
            except OSError:
                time.sleep(0.02)
                continue
            if cmd["action"] == "capture" and cmd["id"] != last:
                last = cmd["id"]
                ok, png = cv2.imencode(".png", np.full((8, 16), 10 * (self.captures % 20),
                                                       np.uint8))
                req = urllib.request.Request(self.base + "/upload", data=png.tobytes(),
                                             headers={"Content-Type": "image/png"},
                                             method="POST")
                urllib.request.urlopen(req, timeout=5).read()
                self.captures += 1


def _rig_set(port: int) -> list[str]:
    return ["--set", "acquire.simulate=true", "--set", f"acquire.http_port={port}",
            "--set", "acquire.http_host=127.0.0.1", "--set", "acquire.settle_ms_scan=0",
            "--set", "projector.width=16", "--set", "projector.height=8"]


def test_scan_captures_one_sequence_from_the_phone(tmp_path):
    port = _free_port()
    phone = _Phone(port)
    phone.start()
    try:
        assert cli.main(["scan", str(tmp_path / "scan"), *_rig_set(port)]) == 0
    finally:
        phone.stop_flag.set()
        phone.join(timeout=10)
    names = sorted(os.listdir(tmp_path / "scan"))
    assert names == [f"{i + 1:02d}.png" for i in range(16)] and phone.captures == 16


def test_auto_scan_writes_the_jax_clis_views(tmp_path):
    for tag, main in (("port", cli.main), ("jax", jcli.main)):
        port = _free_port()
        phone = _Phone(port)
        phone.start()
        try:
            rc = main(["auto-scan", str(tmp_path / tag), "--base-name", "bust",
                       "--artifacts", str(tmp_path / f"{tag}_art"), *_rig_set(port),
                       "--set", "acquire.turns=2", "--set", "acquire.degrees_per_turn=180",
                       "--set", "acquire.pack_frames=true"])
        finally:
            phone.stop_flag.set()
            phone.join(timeout=10)
        assert rc == 0 and phone.captures == 32
    views = sorted(os.listdir(tmp_path / "port"))
    assert views == sorted(os.listdir(tmp_path / "jax")) == ["bust_000deg_scan",
                                                             "bust_180deg_scan"]
    for v in views:
        assert os.listdir(tmp_path / "port" / v) == ["frames.slbp"]
        assert (tmp_path / "port" / v / "frames.slbp").read_bytes() == \
            (tmp_path / "jax" / v / "frames.slbp").read_bytes()
    prog = json.loads((tmp_path / "port_art" / "progress.json").read_text())
    assert [(e["stage"], e["view"], e["angle"]) for e in prog] == [
        ("autoscan", 1, 0.0), ("autoscan", 2, 180.0)]
    assert prog[-1]["remaining_s"] == 0.0


def _serve(argv: list[str], n_lines: int, tmp_path) -> tuple[list[str], subprocess.Popen]:
    proc = subprocess.Popen([sys.executable, "-m", cli.__name__.rsplit(".", 1)[0], *argv],
                            cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    lines = [proc.stdout.readline() for _ in range(n_lines)]
    return lines, proc


def _url(line: str) -> str:
    return line.split(" on ", 1)[1].split()[0]


@pytest.mark.parametrize("viewer", [False, True])
def test_capture_serve_answers_and_stops_on_sigint(tmp_path, viewer):
    argv = ["capture-serve", "--save-dir", str(tmp_path / "drops"), "--set",
            "acquire.http_port=0", "--set", "acquire.http_host=127.0.0.1"]
    if viewer:
        argv += ["--viewer", "--artifact-dir", str(tmp_path / "arts")]
    lines, proc = _serve(argv, 2 if viewer else 1, tmp_path)
    try:
        assert lines[0].startswith("capture server on http://127.0.0.1:"), lines
        with urllib.request.urlopen(_url(lines[0]) + "/status", timeout=10) as r:
            assert json.loads(r.read()) == {"connected": False,
                                            "command": {"action": "idle", "id": ""}}
        req = urllib.request.Request(_url(lines[0]) + "/upload", data=b"frame",
                                     headers={"Content-Type": "image/png"}, method="POST")
        assert json.loads(urllib.request.urlopen(req, timeout=10).read())["status"] == "ok"
        assert [p.read_bytes() for p in (tmp_path / "drops").iterdir()] == [b"frame"]
        if viewer:
            assert lines[1].startswith("artifact viewer on http://127.0.0.1:")
            with urllib.request.urlopen(_url(lines[1]) + "/api/list", timeout=10) as r:
                assert json.loads(r.read()) == {"artifacts": []}
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=30)
    assert rc == 0, proc.stderr.read()


def test_viewer_answers_and_stops_on_sigint(tmp_path):
    (tmp_path / "arts").mkdir()
    (tmp_path / "arts" / "model.stl").write_bytes(b"\x00" * 84)
    lines, proc = _serve(["viewer", str(tmp_path / "arts"), "--port", "0", "--set",
                          "acquire.http_host=127.0.0.1"], 1, tmp_path)
    try:
        assert lines[0].startswith("artifact viewer on http://127.0.0.1:"), lines
        with urllib.request.urlopen(_url(lines[0]) + "/api/list", timeout=10) as r:
            assert [a["name"] for a in json.loads(r.read())["artifacts"]] == ["model.stl"]
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=30)
    assert rc == 0, proc.stderr.read()
