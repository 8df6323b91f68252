"""The port's operator viewer (``acquire/viewer.py``) against the JAX
package's: the same requests get the same status codes and bodies (the
artifacts' mtimes aside), traversal is refused, the calibration pose review
crosses packages both ways (one publishes and waits, the other's server
takes the operator's POST), and ``StageRecorder.autoscan_progress`` writes
the JAX package's entries (their ``t`` aside)."""
from __future__ import annotations

import json
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from structured_light_for_3d_model_replication_tpu.acquire import viewer as jvw
from structured_light_for_3d_model_replication_tpu_torch.acquire import viewer as vw
from structured_light_for_3d_model_replication_tpu_torch.io import ply


def _call(base: str, path: str, data: bytes | None = None, method: str | None = None):
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"} if data
                                 else {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _artifacts(root):
    rec = vw.StageRecorder(str(root))
    rng = np.random.default_rng(0)
    rec.merge_step(0, rng.normal(size=(300, 3)).astype(np.float32),
                   np.full((300, 3), 90, np.uint8))
    rec.merge_step(1, rng.normal(size=(500, 3)).astype(np.float32),
                   np.full((500, 3), 120, np.uint8), total=800)
    rec.autoscan_progress({"view": 2, "turns": 12, "angle": 30.0,
                           "elapsed_s": 10.04, "remaining_s": 50.06})
    (root / "model.stl").write_bytes(b"\x00" * 84)
    (root / "plot.png").write_bytes(b"\x89PNG\r\n\x1a\nfake")
    (root / "notes.txt").write_text("not an artifact")
    (root.parent / "secret.ply").write_bytes(b"ply\nsecret")


SCRIPT = [
    ("GET", "/", None), ("GET", "/index.html", None), ("GET", "/api/list", None),
    ("GET", "/api/file?name=merge_step_01.ply", None), ("GET", "/api/file?name=plot.png", None),
    ("GET", "/api/file?name=model.stl", None), ("GET", "/api/progress", None),
    ("GET", "/api/poses", None), ("POST", "/api/poses", b'{"keep": []}'),
    ("GET", "/api/file?name=../secret.ply", None),
    ("GET", "/api/file?name=%2e%2e%2fsecret.ply", None),
    ("GET", "/api/file?name=notes.txt", None), ("GET", "/api/file?name=missing.ply", None),
    ("GET", "/api/nope", None), ("POST", "/api/nope", b"{}"),
    ("PUBLISH", "", None), ("GET", "/api/poses", None),
    ("POST", "/api/poses", b"not json"), ("POST", "/api/poses", b'{"keep": "a"}'),
    ("POST", "/api/poses", b'{"keep": ["pose_1", "pose_3"]}'),
]


def _run_script(mod, root) -> list:
    out = []
    with mod.ViewerServer(str(root), host="127.0.0.1", port=0) as v:
        base = f"http://127.0.0.1:{v.port}"
        for method, path, data in SCRIPT:
            if method == "PUBLISH":
                mod.publish_pose_review(str(root), {"pose_1": (0.31, 0.62),
                                                    "pose_2": (1.8, 2.4),
                                                    "pose_3": (0.45, 0.71)})
                continue
            status, ctype, body = _call(base, path, data, method)
            if path == "/api/list":
                body = json.loads(body)
                for a in body["artifacts"]:
                    a.pop("mtime")
            elif path == "/api/progress":
                body = [{k: v for k, v in e.items() if k != "t"} for e in json.loads(body)]
            out.append((method, path, status, ctype, body))
    sel = json.loads((root / vw.POSE_SELECTION_FILE).read_text())
    out.append(("selection", sel["keep"]))
    return out


def test_viewer_endpoints_answer_like_the_jax_packages(tmp_path):
    (tmp_path / "port").mkdir()
    _artifacts(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    mine = _run_script(vw, tmp_path / "port")
    theirs = _run_script(jvw, tmp_path / "jax")
    assert mine == theirs
    codes = [r[2] for r in mine[:-1]]
    assert codes == [200, 200, 200, 200, 200, 200, 200, 200, 409, 400, 400, 400, 404,
                     404, 404, 200, 400, 400, 200]
    assert [a["name"] for a in mine[2][4]["artifacts"]] == [
        "merge_step_01.ply", "model.stl", "plot.png"]
    assert mine[3][4].startswith(b"ply") and mine[4][3] == "image/png"
    assert [e["stage"] for e in mine[6][4]] == ["merge", "autoscan"]
    assert mine[-1] == ("selection", ["pose_1", "pose_3"])
    assert b"parsePLY" in mine[0][4] and b"pose review" in mine[0][4].lower()


@pytest.mark.parametrize("publisher,server_mod", [(vw, jvw), (jvw, vw)])
def test_the_pose_review_crosses_packages(tmp_path, publisher, server_mod):
    errors = {"pose_1": (0.31, 0.62), "pose_2": (1.8, 2.4), "pose_3": (0.45, 0.71)}
    publisher.publish_pose_review(str(tmp_path), errors)
    with server_mod.ViewerServer(str(tmp_path), host="127.0.0.1", port=0) as v:
        base = f"http://127.0.0.1:{v.port}"
        _, _, body = _call(base, "/api/poses")
        j = json.loads(body)
        assert j["status"] == "pending" and j["poses"]["pose_2"] == {"cam_px": 1.8,
                                                                     "proj_px": 2.4}
        got: list = []
        waiter = threading.Thread(target=lambda: got.append(
            publisher.await_pose_selection(str(tmp_path), timeout=20, poll=0.05)))
        waiter.start()
        status, _, body = _call(base, "/api/poses", b'{"keep": ["pose_1", "pose_3"]}',
                                "POST")
        assert status == 200 and json.loads(body) == {"ok": True, "kept": 2}
        waiter.join(timeout=20)
        assert got == [["pose_1", "pose_3"]]
        assert json.loads(_call(base, "/api/poses")[2])["status"] == "none"


def test_pose_review_files_and_timeout_equal_the_jax_packages(tmp_path):
    errors = {"a": (0.12345, 1.98765), "b": (2.0, 3.0)}
    for name, mod in (("port", vw), ("jax", jvw)):
        d = tmp_path / name
        d.mkdir()
        (d / mod.POSE_SELECTION_FILE).write_text('{"keep": ["stale"]}')
        path = mod.publish_pose_review(str(d), errors)
        assert not (d / mod.POSE_SELECTION_FILE).exists()
        assert path == str(d / "pose_review.json")
        assert mod.await_pose_selection(str(d), timeout=0.1, poll=0.02) is None
        assert not (d / "pose_review.json").exists()
    assert vw.POSE_REVIEW_FILE == jvw.POSE_REVIEW_FILE
    assert vw.POSE_SELECTION_FILE == jvw.POSE_SELECTION_FILE
    vw.publish_pose_review(str(tmp_path / "x"), errors)
    jvw.publish_pose_review(str(tmp_path / "y"), errors)
    assert (tmp_path / "x" / "pose_review.json").read_bytes() == \
        (tmp_path / "y" / "pose_review.json").read_bytes()


def test_autoscan_progress_entries_equal_the_jax_packages(tmp_path):
    infos = [{"view": i + 1, "turns": 3, "angle": 120.0 * i, "elapsed_s": 1.234 * (i + 1),
              "remaining_s": 2.468 * (2 - i)} for i in range(3)] + [{}]
    entries = []
    for name, mod in (("port", vw), ("jax", jvw)):
        rec = mod.StageRecorder(str(tmp_path / name))
        for info in infos:
            rec.autoscan_progress(info)
        prog = json.loads((tmp_path / name / "progress.json").read_text())
        entries.append([{k: v for k, v in e.items() if k != "t"} for e in prog])
    assert entries[0] == entries[1]
    assert entries[0][0] == {"stage": "autoscan", "view": 1, "turns": 3, "angle": 0.0,
                             "elapsed_s": 1.2, "remaining_s": 4.9}
    assert entries[0][2]["remaining_s"] == 0.0


def test_stage_recorder_downsamples_large_steps(tmp_path):
    rec = vw.StageRecorder(str(tmp_path), max_points_per_step=100)
    rec.merge_step(3, np.zeros((1000, 3), np.float32), np.zeros((1000, 3), np.uint8))
    assert len(ply.read_ply(str(tmp_path / "merge_step_03.ply"))["points"]) == 100
