"""The port's acquisition layer (``acquire/``) against the JAX package's.

Mirrors ``tests/test_acquire.py``, ``test_android_client.py`` and the
webcam tests of ``test_aux_capture.py`` on the port's classes, and holds the
two packages side by side on the same inputs: a protocol-faithful fake phone
gets the same status codes and JSON bodies from both capture servers (the
armed command's random id masked), the sequencers write the same frames,
pack-on-capture writes byte-equal ``frames.slbp`` containers, and
``auto_scan_360`` gives the same ``AutoScanResult`` and progress events
(elapsed seconds aside), also under the same fault specs on
``serial.rotate``, ``http.capture`` and ``frame.pack``. The port's copy of
``capture_page.html`` equals the JAX package's byte for byte, so what
``tests/test_capture_page.py`` pins holds for it too.
"""
from __future__ import annotations

import importlib
import json
import os
import pathlib
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

PORT_PKG = "structured_light_for_3d_model_replication_tpu_torch"
JAX_PKG = "structured_light_for_3d_model_replication_tpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]


class _Pkg:
    """One package's acquisition modules, by short name."""

    def __init__(self, pkg: str):
        self.name = pkg
        for mod in ("acquire.server", "acquire.sequencer", "acquire.projector",
                    "acquire.turntable", "acquire.autoscan", "acquire.android",
                    "acquire.webcam", "acquire.viewer", "utils.faults", "io.images",
                    "ops.graycode"):
            setattr(self, mod.split(".")[1], importlib.import_module(f"{pkg}.{mod}"))


PORT, JAX = _Pkg(PORT_PKG), _Pkg(JAX_PKG)


def _quiet(*_a, **_k):
    pass


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    PORT.faults.reset()
    JAX.faults.reset()


# ---------------------------------------------------------------------------
# the capture server and a protocol-faithful phone
# ---------------------------------------------------------------------------

def _multipart(payload: bytes, fields: dict | None = None):
    boundary = "testboundary42"
    body = b""
    for k, v in (fields or {}).items():
        body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n"
                 f"{v}\r\n").encode()
    body += (f"--{boundary}\r\n"
             'Content-Disposition: form-data; name="file"; filename="f.png"\r\n'
             "Content-Type: image/png\r\n\r\n").encode() + payload \
        + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


class FakePhone(threading.Thread):
    """Long-polls /poll_command, dedups command ids, and uploads
    ``frame(cmd_id)`` (multipart ``file``) for each fresh capture command."""

    def __init__(self, base_url: str, frame=lambda _id: b"fakeimage"):
        super().__init__(daemon=True)
        self.base = base_url
        self.frame = frame
        self.stop_flag = threading.Event()
        self.captures = 0
        self.last_id = None
        self.round_trips: list[float] = []

    def run(self):
        while not self.stop_flag.is_set():
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(self.base + "/poll_command", timeout=5) as r:
                    cmd = json.loads(r.read())
            except OSError:
                continue
            if cmd["action"] == "capture" and cmd["id"] != self.last_id:
                self.last_id = cmd["id"]
                body, ctype = _multipart(self.frame(cmd["id"]))
                req = urllib.request.Request(self.base + "/upload", data=body,
                                             headers={"Content-Type": ctype},
                                             method="POST")
                with urllib.request.urlopen(req, timeout=5) as r:
                    assert json.loads(r.read())["status"] == "ok"
                self.captures += 1
                self.round_trips.append(time.perf_counter() - t0)

    def stop(self):
        self.stop_flag.set()
        self.join(timeout=5)


@pytest.fixture(params=["port", "jax"])
def pkg(request):
    return PORT if request.param == "port" else JAX


@pytest.fixture
def server(pkg):
    srv = pkg.server.CaptureServer(host="127.0.0.1", port=0, poll_hold=0.3).start()
    yield srv
    srv.stop()


def _request(base: str, path: str, data: bytes | None = None, method: str | None = None,
             headers: dict | None = None):
    """(status, body) of one request; an HTTP error answer is a result too."""
    req = urllib.request.Request(base + path, data=data, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_armed(srv) -> str:
    deadline = time.monotonic() + 5
    while srv.state.current_command()["action"] != "capture":
        assert time.monotonic() < deadline
        time.sleep(0.01)
    return srv.state.current_command()["id"]


def _exchange(p: _Pkg, tmp: pathlib.Path) -> list:
    """A fixed script of requests against a fresh server of package ``p``:
    [(what, status, body)] with the armed command's id masked."""
    srv = p.server.CaptureServer(host="127.0.0.1", port=0, poll_hold=0.2,
                                 capture_page="<html>page</html>").start()
    base = f"http://127.0.0.1:{srv.port}"
    out = []

    def rec(what, status, body, armed=""):
        text = body.decode()
        if armed:
            text = text.replace(armed, "<id>").replace(armed[:8], "<id8>")
        text = text.replace(str(tmp), "<tmp>")
        out.append((what, status, text))

    try:
        rec("status", *_request(base, "/status"))
        rec("poll idle", *_request(base, "/poll_command"))
        rec("get unknown", *_request(base, "/nope"))
        rec("post unknown", *_request(base, "/nope", b"x", "POST"))
        rec("page", *_request(base, "/"))
        rec("options", *_request(base, "/upload", method="OPTIONS"))
        rec("unarmed upload", *_request(base, "/upload", b"zz", "POST",
                                        {"Content-Type": "image/png"}))
        rec("empty upload", *_request(base, "/upload", b"", "POST",
                                      {"Content-Type": "image/png"}))
        got = {}
        t = threading.Thread(target=lambda: got.update(
            path=srv.trigger_capture(str(tmp / "a.png"), timeout=10)), daemon=True)
        t.start()
        armed = _wait_armed(srv)
        rec("poll armed", *_request(base, "/poll_command"), armed=armed)
        rec("stale upload", *_request(base, "/upload?id=deadbeef", b"stale", "POST",
                                      {"Content-Type": "image/png"}), armed=armed)
        body, ctype = _multipart(b"fresh", {"id": armed})
        rec("upload", *_request(base, "/upload", body, "POST", {"Content-Type": ctype}),
            armed=armed)
        t.join(timeout=10)
        rec("done", 200, json.dumps([os.path.basename(got["path"]),
                                     (tmp / "a.png").read_bytes().decode()]).encode())
        rec("poll after", *_request(base, "/poll_command"),
            armed=srv.state.current_command()["id"])
    finally:
        srv.stop()
    return out


def test_both_capture_servers_answer_the_same(tmp_path):
    mine = _exchange(PORT, tmp_path / "port")
    theirs = _exchange(JAX, tmp_path / "jax")
    assert [(w, s) for w, s, _ in mine] == [
        ("status", 200), ("poll idle", 200), ("get unknown", 404), ("post unknown", 404),
        ("page", 200), ("options", 204), ("unarmed upload", 409), ("empty upload", 400),
        ("poll armed", 200), ("stale upload", 409), ("upload", 200), ("done", 200),
        ("poll after", 200)]
    assert mine == theirs
    assert json.loads(mine[8][2]) == {"action": "capture", "id": "<id>"}


def test_capture_rendezvous_over_http(server, tmp_path):
    phone = FakePhone(f"http://127.0.0.1:{server.port}")
    phone.start()
    try:
        for i in range(3):
            p = str(tmp_path / f"{i:02d}.png")
            assert server.trigger_capture(p, timeout=10.0) == p
            assert open(p, "rb").read() == b"fakeimage"
        deadline = time.monotonic() + 3
        while phone.captures < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert phone.captures == 3 and server.state.connected
    finally:
        phone.stop()


def test_capture_timeout_without_phone(server, pkg, tmp_path):
    t0 = time.monotonic()
    with pytest.raises(pkg.server.CaptureTimeout):
        server.trigger_capture(str(tmp_path / "x.png"), timeout=0.5)
    assert time.monotonic() - t0 < 5.0
    assert server.state.current_command()["action"] == "idle"


def test_raw_upload_and_query_id(server, tmp_path):
    base = f"http://127.0.0.1:{server.port}"
    for name, path_q, hdr in (("raw", "/upload", {}),
                              ("hdr", "/upload", {"X-Command-Id": "<armed>"}),
                              ("query", "/upload?id=<armed>", {})):
        dest = str(tmp_path / f"{name}.png")
        done = threading.Event()
        threading.Thread(target=lambda: (server.trigger_capture(dest, timeout=10),
                                         done.set()), daemon=True).start()
        armed = _wait_armed(server)
        headers = {"Content-Type": "image/png",
                   **{k: v.replace("<armed>", armed) for k, v in hdr.items()}}
        status, body = _request(base, path_q.replace("<armed>", armed), name.encode(),
                                "POST", headers)
        assert status == 200 and json.loads(body)["status"] == "ok"
        assert done.wait(5.0) and open(dest, "rb").read() == name.encode()


def test_unarmed_upload_falls_back_to_dir(pkg, tmp_path):
    srv = pkg.server.CaptureServer(host="127.0.0.1", port=0, poll_hold=0.3,
                                   upload_dir=str(tmp_path / "drops")).start()
    try:
        status, body = _request(f"http://127.0.0.1:{srv.port}", "/upload",
                                b"manualframe", "POST",
                                {"Content-Type": "application/octet-stream"})
        assert status == 200
        drops = list((tmp_path / "drops").iterdir())
        assert len(drops) == 1 and drops[0].read_bytes() == b"manualframe"
        assert json.loads(body)["path"] == str(drops[0])
    finally:
        srv.stop()


def test_disconnect_monitor_callbacks(pkg):
    state = pkg.server.CaptureState(disconnect_after=0.05)
    seen = []
    state.on_connect = lambda: seen.append("up")
    state.on_disconnect = lambda: seen.append("down")
    state.touch()
    state.touch()
    time.sleep(0.1)
    state.check_disconnect()
    state.check_disconnect()
    assert seen == ["up", "down"] and not state.connected


def test_the_capture_page_is_the_jax_packages_and_ships_as_package_data():
    port_page = ROOT / PORT_PKG / "acquire" / "capture_page.html"
    jax_page = ROOT / JAX_PKG / "acquire" / "capture_page.html"
    assert port_page.read_bytes() == jax_page.read_bytes()
    assert PORT.server.default_capture_page() == port_page.read_text(encoding="utf-8")
    # the page test_capture_page.py pins: poll + multipart upload + dedup
    for token in ("/poll_command", "/upload", "lastProcessedId", "applyConstraints",
                  "FormData", '"image/png"'):
        assert token in PORT.server.default_capture_page(), token
    # pyproject lists it as the port's package data, so an install carries it
    text = (ROOT / "pyproject.toml").read_text()
    line = next(ln for ln in text.splitlines() if ln.startswith(PORT_PKG + " ="))
    globs = json.loads(line.split("=", 1)[1])
    assert "acquire/*.html" in globs
    assert sorted(p.name for g in globs for p in (ROOT / PORT_PKG).glob(g)
                  if p.suffix == ".html") == ["capture_page.html"]


def test_capture_page_served_at_root(server, pkg):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/", timeout=5) as r:
        body = r.read().decode()
        assert r.headers["Content-Type"].startswith("text/html")
    assert body == pkg.server.default_capture_page()


# ---------------------------------------------------------------------------
# projector, turntables, sequencer
# ---------------------------------------------------------------------------

def test_projector_factory_and_virtual_backend(pkg):
    proj = pkg.projector.open_projector("virtual", width=64, height=32)
    assert isinstance(proj, pkg.projector.VirtualProjector) and proj.size == (64, 32)
    proj.show(np.full((32, 64), 7, np.uint8), settle_ms=5)
    assert proj.settle_log == [5] and proj.shown[0].dtype == np.uint8
    proj.close()
    with pytest.raises(ValueError, match="unknown projector kind"):
        pkg.projector.open_projector("hologram")


def test_turntable_backends(pkg):
    tt = pkg.turntable
    lb = tt.LoopbackTurntable()
    lb.rotate(30.0)
    lb.rotate(30.0)
    assert lb.wait_for_done() and lb.angle == 60.0
    sim = tt.SimulatedTurntable(rotate_time_s=0.05)
    sim.rotate(90.0)
    assert sim.wait_for_done(timeout=1.0) and sim.angle == 90.0
    sim.rotate(10.0)
    sim.rotate_time_s = 5.0
    sim.rotate(10.0)
    assert not sim.wait_for_done(timeout=0.05)
    flaky = tt.LoopbackTurntable(fail_after=1)
    flaky.rotate(30.0)
    assert flaky.wait_for_done()
    flaky.rotate(30.0)
    assert not flaky.wait_for_done()
    flaky.reopen()
    assert flaky.wait_for_done() and flaky.reopens == 1
    lb.close()
    assert lb.closed


def test_open_turntable_kinds(pkg):
    tt = pkg.turntable
    assert isinstance(tt.open_turntable("sim", rotate_time_s=0.1), tt.SimulatedTurntable)
    assert isinstance(tt.open_turntable("loopback"), tt.LoopbackTurntable)
    try:
        import serial  # noqa: F401
    except ImportError:
        # no pyserial: the serial driver raises, and "auto" takes the simulator
        with pytest.raises(tt.TurntableError, match="pyserial"):
            tt.open_turntable("serial")
        assert isinstance(tt.open_turntable("auto"), tt.SimulatedTurntable)
    with pytest.raises(ValueError, match="unknown turntable kind"):
        tt.open_turntable("belt")


def test_serial_rotate_fault_site_fires(pkg):
    pkg.faults.configure("serial.rotate~loopback:permanent")
    with pytest.raises(pkg.faults.PermanentFault):
        pkg.turntable.LoopbackTurntable().rotate(5.0)
    sim = pkg.turntable.SimulatedTurntable(rotate_time_s=0.0)
    sim.rotate(5.0)      # item "sim" does not match
    assert sim.angle == 5.0


def _camera(p: _Pkg, proj):
    """The 'camera' photographs whatever the projector shows."""
    return lambda path: p.images.save_image(path, proj.shown[-1])


def test_sequencers_write_the_jax_packages_frames(tmp_path):
    out = {}
    for name, p in (("port", PORT), ("jax", JAX)):
        proj = p.projector.VirtualProjector(64, 32)
        seq = p.sequencer.CaptureSequencer(proj, _camera(p, proj), proj_size=(64, 32),
                                           log=_quiet)
        steps = []
        paths = seq.capture_scan(str(tmp_path / name / "scan"),
                                 progress=lambda i, n: steps.append((i, n)))
        out[name] = (paths, steps, proj.settle_log)
    (paths, steps, settle), (jpaths, jsteps, jsettle) = out["port"], out["jax"]
    n = PORT.graycode.frames_per_view(64, 32)
    assert [os.path.basename(x) for x in paths] == [os.path.basename(x) for x in jpaths] \
        == PORT.sequencer.scan_frame_names(n)
    assert steps == jsteps and steps[-1] == (n, n) and settle == jsettle == [200] * n
    for a, b in zip(paths, jpaths):
        assert open(a, "rb").read() == open(b, "rb").read()
    frames, _ = PORT.images.load_stack(str(tmp_path / "port" / "scan"))
    np.testing.assert_array_equal(frames, PORT.graycode.generate_pattern_stack(64, 32))


def test_sequencer_calibration_poses(pkg, tmp_path):
    proj = pkg.projector.VirtualProjector(32, 16)
    seq = pkg.sequencer.CaptureSequencer(proj, lambda p: open(p, "wb").write(b"x"),
                                         proj_size=(32, 16), log=_quiet)
    seen = []
    dirs = seq.capture_calibration(str(tmp_path), 3, on_pose=seen.append)
    assert seen == [0, 1, 2]
    assert [os.path.basename(d) for d in dirs] == ["pose01", "pose02", "pose03"]
    assert len(os.listdir(dirs[0])) == pkg.graycode.frames_per_view(32, 16)
    assert set(proj.settle_log) == {seq.calib_settle_ms} == {250}
    named = seq.capture_calibration(str(tmp_path / "n"), 2, pose_names=["a", "b"])
    assert [os.path.basename(d) for d in named] == ["a", "b"]


@pytest.mark.parametrize("keep_raw", [False, True])
def test_pack_on_capture_is_byte_equal_to_the_jax_packages(tmp_path, keep_raw):
    out = {}
    for name, p in (("port", PORT), ("jax", JAX)):
        proj = p.projector.VirtualProjector(64, 32)
        seq = p.sequencer.CaptureSequencer(proj, _camera(p, proj), proj_size=(64, 32),
                                           pack_frames=True, pack_keep_raw=keep_raw,
                                           log=_quiet)
        out[name] = seq.capture_scan(str(tmp_path / name / "view"))
    mine, theirs = out["port"], out["jax"]
    assert [os.path.basename(x) for x in mine] == [os.path.basename(x) for x in theirs]
    assert os.path.basename(mine[0]) == PORT.images.PACKED_NAME
    assert open(mine[0], "rb").read() == open(theirs[0], "rb").read()
    left = sorted(os.listdir(tmp_path / "port" / "view"))
    assert left == sorted(os.listdir(tmp_path / "jax" / "view"))
    assert len(left) == (1 + PORT.graycode.frames_per_view(64, 32) if keep_raw else 1)
    # packing an already packed folder returns its container untouched
    assert PORT.images.pack_scan_folder(str(tmp_path / "port" / "view")) == mine[0]
    frames, _ = PORT.images.load_stack(str(tmp_path / "port" / "view"))
    np.testing.assert_array_equal(frames[0], PORT.graycode.generate_pattern_stack(64, 32)[0])


def test_pack_scan_folder_of_a_render_equals_the_jax_packages(tmp_path):
    from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

    rig = syn.default_rig(cam_size=(96, 72), proj_size=(64, 32))
    frames, _ = syn.render_scene(rig, syn.sphere_on_background(), noise_sigma=3.0)
    for name, p in (("port", PORT), ("jax", JAX)):
        p.images.save_stack(str(tmp_path / name), frames)
    a = PORT.images.pack_scan_folder(str(tmp_path / "port"))
    b = JAX.images.pack_scan_folder(str(tmp_path / "jax"))
    assert open(a, "rb").read() == open(b, "rb").read()
    assert os.listdir(tmp_path / "port") == [PORT.images.PACKED_NAME]


def test_frame_pack_fault_site_fires(pkg, tmp_path):
    proj = pkg.projector.VirtualProjector(32, 16)
    seq = pkg.sequencer.CaptureSequencer(proj, _camera(pkg, proj), proj_size=(32, 16),
                                         pack_frames=True, log=_quiet)
    pkg.faults.configure("frame.pack~view:transient")
    with pytest.raises(pkg.faults.TransientFault):
        seq.capture_scan(str(tmp_path / "view"))
    assert len(os.listdir(tmp_path / "view")) == pkg.graycode.frames_per_view(32, 16)
    seq.capture_scan(str(tmp_path / "view"))   # fired once: the retry packs
    assert os.listdir(tmp_path / "view") == [pkg.images.PACKED_NAME]


# ---------------------------------------------------------------------------
# the Android camera host
# ---------------------------------------------------------------------------

SPEC_KEYS = {"camera_id", "jpeg_quality", "ae_mode", "exposure_time_ns", "iso",
             "exposure_compensation", "af_mode", "focus_distance", "awb_mode", "eis",
             "ois", "zoom_ratio"}
_CAMEL = {"camera_id": "cameraId", "jpeg_quality": "jpegQuality", "ae_mode": "aeMode",
          "exposure_time_ns": "exposureTimeNs", "iso": "iso",
          "exposure_compensation": "exposureCompensation", "af_mode": "afMode",
          "focus_distance": "focusDistance", "awb_mode": "awbMode", "eis": "eis",
          "ois": "ois", "zoom_ratio": "zoomRatio"}
_JPEG = b"\xff\xd8\xff\xe0" + b"\x00" * 64 + b"\xff\xd9"


class _DeviceHandler(BaseHTTPRequestHandler):
    """The camera-host app: status, capabilities, settings (unknown keys
    ignored, but recorded) and capture (the server's ``frame`` bytes, else
    a JPEG stub); ``fail_codes`` answers the next captures with those
    statuses."""

    def log_message(self, *a):  # pragma: no cover
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        if self.path == "/status":
            self._json({"ok": True, "device": "FakePixel", "cameraIds": ["0", "1"]})
        elif self.path == "/capabilities":
            self._json({"cameras": [{"cameraId": "0", "isoRange": [50, 6400]}]})
        else:
            self.send_error(404)

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length", "0"))
        raw = self.rfile.read(n) if n else b""
        body = json.loads(raw) if raw else {}
        srv = self.server
        if self.path == "/settings":
            srv.seen_keys.update(body)
            for k in SPEC_KEYS & set(body):
                srv.applied[_CAMEL[k]] = body[k]
            self._json({"ok": True, "applied": dict(srv.applied)})
        elif self.path == "/capture/jpeg":
            if srv.fail_codes:
                self._json({"error": "busy"}, srv.fail_codes.pop(0))
                return
            frame = srv.frame() if srv.frame else _JPEG
            self.send_response(200)
            self.send_header("Content-Type", "image/jpeg")
            self.send_header("X-Capture-Meta", json.dumps({"iso": srv.applied.get("iso")}))
            self.send_header("Content-Length", str(len(frame)))
            self.end_headers()
            self.wfile.write(frame)
        else:
            self.send_error(404)


@pytest.fixture()
def device():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _DeviceHandler)
    httpd.seen_keys, httpd.applied = set(), {"cameraId": "0"}
    httpd.frame, httpd.fail_codes = None, []
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd
    httpd.shutdown()
    httpd.server_close()


def test_android_status_settings_and_capture(pkg, device, tmp_path):
    c = pkg.android.AndroidCameraClient("127.0.0.1", device.server_address[1])
    assert c.reachable() and c.status()["cameraIds"] == ["0", "1"]
    assert c.capabilities()["cameras"][0]["isoRange"] == [50, 6400]
    s = pkg.android.CameraSettings(exposure_ns=8_333_333, iso=100, focus_diopters=2.5,
                                   awb_mode="daylight", zoom=1.5, stabilization=True,
                                   jpeg_quality=97, ae_mode="off", af_mode="off",
                                   exposure_compensation=-2, camera_id="0")
    ap = c.apply_settings(s)["applied"]
    assert not device.seen_keys - SPEC_KEYS
    assert ap["exposureTimeNs"] == 8_333_333 and ap["focusDistance"] == 2.5
    assert ap["zoomRatio"] == 1.5 and ap["eis"] is True and ap["ois"] is True
    jpeg, meta = c.capture_jpeg()
    assert jpeg == _JPEG and meta == {"iso": 100}
    out = tmp_path / "frame.jpg"
    assert c.capture_to_path(str(out)) == {"iso": 100} and out.read_bytes() == _JPEG
    assert not pkg.android.AndroidCameraClient("127.0.0.1", 1).reachable()


def test_camera_settings_wire_keys_equal_the_jax_packages():
    cases = [dict(eis=False, ois=True), dict(eis=False, stabilization=True),
             dict(exposure_ns=1000, focus_diopters=0.5, zoom=2.0, iso=50),
             dict(stabilization=False, camera_id="1", jpeg_quality=90)]
    for kw in cases:
        mine = PORT.android.CameraSettings(**kw).to_dict()
        assert mine == JAX.android.CameraSettings(**kw).to_dict()
        assert set(mine) <= SPEC_KEYS
    assert PORT.android.CameraSettings(eis=False, stabilization=True).to_dict() == \
        {"eis": False, "ois": True}


def test_android_retries_5xx_not_4xx(pkg, device, tmp_path):
    c = pkg.android.AndroidCameraClient("127.0.0.1", device.server_address[1],
                                        retries=2, backoff_s=0.0)
    device.fail_codes = [503]
    c.capture_to_path(str(tmp_path / "a.jpg"))
    assert c.retry_count == 1
    device.fail_codes = [404]
    with pytest.raises(urllib.error.HTTPError) as ei:
        c.capture_to_path(str(tmp_path / "b.jpg"))
    assert ei.value.code == 404 and c.retry_count == 1
    assert not (tmp_path / "b.jpg").exists()
    import io

    assert not c._transient(urllib.error.HTTPError("u", 404, "nf", {}, io.BytesIO()))
    assert c._transient(urllib.error.HTTPError("u", 503, "busy", {}, io.BytesIO()))
    assert c._transient(urllib.error.URLError("drop"))


def test_http_capture_fault_site(pkg, device, tmp_path):
    c = pkg.android.AndroidCameraClient("127.0.0.1", device.server_address[1],
                                        backoff_s=0.0)
    pkg.faults.configure("http.capture:transient")
    c.capture_to_path(str(tmp_path / "frame.jpg"))
    assert c.retry_count == 1 and (tmp_path / "frame.jpg").read_bytes() == _JPEG
    assert [f for f in tmp_path.iterdir() if ".tmp" in f.name] == []
    c2 = pkg.android.AndroidCameraClient("127.0.0.1", device.server_address[1],
                                         retries=1, backoff_s=0.0)
    pkg.faults.configure("http.capture:transientx99")
    with pytest.raises(pkg.faults.TransientFault) as ei:
        c2.capture_to_path(str(tmp_path / "none.jpg"))
    assert ei.value._sl3d_attempts == 2 and not (tmp_path / "none.jpg").exists()


# ---------------------------------------------------------------------------
# the webcam backend
# ---------------------------------------------------------------------------

class _FakeCap:
    def __init__(self, device):
        self.device, self.opened, self.grabs = device, True, 0

    def isOpened(self):  # noqa: N802
        return True

    def set(self, *_):
        return True

    def grab(self):
        self.grabs += 1

    def read(self):
        frame = np.full((48, 64, 3), 90, np.uint8)
        frame[10:20, 10:20] = 200
        return True, frame

    def release(self):
        self.opened = False


def test_webcam_capture_contract_and_sequencer(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setattr(cv2, "VideoCapture", _FakeCap)
    out = str(tmp_path / "cap.png")
    with PORT.webcam.WebcamCapture(device=0, warmup_frames=2) as cam:
        assert cam(out) == out and cam.cap.grabs == 2
    assert os.path.exists(out) and not cam.cap.opened
    seq = PORT.sequencer.CaptureSequencer(PORT.projector.VirtualProjector(),
                                          PORT.webcam.WebcamCapture(), proj_size=(64, 32),
                                          log=_quiet)
    paths = seq.capture_scan(str(tmp_path / "scan"))
    assert len(paths) == 24 and all(os.path.exists(p) for p in paths)
    np.testing.assert_array_equal(PORT.images.load_color(paths[0]),
                                  JAX.images.load_color(paths[0]))


# ---------------------------------------------------------------------------
# auto-scan, side by side, under faults
# ---------------------------------------------------------------------------

def _png(img: np.ndarray) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


def _sweep(p: _Pkg, root: pathlib.Path, device, spec: str, turns: int = 4,
           capture_retries: int = 1, rotate_retries: int = 1, pack: bool = True):
    """One auto-scan of package ``p``: a virtual 32x16 projector, the
    Android host as the camera (it returns the PNG of the frame shown), a
    loopback turntable; the fault plan ``spec`` armed with seed 3."""
    proj = p.projector.VirtualProjector(32, 16)
    client = p.android.AndroidCameraClient("127.0.0.1", device.server_address[1],
                                           retries=1, backoff_s=0.0)
    device.frame = lambda: _png(proj.shown[-1])
    seq = p.sequencer.CaptureSequencer(proj, client.capture_to_path, proj_size=(32, 16),
                                       pack_frames=pack, log=_quiet)
    table = p.turntable.LoopbackTurntable()
    events, logs = [], []
    p.faults.configure(spec, seed=3)
    try:
        res = p.autoscan.auto_scan_360(seq, table, str(root), turns=turns, step_deg=90.0,
                                       capture_retries=capture_retries,
                                       rotate_retries=rotate_retries,
                                       progress=events.append, log=logs.append)
    finally:
        p.faults.reset()
    failures = [{**f.as_dict(), "message": f.message.replace(str(root), "<root>")}
                for f in res.failures]
    summary = {"views": [os.path.basename(d) for d in res.view_dirs],
               "angles": res.angles, "warnings": res.rotation_warnings,
               "failures": failures, "capture_retries": res.capture_retries,
               "rotate_retries": res.rotate_retries, "commands": table.commands,
               "reopens": table.reopens, "http_retries": client.retry_count}
    ev = [{k: v for k, v in e.items() if k != "elapsed_s"} for e in events]
    for e in ev[:-1]:
        e["remaining_s"] = e["remaining_s"] > 0
    logs = [re.sub(r"\(\d+\.\d+s\)|in \d+\.\d+s", "<s>", m.replace(str(root), "<root>"))
            for m in logs]
    return res, summary, ev, logs


@pytest.mark.parametrize("spec", [
    "",
    "serial.rotate:transient",
    "serial.rotate:permanentx3",
    "http.capture:transient@5",
    "http.capture~180deg:permanent",
    "frame.pack:transient",
    "frame.pack~090deg:permanent",
    "http.capture:transientx99%0.05,serial.rotate:transient@2",
])
def test_auto_scan_matches_the_jax_package_under_faults(tmp_path, device, spec):
    mine = _sweep(PORT, tmp_path / "port", device, spec)
    theirs = _sweep(JAX, tmp_path / "jax", device, spec)
    res, summary, events, logs = mine
    assert summary == theirs[1]
    assert events == theirs[2] and logs == theirs[3]
    assert len(events) == 4 and events[-1]["remaining_s"] == 0.0
    assert [e["angle"] for e in events] == [0.0, 90.0, 180.0, 270.0]
    for d in res.view_dirs:   # every surviving view is packed, byte-equal
        name = os.path.basename(d)
        a = tmp_path / "port" / name / "frames.slbp"
        assert a.read_bytes() == (tmp_path / "jax" / name / "frames.slbp").read_bytes()
    if spec == "":
        assert summary["views"] == [PORT.autoscan.view_folder_name("scan", a)
                                    for a in (0, 90, 180, 270)]
        assert summary["commands"] == [90.0, 90.0, 90.0] and not summary["failures"]


def test_auto_scan_quarantine_and_cancel(pkg, tmp_path):
    proj = pkg.projector.VirtualProjector(32, 16)

    def capture(p):
        if "120deg" in os.path.dirname(p):
            raise ValueError("sensor returned garbage")
        open(p, "wb").write(b"x")

    seq = pkg.sequencer.CaptureSequencer(proj, capture, proj_size=(32, 16), log=_quiet)
    res = pkg.autoscan.auto_scan_360(seq, pkg.turntable.LoopbackTurntable(),
                                     str(tmp_path / "a"), turns=3, step_deg=120.0,
                                     capture_retries=2, log=_quiet)
    assert len(res.view_dirs) == 2 and len(res.failures) == 1
    rec = res.failures[0]
    assert "120deg" in rec.view and rec.stage == "capture" and not rec.transient
    assert rec.attempts == 1
    deadline = importlib.import_module(f"{pkg.name}.utils.deadline")
    token = deadline.CancelToken()
    token.cancel("operator stop")
    res = pkg.autoscan.auto_scan_360(seq, pkg.turntable.LoopbackTurntable(),
                                     str(tmp_path / "b"), turns=3, step_deg=120.0,
                                     token=token, log=_quiet)
    assert res.view_dirs == []


def test_auto_scan_over_the_capture_server(tmp_path):
    """The whole rendezvous: the sequencer's capture is the server's
    trigger_capture and a fake phone uploads the PNG of the frame shown;
    the port's packed views equal the JAX package's byte for byte."""
    out = {}
    for name, p in (("port", PORT), ("jax", JAX)):
        proj = p.projector.VirtualProjector(32, 16)
        srv = p.server.CaptureServer(host="127.0.0.1", port=0, poll_hold=0.5).start()
        phone = FakePhone(f"http://127.0.0.1:{srv.port}",
                          frame=lambda _id, proj=proj: _png(proj.shown[-1]))
        phone.start()
        seq = p.sequencer.CaptureSequencer(
            proj, lambda path, srv=srv: srv.trigger_capture(path, timeout=10),
            proj_size=(32, 16), scan_settle_ms=0, pack_frames=True, log=_quiet)
        try:
            res = p.autoscan.auto_scan_360(seq, p.turntable.SimulatedTurntable(0.01),
                                           str(tmp_path / name), turns=2, step_deg=180.0,
                                           log=_quiet)
        finally:
            phone.stop()
            srv.stop()
        out[name] = res
        assert phone.captures == 2 * p.graycode.frames_per_view(32, 16)
    assert [os.path.basename(d) for d in out["port"].view_dirs] == \
        [os.path.basename(d) for d in out["jax"].view_dirs] == ["scan_000deg_scan",
                                                               "scan_180deg_scan"]
    for d in out["port"].view_dirs:
        name = os.path.basename(d)
        assert (tmp_path / "port" / name / "frames.slbp").read_bytes() == \
            (tmp_path / "jax" / name / "frames.slbp").read_bytes()
