"""HTTP capture server: the PC <-> phone acquisition rendezvous.

The phone long-polls ``GET /poll_command`` for work (the handler holds the
request in 0.1 s steps while the command is idle); when the pipeline wants a
frame it arms a capture command with a fresh id and blocks until the phone
POSTs the image to ``/upload``, which stores it at the armed path and
releases the waiter. A monitor thread flags the phone as disconnected after
a silence window. A dependency-free ``http.server`` threading server around
an explicitly locked ``CaptureState``; the rendezvous (``trigger_capture``:
arm, wait, disarm) is the single synchronization point.

The JAX package's wire protocol, status codes and JSON bodies: 409 for an
unarmed or stale upload, 400 for an upload without a file, 404 for an
unknown path. ``GET /`` serves the bundled phone page
(``capture_page.html``, the port's copy of the JAX package's).
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from email import policy
from email.parser import BytesParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["CaptureState", "CaptureServer", "CaptureTimeout"]


class CaptureTimeout(TimeoutError):
    """The phone did not deliver a frame inside the rendezvous window."""


class CaptureState:
    """Locked shared state between the HTTP handlers and the pipeline thread."""

    def __init__(self, disconnect_after: float = 5.0,
                 fallback_dir: str | None = None):
        self._lock = threading.Lock()
        self.command = "idle"
        self.command_id: str = ""
        self.save_path: str | None = None
        self.upload_received = threading.Event()
        self.last_seen = 0.0
        self.connected = False
        self.disconnect_after = disconnect_after
        self.fallback_dir = fallback_dir
        self._fallback_seq = 0
        self.on_connect = None   # optional callbacks for the orchestrator/GUI
        self.on_disconnect = None

    def arm(self, save_path: str) -> str:
        """Arm a capture command; returns the fresh command id."""
        with self._lock:
            self.upload_received.clear()
            self.save_path = save_path
            self.command_id = uuid.uuid4().hex
            self.command = "capture"
            return self.command_id

    def disarm(self) -> None:
        with self._lock:
            self.command = "idle"
            self.save_path = None

    def current_command(self) -> dict:
        with self._lock:
            return {"action": self.command, "id": self.command_id}

    def touch(self) -> None:
        """Record phone activity; fires on_connect on silence -> active edge."""
        with self._lock:
            was = self.connected
            self.last_seen = time.monotonic()
            self.connected = True
            cb = None if was else self.on_connect
        if cb:
            cb()

    def check_disconnect(self) -> None:
        with self._lock:
            silent = time.monotonic() - self.last_seen > self.disconnect_after
            was = self.connected
            if silent and was:
                self.connected = False
                cb = self.on_disconnect
            else:
                cb = None
        if cb:
            cb()

    def complete_upload(self, payload: bytes, upload_id: str | None = None) -> str:
        """Store the uploaded frame at the armed path and release the waiter.

        ``upload_id`` (when the client echoes the command id) guards against a
        late upload from a timed-out command landing on the next command's
        path. Clients that don't send an id (the bundled page doesn't) get
        the armed-command check only. The event is set only if the same
        command is still armed after the file write, so a concurrent re-arm
        can never be released by a stale frame.

        With no capture armed, the frame lands in ``fallback_dir`` (when set)
        under a timestamped name — the standalone ``serve`` flow, where a
        phone uploads without a command round-trip.
        """
        fallback_path = None
        with self._lock:
            if self.command != "capture" or self.save_path is None:
                if self.fallback_dir is None:
                    raise ValueError("no capture armed")
                name = time.strftime("upload_%Y%m%d_%H%M%S")
                fallback_path = os.path.join(
                    self.fallback_dir,
                    f"{name}_{os.getpid()}_{self._fallback_seq}.png")
                self._fallback_seq += 1
        if fallback_path is not None:
            # file IO outside the lock: a slow multi-MB phone upload must not
            # stall /poll_command handlers and connection-state tracking
            os.makedirs(self.fallback_dir, exist_ok=True)
            with open(fallback_path, "wb") as f:
                f.write(payload)
            return fallback_path
        with self._lock:
            if self.command != "capture" or self.save_path is None:
                raise ValueError("capture disarmed during upload")
            if upload_id and upload_id != self.command_id:
                raise ValueError(
                    f"stale upload for command {upload_id[:8]}..., "
                    f"armed is {self.command_id[:8]}..."
                )
            path = self.save_path
            armed_id = self.command_id
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            f.write(payload)
        with self._lock:
            if self.command == "capture" and self.command_id == armed_id:
                self.upload_received.set()
            else:
                raise ValueError("capture disarmed during upload")
        return path


def _multipart_file(headers, body: bytes) -> tuple[bytes | None, str | None]:
    """Extract the ``file`` field (and optional ``id`` field) from a
    multipart/form-data body (stdlib only). Returns (payload, command_id)."""
    ctype = headers.get("Content-Type", "")
    if not ctype.startswith("multipart/"):
        return body or None, None  # raw-body fallback for simple clients
    msg = BytesParser(policy=policy.HTTP).parsebytes(
        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body
    )
    fallback = None
    found = None
    cmd_id = None
    for part in msg.iter_parts():
        payload = part.get_payload(decode=True)
        if payload is None:
            continue
        name = part.get_param("name", header="content-disposition")
        if name == "file":
            found = payload
        elif name == "id":
            cmd_id = payload.decode(errors="replace").strip()
        elif fallback is None:
            fallback = payload
    return (found if found is not None else fallback), cmd_id


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # pragma: no cover - logging detail
        pass

    @property
    def state(self) -> CaptureState:
        return self.server.capture_state  # type: ignore[attr-defined]

    def _json(self, obj: dict, code: int = 200) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(data)

    def do_OPTIONS(self):  # CORS preflight
        self.send_response(204)
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
        self.send_header("Access-Control-Allow-Headers", "Content-Type")
        self.end_headers()

    def do_GET(self):
        path = self.path.split("?")[0]
        if path == "/poll_command":
            self.state.touch()
            # long-poll: hold while idle (poll_hold, in 0.1 s steps) so
            # the phone does not spam
            deadline = time.monotonic() + self.server.poll_hold  # type: ignore[attr-defined]
            while time.monotonic() < deadline:
                cmd = self.state.current_command()
                if cmd["action"] != "idle":
                    break
                time.sleep(0.1)
            self._json(self.state.current_command())
        elif path == "/status":
            st = self.state
            self._json({
                "connected": st.connected,
                "command": st.current_command(),
            })
        elif path in ("/", "/index.html"):
            page = self.server.capture_page  # type: ignore[attr-defined]
            if page is None:
                self._json({"error": "no capture page configured"}, 404)
            else:
                data = page.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):
        if self.path.split("?")[0] != "/upload":
            self._json({"error": "not found"}, 404)
            return
        self.state.touch()
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b""
        payload, cmd_id = _multipart_file(self.headers, body)
        # the id may also travel as a header or query param for raw-body clients
        cmd_id = cmd_id or self.headers.get("X-Command-Id")
        if cmd_id is None and "?" in self.path:
            from urllib.parse import parse_qs, urlsplit

            cmd_id = parse_qs(urlsplit(self.path).query).get("id", [None])[0]
        if not payload:
            self._json({"error": "no file in upload"}, 400)
            return
        try:
            path = self.state.complete_upload(payload, cmd_id)
        except ValueError as e:
            self._json({"error": str(e)}, 409)
            return
        self._json({"status": "ok", "path": path})


def default_capture_page() -> str | None:
    """The bundled phone capture client (capture_page.html), served at
    GET /."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "capture_page.html")
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:  # pragma: no cover - packaging problem only
        return None


class CaptureServer:
    """Threaded capture server + the pipeline-side rendezvous API."""

    def __init__(self, host: str = "0.0.0.0", port: int = 5000,
                 poll_hold: float = 2.0, disconnect_after: float = 5.0,
                 capture_page: str | None = None,
                 upload_dir: str | None = None):
        if capture_page is None:
            capture_page = default_capture_page()
        self.state = CaptureState(disconnect_after=disconnect_after,
                                  fallback_dir=upload_dir)
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.capture_state = self.state  # type: ignore[attr-defined]
        self._httpd.poll_hold = poll_hold       # type: ignore[attr-defined]
        self._httpd.capture_page = capture_page  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self._serve_thread: threading.Thread | None = None
        self._monitor_stop = threading.Event()
        self._monitor_thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "CaptureServer":
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="capture-http"
        )
        self._serve_thread.start()
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name="capture-monitor"
        )
        self._monitor_thread.start()
        return self

    def _monitor(self) -> None:
        while not self._monitor_stop.wait(1.0):
            self.state.check_disconnect()

    def stop(self) -> None:
        self._monitor_stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "CaptureServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def trigger_capture(self, save_path: str, timeout: float = 20.0) -> str:
        """Arm a capture and block until the phone uploads (the single
        cross-machine sync point); disarm whatever happens."""
        self.state.arm(save_path)
        try:
            if not self.state.upload_received.wait(timeout):
                raise CaptureTimeout(
                    f"no upload within {timeout:.0f}s for {save_path}"
                )
        finally:
            self.state.disarm()
        return save_path
