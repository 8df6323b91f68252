"""Client for the Android camera-host HTTP API (pull-model capture).

The phone app runs an HTTP server (default port 8765) with ``GET /status``,
``GET /capabilities``, ``POST /settings`` (manual exposure / ISO / focus /
zoom / AWB / stabilization) and ``POST /capture/jpeg``, which returns the
JPEG bytes with an ``X-Capture-Meta`` JSON header. Stdlib urllib only.

Every request runs under a bounded transient-retry budget
(``retries``/``backoff_s``, the defaults of ``acquire.http_retries`` /
``acquire.http_backoff_s``): a socket-level failure or a 5xx answer (the
app restarting) retries; a 4xx answer is permanent and never retried. Each
capture attempt fires the ``http.capture`` fault site. Captured frames land
on disk through tmp + rename, so a connection cut mid-body never leaves a
truncated frame behind.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
from dataclasses import asdict, dataclass

from structured_light_for_3d_model_replication_tpu_torch.io.atomic import (
    atomic_write,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import faults

__all__ = ["CameraSettings", "AndroidCameraClient"]


@dataclass
class CameraSettings:
    """Manual camera controls; None fields are left at the phone's defaults.

    Field names are pythonic; ``to_dict`` emits the wire keys the device app
    parses (``exposure_time_ns`` / ``focus_distance`` / ``zoom_ratio`` /
    ``eis`` / ``ois``; the app ignores unknown keys, so a wrong name would
    do nothing without an error; docs/android_protocol.md lists them)"""

    exposure_ns: int | None = None
    iso: int | None = None
    exposure_compensation: int | None = None
    ae_mode: str | None = None          # "on" | "off" (manual)
    af_mode: str | None = None          # "auto" | "off" (manual)
    focus_diopters: float | None = None
    awb_mode: str | None = None
    zoom: float | None = None
    # eis/ois are independent wire controls (EIS's frame warp corrupts
    # structured-light correspondence; OIS does not) — set them separately,
    # or use `stabilization` as a both-at-once convenience
    eis: bool | None = None
    ois: bool | None = None
    stabilization: bool | None = None
    jpeg_quality: int | None = None
    camera_id: str | None = None

    _WIRE_KEYS = {  # pythonic field -> wire key
        "exposure_ns": "exposure_time_ns",
        "focus_diopters": "focus_distance",
        "zoom": "zoom_ratio",
    }

    def to_dict(self) -> dict:
        out = {}
        for k, v in asdict(self).items():
            if v is None:
                continue
            if k == "stabilization":  # convenience: explicit eis/ois win
                out.setdefault("eis", bool(v))
                out.setdefault("ois", bool(v))
            else:
                out[self._WIRE_KEYS.get(k, k)] = v
        return out


class AndroidCameraClient:
    def __init__(self, host: str, port: int = 8765, timeout: float = 10.0,
                 retries: int = 2, backoff_s: float = 0.2,
                 on_retry=None):
        self.base = f"http://{host}:{port}"
        self.timeout = timeout
        self.retry_count = 0  # lifetime transient retries (the blip gauge)
        self._policy = faults.RetryPolicy(max_retries=retries,
                                          backoff_base_s=backoff_s,
                                          backoff_max_s=max(2.0, backoff_s))
        self._on_retry = on_retry  # optional (retry_index, exc) hook

    @staticmethod
    def _transient(e: BaseException) -> bool:
        """Socket-level failures retry; an HTTP status is the app answering,
        so only 5xx (app mid-restart) is worth the budget."""
        if isinstance(e, urllib.error.HTTPError):
            return e.code >= 500
        return faults.is_transient(e)

    def _retry(self, fn):
        def note(n, e):
            self.retry_count += 1
            if self._on_retry is not None:
                self._on_retry(n, e)

        return faults.retry_call(fn, self._policy, classify=self._transient,
                                 on_retry=note)

    def _request(self, path: str, data: bytes | None = None,
                 headers: dict | None = None):
        req = urllib.request.Request(
            self.base + path, data=data, headers=headers or {},
            method="POST" if data is not None else "GET",
        )
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _json(self, path: str, payload: dict | None = None,
              retry: bool = True) -> dict:
        data = None
        headers = {}
        if payload is not None:
            data = json.dumps(payload).encode()
            headers["Content-Type"] = "application/json"

        def _once() -> dict:
            with self._request(path, data, headers) as resp:
                return json.loads(resp.read().decode() or "{}")

        return self._retry(_once) if retry else _once()

    def status(self) -> dict:
        return self._json("/status")

    def capabilities(self) -> dict:
        return self._json("/capabilities")

    def apply_settings(self, settings: CameraSettings) -> dict:
        return self._json("/settings", settings.to_dict())

    def reachable(self) -> bool:
        try:
            # a probe, not a request worth the retry budget: one attempt
            self._json("/status", retry=False)
            return True
        except (urllib.error.URLError, OSError, ValueError):
            return False

    def capture_jpeg(self) -> tuple[bytes, dict]:
        """Trigger a still capture; returns (jpeg_bytes, capture_metadata).
        Transient failures (dropped connection, app restart, injected
        ``http.capture`` faults) retry with backoff inside the budget."""

        def _once() -> tuple[bytes, dict]:
            faults.fire("http.capture", item=self.base)
            with self._request("/capture/jpeg", data=b"") as resp:
                meta_hdr = resp.headers.get("X-Capture-Meta", "{}")
                try:
                    meta = json.loads(meta_hdr)
                except json.JSONDecodeError:
                    meta = {"raw": meta_hdr}
                return resp.read(), meta

        return self._retry(_once)

    def capture_to_path(self, path: str) -> dict:
        """Capture one frame to disk — drop-in CaptureFn for the sequencer.
        tmp+rename publish: a failure at any byte offset leaves no partial
        frame for the decoder to trip on (sync skipped: frame cadence
        matters more than power-loss durability for re-capturable data)."""
        jpeg, meta = self.capture_jpeg()
        with atomic_write(path, sync=False) as tmp, open(tmp, "wb") as f:
            f.write(jpeg)
        return meta
