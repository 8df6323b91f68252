"""Auto-scan 360: the turntable sweep orchestrator.

N turns of (capture the full pattern sequence) -> (rotate the turntable,
wait for DONE), each view written to ``{base}_{angle:03d}deg_scan/`` (the
``<n>deg`` tag the merge sorts by). A rotation that still fails after its
retries logs a warning and the sweep goes on. Progress events carry the
elapsed and the estimated remaining wall-clock.

Each hardware step has a bounded recovery budget:

  - a failed capture sequence (dropped phone connection, an ``http.capture``
    or ``frame.pack`` fault) retries up to ``capture_retries`` times when
    the error is transient; an exhausted budget records the view as a
    ``FailureRecord`` in ``AutoScanResult.failures`` and the sweep goes on
    (the pipeline's view floor handles the hole downstream);
  - a failed rotation (missed DONE, serial error, a ``serial.rotate``
    fault) retries up to ``rotate_retries`` times, calling the turntable's
    ``reopen()`` between attempts when it has one.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable

from structured_light_for_3d_model_replication_tpu_torch.utils import faults

__all__ = ["AutoScanResult", "auto_scan_360", "view_folder_name"]


def view_folder_name(base: str, angle_deg: float) -> str:
    """The angle-tagged folder contract the merge stage sorts by (the
    ``"<n>deg"`` substring)."""
    return f"{base}_{int(round(angle_deg)):03d}deg_scan"


@dataclass
class AutoScanResult:
    view_dirs: list[str] = field(default_factory=list)
    angles: list[float] = field(default_factory=list)
    rotation_warnings: list[int] = field(default_factory=list)
    failures: list[faults.FailureRecord] = field(default_factory=list)
    capture_retries: int = 0
    rotate_retries: int = 0
    elapsed_s: float = 0.0


def _capture_view(sequencer, view_dir: str, retries: int,
                  result: AutoScanResult, view_name: str, log) -> bool:
    """One per-view capture under a bounded retry budget; False quarantines
    the view (recorded in ``result.failures``) and the sweep continues."""
    for attempt in range(1, retries + 2):
        try:
            sequencer.capture_scan(view_dir)
            return True
        except faults.InjectedCrash:
            raise
        except Exception as e:
            if attempt <= retries and faults.is_transient(e):
                result.capture_retries += 1
                log(f"[autoscan] {view_name}: capture failed "
                    f"({type(e).__name__}: {e}); retry "
                    f"{attempt}/{retries}")
                continue
            rec = faults.FailureRecord.from_exception(
                "capture", view_name, e, attempts=attempt)
            result.failures.append(rec)
            log(f"[autoscan] {view_name} FAILED after {attempt} "
                f"attempt(s): {e} — continuing the sweep without it")
            return False


def _rotate_step(turntable, step_deg: float, timeout: float, retries: int,
                 result: AutoScanResult, step_index: int, log) -> bool:
    """Rotate + wait-DONE with serial recovery: on a missed DONE or a serial
    error, re-open the port (``turntable.reopen()`` when available) and
    re-issue the rotation, up to ``retries`` times. Exhaustion degrades to
    warn-and-continue."""
    for attempt in range(1, retries + 2):
        try:
            turntable.rotate(step_deg)
            if turntable.wait_for_done(timeout):
                return True
            err: Exception = TimeoutError(
                f"rotation {step_index} missed DONE within {timeout:.0f}s")
        except faults.InjectedCrash:
            raise
        except Exception as e:
            err = e
        if attempt > retries:
            break
        result.rotate_retries += 1
        log(f"[autoscan] rotation {step_index} failed ({err}); "
            f"re-opening the turntable and retrying "
            f"{attempt}/{retries}")
        reopen = getattr(turntable, "reopen", None)
        if reopen is not None:
            try:
                reopen()
            except Exception as e:
                log(f"[autoscan] turntable re-open failed ({e})")
    # go on with a warning
    log(f"[autoscan] WARNING: rotation {step_index} failed ({err}); "
        f"continuing")
    result.rotation_warnings.append(step_index)
    return False


def auto_scan_360(sequencer, turntable, output_root: str,
                  turns: int = 12, step_deg: float = 30.0,
                  base_name: str = "scan", rotate_timeout: float = 30.0,
                  capture_retries: int = 0, rotate_retries: int = 0,
                  progress: Callable[[dict], None] | None = None,
                  token=None, log=print) -> AutoScanResult:
    """Run the full turntable sweep; returns per-view folders + angles.

    ``sequencer`` is a CaptureSequencer (or anything with ``capture_scan``);
    ``turntable`` anything with ``rotate``/``wait_for_done`` (serial, sim,
    fake — ``reopen()`` is used for recovery when present).
    ``capture_retries``/``rotate_retries`` default to 0 (one attempt); the
    CLI wires ``acquire.capture_retries`` / ``acquire.rotate_retries``.

    ``token`` (a :class:`~.utils.deadline.CancelToken`) makes the sweep
    cooperatively cancellable: checked between hardware steps, a raised
    token stops the sweep CLEANLY after the current view — captured views
    remain usable, nothing half-rotates. An hours-long sweep should never
    need ``kill -9`` to stop.
    """
    os.makedirs(output_root, exist_ok=True)
    result = AutoScanResult()
    t0 = time.monotonic()
    for i in range(turns):
        if token is not None and token.cancelled:
            log(f"[autoscan] cancelled after {i}/{turns} view(s) "
                f"({token.reason or 'no reason given'}); stopping the "
                f"sweep cleanly")
            break
        angle = i * step_deg
        view_dir = os.path.join(output_root, view_folder_name(base_name, angle))
        view_name = os.path.basename(view_dir)
        log(f"[autoscan] view {i + 1}/{turns} @ {angle:.0f}deg")
        if _capture_view(sequencer, view_dir, capture_retries, result,
                         view_name, log):
            result.view_dirs.append(view_dir)
            result.angles.append(angle)
        if progress:
            elapsed = time.monotonic() - t0
            per_view = elapsed / (i + 1)
            progress({
                "view": i + 1, "turns": turns, "angle": angle,
                "elapsed_s": elapsed,
                "remaining_s": per_view * (turns - i - 1),
            })
        if i < turns - 1:
            _rotate_step(turntable, step_deg, rotate_timeout, rotate_retries,
                         result, i + 1, log)
    result.elapsed_s = time.monotonic() - t0
    done = f"{len(result.view_dirs)}/{turns} views"
    if result.failures:
        done += f" ({len(result.failures)} FAILED + quarantined)"
    log(f"[autoscan] {done} in {result.elapsed_s:.1f}s")
    return result
