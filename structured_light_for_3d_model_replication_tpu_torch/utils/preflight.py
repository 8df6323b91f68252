"""Card preflight: detect a wedged or missing CUDA device without hanging.

A card that a crashed process left in a bad state, or a driver that stalls,
can make CUDA context creation or the first device operation block for a
long time. Probing in a SUBPROCESS under a timeout turns that into a
bounded, labelled verdict: ``doctor`` runs it before anything touches the
card in its own process.
"""
from __future__ import annotations

import subprocess
import sys

__all__ = ["accelerator_preflight"]

# init AND execute: a context that comes up but whose first operation
# stalls is the second hang signature; one tiny op catches both and adds
# about a second on a healthy card
_PROBE = """\
import torch
if not torch.cuda.is_available():
    print("cpu")
else:
    x = torch.ones(1, device="cuda") + 1
    torch.cuda.synchronize()
    assert float(x.item()) == 2.0
    print(torch.cuda.get_device_name(0))
"""


def accelerator_preflight(timeout: float = 180.0, cwd: str | None = None
                          ) -> tuple[str, str]:
    """Probe CUDA (``torch.cuda.is_available()`` and one device op) in a
    subprocess.

    Returns (status, detail): status is ``"ok"`` (detail = the card's name,
    or ``"cpu"`` when no CUDA device is present), ``"hung"`` (init or the
    first operation exceeded ``timeout``), or ``"failed"`` (nonzero exit;
    detail = stderr tail).
    """
    try:
        probe = subprocess.run([sys.executable, "-c", _PROBE],
                               capture_output=True, text=True,
                               timeout=timeout, cwd=cwd)
    except subprocess.TimeoutExpired:
        return "hung", (f"CUDA init/exec exceeded {timeout:.0f}s "
                        f"(card or driver wedged?)")
    if probe.returncode != 0:
        return "failed", (probe.stderr or "")[-300:]
    lines = (probe.stdout or "").strip().splitlines()
    return "ok", (lines[-1] if lines else "?")
