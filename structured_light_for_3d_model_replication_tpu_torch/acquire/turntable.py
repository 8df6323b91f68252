"""Turntable control: the serial line protocol to the stepper firmware.

The host writes ``"<degrees>\n"`` at 115200 baud; the firmware rotates
(blocking) and answers ``"DONE"``. The driver opens the first serial port
found, waits out the boot delay after opening, and polls for the DONE line
with a timeout.

Three interchangeable backends behind one interface:
  SerialTurntable    real hardware (requires pyserial, imported lazily)
  SimulatedTurntable no hardware: a fixed-delay stand-in
  LoopbackTurntable  deterministic in-memory fake for tests (records every
                     command; scripted failures)

Every ``rotate`` fires the ``serial.rotate`` fault site
(``utils/faults.py``). ``open_turntable("auto")`` takes the simulator when
the serial driver raises ``TurntableError`` (no pyserial, no port), as the
JAX package does: that is the rig's fallback for a missing serial line, not
a device choice.
"""
from __future__ import annotations

import time

from structured_light_for_3d_model_replication_tpu_torch.utils import faults

__all__ = [
    "TurntableError",
    "SerialTurntable",
    "SimulatedTurntable",
    "LoopbackTurntable",
    "open_turntable",
]


class TurntableError(RuntimeError):
    pass


class SerialTurntable:
    """pyserial-backed driver speaking the ``<deg>\\n`` -> ``DONE`` protocol."""

    BAUD = 115200
    BOOT_WAIT_S = 2.0  # firmware resets on port open

    def __init__(self, port: str | None = None, boot_wait: float | None = None):
        try:
            import serial
            import serial.tools.list_ports
        except ImportError as e:  # pragma: no cover - environment dependent
            raise TurntableError(
                "SerialTurntable requires pyserial; use SimulatedTurntable "
                "or LoopbackTurntable without hardware"
            ) from e
        self._serial_mod = serial
        if port is None:
            ports = self.available_ports()
            if not ports:
                raise TurntableError("no serial ports found")
            port = ports[0]
        self.port_name = port
        self._conn = serial.Serial(port, self.BAUD, timeout=0.1)
        time.sleep(self.BOOT_WAIT_S if boot_wait is None else boot_wait)
        self._conn.reset_input_buffer()

    @staticmethod
    def available_ports() -> list[str]:
        try:
            from serial.tools import list_ports
        except ImportError:  # pragma: no cover
            return []
        return [p.device for p in list_ports.comports()]

    def rotate(self, degrees: float) -> None:
        faults.fire("serial.rotate", item=self.port_name)
        # drop any stale DONE from a previously timed-out rotation, or the
        # next wait_for_done would return before the table stops moving
        self._conn.reset_input_buffer()
        self._conn.write(f"{degrees}\n".encode())
        self._conn.flush()

    def reopen(self) -> None:
        """Recovery path for a wedged/dropped serial line: close and re-open
        the port (the firmware resets on open, so this is also the bounded
        re-home — the table holds position, the controller restarts clean).
        The boot delay is paid again; callers re-issue the lost rotation."""
        try:
            self._conn.close()
        except Exception:
            pass
        self._conn = self._serial_mod.Serial(self.port_name, self.BAUD,
                                             timeout=0.1)
        time.sleep(self.BOOT_WAIT_S)
        self._conn.reset_input_buffer()

    def wait_for_done(self, timeout: float = 30.0) -> bool:
        """Poll for the firmware's DONE line at ~10 Hz."""
        deadline = time.monotonic() + timeout
        buf = b""
        while time.monotonic() < deadline:
            buf += self._conn.read(64)
            if b"DONE" in buf:
                return True
            time.sleep(0.1)
        return False

    def close(self) -> None:
        self._conn.close()


class SimulatedTurntable:
    """Hardware-free stand-in: rotations 'complete' after a fixed delay."""

    def __init__(self, rotate_time_s: float = 2.0):
        self.rotate_time_s = rotate_time_s
        self.angle = 0.0
        self._done_at = 0.0

    def rotate(self, degrees: float) -> None:
        faults.fire("serial.rotate", item="sim")
        self.angle = (self.angle + degrees) % 360.0
        self._done_at = time.monotonic() + self.rotate_time_s

    def wait_for_done(self, timeout: float = 30.0) -> bool:
        remaining = self._done_at - time.monotonic()
        if remaining > timeout:
            time.sleep(timeout)
            return False
        if remaining > 0:
            time.sleep(remaining)
        return True

    def close(self) -> None:
        pass


class LoopbackTurntable:
    """Test fake: instant (or scripted) completion, full command log."""

    def __init__(self, fail_after: int | None = None,
                 recover_on_reopen: bool = True):
        self.commands: list[float] = []
        self.fail_after = fail_after
        self.recover_on_reopen = recover_on_reopen
        self.reopens = 0
        self.closed = False

    def rotate(self, degrees: float) -> None:
        faults.fire("serial.rotate", item="loopback")
        self.commands.append(float(degrees))

    def wait_for_done(self, timeout: float = 30.0) -> bool:
        if self.fail_after is not None and len(self.commands) > self.fail_after:
            return False
        return True

    def reopen(self) -> None:
        """Models the serial recovery path: by default the fake 'hardware'
        comes back healthy after a reopen (``recover_on_reopen=False``
        scripts a permanently dead line)."""
        self.reopens += 1
        if self.recover_on_reopen:
            self.fail_after = None

    @property
    def angle(self) -> float:
        return sum(self.commands) % 360.0

    def close(self) -> None:
        self.closed = True


def open_turntable(kind: str = "auto", port: str | None = None,
                   rotate_time_s: float = 2.0):
    """Factory: ``serial``, ``sim``, ``loopback``, or ``auto`` (serial when a
    port opens, else simulation)."""
    if kind == "serial":
        return SerialTurntable(port)
    if kind == "sim":
        return SimulatedTurntable(rotate_time_s)
    if kind == "loopback":
        return LoopbackTurntable()
    if kind == "auto":
        try:
            return SerialTurntable(port)
        except TurntableError:
            return SimulatedTurntable(rotate_time_s)
    raise ValueError(f"unknown turntable kind: {kind}")
