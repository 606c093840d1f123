"""No-progress watchdog (port of esr_tpu/utils/watchdog.py; stdlib only).

A long loop calls :meth:`Watchdog.beat` after every unit of progress (an
evaluated image, a dataset boundary); a daemon thread checks the time since
the last beat against ``max(min_timeout, factor * EMA(progress time))`` and,
on a stall, logs the state and hard-exits the process with code 86
(``os._exit``: a thread wedged in a device call would wedge atexit hooks
too), so that a supervisor can restart the run.
"""

from __future__ import annotations

import logging
import os
import threading
import time

__all__ = ["Watchdog", "STALL_EXIT_CODE", "DEFAULT_FLOOR", "arm_from_opt"]

STALL_EXIT_CODE = 86

# Default-on floor: generous enough that a slow first call (kernel builds)
# never fires it; the watchdog exists for the hours-silent wedge.
DEFAULT_FLOOR = 900.0


def _die(rc: int, msg: str) -> None:
    """Log and hard-exit (module-level so tests can monkeypatch it)."""
    logging.getLogger("base").error(msg)
    for h in logging.getLogger("base").handlers:
        try:
            h.flush()
        except Exception:  # noqa: BLE001 — flushing is best-effort pre-exit
            pass
    os._exit(rc)


def arm_from_opt(value, factor=None, logger=None, label: str = "train"):
    """Resolve the ``watchdog`` option into an armed :class:`Watchdog`.

    - unset/``None``/``true`` -> armed with the :data:`DEFAULT_FLOOR`
    - a positive number       -> armed with that floor (seconds)
    - ``false`` or ``<= 0``   -> disarmed (returns ``None``)
    """
    if value is False or (
        isinstance(value, (int, float)) and not isinstance(value, bool) and float(value) <= 0
    ):
        return None
    floor = DEFAULT_FLOOR if value is None or value is True else float(value)
    wd = Watchdog(min_timeout=floor, factor=float(factor) if factor else 50.0)
    if logger is not None:
        logger.info(
            f"watchdog armed ({label}): min {wd.min_timeout:.0f}s / "
            f"{wd.factor:.0f}x EMA progress time; on stall exits "
            f'{STALL_EXIT_CODE} for a supervisor restart (disable: "watchdog": false)'
        )
    return wd


class Watchdog:
    """Heartbeat-based stall detector (see module docstring).

    Args:
        min_timeout: absolute floor in seconds — never fire earlier than
            this after the last beat.
        factor: multiple of the EMA progress time that must elapse beat-free
            before the run counts as stalled.
        poll: checker thread wake interval.
    """

    def __init__(self, min_timeout: float = 600.0, factor: float = 50.0, poll: float = 1.0):
        self.min_timeout = float(min_timeout)
        self.factor = float(factor)
        self.poll = float(poll)
        self._ema: float | None = None
        self._last = time.monotonic()
        self._step = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="esr-watchdog")
        self._thread.start()

    def beat(self, step: int | None = None, count: bool = True) -> None:
        """Record progress. ``count=False`` resets the silence clock without
        folding the interval into the EMA (for phases whose duration is not a
        unit of progress, such as a dataset boundary)."""
        now = time.monotonic()
        if count:
            dt = now - self._last
            self._ema = dt if self._ema is None else 0.9 * self._ema + 0.1 * dt
        self._last = now
        if step is not None:
            self._step = int(step)

    def timeout(self) -> float:
        ema = self._ema
        return max(self.min_timeout, self.factor * ema) if ema is not None else float("inf")

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self.poll):
            silent = time.monotonic() - self._last
            limit = self.timeout()
            if silent > limit:
                _die(
                    STALL_EXIT_CODE,
                    f"watchdog: no progress for {silent:.0f}s "
                    f"(limit {limit:.0f}s = max({self.min_timeout:.0f}, "
                    f"{self.factor:.0f} x EMA {self._ema:.1f}s)) at step "
                    f"{self._step} — the run is presumed wedged; exiting "
                    f"{STALL_EXIT_CODE} so a supervisor can restart it",
                )
                return  # only reached when _die is monkeypatched in tests
