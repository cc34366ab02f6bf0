"""Failure detection + elastic recovery for batch renders (SURVEY.md §5).

The reference has none of this: a crashed render thread would silently hang
the Join barrier (RayTracer.cs:117-120), and a crashed animation could only
be salvaged manually by re-stitching the frame PNGs already on disk
(Game1.cs:156-161, :192-210).

The design exploits that rendering is stateless and tile/frame
units are re-renderable: recovery = re-dispatch.  :func:`render_units`
drives a list of independent work units (tiles or frames) through a render
callable, detects failures (exceptions from the runtime — device resets,
preemptions — or a per-unit wall-clock timeout), retries with exponential
backoff, and reports per-unit status.  For multi-host runs each host
renders its own unit slice; a lost host's units are re-dispatched from its
survivors by the driver on the next call (the unit list is just data).

Fault injection for tests: pass ``inject_failure`` — a callable
``(unit_index, attempt) -> bool`` — to make chosen attempts raise.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Sequence


class UnitFailure(RuntimeError):
    pass


def _run_with_watchdog(fn, unit, timeout_s: Optional[float]):
    """Run ``fn(unit)`` under a watchdog thread.

    With a timeout, the call runs in a daemon worker and the driver waits at
    most ``timeout_s`` — a silently hung device call (the reference's analog
    failure: a crashed render thread hanging Thread.Join,
    RayTracer.cs:117-120) no longer hangs the driver; it raises UnitFailure
    and the unit is re-dispatched.  The hung call itself cannot be
    interrupted portably: its daemon thread is abandoned (it dies with the
    process), and the retry may contend with it for the device until the
    runtime clears the stuck call."""
    if timeout_s is None:
        return fn(unit)
    box: dict = {}

    def work():
        try:
            box["result"] = fn(unit)
        except BaseException as e:  # noqa: BLE001 — re-raised in the driver
            box["error"] = e

    th = threading.Thread(target=work, daemon=True)
    t0 = time.perf_counter()
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        raise UnitFailure(
            f"watchdog: call still in flight after "
            f"{time.perf_counter() - t0:.1f}s (timeout {timeout_s:.1f}s)"
        )
    if "error" in box:
        raise box["error"]
    return box["result"]


@dataclasses.dataclass
class UnitResult:
    index: int
    ok: bool
    attempts: int
    seconds: float
    result: object = None
    error: Optional[str] = None


def render_units(units: Sequence, render_one: Callable,
                 max_attempts: int = 3, timeout_s: Optional[float] = None,
                 backoff_s: float = 0.5,
                 on_progress: Optional[Callable[[UnitResult], None]] = None,
                 inject_failure: Optional[Callable[[int, int], bool]] = None,
                 ) -> List[UnitResult]:
    """Render every unit with detection + bounded re-dispatch.

    ``render_one(unit)`` must be a pure function of the unit (re-running it
    is safe by construction — the elastic recovery contract).  With
    ``timeout_s``, each attempt runs under a watchdog thread: a hung device
    call is abandoned after the timeout and the unit retried, so the driver
    itself can never hang (see _run_with_watchdog for the contract).
    """
    out: List[UnitResult] = []
    for i, unit in enumerate(units):
        t_unit = time.perf_counter()
        last_err = None
        ok = False
        result = None
        attempt = 0
        for attempt in range(1, max_attempts + 1):
            try:
                if inject_failure is not None and inject_failure(i, attempt):
                    raise UnitFailure(f"injected failure (unit {i}, "
                                      f"attempt {attempt})")
                result = _run_with_watchdog(render_one, unit, timeout_s)
                ok = True
                break
            except Exception as e:  # noqa: BLE001 — runtime faults vary
                last_err = f"{type(e).__name__}: {e}"
                if attempt < max_attempts:
                    time.sleep(backoff_s * (2 ** (attempt - 1)))
        r = UnitResult(
            index=i, ok=ok, attempts=attempt,
            seconds=time.perf_counter() - t_unit,
            result=result, error=None if ok else last_err,
        )
        out.append(r)
        if on_progress is not None:
            on_progress(r)
    return out


def failed_units(results: Sequence[UnitResult]) -> List[int]:
    """Indices needing re-dispatch (feed back into render_units)."""
    return [r.index for r in results if not r.ok]
