"""Tracing / profiling instruments (SURVEY.md §5).

The reference's only instrumentation is a per-render Stopwatch printed to
debug output (Game1.cs:274, :154-155) and a scanline progress fraction
(RayTracer.cs:43-46).  Equivalents here:

- :class:`PhaseTimer` — Stopwatch with named phases and rays/s reporting
  (forces device completion before stamping).
- :func:`device_trace` — context manager around ``jax.profiler`` for a
  TensorBoard-viewable device trace of a render.
- :func:`render_stats` — one-call throughput measurement of a jitted render
  (compile time, best/median wall time, rays/s).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple


class PhaseTimer:
    """Named-phase wall timer that syncs the device at each boundary.

    Usage::

        t = PhaseTimer()
        with t.phase("flatten"):
            flat = scene.flatten()
        with t.phase("render"):
            img = render_image(flat, cfg, cam)
        print(t.report(rays=cfg.width * cfg.height))
    """

    def __init__(self):
        self.phases: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        import jax

        t0 = time.perf_counter()
        try:
            yield
        finally:
            # Drain all in-flight device work so the stamp is honest.
            try:
                jax.effects_barrier()
            except Exception:
                pass
            self.phases.append((name, time.perf_counter() - t0))

    def total(self) -> float:
        return sum(dt for _, dt in self.phases)

    def report(self, rays: Optional[int] = None) -> str:
        lines = [f"{name:16s} {dt * 1e3:9.2f} ms" for name, dt in self.phases]
        total = self.total()
        lines.append(f"{'total':16s} {total * 1e3:9.2f} ms")
        if rays and total > 0:
            lines.append(f"{'throughput':16s} {rays / total / 1e6:9.2f} Mrays/s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace around a block: view in TensorBoard/Perfetto."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def render_stats(fn: Callable, args: tuple, rays: int, reps: int = 3,
                 sync: Optional[Callable] = None) -> Dict[str, float]:
    """Compile + time a jitted render callable; returns a stats dict.

    ``sync`` defaults to ``jax.block_until_ready`` on the result.
    """
    import jax

    sync = sync or jax.block_until_ready
    t0 = time.perf_counter()
    out = fn(*args)
    sync(out)
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    best = times[0]
    return {
        "compile_s": compile_s,
        "best_s": best,
        "median_s": times[len(times) // 2],
        "rays_per_s": rays / best if best > 0 else float("inf"),
    }
