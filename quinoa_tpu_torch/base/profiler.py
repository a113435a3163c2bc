"""Per-phase wall-clock profiling.

The port's own copy of quinoa_tpu/base/profiler.py's PhaseProfiler, the
analog of the reference's timer table printed by Main at the end of a
run (src/Main/Inciter.cpp timers: mesh read, partition, time stepping):
phases accumulate host wall-clock over repeated entries.  A phase times
device work only where the code inside it waits for the device (the
inciter step loop reads the iteration count back inside its timestep
phase).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple


class PhaseProfiler:
    """Accumulating named-phase wall-clock breakdown.

        prof = PhaseProfiler()
        with prof.phase("mesh read"):
            ...
        with prof.phase("timestep"):
            ...
        print(prof.table())

    Phases may be entered repeatedly (times and counts accumulate); the
    table lists phases in first-entry order with share-of-total.
    """

    def __init__(self):
        self._t0 = time.perf_counter()
        self._acc: Dict[str, float] = {}
        self._n: Dict[str, int] = {}
        self._order: List[str] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        if name not in self._acc:
            self._acc[name] = 0.0
            self._n[name] = 0
            self._order.append(name)
        t = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t
            self._n[name] += 1

    def times(self) -> List[Tuple[str, float, int]]:
        """[(phase, seconds, entries)] in first-entry order."""
        return [(k, self._acc[k], self._n[k]) for k in self._order]

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def table(self) -> str:
        """Formatted breakdown, one line per phase + total (the layout
        of the reference's end-of-run timer printout)."""
        tot = self.total()
        w = max((len(k) for k in self._order), default=5)
        lines = [f"{'phase':<{w}}  {'sec':>9}  {'%':>5}  {'n':>6}"]
        for k, s, n in self.times():
            lines.append(
                f"{k:<{w}}  {s:9.3f}  {100.0 * s / tot:5.1f}  {n:6d}")
        acc = sum(self._acc.values())
        lines.append(
            f"{'(untimed)':<{w}}  {tot - acc:9.3f}  "
            f"{100.0 * (tot - acc) / tot:5.1f}")
        lines.append(f"{'total':<{w}}  {tot:9.3f}  100.0")
        return "\n".join(lines)
