"""Wall-clock timer with h:m:s split and ETA estimation (tk::Timer):
the port's own copy of quinoa_tpu/base/timer.py."""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Watch:
    hrs: int
    min: int
    sec: int

    def __str__(self):
        return f"{self.hrs:02d}:{self.min:02d}:{self.sec:02d}"


class Timer:
    def __init__(self):
        self._start = time.perf_counter()

    def sec(self) -> float:
        return time.perf_counter() - self._start

    def hms(self) -> Watch:
        s = int(self.sec())
        return Watch(s // 3600, (s % 3600) // 60, s % 60)

    def eta(self, term: float, t: float, nstep: int, it: int) -> Watch:
        """Estimated time to accomplishment (Timer::eta): scale elapsed
        wall time by the more restrictive of the physical-time and
        step-count budgets."""
        if it <= 0:
            return Watch(0, 0, 0)
        elapsed = self.sec()
        frac = []
        if term not in (float("inf"), 0.0) and t > 0:
            frac.append(t / term)
        if nstep < 10**9 and nstep > 0:
            frac.append(it / nstep)
        if not frac:
            return Watch(0, 0, 0)
        f = max(min(max(frac), 1.0), 1e-12)
        rem = int(elapsed * (1.0 - f) / f)
        return Watch(rem // 3600, (rem % 3600) // 60, rem % 60)
