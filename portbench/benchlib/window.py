"""The timed loop: a frozen copy of the step loop of the port's inciter
command (quinoa_tpu_torch/cli.py _cmd_inciter) under -b, Quinoa's
benchmark mode: no field output, diagnostics still written.

Each step is solver.step(state), then the host read of int(state.it), the
command's synchronisation point and the boundary between two steps'
times, then at the deck's diagnostics interval diag.compute(state) and one
DiagWriter row.  The loop runs for a fixed number of seconds, not to the
deck's nstep or term.
"""

from __future__ import annotations

import time


class Loop:

    def __init__(self, solver, diag, writer, interval, label=None):
        self.solver, self.diag, self.writer = solver, diag, writer
        self.interval = interval
        #: a context factory around each part (torch.profiler's
        #: record_function in a traced slice), or None
        self.label = label
        #: host seconds of every diagnostics call (compute + row)
        self.diag_s = []

    def _part(self, name):
        if self.label is None:
            return _NULL
        return self.label(name)

    def _diagnostics(self, state, it):
        t0 = time.perf_counter()
        row = self.diag.compute(state)
        if isinstance(row, tuple):
            l2sol, l2err, linferr = row
            self.writer.write(it, float(state.t), float(state.dt), l2sol,
                              l2err, linferr)
        else:
            self.writer.write(it, row.t, row.dt, row.l2sol, row.l2err,
                              row.linferr)
        self.diag_s.append(time.perf_counter() - t0)

    def run(self, state, seconds=None, steps=None):
        """Step until `seconds` have passed (checked at each step boundary)
        or for `steps` steps.  Returns (previous state, last state, the
        seconds of every step, the seconds from the start to the last
        boundary)."""
        prev = state
        times = []
        t0 = last = time.perf_counter()
        end = None if seconds is None else t0 + seconds
        while True:
            prev = state
            with self._part("portbench.step"):
                state = self.solver.step(state)
            with self._part("portbench.read_it"):
                it = int(state.it)
            now = time.perf_counter()
            times.append(now - last)
            last = now
            if (end is not None and now >= end) or \
                    (steps is not None and len(times) >= steps):
                break
            if self.diag is not None and it % self.interval == 0:
                with self._part("portbench.diag"):
                    self._diagnostics(state, it)
        return prev, state, times, last - t0


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()
