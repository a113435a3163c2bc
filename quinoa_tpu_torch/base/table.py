"""Tabulated-function linear interpolation (tk::Table / tk::sample).

The port's own copy of quinoa_tpu/base/table.py: y(x) piecewise linear
with constant extrapolation, as jnp.interp evaluates it.  The walker's
hydro-timescale coefficient policies sample it at the step's time on the
host.
"""

from __future__ import annotations

import numpy as np


class Table:
    """Piecewise-linear y(x) with constant extrapolation."""

    def __init__(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if x.ndim != 1 or x.shape != y.shape:
            raise ValueError("x and y must be equal-length 1-D")
        if not (np.diff(x) > 0).all():
            raise ValueError("x must be strictly increasing")
        self.x = x
        self.y = y

    def __call__(self, t) -> float:
        """y(t) in float64, jnp.interp's formula: the bracketing segment
        by a right-sided search, y0 + (t - x0) / dx * dy, the end values
        outside [x0, xn]."""
        x, y = self.x, self.y
        t = float(t)
        i = min(max(int(np.searchsorted(x, t, side="right")), 1), len(x) - 1)
        f = y[i - 1] + ((t - x[i - 1]) / (x[i] - x[i - 1])) * (y[i] - y[i - 1])
        if t < x[0]:
            f = y[0]
        if t > x[-1]:
            f = y[-1]
        return float(f)
