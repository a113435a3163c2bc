"""Node diagnostics of the CG schemes: L2 norms and analytic-error norms.

Port of quinoa_tpu/inciter/diagnostics.py (reference NodeDiagnostics.cpp:
51-140): volume-weighted sums finalised as sqrt(sum(A_i^2 V_i) / total
volume); Linf is a plain max.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class DiagRow:
    """One diagnostics output row (mirrors the reference's diag file)."""

    it: int
    t: float
    dt: float
    l2sol: list
    l2err: Optional[list]
    linferr: Optional[list]


class Diagnostics:
    """L2(sol) and, where the system has an analytic solution, L2(err) and
    Linf(err), all at state.t."""

    def __init__(self, system, geom):
        self.system = system
        self.geom = geom
        self.total_vol = float(geom.vol.sum())

    def compute(self, state) -> DiagRow:
        u = state.u  # (C, N)
        vol = self.geom.vol[None, :]
        l2sol = ((u * u * vol).sum(dim=1) / self.total_vol).sqrt()

        l2err = linferr = None
        if hasattr(self.system, "analytic"):
            # at t: state.t is already past the step, the reference's
            # d.T()+d.Dt() convention
            a = self.system.analytic(self.geom.coords, state.t).to(u.dtype)
            e = u - a
            l2err = ((e * e * vol).sum(dim=1) / self.total_vol).sqrt()
            linferr = e.abs().amax(dim=1)

        return DiagRow(
            it=int(state.it),
            t=float(state.t),
            dt=float(state.dt),
            l2sol=[float(v) for v in l2sol],
            l2err=None if l2err is None else [float(v) for v in l2err],
            linferr=None if linferr is None else [float(v) for v in linferr],
        )
