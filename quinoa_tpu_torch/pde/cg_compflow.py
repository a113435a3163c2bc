"""CGCompFlow: node-centred compressible Euler, on torch tensors.

Port of the part of quinoa_tpu/pde/cg_compflow.py that ALECG needs: the
initial/analytic solution, the nodal flux columns, the characteristic
speed |v| + c with the pressure clamped to p >= 0 (CGCompFlow.hpp dt
352-430) and dt.  Fields are (5, N)/(5, E).  The Taylor-Galerkin rhs of
DiagCG is not ported here.
"""

from __future__ import annotations

import torch

from ..ops.assembly import gather_nodes
from .cg import CGGeom
from .problems.compflow import euler_flux_dir


class CGCompFlow:
    """Compressible Euler flow (5 components) for node-centred schemes."""

    ncomp = 5
    flavour = "compflow"

    def __init__(self, problem):
        self.problem = problem
        self.eos = problem.eos

    def initialize(self, xyz, t):
        return self.problem.solution(xyz, t)

    def analytic(self, xyz, t):
        return self.problem.analytic(xyz, t)

    def flux_at_nodes(self, u, xyz):
        """Three flux columns at nodal states u (5, n)."""
        p = self.eos.pressure_cons_cm(u)
        return [euler_flux_dir(u, p, j) for j in range(3)]

    def charspeed(self, u, xyz):
        """|v| + c at nodal states (the edge dissipation's lambda)."""
        rho = u[0]
        p = torch.clamp_min(self.eos.pressure_cons_cm(u), 0.0)
        c = self.eos.soundspeed(rho, p)
        return torch.sqrt(u[1] * u[1] + u[2] * u[2] + u[3] * u[3]) / rho + c

    def dt(self, geom: CGGeom, U):
        """Min over elements of L / max_nodes(|v| + c) (before CFL)."""
        un = gather_nodes(U, geom.inpoelT)  # (4, 5, E)
        maxvel = None
        for a in range(4):
            v = self.charspeed(un[a], None)
            maxvel = v if maxvel is None else torch.maximum(maxvel, v)
        elemdt = geom.elem_length / maxvel
        big = torch.finfo(U.dtype).max
        return torch.where(geom.emask > 0, elemdt, big).min()
