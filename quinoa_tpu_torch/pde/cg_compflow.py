"""CGCompFlow: node-centred compressible Euler, on torch tensors.

Port of quinoa_tpu/pde/cg_compflow.py: the initial/analytic solution and
Dirichlet increment, the two-stage Taylor-Galerkin rhs of DiagCG
(CGCompFlow.hpp rhs 185-350), the ALECG nodal flux columns and the
characteristic speed |v| + c with the pressure clamped to p >= 0, and dt
(CGCompFlow.hpp 352-430).  Fields are (5, N)/(5, E).
"""

from __future__ import annotations

import torch

from ..ops.assembly import gather_nodes
from .cg import CGGeom, cg_assemble_add, cg_gather
from .problems.compflow import euler_flux_dir


class CGCompFlow:
    """Compressible Euler flow (5 components) for node-centred schemes."""

    ncomp = 5
    flavour = "compflow"

    def __init__(self, problem):
        self.problem = problem
        self.eos = problem.eos
        # (geom, sources) of a steady manufactured problem, made once
        self._steady_src = None

    def initialize(self, xyz, t):
        return self.problem.solution(xyz, t)

    def analytic(self, xyz, t):
        return self.problem.analytic(xyz, t)

    def solinc(self, xyz, t, dt):
        return self.problem.solinc(xyz, t, dt)

    def rhs(self, t, dt, geom: CGGeom, U):
        return cg_assemble_add(
            geom, self.rhs_contrib(t, dt, geom, U, cg_gather(geom, U)))

    def element_sources(self, geom: CGGeom, t, dt):
        """The manufactured source of the rhs, (s_n, s_c), each (5, E):
        s_n sums it over the four corners at t, s_c is its value at the
        element centre at t + dt/2.  A steady problem's are made once per
        geometry (they do not depend on t)."""
        steady = getattr(self.problem, "steady", False)
        if steady and self._steady_src is not None \
                and self._steady_src[0] is geom:
            return self._steady_src[1]
        s_n = torch.zeros((5, geom.nelem), dtype=geom.dtype,
                          device=geom.device)
        for a in range(4):
            s_n = s_n + self.problem.src(geom.coords_n[a], t)
        s_c = self.problem.src(geom.ctr, t + 0.5 * dt)
        if steady:
            self._steady_src = (geom, (s_n, s_c))
        return s_n, s_c

    def rhs_contrib(self, t, dt, geom: CGGeom, U, un):
        """Element-corner rhs contributions (4, 5, E) from the step's nodal
        gather un (4, 5, E): the element intermediate at t + dt/2 from the
        divergence of the corner fluxes (plus the nodal source), then its
        flux (plus the centre source) back to the corners."""
        C, E = 5, geom.nelem
        divF = torch.zeros((C, E), dtype=U.dtype, device=U.device)
        for a in range(4):
            p_a = self.eos.pressure_cons_cm(un[a])
            for j in range(3):
                divF = divF + geom.grad[a, j] * euler_flux_dir(un[a], p_a, j)
        ue = un.mean(dim=0) - 0.5 * dt * divF

        manufactured = getattr(self.problem, "manufactured", False)
        if manufactured:
            s_n, s_c = self.element_sources(geom, t, dt)
            ue = ue + 0.5 * dt * s_n / 4.0

        p_e = self.eos.pressure_cons_cm(ue)
        F = [euler_flux_dir(ue, p_e, j) for j in range(3)]
        d = dt * geom.J * geom.emask / 6.0
        contrib = torch.stack(
            [d * sum(geom.grad[a, j] * F[j] for j in range(3))
             for a in range(4)])
        if manufactured:
            contrib = contrib + (d / 4.0) * s_c[None]
        return contrib

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
