"""DG system for compressible Euler (DGCompFlow), feature-major layout.

Port of quinoa_tpu/pde/dg_compflow.py:18-88 (reference DGCompFlow.hpp):
the flux, Riemann, boundary-ghost and characteristic-speed callbacks the
DG operators consume.  States are (C, ...), normals (3, ...).  Only the
coordinate-free boundary conditions (symmetry, extrapolate, outlet) are
ported; a Dirichlet or inlet face needs the face Gauss-point coordinates
and raises.
"""

from __future__ import annotations

import torch

from ..ops import riemann as rie
from .dg import BC_SYMMETRY
from .problems.compflow import euler_flux_dir


class DGCompFlow:
    """Compressible Euler for cell-centered DG.

    riemann_flux: 'hllc' (default) or 'laxfriedrichs'.  The CUDA face
    kernel implements HLLC only.
    """

    ncomp = 5
    #: flux and Riemann solver never sample face coordinates
    needs_face_gp = False
    #: flux_cols ignores gp and t: the limit + volume kernel relies on it
    coord_free_flux = True

    def __init__(self, problem, riemann_flux: str = "hllc"):
        self.problem = problem
        self.eos = problem.eos
        if riemann_flux not in ("hllc", "laxfriedrichs"):
            raise ValueError(f"unknown flux {riemann_flux!r} for compflow DG")
        self.riemann_flux = riemann_flux
        self.has_src = getattr(problem, "manufactured", False)

    def initialize(self, xyz, t):
        return self.problem.solution(xyz, t)

    def analytic(self, xyz, t):
        return self.problem.analytic(xyz, t)

    def src(self, xyz, t):
        return self.problem.src(xyz, t)

    def flux_cols(self, state, gp, t):
        """The three flux columns [F_x, F_y, F_z], each (5, ...)."""
        p = self.eos.pressure_cons_cm(state)
        return [euler_flux_dir(state, p, j) for j in range(3)]

    def riemann(self, fn, sL, sR, gp, t):
        if self.riemann_flux == "hllc":
            return rie.hllc(fn, sL, sR, self.eos)
        return rie.lax_friedrichs(fn, sL, sR, self.eos)

    def bc_state(self, bctype, sL, fn, gp, t):
        """Ghost state for boundary faces: reflected velocity on symmetry
        faces, a copy of the interior state otherwise (the caller keeps
        the true right state on interior faces)."""
        if gp is not None:
            raise NotImplementedError(
                "Dirichlet/inlet ghosts (face coordinates) are not ported")
        rho = sL[0]
        vel = sL[1:4] / rho
        vn = rie._dot3(vel, fn)
        velr = vel - 2.0 * vn * fn
        sym = torch.cat([sL[0:1], rho * velr, sL[4:5]])
        return torch.where(bctype == BC_SYMMETRY, sym, sL)

    def charvel(self, state, fn, gp=None):
        """|v.n| + a at face states, for the dt sweep."""
        rho = state[0]
        vel = state[1:4] / rho
        p = torch.clamp_min(self.eos.pressure_cons_cm(state), 0.0)
        a = self.eos.soundspeed(rho, p)
        return rie._dot3(vel, fn).abs() + a
