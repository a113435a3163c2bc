"""DG systems: compressible Euler (DGCompFlow) and scalar transport
(DGTransport), feature-major layout.

Port of quinoa_tpu/pde/dg_compflow.py (reference DGCompFlow.hpp,
DGTransport.hpp): the flux, Riemann, boundary-ghost and
characteristic-speed callbacks the DG operators consume.  States are
(C, ...), normals (3, ...).
"""

from __future__ import annotations

import torch

from ..ops import riemann as rie
from .dg import BC_DIRICHLET, BC_INLET, BC_SYMMETRY
from .problems.compflow import euler_flux_dir


class DGCompFlow:
    """Compressible Euler for cell-centered DG.

    riemann_flux: 'hllc' (default) or 'laxfriedrichs'.  On faces that
    need no coordinates the face kernel K12 has both fluxes at every
    order.  The face Gauss-point path (Dirichlet or inlet faces) runs
    either flux in torch.
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
        faces, the analytic solution on Dirichlet faces (needs the face
        coordinates gp), a copy of the interior state otherwise (the
        caller keeps the true right state on interior faces)."""
        rho = sL[0]
        vel = sL[1:4] / rho
        vn = rie._dot3(vel, fn)
        velr = vel - 2.0 * vn * fn
        sym = torch.cat([sL[0:1], rho * velr, sL[4:5]])
        out = torch.where(bctype == BC_SYMMETRY, sym, sL)
        if gp is None:
            return out
        return torch.where(bctype == BC_DIRICHLET,
                           self.problem.solution(gp, t), out)

    def charvel(self, state, fn, gp=None):
        """|v.n| + a at face states, for the dt sweep."""
        rho = state[0]
        vel = state[1:4] / rho
        p = torch.clamp_min(self.eos.pressure_cons_cm(state), 0.0)
        a = self.eos.soundspeed(rho, p)
        return rie._dot3(vel, fn).abs() + a


class DGTransport:
    """Linear advection of N scalars for cell-centered DG (upwind flux),
    counterpart of DGTransport.hpp.  Its velocity field samples
    coordinates, so it always takes the face Gauss-point path (no
    needs_face_gp attribute: the solver reads the default, True)."""

    has_src = False

    def __init__(self, problem, ncomp=None):
        self.problem = problem
        self.ncomp = ncomp if ncomp is not None else problem.ncomp

    def initialize(self, xyz, t):
        return self.problem.solution(xyz, t)

    def analytic(self, xyz, t):
        return self.problem.solution(xyz, t)

    def src(self, xyz, t):
        return torch.zeros((self.ncomp,) + tuple(xyz.shape[1:]),
                           dtype=xyz.dtype, device=xyz.device)

    def flux_cols(self, state, gp, t):
        """F_j[c] = v_j(x)[c] * u[c]."""
        vel = self.problem.velocity(gp, t)               # (C, 3, n)
        return [state * vel[:, j] for j in range(3)]

    def riemann(self, fn, sL, sR, gp, t):
        return rie.upwind(fn, sL, sR, self.problem.velocity(gp, t))

    def bc_state(self, bctype, sL, fn, gp, t):
        """Dirichlet: analytic solution; Inlet: zero; Outlet/Extrapolate:
        copy (DGTransport.hpp:340-400)."""
        dirich = self.problem.solution(gp, t)
        return torch.where(
            bctype == BC_DIRICHLET,
            dirich,
            torch.where(bctype == BC_INLET, torch.zeros_like(sL), sL),
        )

    def charvel(self, state, fn, gp=None):
        """max over components of |v.n| for the dt face sweep."""
        vel = self.problem.velocity(gp, 0.0)             # (C, 3, n)
        return rie._dot3(vel.movedim(1, 0), fn).abs().amax(0)
