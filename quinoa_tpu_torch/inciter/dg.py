"""DG time stepping: SSP-RK3 with Superbee limiting, on torch.

Port of quinoa_tpu/inciter/dg.py for the DG(P1) + Superbee slice.  Each
of the three RK stages runs

    u, rv   = superbee_limit_window(geom, u, system)    # K1
    r, delt = fused_face_pass(system, geom, u, rv)      # K2 + K3
    (stage 0: un = u, dt = cfl/3 * min_e vol_e / delt_e)
    u = rk0[s]*un + rk1[s]*(u + dt*r/M)

with the block-diagonal mass matrix diagonal in the Dubiner basis
(M_k = vol*mnorm_k).  The RK anchor is the LIMITED stage-0 state
(reference DG.cpp:1471).  On a CUDA geometry the step launches only the
three kernels plus torch elementwise work and one min reduction; it never
synchronises with the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.basis import eval_basis_np
from ..ops.face_fused import fused_face_pass
from ..ops.nbr_bounds import superbee_limit_window
from ..ops.quadrature import gauss_tet, ng_diag
from ..pde.dg import (DGGeom, _phys_gp, dg_dt_from_delt, dg_initialize,
                      require_slice, uview)

RK0 = (0.0, 3.0 / 4.0, 1.0 / 3.0)
RK1 = (1.0, 1.0 / 4.0, 2.0 / 3.0)


@dataclasses.dataclass
class DGState:
    u: torch.Tensor       # (C*K, E)
    ndofel: torch.Tensor  # (E,) int32 active dofs (always K here)
    t: torch.Tensor
    it: torch.Tensor
    dt: torch.Tensor


class DGSolver:
    """Cell-centered DG(P1) solver on one device, Superbee-limited.

    The signature mirrors quinoa_tpu's DGSolver without the WENO and
    p-adaptivity tuning knobs (cweight, tolref); what lies outside the
    ported slice raises NotImplementedError: other limiters or none,
    p-adaptivity (pref), rDG (evolve_ndof), a constant dt, P0/P2,
    Dirichlet/inlet faces and systems other than compressible Euler.
    """

    def __init__(
        self,
        system,
        geom: DGGeom,
        cfl: float = 0.5,
        const_dt: Optional[float] = None,
        limiter: Optional[str] = None,
        pref: bool = False,
        evolve_ndof: Optional[int] = None,
    ):
        if limiter != "superbeep1":
            raise NotImplementedError(
                f"limiter={limiter!r}: only 'superbeep1' is ported")
        if pref:
            raise NotImplementedError("p-adaptive DG (pref) is not ported")
        if const_dt is not None:
            raise NotImplementedError("const_dt is not ported")
        if evolve_ndof not in (None, geom.ndof):
            raise NotImplementedError("rDG (evolve_ndof) is not ported")
        require_slice(system, geom)
        self.system = system
        self.geom = geom
        self.cfl = cfl
        self.limiter = limiter
        self.cflscale = 1.0 / 3.0   # 1/(2p+1) for p = 1
        C, K = system.ncomp, geom.ndof
        mn = torch.as_tensor(geom.tables["mnorm"], dtype=geom.dtype,
                             device=geom.device)
        inv = 1.0 / (geom.vol[None, :] * mn[:, None])   # (K, E)
        self.minv = inv.repeat(C, 1)                    # (C*K, E)

    def initial_state(self, t0: float = 0.0) -> DGState:
        g = self.geom
        u0 = dg_initialize(self.system, g, t0)
        return DGState(
            u=u0.to(g.dtype).contiguous(),
            ndofel=torch.full((g.nelem,), g.ndof, dtype=torch.int32,
                              device=g.device),
            t=torch.tensor(t0, dtype=g.dtype, device=g.device),
            it=torch.tensor(0, dtype=torch.int32, device=g.device),
            dt=torch.tensor(0.0, dtype=g.dtype, device=g.device),
        )

    def step(self, state: DGState) -> DGState:
        g, system = self.geom, self.system
        u = un = state.u
        dt = state.dt
        for s in range(3):
            u, rv = superbee_limit_window(g, u, system)
            if s == 0:
                un = u
            r, delt = fused_face_pass(system, g, u, vol_rhs=rv)
            if s == 0:
                dt = dg_dt_from_delt(g, delt) * (self.cfl * self.cflscale)
            u = RK0[s] * un + RK1[s] * (u + dt * r * self.minv)
        return DGState(u=u, ndofel=state.ndofel, t=state.t + dt,
                       it=state.it + 1, dt=dt)

    def nsteps(self, state: DGState, n: int) -> DGState:
        for _ in range(n):
            state = self.step(state)
        return state


class DGDiagnostics:
    """Element diagnostics: L2 norms via NGdiag-point quadrature
    (reference ElemDiagnostics.cpp), for states with every dof active."""

    def __init__(self, system, geom: DGGeom):
        self.system = system
        self.geom = geom
        self.pts, self.w = gauss_tet(ng_diag(geom.ndof))
        self.B = eval_basis_np(geom.ndof, self.pts)     # (G, K)
        self.total_vol = float((geom.vol * geom.emask).sum())

    def compute(self, state: DGState):
        """([l2sol], [l2err], [linferr]) per component, as Python floats."""
        g = self.geom
        C, K = self.system.ncomp, g.ndof
        if bool((state.ndofel != K).any()):
            raise NotImplementedError("p-adaptive diagnostics are not ported")
        dt_, dev = state.u.dtype, state.u.device
        Uv = uview(state.u, C, K)
        ve = g.vol * g.emask
        s2 = torch.zeros(C, dtype=dt_, device=dev)
        e2 = torch.zeros(C, dtype=dt_, device=dev)
        einf = torch.zeros(C, dtype=dt_, device=dev)
        for gi in range(len(self.w)):
            B = torch.as_tensor(self.B[gi], dtype=dt_, device=dev)[:, None]
            sgp = (Uv * B).sum(dim=1)                       # (C,E)
            xi = torch.as_tensor(self.pts[gi], dtype=dt_, device=dev)[:, None]
            gp = _phys_gp(g.node0, g.Jmat, xi)
            a = self.system.analytic(gp, state.t).to(dt_)
            w = float(self.w[gi]) * ve
            s2 = s2 + (w * sgp**2).sum(dim=1)
            err = (sgp - a) * (g.emask > 0)
            e2 = e2 + (w * err**2).sum(dim=1)
            einf = torch.maximum(einf, err.abs().amax(dim=1))
        l2sol = torch.sqrt(s2 / self.total_vol)
        l2err = torch.sqrt(e2 / self.total_vol)
        return (
            [float(v) for v in l2sol],
            [float(v) for v in l2err],
            [float(v) for v in einf],
        )
