"""DG time stepping: SSP-RK3 with limiting, p-adaptivity and rDG, on
torch.

Port of quinoa_tpu/inciter/dg.py for DG(P0), DG(P1) and DG(P2).  Each of
the three RK stages limits, (stage 0) evaluates the p-adaptive dofs and
the dt, takes the rhs and applies

    u = rk0[s]*un + rk1[s]*(u + dt*r/M)

with the block-diagonal mass matrix diagonal in the Dubiner basis
(M_k = vol*mnorm_k).  The RK anchor un is the LIMITED stage-0 state
(reference DG.cpp:1471).  The routes, as the JAX package dispatches them
on a TPU:

- Superbee at P1 on compressible Euler: the fused limit + flux volume
  pass (K1; with pref its p-adaptive flavour, which reads ndofel and
  writes the masked state), plus the source integral in torch where the
  problem has one; otherwise Superbee is the split route, neighbour-mean
  bounds (K4) then superbee_p1 in torch (P2, and P1 off compressible
  Euler); WENO is torch;
- a system and faces that need no face coordinates (Euler on symmetry,
  extrapolate, outlet faces): the fused face pass on the state masked by
  the dofmask, whose charvel gives the stage-0 dt: K12 + K13 (HLLC or
  Lax-Friedrichs), with the volume term of K1 or of torch beneath it;
- otherwise, and at P0 and P2 with pref, the face Gauss-point path of
  dg_rhs (gathers K5, accumulation K6) and, at stage 0, the dg_dt face
  sweep;
- DG(P2) and DG(P0) on the fused face pass (compressible Euler, faces
  that need no coordinates): the XLA-formulation volume integral with the
  source at the step's start time in torch (at P0 only the source, and
  nothing without one), then the single-stream face pass (K12 + K13, HLLC
  or Lax-Friedrichs), whose charvel gives the stage-0 dt.

p-adaptive runs (pref) re-evaluate ndofel at stage 0 (sticky indicator,
one-ring promotion; P1 elements only, so at P0 and P2 the dofmask stays
all ones), zero the coarsened dofs at stage 0 (K1's p-adaptive flavour
writes them zeroed at every stage), and restore the inactive rows from
the anchor after every stage.  rDG (evolve_ndof below ndof, the
p0p1 scheme) advances only the first evolve_ndof dofs of every component
and scales the CFL by the evolved order.  On a CUDA geometry the step
launches only the kernels of csrc/ plus torch elementwise work, small
index gathers and reductions; it never synchronises with the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..base.lockstep import run_alone
from ..base.profiler import count, span
from ..ops.basis import eval_basis_np
from ..ops.face_fused import face_pass_for, fused_face_pass
from ..ops.nbr_bounds import (neighbor_mean_bounds, superbee_limit_window,
                              volume_rhs_plain)
from ..ops.quadrature import gauss_tet, ng_diag
from ..pde.dg import (DGGeom, _phys_gp, dg_dt, dg_dt_from_delt,
                      dg_initialize, dg_rhs, eval_ndof_sticky, needs_face_gp,
                      propagate_ndof, require_slice, source_rhs, uview,
                      volume_rhs)
from ..pde.limiter import superbee_p1, weno_p1

RK0 = (0.0, 3.0 / 4.0, 1.0 / 3.0)
RK1 = (1.0, 1.0 / 4.0, 2.0 / 3.0)


@dataclasses.dataclass
class DGState:
    u: torch.Tensor       # (C*K, E)
    ndofel: torch.Tensor  # (E,) int32 active dofs (p-adaptive)
    t: torch.Tensor
    it: torch.Tensor
    dt: torch.Tensor


class DGSolver:
    """Cell-centered DG(P0), DG(P1) and DG(P2) solver on one device.

    limiter     : None | 'wenop1' | 'superbeep1' (ndof >= 4; both limit
                  the P1 dofs only)
    cweight     : the WENO limiter's central weight
    pref        : p-adaptive DG (P1 <-> P0 by gradient indicator,
                  DG.cpp:1088-1163); tolref is the threshold
    evolve_ndof : rDG, the dofs that advance (p0p1: 1 of geom.ndof 4)

    The signature and what it accepts are quinoa_tpu's DGSolver's: a
    limiter below P1 or an unknown one raises ValueError, as there.
    """

    def __init__(
        self,
        system,
        geom: DGGeom,
        cfl: float = 0.5,
        const_dt: Optional[float] = None,
        limiter: Optional[str] = None,
        cweight: float = 30.0,
        pref: bool = False,
        tolref: float = 0.1,
        evolve_ndof: Optional[int] = None,
    ):
        if limiter not in (None, "wenop1", "superbeep1"):
            raise ValueError(f"unknown limiter {limiter!r}")
        if limiter is not None and geom.ndof < 4:
            raise ValueError("limiters require ndof >= 4")
        require_slice(system, geom)
        self.system = system
        self.geom = geom
        self.cfl = cfl
        self.limiter = limiter
        self.cweight = cweight
        self.pref = pref
        self.tolref = tolref
        # rDG(PnPm): faces and limiters see every dof, only the first
        # evolve_ndof advance, and the CFL scale is the EVOLVED order's
        # (quinoa_tpu/inciter/dg.py:83-90)
        self.evolve_ndof = evolve_ndof or geom.ndof
        p = {1: 0.0, 4: 1.0, 10: 2.0}[self.evolve_ndof]
        self.cflscale = 1.0 / (2.0 * p + 1.0)
        self.const_dt = None if const_dt is None else torch.tensor(
            const_dt, dtype=geom.dtype, device=geom.device)
        # p-adaptive P0 and P2 keep every dof (the indicator re-evaluates
        # P1 elements only): their masked rhs is the face Gauss-point
        # route's, as the JAX step takes it (dg_rhs with the dofmask)
        self.face_gp = (needs_face_gp(system, geom)
                        or (pref and geom.ndof != 4))
        self.fused_limit = (limiter == "superbeep1" and geom.ndof == 4
                            and getattr(system, "coord_free_flux", False))
        #: the DG(P1) face pass off the face Gauss-point path
        self.p1_face_pass = face_pass_for(system, 4)
        C, K = system.ncomp, geom.ndof
        mn = torch.as_tensor(geom.tables["mnorm"], dtype=geom.dtype,
                             device=geom.device)
        inv = 1.0 / (geom.vol[None, :] * mn[:, None])   # (K, E)
        self.minv = inv.repeat(C, 1)                    # (C*K, E)
        #: rDG: the rows that advance (c*K + k with k < evolve_ndof)
        self.evolved = None
        if self.evolve_ndof < K:
            self.evolved = (torch.arange(K, device=geom.device).repeat(C)
                            < self.evolve_ndof)[:, None]

    def initial_state(self, t0: float = 0.0) -> DGState:
        with span("initial_state"):
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

    def _dofmask(self, ndofel):
        k = torch.arange(self.geom.ndof, device=ndofel.device)[:, None]
        return (k < ndofel[None, :]).to(self.geom.dtype)

    def step(self, state: DGState) -> DGState:
        with span("step"):
            return run_alone(self.step_coroutine(state))

    def step_coroutine(self, state: DGState, owned=None):
        """The step as a coroutine (base/lockstep.py): it yields
        ("halo", x) where ghost elements must take their owners' values
        (the reference's comsol and comlim exchanges: at each stage's
        start, after the limiter, and twice around the p-adaptive ring
        promotion) and ("min", dt) for the global time step.  On a shard
        ``owned`` (E,) marks the elements that advance; the others keep
        their values until an exchange refreshes them
        (quinoa_tpu/parallel/dg_spmd.py:185-331).

        Its spans (base/profiler.py) partition each stage: pref, limit,
        volume, face_pass, dt and rk_update; each closes before the next
        yield.  pref holds pref.eval (the sticky indicator),
        pref.propagate (the ring promotion) and pref.mask (the dofmask
        and, off the fused limiter, the stage-0 zeroing and the masked
        face input); the split Superbee route's limit holds limit.bounds
        (K4) and limit.superbee."""
        g, system = self.geom, self.system
        C = system.ncomp
        u = un = state.u
        ndofel, dt = state.ndofel, state.dt
        for s in range(3):
            u = yield "halo", u
            if s == 0 and self.pref and g.ndof >= 4:
                # a ghost's sticky history lives with its owner: the
                # decisions are exchanged, promoted one ring, exchanged
                with span("pref"), span("pref.eval"):
                    ndofel = eval_ndof_sticky(g, u, ndofel, C, self.tolref)
                ndofel = (yield "halo", ndofel[None])[0]
                with span("pref"), span("pref.propagate"):
                    ndofel = propagate_ndof(g, ndofel)
                ndofel = (yield "halo", ndofel[None])[0]
            dofmask = dm = None
            if self.pref:
                with span("pref"), span("pref.mask"):
                    dofmask = self._dofmask(ndofel)
                    dm = dofmask.repeat(C, 1)
            rv = None
            with span("limit"):
                if self.fused_limit:
                    # with pref the kernel writes the masked state
                    u, rv = superbee_limit_window(
                        g, u, system, ndofel=ndofel if self.pref else None)
                elif self.limiter == "superbeep1":
                    with span("limit.bounds"):
                        bounds = neighbor_mean_bounds(g, u, C)
                    with span("limit.superbee"):
                        u = superbee_p1(g, u, dofmask, C, bounds=bounds)
                elif self.limiter == "wenop1":
                    u = weno_p1(g, u, dofmask, C, self.cweight)
            if self.fused_limit and system.has_src:
                # K1 integrates the flux only: the source term at the
                # step's start time rides on top, in torch
                with span("volume"):
                    rv = rv + source_rhs(system, g, state.t)
            if self.limiter is not None:
                # a ghost limited with an incomplete neighbour set takes
                # its owner's limited values
                u = yield "halo", u
            if s == 0:
                if dm is not None and not self.fused_limit:
                    # coarsened elements' high-order dofs are ZEROED at
                    # stage 0 (DG.cpp:1452-1469), which also feeds the
                    # anchor: a later ring promotion restarts them from
                    # clean P0 state
                    with span("pref"), span("pref.mask"):
                        u = u * dm
                un = u
                if self.const_dt is not None:
                    dt = self.const_dt
            if self.face_gp:
                if s == 0 and self.const_dt is None:
                    with span("dt"):
                        dt = dg_dt(system, g, u, dofmask) * (
                            self.cfl * self.cflscale)
                    dt = yield "min", dt
                # the JAX step passes the step's start time to every
                # stage's rhs (quinoa_tpu/inciter/dg.py:302-315); dg_rhs
                # opens the volume and face_pass spans
                r = dg_rhs(system, g, u, dofmask, state.t, face_gp=True,
                           vol_rhs=rv)
            else:
                if g.ndof != 4:
                    # the source at the step's start time, as the JAX
                    # step passes it to every stage's rhs; at P0 the
                    # volume term is the source alone
                    with span("volume"):
                        rv = (volume_rhs(system, g, u, state.t)
                              if g.ndof == 10 or system.has_src else None)
                    with span("face_pass"):
                        r, delt = fused_face_pass(system, g, u, vol_rhs=rv)
                else:
                    # the fused pass sees the masked state; the rows it
                    # writes for inactive dofs are dropped by the restore
                    uf = u
                    if dm is not None and s != 0 and not self.fused_limit:
                        with span("pref"), span("pref.mask"):
                            uf = u * dm
                    if rv is None:
                        with span("volume"):
                            rv = (volume_rhs(system, g, uf, state.t)
                                  if system.has_src
                                  else volume_rhs_plain(system, g, uf))
                    with span("face_pass"):
                        r, delt = self.p1_face_pass(system, g, uf,
                                                    vol_rhs=rv)
                if s == 0 and self.const_dt is None:
                    with span("dt"):
                        dt = dg_dt_from_delt(g, delt) * (
                            self.cfl * self.cflscale)
                    dt = yield "min", dt
            with span("rk_update"):
                unew = RK0[s] * un + RK1[s] * (u + dt * r * self.minv)
                if self.evolved is not None:
                    # rDG: the reconstructed dofs keep their current
                    # (limited) values (quinoa_tpu/inciter/dg.py:324-330)
                    unew = torch.where(self.evolved, unew, u)
                if dm is not None:
                    unew = torch.where(dm > 0, unew, un)
                if owned is not None:
                    unew = torch.where(owned, unew, u)
                u = unew
        return DGState(u=u, ndofel=ndofel, t=state.t + dt,
                       it=state.it + 1, dt=dt)

    def nsteps(self, state: DGState, n: int) -> DGState:
        for _ in range(n):
            state = self.step(state)
        return state


class DGDiagnostics:
    """Element diagnostics: L2 norms via NGdiag-point quadrature
    (reference ElemDiagnostics.cpp)."""

    def __init__(self, system, geom: DGGeom):
        self.system = system
        self.geom = geom
        self.pts, self.w = gauss_tet(ng_diag(geom.ndof))
        self.B = eval_basis_np(geom.ndof, self.pts)     # (G, K)
        self.total_vol = float((geom.vol * geom.emask).sum())

    def compute(self, state: DGState):
        """([l2sol], [l2err], [linferr]) per component, as Python floats.

        p-adaptive states are evaluated with each element's active dofs
        only, and a P0 element's error is taken at its centroid
        (ElemDiagnostics.cpp:171-196, Quadrature.hpp:45-50)."""
        with span("diag"):
            s2, e2, einf = self.sums(state)
            l2sol = torch.sqrt(s2 / self.total_vol)
            l2err = torch.sqrt(e2 / self.total_vol)
            with span("diag.read"):
                count("host_syncs", 3 * len(l2sol))
                return (
                    [float(v) for v in l2sol],
                    [float(v) for v in l2err],
                    [float(v) for v in einf],
                )

    def sums(self, state: DGState):
        """The per-component sums (C,) over the elements with emask > 0:
        the volume-weighted squares of the solution and of its error, and
        the largest error.  A shard's emask marks its owned elements, so
        the parallel diagnostics fold these over the shards."""
        with span("diag.sums"):
            return self._sums(state)

    def _sums(self, state: DGState):
        g = self.geom
        C, K = self.system.ncomp, g.ndof
        dt_, dev = state.u.dtype, state.u.device
        Uv = uview(state.u, C, K)
        n_p0 = 0
        if K > 1:
            # one read: the mixed P0/P1 test and the P0 count.  1 // ndofel
            # is 1 exactly at P0 (ndofel >= 1); its int32 sum launches as
            # many kernels as the == and any() it replaces, where a sum of
            # the bool mask adds a cast
            count("host_syncs")
            n_p0 = int((1 // state.ndofel).sum(dtype=torch.int32))
            if n_p0:
                count("pref_p0_elements", n_p0)
        mixed = n_p0 > 0
        p0 = None
        if mixed:
            kmask = (torch.arange(K, device=dev)[None, :, None]
                     < state.ndofel[None, None, :]).to(dt_)
            Uv = Uv * kmask
            p0 = (state.ndofel == 1) & (g.emask > 0)
        ve = g.vol * g.emask
        s2 = torch.zeros(C, dtype=dt_, device=dev)
        e2 = torch.zeros(C, dtype=dt_, device=dev)
        einf = torch.zeros(C, dtype=dt_, device=dev)
        for gi in range(len(self.w)):
            count("host_syncs", 2)      # the two uploads below
            B = torch.as_tensor(self.B[gi], dtype=dt_, device=dev)[:, None]
            sgp = (Uv * B).sum(dim=1)                       # (C,E)
            xi = torch.as_tensor(self.pts[gi], dtype=dt_, device=dev)[:, None]
            gp = _phys_gp(g.node0, g.Jmat, xi)
            a = self.system.analytic(gp, state.t).to(dt_)
            w = float(self.w[gi]) * ve
            s2 = s2 + (w * sgp**2).sum(dim=1)
            err = (sgp - a) * (g.emask > 0)
            if p0 is not None:
                err = err * (~p0)   # a P0 error comes from the centroid
            e2 = e2 + (w * err**2).sum(dim=1)
            einf = torch.maximum(einf, err.abs().amax(dim=1))
        if p0 is not None:
            ctr = torch.full((3, 1), 0.25, dtype=dt_, device=dev)
            a = self.system.analytic(_phys_gp(g.node0, g.Jmat, ctr),
                                     state.t).to(dt_)
            errc = (Uv[:, 0, :] - a) * p0
            e2 = e2 + (ve * errc**2).sum(dim=1)
            einf = torch.maximum(einf, errc.abs().amax(dim=1))
        return s2, e2, einf
