"""DG time stepping: SSP-RK3 with limiting, p-adaptivity and rDG, on
torch.

Port of quinoa_tpu/inciter/dg.py for DG(P0), DG(P1) and DG(P2).  Each of
the three RK stages (pde/dg_step.py, the loop multimat shares) limits,
(stage 0) evaluates the p-adaptive dofs and the dt, takes the rhs and
applies

    u = rk0[s]*un + rk1[s]*(u + dt*r/M)

with the block-diagonal mass matrix diagonal in the Dubiner basis
(M_k = vol*mnorm_k).  The RK anchor un is the LIMITED stage-0 state
(reference DG.cpp:1471).  The routes (pde/dg_step.py Route; choose_route
picks one when the solver is built), as the JAX package dispatches them
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

import functools
from typing import Optional

import torch

from ..base.profiler import count, span
from ..ops.basis import eval_basis_np
from ..ops.face_fused import fused_face_pass
from ..ops.nbr_bounds import (neighbor_mean_bounds, superbee_limit_window,
                              volume_rhs_plain)
from ..ops.quadrature import gauss_tet, ng_diag
from ..pde.dg import (DGGeom, _phys_gp, dg_dt, dg_rhs, dofmask_of,
                      eval_ndof_sticky, propagate_ndof, uview, volume_rhs)
from ..pde.dg_step import SSPRK3, DGState, choose_route
from ..pde.limiter import superbee_p1, weno_p1


class DGSolver(SSPRK3):
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

    #: the fused face pass (K12 + K13) off the face Gauss-point path
    p1_face_pass = staticmethod(fused_face_pass)

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
        route = self.route or choose_route(system, [geom], limiter, pref,
                                           const_dt)
        self.limiter = limiter
        self.cweight = cweight
        self.pref = pref
        self.tolref = tolref
        # rDG(PnPm): faces and limiters see every dof, only the first
        # evolve_ndof advance, and the CFL scale is the EVOLVED order's
        # (quinoa_tpu/inciter/dg.py:83-90)
        self.evolve_ndof = evolve_ndof or geom.ndof
        self._setup(system, geom, cfl, const_dt, route, self.evolve_ndof,
                    lambda u, dofmask: dg_dt(system, geom, u, dofmask))
        self.dt_factors = (cfl * self.cflscale,)
        C, K = system.ncomp, geom.ndof
        if self.evolve_ndof < K:
            #: rDG: the rows that advance (c*K + k with k < evolve_ndof)
            self.evolved = (torch.arange(K, device=geom.device).repeat(C)
                            < self.evolve_ndof)[:, None]
        part = functools.partial    # stages that do not hold the solver
        if pref:
            self._masks = part(_pref_masks, geom, C)
            if K >= 4:
                self._adapt = part(_pref_ring, geom, C, tolref)
            if route.limit not in ("k1", "k1_pref"):
                self._zero = _zero_inactive
        self._limit_fn = {
            "none": lambda u, nd, dofmask: (u, None),
            "k1": lambda u, nd, dofmask: superbee_limit_window(
                geom, u, system),
            # the p-adaptive flavour writes the masked state
            "k1_pref": lambda u, nd, dofmask: superbee_limit_window(
                geom, u, system, ndofel=nd),
            "superbee_split": part(_superbee_split, geom, C),
            "weno": lambda u, nd, dofmask: (
                weno_p1(geom, u, dofmask, C, cweight), None)}[route.limit]
        vol = {"plain": volume_rhs_plain, "xla": volume_rhs,
               "none": lambda *_: None}.get(route.volume)
        self._rhs = (part(_rhs_face_gp, system, geom)
                     if route.face == "face_gp" else
                     part(_rhs_face_pass, system, geom, self._zero, vol))


def _pref_ring(geom, C, tolref, ndofel, u):
    """Stage 0's dof counts; a ghost's sticky history lives with its
    owner: exchanged, promoted one ring, exchanged."""
    with span("pref"), span("pref.eval"):
        ndofel = eval_ndof_sticky(geom, u, ndofel, C, tolref)
    ndofel = (yield "halo", ndofel[None])[0]
    with span("pref"), span("pref.propagate"):
        ndofel = propagate_ndof(geom, ndofel)
    return (yield "halo", ndofel[None])[0]


def _pref_masks(geom, C, ndofel):
    with span("pref"), span("pref.mask"):
        dofmask = dofmask_of(ndofel, geom.ndof, geom.dtype)
        return dofmask, dofmask.repeat(C, 1)


def _zero_inactive(u, dm):
    """u, coarsened elements' high-order dofs ZEROED: the stage-0 state and
    anchor (DG.cpp:1452-1469), later stages' fused face pass input."""
    with span("pref"), span("pref.mask"):
        return u * dm


def _superbee_split(geom, C, u, ndofel, dofmask):
    with span("limit.bounds"):
        bounds = neighbor_mean_bounds(geom, u, C)
    with span("limit.superbee"):
        return superbee_p1(geom, u, dofmask, C, bounds=bounds), None


def _rhs_face_gp(system, geom, s, u, dofmask, dm, rv, t):
    # at the step's start time, as the JAX step passes it to every stage
    # (quinoa_tpu/inciter/dg.py:302-315); dg_rhs opens the spans
    return dg_rhs(system, geom, u, dofmask, t, face_gp=True,
                  vol_rhs=rv), None


def _rhs_face_pass(system, geom, zero, vol, s, u, dofmask, dm, rv, t):
    # the fused pass sees the masked state (zeroed at stage 0); the rows
    # it writes for inactive dofs are dropped by the restore
    uf = u if s == 0 else zero(u, dm)
    if rv is None:
        with span("volume"):
            rv = vol(system, geom, uf, t)
    with span("face_pass"):
        return fused_face_pass(system, geom, uf, vol_rhs=rv)


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
            Uv = Uv * dofmask_of(state.ndofel, K, dt_)[None]
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
