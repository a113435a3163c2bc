"""DiagCG: node-centred, diagonally-lumped Taylor-Galerkin + FCT solver, on
torch.

Port of quinoa_tpu/inciter/diagcg.py for one device (reference
src/Inciter/DiagCG.cpp: dt 229-286, rhs 288-357, solve 359-414, update
472-500, with its DistFCT companion).  One step is

    dt -> rhs + mass diffusion -> low/high solve -> FCT aec -> alw -> lim
       -> u' = ul + A

through three node gathers (K10) and three node assemblies (K11) on a
CUDA geometry (their plain versions on a CPU one).  State fields are
feature-major (C, N).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..fct.fct import FCT
from ..pde.cg import (CGGeom, cg_assemble_add, cg_assemble_add_max,
                      cg_gather, lumped_mass)


@dataclasses.dataclass
class CGState:
    """Time-marching state for node-centred schemes; u is (C, nnode)."""

    u: torch.Tensor
    t: torch.Tensor
    it: torch.Tensor
    dt: torch.Tensor


def _identity_combine(x):
    return x


def diagcg_advance(
    system,
    fct: FCT,
    use_fct: bool,
    geom: CGGeom,
    lhs,
    bcmask,
    u,
    t,
    dt,
    combine_sum=_identity_combine,
    combine_max=_identity_combine,
    combine_min=_identity_combine,
    bc_n=None,
    vol_n=None,
):
    """One DiagCG(+FCT) update of u (C, N) over dt, with the JAX package's
    signature: diagcg_advance_coroutine below, its requests answered by
    the combine hooks (the identity on one device; combine_min sits at
    the JAX package's position and is never called).  bc_n (4, C, E) and
    vol_n (4, E) are the static gathers of bcmask and the nodal volumes
    (the solver makes them once)."""
    hooks = {"sum": combine_sum, "max": combine_max}
    gen = diagcg_advance_coroutine(system, fct, use_fct, geom, lhs, bcmask,
                                   u, t, dt, bc_n=bc_n, vol_n=vol_n)
    try:
        op, x = next(gen)
        while True:
            op, x = gen.send(hooks[op](x))
    except StopIteration as e:
        return e.value


def diagcg_advance_coroutine(system, fct: FCT, use_fct: bool, geom: CGGeom,
                             lhs, bcmask, u, t, dt, bc_n=None, vol_n=None):
    """One DiagCG(+FCT) update of u (C, N) over dt as a coroutine
    (base/lockstep.py).  It yields ("sum", x) and ("max", x) where the
    reference's DistFCT exchanged chare-boundary messages on node buffers
    x (C', N): sums of rhs + dif, P and A; maxima of Q, whose minima ride
    negated (the JAX package's combine_min is never called either), and
    returns the updated u."""
    C = u.shape[0]
    # one nodal gather feeds the PDE rhs, the mass diffusion and the AEC;
    # rhs and diffusion ride one stacked assembly
    un = cg_gather(geom, u)                                  # (4, C, E)
    rc = system.rhs_contrib(t, dt, geom, u, un)
    dc = fct.diff_contrib(geom, un)
    rd = yield "sum", cg_assemble_add(geom, torch.cat([rc, dc], dim=1))
    r, dif = rd[:C], rd[C:]

    # Dirichlet BCs: lhs = 1, rhs = the increment, dif = 0 at BC nodes
    # (DiagCG::solve, src/Inciter/DiagCG.cpp:359-414)
    bc = bcmask > 0
    binc = system.solinc(geom.coords, t, dt).to(u.dtype)
    lhs_eff = torch.where(bc, 1.0, lhs[None, :])
    r = torch.where(bc, binc, r)
    dif = torch.where(bc, 0.0, dif)

    dul = (r + dif) / lhs_eff
    ul = u + dul
    du = r / lhs_eff
    if not use_fct:
        return u + du

    aec = fct.aec_contrib(geom, du, u, bcmask, un=un, bc_n=bc_n,
                          vol_n=vol_n)
    # gather(max(Ul, Un)) == max(gather(Ul), un): alw rides a C-row gather
    uln = cg_gather(geom, ul)
    s_el = fct.alw_contrib(geom, u, ul, un=un, uln=uln)      # (2C, E)
    pq = torch.cat([torch.clamp_min(aec, 0.0), torch.clamp_max(aec, 0.0)],
                   dim=1)
    # P's sums and Q's maxima in one K11 pass; s_el is the same row at all
    # four corners of an element.  Each row is summed or maxed in slot
    # order, so this equals the JAX package's split and fused paths.
    P2, Q2 = cg_assemble_add_max(geom, pq, s_el[None])
    P2 = yield "sum", P2
    P = torch.stack([P2[:C], P2[C:]])
    Q2 = yield "max", Q2                                     # [qmax | -qmin]
    Q = torch.stack([Q2[:C], -Q2[C:]])
    A = yield "sum", fct.lim(geom, aec, P, Q, ul)
    return ul + A


class DiagCGSolver:
    """Single-device DiagCG driver.

    system   : CGTransport or CGCompFlow
    geom     : CGGeom static geometry
    cfl      : Courant number scaling the min element dt
    const_dt : a constant dt instead of the CFL one, if given
    ctau     : FCT mass-diffusion coefficient
    fct      : flux-corrected transport (else plain lumped-mass TG)
    bcnodes  : node ids with Dirichlet BCs on all components
    """

    def __init__(self, system, geom: CGGeom, cfl: float = 0.5,
                 const_dt: Optional[float] = None, ctau: float = 1.0,
                 fct: bool = True, bcnodes=None):
        self.system = system
        self.geom = geom
        self.cfl = cfl
        self.const_dt = const_dt
        self.fct = FCT(ctau=ctau)
        self.use_fct = fct

        dtype, dev = geom.dtype, geom.device
        bcmask = torch.zeros((system.ncomp, geom.nnode), dtype=dtype,
                             device=dev)
        if bcnodes is not None and len(bcnodes) > 0:
            idx = torch.as_tensor(bcnodes, dtype=torch.long).to(dev)
            bcmask[:, idx] = 1.0
        self.bcmask = bcmask
        # assembled lumped-mass lhs (DiagCG::lhs)
        self.lhs = lumped_mass(geom)
        # static gathers, once: bcmask and nodal volumes at element nodes
        self.bc_n = cg_gather(geom, bcmask)
        self.vol_n = cg_gather(geom, geom.vol[None, :])[:, 0]

        # CGTransport's dt law reads only the static velocity field: the
        # per-step sweep is a run constant
        self._static_dt = None
        if const_dt is None and getattr(system, "static_dt", False):
            u0 = system.initialize(geom.coords, 0.0).to(dtype)
            self._static_dt = system.dt(geom, u0) * torch.tensor(
                cfl, dtype=dtype, device=dev)

    def initial_state(self, t0: float = 0.0) -> CGState:
        g = self.geom
        return CGState(
            u=self.system.initialize(g.coords, t0).to(g.dtype).contiguous(),
            t=torch.tensor(t0, dtype=g.dtype, device=g.device),
            it=torch.tensor(0, dtype=torch.int32, device=g.device),
            dt=torch.tensor(0.0, dtype=g.dtype, device=g.device))

    def compute_dt(self, u):
        if self.const_dt is not None:
            return torch.tensor(self.const_dt, dtype=self.geom.dtype,
                                device=self.geom.device)
        if self._static_dt is not None:
            return self._static_dt
        return self.system.dt(self.geom, u) * self.cfl

    def step(self, state: CGState) -> CGState:
        dt = self.compute_dt(state.u)
        u = diagcg_advance(self.system, self.fct, self.use_fct, self.geom,
                           self.lhs, self.bcmask, state.u, state.t, dt,
                           bc_n=self.bc_n, vol_n=self.vol_n)
        return CGState(u=u, t=state.t + dt, it=state.it + 1, dt=dt)

    def nsteps(self, state: CGState, n: int) -> CGState:
        for _ in range(n):
            state = self.step(state)
        return state
