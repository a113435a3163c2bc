"""The plain DG(P1) step: SSP-RK3 with Superbee limiting, written with
ordinary torch operations on the reference's own geometry.

Each stage limits the state, takes the volume and face integrals and
applies u = rk0*un + rk1*(u + dt*r/M), with the RK anchor un the limited
stage-0 state and dt from the stage-0 face sweep of the limited state
(Quinoa's DG.cpp).  A system supplies the physics: ncomp, the initial
state, the flux columns, the Riemann flux (with any extra rows), the
boundary ghost, the characteristic speed, a limiter adjustment and a
post-stage fix-up.  Faces are summed with index_add_, so the sum order is
not the program's.
"""

from __future__ import annotations

import dataclasses

import torch

from .geometry import Geom

RK0 = (0.0, 3.0 / 4.0, 1.0 / 3.0)
RK1 = (1.0, 1.0 / 4.0, 2.0 / 3.0)
K = 4


@dataclasses.dataclass
class State:
    u: torch.Tensor   # (C*K, E)
    t: float
    dt: float


def initial(system, g: Geom, points=torch.float64):
    """L2 projection of the system's initial state on the P1 basis.  The
    state is sampled at the quadrature points as the configuration's
    precision, `points`, computes them (its rounded node coordinates and
    Jacobians): a point within rounding of a discontinuity lies on the
    side that precision puts it."""
    xi = g.tab["xi_init"].T.to(points)                        # (3, Gi)
    gp = g.node0.to(points)[:, None, :] + torch.einsum(
        "ime,mg->ige", g.jac.to(points), xi)
    f = system.initialize(gp.to(g.vol.dtype))                 # (C, Gi, E)
    wB = g.tab["w_init"][:, None] * g.tab["B_init"]           # (Gi, K)
    proj = torch.einsum("gk,cge->cke", wB, f) / g.tab["mnorm"][None, :, None]
    return proj.reshape(-1, g.nelem)


def superbee_phi(g: Geom, U, C, beta=2.0):
    """The Superbee coefficient (C, E) of every component's P1 dofs from
    the min/max of the element's and its face neighbours' means, taken at
    the face points of the element's own four faces."""
    Uv = U.reshape(C, K, -1)
    u0 = Uv[:, 0]
    valid = g.esuel >= 0
    nb = torch.where(valid, g.esuel, 0)
    umax, umin = u0, u0
    for i in range(4):
        un = u0[:, nb[i]]
        umax = torch.where(valid[i], torch.maximum(umax, un), umax)
        umin = torch.where(valid[i], torch.minimum(umin, un), umin)
    Bs = g.tab["B_self"]                                      # (4, G, K)
    one = torch.ones_like(u0)
    phi = one
    eps = 1.0e-14
    for lf in range(4):
        for q in range(Bs.shape[1]):
            s = torch.einsum("k,cke->ce", Bs[lf, q], Uv)
            d = s - u0
            up = torch.minimum(one, (umax - u0) / (2.0 * torch.where(d > eps, d, one)))
            dn = torch.minimum(one, (umin - u0) / (2.0 * torch.where(d < -eps, d, one)))
            pg = torch.where(d > eps, up, torch.where(d < -eps, dn, one))
            pg = torch.clamp_min(torch.maximum(torch.clamp_max(beta * pg, 1.0),
                                               torch.clamp_max(pg, beta)), 0.0)
            phi = torch.minimum(phi, pg)
    return phi


def limit(system, g: Geom, U):
    C = system.ncomp
    phi = system.adjust_phi(superbee_phi(g, U, C))
    Uv = U.reshape(C, K, -1)
    return torch.cat([Uv[:, :1], Uv[:, 1:] * phi[:, None]], dim=1).reshape(U.shape)


def volume(system, g: Geom, U):
    """Flux volume integral (C*K, E) of U."""
    C = system.ncomp
    s = torch.einsum("gk,cke->cge", g.tab["B_vol"], U.reshape(C, K, -1))
    F = system.flux_cols(s)                                   # 3 x (C, Gv, E)
    Fref = torch.stack([F[0] * g.jinv[m, 0, None, None] + F[1] * g.jinv[m, 1, None, None]
                        + F[2] * g.jinv[m, 2, None, None] for m in range(3)])
    R = torch.einsum("gkm,mcge->cke", g.tab["wdB"], Fref)
    return (R * g.vol).reshape(C * K, -1)


def face_sums(system, g: Geom, U):
    """(acc (R, K, E), delt (E,)): the face integrals of the system's R
    flux rows summed onto both sides (minus on the left, plus on the
    right) and each element's summed weighted characteristic speed."""
    C = system.ncomp
    Uv = U.reshape(C, K, -1)
    sL = torch.einsum("kgf,ckf->cgf", g.B_l, Uv[:, :, g.el])
    sR = torch.einsum("kgf,ckf->cgf", g.B_r, Uv[:, :, g.er])
    fn = g.fn[:, None, :]
    inner = g.interior
    sR = torch.where(inner, sR, system.ghost(g.bctype, sL, fn))
    fl = system.riemann(fn, sL, sR)                           # (R, G, F)
    wt = g.tab["w_face"][:, None] * g.farea                   # (G, F)
    wfl = fl * wt
    vl, vr = system.charvel(sL, fn), system.charvel(sR, fn)
    mx = (wt * torch.where(inner, torch.maximum(vl, vr), vl)).sum(0)
    cL = torch.einsum("kgf,rgf->rkf", g.B_l, wfl)
    cR = torch.einsum("kgf,rgf->rkf", g.B_r, wfl)
    E = g.nelem
    acc = U.new_zeros((fl.shape[0], K, E))
    acc.index_add_(2, g.el, -cL)
    acc.index_add_(2, g.er[inner], cR[:, :, inner])
    delt = U.new_zeros(E)
    delt.index_add_(0, g.el, mx)
    delt.index_add_(0, g.er[inner], mx[inner])
    return acc, delt


def rhs(system, g: Geom, U):
    acc, delt = face_sums(system, g, U)
    return system.assemble(g, U, volume(system, g, U), acc), delt


class Solver:
    """The reference stepper of one system on one geometry."""

    def __init__(self, system, g: Geom, cfl: float, eorder=None,
                 points=torch.float64):
        self.system, self.g, self.cfl = system, g, cfl
        #: the precision the initial state's quadrature points are in
        self.points = points
        #: new -> old element order of the geometry (geometry.build)
        self.eorder = eorder
        C = system.ncomp
        self.minv = (1.0 / (g.vol[None] * g.tab["mnorm"][:, None])).repeat(C, 1)

    def cast(self, dtype):
        """The same solver computing in dtype (tables rounded from
        float64)."""
        return Solver(self.system, self.g.to(dtype), self.cfl, self.eorder,
                      self.points)

    def initial_state(self):
        return State(u=initial(self.system, self.g, self.points), t=0.0, dt=0.0)

    def step(self, st: State) -> State:
        g, sy = self.g, self.system
        un = u = st.u
        dt = None
        for s in range(3):
            u = limit(sy, g, u)
            r, delt = rhs(sy, g, u)
            if s == 0:
                un = u
                dt = (g.vol / delt).min() * (self.cfl / 3.0)
            u = sy.fixup(RK0[s] * un + RK1[s] * (u + dt * r * self.minv))
        return State(u=u, t=st.t + float(dt), dt=float(dt))
