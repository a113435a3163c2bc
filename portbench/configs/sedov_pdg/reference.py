"""Plain reference of sedov_pdg: Euler, HLLC, Superbee, SSP-RK3 DG(P1)
under p-adaptivity (each element at P1 or P0, chosen every step) from the
deck's settings, with the Sedov initial state of Quinoa's
src/PDE/CompFlow/Problem/SedovBlastwave.cpp (a hot corner column
x, y < 0.05 at p = 783.4112 in a gas at rest, density 1, p = 1e-6).

The three p-adaptive mechanisms of Quinoa's src/Inciter/DG.cpp, each step:

- the sticky indicator (DG.cpp:1108): only an element at P1 is
  re-evaluated, and it stays at P1 where any component's gradient
  magnitude exceeds tolref (0.1 unless the deck's pref block sets it);
  an element at P0 stays there;
- the one-ring promotion (DG.cpp:1286-1313): every face neighbour of an
  element at P1 after the indicator goes to P1, read from the
  indicator's result, not transitively;
- the stage-0 zeroing (DG.cpp:1452-1469): the slopes of the elements at
  P0 are set to zero after the stage-0 limiter, and that state is the RK
  anchor.

Each stage limits the elements at P1 (those at P0 keep their state),
takes the volume and face integrals of the state with the P0 elements'
slopes masked out, and applies the RK update to the active dofs only: an
inactive dof takes the anchor's value again, so it stays zero.

Departures from DG.cpp, besides those of the DG(P1) reference
(reference/dg.py: faces summed with index_add_, so the sum order is not
the program's):

- The state carries no dof counts: the benchmark keeps only u, t and dt
  of the program's states.  Each step rebuilds them from u: an element
  is at P1 where any of its slope dofs is non-zero, else at P0.  This
  gives the same counts after the indicator as the program's own,
  because (1) an element the program keeps at P0 ends every step with
  all slopes exactly zero (zeroed at stage 0, restored from that anchor
  at every later stage, and left alone by the limiter), so it reads P0
  here too, where it stays; and (2) an element the program keeps at P1
  either has a non-zero slope, and reads P1 here too, or has none, and
  then its gradient is zero, never above tolref > 0, so the indicator
  drops it to P0 in the program as it stays at P0 here.  At the initial
  state the program holds every element at P1; by (2) that also agrees.
  The promotion reads only the indicator's result, so it agrees as well.
- The indicator is the gradient form the repository restates from
  DG.cpp eval_ndof (1089-1163): the physical gradient of each
  component's P1 part, |sum_k u_k dB_k/dxi . dxi/dx|; the upstream
  source is not in this repository.
- The masked rhs computes the inactive rows too and the update drops
  them, where DG.cpp loops over each element's active dofs only: the
  same numbers.
"""

import torch

from reference import dg, euler, geometry
from reference.deck import parse

P_HOT, P_AMBIENT, RCORNER = 783.4112, 1.0e-6, 0.05
#: the p-adaptive threshold without a pref block (InputDeck.hpp:232)
TOLREF = 0.1
K = dg.K


def initialize(xyz, system):
    x, y = xyz[0], xyz[1]
    hot = (x < RCORNER) & (y < RCORNER)
    p = torch.where(hot, torch.full_like(x, P_HOT), torch.full_like(x, P_AMBIENT))
    z = torch.zeros_like(x)
    return torch.stack([torch.ones_like(x), z, z, z, p / (system.gamma - 1.0)])


def tolref(deck_text):
    """The deck's `pref ... tolref <x>`, or the default."""
    tok = []
    for line in deck_text.splitlines():
        tok += line.split("#", 1)[0].split()
    return float(tok[tok.index("tolref") + 1]) if "tolref" in tok else TOLREF


def at_p1(u, C):
    """(E,) bool: the elements whose state has a non-zero slope dof."""
    return (u.reshape(C, K, -1)[:, 1:] != 0).any(dim=1).any(dim=0)


def indicator(g, u, C, tol):
    """(E,) bool: some component's gradient magnitude exceeds tol."""
    dbdxi = torch.as_tensor(geometry.DBDXI[1:], dtype=u.dtype, device=u.device)
    dudxi = torch.einsum("km,cke->cme", dbdxi, u.reshape(C, K, -1)[:, 1:])
    grad = torch.einsum("cme,mje->cje", dudxi, g.jinv)
    return (torch.sqrt((grad * grad).sum(dim=1)) > tol).any(dim=0)


def promote(g, p1):
    """p1 with every face neighbour of a p1 element added."""
    valid = g.esuel >= 0
    nb = p1[torch.where(valid, g.esuel, 0)] & valid           # (4, E)
    return p1 | nb.any(dim=0)


class Solver(dg.Solver):
    """The reference stepper of p-adaptive DG(P1)."""

    def __init__(self, system, g, cfl, eorder=None, points=torch.float64,
                 tol=TOLREF):
        super().__init__(system, g, cfl, eorder, points)
        self.tol = tol

    def cast(self, dtype):
        return Solver(self.system, self.g.to(dtype), self.cfl, self.eorder,
                      self.points, self.tol)

    def step(self, st: dg.State) -> dg.State:
        g, sy = self.g, self.system
        C = sy.ncomp
        u = st.u
        p1 = at_p1(u, C) & indicator(g, u, C, self.tol)
        p1 = promote(g, p1)
        # (C*K, E): 1 on the means, the element's P1 flag on the slopes
        mask = torch.cat([torch.ones_like(p1)[None], p1[None].expand(K - 1, -1)])
        mask = mask.repeat(C, 1).to(u.dtype)
        un = u
        dt = None
        for s in range(3):
            u = torch.where(p1, dg.limit(sy, g, u), u)
            if s == 0:
                u = u * mask
                un = u
            r, delt = dg.rhs(sy, g, u * mask)
            if s == 0:
                dt = (g.vol / delt).min() * (self.cfl / 3.0)
            unew = sy.fixup(dg.RK0[s] * un + dg.RK1[s] * (u + dt * r * self.minv))
            u = torch.where(mask > 0, unew, un)
        return dg.State(u=u, t=st.t + float(dt), dt=float(dt))


def make(deck_text, mesh, device, precision):
    """The float64 reference solver of the deck on the raw mesh
    {coords, inpoel, bface}, its elements in Hilbert order, its initial
    state sampled at quadrature points in the configuration's
    precision."""
    d = parse(deck_text)
    if (d["scheme"], d["limiter"], d["flux"] or "hllc") != ("pdg", "superbeep1", "hllc"):
        raise ValueError("this reference is p-adaptive DG (pdg), Superbee and "
                         "HLLC only")
    codes = {**{s: geometry.BC_EXTRAPOLATE for s in d["bc_extrapolate"]},
             **{s: geometry.BC_SYMMETRY for s in d["bc_sym"]}}
    g, eorder = geometry.build(mesh["coords"], mesh["inpoel"], mesh["bface"], codes,
                               device)
    system = euler.Euler(d["gamma"][0], initialize)
    return Solver(system, g, d["cfl"], eorder, getattr(torch, precision),
                  tolref(deck_text))
