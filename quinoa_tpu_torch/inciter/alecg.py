"""ALECG: node-centred RK3 Galerkin scheme with edge-based dissipation, on
torch.

Port of quinoa_tpu/inciter/alecg.py for one device:

- lumped-mass P1 Galerkin volume term: node a of element e receives
  -(V_e/4) sum_b grad_b . F(u_b);
- edge Rusanov dissipation over the edge graph: R_a += A_ab lambda_ab
  (u_b - u_a), A_ab = 2 m_ab / h_ab from the consistent-mass off-diagonal
  m_ab = sum_e J_e/120, lambda_ab the larger characteristic speed of the
  two nodes;
- SSP-RK3 stages u = rk0 un + rk1 (u + dt R / M_L), dt = system.dt * cfl
  / 3;
- Dirichlet nodes pinned to the analytic solution after every stage.

The stage rhs runs the kernels K7-K9 (ops/alecg_fused.py) on a CUDA
geometry, their plain versions on a CPU one; there is no switch between
them.  ``alecg_flux_rhs`` and ``alecg_dissipation`` are the JAX package's
XLA formulation ported as written, which the tests hold the kernels'
plain versions against.  State fields are feature-major (C, N).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..mesh.derived import _TET_EDGES, gen_inpoed
from ..mesh.geometry import tet_geometry
from ..ops.alecg_fused import alecg_rhs, build_alecg_rows
from ..ops.assembly import assemble_add, build_nsup, gather_nodes
from ..pde.cg import CGGeom, lumped_mass, make_cggeom
from .diagcg import CGState

RK0 = (0.0, 3.0 / 4.0, 1.0 / 3.0)
RK1 = (1.0, 1.0 / 4.0, 2.0 / 3.0)


@dataclasses.dataclass(frozen=True)
class EdgeTables:
    """Edge graph of the dissipation operator.

    edges : (2, nE) i32    endpoints, low id first
    A     : (nE,)          dual-face area scale 2*m_ab/h_ab
    ensup : (D, N) i32     edge-slot assembly table (slot side*nE + edge)
    xyz   : (2, 3, nE)     static endpoint coordinates
    """

    edges: torch.Tensor
    A: torch.Tensor
    ensup: torch.Tensor
    xyz: torch.Tensor


def edge_arrays_np(coords: np.ndarray, inpoel: np.ndarray, nnode: int):
    """Host-side edge graph: (edges (nE, 2) int64 lo<hi, A (nE,) float64,
    ensup (D, nnode) int32, D), as quinoa_tpu's edge_arrays_np.  m_ab sums
    over the given elements only."""
    edges = gen_inpoed(inpoel).astype(np.int64)  # (nE, 2) lo<hi, lexsorted
    nE = len(edges)
    key = edges[:, 0] << 32 | edges[:, 1]

    # consistent-mass off-diagonal sums m_ab = sum_e J_e/120 over the
    # elements that hold edge (a, b)
    J, _ = tet_geometry(coords, inpoel)
    m = np.zeros(nE)
    inp = inpoel.astype(np.int64)
    for le in range(6):
        a = inp[:, _TET_EDGES[le, 0]]
        b = inp[:, _TET_EDGES[le, 1]]
        k = np.minimum(a, b) << 32 | np.maximum(a, b)
        np.add.at(m, np.searchsorted(key, k), J / 120.0)

    h = np.linalg.norm(coords[edges[:, 1]] - coords[edges[:, 0]], axis=1)
    A = 2.0 * m / h

    ensup, D = build_nsup(edges.astype(np.int32), nnode)
    return edges, A, ensup, D


def build_edge_tables(mesh, dtype: torch.dtype = torch.float64,
                      device=DEFAULT_DEVICE) -> EdgeTables:
    """ALECG edge tables of a host UnsMesh, on the card unless ``device``
    says otherwise."""
    device = resolve_device(device)
    edges, A, ensup, _ = edge_arrays_np(mesh.coords, mesh.inpoel, mesh.nnode)
    xyz = np.stack([mesh.coords[edges[:, 0]].T, mesh.coords[edges[:, 1]].T])
    return EdgeTables(
        edges=torch.from_numpy(np.ascontiguousarray(edges.T, np.int32)
                               ).to(device),
        A=torch.from_numpy(A).to(dtype).to(device),
        ensup=torch.from_numpy(np.ascontiguousarray(ensup)).to(device),
        xyz=torch.from_numpy(np.ascontiguousarray(xyz)).to(dtype).to(device),
    )


def alecg_flux_rhs(system, geom: CGGeom, u):
    """Galerkin volume rhs (C, N): R_a -= (V_e/4) sum_b grad_b . F(u_b)
    (the XLA formulation)."""
    un = gather_nodes(u, geom.inpoelT)  # (4, C, E)
    divF = None
    for b in range(4):
        fb = system.flux_at_nodes(un[b], geom.coords_n[b])
        d = sum(geom.grad[b, j] * fb[j] for j in range(3))
        divF = d if divF is None else divF + d
    w = (geom.J * geom.emask) / 24.0  # V/4
    return assemble_add((-w * divF)[None].expand((4,) + tuple(divF.shape)),
                        geom.nsup)


def alecg_dissipation(system, geom: CGGeom, edges, A, ensup, u, exyz=None):
    """Edge Rusanov (C, N): R_a += A_ab lambda_ab (u_b - u_a); exyz is the
    optional static endpoint-coordinate cache (2, 3, nE)."""
    a, b = edges[0].long(), edges[1].long()
    ua, ub = u[:, a], u[:, b]
    xa = exyz[0] if exyz is not None else geom.coords[:, a]
    xb = exyz[1] if exyz is not None else geom.coords[:, b]
    lam = torch.maximum(system.charspeed(ua, xa), system.charspeed(ub, xb))
    d = A * lam * (ub - ua)  # (C, nE)
    return assemble_add(torch.stack([d, -d]), ensup)


class ALECGSolver:
    """RK3 node-centred solver on one device (static mesh: the ALE hooks
    reduce to the Eulerian frame).  The signature mirrors quinoa_tpu's
    ALECGSolver."""

    def __init__(
        self,
        system,
        geom: CGGeom,
        edget: EdgeTables,
        cfl: float = 0.5,
        const_dt: Optional[float] = None,
        bcnodes=None,
    ):
        self.system = system
        self.geom = geom
        self.edget = edget
        self.cfl = cfl
        self.rows = build_alecg_rows(system, geom, edget)
        self.lhs = lumped_mass(geom)
        dtype, dev = geom.dtype, geom.device
        self.const_dt = None if const_dt is None else torch.tensor(
            const_dt, dtype=dtype, device=dev)
        problem = system.problem
        self.manufactured = getattr(problem, "manufactured", False)
        # a steady problem's source and Dirichlet values do not depend on
        # t: evaluated once, equal bit for bit to the per-stage values
        self.steady = getattr(problem, "steady", False)

        # the Dirichlet pin is evaluated on the pinned nodes only (the
        # JAX step evaluates it everywhere and selects them)
        self.bidx = None
        if bcnodes is not None and len(bcnodes) > 0:
            self.bidx = torch.from_numpy(
                np.unique(np.asarray(bcnodes, dtype=np.int64))).to(dev)
            self.bxyz = geom.coords[:, self.bidx].contiguous()
        self._vsrc = self._pin = None
        if self.steady:
            if self.manufactured:
                self._vsrc = self._source(0.0)
            if self.bidx is not None:
                self._pin = system.analytic(self.bxyz, 0.0).to(dtype)

        # time-independent-velocity transport: the dt sweep is a run
        # constant (the JAX solver's _static_dt)
        self._static_dt = None
        if const_dt is None and getattr(system, "static_dt", False):
            u0 = system.initialize(geom.coords, 0.0).to(dtype)
            self._static_dt = system.dt(geom, u0) * (cfl / 3.0)

    def _source(self, t):
        """Nodal-quadrature manufactured source: node i receives
        V_i s(x_i, t) (lumped-mass consistent)."""
        g = self.geom
        return g.vol[None, :] * self.system.problem.src(g.coords, t).to(
            g.dtype)

    def initial_state(self, t0: float = 0.0) -> CGState:
        g = self.geom
        u0 = self.system.initialize(g.coords, t0)
        return CGState(
            u=u0.to(g.dtype).contiguous(),
            t=torch.tensor(t0, dtype=g.dtype, device=g.device),
            it=torch.tensor(0, dtype=torch.int32, device=g.device),
            dt=torch.tensor(0.0, dtype=g.dtype, device=g.device),
        )

    def step(self, state: CGState) -> CGState:
        g, system = self.geom, self.system
        if self.const_dt is not None:
            dt = self.const_dt
        elif self._static_dt is not None:
            dt = self._static_dt
        else:
            dt = system.dt(g, state.u) * self.cfl / 3.0  # RK3 CFL

        un = u = state.u
        # SSP-RK3 stage times: sources at the INPUT state's time (t,
        # t+dt, t+dt/2); each stage's OUTPUT stands for (t+dt, t+dt/2,
        # t+dt), where the Dirichlet pin is evaluated
        t = state.t
        ts = (t, t + dt, t + 0.5 * dt)
        to = (t + dt, t + 0.5 * dt, t + dt)
        for s in range(3):
            r = alecg_rhs(system, g, self.edget, self.rows, u)
            if self.manufactured:
                r = r + (self._vsrc if self.steady else self._source(ts[s]))
            u = RK0[s] * un + RK1[s] * (u + dt * r / self.lhs[None, :])
            if self.bidx is not None:
                ubc = self._pin if self.steady else system.analytic(
                    self.bxyz, to[s]).to(u.dtype)
                u = u.index_copy(1, self.bidx, ubc)

        return CGState(u=u, t=t + dt, it=state.it + 1, dt=dt)

    def nsteps(self, state: CGState, n: int) -> CGState:
        for _ in range(n):
            state = self.step(state)
        return state


def make_alecg(system, mesh, cfl=0.5, const_dt=None, bcnodes=None,
               dtype: torch.dtype = torch.float64, device=DEFAULT_DEVICE):
    """Geometry + edge tables + solver, as quinoa_tpu's make_alecg, in
    ``dtype`` on ``device`` (the card unless the caller asks for another)."""
    geom = make_cggeom(mesh, dtype=dtype, device=device)
    edget = build_edge_tables(mesh, dtype=dtype, device=device)
    return ALECGSolver(system, geom, edget, cfl=cfl, const_dt=const_dt,
                       bcnodes=bcnodes)
