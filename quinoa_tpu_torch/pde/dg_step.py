"""The DG family's SSP-RK3 step, the port of the stage loops of
quinoa_tpu/inciter/dg.py and quinoa_tpu/pde/multimat.py: one loop for
DGSolver (inciter/dg.py, whose docstring sets out the stages and routes)
and MultiMatSolver, on a route chosen once, when the solver is built.
"""

from __future__ import annotations

import dataclasses

import torch

from ..base.lockstep import run_alone
from ..base.profiler import span
from .dg import (BC_DIRICHLET, DGGeom, dg_dt_from_delt, dg_initialize,
                 source_rhs, volume_term)

RK0 = (0.0, 3.0 / 4.0, 1.0 / 3.0)
RK1 = (1.0, 1.0 / 4.0, 2.0 / 3.0)


@dataclasses.dataclass
class DGState:
    u: torch.Tensor       # (C*K, E)
    ndofel: torch.Tensor  # (E,) int32 active dofs (p-adaptive)
    t: torch.Tensor
    it: torch.Tensor
    dt: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Route:
    """What a DG-family step's stages run: the limit pass, the volume term,
    the face pass and stage 0's dt (choose_route lists the values; the
    module docstrings of inciter/dg.py and pde/multimat.py describe them)."""

    limit: str
    volume: str
    face: str
    dt: str


def choose_route(system, geoms, limiter=None, pref=False,
                 const_dt=None) -> Route:
    """The route of a DGSolver, or of a MultiMatSolver (a system with
    materials), on geoms: its geometry, or a sharded solver's, whose
    shards all take the group's route (as the JAX solvers decide on the
    stacked tables).  A limiter the solver does not take raises
    ValueError, as in the JAX package; an order it does not take,
    NotImplementedError."""
    K = geoms[0].ndof
    if hasattr(system, "nmat"):
        if K not in (1, 4):
            raise ValueError("multimat supports DG(P0) and DG(P1) only")
        if limiter not in (None, "superbeep1"):
            raise ValueError(
                f"unknown multimat limiter {limiter!r} (superbeep1 only: "
                "consistent fraction limiting needs the phi factors)")
        # the face kernel has no Dirichlet ghost (it samples the solution)
        dirichlet = any(bool((g.bctype == BC_DIRICHLET).any())
                        for g in geoms)
        limit = "none" if limiter is None else "k15"
        volume = "k16" if K == 4 else "none"
        face = ("mm_dirichlet" if dirichlet
                else "k14_thinc" if system.intsharp and K == 4 else "k14")
    else:
        if limiter not in (None, "wenop1", "superbeep1"):
            raise ValueError(f"unknown limiter {limiter!r}")
        # a ghost or flux that needs the face coordinates (a system without
        # needs_face_gp does: quinoa_tpu/inciter/dg.py:99-102) and pref at
        # P0 and P2 (every dof kept) take the face Gauss-point path
        face_gp = (getattr(system, "needs_face_gp", True)
                   or any(g.has_coord_bc for g in geoms)
                   or (pref and K != 4))
        k1 = (limiter == "superbeep1" and K == 4
              and getattr(system, "coord_free_flux", False))
        limit = (("k1_pref" if pref else "k1") if k1 else
                 {None: "none", "superbeep1": "superbee_split",
                  "wenop1": "weno"}[limiter])
        volume = (("k1_source" if system.has_src else "k1") if k1
                  else volume_term(system, K, face_gp))
        # K12 + K13's flavour (fused_face_pass refuses another flux)
        face = "face_gp" if face_gp else "k12_" + {
            "laxfriedrichs": "lf"}.get(system.riemann_flux,
                                       system.riemann_flux)
    if limiter is not None and K < 4:
        raise ValueError("limiters require ndof >= 4")
    if K not in (1, 4, 10):
        raise NotImplementedError(f"ndof={K}: only DG(P0), DG(P1) and "
                                  "DG(P2) are ported")
    dt = ("const" if const_dt is not None
          else "sweep" if face in ("face_gp", "mm_dirichlet") else "charvel")
    return Route(limit, volume, face, dt)


def rk_update(s, un, u, dt, r, minv, evolved=None, dm=None, closure=None,
              owned=None):
    """Stage s's update, then the restores: rDG's rows that do not advance
    keep u's limited values (quinoa_tpu/inciter/dg.py:324-330), inactive
    p-adaptive rows (dm 0) the anchor's, multimat closes the fractions,
    and a shard's elements it does not own keep u's."""
    unew = RK0[s] * un + RK1[s] * (u + dt * r * minv)
    if evolved is not None:
        unew = torch.where(evolved, unew, u)
    if dm is not None:
        unew = torch.where(dm > 0, unew, un)
    if closure is not None:
        unew = closure(unew)
    if owned is not None:
        unew = torch.where(owned, unew, u)
    return unew


def on_route(cls, route: Route, *args, **kw):
    """A cls solver built on route, not choose_route's (a shard on its
    group's, a test on a named one), its signature still the JAX one."""
    solver = cls.__new__(cls)
    solver.route = route        # the constructor reads it
    solver.__init__(*args, **kw)
    return solver


def _same(x, *_):
    yield from ()       # a stage that requests nothing
    return x


def _halo(x):
    return (yield "halo", x)


class SSPRK3:
    """The DG family's step.  The solver's constructor calls _setup and
    binds its stages (_limit_fn, _rhs, the p-adaptive ones below) to its
    route, none holding the solver (no reference cycle to collect)."""

    route = evolved = closure = None
    _adapt = staticmethod(_same)                  # stage 0's ndofel
    _masks = staticmethod(lambda ndofel: (None, None))  # (dofmask, rows)
    _zero = staticmethod(lambda u, dm: u)         # coarsened dofs zeroed

    def _setup(self, system, geom: DGGeom, cfl, const_dt, route: Route,
               evolve_ndof, sweep):
        """sweep(u, dofmask) is the solver's face sweep.  The solver then
        sets dt_factors, the CFL factors stage 0's dt is multiplied by."""
        self.system, self.geom, self.route = system, geom, route
        self.cfl = cfl
        # CFL order scale (DG.cpp:1404-1418)
        p = {1: 0.0, 4: 1.0, 10: 2.0}[evolve_ndof]
        self.cflscale = 1.0 / (2.0 * p + 1.0)
        self.const_dt = None if const_dt is None else torch.tensor(
            const_dt, dtype=geom.dtype, device=geom.device)
        mn = torch.as_tensor(geom.tables["mnorm"], dtype=geom.dtype,
                             device=geom.device)
        inv = 1.0 / (geom.vol[None, :] * mn[:, None])   # (K, E)
        self.minv = inv.repeat(system.ncomp, 1)         # (C*K, E)
        self._limit_halo = _same if route.limit == "none" else _halo
        self._dt_sweep = sweep if route.dt == "sweep" else None
        self._dt_charvel = ((lambda delt: dg_dt_from_delt(geom, delt))
                            if route.dt == "charvel" else None)

    def _limiter(self, u, ndofel, dofmask, t):
        """(u limited, the volume term the limit pass made or None)."""
        with span("limit"):
            u, rv = self._limit_fn(u, ndofel, dofmask)
        if self.route.volume == "k1_source":
            # K1 integrates the flux only: the source term at the step's
            # start time rides on top, in torch
            with span("volume"):
                rv = rv + source_rhs(self.system, self.geom, t)
        return u, rv

    def initial_state(self, t0: float = 0.0) -> DGState:
        with span("initial_state"):
            return self._initial(t0)

    def _initial(self, t0):
        g = self.geom
        # L2 projection onto the modal basis (P0: the centroid value)
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
        with span("step"):
            return run_alone(self.step_coroutine(state))

    def nsteps(self, state: DGState, n: int) -> DGState:
        for _ in range(n):
            state = self.step(state)
        return state

    def _stage0_dt(self, dt_of, dt, *args):
        """dt_of(*args) * the CFL factors, min over shards (None: dt)."""
        if dt_of is None:
            return dt
        with span("dt"):
            dt = dt_of(*args)
            for f in self.dt_factors:
                dt = dt * f
        return (yield "min", dt)

    def step_coroutine(self, state: DGState, owned=None):
        """The step as a coroutine (base/lockstep.py): it yields ("halo",
        x) where ghost elements must take their owners' values (the
        reference's comsol and comlim exchanges: at each stage's start,
        after the limiter, and twice around the p-adaptive ring promotion)
        and ("min", dt) for the global time step.  On a shard ``owned``
        (E,) marks the elements that advance (quinoa_tpu/parallel/
        dg_spmd.py:185-331, 471-524).

        Its spans (base/profiler.py) partition each stage: pref, limit,
        volume, face_pass, nonconservative (multimat P0), dt and rk_update,
        each closed before the next yield; pref holds pref.eval,
        pref.propagate and pref.mask, the split Superbee's limit
        limit.bounds (K4) and limit.superbee."""
        u = un = state.u
        ndofel, t = state.ndofel, state.t
        for s in range(3):
            u = yield "halo", u
            if s == 0:
                ndofel = yield from self._adapt(ndofel, u)
            dofmask, dm = self._masks(ndofel)
            u, rv = self._limiter(u, ndofel, dofmask, t)
            # a ghost limited with an incomplete neighbour set takes its
            # owner's limited values
            u = yield from self._limit_halo(u)
            if s == 0:
                un = u = self._zero(u, dm)
                dt = yield from self._stage0_dt(self._dt_sweep, self.const_dt,
                                                u, dofmask)
            r, delt = self._rhs(s, u, dofmask, dm, rv, t)
            if s == 0:
                dt = yield from self._stage0_dt(self._dt_charvel, dt, delt)
            with span("rk_update"):
                u = rk_update(s, un, u, dt, r, self.minv, self.evolved, dm,
                              self.closure, owned)
        return DGState(u=u, ndofel=ndofel, t=t + dt, it=state.it + 1, dt=dt)
