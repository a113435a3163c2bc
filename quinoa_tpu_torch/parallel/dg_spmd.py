"""Sharded DG solvers: RK3 with limiting and the ghost exchange over the
shards of a ShardGroup.

The port's counterpart of quinoa_tpu/parallel/dg_spmd.py (which replaces
the reference DG chare's per-stage comsol/comlim ghost messages,
src/Inciter/DG.cpp:1010-1086).  Each shard runs the single-device
solver's step (pde/dg_step.py SSPRK3.step_coroutine, of DGSolver or
MultiMatSolver) on its own geometry and the group's one route, so each
shard launches the kernels of the single-device path: K1 (or K4), K12 and K13,
the face Gauss-point route's K5 and K6, K14 for multimat.  The shards run
in lockstep (base/lockstep.py) and meet where the JAX program has a
collective: the ghost refresh at each stage's start and after the
limiter (ShardedDG.exchange), the p-adaptive decisions exchanged around
the ring promotion, and the global dt (a min folded in shard order).
Only owned elements advance; ghosts take their owners' values at the
next exchange.  The diagnostics fold each shard's owned-element sums in
shard order.  Unlike the JAX package this has no fallback path: a kernel
that fails to build or launch raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base.lockstep import run_lockstep
from ..base.profiler import count, span
from ..inciter.dg import DGDiagnostics, DGSolver
from ..pde.dg_step import DGState, choose_route, on_route
from ..pde.multimat import MultiMatSolver
from .dg_shard import ShardedDG


class SPMDDGSolver:
    """DG(P0/P1/P2) over the shards of a ShardedDG, with the arguments of
    quinoa_tpu's SPMDDGSolver (the device mesh is the ShardedDG's group).
    A state holds one tensor per shard in each field, the scalars t, it
    and dt too (the JAX package's (S,) arrays)."""

    def __init__(
        self,
        system,
        sharded: ShardedDG,
        cfl: float = 0.5,
        const_dt: Optional[float] = None,
        limiter: Optional[str] = None,
        cweight: float = 30.0,
        evolve_ndof: Optional[int] = None,
        pref: bool = False,
        tolref: float = 0.1,
    ):
        self.system = system
        self.sharded = sharded
        self.group = sharded.group
        self.pref = pref                # the command's load balancer reads it
        self.overdecomp = None
        # one route for every shard, from the group's faces
        route = choose_route(system, sharded.geoms, limiter, pref, const_dt)
        self.shards = [self._shard_solver(
            g, route, cfl=cfl, const_dt=const_dt, limiter=limiter,
            cweight=cweight, evolve_ndof=evolve_ndof, pref=pref,
            tolref=tolref) for g in sharded.geoms]
        self._diag = [DGDiagnostics(system, g) for g in sharded.geoms]

    def _shard_solver(self, geom, route, **kw):
        return on_route(DGSolver, route, self.system, geom, **kw)

    # -- collectives ----------------------------------------------------------

    def _answer(self, op, xs):
        if op == "halo":
            return self.sharded.exchange(xs)
        if op == "min":
            return self.group.pmin(xs)
        raise ValueError(f"unknown request {op!r}")

    # -- public API -----------------------------------------------------------

    @property
    def ndof(self) -> int:
        return self.sharded.ndof

    def initial_state(self, t0: float = 0.0) -> DGState:
        with span("initial_state"):
            sts = [sv._initial(t0) for sv in self.shards]
            return DGState(**{f: [getattr(st, f) for st in sts]
                              for f in ("u", "ndofel", "t", "it", "dt")})

    def shard_state(self, state: DGState, s: int) -> DGState:
        return DGState(u=state.u[s], ndofel=state.ndofel[s], t=state.t[s],
                       it=state.it[s], dt=state.dt[s])

    def step(self, state: DGState) -> DGState:
        gens = [sv.step_coroutine(self.shard_state(state, s),
                                  owned=self.sharded.owned[s])
                for s, sv in enumerate(self.shards)]
        with span("step"):
            outs = run_lockstep(gens, self._answer)
        return DGState(**{f: [getattr(o, f) for o in outs]
                          for f in ("u", "ndofel", "t", "it", "dt")})

    def nsteps(self, state, n):
        for _ in range(n):
            state = self.step(state)
        return state

    def diagnostics(self, state: DGState):
        """(l2sol, l2err, linferr) numpy (C,) arrays: each shard's
        owned-element sums folded in shard order."""
        parts = [d.sums(self.shard_state(state, s))
                 for s, d in enumerate(self._diag)]
        vol = [(g.vol * g.emask).sum() for g in self.sharded.geoms]
        g = self.group
        vol_tot = g.psum(vol)[0]
        s2 = g.psum([p[0] for p in parts])[0]
        e2 = g.psum([p[1] for p in parts])[0]
        einf = g.pmax([p[2] for p in parts])[0]

        def host(x):
            count("host_syncs")
            return x.detach().cpu().numpy()

        return (host(torch.sqrt(s2 / vol_tot)),
                host(torch.sqrt(e2 / vol_tot)), host(einf))

    def gather_global(self, state) -> np.ndarray:
        """The global (C*K, E) modal field from the owned copies."""
        return self.gather(state.u)

    def gather(self, xs) -> np.ndarray:
        """A global (R, E) field from per-shard (R, El) tensors' owned
        columns."""
        return gather_owned(self.sharded, xs)

    def gather_ndofel(self, state) -> np.ndarray:
        """The global (E,) active-dof counts from the owned copies."""
        return self.gather([n[None] for n in state.ndofel])[0].astype(
            np.int32)

    def scatter(self, x_glob, like):
        """Per-shard tensors (like's dtypes and devices) of a global (R,
        E) numpy field: ghosts take their owners' values, pads element
        0's."""
        return scatter_global(self.shard_ids()[0], x_glob, like)

    def shard_ids(self):
        """(global element id of each local element (S, El), -1 pad;
        owned mask (S, El))."""
        a = self.sharded.arrays
        return a["eglobal"], a["owned"] > 0


def scatter_global(ids, x_glob, like):
    """Per-shard tensors of a global (R, n) numpy field through the local
    -> global id table ids (S, nl), -1 pads reading entry 0."""
    ids = np.maximum(ids, 0)
    return [torch.from_numpy(np.ascontiguousarray(x_glob[:, ids[s]])).to(
        device=x.device, dtype=x.dtype) for s, x in enumerate(like)]


def gather_owned(sharded: ShardedDG, xs) -> np.ndarray:
    """A global (R, E) field from per-shard (R, El) tensors' owned
    columns."""
    eg = sharded.arrays["eglobal"]
    owned = sharded.arrays["owned"] > 0
    x0 = xs[0].detach().cpu().numpy()
    out = np.zeros((x0.shape[0], sharded.nelem_global), dtype=x0.dtype)
    for s in range(sharded.nshard):
        m = owned[s]
        out[:, eg[s][m]] = xs[s].detach().cpu().numpy()[:, m]
    return out


class SPMDMultiMatSolver(SPMDDGSolver):
    """Multi-material DG(P0/P1) over the shards: the DG ghost exchange
    with the multimat step (pde/multimat.py), the counterpart of
    quinoa_tpu's SPMDMultiMatSolver.  P1 adds consistent material-
    fraction Superbee limiting and the alpha closure after every stage."""

    def __init__(self, system, sharded: ShardedDG, cfl: float = 0.5,
                 const_dt=None, limiter=None):
        super().__init__(system, sharded, cfl=cfl, const_dt=const_dt,
                         limiter=limiter)

    def _shard_solver(self, geom, route, cfl, const_dt, limiter, **_):
        return on_route(MultiMatSolver, route, self.system, geom, cfl,
                        const_dt, limiter)
