"""Sharded DiagCG + FCT solver over the shards of a ShardGroup.

The port's counterpart of quinoa_tpu/parallel/spmd.py (which replaces the
reference's DistFCT/DiagCG per-neighbour messages comrhs/comaec/comalw/
comlim and its custom reducers).  Each shard runs the single-device
update, inciter/diagcg.py diagcg_advance_coroutine (K10 gathers, K11
assemblies), on its own padded geometry; the shards run in lockstep
(base/lockstep.py) and meet at the JAX program's collectives: the dt (a
min folded in shard order) and the combines of node partial sums (rhs +
mass diffusion, P, A) and maxima (Q, its minima negated) at shard-
boundary nodes (ShardedCG.combine: per-offset rounds, or the slot buffer
of an overdecomposed merge).  The lumped-mass lhs is the fully summed
nodal volume.  Diagnostics fold owned-node sums in shard order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base.lockstep import run_lockstep
from ..base.profiler import span
from ..fct.fct import FCT
from ..inciter.diagcg import CGState, diagcg_advance_coroutine
from ..pde.cg import cg_gather
from .shard import ShardedCG, gather_global_field


class _CGShardSolver:
    """What the sharded CG solvers share: the per-shard initial state,
    the answers to the shards' requests, ownership-masked diagnostics and
    the gathered field."""

    cg: ShardedCG

    def _answer(self, op, xs):
        if op == "min":
            return self.cg.group.pmin(xs)
        return self.cg.combine(op, xs)

    def initial_state(self, t0: float = 0.0) -> CGState:
        us, ts, its, dts = [], [], [], []
        for g in self.cg.geoms:
            us.append(self.system.initialize(g.coords, t0).to(g.dtype)
                      .contiguous())
            ts.append(torch.tensor(t0, dtype=g.dtype, device=g.device))
            its.append(torch.tensor(0, dtype=torch.int32, device=g.device))
            dts.append(torch.tensor(0.0, dtype=g.dtype, device=g.device))
        return CGState(u=us, t=ts, it=its, dt=dts)

    @staticmethod
    def shard_state(state: CGState, s: int) -> CGState:
        return CGState(u=state.u[s], t=state.t[s], it=state.it[s],
                       dt=state.dt[s])

    def step(self, state: CGState) -> CGState:
        gens = [self._step_coroutine(s, self.shard_state(state, s))
                for s in range(self.cg.nshard)]
        with span("step"):
            outs = run_lockstep(gens, self._answer)
        return CGState(**{f: [getattr(o, f) for o in outs]
                          for f in ("u", "t", "it", "dt")})

    def nsteps(self, state, n):
        for _ in range(n):
            state = self.step(state)
        return state

    def diagnostics(self, state: CGState):
        """(l2sol, l2err, linferr) numpy (C,) arrays from owned nodes,
        folded in shard order (quinoa_tpu/parallel/spmd.py:219-229)."""
        vs, s2, e2, ei = [], [], [], []
        for s, g in enumerate(self.cg.geoms):
            u = state.u[s]
            own = self.cg.owned[s]
            w = (g.vol * own)[None, :]
            vs.append((g.vol * own).sum())
            s2.append((u * u * w).sum(dim=1))
            a = self.system.analytic(g.coords, state.t[s]).to(u.dtype)
            e = (u - a) * (own[None, :] > 0)
            e2.append((e * e * w).sum(dim=1))
            ei.append(e.abs().amax(dim=1))
        grp = self.cg.group
        vol_tot = grp.psum(vs)[0]

        def host(x):
            return x.detach().cpu().numpy()

        return (host(torch.sqrt(grp.psum(s2)[0] / vol_tot)),
                host(torch.sqrt(grp.psum(e2)[0] / vol_tot)),
                host(grp.pmax(ei)[0]))

    @property
    def group(self):
        return self.cg.group

    def gather_global(self, state) -> np.ndarray:
        """The global (C, nnode) field from the owned copies."""
        return self.gather(state.u)

    def gather(self, xs) -> np.ndarray:
        """A global (C, nnode) field from per-shard (C, Nl) tensors."""
        return gather_global_field(self.cg, xs)

    def scatter(self, x_glob, like):
        """Per-shard tensors (like's dtypes and devices) of a global (C,
        nnode) numpy field; pads read node 0."""
        from .dg_spmd import scatter_global

        return scatter_global(self.shard_ids()[0], x_glob, like)

    def shard_ids(self):
        """(global node id of each local node (S, Nl), -1 pad; owned mask
        (S, Nl))."""
        a = self.cg.arrays
        return a["gids"], a["owned"] > 0


class SPMDDiagCGSolver(_CGShardSolver):
    """DiagCG + FCT over the shards of a ShardedCG, with the arguments of
    quinoa_tpu's SPMDDiagCGSolver (the device mesh is the group's)."""

    def __init__(self, system, sharded: ShardedCG, cfl: float = 0.5,
                 const_dt: Optional[float] = None, ctau: float = 1.0,
                 fct: bool = True):
        self.system = system
        self.sharded = self.cg = sharded
        self.cfl = cfl
        self.const_dt = const_dt
        self.fct = FCT(ctau=ctau)
        self.use_fct = fct
        self.overdecomp = None
        # static gathers of the Dirichlet mask and nodal volumes per shard
        self._bc_n = [cg_gather(g, m) for g, m in zip(sharded.geoms,
                                                      sharded.bcmask)]
        self._vol_n = [cg_gather(g, g.vol[None, :])[:, 0]
                       for g in sharded.geoms]

    def _step_coroutine(self, s, state: CGState):
        g = self.cg.geoms[s]
        u = state.u
        if self.const_dt is not None:
            dt = torch.tensor(self.const_dt, dtype=g.dtype, device=g.device)
        else:
            dt = yield "min", self.system.dt(g, u) * self.cfl
        # lumped mass == the fully assembled nodal volume
        unew = yield from diagcg_advance_coroutine(
            self.system, self.fct, self.use_fct, g, g.vol,
            self.cg.bcmask[s], u, state.t, dt, bc_n=self._bc_n[s],
            vol_n=self._vol_n[s])
        return CGState(u=unew, t=state.t + dt, it=state.it + 1, dt=dt)
