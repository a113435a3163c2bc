"""Sharded ALECG solver: RK3 node-centred scheme over the shards.

The port's counterpart of quinoa_tpu/parallel/alecg_spmd.py (the
node-centred analog of the reference's ALECG chare array, src/Inciter/
ALECG.cpp:48-614: comrhs per-neighbour sends + lhsmerge).  Each shard
computes the stage rhs of the single-device solver, ops/alecg_fused.py
alecg_rhs (K7 volume, K8 edges, K9 assembly), on its own padded tables;
the per-shard partial sums are combined at shard-boundary nodes once a
stage (ShardedCG.combine), dt is a min folded in shard order, and the
lumped mass is the fully summed nodal volume.  Edge coefficients A_ab are
per-shard partial sums (each element gives J/120 to its six edges on one
shard), so the combine reproduces the global operator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..inciter.alecg import RK0, RK1, EdgeTables, edge_arrays_np
from ..inciter.diagcg import CGState
from ..ops.alecg_fused import alecg_rhs, build_alecg_rows
from . import ShardGroup
from .partition import partition_for
from .shard import ShardedCG, cg_shard_tables, sharded_cg_from_tables
from .spmd import _CGShardSolver


@dataclasses.dataclass
class ShardedALECG:
    """A ShardedCG plus per-shard edge tables.

    edget  : S EdgeTables (edges (2, EE) local endpoints, 0 for padding;
             A (EE,) partial dual-face area scale, 0 pad; ensup (De, Nl)
             edge-slot table, pad slots 2*EE; xyz (2, 3, EE) endpoint
             coordinates)
    arrays : the JAX package's stacked edge tables {edgesT, eA, ensup,
             exyz} ((S, ...) numpy; no exyz for an overdecomposed merge)
    """

    cg: ShardedCG
    edget: Tuple[EdgeTables, ...]
    arrays: Dict[str, np.ndarray]


def alecg_edge_tables(coords, inpoel, elems, nodes, Nmax):
    """The JAX build_alecg_shards' stacked edge tables (numpy) for the
    given per-shard element and node sets."""
    per = []
    for s in range(len(elems)):
        g2l = np.full(len(coords), -1, dtype=np.int64)
        g2l[nodes[s]] = np.arange(len(nodes[s]))
        loc_inpoel = g2l[inpoel[elems[s]]]
        edges, A, ensup, D = edge_arrays_np(
            coords[nodes[s]], loc_inpoel, len(nodes[s]))
        per.append((edges, A, ensup, len(nodes[s])))

    EE = max(len(p[0]) for p in per)
    De = max(p[2].shape[0] for p in per)
    S = len(elems)
    s_edges = np.zeros((S, 2, EE), dtype=np.int32)
    s_A = np.zeros((S, EE))
    s_xyz = np.zeros((S, 2, 3, EE))
    s_ensup = np.full((S, De, Nmax), 2 * EE, dtype=np.int32)
    for s, (edges, A, ensup, nn) in enumerate(per):
        ne = len(edges)
        s_edges[s, :, :ne] = edges.T
        s_A[s, :ne] = A
        sc = coords[nodes[s]]
        s_xyz[s, 0, :, :ne] = sc[edges[:, 0]].T
        s_xyz[s, 1, :, :ne] = sc[edges[:, 1]].T
        # remap slot ids a*ne + e into the padded slot space a*EE + e
        a_idx = ensup // ne if ne else ensup
        e_idx = ensup % ne if ne else ensup
        valid = ensup < 2 * ne
        s_ensup[s, : ensup.shape[0], :nn] = np.where(
            valid, a_idx * EE + e_idx, 2 * EE)
    return dict(edgesT=s_edges, eA=s_A, ensup=s_ensup, exyz=s_xyz)


def sharded_alecg_from_tables(cg: ShardedCG, et, dtype) -> ShardedALECG:
    """Per-shard EdgeTables on the group's devices; without exyz (an
    overdecomposed merge) the endpoint coordinates are gathered from the
    shard's node coordinates."""
    tabs = []
    for s, g in enumerate(cg.geoms):
        dev = g.device
        edges = torch.from_numpy(np.ascontiguousarray(et["edgesT"][s],
                                                      np.int32)).to(dev)
        if et.get("exyz") is not None:
            xyz = torch.from_numpy(et["exyz"][s]).to(dtype).to(dev)
        else:
            xyz = torch.stack([g.coords[:, edges[0].long()],
                               g.coords[:, edges[1].long()]])
        tabs.append(EdgeTables(
            edges=edges,
            A=torch.from_numpy(et["eA"][s]).to(dtype).to(dev),
            ensup=torch.from_numpy(np.ascontiguousarray(et["ensup"][s],
                                                        np.int32)).to(dev),
            xyz=xyz.contiguous()))
    return ShardedALECG(cg=cg, edget=tuple(tabs), arrays=et)


def build_alecg_shards(
    mesh,
    nshard: int,
    ncomp: int,
    bcnodes: Optional[np.ndarray] = None,
    algorithm: str = "sfc",
    dtype: Optional[torch.dtype] = None,
    hierarchy=None,
    group: Optional[ShardGroup] = None,
) -> ShardedALECG:
    """CG shards plus per-shard edge tables on the group's devices."""
    if dtype is None:
        dtype = torch.get_default_dtype()
    if group is None:
        group = ShardGroup(nshard)
    epart = partition_for(mesh.coords, mesh.inpoel, nshard, algorithm,
                          hierarchy=hierarchy)
    t, nhalo, nb, elems, nodes = cg_shard_tables(
        mesh, nshard, ncomp, bcnodes, algorithm, epart=epart)
    cg = sharded_cg_from_tables(t, nhalo, nb, mesh.nnode, mesh.nelem,
                                group, dtype)
    et = alecg_edge_tables(mesh.coords, mesh.inpoel, elems, nodes,
                           t["vol"].shape[1])
    return sharded_alecg_from_tables(cg, et, dtype)


class SPMDALECGSolver(_CGShardSolver):
    """ALECG (RK3 + edge Rusanov) over the shards of a ShardedALECG, with
    the arguments of quinoa_tpu's SPMDALECGSolver."""

    def __init__(self, system, sharded: ShardedALECG, cfl: float = 0.5,
                 const_dt: Optional[float] = None):
        self.system = system
        self.sharded = sharded
        self.cg = sharded.cg
        self.cfl = cfl
        self.const_dt = const_dt
        self.overdecomp = None
        self.rows = [build_alecg_rows(system, g, e)
                     for g, e in zip(self.cg.geoms, sharded.edget)]
        self.manufactured = getattr(system.problem, "manufactured", False)

    def _step_coroutine(self, s, state: CGState):
        g, edget = self.cg.geoms[s], self.sharded.edget[s]
        system = self.system
        u = state.u
        if self.const_dt is not None:
            dt = torch.tensor(self.const_dt, dtype=g.dtype, device=g.device)
        else:
            dt = yield "min", system.dt(g, u) * self.cfl / 3.0
        un = u
        t = state.t
        ts = (t, t + dt, t + 0.5 * dt)
        to = (t + dt, t + 0.5 * dt, t + dt)
        bc = self.cg.bcmask[s] > 0
        for st in range(3):
            r = yield "sum", alecg_rhs(system, g, edget, self.rows[s], u)
            if self.manufactured:
                # the nodal source is a complete nodal value: added after
                # the combine
                r = r + g.vol[None, :] * system.problem.src(
                    g.coords, ts[st]).to(u.dtype)
            # lumped mass == fully summed nodal volume (ALECG lhsmerge)
            u = RK0[st] * un + RK1[st] * (u + dt * r / g.vol[None, :])
            ubc = system.analytic(g.coords, to[st]).to(u.dtype)
            u = torch.where(bc, ubc, u)
        return CGState(u=u, t=t + dt, it=state.it + 1, dt=dt)
