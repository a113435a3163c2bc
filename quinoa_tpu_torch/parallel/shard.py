"""CG shards: padded per-shard tables and the boundary-node halo.

The port's own copy of quinoa_tpu/parallel/shard.py (the counterpart of
the reference's Partitioner distribute/categorize, Sorter and the
Discretization comm maps, src/Inciter/Partitioner.cpp:344-542,
Sorter.cpp:89-437, Discretization.hpp:31-361).  Once per (re)partition
the host builds, in numpy and in the JAX package's order,

- per-shard local meshes (the shard's elements and the nodes they touch),
  padded to the largest shard's counts (feature-major: long axes last);
- the boundary-node slots: every node on two or more shards gets one;
  ``bnd_slot`` maps a local node to its slot (or the trash slot nb) and
  ``rev_slot`` a slot to its local node (or the trash column Nl);
- the per-offset boundary-node exchange tables (NodeHalo, the msum and
  comrhs analog);
- node ownership by the lowest sharing shard (NodeDiagnostics.cpp:75-85).

A shard's tables are the JAX package's stacked tables' row s
(``ShardedCG.arrays``).  The combines of node partial sums and extremes
(``ShardedCG.combine``) follow NodeHalo offset by offset, or, for a
merged overdecomposed shard (several local copies of one node), fold the
copies and then the shards through the slot buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..mesh.geometry import nodal_volumes, tet_geometry
from ..ops.assembly import build_nsup
from ..pde.cg import CGGeom, GEOM_TENSOR_FIELDS, coords_cache_np
from . import ShardGroup
from .partition import partition_for


@dataclasses.dataclass(frozen=True)
class NodeHalo:
    """Per-neighbour exchange tables (numpy; quinoa_tpu's NodeHalo): one
    round per occurring shard-id offset.

    send[k] : (S, L_k) i32 local ids that shard s sends to shard
              s + offsets[k] (pad: the padded local count)
    rpos[k] : (S, Nl) i32 each local id's position in the slab received
              from shard s - offsets[k], or L_k where none
    """

    send: Tuple
    rpos: Tuple
    offsets: Tuple
    Ls: Tuple


def halo_routes(halo: NodeHalo, S: int):
    """Per receiving shard, [(sender, src ids, dst ids)] in offset order:
    the entries of the slab from sender that land on the receiver's local
    ids dst (numpy int64)."""
    routes: List[list] = [[] for _ in range(S)]
    for d, send, rpos, L in zip(halo.offsets, halo.send, halo.rpos,
                                halo.Ls):
        for r in range(S):
            s = r - d
            if not 0 <= s < S:
                continue
            dst = np.nonzero(rpos[r] < L)[0]
            if len(dst):
                src = send[s][rpos[r][dst]].astype(np.int64)
                routes[r].append((s, src, dst))
    return routes


def build_node_halo(nodes, nnode: int, Nl: int) -> Optional[NodeHalo]:
    """Neighbour-exchange tables from per-shard global-node-id lists.

    nodes[s] is the sorted array of global node ids on shard s; Nl the
    padded local node count.  Returns None for a single shard.
    """
    S = len(nodes)
    if S < 2:
        return None
    g2l = []
    for s in range(S):
        m = np.full(nnode, -1, dtype=np.int64)
        m[nodes[s]] = np.arange(len(nodes[s]))
        g2l.append(m)

    # shared node ids per ordered pair (sender s -> receiver s+d)
    shared: Dict[Tuple[int, int], np.ndarray] = {}
    sets = [np.zeros(nnode, dtype=bool) for s in range(S)]
    for s in range(S):
        sets[s][nodes[s]] = True
    for s1 in range(S):
        for s2 in range(s1 + 1, S):
            common = np.nonzero(sets[s1] & sets[s2])[0]  # sorted gids
            if len(common):
                shared[(s1, s2)] = common
                shared[(s2, s1)] = common

    offsets = sorted({s2 - s1 for (s1, s2) in shared})
    send, rpos, Ls = [], [], []
    for d in offsets:
        L = max(
            (len(v) for (s1, s2), v in shared.items() if s2 - s1 == d),
            default=0,
        )
        sd = np.full((S, L), Nl, dtype=np.int32)
        rp = np.full((S, Nl), L, dtype=np.int32)
        for s in range(S):
            # sender side: s -> s+d
            v = shared.get((s, s + d))
            if v is not None:
                sd[s, : len(v)] = g2l[s][v]
            # receiver side: s-d -> s
            v = shared.get((s - d, s))
            if v is not None:
                rp[s, g2l[s][v]] = np.arange(len(v))
        send.append(sd)
        rpos.append(rp)
        Ls.append(L)
    return NodeHalo(
        send=tuple(send), rpos=tuple(rpos),
        offsets=tuple(int(d) for d in offsets), Ls=tuple(Ls),
    )


def cg_shard_tables(mesh, nshard: int, ncomp: int, bcnodes=None,
                    algorithm: str = "sfc", epart=None, hierarchy=None):
    """The JAX build_cg_shards' stacked tables as float64/int32 numpy
    arrays ({name: (S, ...)}: the CGGeom fields and bnd_slot, rev_slot,
    owned, bcmask, gids), plus (nhalo, nb, elems, nodes)."""
    coords, inpoel = mesh.coords, mesh.inpoel
    nnode = mesh.nnode

    Jg, gradg = tet_geometry(coords, inpoel)
    if not (Jg > 0).all():
        raise ValueError("mesh has non-positive element Jacobians")
    volg = nodal_volumes(coords, inpoel, nnode)

    if epart is None:
        epart = partition_for(coords, inpoel, nshard, algorithm,
                              hierarchy=hierarchy)
    elems = [np.nonzero(epart == s)[0] for s in range(nshard)]
    nodes = [np.unique(inpoel[e].ravel()) for e in elems]

    counts = np.zeros(nnode, dtype=np.int32)
    owner = np.full(nnode, nshard, dtype=np.int32)
    for s in range(nshard - 1, -1, -1):
        counts[nodes[s]] += 1
        owner[nodes[s]] = s
    bnd_gids = np.nonzero(counts >= 2)[0]
    nb = len(bnd_gids)
    slot_of = np.full(nnode, nb, dtype=np.int64)
    slot_of[bnd_gids] = np.arange(nb)

    Emax = max(len(e) for e in elems)
    Nmax = max(len(n) for n in nodes)

    bcset = np.zeros(nnode, dtype=bool)
    if bcnodes is not None and len(bcnodes) > 0:
        bcset[np.asarray(bcnodes, dtype=np.int64)] = True

    # per-shard nsup with a common D
    nsups, Ds = [], []
    for s in range(nshard):
        g2l = np.full(nnode, -1, dtype=np.int64)
        g2l[nodes[s]] = np.arange(len(nodes[s]))
        loc_inpoel = g2l[inpoel[elems[s]]]
        ns, D = build_nsup(loc_inpoel.astype(np.int32), len(nodes[s]))
        nsups.append((ns, loc_inpoel))
        Ds.append(D)
    Dmax = max(Ds) if Ds else 0

    S = nshard
    t = dict(
        coords=np.zeros((S, 3, Nmax)),
        inpoelT=np.zeros((S, 4, Emax), dtype=np.int32),
        J=np.ones((S, Emax)),
        grad=np.zeros((S, 4, 3, Emax)),
        vol=np.ones((S, Nmax)),
        emask=np.zeros((S, Emax)),
        nsup=np.full((S, Dmax, Nmax), 4 * Emax, dtype=np.int32),
        bnd_slot=np.full((S, Nmax), nb, dtype=np.int32),
        rev_slot=np.full((S, nb + 1), Nmax, dtype=np.int32),
        owned=np.zeros((S, Nmax)),
        bcmask=np.zeros((S, ncomp, Nmax)),
        gids=np.full((S, Nmax), -1, dtype=np.int32),
    )
    for s in range(S):
        e, n = elems[s], nodes[s]
        ne, nn = len(e), len(n)
        ns, loc_inpoel = nsups[s]
        t["coords"][s, :, :nn] = coords[n].T
        t["inpoelT"][s, :, :ne] = loc_inpoel.T
        t["J"][s, :ne] = Jg[e]
        t["grad"][s, :, :, :ne] = np.transpose(gradg[e], (1, 2, 0))
        t["vol"][s, :nn] = volg[n]
        t["emask"][s, :ne] = 1.0
        # remap this shard's nsup slot ids (a*ne + e) into the padded
        # slot space (a*Emax + e); pad slots point at 4*Emax
        a_idx = ns // ne if ne else ns
        e_idx = ns % ne if ne else ns
        valid = ns < 4 * ne
        t["nsup"][s, : ns.shape[0], :nn] = np.where(
            valid, a_idx * Emax + e_idx, 4 * Emax)
        t["bnd_slot"][s, :nn] = slot_of[n]
        on_bnd = slot_of[n] < nb
        t["rev_slot"][s, slot_of[n][on_bnd]] = np.nonzero(on_bnd)[0]
        t["owned"][s, :nn] = (owner[n] == s).astype(np.float64)
        t["bcmask"][s, :, :nn] = bcset[n][None, :].astype(np.float64)
        t["gids"][s, :nn] = n
        if nn < Nmax:
            t["coords"][s, :, nn:] = coords[n[0], :, None] if nn else 0.0

    cn = np.zeros((S, 4, 3, Emax))
    ctr = np.zeros((S, 3, Emax))
    for s in range(S):
        cn[s], ctr[s] = coords_cache_np(t["coords"][s], t["inpoelT"][s])
    t["coords_n"], t["ctr"] = cn, ctr
    return t, build_node_halo(nodes, nnode, Nmax), nb, elems, nodes


_CG_INT = ("inpoelT", "nsup", "bnd_slot", "rev_slot", "gids")


def _tensor(a, dev, dtype, integer):
    if integer:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)
                                ).to(dev)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)
                            ).to(dtype).to(dev)


@dataclasses.dataclass
class ShardedCG:
    """Per-shard CG tables and geometries.

    geoms   : S CGGeom, shard s on group.devices[s]
    bcmask  : S (C, Nl) tensors, 1.0 at Dirichlet nodes
    owned   : S (Nl,) tensors, 1.0 where the shard owns the node
    arrays  : the JAX package's stacked tables {name: (S, ...) numpy}
    nhalo   : per-offset exchange tables, or None: then the combines go
              through the boundary slots (rev_slot (nb+1,) or, merged
              overdecomposed shards, (m, nb+1) with m local copies)
    """

    geoms: Tuple[CGGeom, ...]
    bcmask: Tuple[torch.Tensor, ...]
    owned: Tuple[torch.Tensor, ...]
    arrays: Dict[str, np.ndarray]
    nhalo: Optional[NodeHalo]
    group: ShardGroup
    nb: int
    nnode_global: int
    nelem_global: int

    @property
    def nshard(self) -> int:
        return self.group.nshard

    def __post_init__(self):
        S, devs = self.group.nshard, self.group.devices
        self._routes = None
        if self.nhalo is not None:
            self._routes = [
                [(s, torch.from_numpy(src).to(devs[s]),
                  torch.from_numpy(dst).to(devs[r])) for s, src, dst in rr]
                for r, rr in enumerate(halo_routes(self.nhalo, S))]
        t = self.arrays
        self._rev = [torch.from_numpy(t["rev_slot"][s].astype(np.int64)
                                      ).to(devs[s]) for s in range(S)]
        self._slot = [torch.from_numpy(t["bnd_slot"][s].astype(np.int64)
                                       ).to(devs[s]) for s in range(S)]
        self._is_bnd = [torch.from_numpy(t["bnd_slot"][s] < self.nb
                                         ).to(devs[s]) for s in range(S)]

    def combine(self, op: str, xs):
        """Combine per-shard (C, Nl) partials at shard-boundary nodes:
        op "sum", "max" or "min"."""
        if self._routes is not None:
            return self._combine_halo(op, xs)
        return self._combine_slots(op, xs)

    def _combine_halo(self, op, xs):
        """quinoa_tpu's PpermuteHalo: one round per offset, the received
        entries folded into the receiver's nodes in offset order."""
        out = []
        for r, rr in enumerate(self._routes):
            y = xs[r]
            for s, src, dst in rr:
                rec = xs[s].index_select(1, src).to(y.device)
                if op == "sum":
                    y = y.index_add(1, dst, rec)
                else:
                    f = torch.maximum if op == "max" else torch.minimum
                    y = y.index_copy(1, dst, f(y.index_select(1, dst), rec))
            out.append(y)
        return out

    def _combine_slots(self, op, xs):
        """quinoa_tpu's HaloCombiner: each shard gathers its boundary
        nodes into the slot buffer (folding its local copies), the
        buffers fold over the shards, and each boundary node reads its
        slot back."""
        if self.nb == 0:
            return list(xs)
        x0 = xs[0]
        fill = {"sum": 0.0, "max": torch.finfo(x0.dtype).min,
                "min": torch.finfo(x0.dtype).max}[op]
        bufs = []
        for s, x in enumerate(xs):
            xp = torch.cat([x, x.new_full((x.shape[0], 1), fill)], dim=1)
            rev = self._rev[s]
            buf = xp[:, rev.reshape(-1)].reshape((x.shape[0],)
                                                 + tuple(rev.shape))
            if rev.dim() == 2:
                buf = {"sum": lambda b: b.sum(dim=1),
                       "max": lambda b: b.amax(dim=1),
                       "min": lambda b: b.amin(dim=1)}[op](buf)
            bufs.append(buf)
        red = {"sum": self.group.psum, "max": self.group.pmax,
               "min": self.group.pmin}[op](bufs)
        return [torch.where(self._is_bnd[s], red[s][:, self._slot[s]], x)
                for s, x in enumerate(xs)]


def sharded_cg_from_tables(t, nhalo, nb, nnode_global, nelem_global,
                           group: ShardGroup, dtype) -> ShardedCG:
    """Per-shard CGGeoms and masks on the group's devices."""
    S = t["owned"].shape[0]
    geoms, bcm, owned = [], [], []
    for s in range(S):
        dev = group.devices[s]
        f = {k: _tensor(t[k][s], dev, dtype, k in _CG_INT)
             for k in GEOM_TENSOR_FIELDS}
        geoms.append(CGGeom(**f, nnode=int(t["vol"].shape[1])))
        bcm.append(_tensor(t["bcmask"][s], dev, dtype, False))
        owned.append(_tensor(t["owned"][s], dev, dtype, False))
    return ShardedCG(geoms=tuple(geoms), bcmask=tuple(bcm),
                     owned=tuple(owned), arrays=t, nhalo=nhalo, group=group,
                     nb=int(nb), nnode_global=int(nnode_global),
                     nelem_global=int(nelem_global))


def build_cg_shards(
    mesh,
    nshard: int,
    ncomp: int,
    bcnodes: Optional[np.ndarray] = None,
    algorithm: str = "sfc",
    dtype: Optional[torch.dtype] = None,
    epart: Optional[np.ndarray] = None,
    hierarchy=None,
    group: Optional[ShardGroup] = None,
) -> ShardedCG:
    """Partition a host mesh and build the padded per-shard tables on the
    group's devices (default: a ShardGroup on the card).  epart (nelem,)
    overrides the partitioner with a precomputed element->shard
    assignment."""
    if dtype is None:
        dtype = torch.get_default_dtype()
    if group is None:
        group = ShardGroup(nshard)
    if group.nshard != nshard:
        raise ValueError("shard group size != shard count")
    t, nhalo, nb, _, _ = cg_shard_tables(mesh, nshard, ncomp, bcnodes,
                                         algorithm, epart, hierarchy)
    return sharded_cg_from_tables(t, nhalo, nb, mesh.nnode, mesh.nelem,
                                  group, dtype)


def gather_global_field(sharded: ShardedCG, us) -> np.ndarray:
    """The global (C, nnode_global) field from per-shard (C, Nl) tensors:
    owned nodes contribute their values."""
    gids = sharded.arrays["gids"]
    owned = sharded.arrays["owned"] > 0
    u0 = us[0].detach().cpu().numpy()
    out = np.zeros((u0.shape[0], sharded.nnode_global), dtype=u0.dtype)
    for s in range(sharded.nshard):
        u = us[s].detach().cpu().numpy()
        m = owned[s]
        out[:, gids[s][m]] = u[:, m]
    return out
