"""DG shards: the ghost-element layer and its exchange tables.

The port's own copy of quinoa_tpu/parallel/dg_shard.py (the counterpart of
the reference DG chare's ghost machinery, src/Inciter/DG.cpp:135-226
resizeComm and 469-714 setupGhost/comGhost).  Once per (re)partition the
host builds, in numpy and in the JAX package's order,

- per-shard local element sets: the owned elements, then the one-deep
  layer of face neighbours owned elsewhere (the ghosts), with every face
  incident on an owned element;
- the interface slots (every element that is a ghost somewhere) and the
  per-offset ghost exchange tables (``ghalo``, the comsol analog);
- faces-of-element tables for owned elements only, padded elements and
  faces (pad faces keep a unit normal, so a Riemann solver stays finite
  on them).

Every shard is padded to the largest shard's element and face counts,
so a shard's tables are the JAX package's stacked tables' row s
(``ShardedDG.arrays``).  The per-shard DGGeom the solvers run on is that
row on the shard's device, with one change: a fose slot of a ghost or
padded element, which the JAX package points one past the last face (a
gather that XLA clamps), points at the last face, so no gather or kernel
reads past the face axis.  Only owned elements' rows are kept.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..mesh.derived import gen_esuel
from ..pde.dg import DGGeom, build_dggeom
from . import ShardGroup
from .partition import partition_for
from .shard import NodeHalo, halo_routes


def _build_ghost_halo(owned_l, ghosts_l, local_l, E, El, nshard):
    """Per-neighbour ghost-element exchange tables (NodeHalo layout, but
    asymmetric: the owner sends, the ghost holder receives; the comsol
    analog, src/Inciter/DG.cpp:1019-1036).  Slabs are ordered by global
    element id on both sides."""
    if nshard < 2:
        return None
    owner = np.empty(E, dtype=np.int64)
    for s in range(nshard):
        owner[owned_l[s]] = s
    g2l = []
    for s in range(nshard):
        m = np.full(E, -1, dtype=np.int64)
        m[local_l[s]] = np.arange(len(local_l[s]))
        g2l.append(m)

    shared = {}
    for holder in range(nshard):
        gh = ghosts_l[holder]  # sorted global ids (np.unique)
        if not len(gh):
            continue
        for s in np.unique(owner[gh]):
            shared[(int(s), holder)] = gh[owner[gh] == s]

    offsets = sorted({h - s for (s, h) in shared})
    send, rpos, Ls = [], [], []
    for d in offsets:
        L = max(
            (len(v) for (s, h), v in shared.items() if h - s == d),
            default=0,
        )
        sd = np.full((nshard, L), El, dtype=np.int32)
        rp = np.full((nshard, El), L, dtype=np.int32)
        for s in range(nshard):
            v = shared.get((s, s + d))
            if v is not None:
                sd[s, : len(v)] = g2l[s][v]
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


def _owned_fose(lel, ler, bct, El, nown, pad):
    """fose (4, El) and fsideR (4, El) for the owned elements (local ids
    below nown): each owned element's faces in face order, where it is
    the right side of interior faces only; the other slots hold pad
    (quinoa_tpu/parallel/dg_shard.py:250-267)."""
    fose = np.full((4, El), pad, dtype=np.int32)
    fsideR = np.zeros((4, El))
    left = np.nonzero(lel < nown)[0]
    right = np.nonzero((ler < nown) & (ler != lel) & (bct == 0))[0]
    elem = np.concatenate([lel[left], ler[right]])
    face = np.concatenate([left, right])
    side = np.concatenate([np.zeros(len(left)), np.ones(len(right))])
    order = np.lexsort((face, elem))
    elem, face, side = elem[order], face[order], side[order]
    counts = np.bincount(elem, minlength=nown)
    if not (counts[:nown] == 4).all():
        raise AssertionError("owned element missing face slots")
    slot = np.arange(len(elem)) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    fose[slot, elem] = face
    fsideR[slot, elem] = side
    return fose, fsideR


def dg_shard_tables(mesh, nshard: int, ndof: int,
                    bc_sidesets: Optional[Dict[int, int]] = None,
                    algorithm: str = "sfc", hierarchy=None,
                    epart: Optional[np.ndarray] = None):
    """The JAX build_dg_shards' stacked tables as float64/int32 numpy
    arrays, {name: (S, ...) array} with the DGGeom field names and
    owned, gslot, grev, eglobal; plus (ghalo, nslots, tables)."""
    g = build_dggeom(mesh, ndof, bc_sidesets, dtype=torch.float64,
                     device="cpu")
    gnp = {k: getattr(g, k).numpy()
           for k in ("vol", "jacInv", "Jmat", "node0", "el", "er", "fn",
                     "farea", "xi_l", "xi_r", "bctype", "fmask")}
    E = mesh.nelem
    esuel = gen_esuel(mesh.inpoel, mesh.nnode)  # (E,4)

    if epart is None:
        epart = partition_for(mesh.coords, mesh.inpoel, nshard, algorithm,
                              hierarchy=hierarchy)
    else:
        # explicit partition (dynamic load balancing rebuilds with a
        # weighted split; the Charm++ migration analog)
        epart = np.asarray(epart, dtype=np.int32)
        if epart.shape != (E,):
            raise ValueError("epart must be (nelem,)")

    owned_l, local_l, ghosts_l = [], [], []
    for s in range(nshard):
        own = np.nonzero(epart == s)[0]
        nbr = esuel[own].ravel()
        nbr = np.unique(nbr[nbr >= 0])
        ghosts = nbr[epart[nbr] != s]
        owned_l.append(own)
        ghosts_l.append(ghosts)
        local_l.append(np.concatenate([own, ghosts]))

    # interface elements: ghosts anywhere
    iface = np.unique(np.concatenate(ghosts_l)) if any(
        len(gh) for gh in ghosts_l) else np.zeros(0, np.int64)
    nslots = len(iface)
    slot_of = np.full(E, nslots, dtype=np.int64)
    slot_of[iface] = np.arange(nslots)

    El = max(len(loc) for loc in local_l)
    # per-shard face sets: faces with el or er owned
    face_sets = []
    gel, ger = gnp["el"].astype(np.int64), gnp["er"].astype(np.int64)
    for s in range(nshard):
        m = (epart[gel] == s) | ((epart[ger] == s) & (ger != gel))
        face_sets.append(np.nonzero(m)[0])
    Fl = max(len(f) for f in face_sets)

    S = nshard
    G = gnp["xi_l"].shape[1]
    t = dict(
        vol=np.ones((S, El)),
        jacInv=np.zeros((S, 3, 3, El)),
        Jmat=np.zeros((S, 3, 3, El)),
        node0=np.zeros((S, 3, El)),
        emask=np.zeros((S, El)),
        el=np.zeros((S, Fl), dtype=np.int32),
        er=np.zeros((S, Fl), dtype=np.int32),
        fn=np.zeros((S, 3, Fl)),
        farea=np.zeros((S, Fl)),
        xi_l=np.zeros((S, 3, G, Fl)),
        xi_r=np.zeros((S, 3, G, Fl)),
        bctype=np.zeros((S, Fl), dtype=np.int32),
        fmask=np.zeros((S, Fl)),
        fose=np.full((S, 4, El), Fl, dtype=np.int32),
        fsideR=np.zeros((S, 4, El)),
        esuelT=np.full((S, 4, El), -1, dtype=np.int32),
        owned=np.zeros((S, El)),
        gslot=np.full((S, El), nslots, dtype=np.int32),
        grev=np.full((S, nslots + 1), El, dtype=np.int32),
        eglobal=np.full((S, El), -1, dtype=np.int32),
    )
    # padding faces keep a unit normal so the Riemann solver stays finite
    t["fn"][:, 0, :] = 1.0

    for s in range(S):
        loc = local_l[s]
        nl = len(loc)
        nown = len(owned_l[s])
        g2l = np.full(E, -1, dtype=np.int64)
        g2l[loc] = np.arange(nl)

        t["vol"][s, :nl] = gnp["vol"][loc]
        t["jacInv"][s, :, :, :nl] = gnp["jacInv"][:, :, loc]
        t["Jmat"][s, :, :, :nl] = gnp["Jmat"][:, :, loc]
        t["node0"][s, :, :nl] = gnp["node0"][:, loc]
        t["emask"][s, :nown] = 1.0  # emask marks OWNED elements (dt/diag)
        t["owned"][s, :nown] = 1.0
        t["eglobal"][s, :nl] = loc

        fs = face_sets[s]
        nf = len(fs)
        # faces sorted by their local left element
        fs = fs[np.argsort(g2l[gel[fs]], kind="stable")]
        lel = g2l[gel[fs]]
        ler = g2l[ger[fs]]
        # a face's R element may be absent (face on the far side of a
        # ghost): clamp to L (boundary-style; such faces only feed ghost
        # rows, which fose ignores)
        ler = np.where(ler < 0, lel, ler)
        t["el"][s, :nf] = lel
        t["er"][s, :nf] = ler
        t["fn"][s, :, :nf] = gnp["fn"][:, fs]
        t["farea"][s, :nf] = gnp["farea"][fs]
        t["xi_l"][s, :, :, :nf] = gnp["xi_l"][:, :, fs]
        t["xi_r"][s, :, :, :nf] = gnp["xi_r"][:, :, fs]
        t["bctype"][s, :nf] = gnp["bctype"][fs]
        t["fmask"][s, :nf] = 1.0

        t["fose"][s], t["fsideR"][s] = _owned_fose(
            lel, ler, gnp["bctype"][fs], El, nown, Fl)

        # limiter neighbours (local ids; -1 where absent)
        nb = esuel[loc]
        nbl = np.where(nb >= 0, g2l[np.clip(nb, 0, E - 1)], -1)
        t["esuelT"][s, :, :nl] = nbl.T

        # ghost exchange tables
        t["gslot"][s, :nl] = slot_of[loc]
        own_iface = owned_l[s][slot_of[owned_l[s]] < nslots]
        t["grev"][s, slot_of[own_iface]] = g2l[own_iface]

    ghalo = _build_ghost_halo(owned_l, ghosts_l, local_l, E, El, S)
    return t, ghalo, nslots, g.tables


def ghost_routes(t, ghalo, nslots):
    """Per receiving shard, the list of (sender, local ids on the sender,
    local ids on the receiver) that refresh its ghost elements: from the
    per-offset tables where there are some, else from the interface
    buffer (every slot has one owner, whose grev names its local id)."""
    S, El = t["owned"].shape
    if ghalo is not None:
        return halo_routes(ghalo, S)
    owner = np.full(nslots, -1, dtype=np.int64)
    srcid = np.zeros(nslots, dtype=np.int64)
    for s in range(S):
        m = np.nonzero(t["grev"][s, :nslots] < El)[0]
        owner[m] = s
        srcid[m] = t["grev"][s, m]
    routes = []
    for r in range(S):
        dst = np.nonzero((t["owned"][r] <= 0)
                         & (t["gslot"][r] < nslots))[0]
        q = t["gslot"][r, dst]
        rr = []
        for s in np.unique(owner[q]):
            m = owner[q] == s
            rr.append((int(s), srcid[q[m]], dst[m]))
        routes.append(rr)
    return routes


@dataclasses.dataclass
class ShardedDG:
    """Per-shard DG tables and geometries.

    geoms   : S DGGeom, shard s on group.devices[s] (fose pad slots at the
              last face, see the module docstring)
    owned   : S (El,) bool tensors, the elements shard s owns
    arrays  : the JAX package's stacked tables {name: (S, ...) numpy}
              (DGGeom fields and owned, gslot, grev, eglobal)
    ghalo   : per-offset ghost exchange tables (None for one shard or an
              overdecomposed merge, whose ghosts go through the interface
              slots)
    routes  : per receiving shard, [(sender, src ids, dst ids)] as
              tensors on the sender's and the receiver's devices
    """

    geoms: Tuple[DGGeom, ...]
    owned: Tuple[torch.Tensor, ...]
    arrays: Dict[str, np.ndarray]
    ghalo: Optional[NodeHalo]
    routes: List[list]
    group: ShardGroup
    nslots: int
    nelem_global: int

    @property
    def nshard(self) -> int:
        return self.group.nshard

    @property
    def ndof(self) -> int:
        return self.geoms[0].ndof

    def exchange(self, xs):
        """Ghost refresh of per-shard (R, El) tensors: each ghost element
        takes its owner's column.  The received slabs are gathered on the
        sender, moved with .to() and placed into a new tensor."""
        out = []
        for r, rr in enumerate(self.routes):
            if not rr:
                out.append(xs[r])
                continue
            dev = xs[r].device
            parts = [xs[s].index_select(1, src).to(dev)
                     for s, src, _ in rr]
            dst = rr[0][2] if len(rr) == 1 else self._dst_cat[r]
            rec = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            out.append(xs[r].index_copy(1, dst, rec))
        return out

    def __post_init__(self):
        self._dst_cat = [torch.cat([d for _, _, d in rr]) if len(rr) > 1
                         else None for rr in self.routes]


def sharded_dg_from_tables(t, ghalo, nslots, tables, ndof, nelem_global,
                           group: ShardGroup, dtype) -> ShardedDG:
    """Per-shard geometries on the group's devices from stacked tables."""
    from ..pde.dg import GEOM_INT_FIELDS, GEOM_TENSOR_FIELDS

    S, El = t["owned"].shape
    Fl = t["el"].shape[1]
    geoms, owned = [], []
    for s in range(S):
        dev = group.devices[s]
        f = {}
        for k in GEOM_TENSOR_FIELDS:
            a = t[k][s]
            if k == "fose":
                a = np.minimum(a, Fl - 1)
            if k in GEOM_INT_FIELDS:
                f[k] = torch.from_numpy(np.ascontiguousarray(
                    a, dtype=np.int32)).to(dev)
            else:
                f[k] = torch.from_numpy(np.ascontiguousarray(
                    a, dtype=np.float64)).to(dtype).to(dev)
        geoms.append(DGGeom(**f, ndof=int(ndof), nelem_real=int(nelem_global),
                            tables=tables))
        owned.append(torch.from_numpy(t["owned"][s] > 0).to(dev))
    routes = []
    for r, rr in enumerate(ghost_routes(t, ghalo, nslots)):
        routes.append([
            (s, torch.from_numpy(np.asarray(src, np.int64)).to(
                group.devices[s]),
             torch.from_numpy(np.asarray(dst, np.int64)).to(
                group.devices[r]))
            for s, src, dst in rr])
    return ShardedDG(geoms=tuple(geoms), owned=tuple(owned), arrays=t,
                     ghalo=ghalo, routes=routes, group=group, nslots=nslots,
                     nelem_global=int(nelem_global))


def build_dg_shards(
    mesh,
    nshard: int,
    ndof: int,
    bc_sidesets: Optional[Dict[int, int]] = None,
    algorithm: str = "sfc",
    dtype: Optional[torch.dtype] = None,
    hierarchy=None,
    epart: Optional[np.ndarray] = None,
    group: Optional[ShardGroup] = None,
) -> ShardedDG:
    """Partition a host mesh into nshard DG shards (owned elements plus
    their ghost layer), on the group's devices (default: a ShardGroup on
    the card); dtype None is torch's default float."""
    if dtype is None:
        dtype = torch.get_default_dtype()
    if group is None:
        group = ShardGroup(nshard)
    if group.nshard != nshard:
        raise ValueError("shard group size != shard count")
    t, ghalo, nslots, tables = dg_shard_tables(
        mesh, nshard, ndof, bc_sidesets, algorithm, hierarchy, epart)
    return sharded_dg_from_tables(t, ghalo, nslots, tables, ndof,
                                  mesh.nelem, group, dtype)
