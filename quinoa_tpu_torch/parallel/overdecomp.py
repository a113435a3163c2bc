"""Overdecomposition: several mesh chunks per shard (virtualization, -u).

The port's own copy of quinoa_tpu/parallel/overdecomp.py, the counterpart
of the reference's Charm++ overdecomposition: more chares than
processing elements, sized by tk::linearLoadDistributor's virtualization
u in [0, 1] (LoadDistributor.cpp:23-90).

- linear_load_distributor(u, nelem, npes) gives the chunk count, rounded
  up to a multiple of npes so every shard holds cpd chunks;
- the partitioner cuts cpd*npes chunks, which lpt_assign packs onto the
  shards by longest-processing-time over their element counts (or, for
  dynamic load balancing, their active dofs): the role of Charm++'s chare
  placement and migration;
- each shard's chunks are merged along the node/element (DG: element/
  face) axes into one super-shard, so the sharded solvers run unchanged.
  A boundary node shared by two chunks of one shard has two local copies:
  the slot table becomes rev_slot (m, nb+1), and the combine folds the m
  copies elementwise before it folds the shards.  DG ghosts go through the
  interface slots, each with one owner chunk.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..base.load import linear_load_distributor
from ..pde.cg import coords_cache_np
from . import ShardGroup


def lpt_assign(costs: np.ndarray, npes: int, cpd: int) -> np.ndarray:
    """Longest-processing-time greedy: chunks (sorted by cost desc) go to
    the least-loaded shard that still has room (cpd chunks each).
    Returns (npes, cpd) chunk ids."""
    nchunk = len(costs)
    assert nchunk == npes * cpd
    order = np.argsort(-np.asarray(costs), kind="stable")
    load = np.zeros(npes)
    fill = np.zeros(npes, dtype=np.int64)
    out = np.full((npes, cpd), -1, dtype=np.int64)
    for c in order:
        open_ = np.nonzero(fill < cpd)[0]
        d = open_[np.argmin(load[open_])]
        out[d, fill[d]] = c
        fill[d] += 1
        load[d] += costs[c]
    return out


@dataclasses.dataclass
class Overdecomposed:
    """A merged sharded table set (nshard = npes) and the chunk
    bookkeeping that rebalancing and per-chare output need."""

    sharded: object
    npes: int
    cpd: int
    assign: tuple  # (npes, cpd) chunk ids as tuple-of-tuples


def chunks_per_shard(virtualization: float, nelem: int, npes: int) -> int:
    """The chunks each shard holds: linearLoadDistributor's chunk count
    rounded up to a multiple of npes."""
    _, nchare = linear_load_distributor(virtualization, nelem, npes)
    return max(math.ceil(nchare / npes), 1)


def _group(group, npes):
    return ShardGroup(npes) if group is None else group


def merge_cg_tables(base, nb, npes, cpd, assign):
    """Merge chunk tables (nchunk = npes*cpd leading rows) into npes
    super-shards in assignment order (quinoa_tpu/parallel/overdecomp.py
    :104-176)."""
    perm = assign.reshape(-1)
    Nl = base["vol"].shape[1]
    Emax = base["emask"].shape[1]
    D = base["nsup"].shape[1]
    ncomp = base["bcmask"].shape[1]

    def grp(a):
        """(nchunk, ...) -> (npes, cpd, ...) in assignment order."""
        return np.asarray(a)[perm].reshape((npes, cpd) + a.shape[1:])

    coords = grp(base["coords"])
    inpoelT = grp(base["inpoelT"])
    nsup = grp(base["nsup"])
    slot = grp(base["bnd_slot"])

    NlM, EM = cpd * Nl, cpd * Emax
    coff = (np.arange(cpd) * Nl)[None, :, None, None]
    inpoelT_m = (inpoelT + coff).transpose(0, 2, 1, 3).reshape(npes, 4, EM)

    # nsup values index the chunk's (4*Emax) gather-slot space
    # (a*Emax + e, pad = 4*Emax); remap into the merged (4*EM) space:
    # a*EM + c*Emax + e, pad -> 4*EM
    a_idx = nsup // Emax
    e_idx = nsup % Emax
    valid = nsup < 4 * Emax
    ch = (np.arange(cpd) * Emax)[None, :, None, None]
    nsup_m = np.where(valid, a_idx * EM + ch + e_idx, 4 * EM)
    nsup_m = nsup_m.transpose(0, 2, 1, 3).reshape(npes, D, NlM)

    slot_m = slot.reshape(npes, NlM)
    # multi-copy reverse table: each boundary slot's local positions
    rev_lists = [[[] for _ in range(nb)] for _ in range(npes)]
    for d in range(npes):
        on = np.nonzero(slot_m[d] < nb)[0]
        for p in on:
            rev_lists[d][slot_m[d][p]].append(p)
    m = max((len(v) for dev in rev_lists for v in dev), default=1)
    rev_m = np.full((npes, m, nb + 1), NlM, dtype=np.int32)
    for d in range(npes):
        for s, v in enumerate(rev_lists[d]):
            rev_m[d, : len(v), s] = v

    coords_m = coords.transpose(0, 2, 1, 3).reshape(npes, 3, NlM)
    cn = np.zeros((npes, 4, 3, EM))
    ctr = np.zeros((npes, 3, EM))
    for d in range(npes):
        cn[d], ctr[d] = coords_cache_np(coords_m[d], inpoelT_m[d])
    return dict(
        coords=coords_m,
        inpoelT=inpoelT_m,
        J=grp(base["J"]).reshape(npes, EM),
        grad=grp(base["grad"]).transpose(0, 2, 3, 1, 4).reshape(
            npes, 4, 3, EM),
        vol=grp(base["vol"]).reshape(npes, NlM),
        emask=grp(base["emask"]).reshape(npes, EM),
        nsup=nsup_m,
        coords_n=cn,
        ctr=ctr,
        bnd_slot=slot_m,
        rev_slot=rev_m,
        owned=grp(base["owned"]).reshape(npes, NlM),
        bcmask=grp(base["bcmask"]).transpose(0, 2, 1, 3).reshape(
            npes, ncomp, NlM),
        gids=grp(base["gids"]).reshape(npes, NlM),
    )


def build_overdecomposed_cg(
    mesh,
    npes: int,
    virtualization: float,
    ncomp: int,
    bcnodes: Optional[np.ndarray] = None,
    algorithm: str = "sfc",
    dtype: Optional[torch.dtype] = None,
    epart: Optional[np.ndarray] = None,
    group: Optional[ShardGroup] = None,
) -> Overdecomposed:
    """linearLoadDistributor-many chunks, LPT-packed onto npes shards and
    merged per shard, on the group's devices."""
    from .shard import cg_shard_tables, sharded_cg_from_tables

    if dtype is None:
        dtype = torch.get_default_dtype()
    cpd = chunks_per_shard(virtualization, mesh.nelem, npes)
    nchunk = cpd * npes
    base, _, nb, _, _ = cg_shard_tables(mesh, nchunk, ncomp, bcnodes,
                                        algorithm, epart=epart)
    costs = base["emask"].sum(axis=1)
    assign = lpt_assign(costs, npes, cpd)
    t = merge_cg_tables(base, nb, npes, cpd, assign)
    sh = sharded_cg_from_tables(t, None, nb, mesh.nnode, mesh.nelem,
                                _group(group, npes), dtype)
    return Overdecomposed(sharded=sh, npes=npes, cpd=cpd,
                          assign=tuple(map(tuple, assign.tolist())))


def build_overdecomposed_dg(
    mesh,
    npes: int,
    virtualization: float,
    ndof: int,
    bc_sidesets=None,
    algorithm: str = "sfc",
    dtype: Optional[torch.dtype] = None,
    elem_weights=None,
    group: Optional[ShardGroup] = None,
) -> Overdecomposed:
    """DG overdecomposition: chunks cut by the stacked DG builder
    (uniformly padded per chunk), LPT-packed, and merged per shard along
    the element and face axes (connectivity offset per chunk block).
    With elem_weights (active dofs) the chunks keep their membership and
    only their packing changes (the chare-migration analog)."""
    from .dg_shard import dg_shard_tables, sharded_dg_from_tables

    if dtype is None:
        dtype = torch.get_default_dtype()
    cpd = chunks_per_shard(virtualization, mesh.nelem, npes)
    nchunk = cpd * npes
    base, _, nslots, tables = dg_shard_tables(mesh, nchunk, ndof,
                                              bc_sidesets, algorithm)
    if elem_weights is None:
        costs = base["owned"].sum(axis=1)
    else:
        w = np.asarray(elem_weights, dtype=np.float64)
        eg = base["eglobal"]
        owned = base["owned"] > 0
        costs = np.array([w[eg[c][owned[c]]].sum() for c in range(nchunk)])
    assign = lpt_assign(costs, npes, cpd)
    perm = assign.reshape(-1)

    El = base["vol"].shape[1]
    Fl = base["el"].shape[1]
    ElM, FlM = cpd * El, cpd * Fl

    def grp(a):
        return np.asarray(a)[perm].reshape((npes, cpd) + a.shape[1:])

    def cat(a, n):  # (npes, cpd, ..., n) -> (npes, ..., cpd*n)
        x = grp(a)
        return np.moveaxis(x, 1, -2).reshape(
            x.shape[:1] + x.shape[2:-1] + (cpd * n,))

    eoff = (np.arange(cpd) * El)[None, :, None]
    foff = (np.arange(cpd) * Fl)[None, :, None]

    t = {}
    for k in ("vol", "jacInv", "Jmat", "node0", "emask", "fsideR", "owned",
              "gslot", "eglobal"):
        t[k] = cat(base[k], El)
    for k in ("fn", "farea", "xi_l", "xi_r", "bctype", "fmask"):
        t[k] = cat(base[k], Fl)
    for k in ("el", "er"):
        x = grp(base[k]) + eoff
        t[k] = np.moveaxis(x, 1, -2).reshape(npes, FlM).astype(np.int32)

    fose = grp(base["fose"])  # (npes, cpd, 4, El); pad = Fl
    fose = np.where(fose == Fl, FlM, fose + foff[:, :, None, :])
    t["fose"] = np.moveaxis(fose, 1, -2).reshape(npes, 4, ElM).astype(
        np.int32)
    esu = grp(base["esuelT"])  # (npes, cpd, 4, El); -1 absent
    esu = np.where(esu < 0, -1, esu + eoff[:, :, None, :])
    t["esuelT"] = np.moveaxis(esu, 1, -2).reshape(npes, 4, ElM).astype(
        np.int32)

    # per-shard single-copy push table: the owning chunk's local id
    grev = grp(base["grev"])  # (npes, cpd, nslots+1); pad = El
    grev_m = np.full((npes, nslots + 1), ElM, dtype=np.int32)
    for d in range(npes):
        for c in range(cpd):
            own = grev[d, c] < El
            grev_m[d, own] = c * El + grev[d, c][own]
    t["grev"] = grev_m

    sh = sharded_dg_from_tables(t, None, nslots, tables, ndof, mesh.nelem,
                                _group(group, npes), dtype)
    return Overdecomposed(sharded=sh, npes=npes, cpd=cpd,
                          assign=tuple(map(tuple, assign.tolist())))


def build_overdecomposed_alecg(
    mesh,
    npes: int,
    virtualization: float,
    ncomp: int,
    bcnodes: Optional[np.ndarray] = None,
    algorithm: str = "sfc",
    dtype: Optional[torch.dtype] = None,
    group: Optional[ShardGroup] = None,
) -> Overdecomposed:
    """ALECG overdecomposition: the CG node/element merge plus per-chunk
    edge tables merged along the edge axis (slot space offset per
    chunk).  Shared-node dual-face areas stay per-chunk partial sums,
    which the boundary-node combine totals as it does across shards."""
    from ..inciter.alecg import edge_arrays_np
    from .alecg_spmd import sharded_alecg_from_tables
    from .partition import partition_elements

    if dtype is None:
        dtype = torch.get_default_dtype()
    cpd = chunks_per_shard(virtualization, mesh.nelem, npes)
    nchunk = cpd * npes
    coords, inpoel = mesh.coords, mesh.inpoel
    epart = partition_elements(coords, inpoel, nchunk, algorithm)
    over = build_overdecomposed_cg(mesh, npes, virtualization, ncomp,
                                   bcnodes=bcnodes, algorithm=algorithm,
                                   dtype=dtype, epart=epart, group=group)
    assert over.cpd == cpd

    elems = [np.nonzero(epart == c)[0] for c in range(nchunk)]
    nodes = [np.unique(inpoel[e].ravel()) for e in elems]
    Nl = over.sharded.geoms[0].nnode // cpd

    per = []
    for c in range(nchunk):
        g2l = np.full(mesh.nnode, -1, dtype=np.int64)
        g2l[nodes[c]] = np.arange(len(nodes[c]))
        loc_inpoel = g2l[inpoel[elems[c]]]
        edges, A, ensup, D = edge_arrays_np(
            coords[nodes[c]], loc_inpoel, len(nodes[c]))
        per.append((edges, A, ensup, len(nodes[c])))

    EE = max(len(p[0]) for p in per)
    De = max(p[2].shape[0] for p in per)
    EEM = cpd * EE
    s_edges = np.zeros((npes, 2, EEM), dtype=np.int32)
    s_A = np.zeros((npes, EEM))
    s_ensup = np.full((npes, De, cpd * Nl), 2 * EEM, dtype=np.int32)
    for d, row in enumerate(over.assign):
        for j, c in enumerate(row):
            edges, A, ensup, nn = per[c]
            ne = len(edges)
            s_edges[d, :, j * EE: j * EE + ne] = edges.T + j * Nl
            s_A[d, j * EE: j * EE + ne] = A
            a_idx = ensup // ne if ne else ensup
            e_idx = ensup % ne if ne else ensup
            valid = ensup < 2 * ne
            s_ensup[d, : ensup.shape[0], j * Nl: j * Nl + nn] = np.where(
                valid, a_idx * EEM + j * EE + e_idx, 2 * EEM)
    sh = sharded_alecg_from_tables(
        over.sharded, dict(edgesT=s_edges, eA=s_A, ensup=s_ensup), dtype)
    return Overdecomposed(sharded=sh, npes=npes, cpd=cpd,
                          assign=over.assign)
