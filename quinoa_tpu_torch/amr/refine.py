"""Tetrahedral refinement: compatibility closure + 1:2/1:4/1:8 templates.

The port's own copy of quinoa_tpu/amr/refine.py (host-side numpy): the
same operations in the same order, so both packages refine, coarsen and
transfer to the same bits.

Counterpart of the reference's refinement classes and compatibility
algorithm (src/Inciter/AMR/mesh_adapter.hpp:23-96, refinement.hpp): an
element whose tagged-edge set is not one of the admissible patterns

    1 edge            -> 1:2
    3 edges, one face -> 1:4
    6 edges           -> 1:8

gets all six edges tagged (upgrade toward 1:8), iterated to a fixed point
— the same closure Refiner::correctref converges by chare-boundary
iteration, done here as a vectorized host loop.

New nodes are edge midpoints (the reference derives child node ids by
hashing parent edge endpoints, node_connectivity; here they are rows of a
midpoint table).  Boundary triangles are subdivided with the same edge
midpoints, so side sets stay consistent with the volume subdivision.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from ..mesh.unsmesh import UnsMesh
from ..mesh.derived import _TET_EDGES, gen_inpoed

# local faces (by their 3 local edge ids) — used for the 1:4 pattern.
# edges: 0:(0,1) 1:(1,2) 2:(2,0) 3:(0,3) 4:(1,3) 5:(2,3)
_FACE_EDGES = np.array(
    [[0, 1, 2], [0, 4, 3], [1, 5, 4], [2, 3, 5]], dtype=np.int64
)
# the local node opposite each of those faces (face (0,1,2)->node 3 etc.)
_FACE_OPP = np.array([3, 2, 0, 1], dtype=np.int64)
_FACE_NODES = np.array(
    [[0, 1, 2], [0, 1, 3], [1, 2, 3], [2, 0, 3]], dtype=np.int64
)

_EDGE_MASKS = (1 << np.arange(6)).astype(np.int64)
# the two local nodes NOT on each local edge, in original node order
_EDGE_OTHERS = np.array(
    [[2, 3], [0, 3], [1, 3], [1, 2], [0, 2], [0, 1]], dtype=np.int64
)
_FACE_MASKS = np.array(
    [int(_EDGE_MASKS[f].sum()) for f in _FACE_EDGES], dtype=np.int64
)

# Child-orientation parity per template variant.  Child nodes are fixed
# barycentric combinations of the parent's, so J_child = c * J_parent
# with c a template constant: the flip decision is a per-slot constant
# XOR'd with the parent's orientation sign — no per-child geometry.
# Constants verified against the geometric Jacobian on random tets
# (tests/test_amr.py::test_child_orientation_parity).  All slots of a
# variant share one parity: 1:2 about local edge 4 inverts, 1:4 about
# local faces 1/2/3 inverts, 1:1/1:8 and the rest preserve.
_FLIP_12 = np.array([0, 0, 0, 0, 1, 0], dtype=bool)
_FLIP_14 = np.array([0, 1, 1, 1], dtype=bool)


@dataclasses.dataclass
class RefineMap:
    """Bookkeeping of one refinement event.

    mid_edges : (nmid, 2) parent node ids of each new (midpoint) node,
                in order; new node i has id nnode_old + i.
    parent    : (nelem_new,) parent element id of each child.  -1 for
                children of a 2:8/4:8 partial-group rebuild (multipass
                refine_pass only): their source is not one old element
                but the group's old children, recorded in `rebuilt`.
    nnode_old : node count before refinement.
    rebuilt   : multipass only — one (old_children_rows, new_rows) pair
                per rebuilt partial group, for conservative solution
                transfer through the parent rebuild (mesh_adapter.cpp
                two_to_eight/four_to_eight).
    """

    mid_edges: np.ndarray
    parent: np.ndarray
    nnode_old: int
    rebuilt: list = None


def _edge_key(a, b):
    lo = np.minimum(a, b).astype(np.int64)
    hi = np.maximum(a, b).astype(np.int64)
    return lo << 32 | hi


_POPCOUNT6 = np.array([bin(i).count("1") for i in range(64)],
                      dtype=np.int64)


def compatible_tags(inpoel: np.ndarray, tagged: np.ndarray) -> np.ndarray:
    """Close a tagged-edge set under the admissible patterns.

    tagged : (n,2) node pairs.  Returns the closed set as (m,2) pairs.

    Follows the reference's "Algorithm 1" closure exactly
    (mesh_adapter.cpp refinement_class_one): 1 edge -> 1:2; 2 or 3
    edges on one face -> activate that face's remaining edges, 1:4;
    anything else -> activate all six, 1:8.  In particular TWO tagged
    edges sharing a face upgrade to the 1:4 face pattern, NOT to 1:8 —
    the fixed point of these monotone deterministic rules is unique, so
    the batch-round iteration order matches the reference's per-element
    sweeps.
    """
    tag_arr = (np.unique(_edge_key(tagged[:, 0], tagged[:, 1]))
               if len(tagged) else np.zeros(0, np.int64))
    eA = inpoel[:, _TET_EDGES[:, 0]]  # (E,6)
    eB = inpoel[:, _TET_EDGES[:, 1]]
    keys = _edge_key(eA, eB)  # (E,6)
    face_ok = np.zeros(64, dtype=bool)
    face_ok[_FACE_MASKS] = True

    # edge-key -> incident-element index, built once: after the first
    # full sweep only elements touching newly tagged edges can change
    # status, so the fixed point iterates on a shrinking frontier
    # instead of re-scanning all (E,6) keys every round.
    flat_order = np.argsort(keys, axis=None, kind="stable")
    flat_sorted = keys.ravel()[flat_order]
    elem_of = flat_order // 6

    def _grow(sub):
        """Keys to newly tag for element subset `sub` (Algorithm 1)."""
        k = keys[sub]
        if len(tag_arr):
            posc = np.clip(np.searchsorted(tag_arr, k), 0,
                           len(tag_arr) - 1)
            isin = tag_arr[posc] == k
        else:
            isin = np.zeros_like(k, dtype=bool)
        mask = (isin * _EDGE_MASKS).sum(axis=1)
        cnt = isin.sum(axis=1)
        ok = ((cnt == 0) | (cnt == 1)
              | ((cnt == 3) & face_ok[mask]) | (cnt == 6))
        # 2 tagged edges on a common face: activate only that face's
        # third edge (refinement_class_one's same-face 1:4 branch)
        addmask = np.zeros(len(sub), dtype=np.int64)
        two = ~ok & (cnt == 2)
        if two.any():
            for fm in _FACE_MASKS:
                onface = two & (_POPCOUNT6[mask & fm] == 2)
                addmask[onface] = fm & ~mask[onface]
        # everything else inadmissible: activate all six (1:8)
        full = ~ok & (addmask == 0)
        addmask[full] = 63 & ~mask[full]
        if not addmask.any():
            return np.zeros(0, np.int64)
        addbits = (addmask[:, None] & _EDGE_MASKS) != 0
        return np.unique(k[addbits])

    frontier = np.arange(inpoel.shape[0])
    while len(frontier):
        new_keys = np.setdiff1d(_grow(frontier), tag_arr)
        if not len(new_keys):
            break
        tag_arr = np.union1d(tag_arr, new_keys)
        # next frontier: every element incident to a newly tagged edge
        lo = np.searchsorted(flat_sorted, new_keys, side="left")
        hi = np.searchsorted(flat_sorted, new_keys, side="right")
        spans = hi - lo
        touch = elem_of[np.repeat(lo, spans)
                        + (np.arange(spans.sum())
                           - np.repeat(np.cumsum(spans) - spans, spans))]
        frontier = np.unique(touch)

    if not len(tag_arr):
        return np.zeros((0, 2), dtype=np.int64)
    return np.stack([tag_arr >> 32, tag_arr & 0xFFFFFFFF], axis=1)


def _orient(children: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Fix inverted child tets by swapping their last two nodes.

    Retained as the geometric ORACLE for the template-parity fast path
    used by refine_mesh (tests/test_amr.py::test_child_orientation_
    parity).  The parity path infers child signs algebraically; for a
    parent so degenerate that a child's floating-point Jacobian sign
    is rounding noise the two can differ — downstream geometry builders
    assert J > 0 and fail loudly on such meshes either way."""
    from ..mesh.geometry import _cross3

    xyz = coords[children]                      # ONE (Nc, 4, 3) gather
    a = xyz[:, 0]
    j = np.einsum("ij,ij->i",
                  _cross3(xyz[:, 1] - a, xyz[:, 2] - a), xyz[:, 3] - a)
    flip = j < 0
    out = children.copy()
    out[flip, 2], out[flip, 3] = children[flip, 3], children[flip, 2]
    return out


def refine_mesh(
    mesh: UnsMesh, tagged: np.ndarray
) -> Tuple[UnsMesh, RefineMap]:
    """Refine mesh with the (already-compatible or not) tagged edge set."""
    inpoel = mesh.inpoel.astype(np.int64)
    tagged = compatible_tags(inpoel, np.asarray(tagged, dtype=np.int64))
    if len(tagged) == 0:
        return mesh, RefineMap(
            mid_edges=np.zeros((0, 2), np.int64),
            parent=np.arange(mesh.nelem),
            nnode_old=mesh.nnode,
        )

    # midpoint node table
    keys = _edge_key(tagged[:, 0], tagged[:, 1])
    order = np.argsort(keys)
    tagged = tagged[order]
    keys = keys[order]
    midcoords = 0.5 * (mesh.coords[tagged[:, 0]] + mesh.coords[tagged[:, 1]])
    coords = np.concatenate([mesh.coords, midcoords], axis=0)

    # ---- vectorized template subdivision (bit-identical to the former
    # per-element loop, measured 20x faster at 200k-parent remeshes):
    # per element-edge midpoint ids via one searchsorted (midpoint node
    # ids are sequential in sorted-key order), then each admissible
    # pattern {0,1,3,6 tagged edges} filled as one batch at precomputed
    # child offsets so the child ORDER matches the loop exactly.
    eA = inpoel[:, _TET_EDGES[:, 0]]
    eB = inpoel[:, _TET_EDGES[:, 1]]
    ek = _edge_key(eA, eB)
    pos = np.searchsorted(keys, ek)
    posc = np.clip(pos, 0, len(keys) - 1)
    has = keys[posc] == ek
    mids = np.where(has, mesh.nnode + posc, -1)
    cnt = has.sum(axis=1)
    maskbits = (has * _EDGE_MASKS).sum(axis=1)

    E = inpoel.shape[0]
    nchild = np.select([cnt == 0, cnt == 1, cnt == 3], [1, 2, 4], default=8)
    off = np.zeros(E + 1, np.int64)
    np.cumsum(nchild, out=off[1:])
    raw = np.empty((off[-1], 4), np.int64)
    parents = np.repeat(np.arange(E), nchild)
    flipc = np.zeros(off[-1], dtype=bool)  # template orientation parity

    idx = np.nonzero(cnt == 0)[0]
    if len(idx):
        raw[off[idx]] = inpoel[idx]

    for le in range(6):  # 1:2 split about local edge le
        idx = np.nonzero((cnt == 1) & has[:, le])[0]
        if not len(idx):
            continue
        a = inpoel[idx, _TET_EDGES[le, 0]]
        b = inpoel[idx, _TET_EDGES[le, 1]]
        o0 = inpoel[idx, _EDGE_OTHERS[le, 0]]
        o1 = inpoel[idx, _EDGE_OTHERS[le, 1]]
        m = mids[idx, le]
        base = off[idx]
        raw[base] = np.stack([m, b, o0, o1], axis=1)
        raw[base + 1] = np.stack([a, m, o0, o1], axis=1)
        if _FLIP_12[le]:
            flipc[base] = flipc[base + 1] = True

    for lf in range(4):  # 1:4 split about local face lf
        idx = np.nonzero((cnt == 3) & (maskbits == _FACE_MASKS[lf]))[0]
        if not len(idx):
            continue
        fa = inpoel[idx, _FACE_NODES[lf, 0]]
        fb = inpoel[idx, _FACE_NODES[lf, 1]]
        fc = inpoel[idx, _FACE_NODES[lf, 2]]
        d = inpoel[idx, _FACE_OPP[lf]]
        mab = mids[idx, _FACE_EDGES[lf, 0]]
        mbc = mids[idx, _FACE_EDGES[lf, 1]]
        mca = mids[idx, _FACE_EDGES[lf, 2]]
        base = off[idx]
        raw[base] = np.stack([fa, mab, mca, d], axis=1)
        raw[base + 1] = np.stack([fb, mbc, mab, d], axis=1)
        raw[base + 2] = np.stack([fc, mca, mbc, d], axis=1)
        raw[base + 3] = np.stack([mab, mbc, mca, d], axis=1)
        if _FLIP_14[lf]:
            for k in range(4):
                flipc[base + k] = True

    idx = np.nonzero(cnt == 6)[0]
    if len(idx):  # 1:8 regular subdivision: corner tets + octahedron
        # split about the AC-BD diagonal, matching the reference
        # template (src/Inciter/AMR/refinement.hpp:526-534)
        a, b, cc, d = (inpoel[idx, i] for i in range(4))
        e_, f_, g_, h_, i_, j_ = (mids[idx, k] for k in range(6))
        base = off[idx]
        for k, r in enumerate([
            (a, e_, g_, h_), (b, f_, e_, i_), (cc, g_, f_, j_),
            (d, h_, j_, i_), (f_, j_, g_, i_), (e_, i_, g_, h_),
            (e_, f_, g_, i_), (g_, i_, j_, h_),
        ]):
            raw[base + k] = np.stack(r, axis=1)

    # orientation by template parity: J_child is a fixed multiple of
    # J_parent per variant slot (_FLIP_12/_FLIP_14), so only the PARENT
    # Jacobian signs need geometry — ~8x less work than orienting every
    # child (the former _orient), and bit-identical output.
    from ..mesh.geometry import _cross3
    pxyz = mesh.coords[inpoel]                   # one (E, 4, 3) gather
    pa = pxyz[:, 0]
    pj = np.einsum("ij,ij->i",
                   _cross3(pxyz[:, 1] - pa, pxyz[:, 2] - pa),
                   pxyz[:, 3] - pa)
    flip = flipc ^ (pj < 0)[parents]
    newinpoel = raw  # fresh array; swap in place (RHS copies first)
    if flip.any():
        newinpoel[flip, 2], newinpoel[flip, 3] = \
            raw[flip, 3], raw[flip, 2]

    # boundary triangles: subdivide with the same midpoints
    # (vectorized batch-per-pattern, emitting rows at per-tri offsets so
    # the output order matches the former per-tri loop exactly)
    newbface: Dict[int, np.ndarray] = {}
    for ss, tris in mesh.bface.items():
        t = tris.astype(np.int64)
        if not len(t):
            newbface[ss] = np.zeros((0, 3), np.int32)
            continue
        k3 = np.stack([
            _edge_key(t[:, 0], t[:, 1]),
            _edge_key(t[:, 1], t[:, 2]),
            _edge_key(t[:, 2], t[:, 0]),
        ], axis=1)                                   # (T, 3)
        posb = np.searchsorted(keys, k3)
        posbc = np.clip(posb, 0, len(keys) - 1)
        hasb = keys[posbc] == k3
        m3 = np.where(hasb, mesh.nnode + posbc, -1)
        ntb = hasb.sum(axis=1)
        counts = 1 + ntb                              # 1/2/3/4 rows
        offb = np.zeros(len(t) + 1, np.int64)
        np.cumsum(counts, out=offb[1:])
        out = np.empty((offb[-1], 3), np.int64)

        idx = np.nonzero(ntb == 0)[0]
        if len(idx):
            out[offb[idx]] = t[idx]

        # nt == 1: tagged edge k -> (p, m, r), (m, q, r)
        for k in range(3):
            idx = np.nonzero((ntb == 1) & hasb[:, k])[0]
            if not len(idx):
                continue
            pn = t[idx, k]
            qn = t[idx, (k + 1) % 3]
            rn = t[idx, (k + 2) % 3]
            m = m3[idx, k]
            base = offb[idx]
            out[base] = np.stack([pn, m, rn], axis=1)
            out[base + 1] = np.stack([m, qn, rn], axis=1)

        # nt == 2: untagged edge k -> (p,q,mqr), (p,mqr,mrp), (mrp,mqr,r)
        for k in range(3):
            idx = np.nonzero((ntb == 2) & ~hasb[:, k])[0]
            if not len(idx):
                continue
            pn = t[idx, k]
            qn = t[idx, (k + 1) % 3]
            rn = t[idx, (k + 2) % 3]
            mqr = m3[idx, (k + 1) % 3]               # edge (q, r)
            mrp = m3[idx, (k + 2) % 3]               # edge (r, p)
            base = offb[idx]
            out[base] = np.stack([pn, qn, mqr], axis=1)
            out[base + 1] = np.stack([pn, mqr, mrp], axis=1)
            out[base + 2] = np.stack([mrp, mqr, rn], axis=1)

        idx = np.nonzero(ntb == 3)[0]
        if len(idx):
            an, bn, cn = t[idx, 0], t[idx, 1], t[idx, 2]
            mab, mbc, mca = m3[idx, 0], m3[idx, 1], m3[idx, 2]
            base = offb[idx]
            out[base] = np.stack([an, mab, mca], axis=1)
            out[base + 1] = np.stack([bn, mbc, mab], axis=1)
            out[base + 2] = np.stack([cn, mca, mbc], axis=1)
            out[base + 3] = np.stack([mab, mbc, mca], axis=1)
        newbface[ss] = out.astype(np.int32)

    newmesh = UnsMesh(coords=coords, inpoel=newinpoel.astype(np.int32))
    newmesh.bface = newbface
    newmesh.bnode = newmesh.bnode_from_bface()
    return newmesh, RefineMap(
        mid_edges=tagged,
        parent=np.asarray(parents, dtype=np.int64),
        nnode_old=mesh.nnode,
    )


def uniform_refine(mesh: UnsMesh) -> Tuple[UnsMesh, RefineMap]:
    """1:8 refinement of every element (amr initial uniform)."""
    return refine_mesh(mesh, gen_inpoed(mesh.inpoel).astype(np.int64))


def transfer_cg(refmap: RefineMap, u: np.ndarray) -> np.ndarray:
    """Transfer a nodal field (C, N_old) to the refined mesh: midpoint
    nodes get the P1-interpolated (edge-average) value — exact for the
    linear finite-element representation."""
    mids = 0.5 * (u[:, refmap.mid_edges[:, 0]] + u[:, refmap.mid_edges[:, 1]])
    return np.concatenate([u, mids], axis=1)


def derefine_mesh(
    coarse_mesh: UnsMesh, refmap: RefineMap, request: np.ndarray
) -> Tuple[UnsMesh, RefineMap, np.ndarray]:
    """Coarsen a refined mesh back toward its parent, one level.

    Counterpart of the reference's derefinement side of mesh_adapter
    (src/Inciter/AMR/mesh_adapter.hpp derefinement_algorithm): parents
    whose children are all flagged for coarsening collapse back to the
    parent tet, subject to conformity — a parent may only collapse if
    none of its refined-edge midpoints is still needed by a neighboring
    parent that stays refined (the reference's deactivation locks).  The
    lock set is iterated to a fixed point, mirroring compatible_tags on
    the refinement side.

    coarse_mesh : the mesh BEFORE the refinement event
    refmap      : the RefineMap produced by that refinement
    request     : bool (nelem_coarse,), True = want this parent coarsened

    Returns (new_mesh, new_refmap, coarsened) where new_refmap maps
    coarse_mesh -> new_mesh (the surviving refinement) and coarsened
    marks the parents whose child count strictly decreased.  A midpoint
    survives iff some incident parent did NOT request coarsening; the
    compatible_tags closure inside refine_mesh then upgrades parents left
    with inadmissible partial edge sets — that closure IS the transition
    layer between coarsened and kept regions (a requesting parent next to
    a staying one keeps its shared edges and becomes 1:2/1:4 instead of
    staying 1:8).  Rebuilding with refine_mesh keeps subdivision
    templates, orientation, and boundary-triangle handling identical to
    the refinement path.  Returns (None, refmap, zeros) when nothing
    changes.
    """
    ncoarse = coarse_mesh.nelem
    request = np.asarray(request, dtype=bool)
    child_cnt = np.bincount(refmap.parent, minlength=ncoarse)
    refined = child_cnt > 1
    if len(refmap.mid_edges) == 0 or not (request & refined).any():
        # nothing to do: the surviving refinement is the input refinement
        return None, refmap, np.zeros(ncoarse, dtype=bool)

    # tagged-edge incidence: which coarse parents touch which midpoint edge
    tag_keys = _edge_key(refmap.mid_edges[:, 0], refmap.mid_edges[:, 1])
    order = np.argsort(tag_keys)
    tag_keys_sorted = tag_keys[order]
    inpoel = coarse_mesh.inpoel.astype(np.int64)
    ek = _edge_key(inpoel[:, _TET_EDGES[:, 0]], inpoel[:, _TET_EDGES[:, 1]])
    pos = np.searchsorted(tag_keys_sorted, ek)
    pos = np.clip(pos, 0, len(tag_keys_sorted) - 1)
    is_tag = tag_keys_sorted[pos] == ek  # (E,6)
    par_idx, loc = np.nonzero(is_tag)
    edge_idx = pos[par_idx, loc]  # sorted-tag index per incidence
    M = len(tag_keys_sorted)

    # an edge midpoint survives while any incident parent stays refined
    edge_kept = np.zeros(M, dtype=bool)
    edge_kept[edge_idx[~request[par_idx]]] = True
    if edge_kept.all():  # every tagged edge is still needed
        return None, refmap, np.zeros(ncoarse, dtype=bool)

    kept = refmap.mid_edges[order][edge_kept]
    newmesh, newmap = refine_mesh(coarse_mesh, kept)
    new_cnt = np.bincount(newmap.parent, minlength=ncoarse)
    return newmesh, newmap, new_cnt < child_cnt


def _child_blocks(refmap: RefineMap, ncoarse: int):
    cnt = np.bincount(refmap.parent, minlength=ncoarse)
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    return cnt, start


def transfer_cg_derefine(
    refmap_old: RefineMap, refmap_new: RefineMap, u: np.ndarray
) -> np.ndarray:
    """Nodal field (C, N_fine) -> derefined mesh: original coarse nodes
    keep their values; surviving midpoints are gathered by edge key;
    midpoints the compatibility closure introduced fresh (not present in
    the fine mesh) get the linear edge-endpoint average."""
    n0 = refmap_old.nnode_old
    if len(refmap_new.mid_edges) == 0:
        return u[:, :n0].copy()
    ok = _edge_key(refmap_old.mid_edges[:, 0], refmap_old.mid_edges[:, 1])
    oorder = np.argsort(ok)
    oks = ok[oorder]
    # refine_mesh stores mid_edges sorted by key and assigns midpoint ids
    # in that order, so row i of mid_edges IS node n0+i
    nk = _edge_key(refmap_new.mid_edges[:, 0], refmap_new.mid_edges[:, 1])
    assert (np.diff(nk) > 0).all(), "mid_edges not in id order"
    if len(oks):
        idx = np.clip(np.searchsorted(oks, nk), 0, len(oks) - 1)
        found = oks[idx] == nk
    else:
        idx = np.zeros(len(nk), np.int64)
        found = np.zeros(len(nk), dtype=bool)
    mids = np.empty((u.shape[0], len(nk)), dtype=u.dtype)
    mids[:, found] = u[:, n0 + oorder[idx[found]]]
    if (~found).any():
        ed = refmap_new.mid_edges[~found]
        mids[:, ~found] = 0.5 * (u[:, ed[:, 0]] + u[:, ed[:, 1]])
    return np.concatenate([u[:, :n0], mids], axis=1)


def _parent_tag_sets(coarse_inpoel: np.ndarray, mid_edges: np.ndarray):
    """(parent, edge-key) incidence rows, lex-sorted, for pattern tests."""
    inpoel = coarse_inpoel.astype(np.int64)
    ek = _edge_key(inpoel[:, _TET_EDGES[:, 0]], inpoel[:, _TET_EDGES[:, 1]])
    keys = np.sort(_edge_key(mid_edges[:, 0], mid_edges[:, 1]))
    if len(keys) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    pos = np.clip(np.searchsorted(keys, ek), 0, len(keys) - 1)
    hit = keys[pos] == ek
    par, loc = np.nonzero(hit)
    key = ek[par, loc]
    s = np.lexsort((key, par))
    return par[s], key[s]


def transfer_dg_derefine(
    coarse_mesh: UnsMesh, refmap_old: RefineMap, refmap_new: RefineMap,
    u: np.ndarray, vol_old: np.ndarray, ncomp: int, ndof: int,
) -> np.ndarray:
    """DG dofs (C*K, E_fine) -> derefined mesh.  Children of parents whose
    subdivision pattern is unchanged carry over 1:1 (identical template
    order); parents whose pattern changed (collapsed, or re-templated by
    the compatibility closure) get the volume-weighted average of their
    old children's cell means — exactly conservative — with higher dofs
    zeroed."""
    ncoarse = coarse_mesh.nelem
    ocnt, ostart = _child_blocks(refmap_old, ncoarse)
    ncnt, nstart = _child_blocks(refmap_new, ncoarse)

    # pattern equality per parent: identical tagged-edge key multisets
    opar, okey = _parent_tag_sets(coarse_mesh.inpoel, refmap_old.mid_edges)
    npar_, nkey = _parent_tag_sets(coarse_mesh.inpoel, refmap_new.mid_edges)
    tagsA = np.bincount(opar, minlength=ncoarse)
    tagsB = np.bincount(npar_, minlength=ncoarse)
    same_pattern = tagsA == tagsB
    selA = same_pattern[opar]
    selB = same_pattern[npar_]
    mism = okey[selA] != nkey[selB]  # aligned: equal counts per parent
    if mism.any():
        bad = np.zeros(ncoarse, dtype=bool)
        bad[opar[selA][mism]] = True
        same_pattern &= ~bad

    u = u.reshape(ncomp, ndof, -1)
    enew = len(refmap_new.parent)
    out = np.zeros((ncomp, ndof, enew), dtype=u.dtype)

    newpar = refmap_new.parent
    off = np.arange(enew) - nstart[newpar]
    same = same_pattern[newpar]
    src = ostart[newpar] + off
    out[:, :, same] = u[:, :, src[same]]

    coll = ~same
    if coll.any():
        cp = newpar[coll]
        oldpar = refmap_old.parent
        wsum = np.zeros((ncomp, ncoarse), dtype=u.dtype)
        vsum = np.zeros(ncoarse, dtype=u.dtype)
        np.add.at(vsum, oldpar, vol_old)
        for c in range(ncomp):
            np.add.at(wsum[c], oldpar, u[c, 0] * vol_old)
        out[:, 0, coll] = wsum[:, cp] / vsum[cp]
    return out.reshape(ncomp * ndof, enew)


def transfer_dg(refmap: RefineMap, u: np.ndarray, ncomp: int,
                ndof: int) -> np.ndarray:
    """Transfer DG dofs (C*K, E_old) to the refined mesh: each child
    inherits its parent's cell average (dof 0) — exact for DG(P0), the
    scheme the reference's dtref decks use — with higher-order dofs
    injected as zero (the reference's during-timestepping AMR likewise
    transfers cell data to children; src/Inciter/DG.cpp resizePostAMR).
    """
    u = u.reshape(ncomp, ndof, -1)
    out = u[:, :, refmap.parent].copy()
    if ndof > 1:
        out[:, 1:, :] = 0.0
    return out.reshape(ncomp * ndof, -1)
