"""Multi-pass refinement with the reference's intermediates semantics.

The port's own copy of quinoa_tpu/amr/multipass.py (host-side numpy, the
same operations in the same order).

Single-pass refinement (refine.py) closes a tagged-edge set under the
admissible patterns and subdivides — enough for any ONE refinement event
on a conforming mesh.  The reference, however, refines REPEATEDLY
through a persistent tet store (t0ref applies each `initial` deck
keyword as a pass over the previous pass's result; dtref compounds), and
its algorithm treats partially-refined elements specially
(src/Inciter/AMR/mesh_adapter.cpp, the Waltz et al. marking algorithm):

- children of a 1:2 or 1:4 template are INTERMEDIATE elements; the
  edges incident to the template's midpoint node(s) are intermediate-
  locked between passes (lock_intermediates, mesh_adapter.cpp:538), and
  incoming tags on them are dropped (mark_error_refinement:134).
- tagging any unlocked edge of an intermediate element re-refines the
  PARENT: all the siblings' unlocked edges are activated and, if every
  sibling is in a valid state (check_valid_refinement_case), the group
  is replaced by the parent's full 1:8 (two_to_eight / four_to_eight,
  perform_refinement round_two) — partial templates never stack.
- normal elements with locked/intermediate edges take "Algorithm 2"
  (refinement_class_two): 1:2 for a single active edge, 1:4 on the
  first lock-free face (face order ABC/ABD/ACD/BCD) with two active
  edges, else deactivate-and-lock.

This module implements that machine vectorized on the host: an
`AMRState` carries the live partial groups (parent connectivity,
children, midpoint nodes, boundary triangles) between passes, and
`refine_pass` marks + applies one pass.  Used by the sequential t0ref
passes (control/config.apply_t0ref); single-event dtref remains on
refine.refine_mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..mesh.unsmesh import UnsMesh
from ..mesh.derived import _TET_EDGES
from .refine import (
    RefineMap, _edge_key, _EDGE_MASKS, _FACE_MASKS, _FACE_EDGES,
    _FACE_NODES, _FACE_OPP, _EDGE_OTHERS, _FLIP_12, _FLIP_14, _POPCOUNT6,
)

#: our local-face scan order matching the reference's generate_face_lists
#: (ABC, ABD, ACD, BCD -> our _FACE_NODES rows 0, 1, 3, 2)
_REF_FACE_ORDER = (0, 1, 3, 2)

_MAX_ROUNDS = 30  # AMR_MAX_ROUNDS (mesh_adapter.cpp:278)


@dataclasses.dataclass
class PartialGroup:
    """One live 1:2 or 1:4 template (an 'intermediate' sibling group)."""

    parent: np.ndarray     # (4,) parent tet node ids
    kind: int              # 2 or 4 (number of children)
    which: int             # local edge (1:2) / local face (1:4) of parent
    children: np.ndarray   # element rows in the CURRENT mesh
    mids: np.ndarray       # midpoint node ids (1 or 3)
    mid_pairs: np.ndarray  # (len(mids), 2) parent-node endpoints of each mid
    btris: List[Tuple[int, np.ndarray]]  # (sideset, (3,) tri) at PARENT level


@dataclasses.dataclass
class AMRState:
    """Persistent cross-pass refinement state (the tet_store analog)."""

    groups: List[PartialGroup] = dataclasses.field(default_factory=list)

    def inter_nodes(self) -> np.ndarray:
        if not self.groups:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate([g.mids for g in self.groups]))


def _tri_split(tri, keys_sorted, mid_ids):
    """Subdivide one boundary triangle by the split edges present in the
    sorted key table (same templates as refine.refine_mesh's bface pass).
    Returns an (n, 3) int64 array."""
    t = np.asarray(tri, np.int64)
    k3 = np.array([_edge_key(t[0], t[1]), _edge_key(t[1], t[2]),
                   _edge_key(t[2], t[0])])
    pos = np.searchsorted(keys_sorted, k3)
    posc = np.clip(pos, 0, max(len(keys_sorted) - 1, 0))
    has = (keys_sorted[posc] == k3) if len(keys_sorted) else \
        np.zeros(3, bool)
    m3 = np.where(has, mid_ids[posc] if len(keys_sorted) else -1, -1)
    nt = int(has.sum())
    if nt == 0:
        return t[None, :]
    if nt == 1:
        k = int(np.nonzero(has)[0][0])
        p, q, r = t[k], t[(k + 1) % 3], t[(k + 2) % 3]
        m = m3[k]
        return np.array([[p, m, r], [m, q, r]])
    if nt == 2:
        k = int(np.nonzero(~has)[0][0])
        p, q, r = t[k], t[(k + 1) % 3], t[(k + 2) % 3]
        mqr, mrp = m3[(k + 1) % 3], m3[(k + 2) % 3]
        return np.array([[p, q, mqr], [p, mqr, mrp], [mrp, mqr, r]])
    a, b, c = t
    mab, mbc, mca = m3
    return np.array([[a, mab, mca], [b, mbc, mab], [c, mca, mbc],
                     [mab, mbc, mca]])


def _tri_split_batch(tris, keys_sorted, mid_ids):
    """Vectorized _tri_split over an (T, 3) triangle batch (the same
    batch-per-pattern emission as refine.refine_mesh's bface pass, so
    per-tri output order matches the scalar helper)."""
    t = np.asarray(tris, np.int64)
    if not len(t):
        return np.zeros((0, 3), np.int64)
    k3 = np.stack([_edge_key(t[:, 0], t[:, 1]),
                   _edge_key(t[:, 1], t[:, 2]),
                   _edge_key(t[:, 2], t[:, 0])], axis=1)
    pos = np.searchsorted(keys_sorted, k3)
    posc = np.clip(pos, 0, max(len(keys_sorted) - 1, 0))
    has = (keys_sorted[posc] == k3) if len(keys_sorted) else \
        np.zeros_like(k3, bool)
    m3 = np.where(has, mid_ids[posc] if len(keys_sorted) else -1, -1)
    nt = has.sum(axis=1)
    counts = 1 + nt                         # 1/2/3/4 rows
    offb = np.zeros(len(t) + 1, np.int64)
    np.cumsum(counts, out=offb[1:])
    out = np.empty((offb[-1], 3), np.int64)

    idx = np.nonzero(nt == 0)[0]
    if len(idx):
        out[offb[idx]] = t[idx]
    for k in range(3):
        idx = np.nonzero((nt == 1) & has[:, k])[0]
        if len(idx):
            p = t[idx, k]
            q = t[idx, (k + 1) % 3]
            r = t[idx, (k + 2) % 3]
            m = m3[idx, k]
            base = offb[idx]
            out[base] = np.stack([p, m, r], axis=1)
            out[base + 1] = np.stack([m, q, r], axis=1)
    for k in range(3):
        idx = np.nonzero((nt == 2) & ~has[:, k])[0]
        if len(idx):
            p = t[idx, k]
            q = t[idx, (k + 1) % 3]
            r = t[idx, (k + 2) % 3]
            mqr = m3[idx, (k + 1) % 3]
            mrp = m3[idx, (k + 2) % 3]
            base = offb[idx]
            out[base] = np.stack([p, q, mqr], axis=1)
            out[base + 1] = np.stack([p, mqr, mrp], axis=1)
            out[base + 2] = np.stack([mrp, mqr, r], axis=1)
    idx = np.nonzero(nt == 3)[0]
    if len(idx):
        a, b, c = t[idx, 0], t[idx, 1], t[idx, 2]
        mab, mbc, mca = m3[idx, 0], m3[idx, 1], m3[idx, 2]
        base = offb[idx]
        out[base] = np.stack([a, mab, mca], axis=1)
        out[base + 1] = np.stack([b, mbc, mab], axis=1)
        out[base + 2] = np.stack([c, mca, mbc], axis=1)
        out[base + 3] = np.stack([mab, mbc, mca], axis=1)
    return out


def _group_subtris(g: PartialGroup):
    """The current-mesh boundary triangles a live group contributed (its
    parent btris subdivided by the group's midpoints)."""
    if not g.btris:
        return []
    order = np.argsort(_edge_key(g.mid_pairs[:, 0], g.mid_pairs[:, 1]))
    keys = _edge_key(g.mid_pairs[order, 0], g.mid_pairs[order, 1])
    mid_ids = g.mids[order]
    out = []
    for ss, tri in g.btris:
        for row in _tri_split(tri, keys, mid_ids):
            out.append((ss, row))
    return out


def mark_pass(mesh: UnsMesh, tags: np.ndarray, state: AMRState,
              banned: np.ndarray = None):
    """The reference's mark_refinement fixed point for one pass.

    tags   : (n, 2) node pairs requested for refinement.
    banned : optional (m, 2) node pairs pre-LOCKED for this pass — the
             level-cap mechanism (refinement.hpp:28 locks the edges of
             at-cap elements INSIDE the compatibility iteration, so the
             closure routes around them via class 2 instead of
             escalating through them).
    Returns (hasmask (E,) int64 6-bit decision per element,
             rebuild (len(groups),) bool).
    Batch (Jacobi) rounds instead of the reference's in-round sequential
    sweeps; converges to the same state for tag sets whose class-2/3
    interactions are order-independent (asserted by the parity tests).
    """
    inpoel = mesh.inpoel.astype(np.int64)
    E = inpoel.shape[0]
    eA = inpoel[:, _TET_EDGES[:, 0]]
    eB = inpoel[:, _TET_EDGES[:, 1]]
    keys = _edge_key(eA, eB)                      # (E,6)
    ukeys = np.unique(keys)
    eidx = np.searchsorted(ukeys, keys)           # (E,6) -> unique edge id

    # persistent intermediate locks: every edge incident to a live
    # partial template's midpoint node (lock_intermediates)
    lockv = np.zeros(len(ukeys), np.int8)         # 0 unlocked 1 locked 2 int
    inter = state.inter_nodes()
    if len(inter):
        enda = (ukeys >> 32)
        endb = (ukeys & 0xFFFFFFFF)
        isin = np.isin(enda, inter) | np.isin(endb, inter)
        lockv[isin] = 2

    if banned is not None and len(banned):
        banned = np.asarray(banned, np.int64).reshape(-1, 2)
        bk = np.unique(_edge_key(banned[:, 0], banned[:, 1]))
        pos = np.clip(np.searchsorted(ukeys, bk), 0, len(ukeys) - 1)
        tgt = pos[ukeys[pos] == bk]
        lockv[tgt[lockv[tgt] == 0]] = 1

    # intake: tags on non-unlocked edges are dropped
    needs = np.zeros(len(ukeys), bool)
    if len(tags):
        tk = np.unique(_edge_key(tags[:, 0], tags[:, 1]))
        pos = np.searchsorted(ukeys, tk)
        posc = np.clip(pos, 0, len(ukeys) - 1)
        ok = ukeys[posc] == tk
        tgt = posc[ok]
        needs[tgt[lockv[tgt] == 0]] = True

    # per-element case / group id
    case_arr = np.zeros(E, np.int8)
    group_id = np.full(E, -1, np.int64)
    for gi, g in enumerate(state.groups):
        case_arr[g.children] = g.kind
        group_id[g.children] = gi
    normal = np.zeros(E, bool)
    rebuild = np.zeros(len(state.groups), bool)

    hasmask = np.zeros(E, np.int64)
    face_ok = np.zeros(64, bool)
    face_ok[_FACE_MASKS] = True

    for _ in range(_MAX_ROUNDS):
        lock_e = lockv[eidx]                       # (E,6)
        act = needs[eidx]                          # needs only on unlocked
        n_ref = act.sum(axis=1)
        n_other = (lock_e > 0).sum(axis=1)

        eligible = n_ref > 0
        partial = (case_arr > 0) & ~normal
        c3 = eligible & partial
        c1 = eligible & ~partial & (n_other == 0)
        c2 = eligible & ~c3 & ~c1

        adds: List[np.ndarray] = []
        rms: List[np.ndarray] = []
        locks: List[np.ndarray] = []
        newmask = np.zeros(E, np.int64)
        # rebuild decisions are re-derived every round: a class-2 lock
        # can invalidate a group that looked rebuildable earlier
        rebuild0 = rebuild.copy()
        rebuild[:] = False

        # ---- class 1 (Algorithm 1) — vectorized
        idx = np.nonzero(c1)[0]
        if len(idx):
            mask = (act[idx] * _EDGE_MASKS).sum(axis=1)
            cnt = n_ref[idx]
            m1 = cnt == 1
            newmask[idx[m1]] = mask[m1]
            rest = ~m1
            fmask = np.zeros(len(idx), np.int64)
            for lf in _REF_FACE_ORDER:
                fm = _FACE_MASKS[lf]
                onf = rest & (fmask == 0) & \
                    (_POPCOUNT6[mask & fm] == cnt) & (cnt <= 3)
                fmask[onf] = fm
            newmask[idx[rest & (fmask > 0)]] = fmask[rest & (fmask > 0)]
            full = rest & (fmask == 0)
            newmask[idx[full]] = 63
            grow = newmask[idx] & ~mask
            if grow.any():
                gbits = (grow[:, None] & _EDGE_MASKS) != 0
                adds.append(eidx[idx][gbits])

        # ---- class 3 (Algorithm 3) — per triggered group
        for gi in np.unique(group_id[c3]):
            if gi < 0:
                continue
            g = state.groups[gi]
            che = eidx[g.children]                 # (k,6)
            unl = lockv[che] == 0
            adds.append(che[unl])
            # validity with the activation applied
            n_int_ch = (lockv[che] == 2).sum(axis=1)
            n_ref_ch = unl.sum(axis=1)
            if g.kind == 2:
                valid = (n_int_ch == 3) & (n_ref_ch == 3)
            else:
                valid = ((n_int_ch == 5) & (n_ref_ch == 1)) \
                    | ((n_int_ch == 6) & (n_ref_ch == 0))
            if valid.all():
                rebuild[gi] = True
            else:
                rebuild[gi] = False
                rms.append(che.ravel())
                locks.append(che[unl])
                normal[g.children] = True

        # ---- class 2 (Algorithm 2) — small counts, per element
        for el in np.nonzero(c2)[0]:
            ed = eidx[el]
            nd = act[el]
            na = int(nd.sum())
            if na == 1:
                newmask[el] = int((_EDGE_MASKS * nd).sum())
                continue
            done = False
            for lf in _REF_FACE_ORDER:
                fed = _FACE_EDGES[lf]
                if nd[fed].sum() >= 2 and (lock_e[el][fed] > 0).sum() == 0:
                    adds.append(ed[fed])
                    newmask[el] = int(_FACE_MASKS[lf])
                    done = True
                    break
            if not done:
                rms.append(ed)
                locks.append(ed[lockv[ed] == 0])

        needs0, lock0 = needs.copy(), lockv.copy()
        for a in adds:
            needs[a] = True
        for r in rms:
            needs[r] = False
        for lk in locks:
            lockv[np.asarray(lk)[lockv[np.asarray(lk)] == 0]] = 1
        needs[lockv > 0] = False

        changed = (not np.array_equal(needs, needs0)
                   or not np.array_equal(lockv, lock0)
                   or not np.array_equal(newmask, hasmask)
                   or not np.array_equal(rebuild, rebuild0))
        hasmask = newmask
        if not changed:
            break

    # rebuilt groups' children don't subdivide themselves
    for gi, g in enumerate(state.groups):
        if rebuild[gi]:
            hasmask[g.children] = 0

    # conformity: every element must split every still-needed edge it
    # touches (class interactions resolve any conflicts by fixed point)
    act = needs[eidx]
    covered = (hasmask[:, None] & _EDGE_MASKS) != 0
    for gi, g in enumerate(state.groups):
        if rebuild[gi]:
            covered[g.children] = True  # replaced by the parent's 1:8
    if (act & ~covered).any():
        raise AssertionError(
            "non-conforming mark fixed point (order-dependent class-2/3 "
            "interaction); fall back to single-pass refinement")
    return hasmask, rebuild


def transfer_dg_pass(rmap: RefineMap, u: np.ndarray, vol_old: np.ndarray,
                     ncomp: int, ndof: int) -> np.ndarray:
    """DG dofs (C*K, E_old) -> the refine_pass mesh.

    - children of an untouched parent (one child) carry ALL dofs 1:1;
    - children of a subdivided parent inherit the parent's cell mean
      with higher dofs zeroed (exactly conservative: the children
      partition the parent);
    - children of a 2:8/4:8 partial-group REBUILD get the group's
      volume-weighted mean of its old children's means (conservative
      through the parent rebuild), higher dofs zeroed.
    """
    u = np.asarray(u).reshape(ncomp, ndof, -1)
    Enew = len(rmap.parent)
    out = np.zeros((ncomp, ndof, Enew), dtype=u.dtype)
    ok = rmap.parent >= 0
    src = np.maximum(rmap.parent, 0)
    out[:, :, ok] = u[:, :, src[ok]]
    if ndof > 1:
        cnt = np.bincount(src[ok], minlength=u.shape[2])
        split = ok & (cnt[src] > 1)
        if split.any():
            out[:, 1:, split] = 0.0
    vol_old = np.asarray(vol_old)
    for old_rows, new_rows in (rmap.rebuilt or []):
        v = vol_old[old_rows]
        mean = (u[:, 0, :][:, old_rows] * v).sum(axis=1) / v.sum()
        out[:, 0, :][:, new_rows] = mean[:, None]
    return out.reshape(ncomp * ndof, Enew)


def refine_pass(mesh: UnsMesh, tags: np.ndarray, state: AMRState,
                banned: np.ndarray = None,
                ) -> Tuple[UnsMesh, RefineMap, AMRState]:
    """One reference-semantics refinement pass; returns the refined
    mesh, a RefineMap (nodal-transfer compatible; its `rebuilt` field
    carries per-rebuilt-group (old_children, new_rows) for conservative
    DG transfer), and the new state.  `banned` edges are pre-locked
    (level-cap locks, see mark_pass)."""
    tags = np.asarray(tags, np.int64).reshape(-1, 2)
    hasmask, rebuild = mark_pass(mesh, tags, state, banned=banned)

    inpoel = mesh.inpoel.astype(np.int64)
    E = inpoel.shape[0]

    # ---- working element list: drop rebuilt children, append parents
    drop = np.zeros(E, bool)
    reb_groups = [g for gi, g in enumerate(state.groups) if rebuild[gi]]
    for g in reb_groups:
        drop[g.children] = True
    keep_rows = np.nonzero(~drop)[0]
    w_inpoel = np.concatenate(
        [inpoel[keep_rows]]
        + [g.parent[None, :] for g in reb_groups], axis=0)
    w_mask = np.concatenate(
        [hasmask[keep_rows], np.full(len(reb_groups), 63, np.int64)])
    W = w_inpoel.shape[0]

    # known midpoints: rebuilt parents' originally-split edges
    old_mid: Dict[int, int] = {}
    for g in reb_groups:
        for (a, b), m in zip(g.mid_pairs.tolist(), g.mids.tolist()):
            old_mid[int(_edge_key(np.int64(a), np.int64(b)))] = int(m)

    eA = w_inpoel[:, _TET_EDGES[:, 0]]
    eB = w_inpoel[:, _TET_EDGES[:, 1]]
    ek = _edge_key(eA, eB)                         # (W,6)
    has = (w_mask[:, None] & _EDGE_MASKS) != 0     # (W,6)
    split_keys = np.unique(ek[has])
    is_old = np.isin(split_keys,
                     np.fromiter(old_mid.keys(), np.int64,
                                 len(old_mid)) if old_mid else
                     np.zeros(0, np.int64))
    new_keys = split_keys[~is_old]                 # sorted
    npa = (new_keys >> 32)
    npb = (new_keys & 0xFFFFFFFF)
    midcoords = 0.5 * (mesh.coords[npa] + mesh.coords[npb])
    coords = np.concatenate([mesh.coords, midcoords], axis=0)

    mid_id = np.empty(len(split_keys), np.int64)
    mid_id[~is_old] = mesh.nnode + np.arange(len(new_keys))
    if old_mid:
        mid_id[is_old] = [old_mid[int(k)] for k in split_keys[is_old]]

    pos = np.searchsorted(split_keys, ek)
    posc = np.clip(pos, 0, max(len(split_keys) - 1, 0))
    mids = np.where(has, mid_id[posc] if len(split_keys) else -1, -1)
    cnt = has.sum(axis=1)
    maskbits = w_mask

    nchild = np.select([cnt == 0, cnt == 1, cnt == 3], [1, 2, 4], default=8)
    off = np.zeros(W + 1, np.int64)
    np.cumsum(nchild, out=off[1:])
    raw = np.empty((off[-1], 4), np.int64)
    parents_w = np.repeat(np.arange(W), nchild)
    flipc = np.zeros(off[-1], bool)

    idx = np.nonzero(cnt == 0)[0]
    if len(idx):
        raw[off[idx]] = w_inpoel[idx]

    for le in range(6):
        idx = np.nonzero((cnt == 1) & has[:, le])[0]
        if not len(idx):
            continue
        a = w_inpoel[idx, _TET_EDGES[le, 0]]
        b = w_inpoel[idx, _TET_EDGES[le, 1]]
        o0 = w_inpoel[idx, _EDGE_OTHERS[le, 0]]
        o1 = w_inpoel[idx, _EDGE_OTHERS[le, 1]]
        m = mids[idx, le]
        base = off[idx]
        raw[base] = np.stack([m, b, o0, o1], axis=1)
        raw[base + 1] = np.stack([a, m, o0, o1], axis=1)
        if _FLIP_12[le]:
            flipc[base] = flipc[base + 1] = True

    for lf in range(4):
        idx = np.nonzero((cnt == 3) & (maskbits == _FACE_MASKS[lf]))[0]
        if not len(idx):
            continue
        fa = w_inpoel[idx, _FACE_NODES[lf, 0]]
        fb = w_inpoel[idx, _FACE_NODES[lf, 1]]
        fc = w_inpoel[idx, _FACE_NODES[lf, 2]]
        d = w_inpoel[idx, _FACE_OPP[lf]]
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
    if len(idx):
        a, b, cc, d = (w_inpoel[idx, i] for i in range(4))
        e_, f_, g_, h_, i_, j_ = (mids[idx, k] for k in range(6))
        base = off[idx]
        for k, r in enumerate([
            (a, e_, g_, h_), (b, f_, e_, i_), (cc, g_, f_, j_),
            (d, h_, j_, i_), (f_, j_, g_, i_), (e_, i_, g_, h_),
            (e_, f_, g_, i_), (g_, i_, j_, h_),
        ]):
            raw[base + k] = np.stack(r, axis=1)

    from ..mesh.geometry import _cross3
    pxyz = mesh.coords[w_inpoel]
    pa = pxyz[:, 0]
    pj = np.einsum("ij,ij->i",
                   _cross3(pxyz[:, 1] - pa, pxyz[:, 2] - pa),
                   pxyz[:, 3] - pa)
    flip = flipc ^ (pj < 0)[parents_w]
    newinpoel = raw
    if flip.any():
        newinpoel[flip, 2], newinpoel[flip, 3] = raw[flip, 3], raw[flip, 2]

    # ---- boundary triangles
    # drop rebuilt groups' contributed sub-tris; re-split from the
    # parent level so the rebuilt 1:8's canonical face split is used
    reb_sub = {}
    for g in reb_groups:
        for ss, tri in _group_subtris(g):
            reb_sub.setdefault(ss, []).append(tuple(sorted(tri.tolist())))
    # per-tri midpoint lookup covers new splits AND old group midpoints
    all_keys = split_keys
    all_ids = mid_id
    newbface: Dict[int, np.ndarray] = {}
    w_btris: Dict[int, List[np.ndarray]] = {}
    for ss, tris in mesh.bface.items():
        rows = [t for t in np.asarray(tris, np.int64)]
        gone = set(reb_sub.get(ss, []))
        rows = [t for t in rows if tuple(sorted(t.tolist())) not in gone]
        for g in reb_groups:
            rows += [tri.astype(np.int64) for s2, tri in g.btris
                     if s2 == ss]
        w_btris[ss] = rows
        newbface[ss] = (_tri_split_batch(np.stack(rows), all_keys,
                                         all_ids).astype(np.int32)
                        if rows else np.zeros((0, 3), np.int32))

    newmesh = UnsMesh(coords=coords, inpoel=newinpoel.astype(np.int32))
    newmesh.bface = newbface
    newmesh.bnode = newmesh.bnode_from_bface()

    # ---- next state: surviving groups (reindexed) + new partial groups
    newstate = AMRState()
    w_of_cur = np.full(E, -1, np.int64)
    w_of_cur[keep_rows] = np.arange(len(keep_rows))
    for gi, g in enumerate(state.groups):
        if rebuild[gi]:
            continue
        wrows = w_of_cur[g.children]
        if (w_mask[wrows] != 0).any():
            raise AssertionError("live partial child subdivided in place")
        newstate.groups.append(dataclasses.replace(
            g, children=off[wrows].copy()))

    node_sets = {}
    for ss, rows in w_btris.items():
        for t in rows:
            node_sets.setdefault(frozenset(t.tolist()), []).append(
                (ss, t))
    for w in np.nonzero((cnt == 1) | (cnt == 3))[0]:
        pn = w_inpoel[w]
        if cnt[w] == 1:
            which = int(np.nonzero(has[w])[0][0])
            gm = mids[w, which:which + 1]
            gp = np.array([[pn[_TET_EDGES[which, 0]],
                            pn[_TET_EDGES[which, 1]]]])
            kind = 2
        else:
            which = int(np.nonzero(maskbits[w] == _FACE_MASKS)[0][0])
            fed = _FACE_EDGES[which]
            gm = mids[w, fed]
            gp = np.stack([pn[_TET_EDGES[fed, 0]],
                           pn[_TET_EDGES[fed, 1]]], axis=1)
            kind = 4
        btris = []
        pset = set(pn.tolist())
        for fl in range(4):
            fs = frozenset(pn[_FACE_NODES[fl]].tolist())
            for ss, t in node_sets.get(fs, []):
                btris.append((ss, t.copy()))
        newstate.groups.append(PartialGroup(
            parent=pn.copy(), kind=kind, which=which,
            children=off[w] + np.arange(kind), mids=gm.copy(),
            mid_pairs=gp.copy(), btris=btris))

    # RefineMap: nodal transfer needs mid (endpoint) pairs for every new
    # node; parent rows refer to the WORKING list (rebuilt parents map
    # to -1 in the original mesh)
    parent_orig = np.concatenate(
        [keep_rows, np.full(len(reb_groups), -1, np.int64)])
    # rebuilt-group transfer info: (old element rows, new element rows)
    # per 2:8/4:8 rebuild, for conservative DG transfer through the
    # parent rebuild (two_to_eight/four_to_eight re-refines the parent,
    # so the new children's source is the group's old children)
    rebuilt = []
    for i, g in enumerate(reb_groups):
        w = len(keep_rows) + i
        rebuilt.append((g.children.copy(),
                        off[w] + np.arange(int(nchild[w]))))
    rmap = RefineMap(
        mid_edges=np.stack([npa, npb], axis=1) if len(new_keys)
        else np.zeros((0, 2), np.int64),
        parent=parent_orig[parents_w],
        nnode_old=mesh.nnode,
        rebuilt=rebuilt,
    )
    return newmesh, rmap, newstate
