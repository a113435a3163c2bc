"""Derived mesh connectivity (vectorized numpy).

The port's own copy of the part of quinoa_tpu/mesh/derived.py it calls
(reference src/Mesh/DerivedData.hpp): the face neighbours of elements, the
DG face tables and the edge list.  Node triples and pairs are packed into
one unsigned 64-bit key each, so every pass is one sort.
"""

from __future__ import annotations

import numpy as np

# Local nodes of the four faces of a tet, outward-oriented for a
# positive-Jacobian element; face f is opposite local node f.
_TET_FACES = np.array([[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]],
                      dtype=np.int32)

# The six edges of a tet by local node pairs.
_TET_EDGES = np.array([[0, 1], [1, 2], [2, 0], [0, 3], [1, 3], [2, 3]],
                      dtype=np.int32)


def gen_inpoed(inpoel: np.ndarray) -> np.ndarray:
    """Unique undirected edges (nedge, 2) int32 with lo < hi, in
    lexicographic order."""
    e = np.sort(inpoel[:, _TET_EDGES].reshape(-1, 2).astype(np.uint64),
                axis=1)
    key = np.unique((e[:, 0] << np.uint64(32)) | e[:, 1])
    return np.stack([key >> np.uint64(32), key & np.uint64(0xFFFFFFFF)],
                    axis=1).astype(np.int32)


def _face_order(inpoel: np.ndarray):
    """The 4*nelem faces sorted by their node triple: (order, eq) with
    eq[i] true where sorted faces i and i+1 are the same triangle."""
    keys = np.sort(inpoel[:, _TET_FACES].reshape(-1, 3), axis=1)
    if keys.size and int(keys.max()) < (1 << 21):
        # 21 bits a node: one argsort instead of three lexsort passes
        pk = ((keys[:, 0].astype(np.uint64) << np.uint64(42))
              | (keys[:, 1].astype(np.uint64) << np.uint64(21))
              | keys[:, 2].astype(np.uint64))
        order = np.argsort(pk, kind="stable")
        return order, pk[order][:-1] == pk[order][1:]
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    k = keys[order]
    return order, (k[:-1] == k[1:]).all(axis=1)


def gen_esuel(inpoel: np.ndarray, nnode: int) -> np.ndarray:
    """Element neighbours across faces: (nelem, 4) int32; entry (e, f) is
    the element across the face opposite local node f, -1 on the
    boundary."""
    nelem = inpoel.shape[0]
    order, eq = _face_order(inpoel)
    a, b = order[:-1][eq], order[1:][eq]
    esuel = np.full((nelem, 4), -1, dtype=np.int32)
    esuel[a // 4, a % 4] = b // 4
    esuel[b // 4, b % 4] = a // 4
    return esuel


def gen_faces(inpoel: np.ndarray, nnode: int):
    """Face tables of cell-centred (DG) solvers, as quinoa_tpu's:

      esuf   (nface, 2) int32  left/right element, right -1 on the
                               boundary; interior faces have the lower
                               element id on the left
      inpofa (nface, 3) int32  face nodes, outward for the left element
      lfacel (nface,) int32    local face id in the left element
      lfacer (nface,) int32    local face id in the right element (-1)
      nbfac  int               number of boundary faces, which come first
    """
    nelem = inpoel.shape[0]
    owner = np.repeat(np.arange(nelem, dtype=np.int64), 4)
    lface = np.tile(np.arange(4, dtype=np.int64), nelem)
    order, eq = _face_order(inpoel)
    same = np.zeros(len(order), dtype=bool)
    same[:-1] |= eq
    same[1:] |= eq

    bnd_rows = order[~same]
    first, second = order[:-1][eq], order[1:][eq]
    el_a, el_b = owner[first], owner[second]
    lf_a, lf_b = lface[first], lface[second]
    swap = el_a > el_b
    el_l = np.where(swap, el_b, el_a)
    el_r = np.where(swap, el_a, el_b)
    lf_l = np.where(swap, lf_b, lf_a)
    lf_r = np.where(swap, lf_a, lf_b)

    nbfac = len(bnd_rows)
    nface = nbfac + len(first)
    esuf = np.empty((nface, 2), dtype=np.int32)
    inpofa = np.empty((nface, 3), dtype=np.int32)
    lfacel = np.empty(nface, dtype=np.int32)
    lfacer = np.empty(nface, dtype=np.int32)

    b_el, b_lf = owner[bnd_rows], lface[bnd_rows]
    esuf[:nbfac, 0] = b_el
    esuf[:nbfac, 1] = -1
    inpofa[:nbfac] = inpoel[b_el[:, None], _TET_FACES[b_lf]]
    lfacel[:nbfac] = b_lf
    lfacer[:nbfac] = -1

    esuf[nbfac:, 0] = el_l
    esuf[nbfac:, 1] = el_r
    inpofa[nbfac:] = inpoel[el_l[:, None], _TET_FACES[lf_l]]
    lfacel[nbfac:] = lf_l
    lfacer[nbfac:] = lf_r
    return {"esuf": esuf, "inpofa": inpofa, "lfacel": lfacel,
            "lfacer": lfacer, "nbfac": nbfac}
