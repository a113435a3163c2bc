"""Hilbert element and first-touch node reordering (numpy).

Port of quinoa_tpu/mesh/reorder.py: remap and shift_to_zero (reference
src/Base/Reorder.cpp), the Hilbert codes, the element and node reorders,
and the Morton (SFC) renumbering of both.  The Hilbert order keeps face neighbours close in element
rank (the reference's Sorter/Reorder locality pass), which on the card
keeps the neighbour reads of the limit and face kernels within nearby
cache lines.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..base.profiler import span
from .unsmesh import UnsMesh


def remap(ids: np.ndarray, newid: np.ndarray) -> np.ndarray:
    """A connectivity array under a node renumbering (tk::remap)."""
    return newid[ids]


def shift_to_zero(inpoel: np.ndarray) -> Tuple[np.ndarray, int]:
    """Node ids shifted so that the smallest is zero, and the shift
    (tk::shiftToZero)."""
    lo = int(inpoel.min())
    return inpoel - lo, lo


def hilbert_codes(pts: np.ndarray, bits: int = 16) -> np.ndarray:
    """Hilbert-curve index of 3-D points (Skilling's transpose algorithm,
    vectorized); the JAX package's native pass gives the same codes."""
    lo = pts.min(axis=0)
    span = pts.max(axis=0) - lo
    span[span == 0] = 1.0
    X = ((pts - lo) / span * ((1 << bits) - 1)).astype(np.uint32).copy()
    n = 3
    M = np.uint32(1 << (bits - 1))
    # inverse undo excess work
    Q = M
    while Q > 1:
        P = np.uint32(Q - 1)
        for i in range(n):
            cond = (X[:, i] & Q) != 0
            X[cond, 0] ^= P
            t = (X[:, 0] ^ X[:, i]) & P
            t = np.where(cond, np.uint32(0), t)
            X[:, 0] ^= t
            X[:, i] ^= t
        Q >>= np.uint32(1)
    # Gray encode
    for i in range(1, n):
        X[:, i] ^= X[:, i - 1]
    t = np.zeros_like(X[:, 0])
    Q = M
    while Q > 1:
        cond = (X[:, n - 1] & Q) != 0
        t = np.where(cond, t ^ np.uint32(Q - 1), t)
        Q >>= np.uint32(1)
    for i in range(n):
        X[:, i] ^= t
    # interleave the transpose-format bits (X[0] carries the MSB)
    h = np.zeros(len(X), dtype=np.uint64)
    for b in range(bits - 1, -1, -1):
        for i in range(n):
            h = (h << np.uint64(1)) | (
                (X[:, i] >> np.uint32(b)) & 1
            ).astype(np.uint64)
    return h


def hilbert_element_reorder(mesh: UnsMesh) -> Tuple[UnsMesh, np.ndarray]:
    """Renumber ELEMENTS along the Hilbert curve (nodes untouched).

    Returns (new mesh, eorder) with eorder new->old: new.inpoel[i] =
    mesh.inpoel[eorder[i]].  Spans (base/profiler.py): reorder, and inside
    it reorder.codes, reorder.sort and reorder.permute."""
    with span("reorder"):
        with span("reorder.codes"):
            codes = hilbert_codes(mesh.coords[mesh.inpoel].mean(axis=1))
        with span("reorder.sort"):
            eorder = np.argsort(codes, kind="stable")
        with span("reorder.permute"):
            out = UnsMesh(coords=mesh.coords, inpoel=mesh.inpoel[eorder])
            out.bface = dict(mesh.bface)
            out.bnode = mesh.bnode
        return out, eorder


def first_touch_node_reorder(mesh: UnsMesh) -> Tuple[UnsMesh, np.ndarray]:
    """Renumber NODES by first appearance in element order (elements
    untouched); port of quinoa_tpu/mesh/reorder.py:99-132.

    With Hilbert-ordered elements each element's node ids sit near a
    sliding frontier, so the node gathers and slot sums of the CG kernels
    read nearby addresses (the reference's Sorter start-vector node
    order).  Returns (new mesh, nperm) with nperm old->new: nodal fields
    map as u_new[:, nperm] = u_old.
    """
    flat = mesh.inpoel.reshape(-1)
    first = np.full(mesh.nnode, -1, np.int64)
    # each node's first flat index, ranked: the sequential first-touch
    # scan without a Python loop
    uniq, fidx = np.unique(flat, return_index=True)
    order = np.argsort(fidx, kind="stable")
    first[uniq[order]] = np.arange(len(uniq))
    # isolated nodes (no element) keep their order at the end
    rest = np.nonzero(first < 0)[0]
    first[rest] = len(uniq) + np.arange(len(rest))
    nperm = first
    coords = np.empty_like(mesh.coords)
    coords[nperm] = mesh.coords
    out = UnsMesh(coords=coords, inpoel=nperm[mesh.inpoel])
    # bface triangles and bnode sets carry NODE ids: renumber both
    out.bface = {k: nperm[np.asarray(v)] for k, v in mesh.bface.items()}
    out.bnode = {k: nperm[np.asarray(v)] for k, v in mesh.bnode.items()}
    return out, nperm


def sfc_reorder(mesh: UnsMesh) -> Tuple[UnsMesh, np.ndarray, np.ndarray]:
    """Renumber nodes and elements along the Morton curve
    (quinoa_tpu/mesh/reorder.py:135).

    Returns (new mesh, node_perm, elem_perm) where node_perm[old] = new
    and elem_perm[old] = new, to remap fields with.
    """
    from ..parallel.partition import _morton_codes, element_centroids

    ncode = _morton_codes(mesh.coords)
    norder = np.argsort(ncode, kind="stable")  # new -> old
    node_perm = np.empty(mesh.nnode, dtype=np.int64)
    node_perm[norder] = np.arange(mesh.nnode)  # old -> new

    ecode = _morton_codes(element_centroids(mesh.coords, mesh.inpoel))
    eorder = np.argsort(ecode, kind="stable")
    elem_perm = np.empty(mesh.nelem, dtype=np.int64)
    elem_perm[eorder] = np.arange(mesh.nelem)

    out = UnsMesh(
        coords=mesh.coords[norder],
        inpoel=node_perm[mesh.inpoel[eorder]].astype(np.int32),
    )
    out.bface = {
        ss: node_perm[tris].astype(np.int32) for ss, tris in mesh.bface.items()
    }
    out.bnode = out.bnode_from_bface()
    return out, node_perm, elem_perm
