"""Hilbert element reordering, jax-free.

Port of quinoa_tpu/mesh/reorder.py:32-96.  That module cannot be imported
here: it imports quinoa_tpu.parallel.partition, whose package imports jax.
The Hilbert order keeps face neighbours close in element rank (the
reference's Sorter/Reorder locality pass), which on the card keeps the
neighbour reads of the limit and face kernels within nearby cache lines.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from quinoa_tpu.mesh.unsmesh import UnsMesh


def hilbert_codes(pts: np.ndarray, bits: int = 16) -> np.ndarray:
    """Hilbert-curve index of 3-D points (Skilling's transpose algorithm,
    vectorized); the native C++ pass gives identical codes when built."""
    from quinoa_tpu.native import hilbert_codes as _native_hc

    nat = _native_hc(pts, bits)
    if nat is not None:
        return nat
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
    mesh.inpoel[eorder[i]]."""
    centroids = mesh.coords[mesh.inpoel].mean(axis=1)
    eorder = np.argsort(hilbert_codes(centroids), kind="stable")
    out = UnsMesh(coords=mesh.coords, inpoel=mesh.inpoel[eorder])
    out.bface = dict(mesh.bface)
    out.bnode = mesh.bnode
    return out, eorder
