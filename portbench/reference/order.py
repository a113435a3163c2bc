"""The element order of the reference: elements sorted along the Hilbert
curve of their centroids (Skilling's transpose algorithm at 16 bits an
axis), the locality pass of Quinoa's Sorter.  The order sets which element
of a face is its left side (the lower rank), and the DG step depends on
that side where a face state has a negative pressure (the Riemann flux's
branches then fall through on NaN), so the reference orders its elements
as Quinoa does before it builds faces."""

from __future__ import annotations

import numpy as np


def hilbert_codes(pts: np.ndarray, bits: int = 16) -> np.ndarray:
    """Hilbert-curve index (uint64) of 3-D points (n, 3)."""
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


def hilbert_order(coords, inpoel):
    """new -> old element order: the stable sort of the centroids'
    Hilbert codes."""
    centroids = np.asarray(coords)[np.asarray(inpoel)].mean(axis=1)
    return np.argsort(hilbert_codes(centroids), kind="stable")
