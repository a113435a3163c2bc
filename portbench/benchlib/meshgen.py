"""The benchmark's input generator: a box of hexahedra cut into six Kuhn
tetrahedra each, with side sets 1-6 on the x-lo, x-hi, y-lo, y-hi, z-lo
and z-hi walls, and every interior node moved from the seed.

A node moves by a vector whose components are drawn uniformly from
[-jitter, jitter] times the cell's edge along that axis, so the same seed
gives the same mesh; boundary nodes stay, so the walls stay planes and
the side sets exact.  At jitter <= 0.15 every tet keeps a positive volume
(min_volume_ratio checks it; the tests sweep seeds).
"""

from __future__ import annotations

import numpy as np

#: the six Kuhn tets of a hex with corners n0=(0,0,0) n1=(1,0,0) n2=(1,1,0)
#: n3=(0,1,0) n4=(0,0,1) n5=(1,0,1) n6=(1,1,1) n7=(0,1,1); all share n0-n6
KUHN = np.array([[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6],
                 [0, 4, 5, 6], [0, 5, 1, 6]])
#: outward local faces of a tet, face f opposite local node f
TET_FACES = np.array([[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]])


def _rng(seed: int):
    return np.random.default_rng(int(seed) % (1 << 64))


def box(dims, lo, hi, jitter: float, seed: int):
    """{coords (N, 3) float64, inpoel (E, 4) int32, bface {1..6: (n, 3)}}
    of a dims = (nx, ny, nz) box from lo to hi, interior nodes jittered."""
    nx, ny, nz = (int(d) for d in dims)
    axes = [np.linspace(lo[a], hi[a], n + 1) for a, n in enumerate(dims)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    I, J, Kk = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1),
                           np.arange(nz + 1), indexing="ij")
    inner = ((I > 0) & (I < nx) & (J > 0) & (J < ny) & (Kk > 0)
             & (Kk < nz)).ravel()
    h = (np.asarray(hi, float) - np.asarray(lo, float)) / np.asarray(dims)
    move = _rng(seed).uniform(-jitter, jitter, size=(int(inner.sum()), 3))
    coords[inner] += move * h

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, Kk = (a.ravel() for a in np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))
    corners = np.stack([nid(I, J, Kk), nid(I + 1, J, Kk),
                        nid(I + 1, J + 1, Kk), nid(I, J + 1, Kk),
                        nid(I, J, Kk + 1), nid(I + 1, J, Kk + 1),
                        nid(I + 1, J + 1, Kk + 1), nid(I, J + 1, Kk + 1)],
                       axis=1)
    inpoel = corners[:, KUHN].reshape(-1, 4).astype(np.int32)
    return dict(coords=coords, inpoel=inpoel,
                bface=_side_sets(coords, inpoel, lo, hi))


def _side_sets(coords, inpoel, lo, hi):
    """Outward boundary triangles grouped by wall."""
    tri = inpoel[:, TET_FACES].reshape(-1, 3)
    key = np.sort(tri, axis=1).astype(np.int64)
    pk = (key[:, 0] << 42) | (key[:, 1] << 21) | key[:, 2]
    _, inv, cnt = np.unique(pk, return_inverse=True, return_counts=True)
    bnd = tri[cnt[inv] == 1]
    ctr = coords[bnd].mean(axis=1)
    tol = 1e-9 * float(np.abs(np.asarray(hi) - np.asarray(lo)).max())
    sets = {}
    for ss, (ax, val) in enumerate([(0, lo[0]), (0, hi[0]), (1, lo[1]),
                                    (1, hi[1]), (2, lo[2]), (2, hi[2])], 1):
        sets[ss] = bnd[np.abs(ctr[:, ax] - val) < tol].astype(np.int32)
    return sets


def min_volume_ratio(mesh, dims, lo, hi):
    """The smallest tet volume over the unjittered Kuhn tet's (h^3 / 6)."""
    x = mesh["coords"][mesh["inpoel"]]
    d = np.linalg.det(np.stack([x[:, i] - x[:, 0] for i in (1, 2, 3)], axis=2))
    h = (np.asarray(hi, float) - np.asarray(lo, float)) / np.asarray(dims)
    return float(d.min() / np.prod(h))
