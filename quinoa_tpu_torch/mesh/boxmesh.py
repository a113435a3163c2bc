"""Structured box -> tetrahedral mesh generator.

The port's own copy of quinoa_tpu/mesh/boxmesh.py: the unit-box tet meshes
that stand in for the reference's committed regression meshes, each hex
cut into the six Kuhn tets, with six outward-oriented boundary side sets.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .derived import _TET_FACES, gen_esuel
from .unsmesh import UnsMesh

# The 6-tet (Kuhn) subdivision of a hexahedron.  Local hex corners:
#   n0=(0,0,0) n1=(1,0,0) n2=(1,1,0) n3=(0,1,0)
#   n4=(0,0,1) n5=(1,0,1) n6=(1,1,1) n7=(0,1,1)
# All six tets share the main diagonal n0-n6 and have positive Jacobians.
_KUHN_TETS = np.array(
    [[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
     [0, 5, 1, 6]],
    dtype=np.int32,
)


def box_tet_mesh(
    nx: int,
    ny: int,
    nz: int,
    lo: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    hi: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> UnsMesh:
    """Tet mesh of a box: nx*ny*nz hex cells, 6 tets each, with side sets
    1..6 for x-lo, x-hi, y-lo, y-hi, z-lo, z-hi."""
    if min(nx, ny, nz) < 1:
        raise ValueError("need at least one cell per direction")

    xs = np.linspace(lo[0], hi[0], nx + 1)
    ys = np.linspace(lo[1], hi[1], ny + 1)
    zs = np.linspace(lo[2], hi[2], nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    corners = np.stack(
        [nid(I, J, K), nid(I + 1, J, K), nid(I + 1, J + 1, K),
         nid(I, J + 1, K), nid(I, J, K + 1), nid(I + 1, J, K + 1),
         nid(I + 1, J + 1, K + 1), nid(I, J + 1, K + 1)],
        axis=1,
    ).astype(np.int64)
    inpoel = corners[:, _KUHN_TETS].reshape(-1, 4).astype(np.int32)

    mesh = UnsMesh(coords=coords, inpoel=inpoel)
    mesh.bface = _box_side_sets(mesh, lo, hi)
    mesh.bnode = mesh.bnode_from_bface()
    return mesh


def _box_side_sets(mesh: UnsMesh, lo, hi) -> dict:
    """Boundary triangles of a box mesh grouped by box face."""
    esuel = gen_esuel(mesh.inpoel, mesh.nnode)
    e_idx, f_idx = np.nonzero(esuel < 0)
    tris = mesh.inpoel[e_idx[:, None], _TET_FACES[f_idx]]  # (nbf,3) outward

    ctr = mesh.coords[tris].mean(axis=1)
    span = np.array(hi) - np.array(lo)
    tol = 1e-9 * np.abs(span).max()
    planes = [(0, lo[0]), (0, hi[0]), (1, lo[1]), (1, hi[1]), (2, lo[2]),
              (2, hi[2])]
    sets = {}
    for ss, (ax, val) in enumerate(planes, start=1):
        m = np.abs(ctr[:, ax] - val) < tol
        sets[ss] = tris[m].astype(np.int32)
    return sets
