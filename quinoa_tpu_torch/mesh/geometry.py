"""Tetrahedral element geometry (host side, float64 numpy).

The port's own copy of quinoa_tpu/mesh/geometry.py's tet_geometry,
nodal_volumes and node_gradients (reference tk::crossdiv element loops,
src/PDE/CompFlow/CGCompFlow.hpp:191-348, Discretization::vol and
tk::nodegrad).  Each expression is written in the operation order of the
JAX package's native pass (native/quinoa_native.cpp), so both give the
same float64 bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _cross3(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Row-wise 3-D cross product of (E, 3) arrays."""
    out = np.empty_like(u)
    out[:, 0] = u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1]
    out[:, 1] = u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2]
    out[:, 2] = u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]
    return out


def _dot3(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    return u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1] + u[:, 2] * v[:, 2]


def tet_geometry(coords: np.ndarray,
                 inpoel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Element Jacobians J (E,) = 6 * volume and P1 shape-function
    gradients grad (E, 4, 3): grad[e,1] = (ca x da)/J, grad[e,2] =
    (da x ba)/J, grad[e,3] = (ba x ca)/J, grad[e,0] = -sum(others)."""
    xyz = coords[inpoel]                     # one (E, 4, 3) gather
    A = xyz[:, 0]
    ba = xyz[:, 1] - A
    ca = xyz[:, 2] - A
    da = xyz[:, 3] - A
    baca = _cross3(ba, ca)
    J = _dot3(baca, da)
    Jc = J[:, None]
    grad = np.empty((len(J), 4, 3))
    grad[:, 1] = _cross3(ca, da) / Jc
    grad[:, 2] = _cross3(da, ba) / Jc
    grad[:, 3] = baca / Jc
    grad[:, 0] = -(grad[:, 1] + grad[:, 2] + grad[:, 3])
    return J, grad


def nodal_volumes(coords: np.ndarray, inpoel: np.ndarray, nnode: int,
                  J: Optional[np.ndarray] = None) -> np.ndarray:
    """Nodal dual volumes v_p = sum_e J_e/24 over the elements holding p,
    summed in element order."""
    if J is None:
        J, _ = tet_geometry(coords, inpoel)
    return np.bincount(inpoel.ravel(), weights=np.repeat(J / 24.0, 4),
                       minlength=nnode)


def einsum_jacobians(coords: np.ndarray, inpoel: np.ndarray) -> np.ndarray:
    """Element Jacobians as the JAX package's nodal_volumes computes them
    when it is given none (an einsum dot, which differs from
    tet_geometry's by an ulp in some elements): the AMR hessian error
    reads nodal volumes of these."""
    A = coords[inpoel[:, 0]]
    ba = coords[inpoel[:, 1]] - A
    ca = coords[inpoel[:, 2]] - A
    da = coords[inpoel[:, 3]] - A
    return np.einsum("ij,ij->i", _cross3(ba, ca), da)


def node_gradients(coords: np.ndarray, inpoel: np.ndarray, vol: np.ndarray,
                   U: np.ndarray) -> np.ndarray:
    """Dual-volume-weighted nodal gradients (nnode, ncomp, 3) of nodal
    fields U (nnode, ncomp): the volume average over the elements around
    a node of the element gradient of the P1 interpolant (tk::nodegrad,
    src/Mesh/Gradients.hpp:31-46), summed corner 0, 1, 2, then 3."""
    nnode = coords.shape[0]
    J, grad = tet_geometry(coords, inpoel)
    ue = U[inpoel]                                    # (E, 4, C)
    egrad = np.einsum("eac,ead->ecd", ue, grad)       # (E, C, 3)
    w = (J / 24.0)[:, None, None] * egrad             # quarter volume
    out = np.zeros((nnode,) + w.shape[1:])
    np.add.at(out, inpoel[:, 0], w)
    np.add.at(out, inpoel[:, 1], w)
    np.add.at(out, inpoel[:, 2], w)
    np.add.at(out, inpoel[:, 3], w)
    return out / vol[:, None, None]
