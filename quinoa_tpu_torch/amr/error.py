"""AMR error estimators and edge tagging.

The port's own copy of quinoa_tpu/amr/error.py (host-side numpy, the same
operations in the same order).

Counterpart of the reference's Error class (src/Inciter/AMR/Error.cpp):
- jump:    |u_a - u_b| / |u_a + u_b|          (error_jump:55-76)
- hessian: normalized second difference along the edge using nodal
           gradients (error_hessian), both mapped to [0, 1].

And Refiner's tagging modes (src/Inciter/Refiner.cpp:360-414): by error
threshold, by coordinate half-spaces (coordref), or all edges (uniform).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..mesh.derived import gen_inpoed
from ..mesh.geometry import einsum_jacobians, nodal_volumes, node_gradients


def edge_errors(
    mesh, u: np.ndarray, comp: int = 0, method: str = "jump",
    edges: np.ndarray | None = None
) -> np.ndarray:
    """Error indicator in [0,1] for every unique mesh edge.

    u : (C, N) nodal solution.  Pass `edges` (gen_inpoed output) to
    skip recomputing the unique-edge sort — it dominates the tagging
    wall-clock at remesh scale.
    """
    if edges is None:
        edges = gen_inpoed(mesh.inpoel)
    a, b = edges[:, 0], edges[:, 1]
    ua, ub = u[comp, a], u[comp, b]
    if method == "jump":
        norm = np.abs(ua + ub)
        err = np.where(norm < np.finfo(float).eps, 0.0,
                       np.abs(ua - ub) / np.where(norm > 0, norm, 1.0))
        return np.clip(err, 0.0, 1.0)
    if method == "hessian":
        vol = nodal_volumes(mesh.coords, mesh.inpoel, mesh.nnode,
                            J=einsum_jacobians(mesh.coords, mesh.inpoel))
        grad = node_gradients(mesh.coords, mesh.inpoel, vol, u.T)  # (N,C,3)
        dx = mesh.coords[b] - mesh.coords[a]
        # second difference: (grad_b - grad_a) . dx vs |u_a|+|u_b|
        d2 = np.abs(((grad[b, comp] - grad[a, comp]) * dx).sum(axis=1))
        norm = np.abs(ua) + np.abs(ub) + np.finfo(float).eps
        return np.clip(d2 / norm, 0.0, 1.0)
    raise ValueError(f"unknown AMR error method {method!r}")


def tag_edges_by_error(
    mesh, u, comp=0, method="jump", tol: float = 0.2
) -> np.ndarray:
    """Edges whose indicator exceeds tol (Refiner::errorRefine analog)."""
    edges = gen_inpoed(mesh.inpoel)
    err = edge_errors(mesh, u, comp, method, edges=edges)
    return edges[err > tol].astype(np.int64)


def tag_edges_by_coords(
    mesh,
    xminus: Optional[float] = None,
    xplus: Optional[float] = None,
    yminus: Optional[float] = None,
    yplus: Optional[float] = None,
    zminus: Optional[float] = None,
    zplus: Optional[float] = None,
) -> np.ndarray:
    """Edges inside the user's half-world (Refiner coordRefine /
    `initial coords` mode, Refiner.cpp:1094-1100): an edge is tagged
    unless BOTH endpoints lie strictly outside a configured halfspace —
    i.e. one endpoint touching the bound (<= for minus, >= for plus)
    keeps the edge tagged, and every configured halfspace can veto."""
    edges = gen_inpoed(mesh.inpoel)
    x = mesh.coords
    keep = np.ones(len(edges), dtype=bool)

    def not_both_outside(axis, outside):
        return ~(outside(x[edges[:, 0], axis])
                 & outside(x[edges[:, 1], axis]))

    if xminus is not None:
        keep &= not_both_outside(0, lambda v: v > xminus)
    if xplus is not None:
        keep &= not_both_outside(0, lambda v: v < xplus)
    if yminus is not None:
        keep &= not_both_outside(1, lambda v: v > yminus)
    if yplus is not None:
        keep &= not_both_outside(1, lambda v: v < yplus)
    if zminus is not None:
        keep &= not_both_outside(2, lambda v: v > zminus)
    if zplus is not None:
        keep &= not_both_outside(2, lambda v: v < zplus)
    return edges[keep].astype(np.int64)
