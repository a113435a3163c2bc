"""Dubiner (orthogonal tetrahedral) basis functions, up to P2.

Port of quinoa_tpu/ops/basis.py.  The reference-space derivatives dB/dxi
are written out in closed form (the P1/P2 Dubiner polynomials are at most
quadratic), where the JAX package differentiates eval_basis with jacfwd.
Functions take torch tensors; the host-side tables pass float64 tensors made
from numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _basis_list(ndof: int, x, e, z):
    one = torch.ones_like(x)
    B = [one]
    if ndof > 1:
        B += [
            2.0 * x + e + z - 1.0,
            3.0 * e + z - 1.0,
            4.0 * z - 1.0,
        ]
    if ndof > 4:
        B += [
            6 * x * x + e * e + z * z + 6 * x * e + 6 * x * z + 2 * e * z
            - 6 * x - 2 * e - 2 * z + 1,
            5 * e * e + z * z + 10 * x * e + 2 * x * z + 6 * e * z
            - 2 * x - 6 * e - 2 * z + 1,
            6 * z * z + 12 * x * z + 6 * e * z - 2 * x - e - 7 * z + 1,
            10 * e * e + z * z + 8 * e * z - 8 * e - 2 * z + 1,
            6 * z * z + 18 * e * z - 3 * e - 7 * z + 1,
            15 * z * z - 10 * z + 1,
        ]
    return B


def eval_basis(ndof: int, xi: torch.Tensor) -> torch.Tensor:
    """Dubiner basis at reference coordinates xi (..., 3) -> (..., ndof)."""
    return torch.stack(_basis_list(ndof, xi[..., 0], xi[..., 1], xi[..., 2]),
                       dim=-1)


def eval_basis_cm(ndof: int, xi: torch.Tensor) -> torch.Tensor:
    """Component-major basis: xi (3, ...) -> (ndof, ...)."""
    return torch.stack(_basis_list(ndof, xi[0], xi[1], xi[2]))


def eval_dbdxi(ndof: int, xi: torch.Tensor) -> torch.Tensor:
    """dB/dxi at reference coordinates xi (..., 3) -> (..., ndof, 3)."""
    x, e, z = xi[..., 0], xi[..., 1], xi[..., 2]
    zero = torch.zeros_like(x)

    def c(v):
        return torch.full_like(x, float(v))

    rows = [(zero, zero, zero)]
    if ndof > 1:
        rows += [(c(2), c(1), c(1)), (zero, c(3), c(1)), (zero, zero, c(4))]
    if ndof > 4:
        rows += [
            (12 * x + 6 * e + 6 * z - 6, 2 * e + 6 * x + 2 * z - 2,
             2 * z + 6 * x + 2 * e - 2),
            (10 * e + 2 * z - 2, 10 * e + 10 * x + 6 * z - 6,
             2 * z + 2 * x + 6 * e - 2),
            (12 * z - 2, 6 * z - 1, 12 * z + 12 * x + 6 * e - 7),
            (zero, 20 * e + 8 * z - 8, 2 * z + 8 * e - 2),
            (zero, 18 * z - 3, 12 * z + 18 * e - 7),
            (zero, zero, 30 * z - 10),
        ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def eval_basis_np(ndof: int, xi: np.ndarray) -> np.ndarray:
    """eval_basis on a float64 numpy array (host-side table builds)."""
    return eval_basis(ndof, torch.from_numpy(np.asarray(xi, np.float64))
                      ).numpy()


def mass_diag(ndof: int) -> np.ndarray:
    """Normalized diagonal mass entries m_k = (1/V) int B_k^2 dV on the
    reference tet (1, 1/10, 3/10, 3/5, ...), with the 14-point rule."""
    from .quadrature import gauss_tet

    pts, w = gauss_tet(14)
    B = eval_basis_np(ndof, pts)
    return (w[:, None] * B * B).sum(axis=0)
