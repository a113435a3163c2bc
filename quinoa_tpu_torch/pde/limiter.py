"""Superbee slope limiter for DG(P1), the plain reference.

Port of quinoa_tpu/pde/limiter.py:43-108 (reference src/PDE/Limiter.cpp
Superbee_P1:154-317) for the case without a dofmask: scale the P1 dofs of
every (component, element) by a coefficient phi from the min/max of the
face neighbours' cell means, evaluated at all face quadrature points.
The limit + volume kernel (ops/nbr_bounds.py) computes the same phi.
"""

from __future__ import annotations

import torch

from .dg import uview


def neighbor_bounds(geom, u0):
    """(umin, umax) each (C, E): min/max over the element's own cell mean
    and its face neighbours' (esuelT, -1 = none)."""
    valid = geom.esuelT >= 0
    nbr = torch.where(valid, geom.esuelT, 0).long()
    big = torch.finfo(u0.dtype).max
    umax, umin = u0, u0
    for i in range(4):
        un = u0[:, nbr[i]]
        umax = torch.maximum(umax, torch.where(valid[i], un, -big))
        umin = torch.minimum(umin, torch.where(valid[i], un, big))
    return umin, umax


def _no_dofmask(dofmask):
    if dofmask is not None:
        raise NotImplementedError("p-adaptive (dofmask) limiting is not "
                                  "ported")


def superbee_phi(geom, U, dofmask, C, beta_lim: float = 2.0):
    """The per-(component, element) slope coefficient phi (C, E)."""
    _no_dofmask(dofmask)
    K = geom.ndof
    Uv = uview(U, C, K)
    u0 = Uv[:, 0, :]
    umin, umax = neighbor_bounds(geom, u0)

    B = geom.tables["B_selfface"]  # (4, G, K) numpy
    eps = 1.0e-14
    one = torch.ones_like(u0)
    phi = one
    for lf in range(4):
        for g in range(B.shape[1]):
            state = float(B[lf, g, 0]) * Uv[:, 0, :]
            for k in range(1, K):
                state = state + float(B[lf, g, k]) * Uv[:, k, :]
            uNeg = state - u0
            up = torch.minimum(
                one, (umax - u0) / (2.0 * torch.where(uNeg > eps, uNeg, one)))
            dn = torch.minimum(
                one, (umin - u0) / (2.0 * torch.where(uNeg < -eps, uNeg, one)))
            phi_gp = torch.where(uNeg > eps, up,
                                 torch.where(uNeg < -eps, dn, one))
            phi_gp = torch.clamp_min(
                torch.maximum(torch.clamp_max(beta_lim * phi_gp, 1.0),
                              torch.clamp_max(phi_gp, beta_lim)),
                0.0)
            phi = torch.minimum(phi, phi_gp)
    return phi


def superbee_p1(geom, U, dofmask, C, beta_lim: float = 2.0):
    """Superbee-limited copy of U (C*K, E): P1 dofs scaled by phi."""
    K = geom.ndof
    phi = superbee_phi(geom, U, dofmask, C, beta_lim)
    Uv = uview(U, C, K).clone()
    Uv[:, 1:4, :] = Uv[:, 1:4, :] * phi[:, None, :]
    return Uv.reshape(C * K, -1)
