"""Slope limiters of the P1 dofs: WENO, Superbee (the plain reference of
the kernels) and its consistent multi-material adjustment.

Port of quinoa_tpu/pde/limiter.py.  WENO (reference src/PDE/Limiter.cpp
WENO_P1:29-152) blends each element's P1 dofs with its face neighbours'
by oscillation weights; the JAX package has no TPU kernel for it, so it
stays torch here.  Superbee (Superbee_P1:154-317) scales the P1 dofs of
every (component, element) by
a coefficient phi from the min/max of the face neighbours' cell means,
evaluated at all face quadrature points.  With a dofmask (p-adaptive DG)
the face states see only the active dofs and P0 elements keep their
state.  The limit + volume kernel (ops/nbr_bounds.py) computes the same
phi for the case without a dofmask.
"""

from __future__ import annotations

import torch

from ..ops.nbr_bounds import neighbor_mean_bounds_plain
from .dg import uview


def weno_p1(geom, U, dofmask, C, cweight: float = 30.0):
    """WENO-limited copy of U (C*K, E): every component's P1 dofs become the
    weighted mean of its own (central weight cweight) and its face
    neighbours' (weight 1, none across a boundary), each weight over
    (1e-8 + osc)^2 with osc the stencil's P1 magnitude; with a dofmask,
    elements whose P1 dofs are inactive keep U (quinoa_tpu/pde/limiter.py
    :16-40)."""
    K = geom.ndof
    E = U.shape[-1]
    Uv = uview(U, C, K)
    valid = (geom.esuelT >= 0).to(U.dtype)                 # (4,E)
    nbr = torch.where(geom.esuelT < 0, 0, geom.esuelT).long()
    g0 = Uv[:, 1:4, :]                                     # (C,3,E)
    stencils = [g0]
    wts = [torch.full((E,), cweight, dtype=U.dtype, device=U.device)]
    for i in range(4):
        stencils.append(g0[:, :, nbr[i]] * valid[i])
        wts.append(valid[i])
    osc = [torch.sqrt((s ** 2).sum(dim=1)) for s in stencils]   # (C,E)
    w = [wt * (1.0e-8 + o) ** -2 for wt, o in zip(wts, osc)]
    wtot = w[0]
    lim = w[0][:, None, :] * stencils[0]
    for wi, s in zip(w[1:], stencils[1:]):
        wtot = wtot + wi
        lim = lim + wi[:, None, :] * s
    lim = lim / wtot[:, None, :]
    Unew = torch.cat([Uv[:, :1], lim, Uv[:, 4:]], dim=1).reshape(C * K, E)
    if dofmask is None:
        return Unew
    return torch.where(dofmask[1] > 0, Unew, U)


def superbee_phi(geom, U, dofmask, C, beta_lim: float = 2.0, bounds=None):
    """The per-(component, element) slope coefficient phi (C, E).

    bounds: optional precomputed (umin, umax), e.g. from
    ops/nbr_bounds.py neighbor_mean_bounds (kernel K4 on a card);
    without it the bounds come from the plain esuelT gather."""
    K = geom.ndof
    Uv = uview(U, C, K)
    Um = Uv if dofmask is None else Uv * dofmask[None]
    u0 = Uv[:, 0, :]
    umin, umax = (neighbor_mean_bounds_plain(geom, u0) if bounds is None
                  else bounds)

    B = geom.tables["B_selfface"]  # (4, G, K) numpy
    eps = 1.0e-14
    one = torch.ones_like(u0)
    phi = one
    for lf in range(4):
        for g in range(B.shape[1]):
            state = float(B[lf, g, 0]) * Um[:, 0, :]
            for k in range(1, K):
                state = state + float(B[lf, g, k]) * Um[:, k, :]
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


def superbee_p1(geom, U, dofmask, C, beta_lim: float = 2.0, bounds=None):
    """Superbee-limited copy of U (C*K, E): P1 dofs scaled by phi; with a
    dofmask, elements whose P1 dofs are inactive keep U."""
    K = geom.ndof
    phi = superbee_phi(geom, U, dofmask, C, beta_lim, bounds)
    Uv = uview(U, C, K).clone()
    Uv[:, 1:4, :] = Uv[:, 1:4, :] * phi[:, None, :]
    Unew = Uv.reshape(C * K, -1)
    if dofmask is None:
        return Unew
    return torch.where(dofmask[1] > 0, Unew, U)


def consistent_mm_phi(phi, nmat):
    """Consistent material-fraction limiting for multi-material DG(P1)
    (quinoa_tpu/pde/limiter.py:111; the TVD analog of upstream Quinoa's
    consistentMultiMatLimiting_P1): every volume-fraction slope scales by
    the same coefficient, the smallest of the fractions' (only a uniform
    scaling keeps the zero total alpha slope zero), and the material
    density and energy slopes are cut at least as hard.  Momentum rows keep
    their own.  phi (C, E) in the MultiMatIndexing layout -> (C, E)."""
    C = phi.shape[0]
    phi_al = phi[:nmat].amin(dim=0)                      # (E,)
    return torch.cat([
        phi_al.expand(nmat, -1),
        torch.minimum(phi[nmat:2 * nmat], phi_al),
        phi[2 * nmat:2 * nmat + 3],
        torch.minimum(phi[2 * nmat + 3:C], phi_al),
    ])
