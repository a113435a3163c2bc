"""The limiter's element passes: neighbour-mean bounds, and the fused
limit + volume pass of the DG(P1) Euler step.

Port of quinoa_tpu/ops/nbr_bounds.py:

- neighbor_mean_bounds: min/max of each element's own cell mean and its
  face neighbours'.  On a CUDA tensor it launches kernel K4
  (csrc/nbr_bounds.cu); on a CPU tensor it runs
  neighbor_mean_bounds_plain.  The split limiter route (DG(P2), systems
  other than compressible Euler) takes it.
- superbee_limit_window: Superbee limiting and the flux volume integral
  of the limited state in one pass, p-adaptive when given each element's
  dof count (ndofel).  On a CUDA tensor it launches kernel K1
  (csrc/limit_vol.cu); on a CPU tensor it runs limit_vol_plain.

The TPU kernels' element windows, far-neighbour gathers and one-hot
placements exist to avoid HBM gathers on a TPU and have no counterpart
here: the kernels read the neighbour means through esuelT directly.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..pde.dg import dofmask_of, require_fused_physics, uview


def neighbor_mean_bounds_plain(geom, u0):
    """K4's plain version: (umin, umax) each (C, E), min/max over the
    element's own cell mean u0 (C, E) and its face neighbours' (esuelT,
    -1 = none)."""
    valid = geom.esuelT >= 0
    nbr = torch.where(valid, geom.esuelT, 0).long()
    big = torch.finfo(u0.dtype).max
    umax, umin = u0, u0
    for i in range(4):
        un = u0[:, nbr[i]]
        umax = torch.maximum(umax, torch.where(valid[i], un, -big))
        umin = torch.minimum(umin, torch.where(valid[i], un, big))
    return umin, umax


def neighbor_mean_bounds(geom, U, C):
    """U (C*K, E) -> (umin, umax) each (C, E): the Superbee limiter's
    allowed bounds (Limiter.cpp:156-200) from the cell means U[c*K]."""
    if U.device.type == "cpu":
        return neighbor_mean_bounds_plain(geom, uview(U, C, geom.ndof)[:, 0])
    return kernels.nbr_bounds(U, geom.esuelT, C, geom.ndof)


def volume_rhs_plain(system, geom, U, t=0.0):
    """Flux volume integral (C*K, E) of U, scaled by vol*emask, summed in
    the order of the JAX limit kernel (quinoa_tpu/ops/nbr_bounds.py
    :396-431; the quadrature of quinoa_tpu/pde/dg.py:342-370).  A system
    whose flux samples coordinates gets the volume Gauss points."""
    C, K, E = system.ncomp, geom.ndof, U.shape[-1]
    tb = geom.tables
    Bv = tb["B_vol"]
    wdB = tb["w_vol"][:, None, None] * tb["dBdxi_vol"]
    coord_free = getattr(system, "coord_free_flux", False)
    Uv = uview(U, C, K)
    J = geom.jacInv
    rows = [U.new_zeros((C, E)) for _ in range(K)]
    for g in range(Bv.shape[0]):
        state = float(Bv[g, 0]) * Uv[:, 0]
        for k in range(1, K):
            state = state + float(Bv[g, k]) * Uv[:, k]
        gp = None if coord_free else geom.vol_gp[:, g]
        Fj = system.flux_cols(state, gp, t)
        for m in range(3):
            fref = Fj[0] * J[m, 0] + Fj[1] * J[m, 1] + Fj[2] * J[m, 2]
            for k in range(K):
                w = float(wdB[g, k, m])
                if w != 0.0:
                    rows[k] = rows[k] + w * fref
    Rv = torch.stack(rows, dim=1) * (geom.vol * geom.emask)
    return Rv.reshape(C * K, E)


def limit_vol_plain(system, geom, U, beta_lim: float = 2.0, ndofel=None):
    """K1's plain version: (Superbee-limited U, its volume integral).
    With ndofel (E,), the p-adaptive sequence: Superbee with the dofmask,
    the limited state times the dofmask, and the volume integral of that
    masked state."""
    from ..pde.limiter import superbee_p1

    C = system.ncomp
    if ndofel is None:
        ulim = superbee_p1(geom, U, None, C, beta_lim)
    else:
        dofmask = dofmask_of(ndofel, geom.ndof, U.dtype)
        ulim = superbee_p1(geom, U, dofmask, C, beta_lim)
        ulim = ulim * dofmask.repeat(C, 1)
    return ulim, volume_rhs_plain(system, geom, ulim)


def superbee_limit_window(geom, U, system, beta_lim: float = 2.0,
                          ndofel=None):
    """U (C*K, E) -> (u_lim, vol_rhs), both (C*K, E): the P1 dofs scaled by
    the Superbee coefficient and the flux volume integral of the limited
    state (dg_rhs consumes it as vol_rhs).  With ndofel (E,) int32 (1 or
    4 at P1), u_lim is masked by each element's active dofs and
    vol_rhs is that of the masked state on every active row; a P0
    element's inactive rows of vol_rhs are the plain version's on a CPU
    and zero on a card (the step's restore drops them)."""
    require_fused_physics(system, geom)
    if U.device.type == "cpu":
        return limit_vol_plain(system, geom, U, beta_lim, ndofel)
    return kernels.limit_vol(U, geom.esuelT, geom.jacInv,
                             geom.vol * geom.emask, geom.ktab, beta_lim,
                             system.eos, ndofel)
