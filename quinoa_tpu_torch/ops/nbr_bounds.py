"""The limit + volume pass of the DG(P1) step: Superbee limiting and the
flux volume integral of the limited state.

Port of quinoa_tpu/ops/nbr_bounds.py superbee_limit_window(...,
emit_vol=True).  On a CUDA tensor it launches kernel K1
(csrc/limit_vol.cu); on a CPU tensor it runs limit_vol_plain, the same
computation in torch.  The TPU kernel's element windows, far-neighbour
gathers and one-hot placements exist to avoid HBM gathers on a TPU and
have no counterpart here: the kernel reads the neighbour means through
esuelT directly.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..pde.dg import require_slice, uview
from ..pde.limiter import superbee_p1


def volume_rhs_plain(system, geom, U):
    """Flux volume integral (C*K, E) of U, scaled by vol*emask, summed in
    the order of the JAX limit kernel (quinoa_tpu/ops/nbr_bounds.py
    :396-431; the quadrature of quinoa_tpu/pde/dg.py:342-370)."""
    C, K, E = system.ncomp, geom.ndof, U.shape[-1]
    tb = geom.tables
    Bv = tb["B_vol"]
    wdB = tb["w_vol"][:, None, None] * tb["dBdxi_vol"]
    Uv = uview(U, C, K)
    J = geom.jacInv
    rows = [U.new_zeros((C, E)) for _ in range(K)]
    for g in range(Bv.shape[0]):
        state = float(Bv[g, 0]) * Uv[:, 0]
        for k in range(1, K):
            state = state + float(Bv[g, k]) * Uv[:, k]
        Fj = system.flux_cols(state, None, 0.0)
        for m in range(3):
            fref = Fj[0] * J[m, 0] + Fj[1] * J[m, 1] + Fj[2] * J[m, 2]
            for k in range(K):
                w = float(wdB[g, k, m])
                if w != 0.0:
                    rows[k] = rows[k] + w * fref
    Rv = torch.stack(rows, dim=1) * (geom.vol * geom.emask)
    return Rv.reshape(C * K, E)


def limit_vol_plain(system, geom, U, beta_lim: float = 2.0):
    """K1's plain version: (Superbee-limited U, its volume integral)."""
    ulim = superbee_p1(geom, U, None, system.ncomp, beta_lim)
    return ulim, volume_rhs_plain(system, geom, ulim)


def superbee_limit_window(geom, U, system, beta_lim: float = 2.0):
    """U (C*K, E) -> (u_lim, vol_rhs), both (C*K, E): the P1 dofs scaled by
    the Superbee coefficient and the flux volume integral of the limited
    state (dg_rhs consumes it as vol_rhs)."""
    require_slice(system, geom)
    if U.device.type == "cpu":
        return limit_vol_plain(system, geom, U, beta_lim)
    return kernels.limit_vol(U, geom.esuelT, geom.jacInv,
                             geom.vol * geom.emask, geom.ktab, beta_lim,
                             system.eos)
