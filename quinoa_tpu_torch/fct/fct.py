"""Flux-corrected transport (FEM-FCT), feature-major layout, on torch.

Port of quinoa_tpu/fct/fct.py (reference FluxCorrector.cpp: aec 30, lump
238, diff 281, alw 339, lim 389) after Löhner, Morgan, Peraire, Vahdati
(1987), Int. J. Numer. Meth. Fluids 7:1093-1109.  Node fields are (C, N),
element slabs (4, C, E).  Gathers and assemblies go through cg_gather,
cg_assemble_add and node_assemble: K10 and K11 on a CUDA geometry, their
plain versions on a CPU one.

The low/high-order pair is the diagonally-lumped Taylor-Galerkin of
DiagCG: high order = lumped-mass TG (dUh enters the AEC as zero), low
order = high order + mass diffusion c_tau (M_c - M_L) Un.
"""

from __future__ import annotations

import torch

from ..ops.node_window import node_assemble
from ..pde.cg import CGGeom, cg_assemble_add, cg_gather


class FCT:
    """FEM-FCT limiter for the diagonally-lumped Taylor-Galerkin scheme."""

    def __init__(self, ctau: float = 1.0):
        #: mass-diffusion coefficient; 1.0 guarantees monotonicity
        self.ctau = ctau

    # (M_L - M_c) of a tet: diag 3J/120, off-diag -J/120; applied as
    # y_a = (J/120)(4 x_a - sum_b x_b)  (FluxCorrector.cpp aec/diff).

    def _mass_lumped_minus_consistent(self, geom: CGGeom, X):
        """(M_Le - M_ce) @ X per element: X (4, C, E) -> (4, C, E)."""
        j = (geom.J * geom.emask) / 120.0
        s = X.sum(dim=0)
        return j * (4.0 * X - s)

    def diff_contrib(self, geom: CGGeom, un):
        """Mass-diffusion element contributions (4, C, E) from the step's
        nodal gather: D_a = -c_tau (M_Le - M_ce) Un (diff:281-338)."""
        return -self.ctau * self._mass_lumped_minus_consistent(geom, un)

    def diff(self, geom: CGGeom, Un):
        """Mass-diffusion rhs of the low-order system, (C, N)."""
        un = cg_gather(geom, Un)
        return cg_assemble_add(geom, self.diff_contrib(geom, un))

    def aec(self, geom: CGGeom, dUh, Un, bcmask, un=None, bc_n=None,
            vol_n=None):
        """Antidiffusive element contributions and nodal P sums:
        (aec (4, C, E), P (2, C, N)) (aec:30-170)."""
        aec = self.aec_contrib(geom, dUh, Un, bcmask, un=un, bc_n=bc_n,
                               vol_n=vol_n)
        C = aec.shape[1]
        pn = cg_assemble_add(geom, torch.cat(
            [torch.clamp_min(aec, 0.0), torch.clamp_max(aec, 0.0)], dim=1))
        return aec, torch.stack([pn[:C], pn[C:]])

    def aec_contrib(self, geom: CGGeom, dUh, Un, bcmask, un=None,
                    bc_n=None, vol_n=None):
        """AEC = M_L^{-1} (M_Le - M_ce)(ctau Un + dUh), (4, C, E), zero at
        Dirichlet nodes; dUh enters as zero (lumped-mass high order).
        un, bc_n (4, C, E) and vol_n (4, E) are the gathers of Un, bcmask
        and the nodal volumes when the caller holds them."""
        if un is None:
            un = cg_gather(geom, Un)
        me = self._mass_lumped_minus_consistent(geom, self.ctau * un)
        if vol_n is None:
            vol_n = cg_gather(geom, geom.vol[None, :])[:, 0]
        aec = me / vol_n[:, None, :]
        if bc_n is None:
            bc_n = cg_gather(geom, bcmask)
        return torch.where(bc_n > 0, 0.0, aec)

    def alw(self, geom: CGGeom, Un, Ul):
        """Allowed max/min around nodes, Q (2, C, N) (alw:339-388): the
        extrema of the element extrema over the elements around each
        node; the min folds into the max pass by negation."""
        C = Un.shape[0]
        s_el = self.alw_contrib(geom, Un, Ul)
        q = node_assemble(None, s_el[None], geom.nsup)   # [qmax | -qmin]
        return torch.stack([q[:C], -q[C:]])

    def alw_contrib(self, geom: CGGeom, Un, Ul, un=None, uln=None):
        """Element extrema (2C, E) = [max_el | -min_el] of max/min(Ul, Un)
        over the element's nodes.  With un = gather(Un) and uln =
        gather(Ul) given, gather(max(Ul, Un)) = max(uln, un) elementwise
        and no gather of its own is needed."""
        big = torch.finfo(Un.dtype).max
        if un is not None and uln is not None:
            smax = torch.maximum(uln, un).amax(dim=0)
            smin = torch.minimum(uln, un).amin(dim=0)
            s_el = torch.cat([smax, -smin], dim=0)
        else:
            s = cg_gather(geom, torch.cat(
                [torch.maximum(Ul, Un), -torch.minimum(Ul, Un)], dim=0))
            s_el = s.amax(dim=0)
        return torch.where(geom.emask <= 0, -big, s_el)

    def lim(self, geom: CGGeom, aec, P, Q, Ul):
        """Limited antidiffusive contributions assembled to nodes, (C, N)
        (lim:389-470): the ratios R+ and R-, the element coefficient
        C_el = min(min over the element's corners of r, 1), times aec."""
        eps = torch.finfo(Ul.dtype).eps
        big = torch.finfo(Ul.dtype).max
        C = Ul.shape[0]
        Qp = Q[0] - Ul
        Qm = Q[1] - Ul
        Rp = torch.where(
            P[0] > 0.0,
            torch.clamp_max(Qp / torch.where(P[0] > 0.0, P[0], 1.0), 1.0),
            0.0)
        Rm = torch.where(
            P[1] < 0.0,
            torch.clamp_max(Qm / torch.where(P[1] < 0.0, P[1], 1.0), 1.0),
            0.0)
        rpm = cg_gather(geom, torch.cat([Rp, Rm], dim=0))   # (4, 2C, E)
        rp, rm = rpm[:, :C], rpm[:, C:]
        r = torch.where(aec.abs() < eps, big, torch.where(aec > 0.0, rp, rm))
        Cel = torch.clamp_max(r.amin(dim=0), 1.0)           # (C, E)
        return cg_assemble_add(geom, Cel[None] * aec)
