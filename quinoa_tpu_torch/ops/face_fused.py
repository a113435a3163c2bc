"""The DG face pass: surface integral and the dt sweep's charvel.

Port of quinoa_tpu/ops/face_fused.py's two face passes.  The TPU versions
split faces into near/far streams or el- and er-sorted tile passes and
accumulate through one-hot window matmuls because a TPU core cannot gather
or scatter in HBM.  Here each pass is two kernels, one over faces and one
over elements:

- fused_face_pass (compressible Euler at DG(P0), DG(P1) and DG(P2), HLLC
  or Lax-Friedrichs; what the JAX package runs as the near/far pass
  fused_face_pass_nearfar or the single-stream fused_face_pass):
  K12 face_wflux (csrc/face_wflux.cu), the weighted flux (C*G, F) and the
  weighted charvel mx (F,); K13 basis_accum (csrc/basis_accum.cu), each
  element contracting its faces' weighted flux with its own basis and
  summing them on top of the volume term;
- mm_face_pass (multimat DG(P0) and DG(P1)): K14 mm_face_wflux
  (csrc/mm_face_wflux.cu), the multimat flavour of K12 (AUSM+up and the
  riemannDeriv rows, R = 3*nmat + 3 + 3*nmat + 1 a face point; at P1
  optionally with THINC interface sharpening), then K13 over those R
  rows.

On a CPU tensor each runs its plain torch version, in the kernel's
operation order.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..pde.dg import BC_INTERIOR, require_fused_physics, uview
from .basis import eval_basis_cm


def _face_points(system, geom, U):
    """Per face point g, in point order: (g, the Riemann flux fl (C, F),
    the weight wt = w_g * area * fmask (F,), the weighted charvel (F,))."""
    C, K = system.ncomp, geom.ndof
    Uv = uview(U, C, K)
    UvL = Uv[:, :, geom.el.long()]                       # (C,K,F)
    UvR = Uv[:, :, geom.er.long()]
    B_l = eval_basis_cm(K, geom.xi_l)                    # (K,G,F)
    B_r = eval_basis_cm(K, geom.xi_r)
    interior = geom.bctype == BC_INTERIOR
    valid = geom.fmask > 0
    fa = geom.farea * geom.fmask
    wface = geom.tables["w_face"]
    fn = geom.fn
    for g in range(len(wface)):
        sL = B_l[0, g] * UvL[:, 0]
        sR = B_r[0, g] * UvR[:, 0]
        for k in range(1, K):
            sL = sL + B_l[k, g] * UvL[:, k]
            sR = sR + B_r[k, g] * UvR[:, k]
        # pad faces carry a finite unit state (their weights are zero)
        sL = torch.where(valid, sL, 1.0)
        sR = torch.where(valid, sR, 1.0)
        sR = torch.where(interior, sR,
                         system.bc_state(geom.bctype, sL, fn, None, 0.0))
        fl = system.riemann(fn, sL, sR, None, 0.0)       # (C,F)
        wt = float(wface[g]) * fa
        vl = system.charvel(sL, fn)
        vr = system.charvel(sR, fn)
        m = wt * torch.where(interior, torch.maximum(vl, vr), vl)
        yield g, fl, wt, m


def delt_plain(geom, mx):
    """Per-element sum (E,) of the four faces' charvel mx (F,), in slot
    order (quinoa_tpu/pde/dg.py:489)."""
    delt = mx.new_zeros(geom.nelem)
    for i in range(4):
        delt = delt + mx[geom.fose[i].long()]
    return delt


def face_wflux_plain(system, geom, U):
    """K12's plain version: (wfl (C*G, F), mx (F,)), the weighted flux at
    each face point, row c*G + g as the JAX package's fused kernel writes
    it (quinoa_tpu/ops/face_fused.py:181), and the weighted charvel summed
    in point order."""
    wfl, mx = [], None
    for g, fl, wt, m in _face_points(system, geom, U):
        wfl.append(fl * wt)
        mx = m if g == 0 else mx + m
    return torch.stack(wfl, dim=1).reshape(-1, geom.nface), mx


def basis_accum_plain(geom, wfl, mx, rv=None):
    """K13's plain version: (acc (C*K, E), delt (E,)).  Each side's
    contraction sum_g B[:, g] * wfl[c*G + g] (in point order), then each
    element's four faces in slot order: plus on faces where it is the
    right side, minus where it is the left, on top of rv when given."""
    K = geom.ndof
    G = len(geom.tables["w_face"])
    C = wfl.shape[0] // G
    w = wfl.reshape(C, G, -1)
    sides = []
    for xi in (geom.xi_l, geom.xi_r):
        B = eval_basis_cm(K, xi)                         # (K,G,F)
        s = None
        for g in range(G):
            t = B[:, g][None] * w[:, g][:, None]         # (C,K,F)
            s = t if g == 0 else s + t
        sides.append(s.reshape(C * K, -1))
    sL, sR = sides
    acc = rv if rv is not None else wfl.new_zeros((C * K, geom.nelem))
    for i in range(4):
        f = geom.fose[i].long()
        acc = torch.where(geom.fsideR[i] > 0, acc + sR[:, f],
                          acc - sL[:, f])
    return acc, delt_plain(geom, mx)


def fused_face_pass(system, geom, U, vol_rhs=None):
    """The compressible-Euler face pass, DG(P0), DG(P1) or DG(P2): U (C*K,
    E) -> (acc (C*K, E), delt (E,)) through K12 + K13: the accumulated
    surface integral (plus vol_rhs when given, so acc is then the full
    rhs) and the per-element summed charvel of the dt sweep."""
    require_fused_physics(system, geom, face_pass=True, ndofs=(1, 4, 10),
                          fluxes=tuple(kernels.FLUXES))
    if U.device.type == "cpu":
        wfl, mx = face_wflux_plain(system, geom, U)
        return basis_accum_plain(geom, wfl, mx, vol_rhs)
    wfl, mx = kernels.face_wflux(U, geom.el, geom.er, geom.fn, geom.farea,
                                 geom.fmask, geom.xi_l, geom.xi_r,
                                 geom.bctype, geom.w_face, system.eos,
                                 system.riemann_flux)
    return kernels.basis_accum(wfl, mx, geom.fose, geom.fsideR, geom.xi_l,
                               geom.xi_r, geom.ndof, vol_rhs)


def mm_face_wflux_plain(system, geom, U, carriers=None):
    """K14's plain version, for a MultiMatSystem: (wfl (R*G, F), mx (F,)),
    R = C + 3*nmat + 1 rows a face point (the AUSM+up flux, -ap_k*n_i,
    -vriem; quinoa_tpu/pde/multimat.py _FusedMMFacade.riemann), weighted
    as K12's, and the weighted multimat charvel.  With the THINC carriers
    (8*nmat, E) of system.thinc_carriers, the face states carry them as
    5*nmat more rows of K modes (the JAX package's layout) and AUSM+up
    sees the sharpened states."""
    if carriers is None:
        return face_wflux_plain(system.facade, geom, U)
    C, K = system.ncomp, geom.ndof
    full = torch.cat([uview(U, C, K), system.thinc_modes(carriers, K)])
    return face_wflux_plain(system.thinc_facade, geom,
                            full.reshape(-1, U.shape[-1]))


def mm_face_pass(system, geom, U, carriers=None):
    """The multimat face pass, DG(P0) or DG(P1) on faces without a
    Dirichlet ghost: U (C*K, E) -> (acc (R*K, E), delt (E,)) through K14 +
    K13: the surface integral of the flux rows and the riemannDeriv and
    divergence sums, and the per-element summed charvel.  carriers (DG(P1)
    only) selects the THINC flavour of K14."""
    if geom.ndof not in (1, 4):
        raise NotImplementedError(f"ndof={geom.ndof}: the multimat face "
                                  "pass takes DG(P0) and DG(P1)")
    if geom.has_coord_bc:
        raise NotImplementedError("the multimat face kernel has no "
                                  "Dirichlet ghost")
    if carriers is not None and geom.ndof != 4:
        raise NotImplementedError("THINC is a DG(P1) face pass")
    if U.device.type == "cpu":
        wfl, mx = mm_face_wflux_plain(system, geom, U, carriers)
        return basis_accum_plain(geom, wfl, mx)
    wfl, mx = kernels.mm_face_wflux(U, geom.el, geom.er, geom.fn, geom.farea,
                                    geom.fmask, geom.xi_l, geom.xi_r,
                                    geom.bctype, geom.w_face, system.eos,
                                    carriers, system.thinc_beta)
    return kernels.basis_accum(wfl, mx, geom.fose, geom.fsideR, geom.xi_l,
                               geom.xi_r, geom.ndof)
