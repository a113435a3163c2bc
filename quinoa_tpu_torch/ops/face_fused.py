"""The DG(P1) face pass: surface integral and the dt sweep's charvel.

Port of quinoa_tpu/ops/face_fused.py fused_face_pass_nearfar.  The TPU
version splits faces into near/far streams and accumulates through
one-hot window matmuls because a TPU core cannot gather or scatter in HBM.
Here the pass is two kernels:

- K2 face_flux (csrc/face_flux.cu), one thread per face: the per-face
  contributions contribL/contribR (C*K, F) and the weighted charvel mx (F,);
- K3 face_to_elem (csrc/face_to_elem.cu), one thread per element: the sum
  of its four faces through fose/fsideR, plus the volume term.

On a CPU tensor each runs its plain torch version (face_flux_plain,
face_to_elem_plain), the gather formulation of quinoa_tpu/pde/dg.py.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..pde.dg import BC_INTERIOR, require_fused_physics, uview
from .basis import eval_basis_cm
from .face_accum import accumulate_faces_plain


def face_flux_plain(system, geom, U):
    """K2's plain version: (contribL, contribR, mx), summed over the G
    face points in point order as the kernel does."""
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
    cL = cR = mx = None
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
        wfl = fl * wt                                    # (C,F)
        tl = B_l[:, g][None] * wfl[:, None]              # (C,K,F)
        tr = B_r[:, g][None] * wfl[:, None]
        if g == 0:
            cL, cR, mx = tl, tr, m
        else:
            cL, cR, mx = cL + tl, cR + tr, mx + m
    return -cL.reshape(C * K, -1), cR.reshape(C * K, -1), mx


def face_to_elem_plain(geom, contribL, contribR, mx, rv=None):
    """K3's plain version: each element gathers its four faces in slot
    order (quinoa_tpu/pde/dg.py:446-449, :489); returns (r, delt)."""
    return (accumulate_faces_plain(geom, contribL, contribR, rv),
            delt_plain(geom, mx))


def delt_plain(geom, mx):
    """Per-element sum (E,) of the four faces' charvel mx (F,), in slot
    order (quinoa_tpu/pde/dg.py:489)."""
    delt = mx.new_zeros(geom.nelem)
    for i in range(4):
        delt = delt + mx[geom.fose[i].long()]
    return delt


def fused_face_pass(system, geom, U, vol_rhs=None):
    """U (C*K, E) -> (acc (C*K, E), delt (E,)): the accumulated surface
    integral (plus vol_rhs when given, so acc is then the full rhs) and
    the per-element summed charvel of the dt sweep."""
    require_fused_physics(system, geom, face_pass=True)
    if U.device.type == "cpu":
        cL, cR, mx = face_flux_plain(system, geom, U)
        return face_to_elem_plain(geom, cL, cR, mx, vol_rhs)
    cL, cR, mx = kernels.face_flux(U, geom.el, geom.er, geom.fn, geom.farea,
                                   geom.fmask, geom.xi_l, geom.xi_r,
                                   geom.bctype, geom.ktab, system.eos)
    return kernels.face_to_elem(cL, cR, mx, geom.fose, geom.fsideR, vol_rhs)
