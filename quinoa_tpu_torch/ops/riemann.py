"""Riemann solvers on component-major torch tensors.

Port of quinoa_tpu/ops/riemann.py (reference src/PDE/Integrate/Riemann/
{HLLC,LaxFriedrichs,Upwind}.hpp).  States are (C, ...), normals (3, ...).  The
face kernel (csrc/face_wflux.cu, csrc/common.cuh) evaluates hllc and
lax_friedrichs in the same operation order, so the two agree bit for bit
on the card.
"""

from __future__ import annotations

import torch


def _prim(u, eos):
    rho = u[0]
    vel = u[1:4] / rho
    p = eos.pressure(rho, vel[0], vel[1], vel[2], u[4])
    a = eos.soundspeed(rho, p)
    return rho, vel, p, a


def _dot3(a, fn):
    """(a * fn).sum(0) over the 3 axis rows, summed in row order."""
    return a[0] * fn[0] + a[1] * fn[1] + a[2] * fn[2]


def _normal_flux(u, p, vn, fn):
    """Physical Euler flux projected on the face normal: (5, ...)."""
    return torch.stack(
        [
            u[0] * vn,
            u[1] * vn + p * fn[0],
            u[2] * vn + p * fn[1],
            u[3] * vn + p * fn[2],
            (u[4] + p) * vn,
        ]
    )


def lax_friedrichs(fn, uL, uR, eos):
    """Rusanov/Lax-Friedrichs flux (LaxFriedrichs.hpp:27-95)."""
    rhoL, velL, pL, aL = _prim(uL, eos)
    rhoR, velR, pR, aR = _prim(uR, eos)
    vnL = _dot3(velL, fn)
    vnR = _dot3(velR, fn)
    fl = _normal_flux(uL, pL, vnL, fn)
    fr = _normal_flux(uR, pR, vnR, fn)
    lam = torch.maximum(aL, aR) + torch.maximum(vnL.abs(), vnR.abs())
    return 0.5 * (fl + fr - lam * (uR - uL))


def hllc(fn, uL, uR, eos):
    """HLLC flux with Roe-averaged signal velocities (HLLC.hpp:29-134)."""
    rhoL, velL, pL, aL = _prim(uL, eos)
    rhoR, velR, pR, aR = _prim(uR, eos)
    vnL = _dot3(velL, fn)
    vnR = _dot3(velR, fn)

    rlr = torch.sqrt(rhoR / rhoL)
    rlr1 = 1.0 + rlr
    vnroe = (vnR * rlr + vnL) / rlr1
    aroe = (aR * rlr + aL) / rlr1

    Sl = torch.minimum(vnL - aL, vnroe - aroe)
    Sr = torch.maximum(vnR + aR, vnroe + aroe)
    Sm = (rhoR * vnR * (Sr - vnR) - rhoL * vnL * (Sl - vnL) + pL - pR) / (
        rhoR * (Sr - vnR) - rhoL * (Sl - vnL)
    )

    pStar = rhoL * (vnL - Sl) * (vnL - Sm) + pL

    def star(u, rho, vn, p, S):
        w = S - vn
        den = S - Sm
        return torch.stack(
            [
                w * rho / den,
                (w * u[1] + (pStar - p) * fn[0]) / den,
                (w * u[2] + (pStar - p) * fn[1]) / den,
                (w * u[3] + (pStar - p) * fn[2]) / den,
                (w * u[4] - p * vn + pStar * Sm) / den,
            ]
        )

    uStarL = star(uL, rhoL, vnL, pL, Sl)
    uStarR = star(uR, rhoR, vnR, pR, Sr)

    fL = _normal_flux(uL, pL, vnL, fn)
    fR = _normal_flux(uR, pR, vnR, fn)
    fStarL = _normal_flux(uStarL, pStar, Sm, fn)
    fStarR = _normal_flux(uStarR, pStar, Sm, fn)

    return torch.where(
        Sl > 0.0,
        fL,
        torch.where(Sm > 0.0, fStarL, torch.where(Sr >= 0.0, fStarR, fR)),
    )


def upwind(fn, uL, uR, vel):
    """Scalar upwind flux with prescribed velocity (Upwind.hpp:25-64).

    vel (C, 3, ...), uL/uR (C, ...), fn (3, ...) -> (C, ...).
    """
    swave = _dot3(vel.movedim(1, 0), fn)
    splus = 0.5 * (swave + swave.abs())
    sminus = 0.5 * (swave - swave.abs())
    return splus * uL + sminus * uR
