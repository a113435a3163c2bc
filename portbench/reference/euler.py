"""Compressible Euler with an ideal gas: the flux, HLLC (Quinoa's
src/PDE/Integrate/Riemann/HLLC.hpp with Roe-averaged signal speeds), the
symmetry and extrapolation ghosts and the characteristic speed, on
component-major states (5, ...)."""

from __future__ import annotations

import torch

from .geometry import BC_SYMMETRY


def dot3(a, n):
    return a[0] * n[0] + a[1] * n[1] + a[2] * n[2]


class Euler:
    ncomp = 5

    def __init__(self, gamma: float, initialize):
        self.gamma = gamma
        self._init = initialize

    def initialize(self, xyz):
        return self._init(xyz, self)

    def pressure(self, u):
        rho = u[0]
        v = u[1:4] / rho
        return (u[4] - 0.5 * rho * (v[0] * v[0] + v[1] * v[1] + v[2] * v[2])) \
            * (self.gamma - 1.0)

    def soundspeed(self, rho, p):
        return torch.sqrt(self.gamma * p / rho)

    def flux_cols(self, s):
        p = self.pressure(s)
        cols = []
        for j in range(3):
            vj = s[1 + j] / s[0]
            cols.append(torch.stack([
                s[1 + j], s[1] * vj + (p if j == 0 else 0.0),
                s[2] * vj + (p if j == 1 else 0.0),
                s[3] * vj + (p if j == 2 else 0.0), (s[4] + p) * vj]))
        return cols

    @staticmethod
    def _normal_flux(u, p, vn, n):
        return torch.stack([u[0] * vn, u[1] * vn + p * n[0],
                            u[2] * vn + p * n[1], u[3] * vn + p * n[2],
                            (u[4] + p) * vn])

    def riemann(self, n, uL, uR):
        rl, rr = uL[0], uR[0]
        pl, pr = self.pressure(uL), self.pressure(uR)
        al, ar = self.soundspeed(rl, pl), self.soundspeed(rr, pr)
        vnl, vnr = dot3(uL[1:4] / rl, n), dot3(uR[1:4] / rr, n)
        rlr = torch.sqrt(rr / rl)
        vroe = (vnr * rlr + vnl) / (1.0 + rlr)
        aroe = (ar * rlr + al) / (1.0 + rlr)
        sl = torch.minimum(vnl - al, vroe - aroe)
        sr = torch.maximum(vnr + ar, vroe + aroe)
        sm = (rr * vnr * (sr - vnr) - rl * vnl * (sl - vnl) + pl - pr) / (
            rr * (sr - vnr) - rl * (sl - vnl))
        pstar = rl * (vnl - sl) * (vnl - sm) + pl

        def star(u, rho, vn, p, s):
            w, den = s - vn, s - sm
            return torch.stack([w * rho / den,
                                (w * u[1] + (pstar - p) * n[0]) / den,
                                (w * u[2] + (pstar - p) * n[1]) / den,
                                (w * u[3] + (pstar - p) * n[2]) / den,
                                (w * u[4] - p * vn + pstar * sm) / den])

        fl = self._normal_flux(uL, pl, vnl, n)
        fr = self._normal_flux(uR, pr, vnr, n)
        fsl = self._normal_flux(star(uL, rl, vnl, pl, sl), pstar, sm, n)
        fsr = self._normal_flux(star(uR, rr, vnr, pr, sr), pstar, sm, n)
        return torch.where(sl > 0.0, fl, torch.where(
            sm > 0.0, fsl, torch.where(sr >= 0.0, fsr, fr)))

    def ghost(self, bctype, sL, n):
        rho = sL[0]
        v = sL[1:4] / rho
        vn = dot3(v, n)
        sym = torch.cat([sL[:1], rho * (v - 2.0 * vn * n), sL[4:]])
        return torch.where(bctype == BC_SYMMETRY, sym, sL)

    def charvel(self, s, n):
        rho = s[0]
        p = torch.clamp_min(self.pressure(s), 0.0)
        return dot3(s[1:4] / rho, n).abs() + self.soundspeed(rho, p)

    def adjust_phi(self, phi):
        return phi

    def assemble(self, g, U, rv, acc):
        return rv + acc.reshape(rv.shape)

    def fixup(self, u):
        return u
