"""Multi-material Euler in velocity equilibrium (Quinoa's DGMultiMat with
AUSM+up, src/PDE/Integrate/Riemann/AUSM.hpp, and the non-conservative
terms of src/PDE/MultiMat/MultiMatTerms.cpp), stiffened gases with zero
stiffness, on component-major states:

    [ alpha_k (nmat) | alpha_k rho_k (nmat) | rho u_i (3) | alpha_k rho_k E_k (nmat) ]

The face flux has R = C + 3*nmat + 1 rows: the C conservative fluxes, the
Riemann-advected partial pressures times the normal (-ap_k n_i) and the
Riemann velocity (-v), whose face sums drive the non-conservative volume
terms.  Limiting is consistent Superbee: every fraction slope takes the
smallest fraction coefficient, and the material density and energy slopes
are cut at least as hard.  After each stage the majority material's
fraction closes sum(alpha) = 1 on every dof.
"""

from __future__ import annotations

import torch

from .euler import dot3
from .geometry import BC_SYMMETRY


class MultiMat:

    def __init__(self, gammas, initialize, floor):
        #: the floor of the fractions and material densities in the
        #: primitive variables: 50 machine epsilons of the precision the
        #: configuration states (trace materials at face points), whatever
        #: precision the reference computes in
        self.floor = floor
        self.nmat = len(gammas)
        self.gammas = tuple(gammas)
        self.ncomp = 3 * self.nmat + 3
        self._init = initialize

    # row indices
    def a(self, k):
        return k

    def d(self, k):
        return self.nmat + k

    def m(self, i):
        return 2 * self.nmat + i

    def e(self, k):
        return 2 * self.nmat + 3 + k

    def initialize(self, xyz):
        return self._init(xyz, self)

    def _prim(self, u):
        nm = self.nmat
        floor = self.floor
        rho = sum(u[self.d(k)] for k in range(nm))
        vel = [u[self.m(i)] / rho for i in range(3)]
        al, pm, hm, am = [], [], [], []
        for k in range(nm):
            a = torch.clamp_min(u[self.a(k)], floor)
            rk = torch.clamp_min(u[self.d(k)] / a, floor)
            ek = u[self.e(k)] / a
            p = (ek - 0.5 * rk * (vel[0] * vel[0] + vel[1] * vel[1]
                                  + vel[2] * vel[2])) * (self.gammas[k] - 1.0)
            al.append(a)
            pm.append(p)
            hm.append(u[self.e(k)] + a * p)
            am.append(torch.sqrt(self.gammas[k] * torch.clamp_min(p, 1e-30) / rk))
        return rho, vel, al, pm, hm, am

    @staticmethod
    def _split(mach):
        m1p, m1m = 0.5 * (mach + mach.abs()), 0.5 * (mach - mach.abs())
        m2p, m2m = 0.25 * (mach + 1.0) ** 2, -0.25 * (mach - 1.0) ** 2
        c = 3.0
        sup = mach.abs() >= 1.0
        ms = torch.where(mach == 0, 1.0, mach)
        msp = torch.where(sup, m1p, m2p * (1.0 - 2.0 * m2m))
        msm = torch.where(sup, m1m, m2m * (1.0 + 2.0 * m2p))
        psp = torch.where(sup, m1p / ms, m2p * ((2.0 - mach) - c * mach * m2m))
        psm = torch.where(sup, m1m / ms, m2m * ((-2.0 - mach) + c * mach * m2p))
        return msp, msm, psp, psm

    def riemann(self, n, uL, uR):
        nm = self.nmat
        rl, vl, al, pl_, hl, cl = self._prim(uL)
        rr, vr, ar, pr_, hr, cr = self._prim(uR)
        pl = sum(al[k] * pl_[k] for k in range(nm))
        pr = sum(ar[k] * pr_[k] for k in range(nm))
        ac2 = 0.0
        for k in range(nm):
            a12 = 0.5 * (al[k] + ar[k])
            r12 = 0.5 * (uL[self.d(k)] / al[k] + uR[self.d(k)] / ar[k])
            c12 = 0.5 * (cl[k] + cr[k])
            ac2 = ac2 + a12 * r12 * c12 * c12
        ac = torch.sqrt(ac2 / (0.5 * (rl + rr)))
        mspl, _, pspl, _ = self._split(dot3(vl, n) / ac)
        _, msmr, _, psmr = self._split(dot3(vr, n) / ac)
        vriem = ac * (mspl + msmr)
        p12 = pspl * pl + psmr * pr
        lp, lm = 0.5 * (vriem + vriem.abs()), 0.5 * (vriem - vriem.abs())
        f = [None] * self.ncomp
        for k in range(nm):
            f[self.a(k)] = lp * al[k] + lm * ar[k]
            f[self.d(k)] = lp * uL[self.d(k)] + lm * uR[self.d(k)]
            f[self.e(k)] = lp * hl[k] + lm * hr[k]
        for i in range(3):
            f[self.m(i)] = lp * uL[self.m(i)] + lm * uR[self.m(i)] + p12 * n[i]
        lpn, lmn = lp / (vriem.abs() + 1e-16), lm / (vriem.abs() + 1e-16)
        dap = []
        for k in range(nm):
            apl, apr = al[k] * pl_[k], ar[k] * pr_[k]
            ap = torch.where(lpn.abs() > 1e-10, apl, torch.where(
                lmn.abs() > 1e-10, apr, 0.5 * (apl + apr)))
            dap += [-ap * n[i] for i in range(3)]
        return torch.cat([torch.stack(f), torch.stack(dap), -vriem[None]])

    def ghost(self, bctype, sL, n):
        rho = sum(sL[self.d(k)] for k in range(self.nmat))
        v = [sL[self.m(i)] / rho for i in range(3)]
        vn = dot3(v, n)
        m0 = self.m(0)
        mom = torch.stack([rho * (v[i] - 2.0 * vn * n[i]) for i in range(3)])
        sym = torch.cat([sL[:m0], mom, sL[m0 + 3:]])
        return torch.where(bctype == BC_SYMMETRY, sym, sL)

    def charvel(self, u, n):
        rho, vel, al, pm, hm, am = self._prim(u)
        ac = torch.sqrt(sum(al[k] * (u[self.d(k)] / al[k]) * am[k] * am[k]
                            for k in range(self.nmat)) / rho)
        return dot3(vel, n).abs() + ac

    def flux_cols(self, s):
        nm = self.nmat
        rho, vel, al, pm, hm, am = self._prim(s)
        pb = sum(al[k] * pm[k] for k in range(nm))
        cols = []
        for j in range(3):
            f = [None] * self.ncomp
            for k in range(nm):
                f[self.a(k)] = al[k] * vel[j]
                f[self.d(k)] = s[self.d(k)] * vel[j]
                f[self.e(k)] = hm[k] * vel[j]
            for i in range(3):
                mom = s[self.m(i)] * vel[j]
                f[self.m(i)] = mom + pb if i == j else mom
            cols.append(torch.stack(f))
        return cols

    def adjust_phi(self, phi):
        nm = self.nmat
        pa = phi[:nm].amin(dim=0)
        return torch.cat([pa.expand(nm, -1), torch.minimum(phi[nm:2 * nm], pa),
                          phi[2 * nm:2 * nm + 3],
                          torch.minimum(phi[2 * nm + 3:], pa)])

    def assemble(self, g, U, rv, acc):
        """Volume + face integrals + the non-conservative volume terms, the
        face sums of -ap n and -v taken as cell constants over vol."""
        nm, C = self.nmat, self.ncomp
        K = acc.shape[1]
        dap = acc[C:C + 3 * nm, 0] / g.vol
        divu = acc[C + 3 * nm, 0] / g.vol
        s = torch.einsum("gk,cke->cge", g.tab["B_vol"], U.reshape(C, K, -1))
        rho = sum(s[self.d(k)] for k in range(nm))
        vel = [s[self.m(i)] / rho for i in range(3)]
        dtot = [sum(dap[3 * k + i] for k in range(nm)) for i in range(3)]
        ncf = [torch.zeros_like(s[0]) for _ in range(C)]
        for k in range(nm):
            ncf[self.a(k)] = s[self.a(k)] * divu
            y = s[self.d(k)] / rho
            ncf[self.e(k)] = -sum(vel[i] * (y * dtot[i] - dap[3 * k + i])
                                  for i in range(3))
        wB = g.tab["w_vol"][:, None] * g.tab["B_vol"]
        rnc = torch.einsum("gk,cge->cke", wB, torch.stack(ncf)) * g.vol
        return rv + (acc[:C] + rnc).reshape(rv.shape)

    def fixup(self, u):
        nm, C = self.nmat, self.ncomp
        Uv = u.reshape(C, 4, -1)
        al = Uv[:nm]
        kmax = torch.argmax(al[:, 0], dim=0)
        unit0 = torch.zeros_like(al[0])
        unit0[0] = 1.0
        fix = unit0[None] - (al.sum(dim=0)[None] - al)
        onehot = torch.arange(nm, device=u.device)[:, None, None] == kmax
        return torch.cat([torch.where(onehot, fix, al), Uv[nm:]]).reshape(u.shape)
