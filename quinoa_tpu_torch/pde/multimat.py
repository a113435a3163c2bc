"""Multi-material Euler (velocity equilibrium) for cell-centred DG(P0) and
DG(P1), on torch.

Port of quinoa_tpu/pde/multimat.py (reference DGMultiMat.hpp, AUSM.hpp:
32-250, MultiMatTerms.cpp; model of Pelanti & Shyue 2019): nmat materials
with volume fractions alpha_k, partial densities alpha_k rho_k, one
velocity and material energies.  Unknown layout per element
(MultiMatIndexing.hpp):

    [ alpha_k (nmat) | alpha_k rho_k (nmat) | rho u_i (3) |
      alpha_k rho_k E_k (nmat) ]              => ncomp = 3*nmat + 3

The AUSM+up face flux also returns the Riemann-advected partial pressures
and the Riemann velocity, whose face sums (riemannDeriv, Surface.cpp:
282-289) feed the non-conservative volume terms.  The face pass writes
them as R = C + 3*nmat + 1 rows a face point: the C flux rows, -ap_k*n_i
and -vriem (_FusedMMFacade.riemann), so the element sum's (-left, +right)
convention gives +dap at the left element and -dap at the right.

Routes, as the JAX package takes them on a TPU (pde/dg_step.py
choose_route: face 'k14' or 'k14_thinc', else 'mm_dirichlet'):

- no Dirichlet face: the multimat face pass, kernel K14
  mm_face_wflux + K13 basis_accum (ops/face_fused.py mm_face_pass), whose
  charvel gives the stage-0 dt; at P1 then the volume pass (mm_volume,
  kernel K16: the flux volume integral and the non-conservative terms,
  summed with the face rows);
- Dirichlet faces at P0: the face states through the gather (K5), the
  ghost, AUSM+up and the riemannDeriv rows in torch, the element sums
  through the accumulation (K6), and the dt sweep dt_p0 in torch;
- Dirichlet faces at P1: the face Gauss-point path of dg_rhs through the
  facade (pde/dg.py face_gp_rows): the face states of the C rows (with
  THINC, and of the 5*nmat carrier rows) through K5, the ghost (the
  problem's solution at the face points and t, the carriers copied from
  the left side), the sharpening and AUSM+up in torch, the R rows' sums
  through K6, then the volume pass (K16) as above; the dt is dg_dt's face
  sweep through the facade (K5 on the C rows).

The JAX package pads the state with 3*nmat + 1 zero rows so its generic
face kernels carry the riemannDeriv rows; here the state stays C rows and
only the face pass's output has R.

THINC interface sharpening (intsharp, DG(P1)): each stage builds the
carriers of its limited state in torch (thinc_carriers, as the JAX package
builds them in XLA outside its kernels) and the face pass takes the THINC
flavour of K14, which sharpens both face states before AUSM+up (on
Dirichlet faces the facade in torch, the ghost's copied carriers
included).  At P0 intsharp is accepted and ignored, as in the JAX
package.  The sharded solver (parallel/dg_spmd.py SPMDMultiMatSolver) runs
MultiMatSolver.step_coroutine on each shard.
"""

from __future__ import annotations

import functools
from typing import List

import torch

from .. import kernels
from ..base.profiler import count, span
from ..ops.face_accum import accumulate_faces, face_gather
from ..ops.face_fused import delt_plain, mm_face_pass
from ..ops.nbr_bounds import neighbor_mean_bounds
from .dg import (BC_DIRICHLET, BC_INTERIOR, BC_SYMMETRY, DGGeom, dg_dt,
                 dg_dt_from_delt, face_gp_rows, no_plan)
from .dg_step import SSPRK3, choose_route
from .eos import StiffenedGas
from .limiter import consistent_mm_phi, superbee_phi


def volfrac_idx(nmat, k):
    return k


def density_idx(nmat, k):
    return nmat + k


def momentum_idx(nmat, i):
    return 2 * nmat + i


def energy_idx(nmat, k):
    return 2 * nmat + 3 + k


def _split_mach(mach):
    """AUSM+ split Mach/pressure polynomials (AUSM.hpp:200-250), f_a=1."""
    m1p = 0.5 * (mach + mach.abs())
    m1m = 0.5 * (mach - mach.abs())
    mp1, mm1 = mach + 1.0, mach - 1.0
    m2p = 0.25 * (mp1 * mp1)
    m2m = -0.25 * (mm1 * mm1)
    c = 16.0 * (3.0 / 16.0)   # 16 alpha, alpha = (3/16)(-4+5 f_a^2)

    sup = mach.abs() >= 1.0
    msafe = torch.where(mach == 0, 1.0, mach)
    msp = torch.where(sup, m1p, m2p * (1.0 - 2.0 * m2m))
    msm = torch.where(sup, m1m, m2m * (1.0 + 2.0 * m2p))
    psp = torch.where(sup, m1p / msafe,
                      m2p * ((2.0 - mach) - c * mach * m2m))
    psm = torch.where(sup, m1m / msafe,
                      m2m * ((-2.0 - mach) + c * mach * m2p))
    return msp, msm, psp, psm


def _dot3(a, n):
    return a[0] * n[0] + a[1] * n[1] + a[2] * n[2]


class MultiMatSystem:
    """DG multi-material Euler with AUSM+up and non-conservative terms."""

    has_src = False

    def __init__(self, problem, intsharp=False, thinc_beta=2.5):
        self.problem = problem
        self.nmat = problem.nmat
        # a problem may list more materials' EoS than it uses
        # (MMInterfaceAdvection(nmat=2) keeps three): the kernels take nmat
        # from len(eos)
        self.eos: List[StiffenedGas] = list(problem.eos)[:self.nmat]
        self.ncomp = 3 * self.nmat + 3
        # THINC interface sharpening at P1 (upstream Quinoa's intsharp /
        # intsharp_param); beta 2.5 as the JAX package chose it
        self.intsharp = bool(intsharp)
        self.thinc_beta = float(thinc_beta)
        #: rows of the face pass: C fluxes, 3*nmat riemannDeriv, 1 divergence
        self.nrows = self.ncomp + 3 * self.nmat + 1
        self.facade = _FusedMMFacade(self)
        self.thinc_facade = _FusedMMFacade(self, thinc=True)
        #: the route of rhs and rhs_p0 when the caller names none: True the
        #: multimat face pass (no Dirichlet face); a MultiMatSolver names
        #: its own route and leaves this alone
        self.fused_ok = False

    # -- state helpers --------------------------------------------------------

    def _prim(self, u):
        """Bulk rho, velocity, material fractions/pressures/enthalpies/sound
        speeds.  alpha and the material density are floored at 50 eps of
        the dtype (trace materials at face points), the pressure at 1e-30
        in the sound speed."""
        nmat = self.nmat
        floor = 50.0 * torch.finfo(u.dtype).eps
        rho = sum(u[density_idx(nmat, k)] for k in range(nmat))
        vel = [u[momentum_idx(nmat, i)] / rho for i in range(3)]
        al, pm, hm, am = [], [], [], []
        for k in range(nmat):
            a = torch.clamp_min(u[volfrac_idx(nmat, k)], floor)
            rk = torch.clamp_min(u[density_idx(nmat, k)] / a, floor)
            ek = u[energy_idx(nmat, k)] / a
            p = self.eos[k].pressure(rk, vel[0], vel[1], vel[2], ek)
            al.append(a)
            pm.append(p)
            hm.append(u[energy_idx(nmat, k)] + a * p)
            am.append(self.eos[k].soundspeed(rk, torch.clamp_min(p, 1e-30)))
        return rho, vel, al, pm, hm, am

    def ausm(self, fn, uL, uR):
        """AUSM+up flux: (flux (C, n), ap_star (nmat, n), vriem (n,))."""
        nmat = self.nmat
        rhol, vell, all_, pml, hml, aml = self._prim(uL)
        rhor, velr, alr, pmr, hmr, amr = self._prim(uR)

        pl = sum(all_[k] * pml[k] for k in range(nmat))
        pr = sum(alr[k] * pmr[k] for k in range(nmat))

        # mixture speed of sound from averaged material states
        rho12 = 0.5 * (rhol + rhor)
        ac2 = 0.0
        for k in range(nmat):
            al12 = 0.5 * (all_[k] + alr[k])
            rm12 = 0.5 * (uL[density_idx(nmat, k)] / all_[k]
                          + uR[density_idx(nmat, k)] / alr[k])
            am12 = 0.5 * (aml[k] + amr[k])
            ac2 = ac2 + al12 * rm12 * am12 * am12
        ac12 = torch.sqrt(ac2 / rho12)

        vnl, vnr = _dot3(vell, fn), _dot3(velr, fn)
        mspl, _, pspl, _ = _split_mach(vnl / ac12)
        _, msmr, _, psmr = _split_mach(vnr / ac12)

        m12 = mspl + msmr  # k_p = 0 (AUSM.hpp:127: k_u = k_p = 0)
        vriem = ac12 * m12
        p12 = pspl * pl + psmr * pr  # k_u = 0

        lp = 0.5 * (vriem + vriem.abs())
        lm = 0.5 * (vriem - vriem.abs())

        flx = [None] * self.ncomp
        for k in range(nmat):
            flx[volfrac_idx(nmat, k)] = lp * all_[k] + lm * alr[k]
            d = density_idx(nmat, k)
            flx[d] = lp * uL[d] + lm * uR[d]
            flx[energy_idx(nmat, k)] = lp * hml[k] + lm * hmr[k]
        for i in range(3):
            m = momentum_idx(nmat, i)
            flx[m] = lp * uL[m] + lm * uR[m] + p12 * fn[i]

        # Riemann-advected partial pressures: upwinded by the sign of vriem
        lpn = lp / (vriem.abs() + 1e-16)
        lmn = lm / (vriem.abs() + 1e-16)
        ap = []
        for k in range(nmat):
            apl = all_[k] * pml[k]
            apr = alr[k] * pmr[k]
            ap.append(torch.where(
                lpn.abs() > 1e-10, apl,
                torch.where(lmn.abs() > 1e-10, apr, 0.5 * (apl + apr))))
        return torch.stack(flx), torch.stack(ap), vriem

    def bc_state(self, bctype, sL, fn):
        """Ghost states: symmetry reflects the velocity (the momentum is
        rebuilt as rho * (v - 2 (v.n) n)), extrapolate copies; Dirichlet is
        the caller's."""
        nmat = self.nmat
        rho = sum(sL[density_idx(nmat, k)] for k in range(nmat))
        vel = [sL[momentum_idx(nmat, i)] / rho for i in range(3)]
        vn = _dot3(vel, fn)
        m0 = momentum_idx(nmat, 0)
        mom = [rho * (vel[i] - 2.0 * vn * fn[i]) for i in range(3)]
        sym = torch.cat([sL[:m0], torch.stack(mom), sL[m0 + 3:]])
        return torch.where(bctype == BC_SYMMETRY, sym, sL)

    def charvel(self, u, fn):
        nmat = self.nmat
        rho, vel, al, pm, hm, am = self._prim(u)
        ac = torch.sqrt(
            sum(al[k] * (u[density_idx(nmat, k)] / al[k]) * (am[k] * am[k])
                for k in range(nmat)) / rho)
        return _dot3(vel, fn).abs() + ac

    def flux_cols(self, state, gp, t):
        """Conservative flux columns F_j (list of 3, each (C, ...)) for the
        DG volume integral at P1: alpha advects as alpha*u, with the
        +alpha*div(u) balance in the non-conservative term."""
        nmat, C = self.nmat, self.ncomp
        rho, vel, al, pm, hm, am = self._prim(state)
        pb = sum(al[k] * pm[k] for k in range(nmat))
        cols = []
        for j in range(3):
            f = [None] * C
            for k in range(nmat):
                f[volfrac_idx(nmat, k)] = al[k] * vel[j]
                d = density_idx(nmat, k)
                f[d] = state[d] * vel[j]
                # material total enthalpy flux: u_j ((arE)_k + a_k p_k)
                f[energy_idx(nmat, k)] = hm[k] * vel[j]
            for i in range(3):
                mom = state[momentum_idx(nmat, i)] * vel[j]
                f[momentum_idx(nmat, i)] = mom + pb if i == j else mom
            cols.append(torch.stack(f))
        return cols

    def thinc_carriers(self, geom: DGGeom, Uv):
        """THINC carriers (8*nmat, E) of the modal state Uv (C, 4, E), per
        material k the rows 8k..8k+7 (quinoa_tpu/pde/multimat.py
        thinc_carriers, whose (5*nmat, K, E) layout thinc_modes rebuilds):

        - 8k..8k+3: the P1 modes of q_k, the cell's coordinate along the
          interface normal grad(alpha_k)/|grad(alpha_k)|, 0 at the most
          upwind vertex and 1 at the most downwind (affine in the
          reference coordinates, so exact in the P1 basis);
        - 8k+4: q0_k, the interface position from the closed-form
          slab-mean inversion of the tanh profile;
        - 8k+5: the flag, 1.0 in an interface cell (delta < mean alpha_k
          < 1 - delta, |grad alpha_k| > 1e-8);
        - 8k+6, 8k+7: the cell-mean material density (alpha rho)_k /
          alpha_k and energy density, alpha floored at delta.

        The operation order and constants are the JAX package's."""
        nmat = self.nmat
        beta = self.thinc_beta
        delta = 1.0e-4
        dt_ = Uv.dtype
        J, Jm = geom.jacInv, geom.Jmat
        eb, emb = _exp_pm(beta, dt_, Uv.device)
        rows = []
        for k in range(nmat):
            a = Uv[volfrac_idx(nmat, k)]                     # (K,E)
            u1, u2, u3 = a[1], a[2], a[3]
            dxi = (2.0 * u1, u1 + 3.0 * u2, u1 + u2 + 4.0 * u3)
            g = [dxi[0] * J[0, j] + dxi[1] * J[1, j] + dxi[2] * J[2, j]
                 for j in range(3)]
            gn = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2])
            abar = a[0]
            flag = ((abar > delta) & (abar < 1.0 - delta)
                    & (gn > 1.0e-8)).to(dt_)
            gsafe = torch.clamp_min(gn, 1.0e-30)
            n = [g[j] / gsafe for j in range(3)]
            # vertex projections along n: node 0 at 0, the three edge
            # vectors Jmat[:, i]
            pj = [n[0] * Jm[0, i] + n[1] * Jm[1, i] + n[2] * Jm[2, i]
                  for i in range(3)]
            pmin = torch.minimum(torch.minimum(pj[0], pj[1]),
                                 torch.clamp_max(pj[2], 0.0))
            pmax = torch.maximum(torch.maximum(pj[0], pj[1]),
                                 torch.clamp_min(pj[2], 0.0))
            L = torch.clamp_min(pmax - pmin, 1.0e-30)
            # q(xi) = (sum_i pj_i xi_i - pmin) / L in the Dubiner modes
            # (B1 = 2x + e + z - 1, B2 = 3e + z - 1, B3 = 4z - 1)
            c0 = -pmin / L
            c1, c2, c3 = pj[0] / L, pj[1] / L, pj[2] / L
            m1 = c1 / 2.0
            m2 = (c2 - m1) / 3.0
            m3 = (c3 - m1 - m2) / 4.0
            m0 = c0 + m1 + m2 + m3
            # mean = 1/2 + (1/2b) ln[(e^b + z e^-b)/(1+z)], z = e^{2 b q0}
            ab = torch.clamp(abar, delta, 1.0 - delta)
            Em = torch.exp(beta * (2.0 * ab - 1.0))
            z = (eb - Em) / (Em - emb)
            q0 = torch.log(z) / (2.0 * beta)
            asafe = torch.clamp_min(abar, delta)
            rhok = Uv[density_idx(nmat, k)][0] / asafe
            rek = Uv[energy_idx(nmat, k)][0] / asafe
            rows += [m0, m1, m2, m3, q0, flag, rhok, rek]
        return torch.stack(rows)

    def thinc_modes(self, carriers, K):
        """The carriers (8*nmat, E) in the JAX package's layout (5*nmat,
        K, E): per material q's modes, then q0, flag, rho_k and rhoE_k in
        mode 0 with zero higher modes."""
        z = carriers.new_zeros((K - 1, carriers.shape[-1]))
        rows = []
        for k in range(self.nmat):
            x = carriers[8 * k:8 * k + 8]
            rows.append(x[:4])
            rows += [torch.cat([x[j:j + 1], z]) for j in range(4, 8)]
        return torch.stack(rows)

    # -- right-hand sides ------------------------------------------------------

    def _split_acc(self, acc, K):
        """The face pass's (R*K, E) sums -> (conservative (C, K, E), dap
        (3*nmat, E), divu (E,)) from the k = 0 rows of the carriers."""
        nmat, C = self.nmat, self.ncomp
        accv = acc.reshape(self.nrows, K, -1)
        return accv[:C], accv[C:C + 3 * nmat, 0], accv[C + 3 * nmat, 0]

    def rhs_p0(self, geom: DGGeom, U, t, accum_plan=None, want_delt=False):
        """Finite-volume rhs (C, E) with the non-conservative terms.  With
        fused_ok the multimat face pass (K14 + K13 on a card) takes the
        whole face sweep, and want_delt also returns its per-element summed
        charvel; otherwise the Dirichlet route (quinoa_tpu/pde/multimat.py
        :345-405, face sums through K6).  accum_plan, at the JAX package's
        position, must be None: the port has no accumulation plans."""
        no_plan(accum_plan)
        return self._rhs_p0(geom, U, t, self.fused_ok, want_delt)

    def _rhs_p0(self, geom: DGGeom, U, t, fused, want_delt):
        nmat, C = self.nmat, self.ncomp
        if fused:
            with span("face_pass"):
                acc, delt = mm_face_pass(self, geom, U)
                R, dap, divu = self._split_acc(acc, 1)
            with span("nonconservative"):
                R = R[:, 0] + self._nonconservative(geom, U, dap, divu)
            with span("face_pass"):
                R = R * geom.emask
            return (R, delt) if want_delt else R
        if want_delt:
            raise ValueError("want_delt needs the multimat face pass")
        with span("face_pass"):
            acc = accumulate_faces(geom,
                                   *self.dirichlet_face_rows(geom, U, t))
            R, dap, divu = acc[:C], acc[C:C + 3 * nmat], acc[C + 3 * nmat]
        with span("nonconservative"):
            R = R + self._nonconservative(geom, U, dap, divu)
        with span("face_pass"):
            return R * geom.emask

    def dirichlet_face_rows(self, geom: DGGeom, U, t):
        """The Dirichlet route's per-face rows (XL, XR), each (C + 3*nmat +
        1, F): the weighted AUSM+up flux, riemannDeriv and velocity
        divergence that K6 sums onto the left and right elements."""
        nmat = self.nmat
        uL = face_gather(U, geom.el)
        uR0 = face_gather(U, geom.er)
        interior = geom.bctype == BC_INTERIOR

        # boundary ghost states; P0: the cell anchor for Dirichlet
        gp = geom.node0[:, geom.el.long()]
        dirich = self.problem.solution(gp, t).to(U.dtype)
        uR = torch.where(
            interior, uR0,
            torch.where(geom.bctype == BC_DIRICHLET, dirich,
                        self.bc_state(geom.bctype, uL, geom.fn)))

        flx, ap, vriem = self.ausm(geom.fn, uL, uR)
        wt = geom.farea * geom.fmask  # single-point face rule for P0

        contribL = -wt * flx
        contribR = wt * flx
        # riemannDeriv: dap[3k+i] += wt ap_k fn_i; the div u term
        dapL = torch.stack([wt * ap[k] * geom.fn[i] for k in range(nmat)
                            for i in range(3)])
        divL = wt * vriem
        return (torch.cat([contribL, dapL, divL[None]]),
                torch.cat([contribR, -dapL, -divL[None]]))

    def rhs(self, geom: DGGeom, U, t, accum_plan=None, want_delt=False,
            face_gp=False):
        """Order-dispatching rhs (C*K, E) [, delt]: P0 keeps the finite-
        volume path (intsharp ignored); P1 (ndof 4) sums the face rows
        (with intsharp, of the THINC-sharpened faces, on the carriers of
        U) with the volume pass (mm_volume: the flux volume integral and
        the non-conservative terms at the volume Gauss points).  With
        fused_ok the face sums are the multimat face pass's (K14 + K13),
        whose charvel want_delt returns; otherwise the face Gauss-point
        path's (dirichlet_face_gp_sums, K5 + K6), which has no charvel.
        The THINC carriers accumulate nothing, so both give R rows.
        accum_plan and face_gp sit at the JAX package's positions
        (quinoa_tpu/pde/multimat.py:407-408); accum_plan must be None, and
        fused_ok, not face_gp, picks the route, as the JAX solver sets
        face_gp exactly where fused_ok is false."""
        no_plan(accum_plan)
        return self.rhs_routed(geom, U, t, self.fused_ok, want_delt)

    def rhs_routed(self, geom: DGGeom, U, t, fused, want_delt=False):
        """rhs on the route the caller names, fused (the multimat face
        pass) or not (the Dirichlet route), whatever fused_ok says: a
        MultiMatSolver's step names its own."""
        if geom.ndof == 1:
            return self._rhs_p0(geom, U, t, fused, want_delt)
        # spans (base/profiler.py): the THINC carriers and the face sums
        # are the face pass's; the volume pass, which sums them with the
        # volume integrals and takes the emask product, is the volume's
        with span("face_pass"):
            carriers = (self.thinc_carriers(geom, U.reshape(
                self.ncomp, geom.ndof, -1)) if self.intsharp else None)
            if fused:
                acc, delt = mm_face_pass(self, geom, U, carriers)
            else:
                if want_delt:
                    raise ValueError("want_delt needs the multimat face "
                                     "pass")
                acc = self.dirichlet_face_gp_sums(geom, U, carriers, t)
        with span("volume"):
            R = mm_volume(self, geom, U, acc)
        return (R, delt) if want_delt else R

    def dirichlet_face_gp_sums(self, geom: DGGeom, U, carriers, t):
        """The P1 face Gauss-point route's element sums (R*K, E) of U (C*K,
        E): the facade's R rows (the THINC facade's with carriers) summed
        by K6 from zero (the JAX package sums them onto its volume term,
        quinoa_tpu/pde/multimat.py:407-450; here the volume pass adds it)."""
        C, K = self.ncomp, geom.ndof
        E = U.shape[-1]
        facade, Ug = self.facade, U
        if carriers is not None:
            facade = self.thinc_facade
            Ug = torch.cat([U.reshape(C, K, E),
                            self.thinc_modes(carriers, K)]).reshape(-1, E)
        return accumulate_faces(geom, *face_gp_rows(facade, geom, Ug, t))

    def _ncf(self, s, dap, divu):
        """Non-conservative integrands (C rows) of the states s from the
        volume-scaled face sums (MultiMatTerms.cpp:140-170): alpha_k div(u)
        and the velocity-dotted pressure-gradient exchange in the
        material energies."""
        nmat, C = self.nmat, self.ncomp
        rho = sum(s[density_idx(nmat, k)] for k in range(nmat))
        vel = [s[momentum_idx(nmat, i)] / rho for i in range(3)]
        dap_tot = [sum(dap[3 * k + i] for k in range(nmat))
                   for i in range(3)]
        ncf = [torch.zeros_like(s[0]) for _ in range(C)]
        for k in range(nmat):
            ncf[volfrac_idx(nmat, k)] = s[volfrac_idx(nmat, k)] * divu
            y_k = s[density_idx(nmat, k)] / rho
            e = torch.zeros_like(s[0])
            for i in range(3):
                e = e - vel[i] * (y_k * dap_tot[i] - dap[3 * k + i])
            ncf[energy_idx(nmat, k)] = e
        return ncf

    def _nonconservative(self, geom: DGGeom, U, dap, divu):
        """P0 non-conservative volume terms (C, E) from the face sums."""
        V = geom.vol * geom.emask + (1.0 - geom.emask)
        ncf = self._ncf(U, dap / V, divu / V)
        return geom.vol * geom.emask * torch.stack(ncf)

    def dt(self, geom: DGGeom, U):
        """Max-charvel time step: P0 the finite-volume sweep, P1 the DG
        face sweep (dg_dt) through the facade."""
        if geom.ndof == 1:
            return self.dt_p0(geom, U)
        return dg_dt(self.facade, geom, U)

    def dt_p0(self, geom: DGGeom, U):
        uL = face_gather(U, geom.el)
        uR = face_gather(U, geom.er)
        wt = geom.farea * geom.fmask
        interior = geom.bctype == BC_INTERIOR
        dl = wt * self.charvel(uL, geom.fn)
        dr = wt * self.charvel(uR, geom.fn)
        mx = torch.where(interior, torch.maximum(dl, dr), dl)
        return dg_dt_from_delt(geom, delt_plain(geom, mx))

    def initialize(self, xyz, t):
        return self.problem.solution(xyz, t)

    def analytic(self, xyz, t):
        return self.problem.solution(xyz, t)


def clean_alpha_closure(u, C, K, nmat):
    """Enforce sum_k alpha_k == 1 on every dof row: the majority
    material's fraction dofs become (1, 0, 0, 0) minus the sum of the
    others (the alpha part of upstream Quinoa's cleanTraceMultiMat).  The
    majority is the first maximum of the cell means, as jnp.argmax picks
    it.  P1+ only."""
    E = u.shape[-1]
    Uv = u.reshape(C, K, E)
    al = Uv[:nmat]                                       # (nmat,K,E)
    kmax = torch.argmax(al[:, 0, :], dim=0)              # (E,)
    unit0 = torch.zeros((K, E), dtype=u.dtype, device=u.device)
    unit0[0] = 1.0
    total = al.sum(dim=0)                                # (K,E)
    fix = unit0[None] - (total[None] - al)               # (nmat,K,E)
    onehot = (torch.arange(nmat, device=u.device)[:, None, None]
              == kmax[None, None, :])
    return torch.cat([torch.where(onehot, fix, al), Uv[nmat:]]).reshape(
        C * K, E)


@functools.lru_cache(maxsize=None)
def _exp_pm(beta, dtype, device):
    """exp(beta) and exp(-beta) as tensors of dtype on device, taken there
    once (the THINC carriers' constants)."""
    count("host_syncs", 2)              # the two uploads below
    return (torch.exp(torch.tensor(beta, dtype=dtype, device=device)),
            torch.exp(torch.tensor(-beta, dtype=dtype, device=device)))


def mm_volume(system, geom: DGGeom, U, acc=None):
    """Multimat DG(P1)'s volume Gauss-point pass over the state U (C*K,
    E): without acc the flux volume integral (C*K, E) scaled by
    vol*emask; with acc, the face pass's sums (R*K, E), the stage's rhs
    ((acc's C*K rows + the flux integral) + the non-conservative
    integral) * emask.  On a CUDA tensor kernel K16 (csrc/mm_volume.cu);
    on a CPU tensor mm_volume_plain."""
    if U.device.type == "cpu":
        return mm_volume_plain(system, geom, U, acc)
    return kernels.mm_volume(U, geom.jacInv, geom.vol, geom.emask, geom.ktab,
                             geom.wB_vol, system.eos, acc)


def mm_volume_plain(system, geom: DGGeom, U, acc=None):
    """K16's plain version, in its sum order: at each volume point the
    state (the basis sum in mode order), flux_cols' columns contracted
    with jacInv and added through the nonzero entries of w*dB/dxi into
    the volume rows (ops/nbr_bounds.py volume_rhs_plain's order), and with
    acc _ncf's integrands of the fraction and energy rows (the others are
    zero) against w*B, from the face pass's riemannDeriv and divergence
    sums over the volume; the point loop is the outer one of every sum."""
    nmat, C, K = system.nmat, system.ncomp, geom.ndof
    E = U.shape[-1]
    tb = geom.tables
    Bv = tb["B_vol"]
    wdB = tb["w_vol"][:, None, None] * tb["dBdxi_vol"]
    wB = tb["w_vol"][:, None] * Bv
    Uv = U.reshape(C, K, E)
    J = geom.jacInv
    rows = [U.new_zeros((C, E)) for _ in range(K)]
    if acc is not None:
        accv = acc.reshape(system.nrows, K, E)
        V = geom.vol * geom.emask + (1.0 - geom.emask)
        dap = accv[C:C + 3 * nmat, 0] / V
        divu = accv[C + 3 * nmat, 0] / V
        nc = [volfrac_idx(nmat, k) for k in range(nmat)] + [
            energy_idx(nmat, k) for k in range(nmat)]
        rnc = [U.new_zeros((2 * nmat, E)) for _ in range(K)]
    for g in range(Bv.shape[0]):
        s = float(Bv[g, 0]) * Uv[:, 0]
        for k in range(1, K):
            s = s + float(Bv[g, k]) * Uv[:, k]
        Fj = system.flux_cols(s, None, 0.0)
        for m in range(3):
            fref = Fj[0] * J[m, 0] + Fj[1] * J[m, 1] + Fj[2] * J[m, 2]
            for k in range(K):
                w = float(wdB[g, k, m])
                if w != 0.0:
                    rows[k] = rows[k] + w * fref
        if acc is not None:
            ncf = system._ncf(s, dap, divu)
            f = torch.stack([ncf[r] for r in nc])
            for k in range(K):
                rnc[k] = rnc[k] + float(wB[g, k]) * f
    ve = geom.vol * geom.emask
    Rv = torch.stack(rows, dim=1) * ve
    if acc is None:
        return Rv.reshape(C * K, E)
    R = accv[:C] + Rv
    R[nc] = R[nc] + torch.stack(rnc, dim=1) * ve
    return (R * geom.emask).reshape(C * K, E)


def mm_consistent_limit(system, geom: DGGeom, u):
    """Consistent material-fraction Superbee limiting for multimat DG(P1):
    a new (C*K, E) state.  On a CUDA tensor kernel K15
    (csrc/mm_limit.cu); on a CPU tensor mm_consistent_limit_plain."""
    if u.device.type == "cpu":
        return mm_consistent_limit_plain(system, geom, u)
    return kernels.mm_limit(u, geom.esuelT, geom.ktab, system.nmat)


def mm_consistent_limit_plain(system, geom: DGGeom, u):
    """K15's plain version: the neighbour-mean bounds (K4 on a card), the
    Superbee phi, the common-alpha adjustment (pde/limiter.py
    consistent_mm_phi), then the P1 dofs scaled by it."""
    C, K = system.ncomp, geom.ndof
    E = u.shape[-1]
    bounds = neighbor_mean_bounds(geom, u, C)
    phi = consistent_mm_phi(superbee_phi(geom, u, None, C, bounds=bounds),
                            system.nmat)
    Uv = u.reshape(C, K, E)
    return torch.cat([Uv[:, :1], Uv[:, 1:4] * phi[:, None, :]],
                     dim=1).reshape(C * K, E)


class _FusedMMFacade:
    """AUSM+up flux + riemannDeriv + velocity divergence presented as one
    R-row 'flux' of the C-row multimat state, with the multimat ghost and
    charvel: what the face pass (K14 and its plain version, through
    ops/face_fused.py face_wflux_plain) and the dg_dt sweep call.

    With thinc the state carries the 5*nmat THINC carrier rows after its C
    rows (thinc_modes); the ghost copies them from the left side (the
    symmetry ghost rebuilds the momentum rows only), the charvel reads
    the raw C rows, and riemann sharpens both sides (_thinc_faces) before
    AUSM+up."""

    needs_face_gp = False

    def __init__(self, mm: MultiMatSystem, thinc=False):
        self.mm = mm
        self.thinc = bool(thinc)
        self.ncomp = mm.ncomp + (5 * mm.nmat if self.thinc else 0)

    def bc_state(self, bctype, sL, fn, gp, t):
        """The multimat ghost of the C rows, the carrier rows copied from
        the left side; with the face coordinates gp (the face Gauss-point
        path) the problem's solution at (gp, t) on Dirichlet faces."""
        out = self.mm.bc_state(bctype, sL, fn)
        if gp is None:
            return out
        C = self.mm.ncomp
        dirich = torch.cat([self.mm.problem.solution(gp, t).to(sL.dtype),
                            sL[C:]])
        return torch.where(bctype == BC_DIRICHLET, dirich, out)

    def _thinc_faces(self, s):
        """The C rows of the face states s with the THINC tanh profile in
        place of the fractions of flagged materials, the fractions
        renormalised to sum to 1, flagged materials' alpha rho and alpha
        rhoE re-derived from their cell means and the momentum rescaled by
        rho_new / rho_lin (quinoa_tpu/pde/multimat.py _FusedMMFacade.
        _thinc_faces)."""
        mm = self.mm
        C, nmat = mm.ncomp, mm.nmat
        beta = mm.thinc_beta
        floor = 50.0 * torch.finfo(s.dtype).eps
        a_new, flags = [], []
        for k in range(nmat):
            q, q0, flag = s[C + 5 * k], s[C + 5 * k + 1], s[C + 5 * k + 2]
            ath = 0.5 * (1.0 + torch.tanh(beta * (q - q0)))
            flags.append(flag > 0.5)
            a_new.append(torch.where(flags[k], ath, s[volfrac_idx(nmat, k)]))
        ssum = a_new[0]
        for k in range(1, nmat):
            ssum = ssum + a_new[k]
        den = torch.clamp_min(ssum, floor)
        rows = list(s[:C])
        rho_new = rho_lin = None
        for k in range(nmat):
            a = a_new[k] / den
            d, e = density_idx(nmat, k), energy_idx(nmat, k)
            dk = torch.where(flags[k], a * s[C + 5 * k + 3], s[d])
            ek = torch.where(flags[k], a * s[C + 5 * k + 4], s[e])
            rows[volfrac_idx(nmat, k)], rows[d], rows[e] = a, dk, ek
            rho_new = dk if k == 0 else rho_new + dk
            rho_lin = s[d] if k == 0 else rho_lin + s[d]
        for i in range(3):
            m = momentum_idx(nmat, i)
            rows[m] = rho_new * (s[m] / rho_lin)
        return torch.stack(rows)

    def riemann(self, fn, sL, sR, gp, t):
        mm = self.mm
        if self.thinc:
            sL, sR = self._thinc_faces(sL), self._thinc_faces(sR)
        flx, ap, vriem = mm.ausm(fn, sL, sR)
        dap = torch.stack([ap[k] * fn[i] for k in range(mm.nmat)
                           for i in range(3)])
        return torch.cat([flx, -dap, -vriem[None]])

    def charvel(self, s, fn, gp=None):
        return self.mm.charvel(s, fn)


class MultiMatSolver(SSPRK3):
    """SSP-RK3 DG(P0/P1) time stepper for the multi-material system on one
    device (quinoa_tpu/pde/multimat.py MultiMatSolver): pde/dg_step.py's
    step on choose_route's route (or on_route's).

    P0 is the reference fork's scheme (DGMultiMat.hpp:154 asserts
    ndof==1); P1 (ndof 4) runs the DG volume and face integrals with
    consistent material-fraction Superbee limiting and the alpha closure
    after every stage.  With a Dirichlet face the face sums take the face
    Gauss-point route and the stage-0 dt the face sweep (system.dt)."""

    def __init__(self, system: MultiMatSystem, geom: DGGeom, cfl=0.5,
                 const_dt=None, limiter=None):
        route = self.route or choose_route(system, [geom], limiter,
                                           const_dt=const_dt)
        self.limiter = limiter
        self._setup(system, geom, cfl, const_dt, route, geom.ndof,
                    lambda u, dofmask: system.dt(geom, u))
        self.dt_factors = (cfl, self.cflscale)
        if geom.ndof == 1:
            self.minv = 1.0 / geom.vol  # the finite-volume update's 1/vol
        else:
            self.closure = lambda v: clean_alpha_closure(
                v, system.ncomp, geom.ndof, system.nmat)
        self._fused = route.face != "mm_dirichlet"
        self._limit_fn = lambda u, *_: (
            mm_consistent_limit(system, geom, u), None)
        if limiter is None:     # no limit stage, and no limit span
            self._limiter = lambda u, *_: (u, None)

    def _limit(self, u):
        if self.limiter is None:
            return u
        return mm_consistent_limit(self.system, self.geom, u)

    def _rhs(self, s, u, dofmask, dm, rv, t):
        # at stage 0 of the charvel route the face pass emits the dt's
        # charvel sums with the rhs; rhs_routed opens the spans
        want = s == 0 and self._dt_charvel is not None
        r = self.system.rhs_routed(self.geom, u, t, self._fused, want)
        return r if want else (r, None)
