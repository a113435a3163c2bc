"""The SDE/ODE systems, ensemble-vectorized.

The port's own copy of quinoa_tpu/diffeq/systems.py (the reference's
src/DiffEq/: Beta/, Dirichlet/, OrnsteinUhlenbeck/, Gamma/, SkewNormal/,
WrightFisher/, Position/, Dissipation/, Velocity/).  Each system is a
small dataclass with the JAX package's fields and defaults; its
``advance(key, P, dt, t)`` is one Euler-Maruyama step of its slice of the
particle array P (npar, nprop_total) and returns a new array, P itself
untouched.  The Gaussian increments are the JAX package's draws from the
same key (rng.threefry.normal), in P's dtype on P's device.

An ensemble mean inside a step (the coefficients of the homogeneous and
decaying Beta families, the Langevin models' Reynolds stress and mean
frequency) goes through _emean: with ``nshard`` > 1 (walker --npes) the
ensemble is nshard equal row blocks and the mean folds the blocks' sums
in block order, as the JAX walker's reduction over its sharded 'par'
axis does.

Each system owns ``nprop`` slots from ``offset`` (derived quantities such
as the instantaneous density ride beside the advanced ones), and coupled
systems (Position <- Velocity <- Dissipation, the Langevin family) read
other systems' slots through their offsets, as the reference's
CoupledEq machinery does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..rng import threefry
from ..statistics.stats import block_mean


@functools.lru_cache(maxsize=512)
def _const(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def _arr(values, like: torch.Tensor) -> torch.Tensor:
    """A coefficient (a number or a nested sequence of them) as a tensor
    of like's dtype on like's device, made once per value and place."""
    if isinstance(values, np.ndarray):
        values = values.tolist()
    if isinstance(values, (list, tuple)):
        values = tuple(tuple(v) if isinstance(v, (list, tuple)) else v
                       for v in values)
    return _const(values, like.dtype, like.device)


def _emean(x, nshard=1):
    """The ensemble mean over the particle axis 0 (statistics.block_mean:
    over nshard row blocks, their sums folded in block order)."""
    return block_mean(x, nshard)


def _emean_all(x, nshard=1):
    """The mean of every entry of x (particle axis first), as x.mean();
    the row blocks of a row-major x are the flat array's blocks."""
    if nshard == 1:
        return x.mean()
    return block_mean(x.reshape(-1), nshard)


def _gauss(key, npar, ncomp, like):
    return threefry.normal(key, (npar, ncomp), like.dtype, like.device)


def _sqrt_pos(d):
    return torch.sqrt(torch.clamp(d, min=0.0))


def _set(P, cols):
    """A copy of P with the column blocks {offset: (npar, n) tensor} set
    (the JAX package's functional P.at[:, o:o+n].set)."""
    P = P.clone()
    for o, Y in cols.items():
        P[:, o:o + Y.shape[1]] = Y
    return P


@dataclasses.dataclass
class SDEBase:
    """Common bookkeeping: depvar (for moment lookups), offset, init."""

    depvar: str = "x"
    offset: int = 0
    #: callable (key, npar, dtype=, device=) -> (npar, ncomp), set by the
    #: deck's builder or the user
    init = None

    @property
    def nprop(self) -> int:
        return self.ncomp

    def slice(self, P):
        return P[:, self.offset:self.offset + self.ncomp]

    def put(self, P, Y):
        return _set(P, {self.offset: Y})


@dataclasses.dataclass
class DiagOrnsteinUhlenbeck(SDEBase):
    """dY_i = theta_i(mu_i - Y_i)dt + sigma_i dW_i
    (DiagOrnsteinUhlenbeck.hpp:144-165)."""

    sigmasq: Sequence[float] = (0.25,)
    theta: Sequence[float] = (1.0,)
    mu: Sequence[float] = (0.0,)

    @property
    def ncomp(self):
        return len(self.theta)

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y)
        th, mu = _arr(self.theta, Y), _arr(self.mu, Y)
        s2 = _arr(self.sigmasq, Y)
        Y = Y + th * (mu - Y) * dt + _sqrt_pos(s2 * dt) * dW
        return self.put(P, Y)


@dataclasses.dataclass
class OrnsteinUhlenbeck(SDEBase):
    """dY_i = theta_i(mu_i - Y_i)dt + sigma_ji dW_j with the covariance's
    Cholesky factor applied transposed, as the reference
    (OrnsteinUhlenbeck.hpp:157-180)."""

    sigmasq: Sequence[Sequence[float]] = ((0.25,),)  # covariance matrix
    theta: Sequence[float] = (1.0,)
    mu: Sequence[float] = (0.0,)

    @property
    def ncomp(self):
        return len(self.theta)

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y)
        th, mu = _arr(self.theta, Y), _arr(self.mu, Y)
        L = torch.linalg.cholesky(_arr(self.sigmasq, Y))
        Y = Y + th * (mu - Y) * dt + math.sqrt(dt) * (dW @ L.T)
        return self.put(P, Y)


def _beta_step(Y, dW, b, S, k, dt):
    return Y + 0.5 * b * (S - Y) * dt + _sqrt_pos(k * Y * (1.0 - Y) * dt) * dW


@dataclasses.dataclass
class Beta(SDEBase):
    """dY = b/2 (S-Y)dt + sqrt(k Y(1-Y)) dW (Beta.hpp:106-126)."""

    b: Sequence[float] = (1.0,)
    S: Sequence[float] = (0.5,)
    kappa: Sequence[float] = (1.0,)

    @property
    def ncomp(self):
        return len(self.b)

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y)
        Y = _beta_step(Y, dW, _arr(self.b, Y), _arr(self.S, Y),
                       _arr(self.kappa, Y), dt)
        return self.put(P, Y)


class _FractionBetaMixin:
    """Adds instantaneous density/specific-volume slots (2*ncomp extra)."""

    @property
    def nprop(self):
        return 3 * self.ncomp

    def _derived(self, Y):
        """{offset: block} of the derived slots of Y."""
        rho = self.rho(Y)
        o, n = self.offset, self.ncomp
        return {o + n: rho, o + 2 * n: 1.0 / rho}

    def _store(self, P, Y):
        return _set(P, {self.offset: Y, **self._derived(Y)})


@dataclasses.dataclass
class NumberFractionBeta(_FractionBetaMixin, SDEBase):
    """Number-fraction beta: beta SDE + derived rho = rho2(1 - r'X), V=1/rho
    (NumberFractionBeta.hpp:120-190)."""

    b: Sequence[float] = (1.0,)
    S: Sequence[float] = (0.5,)
    kappa: Sequence[float] = (1.0,)
    rho2: Sequence[float] = (1.0,)
    rcomma: Sequence[float] = (0.5,)

    @property
    def ncomp(self):
        return len(self.b)

    def rho(self, X):
        return _arr(self.rho2, X) * (1.0 - _arr(self.rcomma, X) * X)

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        X = self.slice(P)
        dW = _gauss(key, X.shape[0], self.ncomp, X)
        X = _beta_step(X, dW, _arr(self.b, X), _arr(self.S, X),
                       _arr(self.kappa, X), dt)
        return self._store(P, X)


@dataclasses.dataclass
class MassFractionBeta(_FractionBetaMixin, SDEBase):
    """Mass-fraction beta: rho = rho2/(1 + r Y)
    (MassFractionBeta.hpp:47,187)."""

    b: Sequence[float] = (1.0,)
    S: Sequence[float] = (0.5,)
    kappa: Sequence[float] = (1.0,)
    rho2: Sequence[float] = (1.0,)
    r: Sequence[float] = (0.5,)

    @property
    def ncomp(self):
        return len(self.b)

    def rho(self, Y):
        return _arr(self.rho2, Y) / (1.0 + _arr(self.r, Y) * Y)

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y)
        Y = _beta_step(Y, dW, _arr(self.b, Y), _arr(self.S, Y),
                       _arr(self.kappa, Y), dt)
        return self._store(P, Y)


def _decay_coeffs(bprime, kprime, m, v):
    """DECAY policy: b = b'(1 - v/(m(1-m))), k = k'v, with means/variances
    clamped away from the no-mix/fully-mixed limits
    (MixNumberFractionBetaCoeffPolicy.cpp:71-96)."""
    m = torch.where((m < 1e-8) | (m > 1 - 1e-8), 0.5, m)
    v = torch.where((v < 1e-8) | (v > 1 - 1e-8), 0.5, v)
    b = bprime * (1.0 - v / (m * (1.0 - m)))
    k = kprime * v
    return b, k


def _mean_var(Y, nshard=1):
    m = _emean(Y, nshard)
    f = Y - m
    return m, _emean(f * f, nshard)


@dataclasses.dataclass
class MixNumberFractionBeta(_FractionBetaMixin, SDEBase):
    """Mix number-fraction beta: beta SDE with decay coefficient policy
    driven by the evolving mean/variance of X."""

    bprime: Sequence[float] = (1.0,)
    S: Sequence[float] = (0.5,)
    kprime: Sequence[float] = (1.0,)
    rho2: Sequence[float] = (1.0,)
    rcomma: Sequence[float] = (0.5,)

    @property
    def ncomp(self):
        return len(self.bprime)

    def rho(self, X):
        return _arr(self.rho2, X) * (1.0 - _arr(self.rcomma, X) * X)

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        X = self.slice(P)
        dW = _gauss(key, X.shape[0], self.ncomp, X)
        m, v = _mean_var(X, nshard)
        b, k = _decay_coeffs(_arr(self.bprime, X), _arr(self.kprime, X), m, v)
        X = _beta_step(X, dW, b, _arr(self.S, X), k, dt)
        return self._store(P, X)


def _homdecay_S(b, k, r, rho2, d, d2, d3):
    """The homogeneous-decay S constraint forcing d<rho>/dt = 0 where
    <rho> = rho2/(1+rY) (MixMassFracBetaCoeffHomDecay::update,
    src/DiffEq/Beta/MixMassFractionBetaCoeffPolicy.cpp:243-259)."""
    d = torch.where(d < 1e-8, 0.5, d)
    R = 1.0 + d2 / d / d
    B = -1.0 / r / r
    C = (2.0 + r) / r / r
    D = -(1.0 + r) / r / r
    diff = (
        B * d / rho2
        + C * d * d * R / rho2 / rho2
        + D * d * d * d * (1.0 + 3.0 * d2 / d / d + d3 / d / d / d)
        / rho2 / rho2 / rho2
    )
    return (
        rho2 / d / R
        + 2.0 * k / b * rho2 * rho2 / d / d * r * r / R * diff
        - 1.0
    ) / r


@dataclasses.dataclass
class MixMassFractionBeta(_FractionBetaMixin, SDEBase):
    """Mix mass-fraction beta with moment-coupled coefficient policies.

    coeff selects the policy (src/DiffEq/Beta/
    MixMassFractionBetaCoeffPolicy.cpp):
    - 'decay':     b = b'(1 - <y^2>/(<Y>(1-<Y>))), k = k'<y^2>
    - 'homdecay':  decay + S constrained so d<rho>/dt = 0
    - 'montecarlo_homdecay': the same constraint from raw MC moments
      (<YR^2>, <Y(1-Y)R^3>, <R^2>)
    - 'hydrotimescale': b, k scaled by the DNS inverse hydro-timescale
      (eps/k) and shaped by P/eps tables; S as homdecay without the
      [0, 1] clamp.  Needs hts/hp: per-component tables
      (diffeq.hydro.hydro_table).

    Derived per-particle slots (MixMassFractionBeta.hpp:308-318): R at
    ncomp+i, V=1/R at 2*ncomp+i, 1-Y at 3*ncomp+i.
    """

    bprime: Sequence[float] = (1.0,)
    S: Sequence[float] = (0.5,)
    kprime: Sequence[float] = (1.0,)
    rho2: Sequence[float] = (1.0,)
    r: Sequence[float] = (0.5,)
    coeff: str = "decay"
    hts: Optional[Tuple] = None  # per-comp Table callables (hydrotimescale)
    hp: Optional[Tuple] = None

    @property
    def ncomp(self):
        return len(self.bprime)

    @property
    def nprop(self):
        return 4 * self.ncomp

    def rho(self, Y):
        return _arr(self.rho2, Y) / (1.0 + _arr(self.r, Y) * Y)

    def _derived(self, Y):
        rho = self.rho(Y)
        o, n = self.offset, self.ncomp
        return {o + n: rho, o + 2 * n: 1.0 / rho, o + 3 * n: 1.0 - Y}

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y)
        bprime, kprime = _arr(self.bprime, Y), _arr(self.kprime, Y)
        r_, rho2_ = _arr(self.r, Y), _arr(self.rho2, Y)
        m, v = _mean_var(Y, nshard)

        if self.coeff in ("homdecay", "hydrotimescale"):
            R = self.rho(Y)
            d = _emean(R, nshard)
            rf = R - d
            d2 = _emean(rf * rf, nshard)
            d3 = _emean(rf * rf * rf, nshard)

        if self.coeff == "homdecay":
            b, k = _decay_coeffs(bprime, kprime, m, v)
            S = _homdecay_S(b, k, r_, rho2_, d, d2, d3)
            S = torch.where((S < 0.0) | (S > 1.0), 0.5, S)
        elif self.coeff == "montecarlo_homdecay":
            # S = (<YR^2> + 2k/b (r/rho2) <Y(1-Y)R^3>) / <R^2>
            # (MixMassFractionBetaCoeffPolicy.cpp:318-403)
            b, k = _decay_coeffs(bprime, kprime, m, v)
            R = self.rho(Y)
            r2 = _emean(R * R, nshard)
            yr2 = _emean(Y * R * R, nshard)
            y1myr3 = _emean(Y * (1.0 - Y) * (R * R * R), nshard)
            r2 = torch.where(r2 < 1e-8, 0.5, r2)
            S = (yr2 + 2.0 * k / b * r_ / rho2_ * y1myr3) / r2
            S = torch.where((S < 0.0) | (S > 1.0), 0.5, S)
        elif self.coeff == "hydrotimescale":
            V = 1.0 / R
            RY = _emean(R * Y, nshard)
            ds = -_emean(rf * (V - _emean(V, nshard)), nshard)  # -<rv>
            yt = RY / d
            ts = torch.tensor([tb(t) for tb in self.hts], dtype=Y.dtype,
                              device=Y.device)              # eps/k
            pe = torch.tensor([tb(t) for tb in self.hp], dtype=Y.dtype,
                              device=Y.device)              # P/eps
            # b1..b3 are the FIRST THREE deck S values regardless of comp
            # (MixMassFractionBetaCoeffPolicy.cpp:567)
            if len(self.S) < 3:
                raise ValueError(
                    "hydrotimescale policy needs >= 3 S entries (the first "
                    "three seed the beta-shape constants b1..b3)")
            Sdeck = _arr(self.S, Y)
            b1, b2, b3 = Sdeck[0], Sdeck[1], Sdeck[2]
            a = r_ / (1.0 + r_ * yt)
            bnm = a * a * yt * (1.0 - yt)
            thetab = 1.0 - ds / bnm
            pm1 = pe - 1.0
            f2 = 1.0 / torch.sqrt(1.0 + pm1 * pm1 * torch.pow(ds, 0.25))
            eta = d2 / d / d / ds
            beta2 = b2 * (1.0 + eta * ds)
            Thetap = thetab * 0.5 * (1.0 + eta / (1.0 + eta * ds))
            beta3 = b3 * (1.0 + eta * ds)
            beta10 = b1 * (1.0 + ds) / (1.0 + eta * ds)
            beta1 = bprime * 2.0 / (1.0 + eta + eta * ds) * (
                beta10 + beta2 * Thetap * f2
                + beta3 * Thetap * (1.0 - Thetap) * f2
            )
            b = beta1 * ts
            k = kprime * beta1 * ts * ds * ds
            S = _homdecay_S(b, k, r_, rho2_, d, d2, d3)
        else:  # plain decay
            b, k = _decay_coeffs(bprime, kprime, m, v)
            S = _arr(self.S, Y)

        Y = _beta_step(Y, dW, b, S, k, dt)
        return self._store(P, Y)


@dataclasses.dataclass
class Dirichlet(SDEBase):
    """K=N-1 Dirichlet SDE (Dirichlet.hpp:116-141)."""

    b: Sequence[float] = (1.0, 1.5)
    S: Sequence[float] = (0.4, 0.4)
    kappa: Sequence[float] = (1.0, 1.0)

    @property
    def ncomp(self):
        return len(self.b)

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y)
        b, S, k = _arr(self.b, Y), _arr(self.S, Y), _arr(self.kappa, Y)
        yn = 1.0 - Y.sum(dim=1, keepdim=True)
        Y = Y + 0.5 * b * (S * yn - (1.0 - S) * Y) * dt + _sqrt_pos(
            k * Y * yn * dt
        ) * dW
        return self.put(P, Y)


@dataclasses.dataclass
class GeneralizedDirichlet(SDEBase):
    """Lochner's generalized Dirichlet (GeneralizedDirichlet.hpp:150-190)."""

    b: Sequence[float] = (1.0, 1.5)
    S: Sequence[float] = (0.4, 0.4)
    kappa: Sequence[float] = (1.0, 1.0)
    #: upper-triangular c_ij coefficients, K(K-1)/2 of them, row-major
    cij: Sequence[float] = (0.0,)

    @property
    def ncomp(self):
        return len(self.b)

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        Y = self.slice(P)
        n = self.ncomp
        dW = _gauss(key, Y.shape[0], n, Y)
        b, S, k = _arr(self.b, Y), _arr(self.S, Y), _arr(self.kappa, Y)

        # Y_i = 1 - sum_{k<=i} y_k  (cumulative remainder)
        Ycum = 1.0 - torch.cumsum(Y, dim=1)
        inv = 1.0 / Ycum
        # U_i = prod_{j>i} 1/Ycum_j (a reverse cumulative product), U_{n-1}=1
        U = torch.cat([torch.flip(torch.cumprod(torch.flip(inv, (1,))[:, 1:],
                                                dim=1), (1,)),
                       torch.ones_like(inv[:, :1])], dim=1)

        # a_i = sum_{j=i}^{n-2} c_ij / Ycum_j
        cmat = np.zeros((n, n))
        idx = 0
        cij = np.asarray(self.cij, dtype=np.float64)
        for i in range(n):
            for j in range(i, n - 1):
                cmat[i, j] = cij[idx] if idx < len(cij) else 0.0
                idx += 1
        a = inv @ _arr(cmat, Y).T

        YN = Ycum[:, -1:]
        d = _sqrt_pos(k * Y * YN * U * dt)
        drift = U / 2.0 * (b * (S * YN - (1.0 - S) * Y) + Y * YN * a)
        Y = Y + drift * dt + d * dW
        return self.put(P, Y)


@dataclasses.dataclass
class MixDirichlet(SDEBase):
    """Mix Dirichlet: K advanced scalars + YN keeping the sum at 1, plus
    derived density/volume slots (MixDirichlet.hpp:141-231).

    coeff: 'const_coeff' keeps the deck S; 'homogeneous' (and
    'hydrotimescale', whose active reference code is the same) updates S
    from MC moments so the mixture density stays homogeneous
    (MixDirichletCoeffPolicy.cpp:196-272).

    The deck's rho vector is pre-sorted by normalization (heavy:
    ascending so rho_N = rho_H; light: descending -- Grammar.hpp:
    495-506) and r_i = rho_N/rho_i -+ 1 (MixDir_r)."""

    b: Sequence[float] = (1.0, 1.5)
    S: Sequence[float] = (0.4, 0.4)
    kprime: Sequence[float] = (1.0, 1.0)
    rho: Sequence[float] = (1.0, 1.0, 1.0)  # N material densities
    r: Sequence[float] = ()
    coeff: str = "const_coeff"
    normalization: str = "light"

    @property
    def ncomp(self):
        return len(self.b)

    @property
    def nprop(self):
        # K advanced + YN + density + volume
        return self.ncomp + 3

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        n = self.ncomp
        o = self.offset
        Y = P[:, o:o + n]
        yn = P[:, o + n:o + n + 1]
        dW = _gauss(key, Y.shape[0], n, Y)
        b = _arr(self.b, Y)
        k = _arr(self.kprime, Y)  # k = kprime for const/homogeneous
        rhoN = _arr(self.rho, Y)
        if self.coeff in ("homogeneous", "hydrotimescale"):
            R = P[:, o + n + 1:o + n + 2]  # derived density slot
            R2 = R * R
            R2Y = _emean(R2 * Y, nshard)                # <R^2 Yc>
            R2YN = _emean_all(R2 * yn, nshard)          # <R^2 YN>
            R3YNY = _emean(R2 * R * Y * yn, nshard)     # <R^3 Yc YN>
            if self.normalization == "light":           # rho sorted desc
                rhoL, rhoH = rhoN[-1], rhoN[0]
                rc = (rhoL / rhoN[:-1] + 1.0 - 2.0) * rhoH / rhoL
            else:                                       # rho sorted asc
                rhoL, rhoH = rhoN[0], rhoN[-1]
                rc = _arr(self.r, Y) if len(self.r) else (
                    rhoN[-1] / rhoN[:-1] - 1.0)
            S = (R2Y + 2.0 * k / b * rc / rhoH * R3YNY) / (R2Y + R2YN)
        else:
            S = _arr(self.S, Y)
        dY = 0.5 * b * (S * yn - (1.0 - S) * Y) * dt + _sqrt_pos(
            k * Y * yn * dt
        ) * dW
        Y = Y + dY
        yn = yn - dY.sum(dim=1, keepdim=True)
        # instantaneous density: 1/rho = sum_alpha Y_alpha/rho_alpha
        vol = (torch.cat([Y, yn], dim=1) / rhoN).sum(dim=1, keepdim=True)
        return _set(P, {o: Y, o + n: yn, o + n + 1: 1.0 / vol,
                        o + n + 2: vol})

    def initialize_derived(self, P):
        """Fill the density/volume slots from the initial Y (the
        reference's initialize() calls derived() per particle)."""
        n, o = self.ncomp, self.offset
        Yall = P[:, o:o + n + 1]
        vol = (Yall / _arr(self.rho, P)).sum(dim=1, keepdim=True)
        return _set(P, {o + n + 1: 1.0 / vol, o + n + 2: vol})


@dataclasses.dataclass
class Gamma(SDEBase):
    """dY = b/2 (S - (1-S)Y)dt + sqrt(k Y)dW (Gamma.hpp:104-124)."""

    b: Sequence[float] = (1.0,)
    S: Sequence[float] = (0.5,)
    kappa: Sequence[float] = (1.0,)

    @property
    def ncomp(self):
        return len(self.b)

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y)
        b, S, k = _arr(self.b, Y), _arr(self.S, Y), _arr(self.kappa, Y)
        Y = Y + 0.5 * b * (S - (1.0 - S) * Y) * dt + _sqrt_pos(k * Y * dt) * dW
        return self.put(P, Y)


@dataclasses.dataclass
class SkewNormal(SDEBase):
    """Skew-normal SDE (SkewNormal.hpp:136-161)."""

    T: Sequence[float] = (1.0,)
    sigmasq: Sequence[float] = (1.0,)
    lam: Sequence[float] = (1.0,)

    @property
    def ncomp(self):
        return len(self.T)

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        X = self.slice(P)
        dW = _gauss(key, X.shape[0], self.ncomp, X)
        T, s2, lam = _arr(self.T, X), _arr(self.sigmasq, X), _arr(self.lam, X)
        drift = -(
            X
            - lam * s2 * math.sqrt(2.0 / math.pi)
            * torch.exp(-(lam * lam) * (X * X) / 2.0)
            / (1.0 + torch.erf(lam * X / math.sqrt(2.0)))
        ) / T
        X = X + drift * dt + _sqrt_pos(2.0 * s2 / T * dt) * dW
        return self.put(P, X)


@dataclasses.dataclass
class WrightFisher(SDEBase):
    """Wright-Fisher: dY_i = (omega_i - Omega Y_i)/2 dt + sigma(Y)dW with
    diffusion B = diag(Y) - Y Y^T, whose square root is taken per particle
    by a symmetric eigendecomposition with negative eigenvalues clamped
    (the reference leaves this step unfinished, WrightFisher.hpp:141-160).
    """

    omega: Sequence[float] = (0.25, 0.5, 0.25)

    @property
    def ncomp(self):
        return len(self.omega)

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        Y = self.slice(P)
        n = self.ncomp
        om = _arr(self.omega, Y)
        Om = om.sum()
        dW = _gauss(key, Y.shape[0], n, Y)

        eye = torch.eye(n, dtype=Y.dtype, device=Y.device)
        B = eye * Y[:, :, None] - Y[:, :, None] * Y[:, None, :]
        w, V = torch.linalg.eigh(B)
        sqB = (V * torch.sqrt(torch.clamp(w, min=0.0))[:, None, :]
               ) @ V.transpose(1, 2)
        Y = Y + 0.5 * (om - Om * Y) * dt + math.sqrt(dt) * (
            sqB @ dW[:, :, None])[:, :, 0]
        return self.put(P, Y)


@dataclasses.dataclass
class Position(SDEBase):
    """dX = (dU X + u) dt: particle position with coupled velocity
    (Position.hpp:82-102).  velocity_offset points at the coupled Velocity
    system's slots."""

    dU: Sequence[float] = (0.0,) * 9  # prescribed mean velocity gradient
    velocity_offset: int = 3

    ncomp = 3

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        X = self.slice(P)
        u = P[:, self.velocity_offset:self.velocity_offset + 3]
        G = _arr(np.asarray(self.dU, dtype=np.float64).reshape(3, 3), X)
        X = X + (X @ G.T + u) * dt
        return self.put(P, X)


def _rij(fluc, nshard=1):
    """The single-point velocity covariance <u_i u_j> (3, 3)."""
    return _emean(fluc[:, :, None] * fluc[:, None, :], nshard)


@dataclasses.dataclass
class Dissipation(SDEBase):
    """Turbulence-frequency (gamma-distribution) model coupled to velocity
    (Dissipation.hpp:92-141)."""

    c3: float = 1.0
    c4: float = 0.25
    com1: float = 0.44
    com2: float = 0.9
    velocity_offset: int = 0
    prescribed_shear: float = 1.0

    ncomp = 1

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        Op = self.slice(P)
        O = _emean_all(Op, nshard)
        u = P[:, self.velocity_offset:self.velocity_offset + 3]
        rij = _rij(u - _emean(u, nshard), nshard)
        tke = 0.5 * (rij[0, 0] + rij[1, 1] + rij[2, 2])
        Prod = -rij[0, 1] * self.prescribed_shear
        Som = self.com2 - self.com1 * Prod / (O * tke)
        dW = _gauss(key, Op.shape[0], 1, Op)
        d = _sqrt_pos(2.0 * self.c3 * self.c4 * O * O * Op * dt)
        Op = Op + (-self.c3 * (Op - O) - Som * Op) * O * dt + d * dW
        return self.put(P, Op)


def _glm_G(hts, C0, rij, dU):
    """Generalized Langevin model drift tensor (Langevin.cpp glm():
    Haworth-Pope coefficients over the Reynolds-stress anisotropy)."""
    A1, A2 = -(0.5 + 0.75 * C0), 3.7
    B1, B2, B3 = -0.2, 0.8, -0.2
    G1, G2, G3, G4, G5, G6 = -1.28, 3.01, -2.18, 0.0, 4.29, -3.09
    eye = torch.eye(3, dtype=rij.dtype, device=rij.device)
    tr = rij[0, 0] + rij[1, 1] + rij[2, 2]
    b = rij / tr - eye / 3.0
    trdU = dU[0, 0] + dU[1, 1] + dU[2, 2]
    dtmp = (b * dU).sum()
    G = (hts * A1 + B1 * trdU + G1 * dtmp) * eye
    G = G + hts * A2 * b + B2 * dU + B3 * dU.T + G4 * b * trdU
    G = G + G2 * torch.einsum("jl,il->ij", b, dU)
    G = G + G3 * torch.einsum("jl,li->ij", b, dU)
    G = G + G5 * torch.einsum("il,lj->ij", b, dU)
    G = G + G6 * torch.einsum("il,jl->ij", b, dU)
    return G


@dataclasses.dataclass
class Velocity(SDEBase):
    """Simplified Langevin model (Velocity.hpp:111-155, Langevin.cpp):
    dU_i = G_ij (U_j - <U_j>) dt + sqrt(C0 eps) dW_i.

    coeff selects the policy (VelocityCoeffPolicy.cpp):
    - 'const_shear' : G = -(1/2+3C0/4) eps/k I - dU, eps from the
      coupled Dissipation system (eps = k <omega>) or unit timescale
    - 'stationary'  : eps=1, G = -(3C0/4) I
    - 'hydrotimescale': ts = hts(t) (DNS eps/k table), eps = ts*k,
      G = -(1/2+3C0/4) ts I
    """

    c0: float = 2.1
    dissipation_offset: Optional[int] = None
    dU: Sequence[float] = (0.0,) * 9  # mean velocity gradient (shear)
    coeff: str = "const_shear"
    variant: str = "slm"  # slm | glm (Langevin.cpp slm()/glm())
    hts: Optional[object] = None  # Table callable (hydrotimescale)

    ncomp = 3

    def advance(self, key, P, dt, t, moments=None, nshard=1):
        U = self.slice(P)
        fluc = U - _emean(U, nshard)
        rij = _rij(fluc, nshard)
        k = 0.5 * (rij[0, 0] + rij[1, 1] + rij[2, 2])
        eye = torch.eye(3, dtype=U.dtype, device=U.device)
        if self.coeff == "stationary":
            eps = torch.ones((), dtype=U.dtype, device=U.device)
            G = (-0.75 * self.c0) * eye
        elif self.coeff == "hydrotimescale":
            ts = torch.tensor(self.hts(t), dtype=U.dtype, device=U.device)
            eps = ts * k
            G = (-(0.5 + 0.75 * self.c0) * ts) * eye
        else:  # const_shear
            if self.dissipation_offset is not None:
                O = _emean_all(P[:, self.dissipation_offset], nshard)
                eps = k * O
            else:
                eps = k  # unit-timescale fallback
            dUm = _arr(np.asarray(self.dU, dtype=np.float64).reshape(3, 3),
                       U)
            if self.variant == "glm":
                G = _glm_G(eps / k, self.c0, rij, dUm)
            else:
                G = (-(0.5 + 0.75 * self.c0) * eps / k) * eye
            # the prescribed shear is subtracted AFTER the policy tensor
            # (Velocity.hpp:132)
            G = G - dUm
        dW = _gauss(key, U.shape[0], 3, U)
        d = _sqrt_pos(self.c0 * eps * dt)
        U = U + (fluc @ G.T) * dt + d * dW
        return self.put(P, U)
