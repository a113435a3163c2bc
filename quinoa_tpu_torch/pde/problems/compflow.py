"""Compressible-flow (Euler) problems, component-major layout.

Port of quinoa_tpu/pde/problems/compflow.py: the problem base class with
its manufactured source, the inviscid flux column and every problem of
the JAX package: SedovBlastwave (reference SedovBlastwave.cpp:28-100),
SodShocktube (SodShocktube.cpp:28-100) and RotatedSodShocktube,
VorticalFlow (VorticalFlow.cpp:28-64), TaylorGreen (TaylorGreen.cpp:
28-90), the time-dependent manufactured NLEnergyGrowth and RayleighTaylor
(NLEnergyGrowth.cpp:25-190, RayleighTaylor.cpp:28-200) and the quiescent
UserDefined.  Coordinates
arrive as (3, n); solutions are (5, n) with conservative components
(rho, rho*u, rho*v, rho*w, rhoE).

Manufactured sources are derived by forward-mode automatic
differentiation, as the JAX package derives them with jax.jvp: for a
manufactured solution U(x, t) of the Euler system the source is
S = dU/dt + div F(U), evaluated with torch.func.jvp along t and along the
three coordinate directions.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.func import jvp

from ..eos import StiffenedGas


def euler_flux_dir(U: torch.Tensor, p: torch.Tensor, j: int) -> torch.Tensor:
    """Column j of the inviscid flux for component-major states U (5, n)."""
    rho = U[0]
    vj = U[1 + j] / rho
    return torch.stack(
        [
            U[1 + j],
            U[1] * vj + (p if j == 0 else 0.0),
            U[2] * vj + (p if j == 1 else 0.0),
            U[3] * vj + (p if j == 2 else 0.0),
            (U[4] + p) * vj,
        ]
    )


class CompFlowProblem:
    """Base for Euler problems: analytic solution + autodiff source."""

    ncomp: int = 5
    eos: StiffenedGas = StiffenedGas(gamma=1.4)
    #: True if the analytic solution satisfies Euler only with a
    #: manufactured source
    manufactured: bool = False
    #: True if the solution does not depend on t (then so do the source
    #: and the Dirichlet values, and solvers may evaluate them once)
    steady: bool = False

    def analytic(self, xyz, t):
        return self.solution(xyz, t)

    def solinc(self, xyz, t, dt):
        """Dirichlet increment U(t + dt) - U(t), (5, n): exactly zero for a
        steady problem, which is returned without evaluating U."""
        if self.steady:
            return torch.zeros((5,) + tuple(xyz.shape[1:]), dtype=xyz.dtype,
                               device=xyz.device)
        return self.solution(xyz, t + dt) - self.solution(xyz, t)

    def src(self, xyz, t):
        """Manufactured source S = dU/dt + div F(U), or zeros: (5, n)."""
        if not self.manufactured:
            return torch.zeros((5,) + tuple(xyz.shape[1:]), dtype=xyz.dtype,
                               device=xyz.device)
        t = torch.as_tensor(t, dtype=xyz.dtype, device=xyz.device)
        _, dUdt = jvp(lambda tt: self.solution(xyz, tt), (t,),
                      (torch.ones_like(t),))

        def flux_j(p, j):
            U = self.solution(p, t)
            return euler_flux_dir(U, self.eos.pressure_cons_cm(U), j)

        divF = torch.zeros_like(dUdt)
        for j in range(3):
            tangent = torch.zeros_like(xyz)
            tangent[j] = 1.0
            _, dFj = jvp(lambda p, jj=j: flux_j(p, jj), (xyz,), (tangent,))
            divF = divF + dFj
        return dUdt + divF


@dataclasses.dataclass(frozen=True)
class SedovBlastwave(CompFlowProblem):
    """Sedov blast wave ICs: a high-pressure corner region."""

    #: hard-coded in the reference (SedovBlastwave.cpp:55), not deck input
    p_hot: float = 783.4112
    p_ambient: float = 1.0e-6
    rcorner: float = 0.05
    eos: StiffenedGas = StiffenedGas(gamma=1.4)

    def solution(self, xyz, t):
        x, y = xyz[0], xyz[1]
        hot = (x < self.rcorner) & (y < self.rcorner)
        r = torch.ones_like(x)
        pr = torch.where(hot, torch.full_like(x, self.p_hot),
                         torch.full_like(x, self.p_ambient))
        u = torch.zeros_like(x)
        rE = self.eos.totalenergy(r, u, u, u, pr)
        z = torch.zeros_like(x)
        return torch.stack([r, z, z, z, rE])


@dataclasses.dataclass(frozen=True)
class SodShocktube(CompFlowProblem):
    """Sod shock tube ICs (SodShocktube.cpp:28-100); like the reference,
    `solution` returns the t=0 state (no exact Riemann evolution)."""

    eos: StiffenedGas = StiffenedGas(gamma=1.4)

    def solution(self, xyz, t):
        x = xyz[0]
        left = x < 0.5
        r = torch.where(left, torch.full_like(x, 1.0),
                        torch.full_like(x, 0.125))
        pr = torch.where(left, torch.full_like(x, 1.0),
                         torch.full_like(x, 0.1))
        u = torch.zeros_like(x)
        rE = self.eos.totalenergy(r, u, u, u, pr)
        z = torch.zeros_like(x)
        return torch.stack([r, z, z, z, rE])


@dataclasses.dataclass(frozen=True)
class VorticalFlow(CompFlowProblem):
    """Steady vortical flow manufactured solution (VorticalFlow.cpp:28-64);
    regression decks use gamma=5/3, alpha=0.1, beta=1.0, p0=10."""

    alpha: float = 0.1
    beta: float = 1.0
    p0: float = 10.0
    eos: StiffenedGas = StiffenedGas(gamma=5.0 / 3.0)
    manufactured: bool = True
    steady: bool = True

    def solution(self, xyz, t):
        a, b, g = self.alpha, self.beta, self.eos.gamma
        x, y, z = xyz[0], xyz[1], xyz[2]
        ru = a * x - b * y
        rv = b * x + a * y
        rw = -2.0 * a * z
        rE = (ru * ru + rv * rv + rw * rw) / 2.0 + (
            self.p0 - 2.0 * a * a * z * z
        ) / (g - 1.0)
        return torch.stack([torch.ones_like(x), ru, rv, rw, rE])


@dataclasses.dataclass(frozen=True)
class TaylorGreen(CompFlowProblem):
    """Steady 2-D Taylor-Green vortex (TaylorGreen.cpp:28-90); the closed
    form of its energy source assumes gamma=5/3, which all reference decks
    set."""

    eos: StiffenedGas = StiffenedGas(gamma=5.0 / 3.0)
    manufactured: bool = True
    steady: bool = True

    def solution(self, xyz, t):
        x, y = xyz[0], xyz[1]
        r = torch.ones_like(x)
        pr = 10.0 + (torch.cos(2 * math.pi * x)
                     + torch.cos(2 * math.pi * y)) / 4.0
        u = torch.sin(math.pi * x) * torch.cos(math.pi * y)
        v = -torch.cos(math.pi * x) * torch.sin(math.pi * y)
        w = torch.zeros_like(x)
        rE = self.eos.totalenergy(r, u, v, w, pr)
        return torch.stack([r, r * u, r * v, r * w, rE])


@dataclasses.dataclass(frozen=True)
class RotatedSodShocktube(SodShocktube):
    """Sod tube rotated by (-45, -45, -45) degrees about X, Y, Z
    (RotatedSodShocktube.cpp): the unrotated problem evaluated in the
    rotated frame.  The rotation is made in float64 numpy and cast to the
    coordinates' dtype, as the JAX package makes it."""

    def solution(self, xyz, t):
        c, s = np.cos(-np.pi / 4), np.sin(-np.pi / 4)
        Rx = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        Ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        R = torch.as_tensor(Rx @ Ry @ Rz, dtype=xyz.dtype, device=xyz.device)
        q = torch.tensordot(R, xyz, dims=1)
        return SodShocktube.solution(self, q, t)


@dataclasses.dataclass(frozen=True)
class NLEnergyGrowth(CompFlowProblem):
    """Nonlinear energy growth manufactured solution
    (NLEnergyGrowth.cpp:25-190); time-dependent, so its source and
    Dirichlet values are evaluated at every stage's time."""

    alpha: float = 0.25
    betax: float = 1.0
    betay: float = 0.75
    betaz: float = 0.5
    r0: float = 2.0
    ce: float = -1.0
    kappa: float = 0.8
    eos: StiffenedGas = StiffenedGas(gamma=5.0 / 3.0)
    manufactured: bool = True

    def solution(self, xyz, t):
        x, y, z = xyz[0], xyz[1], xyz[2]
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        gx = 1.0 - x * x - y * y - z * z
        h = (torch.cos(self.betax * math.pi * x)
             * torch.cos(self.betay * math.pi * y)
             * torch.cos(self.betaz * math.pi * z))
        ft = torch.exp(-self.alpha * t)
        r = self.r0 + ft * gx
        ec = (-3.0 * (self.ce + self.kappa * h * h * t)) ** (-1.0 / 3.0)
        zero = torch.zeros_like(x)
        return torch.stack([r, zero, zero, zero, r * ec])


@dataclasses.dataclass(frozen=True)
class RayleighTaylor(CompFlowProblem):
    """Time-dependent Rayleigh-Taylor manufactured solution
    (RayleighTaylor.cpp:28-200)."""

    alpha: float = 1.0
    betax: float = 1.0
    betay: float = 1.0
    betaz: float = 1.0
    p0: float = 1.0
    r0: float = 1.0
    kappa: float = 1.0
    eos: StiffenedGas = StiffenedGas(gamma=5.0 / 3.0)
    manufactured: bool = True

    def solution(self, xyz, t):
        x, y, z = xyz[0], xyz[1], xyz[2]
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        gx = self.betax * x * x + self.betay * y * y + self.betaz * z * z
        r = self.r0 - gx
        pr = self.p0 + self.alpha * gx
        ft = torch.cos(self.kappa * math.pi * t)
        u = ft * z * torch.sin(math.pi * x)
        v = ft * z * torch.cos(math.pi * y)
        w = ft * (-0.5 * math.pi * z * z
                  * (torch.cos(math.pi * x) - torch.sin(math.pi * y)))
        rE = self.eos.totalenergy(r, u, v, w, pr)
        return torch.stack([r, r * u, r * v, r * w, rE])


@dataclasses.dataclass(frozen=True)
class UserDefined(CompFlowProblem):
    """Quiescent user-defined ICs (UserDefined.cpp)."""

    eos: StiffenedGas = StiffenedGas(gamma=1.4)
    steady: bool = True

    def solution(self, xyz, t):
        one = torch.ones_like(xyz[0])
        zero = torch.zeros_like(xyz[0])
        return torch.stack([one, zero, zero, zero, one])
