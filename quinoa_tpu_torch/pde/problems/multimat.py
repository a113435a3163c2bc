"""Multi-material problem policies, component-major layout.

Port of quinoa_tpu/pde/problems/multimat.py (reference src/PDE/MultiMat/
Problem/{InterfaceAdvection,SodShocktube}.cpp) with the MultiMatIndexing
layout of pde/multimat.py.  Coordinates arrive as (3, n); solutions are
(3*nmat + 3, n).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..eos import StiffenedGas
from ..multimat import density_idx, energy_idx, momentum_idx, volfrac_idx

ALPHAMIN = 1.0e-12


def _state(nmat, alpha, dens, energy, rhob, vel):
    """Stack the 3*nmat + 3 rows from per-material fractions, partial
    densities and energies, the bulk density and the velocity."""
    s = [None] * (3 * nmat + 3)
    for k in range(nmat):
        s[volfrac_idx(nmat, k)] = alpha[k]
        s[density_idx(nmat, k)] = dens[k]
        s[energy_idx(nmat, k)] = energy[k]
    for i in range(3):
        s[momentum_idx(nmat, i)] = rhob * vel[i]
    return torch.stack(s)


@dataclasses.dataclass(frozen=True)
class MMInterfaceAdvection:
    """Concentric material rings advected diagonally at |v|=10
    (InterfaceAdvection.cpp:36-105); densities from the ideal-gas
    p=1e5, T=300 state per material."""

    nmat: int = 3
    eos: Tuple[StiffenedGas, ...] = (
        StiffenedGas(gamma=1.4, cv=83.33),
        StiffenedGas(gamma=1.4, cv=717.5),
        StiffenedGas(gamma=1.4, cv=717.5),
    )

    def solution(self, xyz, t):
        nmat = self.nmat
        x, y = xyz[0], xyz[1]
        u = v = math.sqrt(50.0)
        w = 0.0
        x0, y0 = 0.45 + u * t, 0.45 + v * t

        r0 = [0.0] * nmat
        r0[nmat - 1] = 0.0
        r0[nmat - 2] = 0.1
        r0[0] = 0.35
        for k in range(1, nmat - 2):
            r0[k] = r0[k - 1] - (r0[0] - r0[nmat - 2]) / max(1.0, nmat - 2)

        dx, dy = x - x0, y - y0
        r = torch.sqrt(dx * dx + dy * dy)
        alpha = [torch.full_like(x, ALPHAMIN) for _ in range(nmat)]
        big = 1.0 - (nmat - 1) * ALPHAMIN
        assigned = torch.zeros_like(x, dtype=torch.bool)
        for k in range(nmat - 1):
            m = (r < r0[k]) & (r >= r0[k + 1])
            alpha[k] = torch.where(m, big, alpha[k])
            assigned = assigned | m
        alpha[nmat - 1] = torch.where(~assigned, big, alpha[nmat - 1])

        dens, energy = [], []
        rhob = torch.zeros_like(x)
        for k in range(nmat):
            rhok = self.eos[k].density(1.0e5, 300.0)
            dens.append(alpha[k] * rhok)
            energy.append(alpha[k] * self.eos[k].totalenergy(rhok, u, v, w,
                                                             1.0e5))
            rhob = rhob + dens[k]
        return _state(nmat, alpha, dens, energy, rhob, (u, v, w))


@dataclasses.dataclass(frozen=True)
class MMSmoothWave:
    """Smooth multi-material density waves advected by a uniform flow
    (constant pressure, velocity and fractions): an exact solution whose
    non-conservative terms vanish, the DG(P1) convergence anchor."""

    nmat: int = 2
    eos: Tuple[StiffenedGas, ...] = (
        StiffenedGas(gamma=1.4),
        StiffenedGas(gamma=1.6),
    )
    vel: Tuple[float, float, float] = (1.0, 0.5, 0.0)
    p0: float = 2.0

    def solution(self, xyz, t):
        nmat = self.nmat
        x, y = xyz[0], xyz[1]
        u, v, w = self.vel
        xi = x - u * t
        eta = y - v * t
        two_pi = 2.0 * math.pi
        alpha = [torch.full_like(x, 1.0 / nmat) for _ in range(nmat)]
        dens, energy = [], []
        rhob = torch.zeros_like(x)
        for k in range(nmat):
            rk = (1.0 + 0.5 * k
                  + 0.2 * torch.sin(two_pi * xi) * torch.cos(two_pi * eta))
            dens.append(alpha[k] * rk)
            energy.append(alpha[k] * self.eos[k].totalenergy(rk, u, v, w,
                                                             self.p0))
            rhob = rhob + dens[k]
        return _state(nmat, alpha, dens, energy, rhob, (u, v, w))


@dataclasses.dataclass(frozen=True)
class MMSodShocktube:
    """Two-material Sod shock tube (MultiMat SodShocktube.cpp): material 0
    fills the left state, material 1 the right, alphamin elsewhere."""

    nmat: int = 2
    eos: Tuple[StiffenedGas, ...] = (
        StiffenedGas(gamma=1.4),
        StiffenedGas(gamma=1.4),
    )

    def solution(self, xyz, t):
        x = xyz[0]
        left = x < 0.5
        big = 1.0 - (self.nmat - 1) * ALPHAMIN

        def pick(a, b):
            return torch.where(left, torch.full_like(x, a),
                               torch.full_like(x, b))

        a0, a1 = pick(big, ALPHAMIN), pick(ALPHAMIN, big)
        r, p = pick(1.0, 0.125), pick(1.0, 0.1)
        zero = torch.zeros_like(x)
        # both materials carry the local (rho, p) state
        dens = [a0 * r, a1 * r]
        energy = [a * self.eos[k].totalenergy(r, zero, zero, zero, p)
                  for k, a in enumerate((a0, a1))]
        return _state(self.nmat, [a0, a1], dens, energy, zero,
                      (zero, zero, zero))
