"""Stiffened-gas equation of state on torch tensors.

Port of quinoa_tpu/pde/eos.py (reference src/PDE/EoS/EoS.hpp:30-160):
p = (rhoE - rho*|v|^2/2 - pstiff)*(gamma-1) - pstiff,
a = sqrt(gamma*(p+pstiff)/rho).  The CUDA kernels evaluate the same
expressions in the same order (csrc/common.cuh).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class StiffenedGas:
    gamma: float = 1.4
    pstiff: float = 0.0
    cv: float = 717.5

    def pressure(self, rho, u, v, w, rhoE):
        return (rhoE - 0.5 * rho * (u * u + v * v + w * w) - self.pstiff) * (
            self.gamma - 1.0
        ) - self.pstiff

    def pressure_cons_cm(self, U):
        """Pressure from component-major conservative variables U (5, ...)."""
        rho = U[0]
        return self.pressure(rho, U[1] / rho, U[2] / rho, U[3] / rho, U[4])

    def soundspeed_cons_cm(self, U):
        """Sound speed of component-major conservative variables U (5, ...),
        the pressure floored at 0."""
        p = torch.clamp_min(self.pressure_cons_cm(U), 0.0)
        return self.soundspeed(U[0], p)

    def soundspeed(self, rho, p):
        return torch.sqrt(self.gamma * (p + self.pstiff) / rho)

    def totalenergy(self, rho, u, v, w, p):
        return ((p + self.pstiff) / (self.gamma - 1.0) + self.pstiff
                + 0.5 * rho * (u * u + v * v + w * w))

    def density(self, p, temp):
        """Density at pressure p and temperature temp (floats or tensors)."""
        return (p + self.pstiff) / ((self.gamma - 1.0) * self.cv * temp)
