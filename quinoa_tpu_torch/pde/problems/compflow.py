"""Compressible-flow (Euler) problems, component-major layout.

Port of the part of quinoa_tpu/pde/problems/compflow.py the Sedov slice
needs: the problem base class, SedovBlastwave
(reference SedovBlastwave.cpp:28-100) and the inviscid flux column.
Coordinates arrive as (3, n); solutions are (5, n) with conservative
components (rho, rho*u, rho*v, rho*w, rhoE).
"""

from __future__ import annotations

import dataclasses

import torch

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
    """Base for Euler problems: analytic solution, no source."""

    ncomp: int = 5
    eos: StiffenedGas = StiffenedGas(gamma=1.4)
    #: manufactured solutions need a source term, which is not ported
    manufactured: bool = False

    def analytic(self, xyz, t):
        return self.solution(xyz, t)

    def src(self, xyz, t):
        """Zeros (5, n) for non-manufactured problems."""
        if self.manufactured:
            raise NotImplementedError(
                "manufactured-solution sources are not ported")
        return torch.zeros((5,) + tuple(xyz.shape[1:]), dtype=xyz.dtype,
                           device=xyz.device)


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
