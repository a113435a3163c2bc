"""Scalar-transport problems, component-major layout.

Port of the part of quinoa_tpu/pde/problems/transport.py the DG transport
path needs: the problem base class and GaussHump (reference
GaussHump.cpp).  Coordinates arrive as (3, n) (or (3, G, n));

  solution(xyz, t) -> (C, n)      initial/analytic solution
  velocity(xyz, t) -> (C, 3, n)   prescribed advection velocity
"""

from __future__ import annotations

import dataclasses

import torch


class TransportProblem:
    """Base: analytic solution = solution."""

    ncomp: int = 1

    def analytic(self, xyz, t):
        return self.solution(xyz, t)


@dataclasses.dataclass
class GaussHump(TransportProblem):
    """Gaussian hump advected by constant velocity (0.1, 0.1, 0)."""

    ncomp: int = 1

    def velocity(self, xyz, t):
        sh = xyz.shape[1:]
        opts = dict(dtype=xyz.dtype, device=xyz.device)
        v = torch.stack([torch.full(sh, 0.1, **opts),
                         torch.full(sh, 0.1, **opts),
                         torch.zeros(sh, **opts)])
        return v[None].expand((self.ncomp,) + tuple(v.shape))

    def solution(self, xyz, t):
        x, y = xyz[0], xyz[1]
        x0 = 0.25 + 0.1 * t
        y0 = 0.25 + 0.1 * t
        s = torch.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2.0 * 0.005))
        return s[None].expand((self.ncomp,) + tuple(s.shape))
