"""Scalar-transport problems, component-major layout.

Port of the part of quinoa_tpu/pde/problems/transport.py the port's paths
need: the problem base class, SlotCyl (reference SlotCyl.cpp, the ALECG
transport leg) and GaussHump (reference GaussHump.cpp, the DG transport
path).  Coordinates arrive as (3, n) (or (3, G, n)); t is a float or a
0-d tensor;

  solution(xyz, t)   -> (C, n)      initial/analytic solution
  velocity(xyz, t)   -> (C, 3, n)   prescribed advection velocity
  solinc(xyz, t, dt) -> (C, n)      Dirichlet increment over [t, t+dt]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class TransportProblem:
    """Base: analytic solution = solution, solinc its increment."""

    ncomp: int = 1

    def analytic(self, xyz, t):
        return self.solution(xyz, t)

    def solinc(self, xyz, t, dt):
        return self.solution(xyz, t + dt) - self.solution(xyz, t)


@dataclasses.dataclass
class SlotCyl(TransportProblem):
    """Zalesak slotted cylinder + cone + hump in solid-body rotation.

    Velocity v = (1/2 - y, x - 1/2, 0); each extra component is the same
    field phase-shifted by 2*pi/ncomp (reference SlotCyl.cpp:30-110).
    """

    ncomp: int = 1

    def velocity(self, xyz, t):
        v = torch.stack([0.5 - xyz[1], xyz[0] - 0.5, torch.zeros_like(xyz[0])])
        return v[None].expand((self.ncomp,) + tuple(v.shape))

    def solution(self, xyz, t):
        x, y = xyz[0], xyz[1]
        t = torch.as_tensor(t, dtype=xyz.dtype, device=xyz.device)
        outs = []
        R0 = 0.15
        for c in range(self.ncomp):
            T = t + 2.0 * np.pi / self.ncomp * c
            sinT, cosT = torch.sin(T), torch.cos(T)

            r_k = 0.25
            kx, ky = 0.5 + r_k * sinT, 0.5 - r_k * cosT
            hx = 0.5 + r_k * torch.sin(T - np.pi / 2)
            hy = 0.5 - r_k * torch.cos(T - np.pi / 2)
            cx = 0.5 + r_k * torch.sin(T + np.pi)
            cy = 0.5 - r_k * torch.cos(T + np.pi)

            s = torch.zeros_like(x)

            r = torch.sqrt((x - kx) ** 2 + (y - ky) ** 2) / R0
            s = torch.where(r < 1.0, 0.6 * (1.0 - r), s)

            r = torch.sqrt((x - hx) ** 2 + (y - hy) ** 2) / R0
            s = torch.where(
                r < 1.0,
                0.2 * (1.0 + torch.cos(np.pi * torch.clamp_max(r, 1.0))), s)

            r = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2) / R0

            i1 = (0.525, 0.75 - r_k * np.cos(np.arcsin(0.025 / r_k)))
            i2 = (0.525, 0.8)
            i3 = (0.475, 0.8)

            def rot(p):
                px = 0.5 + cosT * (p[0] - 0.5) - sinT * (p[1] - 0.5)
                py = 0.5 + sinT * (p[0] - 0.5) + cosT * (p[1] - 0.5)
                return px, py

            r1x, r1y = rot(i1)
            r2x, r2y = rot(i2)
            r3x, r3y = rot(i3)

            v1x, v1y = r2x - r1x, r2y - r1y
            v2x, v2y = r3x - r2x, r3y - r2y
            v1 = torch.sqrt(v1x ** 2 + v1y ** 2)
            v2 = torch.sqrt(v2x ** 2 + v2y ** 2)

            d1 = (v1x * (x - r1x) + v1y * (y - r1y)) / v1
            d2 = (v2x * (x - r2x) + v2y * (y - r2y)) / v2

            in_slot = (d1 > 0.0) & (d1 < v1) & (d2 > 0.0) & (d2 < v2)
            s = torch.where((r < 1.0) & ~in_slot, torch.full_like(s, 0.6), s)
            outs.append(s)
        return torch.stack(outs)


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
