"""Scalar-transport problems, component-major layout.

Port of quinoa_tpu/pde/problems/transport.py: the problem base class,
SlotCyl (reference SlotCyl.cpp), GaussHump (GaussHump.cpp), CylAdvect
(CylAdvect.cpp) and the advection-diffusion ShearDiff (ShearDiff.cpp:
30-67).  Coordinates arrive as (3, n) (or (3, G, n)); t is a float or a
0-d tensor;

  solution(xyz, t)   -> (C, n)      initial/analytic solution
  velocity(xyz, t)   -> (C, 3, n)   prescribed advection velocity
  solinc(xyz, t, dt) -> (C, n)      Dirichlet increment over [t, t+dt]
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch


class TransportProblem:
    """Base: analytic solution = solution, solinc its increment."""

    ncomp: int = 1
    #: diffusivities per component, flattened (dx, dy, dz) * ncomp; empty
    #: = pure advection
    diffusivity: Tuple[float, ...] = ()

    def analytic(self, xyz, t):
        return self.solution(xyz, t)

    def solinc(self, xyz, t, dt):
        return self.solution(xyz, t + dt) - self.solution(xyz, t)


def _constant_velocity(problem, xyz):
    """(0.1, 0.1, 0) at every point, (C, 3, n)."""
    sh = xyz.shape[1:]
    opts = dict(dtype=xyz.dtype, device=xyz.device)
    v = torch.stack([torch.full(sh, 0.1, **opts), torch.full(sh, 0.1, **opts),
                     torch.zeros(sh, **opts)])
    return v[None].expand((problem.ncomp,) + tuple(v.shape))


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
        return _constant_velocity(self, xyz)

    def solution(self, xyz, t):
        x, y = xyz[0], xyz[1]
        x0 = 0.25 + 0.1 * t
        y0 = 0.25 + 0.1 * t
        s = torch.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2.0 * 0.005))
        return s[None].expand((self.ncomp,) + tuple(s.shape))


@dataclasses.dataclass
class CylAdvect(TransportProblem):
    """Cylinder (square wave, r < 0.2) advected by (0.1, 0.1, 0)."""

    ncomp: int = 1

    def velocity(self, xyz, t):
        return _constant_velocity(self, xyz)

    def solution(self, xyz, t):
        x, y = xyz[0], xyz[1]
        x0 = 0.25 + 0.1 * t
        y0 = 0.25 + 0.1 * t
        r = torch.sqrt((x - x0) ** 2 + (y - y0) ** 2)
        s = torch.where(r < 0.2, 1.0, 0.0).to(xyz.dtype)
        return s[None].expand((self.ncomp,) + tuple(s.shape))


@dataclasses.dataclass
class ShearDiff(TransportProblem):
    """Advection-diffusion of a point source in a 3-D shear flow (Carter &
    Okubo; reference ShearDiff.cpp:30-67).  Needs positive diffusivities
    and t0 > 0.  pi^1.5 is taken in float64, the rest in the tensor's
    dtype, as the JAX package takes them."""

    ncomp: int = 1
    u0: Tuple[float, ...] = (0.5,)
    lam: Tuple[float, ...] = (1.0, 0.0)
    diffusivity: Tuple[float, ...] = (1e-3, 5e-4, 5e-4)

    def velocity(self, xyz, t):
        vels = []
        for c in range(self.ncomp):
            l0, l1 = self.lam[2 * c], self.lam[2 * c + 1]
            vx = self.u0[c] + l0 * xyz[1] + l1 * xyz[2]
            vels.append(torch.stack([vx, torch.zeros_like(vx),
                                     torch.zeros_like(vx)]))
        return torch.stack(vels)

    def solution(self, xyz, t):
        x, y, z = xyz[0], xyz[1], xyz[2]
        outs = []
        for c in range(self.ncomp):
            l0, l1 = self.lam[2 * c], self.lam[2 * c + 1]
            d0, d1, d2 = self.diffusivity[3 * c:3 * c + 3]
            phi3s = (l0 * l0 * d1 / d0 + l1 * l1 * d2 / d0) / 12.0
            tt = torch.as_tensor(t, dtype=x.dtype, device=x.device)
            pre = 1.0 / (8.0 * np.pi ** 1.5 * math.sqrt(d0 * d1 * d2)
                         * tt ** 1.5 * torch.sqrt(1.0 + phi3s * tt * tt))
            arg = (-((x - self.u0[c] * tt - 0.5 * (l0 * y + l1 * z) * tt)
                     ** 2) / (4.0 * d0 * tt * (1.0 + phi3s * tt * tt))
                   - y * y / (4.0 * d1 * tt)
                   - z * z / (4.0 * d2 * tt))
            outs.append(pre * torch.exp(arg))
        return torch.stack(outs)
