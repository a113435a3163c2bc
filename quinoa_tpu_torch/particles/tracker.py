"""Passive particle tracking through the flow field.

The port's counterpart of quinoa_tpu/particles/tracker.py (the
reference's Particles subsystem, src/Particles/Tracker.hpp:36): seed
massless tracers inside the mesh, advect them with the flow velocity each
time step, and write H5Part trajectories (io/h5part.py).

The layout is the JAX package's: positions (3, P), element ids (P,), the
particle axis last.  Point location is a fixed-hop neighbour walk (a tet
holds a point when its barycentric coordinates are all >= -1e-12; a
particle leaving through face a hops to the element across it, and a
boundary face keeps it where it is).  The barycentric coordinates are the
P1 shape functions N_a(x) = 1/4 + grad_a . (x - centroid_e).  Everything
is plain torch on the tracker's device, the card unless the caller asks
for the CPU; seeding is numpy, drawn from the same generator as the JAX
package's, so both seed the same particles.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..mesh.derived import gen_esuel
from ..mesh.geometry import tet_geometry

#: a particle is inside an element when every barycentric coordinate is
#: at least -INSIDE_TOL; after a step one below -STUCK_TOL is stuck
INSIDE_TOL = 1e-12
STUCK_TOL = 1e-6


@dataclasses.dataclass(frozen=True)
class TrackerGeom:
    """Static per-mesh tables for particle location and interpolation.

    grad   : (4, 3, E)  P1 shape-function gradients
    cent   : (3, E)     element centroids
    esuel  : (4, E)     face-neighbour element ids (-1: boundary), int64
    inpoelT: (4, E)     connectivity, int64
    coords : (3, N)     node coordinates
    """

    grad: torch.Tensor
    cent: torch.Tensor
    esuel: torch.Tensor
    inpoelT: torch.Tensor
    coords: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.grad.dtype

    @property
    def device(self) -> torch.device:
        return self.grad.device


def make_tracker_geom(mesh, dtype=None, device=DEFAULT_DEVICE) -> TrackerGeom:
    """The tracker tables of a host mesh in dtype (torch's default when
    None) on device (the card unless the caller asks for another)."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.get_default_dtype()
    _, grad = tet_geometry(mesh.coords, mesh.inpoel)   # (E, 4, 3)
    cent = mesh.coords[mesh.inpoel].mean(axis=1)       # (E, 3)
    esuel = gen_esuel(mesh.inpoel, mesh.nnode)         # (E, 4)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype=dt,
                                                           device=dev)

    return TrackerGeom(grad=put(np.transpose(grad, (1, 2, 0)), dtype),
                       cent=put(cent.T, dtype),
                       esuel=put(esuel.T, torch.int64),
                       inpoelT=put(mesh.inpoel.T, torch.int64),
                       coords=put(mesh.coords.T, dtype))


def seed_particles(mesh, npar: int, seed: int = 0):
    """Volume-weighted element sampling + uniform barycentric draws, the
    JAX package's draws from np.random.default_rng(seed): every particle
    starts strictly inside the mesh (the reference's Tracker::genpar).
    Returns numpy (xp (3, npar) float64, ep (npar,) int32)."""
    rng = np.random.default_rng(seed)
    J, _ = tet_geometry(mesh.coords, mesh.inpoel)
    p = J / J.sum()
    ep = rng.choice(mesh.nelem, size=npar, p=p)
    # uniform barycentric via sorted-uniform spacings
    u = np.sort(rng.random((npar, 3)), axis=1)
    lam = np.stack([u[:, 0], u[:, 1] - u[:, 0], u[:, 2] - u[:, 1],
                    1.0 - u[:, 2]], axis=1)            # (npar, 4)
    xp = np.einsum("pa,pad->dp", lam, mesh.coords[mesh.inpoel[ep]])
    return xp, ep.astype(np.int32)


def barycentric(geom: TrackerGeom, xp, ep):
    """N_a(x) for each particle in its element: (4, P)."""
    d = xp - geom.cent[:, ep]                          # (3, P)
    g = geom.grad[:, :, ep]                            # (4, 3, P)
    return 0.25 + (g[:, 0] * d[0] + g[:, 1] * d[1] + g[:, 2] * d[2])


def locate(geom: TrackerGeom, xp, ep, hops: int = 4):
    """Neighbour-walk relocation: hop across the most violated face up to
    `hops` times; a boundary face keeps the particle in its last element
    (the reference's wall behaviour for tracers)."""
    for _ in range(hops):
        lam = barycentric(geom, xp, ep)                # (4, P)
        worst = torch.argmin(lam, dim=0)               # first on ties
        inside = torch.amin(lam, dim=0) >= -INSIDE_TOL
        # face a is opposite node a: a negative N_a leaves into esuel[a]
        nbr = geom.esuel[worst, ep]
        ep = torch.where(inside | (nbr < 0), ep, nbr)
    return ep


def interp_nodal(geom: TrackerGeom, ep, lam, vals):
    """Interpolate nodal fields at particles: vals (C, N) -> (C, P), the
    four corners summed in order."""
    nd = geom.inpoelT[:, ep]                           # (4, P)
    out = lam[0][None, :] * vals[:, nd[0]]
    for a in range(1, 4):
        out = out + lam[a][None, :] * vals[:, nd[a]]
    return out


def nearest_centroid(geom: TrackerGeom, xp, max_pairs: int = 1 << 26):
    """For each particle the element whose centroid is nearest: the
    argmin over elements of (dx*dx + dy*dy) + dz*dz, the first element on
    ties, as the JAX CLI's dense (P, E) table gives it, computed a chunk
    of particles at a time so that no more than max_pairs distances are
    held at once.  Returns (P,) int64."""
    cent = geom.cent
    E, P = cent.shape[1], xp.shape[1]
    chunk = max(1, max_pairs // max(E, 1))
    out = torch.empty(P, dtype=torch.int64, device=xp.device)
    for p0 in range(0, P, chunk):
        x = xp[:, p0:p0 + chunk]
        d = cent[0][None, :] - x[0][:, None]           # (p, E)
        d2 = d * d
        for k in (1, 2):
            d = cent[k][None, :] - x[k][:, None]
            d2 += d * d
        out[p0:p0 + chunk] = torch.argmin(d2, dim=1)
    return out


class ParticleTracker:
    """Advance tracers with a velocity callback.

    velocity_of(geom, xp, ep, lam, t, *vargs) -> (3, P): the flow
    velocity at the particle positions; analytic for transport problems,
    interpolated from the solution for flow solvers (the inciter command
    wires both).  The tables live in dtype on device.
    """

    def __init__(self, mesh, velocity_of: Callable, hops: int = 4,
                 dtype=None, device=DEFAULT_DEVICE):
        self.geom = make_tracker_geom(mesh, dtype, device)
        self.velocity_of = velocity_of
        self.hops = hops

    def rebuild(self, mesh):
        """New tables on a remeshed mesh, in the same dtype and device."""
        self.geom = make_tracker_geom(mesh, self.geom.dtype, self.geom.device)

    def advance(self, xp, ep, t: float, dt: float, *vargs):
        """One RK2 (midpoint) advection step and relocation; a particle
        whose element never contains it (it left the domain) freezes at
        its previous position.  Returns (xp, ep) on the tracker's
        device."""
        g = self.geom
        xp = torch.as_tensor(xp).to(dtype=g.dtype, device=g.device)
        ep = torch.as_tensor(ep).to(dtype=torch.int64, device=g.device)
        lam = barycentric(g, xp, ep)
        v1 = self.velocity_of(g, xp, ep, lam, t, *vargs)
        xm = xp + 0.5 * dt * v1
        em = locate(g, xm, ep, self.hops)
        lamm = barycentric(g, xm, em)
        v2 = self.velocity_of(g, xm, em, lamm, t + 0.5 * dt, *vargs)
        xn = xp + dt * v2
        en = locate(g, xn, ep, self.hops)
        lamn = barycentric(g, xn, en)
        stuck = torch.amin(lamn, dim=0) < -STUCK_TOL
        xn = torch.where(stuck[None, :], xp, xn)
        en = torch.where(stuck, ep, en)
        return xn, en


def analytic_velocity(problem):
    """velocity_of for transport problems, whose velocity(x, t) is closed
    form (e.g. SlotCyl's solid-body rotation): the first component's."""

    def vel(geom, xp, ep, lam, t):
        return problem.velocity(xp, t)[0]

    return vel


def nodal_velocity():
    """velocity_of interpolating nodal momentum over density (CG
    compflow: u (5, N) conserved [rho, rho u, rho v, rho w, E])."""

    def vel(geom, xp, ep, lam, t, U):
        q = interp_nodal(geom, ep, lam, U)             # (5, P)
        return q[1:4] / q[0]

    return vel


def cell_velocity(C: int, K: int):
    """velocity_of for DG solvers: the containing element's cell-mean
    momentum over density (u (C*K, E))."""

    def vel(geom, xp, ep, lam, t, U):
        q = U.reshape(C, K, -1)[:, 0, ep]              # (C, P)
        return q[1:4] / q[0]

    return vel
