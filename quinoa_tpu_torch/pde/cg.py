"""Continuous-Galerkin geometry and the scalar-transport system, on torch
tensors (feature-major layout).

Port of quinoa_tpu/pde/cg.py: the geometry tables, the node gather and
assemblies, the lumped mass, and CGTransport (initial/analytic solution,
the Taylor-Galerkin rhs of DiagCG, the ALECG nodal flux and
characteristic speed, dt).  Fields are (C, N), coordinates (3, N),
per-element tables carry the element axis last.  The tables are built on
the host in float64 exactly as the JAX make_cggeom builds them (the same
geometry arithmetic and nsup slot order), then cast to the requested dtype
and device.

cg_gather, cg_assemble_add and cg_assemble_add_max launch K10 and K11
(ops/node_window.py) on a CUDA geometry and run their plain versions on a
CPU one; there is no switch.  Not ported: the window NodePlan (a TPU
device: the card gathers node values directly).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..mesh.geometry import nodal_volumes, tet_geometry
from ..ops.assembly import build_nsup
from ..ops.node_window import node_assemble, node_gather

#: geometry fields that are tensors, in the JAX CGGeom's order (without
#: the TPU-only ``plan``)
GEOM_TENSOR_FIELDS = ("coords", "inpoelT", "J", "grad", "vol", "emask",
                      "nsup", "coords_n", "ctr")
#: the integer-valued ones (int32, as in the JAX package)
GEOM_INT_FIELDS = ("inpoelT", "nsup")


@dataclasses.dataclass(frozen=True)
class CGGeom:
    """Static single-device geometry for node-centred (CG) solvers, as
    quinoa_tpu's CGGeom without the window plan.

    coords  : (3, N)       node coordinates
    inpoelT : (4, E) i32   element connectivity
    J       : (E,)         element Jacobian = 6 * volume
    grad    : (4, 3, E)    P1 shape-function gradients
    vol     : (N,)         nodal volumes
    emask   : (E,)         1.0 real element / 0.0 padding
    nsup    : (D, N) i32   element-slot assembly table (ops.assembly)
    nnode   : int          node count
    coords_n: (4, 3, E)    element-corner coordinates (static cache)
    ctr     : (3, E)       element centres (static cache)
    """

    coords: torch.Tensor
    inpoelT: torch.Tensor
    J: torch.Tensor
    grad: torch.Tensor
    vol: torch.Tensor
    emask: torch.Tensor
    nsup: torch.Tensor
    nnode: int
    coords_n: torch.Tensor
    ctr: torch.Tensor

    @property
    def nelem(self) -> int:
        return self.inpoelT.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.vol.dtype

    @property
    def device(self) -> torch.device:
        return self.vol.device

    @functools.cached_property
    def elem_length(self) -> torch.Tensor:
        """cbrt(J/6) (E,), the element length of both dt laws.  torch has
        no cube root and pow(x, 1/3) is a few ulp off in float32, so this
        takes numpy's cbrt of J/6 as the geometry's dtype rounds it, once
        per geometry (one host round trip)."""
        x = (self.J / 6.0).double().cpu().numpy()
        return torch.from_numpy(np.cbrt(x)).to(self.dtype).to(self.device)


def cg_gather(geom: CGGeom, U: torch.Tensor) -> torch.Tensor:
    """Nodal fields U (C, N) -> element-corner slabs (4, C, E) (K10)."""
    return node_gather(U, geom.inpoelT)


def cg_assemble_add(geom: CGGeom, contrib: torch.Tensor) -> torch.Tensor:
    """Sum element-corner contributions (4, C, E) into nodes (C, N) (K11's
    sum rows)."""
    return node_assemble(contrib, None, geom.nsup)


def cg_assemble_add_max(geom: CGGeom, contribA: torch.Tensor,
                        contribM: torch.Tensor):
    """The sum-assembly of contribA (4, Ca, E) and the max-assembly of
    contribM (4 or 1, Cm, E; 1 = the same row at all four corners) in one
    K11 pass: ((Ca, N), (Cm, N))."""
    out = node_assemble(contribA, contribM, geom.nsup)
    Ca = contribA.shape[1]
    return out[:Ca], out[Ca:]


def coords_cache_np(coords: np.ndarray, inpoelT: np.ndarray):
    """Host-side static caches from coords (3, N) and inpoelT (4, E):
    (coords_n (4, 3, E), ctr (3, E)); the centre sums the four corners in
    order, then divides, as the JAX package's native pass does."""
    cn = np.ascontiguousarray(coords.T[inpoelT].transpose(0, 2, 1))
    return cn, (((cn[0] + cn[1]) + cn[2]) + cn[3]) / 4.0


def make_cggeom(mesh, dtype: torch.dtype = torch.float64,
                device=DEFAULT_DEVICE) -> CGGeom:
    """Single-device CGGeom from a host UnsMesh (no padding).  Geometry is
    derived in float64 on the host and cast to ``dtype`` on ``device``
    (the card unless the caller asks for another)."""
    device = resolve_device(device)
    J, grad = tet_geometry(mesh.coords, mesh.inpoel)
    if not (J > 0).all():
        raise ValueError("mesh has non-positive element Jacobians")
    vol = nodal_volumes(mesh.coords, mesh.inpoel, mesh.nnode, J=J)
    nsup, _ = build_nsup(mesh.inpoel, mesh.nnode)
    cn, ctr = coords_cache_np(np.ascontiguousarray(mesh.coords.T),
                              np.ascontiguousarray(mesh.inpoel.T))

    def f(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)
                                ).to(dtype).to(device)

    def i(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)
                                ).to(device)

    return CGGeom(
        coords=f(mesh.coords.T), inpoelT=i(mesh.inpoel.T), J=f(J),
        grad=f(np.transpose(grad, (1, 2, 0))), vol=f(vol),
        emask=f(np.ones(mesh.nelem)), nsup=i(nsup), nnode=int(mesh.nnode),
        coords_n=f(cn), ctr=f(ctr))


def lumped_mass(geom: CGGeom) -> torch.Tensor:
    """Assembled lumped mass diagonal (N,): each element gives V/4 = J/24
    to each of its four nodes (FluxCorrector::lump)."""
    w = (geom.J * geom.emask) / 24.0
    return cg_assemble_add(geom, w[None, None, :].expand(4, 1, geom.nelem)
                           .contiguous())[0]


class CGTransport:
    """Scalar advection(-diffusion) for node-centred schemes, two-stage
    Taylor-Galerkin (reference CGTransport.hpp rhs 183-330, dt 331-395),
    with the optional diagonal diffusion of CGAdvDiff (Physics/
    CGAdvDiff.cpp:30-96) where the problem has diffusivities.  ALECG reads
    no diffusivity (its rhs is the flux and the edge dissipation), as in
    the JAX package."""

    flavour = "transport"

    def __init__(self, problem, ncomp: Optional[int] = None):
        self.problem = problem
        self.ncomp = ncomp if ncomp is not None else problem.ncomp
        d = getattr(problem, "diffusivity", ()) or ()
        #: (C, 3) float64 diffusivities, or None
        self.diffusivity = (np.asarray(d, dtype=np.float64).reshape(-1, 3)
                            if len(d) else None)
        # dt() evaluates the velocity at t=0 (the reference's transport dt
        # law), so the sweep is a run constant that solvers cache
        self.static_dt = True

    def initialize(self, xyz, t):
        return self.problem.solution(xyz, t)

    def analytic(self, xyz, t):
        return self.problem.solution(xyz, t)

    def solinc(self, xyz, t, dt):
        return self.problem.solinc(xyz, t, dt)

    def rhs(self, t, dt, geom: CGGeom, U):
        """Right-hand side (C, N)."""
        return cg_assemble_add(
            geom, self.rhs_contrib(t, dt, geom, U, cg_gather(geom, U)))

    def rhs_contrib(self, t, dt, geom: CGGeom, U, un):
        """Element-corner rhs contributions (4, C, E) from the step's nodal
        gather un (4, C, E): the element intermediate at t + dt/2 from the
        corner velocities, then its flux with the centre velocity; with
        diffusivities D minus dt J/6 D_k grad[a,k] grad[b,k] u[b]
        (quinoa_tpu/pde/cg.py:247-257, in that summation order)."""
        C, E = self.ncomp, geom.nelem
        cn = geom.coords_n
        vel_n = [self.problem.velocity(cn[a], t) for a in range(4)]
        adv = torch.zeros((C, E), dtype=U.dtype, device=U.device)
        for a in range(4):
            for j in range(3):
                adv = adv + geom.grad[a, j] * vel_n[a][:, j, :] * un[a]
        ue = un.mean(dim=0) - 0.5 * dt * adv                  # (C, E)

        vel_c = self.problem.velocity(geom.ctr, t)            # (C, 3, E)
        d = dt * geom.J * geom.emask / 6.0
        vdotg = [sum(geom.grad[a, j] * vel_c[:, j, :] for j in range(3))
                 for a in range(4)]
        contrib = torch.stack([d * g * ue for g in vdotg])
        if self.diffusivity is None:
            return contrib
        D = torch.as_tensor(self.diffusivity, dtype=U.dtype, device=U.device)
        gb = [sum(geom.grad[b, k] * un[b] for b in range(4))
              for k in range(3)]
        diff = []
        for a in range(4):
            s = torch.zeros((C, E), dtype=U.dtype, device=U.device)
            for k in range(3):
                s = s + D[:, k][:, None] * geom.grad[a, k] * gb[k]
            diff.append(s)
        return contrib - d * torch.stack(diff)

    def flux_at_nodes(self, u, xyz):
        """F_j = v_j(x) u at nodal states u (C, n)."""
        vel = self.problem.velocity(xyz, 0.0)  # (C, 3, n)
        return [vel[:, j, :] * u for j in range(3)]

    def charspeed(self, u, xyz):
        vel = self.problem.velocity(xyz, 0.0)
        return torch.sqrt((vel * vel).sum(dim=1)).amax(dim=0)

    def dt(self, geom: CGGeom, U):
        """Minimum time step over the elements (before CFL scaling): the
        advective L / max|v|, with diffusion at most L^2 / (2 D_max)."""
        speeds = [self.charspeed(None, geom.coords_n[a]) for a in range(4)]
        maxvel = torch.maximum(torch.maximum(speeds[0], speeds[1]),
                               torch.maximum(speeds[2], speeds[3]))
        L = geom.elem_length
        elemdt = L / torch.clamp_min(maxvel, 1e-300)
        if self.diffusivity is not None:
            dmax = float(self.diffusivity.max())
            elemdt = torch.minimum(elemdt, L * L / (2.0 * dmax))
        big = torch.finfo(U.dtype).max
        return torch.where(geom.emask > 0, elemdt, big).min()
