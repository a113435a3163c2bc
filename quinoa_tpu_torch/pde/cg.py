"""Continuous-Galerkin geometry and the scalar-transport system, on torch
tensors (feature-major layout).

Port of the part of quinoa_tpu/pde/cg.py that ALECG needs: the geometry
tables, the lumped mass, and CGTransport's initial/analytic solution,
nodal flux, characteristic speed and dt.  Fields are (C, N), coordinates
(3, N), per-element tables carry the element axis last.  The tables are
built on the host in float64 exactly as the JAX make_cggeom builds them
(the jax-free quinoa_tpu.mesh.geometry and quinoa_tpu.native passes, the
same nsup slot order), then cast to the requested dtype and device.

Not ported here: the window NodePlan (a TPU device: the card gathers
node values directly) and the Taylor-Galerkin rhs of DiagCG.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from quinoa_tpu.mesh.geometry import nodal_volumes, tet_geometry

from ..ops.assembly import assemble_add, build_nsup

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


def coords_cache_np(coords: np.ndarray, inpoelT: np.ndarray):
    """Host-side static caches from coords (3, N) and inpoelT (4, E):
    (coords_n (4, 3, E), ctr (3, E)); the native pass when built."""
    from quinoa_tpu.native import coords_cache as _native_cc

    nat = _native_cc(coords.T, inpoelT.T)
    if nat is not None:
        return nat
    cn = np.ascontiguousarray(coords.T[inpoelT].transpose(0, 2, 1))
    return cn, cn.mean(axis=0)


def make_cggeom(mesh, dtype: torch.dtype = torch.float64,
                device="cpu") -> CGGeom:
    """Single-device CGGeom from a host UnsMesh (no padding).  Geometry is
    derived in float64 on the host and cast to ``dtype`` on ``device``."""
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
    return assemble_add(w[None, None, :].expand(4, 1, geom.nelem),
                        geom.nsup)[0]


class CGTransport:
    """Scalar advection for node-centred schemes: the ALECG callbacks of
    quinoa_tpu's CGTransport (reference CGTransport.hpp dt 331-395).
    Advection-diffusion (ShearDiff) is not ported."""

    flavour = "transport"

    def __init__(self, problem, ncomp: Optional[int] = None):
        if getattr(problem, "diffusivity", ()):
            raise NotImplementedError("transport with diffusion is not "
                                      "ported")
        self.problem = problem
        self.ncomp = ncomp if ncomp is not None else problem.ncomp
        # dt() evaluates the velocity at t=0 (the reference's transport dt
        # law), so the sweep is a run constant that solvers cache
        self.static_dt = True

    def initialize(self, xyz, t):
        return self.problem.solution(xyz, t)

    def analytic(self, xyz, t):
        return self.problem.solution(xyz, t)

    def solinc(self, xyz, t, dt):
        return self.problem.solinc(xyz, t, dt)

    def flux_at_nodes(self, u, xyz):
        """F_j = v_j(x) u at nodal states u (C, n)."""
        vel = self.problem.velocity(xyz, 0.0)  # (C, 3, n)
        return [vel[:, j, :] * u for j in range(3)]

    def charspeed(self, u, xyz):
        vel = self.problem.velocity(xyz, 0.0)
        return torch.sqrt((vel * vel).sum(dim=1)).amax(dim=0)

    def dt(self, geom: CGGeom, U):
        """Minimum time step over the elements (before CFL scaling)."""
        speeds = [self.charspeed(None, geom.coords_n[a]) for a in range(4)]
        maxvel = torch.maximum(torch.maximum(speeds[0], speeds[1]),
                               torch.maximum(speeds[2], speeds[3]))
        elemdt = geom.elem_length / torch.clamp_min(maxvel, 1e-300)
        big = torch.finfo(U.dtype).max
        return torch.where(geom.emask > 0, elemdt, big).min()
