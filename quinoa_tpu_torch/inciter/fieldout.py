"""Plot-variable derivation with the reference's output names.

The port's own copy of quinoa_tpu/inciter/fieldout.py (the reference's
per-PDE fieldOutput/names methods: src/PDE/CompFlow/CGCompFlow.hpp,
DGCompFlow, DGMultiMat, the Transport problems' field names), on torch
tensors with the port's own equation of state and problem.solution.  Raw
conserved components become the primitive plot variables the reference
writes, under the same names:

  transport : c{i}_numerical, c{i}_analytic, c{i}_error
  compflow  : density, x/y/z-velocity, specific_total_energy, pressure
              (_numerical, plus _analytical where the problem has a
              solution)
  multimat  : volfrac{k}, density, x/y/z-velocity, pressure,
              total_energy_density (_numerical)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_VEL = ("x-velocity", "y-velocity", "z-velocity")


def _compflow_prims(eos, u):
    rho = u[0]
    vel = [u[1] / rho, u[2] / rho, u[3] / rho]
    return rho, vel, u[4] / rho, eos.pressure_cons_cm(u)


def _compflow_fields(out, eos, u, suffix):
    rho, vel, E, p = _compflow_prims(eos, u)
    out[f"density_{suffix}"] = rho
    for nm, v in zip(_VEL, vel):
        out[f"{nm}_{suffix}"] = v
    out[f"specific_total_energy_{suffix}"] = E
    out[f"pressure_{suffix}"] = p


def plot_fields(pde: str, system, u, xyz, t: float, analytic: bool = True,
                exact_mean=None) -> Dict[str, np.ndarray]:
    """Named plot variables (numpy arrays) from component-major data u
    (C, n), a numpy array or a tensor.

    xyz : (3, n) sample points (nodes for CG output, cell centroids for
    DG) at which the analytic solution is evaluated, in u's precision.
    exact_mean : optional (C, n) quadrature cell means of the analytic
    solution for the error variable (num - exact cell mean), while the
    analytic variable is the centroid sample, as the JAX package writes.
    """
    u = torch.as_tensor(u)
    xyz = torch.as_tensor(xyz, dtype=u.dtype, device=u.device)
    problem = getattr(system, "problem", None)
    sol = None
    if analytic and hasattr(problem, "solution") and pde != "multimat":
        sol = problem.solution(xyz, t).to(u.dtype)
    out: Dict[str, torch.Tensor] = {}
    if pde == "transport":
        for c in range(u.shape[0]):
            out[f"c{c}_numerical"] = u[c]
            if sol is not None:
                out[f"c{c}_analytic"] = sol[c]
                ref = (sol[c] if exact_mean is None
                       else torch.as_tensor(exact_mean[c]).to(u))
                out[f"c{c}_error"] = u[c] - ref
    elif pde == "compflow":
        _compflow_fields(out, system.eos, u, "numerical")
        if sol is not None:
            _compflow_fields(out, system.eos, sol, "analytical")
    elif pde == "multimat":
        from ..pde.multimat import (density_idx, energy_idx, momentum_idx,
                                    volfrac_idx)

        nmat = system.nmat
        rho = sum(u[density_idx(nmat, k)] for k in range(nmat))
        vel = [u[momentum_idx(nmat, i)] / rho for i in range(3)]
        p = torch.zeros_like(rho)
        for k in range(nmat):
            a = u[volfrac_idx(nmat, k)]
            rk = u[density_idx(nmat, k)] / a
            ek = u[energy_idx(nmat, k)] / a
            pk = system.eos[k].pressure(rk, vel[0], vel[1], vel[2], ek)
            out[f"volfrac{k + 1}_numerical"] = a
            p = p + a * pk
        out["density_numerical"] = rho
        for nm, v in zip(_VEL, vel):
            out[f"{nm}_numerical"] = v
        out["pressure_numerical"] = p
        out["total_energy_density_numerical"] = sum(
            u[energy_idx(nmat, k)] for k in range(nmat))
    else:
        raise ValueError(f"unknown pde {pde!r}")
    return {k: v.cpu().numpy() for k, v in out.items()}
