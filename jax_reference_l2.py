#!/usr/bin/env python3
"""L2(sol) references of chip_smoke.py's P0 and multimat paths from the
JAX package on the CPU: python3 jax_reference_l2.py [path ...]

For each path (default: all four) builds the path's configuration with
quinoa_tpu in float32 (x64 off) on the Hilbert-ordered 48^3 box, runs 11
step() calls from initial_state() and prints one JSON line
{"path", "t", "l2sol", "l2err", "alpha_min", "alpha_sum_err"}; the last two
(multimat only) are over the cell means.  chip_smoke.py's JAX_L2 holds the
printed numbers.  This is a one-off comparison on the host: the P1 path
takes minutes and a few GB.

    p0        Euler SodShocktube, DG(P0), HLLC, extrapolate on sidesets
              1-2, symmetry on 3-6, cfl 0.5
    mm_p0     MMSodShocktube (nmat 2), MultiMatSolver DG(P0), same BCs
    mm_p1     the same at DG(P1) with consistent Superbee ("superbeep1")
    mm_iface  MMInterfaceAdvection (nmat 3), DG(P0), Dirichlet on all six
              sidesets, cfl 0.4
"""

import json
import sys

N = 48
NSTEPS = 11
PATHS = ("p0", "mm_p0", "mm_p1", "mm_iface")


def run(name):
    import jax.numpy as jnp
    import numpy as np

    from quinoa_tpu.inciter.dg import DGDiagnostics, DGSolver
    from quinoa_tpu.mesh import box_tet_mesh
    from quinoa_tpu.mesh.reorder import hilbert_element_reorder
    from quinoa_tpu.pde.dg import (BC_DIRICHLET, BC_EXTRAPOLATE, BC_SYMMETRY,
                                   build_dggeom)
    from quinoa_tpu.pde.dg_compflow import DGCompFlow
    from quinoa_tpu.pde.multimat import MultiMatSolver, MultiMatSystem
    from quinoa_tpu.pde.problems import SodShocktube
    from quinoa_tpu.pde.problems.multimat import (MMInterfaceAdvection,
                                                  MMSodShocktube)

    mesh, _ = hilbert_element_reorder(box_tet_mesh(N, N, N))
    if name == "mm_iface":
        bc = {i: BC_DIRICHLET for i in range(1, 7)}
    else:
        bc = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE}
        bc.update({i: BC_SYMMETRY for i in range(3, 7)})
    ndof = 4 if name == "mm_p1" else 1
    g = build_dggeom(mesh, ndof=ndof, bc_sidesets=bc, dtype=jnp.float32)
    if name == "p0":
        system = DGCompFlow(SodShocktube(), riemann_flux="hllc")
        solver = DGSolver(system, g, cfl=0.5)
    elif name == "mm_iface":
        system = MultiMatSystem(MMInterfaceAdvection(nmat=3))
        solver = MultiMatSolver(system, g, cfl=0.4)
    else:
        system = MultiMatSystem(MMSodShocktube())
        solver = MultiMatSolver(system, g, cfl=0.5,
                                limiter="superbeep1" if ndof == 4 else None)
    s = solver.initial_state()
    for _ in range(NSTEPS):
        s = solver.step(s)
    l2sol, l2err, _ = DGDiagnostics(system, g).compute(s)
    out = {"path": name, "t": float(s.t), "l2sol": l2sol, "l2err": l2err}
    if name != "p0":
        nmat = system.nmat
        u = np.asarray(s.u).reshape(system.ncomp, ndof, -1)[:, 0]
        out["alpha_min"] = float(u[:nmat].min())
        out["alpha_sum_err"] = float(np.abs(u[:nmat].sum(0) - 1.0).max())
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    for name in sys.argv[1:] or PATHS:
        if name not in PATHS:
            raise SystemExit(f"unknown path {name!r}; paths: {PATHS}")
        print(json.dumps(run(name)), flush=True)


if __name__ == "__main__":
    main()
