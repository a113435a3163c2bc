#!/usr/bin/env python3
"""L2(sol) references of chip_smoke.py's P0, multimat, Lax-Friedrichs and
THINC paths from the JAX package on the CPU:
python3 jax_reference_l2.py [--x64] [--ulp-seed N] [path ...]

For each path (default: all seven) builds the path's configuration with
quinoa_tpu in float32 (x64 off) on the Hilbert-ordered 48^3 box, runs 11
step() calls from initial_state() and prints one JSON line
{"path", "dtype", "t", "l2sol", "l2err", "alpha_min", "alpha_sum_err"}; the
last two
(multimat only) are over the cell means.  chip_smoke.py's JAX_L2 holds the
printed numbers.  This is a one-off comparison on the host: the P1 paths
take minutes and a few GB.  --x64 runs the same configuration in float64
(geometry and state), which measures how far the JAX package's own
float32 round-off moves each L2(sol) in 11 steps; --ulp-seed N multiplies
the initial state by 1 + eps * (2r - 1), r uniform from numpy seed N and
eps the dtype's, a change below one ulp of every entry, which measures how
far two float32 runs that differ by round-off drift apart.

    p0        Euler SodShocktube, DG(P0), HLLC, extrapolate on sidesets
              1-2, symmetry on 3-6, cfl 0.5
    mm_p0     MMSodShocktube (nmat 2), MultiMatSolver DG(P0), same BCs
    mm_p1     the same at DG(P1) with consistent Superbee ("superbeep1")
    mm_iface  MMInterfaceAdvection (nmat 3), DG(P0), Dirichlet on all six
              sidesets, cfl 0.4
    p1_lf     Euler SodShocktube, DG(P1), Lax-Friedrichs, Superbee, the
              BCs of p0, cfl 0.5
    mm_thinc  MMInterfaceAdvection (nmat 3) with THINC (intsharp, beta
              2.5), DG(P1), consistent Superbee, extrapolate on all six
              sidesets, cfl 0.4
    mm_iface_p1  the same with Dirichlet on all six sidesets (the face
              Gauss-point route)
"""

import dataclasses
import json
import sys

N = 48
NSTEPS = 11
PATHS = ("p0", "mm_p0", "mm_p1", "mm_iface", "p1_lf", "mm_thinc",
         "mm_iface_p1")


def run(name, x64=False, ulp_seed=None):
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
    if name in ("mm_iface", "mm_iface_p1"):
        bc = {i: BC_DIRICHLET for i in range(1, 7)}
    elif name == "mm_thinc":
        bc = {i: BC_EXTRAPOLATE for i in range(1, 7)}
    else:
        bc = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE}
        bc.update({i: BC_SYMMETRY for i in range(3, 7)})
    p1 = ("mm_p1", "p1_lf", "mm_thinc", "mm_iface_p1")
    ndof = 4 if name in p1 else 1
    g = build_dggeom(mesh, ndof=ndof, bc_sidesets=bc,
                     dtype=jnp.float64 if x64 else jnp.float32)
    if name in ("p0", "p1_lf"):
        flux = "laxfriedrichs" if name == "p1_lf" else "hllc"
        system = DGCompFlow(SodShocktube(), riemann_flux=flux)
        solver = DGSolver(system, g, cfl=0.5,
                          limiter="superbeep1" if ndof == 4 else None)
    elif name in ("mm_iface", "mm_thinc", "mm_iface_p1"):
        thinc = name in ("mm_thinc", "mm_iface_p1")
        system = MultiMatSystem(MMInterfaceAdvection(nmat=3), intsharp=thinc)
        solver = MultiMatSolver(system, g, cfl=0.4,
                                limiter="superbeep1" if thinc else None)
    else:
        system = MultiMatSystem(MMSodShocktube())
        solver = MultiMatSolver(system, g, cfl=0.5,
                                limiter="superbeep1" if ndof == 4 else None)
    s = solver.initial_state()
    if ulp_seed is not None:
        u = np.asarray(s.u)
        r = np.random.default_rng(ulp_seed).random(u.shape)
        eps = np.finfo(u.dtype).eps
        s = dataclasses.replace(s, u=jnp.asarray(
            u * (1.0 + eps * (2.0 * r - 1.0)), dtype=u.dtype))
    for _ in range(NSTEPS):
        s = solver.step(s)
    l2sol, l2err, _ = DGDiagnostics(system, g).compute(s)
    out = {"path": name, "dtype": str(s.u.dtype), "t": float(s.t),
           "l2sol": l2sol, "l2err": l2err}
    if ulp_seed is not None:
        out["ulp_seed"] = ulp_seed
    if name not in ("p0", "p1_lf"):
        nmat = system.nmat
        u = np.asarray(s.u).reshape(system.ncomp, ndof, -1)[:, 0]
        out["alpha_min"] = float(u[:nmat].min())
        out["alpha_sum_err"] = float(np.abs(u[:nmat].sum(0) - 1.0).max())
    return out


def main():
    import jax

    args = sys.argv[1:]
    x64 = "--x64" in args
    ulp_seed = None
    if "--ulp-seed" in args:
        i = args.index("--ulp-seed")
        ulp_seed = int(args[i + 1])
        del args[i:i + 2]
    names = [a for a in args if a != "--x64"]
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    for name in names or PATHS:
        if name not in PATHS:
            raise SystemExit(f"unknown path {name!r}; paths: {PATHS}")
        print(json.dumps(run(name, x64, ulp_seed)), flush=True)


if __name__ == "__main__":
    main()
