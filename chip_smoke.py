#!/usr/bin/env python3
"""Smoke test of quinoa_tpu_torch on one NVIDIA GPU: python3 chip_smoke.py

Drives the port's three DG(P1) paths and its two ALECG paths at 48^3
(663,552 tets; 117,649 nodes and 795,024 edges) in float32 through their
hand-written CUDA kernels:

1. card    the name and power limit from nvidia-smi;
2. build   compile csrc/*.cu with nvcc (sm_90a), one process per source,
           and load the library;
3. kernels each kernel against its plain torch version on the card:
           K1-K4 on a perturbed Sedov state, K5 and K6 on GaussHump
           transport rows, float32 at 48^3 and float64 on small meshes,
           with a CUDA-event time for kernel and plain version at 48^3;
           K7-K9 (both flavours of K7 and K8) on the SlotCyl and
           VorticalFlow initial states, alone and as the stage rhs;
           then six small float64 solvers on the card against the same
           solvers on the CPU (Sedov P1, Sedov pdg, GaussHump, GaussHump
           pdg, ALECG SlotCyl, ALECG VorticalFlow: 2 steps, u atol 1e-11,
           dt rtol 1e-12, ndofel equal where the state has one);
4. p1      the Sedov DG(P1) HLLC + Superbee step (bench.py) from its
           initial_state(): 1 warm-up and 10 timed steps through K1, K2
           and K3, 33 launches each; then the same 11 steps from the
           initial state tools/bench_l2_known_good.json was harvested
           from (see tpu_precision_initial_u), whose L2(sol) must match
           that file at rtol 5e-4;
5. pdg     the p-adaptive Sedov step (bench.py --pdg): 1 + 10 steps
           through K4, K2 and K3, 33 launches each; finite, with P0 and
           P1 elements;
6. hump    GaussHump transport on Dirichlet faces (the face Gauss-point
           path): 1 + 10 steps through K5 (left and right face states of
           every rhs and dt sweep: 8 launches a step) and K6 (3 a step);
           finite, and L2(err) < 0.5 L2(sol) against the analytic hump;
7. alecg   ALECG SlotCyl transport (bench_alecg.py): 1 + 10 steps through
           K7 alecg_vol, K8 alecg_edge and K9 cg_assemble, 3 launches each
           a step; finite, L2(sol) and L2(err) against the JAX package's
           CPU result (JAX_L2);
8. alecg_cf ALECG VorticalFlow Euler (bench_alecg.py --compflow): the same
           through K7 alecg_vol_cf, K8 alecg_edge_cf and K9.

Every path sets the launch counts to 0 just before it and reads them just
after; a kernel of the path that did not launch as stated, or one that
does not belong to it and launched, fails the run.  Any failure raises,
so the script exits non-zero.  Its last two lines are a JSON object of
the kernels and the result line {"ok": true, "device": {...}}.  Needs one
CUDA card, nvcc and no network.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_BIG = 48                      # the bench box: 48^3 hexes, 6 tets each
SMALL = (6, 6, 4)               # float64 Sedov parity mesh
HUMP_SMALL = (10, 10, 2)        # float64 GaussHump mesh (tests/test_dg.py)
L2_RTOL = 5e-4                  # bench.py's gate
#: ALECG legs of bench_alecg.py: (problem, box lo, box hi, cfl); the small
#: float64 card-vs-CPU meshes are tests/test_alecg_fused.py's
ALECG = {"alecg": ("slotcyl", (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 0.8),
         "alecg_cf": ("vortical", (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5), 0.5)}
ALECG_SMALL = {"alecg": ((10, 10, 5), (0.0, 0.0, 0.0), (1.0, 1.0, 0.5), 0.8),
               "alecg_cf": ((8, 8, 8), (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5),
                            0.6)}
#: L2(sol) and L2(err) per component after 11 float32 steps at 48^3 from
#: initial_state(), from the JAX package on the CPU (its XLA path, x64
#: off): quinoa_tpu.inciter.alecg.make_alecg on the bench_alecg.py mesh
#: (hilbert_element_reorder, first_touch_node_reorder, all boundary nodes
#: pinned), 11 step() calls, then quinoa_tpu.inciter.diagnostics.
JAX_L2 = {
    "alecg": {"l2sol": [0.15534241497516632],
              "l2err": [0.04810980707406998]},
    "alecg_cf": {"l2sol": [1.0, 0.2902412712574005, 0.2902684211730957,
                           0.05775976926088333, 15.08370590209961],
                 "l2err": [2.023221554736665e-07, 1.567408980918117e-05,
                           1.8303720935364254e-05, 2.188024609495187e-06,
                           0.00020845529797952622]},
}
JAX_L2_RTOL = 1e-4
# VorticalFlow is steady, so its L2(err) after 11 steps is float32
# round-off (2e-7 for rho = 1): the JAX package's own jitted and eager
# evaluations of the manufactured source differ by 9.5e-7.  L2(err) is
# held to rtol 1e-4 plus this many float32 ulps of the L2(sol) norm.
L2ERR_ULPS = 8
# |kernel - plain| <= TOL * max|plain| per output.  Kernel and plain
# version evaluate the same expressions in the same order without fused
# multiply-adds, so they differ only by torch's own reduction order;
# the bounds leave room for a few ulp in the largest entries.
TOL = {"float32": 1e-5, "float64": 1e-12}
SOLVER_ATOL = 1e-11             # small-mesh solvers, card vs CPU, 2 steps
REPS = 7                        # timed repetitions (median)
NSTEPS = 10                     # timed steps of each path, after 1 warm-up

KERNELS = {
    "limit_vol": ("quinoa_tpu_torch/csrc/limit_vol.cu",
                  "quinoa_tpu/ops/nbr_bounds.py:541"),
    "face_flux": ("quinoa_tpu_torch/csrc/face_flux.cu",
                  "quinoa_tpu/ops/face_fused.py:762"),
    "face_to_elem": ("quinoa_tpu_torch/csrc/face_to_elem.cu",
                     "quinoa_tpu/ops/face_fused.py:839"),
    "nbr_bounds": ("quinoa_tpu_torch/csrc/nbr_bounds.cu",
                   "quinoa_tpu/ops/nbr_bounds.py:258"),
    "face_gather": ("quinoa_tpu_torch/csrc/face_gather.cu",
                    "quinoa_tpu/ops/face_accum.py:698"),
    "face_accum": ("quinoa_tpu_torch/csrc/face_accum.cu",
                   "quinoa_tpu/ops/face_accum.py:644"),
    "alecg_vol": ("quinoa_tpu_torch/csrc/alecg_vol.cu",
                  "quinoa_tpu/ops/alecg_fused.py:259"),
    "alecg_vol_cf": ("quinoa_tpu_torch/csrc/alecg_vol.cu",
                     "quinoa_tpu/ops/alecg_fused.py:165"),
    "alecg_edge": ("quinoa_tpu_torch/csrc/alecg_edge.cu",
                   "quinoa_tpu/ops/alecg_fused.py:303"),
    "alecg_edge_cf": ("quinoa_tpu_torch/csrc/alecg_edge.cu",
                      "quinoa_tpu/ops/alecg_fused.py:214"),
    "cg_assemble": ("quinoa_tpu_torch/csrc/cg_assemble.cu",
                    "quinoa_tpu/ops/window_kernels.py:148"),
}
#: launches per step of each path; every other kernel must launch 0 times
PATHS = {
    "p1": {"limit_vol": 3, "face_flux": 3, "face_to_elem": 3},
    "pdg": {"nbr_bounds": 3, "face_flux": 3, "face_to_elem": 3},
    "hump": {"face_gather": 8, "face_accum": 3},
    "alecg": {"alecg_vol": 3, "alecg_edge": 3, "cg_assemble": 3},
    "alecg_cf": {"alecg_vol_cf": 3, "alecg_edge_cf": 3, "cg_assemble": 3},
}
#: the path whose launches the kernels line reports for each kernel
MAIN_PATH = {"limit_vol": "p1", "face_flux": "p1", "face_to_elem": "p1",
             "nbr_bounds": "pdg", "face_gather": "hump",
             "face_accum": "hump", "alecg_vol": "alecg",
             "alecg_edge": "alecg", "cg_assemble": "alecg",
             "alecg_vol_cf": "alecg_cf", "alecg_edge_cf": "alecg_cf"}


def tpu_precision_initial_u(solver, torch):
    """The initial state (C*K, E) the committed known-good L2 comes from.

    The known-good was harvested on a TPU, where XLA's default matmul
    precision rounds both operands of dg_initialize's two einsums (face
    coordinates and the L2 projection) to bfloat16 and accumulates in
    float32.  That shifts the projected state by up to ~1e-3 (the 14
    rounded Gauss weights sum to 1.000977), which the 5e-4 gate resolves.
    This reproduces the rounding: products of bfloat16 values are exact in
    float32.  The port's own initial_state() projects in full float32."""
    g, tb = solver.geom, solver.geom.tables
    f32 = dict(dtype=torch.float32, device=g.device)

    def bf16(x):
        return x.to(torch.bfloat16).to(torch.float32)

    xi = torch.as_tensor(tb["xi_init"].T, **f32)
    gp = g.node0[:, None, :] + torch.einsum("ime,mg->ige", bf16(g.Jmat),
                                            bf16(xi))
    f = solver.system.initialize(gp, 0.0)
    wB = torch.as_tensor(tb["w_init"][:, None] * tb["B_init"], **f32)
    proj = torch.einsum("gk,cge->cke", bf16(wB), bf16(f))
    mn = torch.as_tensor(tb["mnorm"], **f32)
    return (proj / mn[None, :, None]).reshape(-1, g.nelem).contiguous()


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def box_geom(n, bc_code, dtype, device):
    """DG(P1) geometry of a Hilbert-ordered box with one BC on all six
    sides: the unit cube at 48^3, 0.1 per cell on the Sedov mesh, and
    the GaussHump box of tests/test_dg.py."""
    from quinoa_tpu_torch.mesh import box_tet_mesh, hilbert_element_reorder
    from quinoa_tpu_torch.pde.dg import build_dggeom

    nx, ny, nz = n
    if n == (N_BIG,) * 3:
        hi = (1.0, 1.0, 1.0)
    elif n == HUMP_SMALL:
        hi = (1.0, 1.0, 0.2)
    else:
        hi = (0.1 * nx, 0.1 * ny, 0.1 * nz)
    mesh, _ = hilbert_element_reorder(box_tet_mesh(nx, ny, nz, hi=hi))
    bc = {i: bc_code for i in range(1, 7)}
    return build_dggeom(mesh, ndof=4, bc_sidesets=bc, dtype=dtype,
                        device=device)


def perturbed_state(E, seed):
    """Physical Sedov-like modal state with perturbed P1 dofs (the
    construction of tests/test_dg.py's fused-pass parity test)."""
    K = 4
    rng = np.random.default_rng(seed)
    U0 = np.zeros((5 * K, E))
    U0[0] = 1.0 + 0.05 * rng.random(E)
    U0[4 * K] = 2.5 + 0.05 * rng.random(E)
    U0[K] = 0.1 * rng.random(E)
    for ck in range(5 * K):
        if ck % K:
            U0[ck] = 0.01 * rng.random(E)
    return U0


def cuda_ms(torch, fn):
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(name, got, want, dtype_name):
    """max |got - want| over the outputs; raises past the tolerance."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: kernel gives {g.dtype} "
                                 f"{tuple(g.shape)}, plain {w.dtype} "
                                 f"{tuple(w.shape)}")
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        if not err <= TOL[dtype_name] * scale:
            raise AssertionError(
                f"{name} ({dtype_name}): max|kernel - plain| = {err:.3e} "
                f"exceeds {TOL[dtype_name]:g} * {scale:.3e}")
        worst = max(worst, err)
    return worst


def kernel_checks(torch, geom, system, U, dtype_name, timed):
    """Each kernel against its plain version on the same inputs; returns
    {name: (max_abs_err, ms, plain_ms)} (times only when timed)."""
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.ops.face_fused import (face_flux_plain,
                                                 face_to_elem_plain,
                                                 fused_face_pass)
    from quinoa_tpu_torch.ops.nbr_bounds import limit_vol_plain

    g = geom

    def k1():
        return kernels.limit_vol(U, g.esuelT, g.jacInv, g.vol * g.emask,
                                 g.ktab, 2.0, system.eos)

    def p1():
        return limit_vol_plain(system, g, U)

    ulim, rv = p1()

    def k2():
        return kernels.face_flux(ulim, g.el, g.er, g.fn, g.farea, g.fmask,
                                 g.xi_l, g.xi_r, g.bctype, g.ktab,
                                 system.eos)

    def p2():
        return face_flux_plain(system, g, ulim)

    cL, cR, mx = p2()

    def k3():
        return kernels.face_to_elem(cL, cR, mx, g.fose, g.fsideR, rv)

    def p3():
        return face_to_elem_plain(g, cL, cR, mx, rv)

    out = {}
    for name, kf, pf in (("limit_vol", k1, p1), ("face_flux", k2, p2),
                         ("face_to_elem", k3, p3)):
        err = compare(name, kf(), pf(), dtype_name)
        ms = cuda_ms(torch, kf) if timed else None
        plain_ms = cuda_ms(torch, pf) if timed else None
        out[name] = (err, ms, plain_ms)
        phase("kernels", f"{name} {dtype_name} E={g.nelem} F={g.nface}: "
              f"max|kernel-plain|={err:.3e} (tol {TOL[dtype_name]:g} * "
              "max|plain|)"
              + (f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                 if timed else ""))
    # K2 + K3 together, as the step calls them
    got = fused_face_pass(system, g, ulim, vol_rhs=rv)
    want = face_to_elem_plain(g, *face_flux_plain(system, g, ulim), rv)
    err = compare("face pass K2+K3", got, want, dtype_name)
    phase("kernels", f"K2+K3 {dtype_name}: max|kernel-plain|={err:.3e} "
          f"(tol {TOL[dtype_name]:g} * max|plain|)")
    return out


def face_gp_kernel_checks(torch, geom, U, hump, Uh, dtype_name, timed):
    """K4 on the Sedov state U of geom, K5 and K6 on the transport rows Uh
    of hump, against their plain versions; returns {name: (max_abs_err,
    ms, plain_ms)} (times only when timed)."""
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.ops.face_accum import (accumulate_faces_plain,
                                                 face_gather_plain)
    from quinoa_tpu_torch.ops.nbr_bounds import neighbor_mean_bounds_plain

    gen = torch.Generator(device=Uh.device).manual_seed(5)
    R = Uh.shape[0]
    cL, cR = torch.randn((2, R, hump.nface), generator=gen, device=Uh.device,
                         dtype=Uh.dtype)
    base = torch.randn((R, hump.nelem), generator=gen, device=Uh.device,
                       dtype=Uh.dtype)
    cases = (
        ("nbr_bounds", lambda: kernels.nbr_bounds(U, geom.esuelT, 5, 4),
         lambda: neighbor_mean_bounds_plain(geom, U[::4])),
        ("face_gather", lambda: kernels.face_gather(Uh, hump.el),
         lambda: face_gather_plain(Uh, hump.el)),
        ("face_accum",
         lambda: kernels.face_accum(cL, cR, hump.fose, hump.fsideR, base),
         lambda: accumulate_faces_plain(hump, cL, cR, base)),
    )
    out = {}
    for name, kf, pf in cases:
        got, want = kf(), pf()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        err = compare(name, got, want, dtype_name)
        ms = cuda_ms(torch, kf) if timed else None
        plain_ms = cuda_ms(torch, pf) if timed else None
        out[name] = (err, ms, plain_ms)
        phase("kernels", f"{name} {dtype_name} E={hump.nelem} "
              f"F={hump.nface} rows={R}: max|kernel-plain|={err:.3e} "
              f"(tol {TOL[dtype_name]:g} * max|plain|)"
              + (f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                 if timed else ""))
    err = compare("face_gather er", (kernels.face_gather(Uh, hump.er),),
                  (face_gather_plain(Uh, hump.er),), dtype_name)
    phase("kernels", f"face_gather er {dtype_name}: max|kernel-plain|="
          f"{err:.3e}")
    return out


def alecg_solver(name, n, dtype, device):
    """The ALECG solver of one bench_alecg.py leg on an n = (nx, ny, nz)
    box in Hilbert element and first-touch node order, every boundary
    node pinned."""
    from quinoa_tpu_torch.inciter.alecg import make_alecg
    from quinoa_tpu_torch.mesh import (box_tet_mesh, first_touch_node_reorder,
                                       hilbert_element_reorder)
    from quinoa_tpu_torch.pde.cg import CGTransport
    from quinoa_tpu_torch.pde.cg_compflow import CGCompFlow
    from quinoa_tpu_torch.pde.problems import SlotCyl, VorticalFlow

    problem, lo, hi, cfl = ALECG[name]
    if n != (N_BIG,) * 3:
        _, lo, hi, cfl = ALECG_SMALL[name]
    system = (CGTransport(SlotCyl()) if problem == "slotcyl"
              else CGCompFlow(VorticalFlow()))
    mesh, _ = hilbert_element_reorder(box_tet_mesh(*n, lo=lo, hi=hi))
    mesh, _ = first_touch_node_reorder(mesh)
    return make_alecg(system, mesh, cfl=cfl, bcnodes=mesh.all_bnodes(),
                      dtype=dtype, device=device)


def alecg_kernel_checks(torch, solver, dtype_name, timed):
    """K7, K8 (the solver's flavour) and K9 against their plain versions on
    the solver's initial state, then the three as the stage rhs; returns
    {name: (max_abs_err, ms, plain_ms)} (times only when timed)."""
    from quinoa_tpu_torch.ops.alecg_fused import (alecg_edge,
                                                  alecg_edge_plain,
                                                  alecg_rhs, alecg_vol,
                                                  alecg_vol_plain,
                                                  cg_assemble,
                                                  cg_assemble_plain)

    g, e, rows, sy = solver.geom, solver.edget, solver.rows, solver.system
    u = solver.initial_state().u
    cv = alecg_vol_plain(sy, g, rows, u)
    d = alecg_edge_plain(sy, e, rows, u)
    sfx = "" if sy.flavour == "transport" else "_cf"
    cases = (
        ("alecg_vol" + sfx, lambda: alecg_vol(sy, g, rows, u),
         lambda: alecg_vol_plain(sy, g, rows, u)),
        ("alecg_edge" + sfx, lambda: alecg_edge(sy, e, rows, u),
         lambda: alecg_edge_plain(sy, e, rows, u)),
        ("cg_assemble", lambda: cg_assemble(cv, d, g.nsup, e.ensup),
         lambda: cg_assemble_plain(cv, d, g.nsup, e.ensup)),
    )
    out = {}
    for name, kf, pf in cases:
        err = compare(name, (kf(),), (pf(),), dtype_name)
        ms = cuda_ms(torch, kf) if timed else None
        plain_ms = cuda_ms(torch, pf) if timed else None
        out[name] = (err, ms, plain_ms)
        phase("kernels", f"{name} {dtype_name} N={g.nnode} E={g.nelem} "
              f"nE={e.edges.shape[1]} rows={u.shape[0]}: max|kernel-plain|="
              f"{err:.3e} (tol {TOL[dtype_name]:g} * max|plain|)"
              + (f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                 if timed else ""))
    err = compare("stage rhs K7+K8+K9", (alecg_rhs(sy, g, e, rows, u),),
                  (cg_assemble_plain(cv, d, g.nsup, e.ensup),), dtype_name)
    phase("kernels", f"K7+K8+K9{sfx} {dtype_name}: max|kernel-plain|="
          f"{err:.3e} (tol {TOL[dtype_name]:g} * max|plain|)")
    return out


def card_vs_cpu(torch, name, make):
    """Two float64 steps of make(device) on the card and on the CPU;
    ndofel must agree where the state has one (DG)."""
    on_card, on_cpu = make("card"), make("cpu")
    sa = on_card.nsteps(on_card.initial_state(), 2)
    sb = on_cpu.nsteps(on_cpu.initial_state(), 2)
    err = float((sa.u.cpu() - sb.u).abs().max())
    dterr = abs(float(sa.dt) - float(sb.dt))
    dg = hasattr(sb, "ndofel")
    same = not dg or bool(torch.equal(sa.ndofel.cpu(), sb.ndofel))
    if not (err <= SOLVER_ATOL and dterr <= 1e-12 * float(sb.dt) and same):
        raise AssertionError(f"{name} card vs CPU: |du|={err:.3e} "
                             f"|ddt|={dterr:.3e} ndofel equal: {same}")
    extra = (f", ndofel equal, P1 elements {int((sb.ndofel == 4).sum())}"
             if dg else f", N={on_cpu.geom.nnode}")
    phase("kernels", f"small solver {name} (E={on_cpu.geom.nelem}, f64, 2 "
          f"steps) card vs CPU: max|du|={err:.3e} |ddt|={dterr:.3e}"
          f"{extra} (atol {SOLVER_ATOL:g}, dt rtol 1e-12)")


def drive(torch, solver, name, card, state=None):
    """1 warm-up and NSTEPS timed steps of one path, with the launch
    counts zeroed just before and read just after; returns (state,
    counts, wall seconds of the timed steps)."""
    from quinoa_tpu_torch import kernels

    if state is None:
        state = solver.initial_state()
    torch.cuda.synchronize()
    kernels.reset_launches()
    state = solver.step(state)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NSTEPS):
        state = solver.step(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    want = {k: (NSTEPS + 1) * PATHS[name].get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{name}: kernel launches {counts}, expected "
                             f"{want}")
    if not bool(torch.isfinite(state.u).all()):
        raise AssertionError(f"{name}: non-finite state after "
                             f"{NSTEPS + 1} steps")
    if name in ALECG:
        unit, n = "node-updates/s", solver.geom.nnode    # bench_alecg.py:66
    else:
        unit, n = "cell-updates/s", solver.geom.nelem
    phase(name, f"{n * NSTEPS / wall:.1f} {unit}, "
          f"{1e3 * wall / NSTEPS:.3f} ms/step, t={float(state.t):.9e}, "
          f"launches {counts}, on {card}")
    return state, counts, wall


def alecg_gate(name, solver, state):
    """L2(sol) and L2(err) after 11 float32 steps against JAX_L2."""
    from quinoa_tpu_torch.inciter.diagnostics import Diagnostics

    row = Diagnostics(solver.system, solver.geom).compute(state)
    want = JAX_L2[name]
    eps = float(np.finfo(np.float32).eps)
    ok = (np.allclose(row.l2sol, want["l2sol"], rtol=JAX_L2_RTOL, atol=0.0)
          and all(abs(a - b) <= JAX_L2_RTOL * abs(b) + L2ERR_ULPS * eps * s
                  for a, b, s in zip(row.l2err, want["l2err"],
                                     want["l2sol"])))
    phase(name, f"after {row.it} steps t={row.t:.9e}: L2(sol) {row.l2sol} "
          f"vs JAX {want['l2sol']}; L2(err) {row.l2err} vs JAX "
          f"{want['l2err']}: {'ok' if ok else 'FAIL'} (rtol {JAX_L2_RTOL:g}"
          f", L2(err) + {L2ERR_ULPS} f32 ulps of L2(sol))")
    if not ok:
        raise AssertionError(f"{name}: L2 gate failed")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.inciter.dg import DGDiagnostics, DGSolver
    from quinoa_tpu_torch.pde.dg import BC_DIRICHLET, BC_SYMMETRY
    from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow, DGTransport
    from quinoa_tpu_torch.pde.problems import GaussHump, SedovBlastwave

    # full float32 matmuls (dg_initialize's einsums); TF32 is off by
    # default, set here so the run does not depend on the default
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    phase("card", f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    kernels.build()
    phase("build", f"{time.perf_counter() - t0:.1f} s "
          f"({os.path.basename(kernels.library_path())})")
    for line in kernels.build_log().splitlines():
        if "registers" in line or "spill" in line:
            phase("build", line.strip())

    system = DGCompFlow(SedovBlastwave(), riemann_flux="hllc")
    transport = DGTransport(GaussHump())

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    big = box_geom((N_BIG,) * 3, BC_SYMMETRY, torch.float32, dev)
    hump = box_geom((N_BIG,) * 3, BC_DIRICHLET, torch.float32, dev)
    phase("kernels", f"48^3 geometries (Sedov, GaussHump): E={big.nelem} "
          f"F={big.nface}, {time.perf_counter() - t0:.1f} s on the host")
    U = torch.as_tensor(perturbed_state(big.nelem, 7)).to(torch.float32
                                                          ).to(dev)
    stats = kernel_checks(torch, big, system, U, "float32", timed=True)
    hump_solver = DGSolver(transport, hump, cfl=0.8)
    Uh = hump_solver.initial_state().u
    stats.update(face_gp_kernel_checks(torch, big, U, hump, Uh, "float32",
                                       timed=True))
    small = box_geom(SMALL, BC_SYMMETRY, torch.float64, dev)
    U64 = torch.as_tensor(perturbed_state(small.nelem, 11)).to(dev)
    kernel_checks(torch, small, system, U64, "float64", timed=False)
    hump_small = box_geom(HUMP_SMALL, BC_DIRICHLET, torch.float64, dev)
    Uh64 = DGSolver(transport, hump_small).initial_state().u
    face_gp_kernel_checks(torch, small, U64, hump_small, Uh64, "float64",
                          timed=False)
    t0 = time.perf_counter()
    alecg = {name: alecg_solver(name, (N_BIG,) * 3, torch.float32, dev)
             for name in ALECG}
    phase("kernels", f"48^3 ALECG solvers (SlotCyl, VorticalFlow): N="
          f"{alecg['alecg'].geom.nnode} E={alecg['alecg'].geom.nelem} "
          f"nE={alecg['alecg'].edget.edges.shape[1]} nsup D="
          f"{alecg['alecg'].geom.nsup.shape[0]} ensup D="
          f"{alecg['alecg'].edget.ensup.shape[0]}, "
          f"{time.perf_counter() - t0:.1f} s on the host")
    for name in ALECG:
        # K9 reports its time at the transport leg's row count
        for k, v in alecg_kernel_checks(torch, alecg[name], "float32",
                                        timed=True).items():
            stats.setdefault(k, v)
        alecg_kernel_checks(torch, alecg_solver(name, ALECG_SMALL[name][0],
                                                torch.float64, dev),
                            "float64", timed=False)

    geoms = {}

    def geom(name, device):
        if (name, device) not in geoms:
            bc = BC_SYMMETRY if name == "sedov" else BC_DIRICHLET
            n = SMALL if name == "sedov" else HUMP_SMALL
            geoms[name, device] = box_geom(n, bc, torch.float64,
                                           dev if device == "card" else
                                           "cpu")
        return geoms[name, device]

    card_vs_cpu(torch, "sedov_p1", lambda d: DGSolver(
        system, geom("sedov", d), cfl=0.5, limiter="superbeep1"))
    card_vs_cpu(torch, "sedov_pdg", lambda d: DGSolver(
        system, geom("sedov", d), cfl=0.5, limiter="superbeep1", pref=True))
    card_vs_cpu(torch, "gausshump", lambda d: DGSolver(
        transport, geom("hump", d), cfl=0.8))
    card_vs_cpu(torch, "gausshump_pdg", lambda d: DGSolver(
        transport, geom("hump", d), cfl=0.8, pref=True))
    for name in ALECG:
        card_vs_cpu(torch, name, lambda d, name=name: alecg_solver(
            name, ALECG_SMALL[name][0], torch.float64,
            dev if d == "card" else "cpu"))

    # 4. the Sedov P1 step
    counts = {}
    solver = DGSolver(system, big, cfl=0.5, limiter="superbeep1")
    state, counts["p1"], _ = drive(torch, solver, "p1", card)
    diag = DGDiagnostics(system, big)
    phase("p1", f"L2(sol) from initial_state(): {diag.compute(state)[0]}")

    # the L2 gate, from the known-good's own initial state
    gate = dataclasses.replace(solver.initial_state(),
                               u=tpu_precision_initial_u(solver, torch))
    gate = solver.nsteps(gate, NSTEPS + 1)
    if not bool(torch.isfinite(gate.u).all()):
        raise AssertionError("non-finite gate state after 11 steps")
    l2sol, _, _ = diag.compute(gate)
    with open(os.path.join(REPO, "tools", "bench_l2_known_good.json")) as fh:
        good = json.load(fh)["l2sol"]
    ok = np.allclose(l2sol, good, rtol=L2_RTOL, atol=0.0)
    phase("p1", f"L2(sol) from the known-good's initial state {l2sol} "
          f"vs {good}: {'ok' if ok else 'FAIL'} (rtol {L2_RTOL}, max rel "
          f"{max(abs(a - b) / abs(b) for a, b in zip(l2sol, good)):.3e})")
    if not ok:
        raise AssertionError("L2(sol) gate failed")

    # 5. the p-adaptive Sedov step
    solver = DGSolver(system, big, cfl=0.5, limiter="superbeep1", pref=True)
    state, counts["pdg"], _ = drive(torch, solver, "pdg", card)
    n4 = int((state.ndofel == 4).sum())
    if not 0 < n4 < big.nelem:
        raise AssertionError(f"pdg: {n4} of {big.nelem} elements at P1, "
                             "expected a mix of P0 and P1")
    phase("pdg", f"P1 share {n4 / big.nelem:.6f} ({n4} of {big.nelem} "
          f"elements), L2(sol) {DGDiagnostics(system, big).compute(state)[0]}")

    # 6. GaussHump transport on the face Gauss-point path
    state, counts["hump"], _ = drive(torch, hump_solver, "hump", card)
    l2sol, l2err, _ = DGDiagnostics(transport, hump).compute(state)
    phase("hump", f"L2(sol) {l2sol[0]:.9e}, L2(err) {l2err[0]:.9e}")
    if not l2err[0] < 0.5 * l2sol[0]:
        raise AssertionError("hump: L2(err) >= 0.5 L2(sol)")

    # 7-8. ALECG SlotCyl transport and VorticalFlow Euler
    for name in ALECG:
        state, counts[name], _ = drive(torch, alecg[name], name, card)
        alecg_gate(name, alecg[name], state)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[MAIN_PATH[name]][name],
         "max_abs_err": stats[name][0], "ms": stats[name][1],
         "plain_ms": stats[name][2]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
