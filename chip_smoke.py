#!/usr/bin/env python3
"""Smoke test of quinoa_tpu_torch on one NVIDIA GPU: python3 chip_smoke.py

Drives the port's main path, the Sedov DG(P1) HLLC + Superbee step at 48^3
(663,552 tets) in float32, through its hand-written CUDA kernels:

1. card    the name and power limit from nvidia-smi;
2. build   compile csrc/*.cu with nvcc (sm_90a) and load the library;
3. kernels each kernel against its plain torch version on the card, on a
           perturbed Sedov state: float32 at 48^3 and float64 on a small
           mesh, with a CUDA-event time for both; then the small-mesh
           solver on the card against the same solver on the CPU;
4. slice   DGSolver at 48^3 from its initial_state(): 1 warm-up and 10
           timed steps; every kernel must have launched 33 times and the
           state must be finite.  Then the same 11 steps from the initial
           state tools/bench_l2_known_good.json was harvested from (see
           tpu_precision_initial_u), whose L2(sol) must match that file at
           rtol 5e-4.

Any failure raises, so the script exits non-zero.  Its last two lines
are a JSON object of the kernels and the result line
{"ok": true, "device": {...}}.  Needs one CUDA card, nvcc and no network.
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
SMALL = (6, 6, 4)               # float64 parity mesh
L2_RTOL = 5e-4                  # bench.py's gate
# |kernel - plain| <= TOL * max|plain| per output.  Kernel and plain
# version evaluate the same expressions in the same order without fused
# multiply-adds, so they differ only by torch's own reduction order;
# the bounds leave room for a few ulp in the largest entries.
TOL = {"float32": 1e-5, "float64": 1e-12}
SOLVER_ATOL = 1e-11             # small-mesh solver, card vs CPU, 2 steps
REPS = 7                        # timed repetitions (median)

KERNELS = {
    "limit_vol": ("quinoa_tpu_torch/csrc/limit_vol.cu",
                  "quinoa_tpu/ops/nbr_bounds.py:541"),
    "face_flux": ("quinoa_tpu_torch/csrc/face_flux.cu",
                  "quinoa_tpu/ops/face_fused.py:762"),
    "face_to_elem": ("quinoa_tpu_torch/csrc/face_to_elem.cu",
                     "quinoa_tpu/ops/face_fused.py:839"),
}


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


def sedov_geom(n, torch, dtype, device):
    from quinoa_tpu_torch.mesh import box_tet_mesh, hilbert_element_reorder
    from quinoa_tpu_torch.pde.dg import BC_SYMMETRY, build_dggeom

    nx, ny, nz = n
    hi = (1.0, 1.0, 1.0) if n == (N_BIG,) * 3 else (0.1 * nx, 0.1 * ny,
                                                     0.1 * nz)
    mesh, _ = hilbert_element_reorder(box_tet_mesh(nx, ny, nz, hi=hi))
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
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


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.inciter.dg import DGDiagnostics, DGSolver
    from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow
    from quinoa_tpu_torch.pde.problems import SedovBlastwave

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

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    big = sedov_geom((N_BIG,) * 3, torch, torch.float32, dev)
    phase("kernels", f"48^3 geometry: E={big.nelem} F={big.nface}, "
          f"{time.perf_counter() - t0:.1f} s on the host")
    U = torch.as_tensor(perturbed_state(big.nelem, 7)).to(torch.float32
                                                          ).to(dev)
    stats = kernel_checks(torch, big, system, U, "float32", timed=True)
    small = sedov_geom(SMALL, torch, torch.float64, dev)
    U64 = torch.as_tensor(perturbed_state(small.nelem, 11)).to(dev)
    kernel_checks(torch, small, system, U64, "float64", timed=False)

    small_cpu = sedov_geom(SMALL, torch, torch.float64, "cpu")
    on_card = DGSolver(system, small, cfl=0.5, limiter="superbeep1")
    on_cpu = DGSolver(system, small_cpu, cfl=0.5, limiter="superbeep1")
    sa = on_card.nsteps(on_card.initial_state(), 2)
    sb = on_cpu.nsteps(on_cpu.initial_state(), 2)
    err = float((sa.u.cpu() - sb.u).abs().max())
    dterr = abs(float(sa.dt) - float(sb.dt))
    if not (err <= SOLVER_ATOL and dterr <= 1e-12 * float(sb.dt)):
        raise AssertionError(f"small solver card vs CPU: |du|={err:.3e} "
                             f"|ddt|={dterr:.3e}")
    phase("kernels", f"small solver (E={small.nelem}, f64, 2 steps) card "
          f"vs CPU: max|du|={err:.3e} |ddt|={dterr:.3e} (atol "
          f"{SOLVER_ATOL:g}, dt rtol 1e-12)")

    # 4. the slice
    solver = DGSolver(system, big, cfl=0.5, limiter="superbeep1")
    state = solver.initial_state()
    torch.cuda.synchronize()
    kernels.reset_launches()
    state = solver.step(state)                       # warm-up
    torch.cuda.synchronize()
    nsteps = 10
    t0 = time.perf_counter()
    for _ in range(nsteps):
        state = solver.step(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    want = 3 * (nsteps + 1)
    if any(counts[k] != want for k in KERNELS):
        raise AssertionError(f"kernel launches {counts}, expected {want} "
                             "each")
    if not bool(torch.isfinite(state.u).all()):
        raise AssertionError("non-finite state after 11 steps")
    diag = DGDiagnostics(system, big)
    ms = 1e3 * wall / nsteps
    phase("slice", f"{big.nelem * nsteps / wall:.1f} cell-updates/s, "
          f"{ms:.3f} ms/step, t={float(state.t):.9e}, launches {counts}, "
          f"on {card}")
    phase("slice", f"L2(sol) from initial_state(): {diag.compute(state)[0]}")

    # the L2 gate, from the known-good's own initial state
    gate = dataclasses.replace(solver.initial_state(),
                               u=tpu_precision_initial_u(solver, torch))
    gate = solver.nsteps(gate, nsteps + 1)
    if not bool(torch.isfinite(gate.u).all()):
        raise AssertionError("non-finite gate state after 11 steps")
    l2sol, _, _ = diag.compute(gate)
    with open(os.path.join(REPO, "tools", "bench_l2_known_good.json")) as fh:
        good = json.load(fh)["l2sol"]
    ok = np.allclose(l2sol, good, rtol=L2_RTOL, atol=0.0)
    phase("slice", f"L2(sol) from the known-good's initial state {l2sol} "
          f"vs {good}: {'ok' if ok else 'FAIL'} (rtol {L2_RTOL}, max rel "
          f"{max(abs(a - b) / abs(b) for a, b in zip(l2sol, good)):.3e})")
    if not ok:
        raise AssertionError("L2(sol) gate failed")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": stats[name][0],
         "ms": stats[name][1], "plain_ms": stats[name][2]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
