"""Card tests of quinoa_tpu_torch's CUDA kernels (marker ``cuda``).

Each kernel against its plain torch version on the same card tensors, and
the solver on the card against the same solver on the CPU.  They skip
where there is no CUDA device; on a machine with one (and nvcc) run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(--noconftest: the repo's conftest configures jax, which the card machine
need not have; this file imports no jax).
"""

import numpy as np
import pytest
import torch

from quinoa_tpu_torch import kernels
from quinoa_tpu_torch.inciter.dg import DGSolver
from quinoa_tpu_torch.mesh import box_tet_mesh, hilbert_element_reorder
from quinoa_tpu_torch.ops.face_accum import (accumulate_faces,
                                             accumulate_faces_plain,
                                             face_gather, face_gather_plain)
from quinoa_tpu_torch.ops.face_fused import (basis_accum_plain,
                                             face_wflux_plain,
                                             fused_face_pass)
from quinoa_tpu_torch.ops.nbr_bounds import (limit_vol_plain,
                                             neighbor_mean_bounds,
                                             neighbor_mean_bounds_plain,
                                             superbee_limit_window)
from quinoa_tpu_torch.pde.dg import (BC_DIRICHLET, BC_EXTRAPOLATE,
                                     BC_SYMMETRY, build_dggeom)
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow, DGTransport
from quinoa_tpu_torch.pde.problems import (GaussHump, SedovBlastwave,
                                           TaylorGreen)

pytestmark = pytest.mark.cuda

#: every kernel's launch count at zero
ZERO = {"limit_vol": 0, "limit_vol_pref": 0, "nbr_bounds": 0,
        "face_gather": 0, "face_accum": 0, "alecg_vol": 0, "alecg_vol_cf": 0,
        "alecg_edge": 0, "alecg_edge_cf": 0, "cg_assemble": 0,
        "node_gather": 0, "node_assemble": 0, "face_wflux": 0,
        "face_wflux_lf": 0, "basis_accum": 0, "mm_face_wflux": 0,
        "mm_face_wflux_thinc": 0, "mm_limit": 0, "mm_volume": 0,
        "mm_volume_nc": 0}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build()
    return torch.device("cuda", 0)


def _geom(device, dtype, ndof=4, n=(6, 6, 4)):
    mesh, _ = hilbert_element_reorder(
        box_tet_mesh(*n, hi=tuple(m / 10 for m in n)))
    return build_dggeom(mesh, ndof, {i: BC_SYMMETRY for i in range(1, 7)},
                        dtype=dtype, device=device)


def _ragged(n):
    """n elements or faces leave a ragged last block for every tile and
    lane group of K1, K12, K13 and K14 (a multiple of 32 entries a
    block)."""
    return n % 32 != 0


def _same(got, want):
    """Bit for bit, a NaN matching a NaN."""
    return all(a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all()) for a, b in zip(got, want))


def _state(E, dtype, device):
    rng = np.random.default_rng(7)
    U = rng.random((20, E)) * 0.01
    U[0] += 1.0
    U[16] += 2.5
    return torch.as_tensor(U).to(dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_versions(card, dtype):
    """K1, then K12 + K13 as the DG(P1) step calls them (fused_face_pass on
    K1's limited state and volume term), bit for bit."""
    system = DGCompFlow(SedovBlastwave())
    g = _geom(card, dtype)
    U = _state(g.nelem, dtype, card)
    kernels.reset_launches()
    ulim, rv = superbee_limit_window(g, U, system)
    assert _same((ulim, rv), limit_vol_plain(system, g, U))
    assert _same(fused_face_pass(system, g, ulim, rv),
                 basis_accum_plain(g, *face_wflux_plain(system, g, ulim), rv))
    torch.cuda.synchronize()
    assert kernels.launches == {**ZERO, "limit_vol": 1, "face_wflux": 1,
                                "basis_accum": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_limit_vol_and_basis_accum_bit_for_bit(card, dtype):
    """K1 and K13 (on the plain K12's rows of K1's limited state) against
    their plain versions bit for bit on a box whose element count leaves
    every lane layout a ragged last block, with boundary elements (esuelT
    = -1), an element whose volume points have negative pressure and one
    without density or momentum (0/0: NaN in its volume flux and its
    faces' fluxes, matched by position); K13 with and without the volume
    term."""
    system = DGCompFlow(SedovBlastwave())
    g = _geom(card, dtype, 4, (6, 6, 3))
    assert _ragged(g.nelem) and bool((g.esuelT < 0).any())
    U = _state(g.nelem, dtype, card)
    Uv = U.view(5, 4, -1)
    Uv[1, 0, 5] = 3.0                  # kinetic energy 4.5 > rhoE 2.5
    Uv[:4, :, g.nelem // 2] = 0.0
    kernels.reset_launches()
    got = kernels.limit_vol(U, g.esuelT, g.jacInv, g.vol * g.emask, g.ktab,
                            2.0, system.eos)
    ulim, rv = limit_vol_plain(system, g, U)
    assert _same(got, (ulim, rv))
    assert float(system.eos.pressure_cons_cm(ulim.view(5, 4, -1)[:, 0,
                                                                 5])) < 0
    assert bool(rv.isnan().any()) and not bool(rv.isnan().all())
    wfl, mx = face_wflux_plain(system, g, ulim)
    assert bool(wfl.isnan().any())
    for base in (None, rv):
        assert _same(kernels.basis_accum(wfl, mx, g.fose, g.fsideR, g.xi_l,
                                         g.xi_r, 4, base),
                     basis_accum_plain(g, wfl, mx, base))
    torch.cuda.synchronize()
    assert kernels.launches == {**ZERO, "limit_vol": 1, "basis_accum": 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mix", ["mixed", "p0", "p1"])
def test_limit_vol_pref_matches_plain(card, dtype, mix):
    """K1's p-adaptive flavour against limit_vol_plain(..., ndofel=) bit
    for bit: the limited (masked) state whole, a P0 element's zeroed
    slopes to the sign of their zeros, the volume integral on every
    active row; a P0 element's inactive volume rows are zero.  With every element at P1 it equals
    the non-adaptive K1 whole.  The ragged box of
    test_limit_vol_and_basis_accum_bit_for_bit, with a negative slope on
    a P0 element (its masked rows are -0)."""
    system = DGCompFlow(SedovBlastwave())
    g = _geom(card, dtype, 4, (6, 6, 3))
    assert _ragged(g.nelem)
    U = _state(g.nelem, dtype, card)
    U.view(5, 4, -1)[1, 1] -= 0.02
    rng = np.random.default_rng(11)
    nd = {"mixed": np.where(rng.random(g.nelem) < 0.5, 1, 4),
          "p0": np.ones(g.nelem), "p1": np.full(g.nelem, 4)}[mix]
    ndofel = torch.as_tensor(nd, dtype=torch.int32, device=card)
    kernels.reset_launches()
    got = superbee_limit_window(g, U, system, ndofel=ndofel)
    torch.cuda.synchronize()
    assert kernels.launches == {**ZERO, "limit_vol_pref": 1}
    ulim, rv = limit_vol_plain(system, g, U, ndofel=ndofel)
    active = (torch.arange(4, device=card)[:, None]
              < ndofel[None, :]).repeat(5, 1)
    assert _same((got[0],), (ulim,))
    assert torch.equal(got[0][~active].signbit(), ulim[~active].signbit())
    assert _same((got[1][active],), (rv[active],))
    assert bool((got[1][~active] == 0).all())
    if mix != "p1":
        assert bool((got[0][~active] == 0).all())
        assert bool(got[0][~active].signbit().any())
    else:
        assert _same(got, kernels.limit_vol(U, g.esuelT, g.jacInv,
                                            g.vol * g.emask, g.ktab, 2.0,
                                            system.eos))
        torch.cuda.synchronize()
        assert kernels.launches == {**ZERO, "limit_vol_pref": 1,
                                    "limit_vol": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_face_gp_kernels_match_plain_versions(card, dtype):
    """K4, K5 and K6 against their plain versions: bit for bit (selects,
    copies, and sums in the same order)."""
    g = _geom(card, dtype)
    U = _state(g.nelem, dtype, card)
    kernels.reset_launches()
    for got, want in zip(neighbor_mean_bounds(g, U, 5),
                         neighbor_mean_bounds_plain(g, U[::4])):
        assert torch.equal(got, want)
    for idx in (g.el, g.er):
        assert torch.equal(face_gather(U, idx), face_gather_plain(U, idx))
    gen = torch.Generator(device=card).manual_seed(3)
    cL, cR = torch.randn((2, 4, g.nface), generator=gen, device=card,
                         dtype=dtype)
    base = torch.randn((4, g.nelem), generator=gen, device=card,
                       dtype=dtype)
    for b in (None, base):
        assert torch.equal(accumulate_faces(g, cL, cR, b),
                           accumulate_faces_plain(g, cL, cR, b))
    torch.cuda.synchronize()
    assert kernels.launches == {**ZERO, "nbr_bounds": 1, "face_gather": 2,
                                "face_accum": 2}


@pytest.mark.parametrize("case", ["faces", "pad", "nan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("flux", ["hllc", "laxfriedrichs"])
@pytest.mark.parametrize("ndof", [1, 4, 10])
def test_face_kernel_pad_faces(card, ndof, flux, dtype, case):
    """K12 (a face tile or a thread per face, as the instance takes it)
    against its plain version bit for bit, with either flux, on a box
    whose face count leaves every tile a ragged last block (16 or 32
    faces) and which has symmetry and extrapolate faces.  pad: every 7th
    face is a pad face (fmask 0), whose left states are all zero (0/0,
    NaN on the real faces that share those elements); with HLLC it
    contributes exactly nothing (with Lax-Friedrichs the unit state's
    negative pressure gives NaN there, as in the JAX package's B11);
    nan: one element's mean has more kinetic energy than energy (negative
    pressure: a NaN sound speed at its face points, as Sedov's first stage
    has) and another has no density or momentum (0/0 states), matched NaN
    for NaN."""
    import dataclasses

    system = DGCompFlow(SedovBlastwave(), riemann_flux=flux)
    mesh, _ = hilbert_element_reorder(box_tet_mesh(6, 5, 3,
                                                   hi=(0.6, 0.5, 0.3)))
    g = build_dggeom(mesh, ndof, {i: BC_SYMMETRY if i < 4 else BC_EXTRAPOLATE
                                  for i in range(1, 7)},
                     dtype=dtype, device=card)
    assert _ragged(g.nface) and g.nface % 16 != 0
    assert {BC_SYMMETRY, BC_EXTRAPOLATE} <= set(g.bctype.tolist())
    rng = np.random.default_rng(13)
    U = rng.random((5 * ndof, g.nelem)) * 0.01
    U[0] += 1.0
    U[4 * ndof] += 2.5
    U = torch.as_tensor(U).to(dtype).to(card)
    Uv = U.view(5, ndof, -1)
    if case == "pad":
        pad = torch.arange(g.nface, device=card) % 7 == 0
        g = dataclasses.replace(g, fmask=torch.where(pad, 0.0, g.fmask))
        U[:, g.el[pad].long()] = 0.0
    elif case == "nan":
        Uv[1, 0, 5] = 3.0                  # kinetic energy 4.5 > rhoE 2.5
        Uv[:4, :, g.nelem // 2] = 0.0
    kernels.reset_launches()
    wfl, mx = kernels.face_wflux(U, g.el, g.er, g.fn, g.farea, g.fmask,
                                 g.xi_l, g.xi_r, g.bctype, g.w_face,
                                 system.eos, flux)
    pw, pm = face_wflux_plain(system, g, U)
    assert _same((wfl, mx), (pw, pm))
    assert bool(pw.isnan().any()) == (case != "faces")
    if case == "pad" and flux == "hllc":
        assert bool((pw[:, pad] == 0).all()) and bool((pm[pad] == 0).all())
    torch.cuda.synchronize()
    assert kernels.launches == {**ZERO, kernels.FLUXES[flux][1]: 1}


def test_solver_on_card_matches_cpu(card):
    """Two float64 steps from the Sedov IC (which has face points of
    negative pressure: NaN propagation must match), atol 1e-11; each step
    launches K1, K12 and K13 three times and nothing else."""
    system = DGCompFlow(SedovBlastwave())
    a = DGSolver(system, _geom(card, torch.float64), limiter="superbeep1")
    b = DGSolver(system, _geom("cpu", torch.float64), limiter="superbeep1")
    kernels.reset_launches()
    sa = a.nsteps(a.initial_state(), 2)
    sb = b.nsteps(b.initial_state(), 2)
    torch.cuda.synchronize()
    assert kernels.launches == {**ZERO, "limit_vol": 6, "face_wflux": 6,
                                "basis_accum": 6}
    assert bool(torch.isfinite(sa.u).all())
    assert float((sa.u.cpu() - sb.u).abs().max()) <= 1e-11
    assert abs(float(sa.dt) - float(sb.dt)) <= 1e-12 * float(sb.dt)


@pytest.mark.parametrize("case", ["sedov_pdg", "gausshump",
                                  "gausshump_pdg"])
def test_new_paths_on_card_match_cpu(card, case):
    """The p-adaptive and face Gauss-point paths, two float64 steps on
    the card against the CPU: u atol 1e-11, dt rtol 1e-12, ndofel
    equal, only the path's kernels launched (Sedov pdg: K1's p-adaptive
    flavour, K12 and K13 three times a step)."""
    def solver(device):
        if case == "sedov_pdg":
            return DGSolver(DGCompFlow(SedovBlastwave()),
                            _geom(device, torch.float64),
                            limiter="superbeep1", pref=True)
        mesh = box_tet_mesh(10, 10, 2, hi=(1.0, 1.0, 0.2))
        g = build_dggeom(mesh, 4, {i: BC_DIRICHLET for i in range(1, 7)},
                         dtype=torch.float64, device=device)
        return DGSolver(DGTransport(GaussHump()), g, cfl=0.8,
                        pref=case == "gausshump_pdg")

    a, b = solver(card), solver("cpu")
    kernels.reset_launches()
    sa = a.nsteps(a.initial_state(), 2)
    sb = b.nsteps(b.initial_state(), 2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(sa.u).all())
    assert torch.equal(sa.ndofel.cpu(), sb.ndofel)
    assert float((sa.u.cpu() - sb.u).abs().max()) <= 1e-11
    assert abs(float(sa.dt) - float(sb.dt)) <= 1e-12 * float(sb.dt)
    path = {"sedov_pdg": ("limit_vol_pref", "face_wflux", "basis_accum"),
            "gausshump": ("face_gather", "face_accum"),
            "gausshump_pdg": ("face_gather", "face_accum")}[case]
    assert {k for k, v in kernels.launches.items() if v} == set(path)
    if case == "sedov_pdg":
        assert kernels.launches == {**ZERO, **{k: 6 for k in path}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ndof", [1, 4, 10])
def test_single_stream_kernels_match_plain_versions(card, ndof, dtype):
    """K12 and K13 at P0, P1 and P2 against their plain versions bit for bit
    (the same expressions in the same order, sums in point and slot
    order), alone and as fused_face_pass, on a box whose element count
    leaves K13 a ragged last block."""
    system = DGCompFlow(SedovBlastwave())
    g = _geom(card, dtype, ndof, (6, 6, 3))
    assert _ragged(g.nelem)
    rng = np.random.default_rng(9)
    U = rng.random((5 * ndof, g.nelem)) * 0.01
    U[0] += 1.0
    U[4 * ndof] += 2.5
    U = torch.as_tensor(U).to(dtype).to(card)
    rv = torch.as_tensor(rng.standard_normal(U.shape)).to(dtype).to(card)
    kernels.reset_launches()
    wfl, mx = kernels.face_wflux(U, g.el, g.er, g.fn, g.farea, g.fmask,
                                 g.xi_l, g.xi_r, g.bctype, g.w_face,
                                 system.eos)
    pw, pm = face_wflux_plain(system, g, U)
    assert torch.equal(wfl, pw) and torch.equal(mx, pm)
    for base in (None, rv):
        got = kernels.basis_accum(wfl, mx, g.fose, g.fsideR, g.xi_l, g.xi_r,
                                  ndof, base)
        for a, b in zip(got, basis_accum_plain(g, pw, pm, base)):
            assert torch.equal(a, b)
    for a, b in zip(fused_face_pass(system, g, U, rv),
                    basis_accum_plain(g, pw, pm, rv)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert kernels.launches == {**ZERO, "face_wflux": 2, "basis_accum": 3}


def test_p2_solver_on_card_matches_cpu(card):
    """Two float64 DG(P2) TaylorGreen steps on the card against the CPU:
    u atol 1e-11, dt rtol 1e-12, 3 launches each of K12 and K13 a step and
    no other kernel."""
    def solver(device):
        mesh, _ = hilbert_element_reorder(
            box_tet_mesh(4, 4, 3, hi=(1.0, 1.0, 0.75)))
        g = build_dggeom(mesh, 10, {i: BC_SYMMETRY for i in range(1, 7)},
                         dtype=torch.float64, device=device)
        return DGSolver(DGCompFlow(TaylorGreen()), g, cfl=0.5)

    a, b = solver(card), solver("cpu")
    kernels.reset_launches()
    sa = a.nsteps(a.initial_state(), 2)
    sb = b.nsteps(b.initial_state(), 2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(sa.u).all())
    assert float((sa.u.cpu() - sb.u).abs().max()) <= 1e-11
    assert abs(float(sa.dt) - float(sb.dt)) <= 1e-12 * float(sb.dt)
    assert kernels.launches == {**ZERO, "face_wflux": 6, "basis_accum": 6}


def _alecg(case, device, dtype=torch.float64):
    """The ALECG solvers of chip_smoke.py's card-vs-CPU checks ("slotcyl",
    "vortical"); SlotCyl with three components ("slotcyl3"); and both
    flavours on a 9x7x3 box ("*_tail": nE = 1675 is not a multiple of the
    runs of edges K8 gives a thread, so K8 takes its entry-by-entry loads
    and a ragged last run; E = 1134 leaves K7 a ragged last block)."""
    from quinoa_tpu_torch.inciter.alecg import make_alecg
    from quinoa_tpu_torch.mesh import first_touch_node_reorder
    from quinoa_tpu_torch.pde.cg import CGTransport
    from quinoa_tpu_torch.pde.cg_compflow import CGCompFlow
    from quinoa_tpu_torch.pde.problems import SlotCyl, VorticalFlow

    n = (9, 7, 3) if case.endswith("_tail") else None
    if case.startswith("slotcyl"):
        mesh = box_tet_mesh(*(n or (10, 10, 5)), hi=(1.0, 1.0, 0.5))
        ncomp = 3 if case == "slotcyl3" else 1
        system, cfl = CGTransport(SlotCyl(ncomp=ncomp)), 0.8
    else:
        mesh = box_tet_mesh(*(n or (8, 8, 8)), lo=(-0.5, -0.5, -0.5),
                            hi=(0.5, 0.5, 0.5))
        system, cfl = CGCompFlow(VorticalFlow()), 0.6
    mesh, _ = first_touch_node_reorder(hilbert_element_reorder(mesh)[0])
    return make_alecg(system, mesh, cfl=cfl, bcnodes=mesh.all_bnodes(),
                      dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["slotcyl", "vortical", "slotcyl3",
                                  "slotcyl_tail", "vortical_tail"])
def test_alecg_kernels_match_plain_versions(card, case, dtype):
    """K7, K8 and K9 of each flavour against their plain versions on a
    perturbed state: bit for bit (the same expressions in the same order,
    sums in slot-level order), also at three rows and on a mesh whose
    element and edge counts leave ragged runs."""
    from quinoa_tpu_torch.ops.alecg_fused import (alecg_edge,
                                                  alecg_edge_plain,
                                                  alecg_rhs, alecg_vol,
                                                  alecg_vol_plain,
                                                  cg_assemble,
                                                  cg_assemble_plain)

    s = _alecg(case, card, dtype)
    g, e, rows, sy = s.geom, s.edget, s.rows, s.system
    gen = torch.Generator(device=card).manual_seed(11)
    u = s.initial_state().u
    u = (u * (1.0 + 0.01 * torch.rand(u.shape, generator=gen, device=card,
                                       dtype=dtype))).contiguous()
    kernels.reset_launches()
    cv = alecg_vol(sy, g, rows, u)
    assert torch.equal(cv, alecg_vol_plain(sy, g, rows, u))
    d = alecg_edge(sy, e, rows, u)
    assert torch.equal(d, alecg_edge_plain(sy, e, rows, u))
    r = cg_assemble(cv, d, g.nsup, e.ensup)
    assert torch.equal(r, cg_assemble_plain(cv, d, g.nsup, e.ensup))
    assert torch.equal(alecg_rhs(sy, g, e, rows, u), r)
    torch.cuda.synchronize()
    sfx = "_cf" if case.startswith("vortical") else ""
    assert kernels.launches == {**ZERO, "alecg_vol" + sfx: 2,
                                "alecg_edge" + sfx: 2, "cg_assemble": 2}


@pytest.mark.parametrize("case", ["slotcyl", "vortical"])
def test_alecg_on_card_matches_cpu(card, case):
    """Two float64 ALECG steps on the card against the CPU with every
    boundary node pinned: u atol 1e-11, dt rtol 1e-12, 3 launches of each
    of the flavour's kernels a step and no other kernel."""
    a, b = _alecg(case, card), _alecg(case, "cpu")
    kernels.reset_launches()
    sa = a.nsteps(a.initial_state(), 2)
    sb = b.nsteps(b.initial_state(), 2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(sa.u).all())
    assert float((sa.u.cpu() - sb.u).abs().max()) <= 1e-11
    assert abs(float(sa.dt) - float(sb.dt)) <= 1e-12 * float(sb.dt)
    sfx = "" if case == "slotcyl" else "_cf"
    assert kernels.launches == {**ZERO, "alecg_vol" + sfx: 6,
                                "alecg_edge" + sfx: 6, "cg_assemble": 6}


def _diagcg(case, device, dtype=torch.float64):
    """The DiagCG solvers of chip_smoke.py's card-vs-CPU checks."""
    from quinoa_tpu_torch.inciter import DiagCGSolver
    from quinoa_tpu_torch.mesh import first_touch_node_reorder
    from quinoa_tpu_torch.pde.cg import CGTransport, make_cggeom
    from quinoa_tpu_torch.pde.cg_compflow import CGCompFlow
    from quinoa_tpu_torch.pde.problems import SlotCyl, VorticalFlow

    if case == "slotcyl":
        mesh = box_tet_mesh(16, 16, 4, hi=(1.0, 1.0, 0.25))
        system, cfl = CGTransport(SlotCyl()), 0.8
    else:
        mesh = box_tet_mesh(6, 6, 6, lo=(-0.5, -0.5, -0.5),
                            hi=(0.5, 0.5, 0.5))
        system, cfl = CGCompFlow(VorticalFlow()), 0.5
    mesh, _ = first_touch_node_reorder(hilbert_element_reorder(mesh)[0])
    return DiagCGSolver(system, make_cggeom(mesh, dtype=dtype,
                                            device=device),
                        cfl=cfl, bcnodes=mesh.all_bnodes())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows", [1, 2, 5, 10])
def test_node_kernels_match_plain_versions(card, rows, dtype):
    """K10 and K11 (sum-only, max-only with 4 and with 1 corner, mixed)
    against their plain versions bit for bit; a NaN slot propagates
    through K11's max rows."""
    from quinoa_tpu_torch.ops.node_window import (node_assemble,
                                                  node_assemble_plain,
                                                  node_gather,
                                                  node_gather_plain)

    g = _diagcg("slotcyl", card, dtype).geom
    gen = torch.Generator(device=card).manual_seed(13)
    U = torch.randn((rows, g.nnode), generator=gen, device=card, dtype=dtype)
    xa = torch.randn((4, rows, g.nelem), generator=gen, device=card,
                     dtype=dtype)
    xm = torch.randn((4, rows, g.nelem), generator=gen, device=card,
                     dtype=dtype)
    kernels.reset_launches()
    assert torch.equal(node_gather(U, g.inpoelT),
                       node_gather_plain(U, g.inpoelT))
    for a, m in ((xa, None), (None, xm), (None, xm[:1]), (xa, xm),
                 (xa, xm[:1])):
        assert torch.equal(node_assemble(a, m, g.nsup),
                           node_assemble_plain(a, m, g.nsup))
    xm[1, rows - 1, 7] = float("nan")
    got = node_assemble(xa, xm, g.nsup)
    want = node_assemble_plain(xa, xm, g.nsup)
    assert int(torch.isnan(got).sum()) == 1
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.cuda.synchronize()
    assert kernels.launches == {**ZERO, "node_gather": 1, "node_assemble": 6}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [1, 5])
def test_cg_assembly_path_instances_bit_for_bit(card, C, dtype):
    """K11 at the three instances of a DiagCG + FCT step ((2C), (2C + 2C,
    one max row per element), (C) rows) and K9 at C rows, at C = 1 and 5,
    bit for bit against their plain versions on meshes with pad slots; a
    NaN in one element's max row makes exactly its 4 nodes' maxima NaN."""
    from quinoa_tpu_torch.ops.alecg_fused import (cg_assemble,
                                                  cg_assemble_plain)
    from quinoa_tpu_torch.ops.node_window import (node_assemble,
                                                  node_assemble_plain)

    g = _diagcg("slotcyl", card, dtype).geom
    a = _alecg("slotcyl", card, dtype)
    gen = torch.Generator(device=card).manual_seed(17 + C)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=card, dtype=dtype)

    E = g.nelem
    assert bool((g.nsup == 4 * E).any())
    xm = randn(1, 2 * C, E)
    e0 = E // 2
    xm[0, -1, e0] = float("nan")
    kernels.reset_launches()
    for xa, m in ((randn(4, 2 * C, E), None), (randn(4, 2 * C, E), xm),
                  (randn(4, C, E), None)):
        got = node_assemble(xa, m, g.nsup)
        assert _same((got,), (node_assemble_plain(xa, m, g.nsup),))
    got = node_assemble(randn(4, 2 * C, E), xm, g.nsup)
    nan = torch.isnan(got)
    assert int(nan.sum()) == 4
    assert set(torch.nonzero(nan[-1]).flatten().tolist()) == set(
        g.inpoelT[:, e0].tolist())
    n_e = a.edget.ensup
    nE = a.edget.edges.shape[1]
    assert bool((n_e == 2 * nE).any())
    cv, d = randn(C, a.geom.nelem), randn(C, nE)
    assert _same((cg_assemble(cv, d, a.geom.nsup, n_e),),
                 (cg_assemble_plain(cv, d, a.geom.nsup, n_e),))
    torch.cuda.synchronize()
    assert kernels.launches == {**ZERO, "node_assemble": 4,
                                "cg_assemble": 1}


@pytest.mark.parametrize("case", ["slotcyl", "vortical"])
def test_diagcg_on_card_matches_cpu(card, case):
    """Two float64 DiagCG + FCT steps on the card against the CPU with
    every boundary node pinned: u atol 1e-11, dt rtol 1e-12, 3 K10 and 3
    K11 launches a step and no other kernel."""
    a, b = _diagcg(case, card), _diagcg(case, "cpu")
    kernels.reset_launches()
    sa = a.nsteps(a.initial_state(), 2)
    sb = b.nsteps(b.initial_state(), 2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(sa.u).all())
    assert float((sa.u.cpu() - sb.u).abs().max()) <= 1e-11
    assert abs(float(sa.dt) - float(sb.dt)) <= 1e-12 * float(sb.dt)
    assert kernels.launches == {**ZERO, "node_gather": 6, "node_assemble": 6}


def _mm(case, device, dtype=torch.float64):
    """The multimat solvers of chip_smoke.py's paths at a small size:
    (solver, its kernels)."""
    from quinoa_tpu_torch.pde.dg import BC_EXTRAPOLATE
    from quinoa_tpu_torch.pde.multimat import MultiMatSolver, MultiMatSystem
    from quinoa_tpu_torch.pde.problems import (MMInterfaceAdvection,
                                               MMSodShocktube)

    if case == "mm_iface":
        mesh = box_tet_mesh(6, 6, 2, hi=(1.0, 1.0, 0.3))
        bc = {i: BC_DIRICHLET for i in range(1, 7)}
        system, ndof, kw = MultiMatSystem(MMInterfaceAdvection()), 1, {
            "cfl": 0.4}
        used = ("face_gather", "face_accum")
    else:
        mesh = box_tet_mesh(8, 3, 2, hi=(1.0, 0.375, 0.25))
        bc = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
              **{i: BC_SYMMETRY for i in range(3, 7)}}
        ndof = 4 if case == "mm_p1" else 1
        system = MultiMatSystem(MMSodShocktube())
        kw = {"cfl": 0.5, "limiter": "superbeep1" if ndof == 4 else None}
        used = ("mm_face_wflux", "basis_accum") + (
            ("mm_limit", "mm_volume_nc") if ndof == 4 else ())
    mesh, _ = hilbert_element_reorder(mesh)
    g = build_dggeom(mesh, ndof, bc, dtype=dtype, device=device)
    return MultiMatSolver(system, g, **kw), used


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["mm_p0", "mm_p1", "mm_iface_nmat3",
                                  "mm_iface_nmat3_p1", "mm_sod_p1_pad",
                                  "mm_sod_p1_nan"])
def test_mm_face_kernel_matches_plain_version(card, case, dtype):
    """K14 (nmat 2 and 3, P0 and P1) and K13 at its R rows (16, 22)
    against their plain versions bit for bit, on the limited initial state
    of the solver, alone and as mm_face_pass.  The nmat 3 box and the
    7x3x2 Sod box leave both kernels a ragged last block; on the Sod box
    every 7th face is a pad face (fmask 0: the unit state), or one
    element has no density and no momentum, so that the sound speed at
    its faces is NaN and must reach the flux and the sums as in the plain
    version."""
    import dataclasses

    from quinoa_tpu_torch.ops.face_fused import (mm_face_pass,
                                                 mm_face_wflux_plain)
    from quinoa_tpu_torch.pde.dg import BC_EXTRAPOLATE, build_dggeom as bd
    from quinoa_tpu_torch.pde.multimat import MultiMatSolver, MultiMatSystem
    from quinoa_tpu_torch.pde.problems import (MMInterfaceAdvection,
                                               MMSodShocktube)

    if case.startswith("mm_iface_nmat3"):
        # extrapolate faces: the face kernel's ghost
        ndof = 4 if case.endswith("p1") else 1
        g = bd(box_tet_mesh(6, 6, 2, hi=(1.0, 1.0, 0.3)), ndof,
               {i: BC_EXTRAPOLATE for i in range(1, 7)}, dtype=dtype,
               device=card)
        assert _ragged(g.nelem) and _ragged(g.nface)
        solver = MultiMatSolver(MultiMatSystem(MMInterfaceAdvection()), g,
                                limiter="superbeep1" if ndof == 4 else None)
    elif case.startswith("mm_sod"):
        mesh, _ = hilbert_element_reorder(
            box_tet_mesh(7, 3, 2, hi=(1.0, 3 / 7, 2 / 7)))
        g = bd(mesh, 4, {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
                         **{i: BC_SYMMETRY for i in range(3, 7)}},
               dtype=dtype, device=card)
        assert _ragged(g.nelem) and _ragged(g.nface)
        solver = MultiMatSolver(MultiMatSystem(MMSodShocktube()), g,
                                limiter="superbeep1")
    else:
        solver, _ = _mm(case, card, dtype)
    sy, g = solver.system, solver.geom
    U = solver._limit(solver.initial_state().u)
    if case == "mm_sod_p1_pad":
        pad = torch.zeros(g.nface, dtype=torch.bool, device=card)
        pad[::7] = True
        g = dataclasses.replace(g, fmask=torch.where(pad, 0.0, g.fmask))
    elif case == "mm_sod_p1_nan":
        Uv = U.reshape(sy.ncomp, 4, -1)
        Uv[sy.nmat:2 * sy.nmat + 3, :, g.nelem // 2] = 0.0
    kernels.reset_launches()
    wfl, mx = kernels.mm_face_wflux(U, g.el, g.er, g.fn, g.farea, g.fmask,
                                    g.xi_l, g.xi_r, g.bctype, g.w_face,
                                    sy.eos)
    pw, pm = mm_face_wflux_plain(sy, g, U)
    assert wfl.shape == (sy.nrows * {1: 1, 4: 3}[g.ndof], g.nface)
    assert _same((wfl, mx), (pw, pm))
    assert bool(pw.isnan().any()) == (case == "mm_sod_p1_nan")
    if case == "mm_sod_p1_pad":
        assert bool((pw[:, pad] == 0).all()) and bool((pm[pad] == 0).all())
    got = kernels.basis_accum(wfl, mx, g.fose, g.fsideR, g.xi_l, g.xi_r,
                              g.ndof)
    assert _same(got, basis_accum_plain(g, pw, pm))
    assert _same(mm_face_pass(sy, g, U), got)
    torch.cuda.synchronize()
    assert kernels.launches == {**ZERO, "mm_face_wflux": 2,
                                "basis_accum": 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nmat", [2, 3])
def test_mm_limit_matches_plain_version(card, nmat, dtype):
    """K15 against mm_consistent_limit_plain on the same card tensors bit
    for bit (NaN by position), on a box whose element count leaves a
    ragged last block, with boundary elements (esuelT = -1).  The state
    has face points with uNeg on both sides of +-1e-14, an element with
    zero slopes, one whose fraction phi cuts its density and energy phi in
    the consistent step, and a NaN density mean that reaches its
    neighbours through the bounds.  One launch; u is left as it was."""
    from quinoa_tpu_torch.pde.dg import BC_EXTRAPOLATE
    from quinoa_tpu_torch.pde.limiter import superbee_phi
    from quinoa_tpu_torch.pde.multimat import (MultiMatSolver,
                                               MultiMatSystem,
                                               mm_consistent_limit,
                                               mm_consistent_limit_plain)
    from quinoa_tpu_torch.pde.problems import (MMInterfaceAdvection,
                                               MMSodShocktube)

    mesh, _ = hilbert_element_reorder(
        box_tet_mesh(7, 3, 2, hi=(1.0, 3 / 7, 2 / 7)))
    g = build_dggeom(mesh, 4, {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
                               **{i: BC_SYMMETRY for i in range(3, 7)}},
                     dtype=dtype, device=card)
    E = g.nelem
    assert _ragged(E) and bool((g.esuelT < 0).any())
    sy = MultiMatSystem(MMSodShocktube() if nmat == 2
                        else MMInterfaceAdvection(nmat=3))
    C = sy.ncomp
    assert sy.nmat == nmat and C == 3 * nmat + 3
    u0 = MultiMatSolver(sy, g).initial_state().u.cpu().double().numpy()
    rng = np.random.default_rng(31 + nmat)
    Uv = u0.reshape(C, 4, E).copy()
    Uv[:, 1:4] = (0.2 * np.abs(Uv[:, :1]) + 1e-3) * rng.uniform(
        -1.0, 1.0, (C, 3, E))
    tiny = np.arange(E // 5, E // 5 + 8)
    Uv[:, 0, tiny] = 0.0
    Uv[:, 1:4, tiny] = rng.uniform(-4e-14, 4e-14, (C, 3, tiny.size))
    flat, cut, bad = E // 3, E // 2, 2 * E // 3
    Uv[:, 1:4, flat] = 0.0
    Uv[:nmat, 1:4, cut] = 10.0
    Uv[nmat:2 * nmat, 1:4, cut] = 0.0
    Uv[2 * nmat + 3:, 1:4, cut] = 0.0
    Uv[nmat, 0, bad] = np.nan
    u = torch.as_tensor(Uv.reshape(C * 4, E)).to(dtype).to(card)
    before = u.clone()

    B = torch.as_tensor(g.tables["B_selfface"].reshape(-1, 4)).to(u)
    uv = u.view(C, 4, E)
    uneg = (torch.einsum("pk,cke->cpe", B, uv) - uv[:, None, 0]).abs()
    assert bool(((uneg > 0) & (uneg < 1e-14)).any())
    assert bool(((uneg > 1e-14) & (uneg < 4e-14)).any())
    phi = superbee_phi(g, u, None, C)
    assert float(phi[:nmat, cut].min()) < min(
        float(phi[nmat:2 * nmat, cut].min()), float(phi[2 * nmat + 3:,
                                                        cut].min()))

    kernels.reset_launches()
    got = mm_consistent_limit(sy, g, u)
    torch.cuda.synchronize()
    assert kernels.launches == {**ZERO, "mm_limit": 1}
    want = mm_consistent_limit_plain(sy, g, u)
    assert _same((got,), (want,))
    assert _same((u,), (before,))
    slopes_nan = got.view(C, 4, E)[:, 1:].isnan().any(dim=1).any(dim=0)
    assert bool(slopes_nan[bad + 1:].any() | slopes_nan[:bad].any())
    assert not bool(slopes_nan.all())
    assert bool((got.view(C, 4, E)[:, 1:, flat] == 0).all())


def _jittered_box(n, hi, seed):
    """box_tet_mesh(*n, hi=hi) with every interior node moved by up to a
    tenth of an edge along each axis, in Hilbert order."""
    mesh = box_tet_mesh(*n, hi=hi)
    x = mesh.coords
    inner = ((x > 1e-9) & (x < np.asarray(hi) - 1e-9)).all(axis=1)
    h = np.asarray(hi) / np.asarray(n)
    x[inner] += np.random.default_rng(seed).uniform(
        -0.1, 0.1, (int(inner.sum()), 3)) * h
    return hilbert_element_reorder(mesh)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["sod", "thinc"])
def test_mm_volume_matches_plain_version(card, case, dtype):
    """K16 against mm_volume_plain on the same card tensors bit for bit
    (NaN by position), both flavours, on jittered boxes whose element
    counts leave a ragged last block: Sod (nmat 2) and the THINC
    interface advection (nmat 3), each after 3 steps of its card solver,
    limited, with the stage's face rows (mm_face_pass, THINC's with its
    carriers).  In the THINC state a few elements' material 0 is a trace
    below the floors of alpha and of the material density; in the Sod
    state one element has no density, so its velocity and rows are NaN.
    One launch a flavour, the inputs left as they were; one step of
    either solver launches mm_volume_nc once a stage."""
    from quinoa_tpu_torch.ops.face_fused import mm_face_pass
    from quinoa_tpu_torch.pde.dg import BC_EXTRAPOLATE
    from quinoa_tpu_torch.pde.multimat import (MultiMatSolver,
                                               MultiMatSystem, mm_volume,
                                               mm_volume_plain)
    from quinoa_tpu_torch.pde.problems import (MMInterfaceAdvection,
                                               MMSodShocktube)

    if case == "sod":
        mesh = _jittered_box((7, 3, 2), (1.0, 3 / 7, 2 / 7), 41)
        bc = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
              **{i: BC_SYMMETRY for i in range(3, 7)}}
        system, cfl = MultiMatSystem(MMSodShocktube()), 0.5
    else:
        mesh = _jittered_box((6, 6, 2), (1.0, 1.0, 0.3), 43)
        bc = {i: BC_EXTRAPOLATE for i in range(1, 7)}
        system = MultiMatSystem(MMInterfaceAdvection(nmat=3), intsharp=True)
        cfl = 0.4
    g = build_dggeom(mesh, 4, bc, dtype=dtype, device=card)
    solver = MultiMatSolver(system, g, cfl=cfl, limiter="superbeep1")
    sy, E = solver.system, g.nelem
    C, nmat = sy.ncomp, sy.nmat
    assert _ragged(E) and E % 128 != 0
    st = solver.nsteps(solver.initial_state(), 3)
    u = solver._limit(st.u).reshape(C, 4, E)
    floor = 50.0 * torch.finfo(dtype).eps
    if case == "sod":
        u[nmat:2 * nmat + 3, :, E // 2] = 0.0
    else:
        few = torch.arange(E // 4, E // 4 + 5, device=card)
        u[0, 0, few], u[0, 1:, few] = 1e-20, 0.0
        u[nmat, 0, few], u[nmat, 1:, few] = 1e-30, 0.0
        s = torch.einsum("gk,cke->cge", g.ktab[kernels.TAB_BVOL:
                                               kernels.TAB_WDB].view(5, 4), u)
        a = s[:nmat].clamp_min(floor)
        assert bool((s[:nmat] < floor).any())
        assert bool((s[nmat:2 * nmat] / a < floor).any())
    u = u.reshape(C * 4, E).contiguous()
    X = (sy.thinc_carriers(g, u.view(C, 4, E)) if sy.intsharp else None)
    acc, _ = mm_face_pass(sy, g, u, X)
    ins = [t.clone() for t in (u, acc)]
    kernels.reset_launches()
    for a, name in ((None, "mm_volume"), (acc, "mm_volume_nc")):
        got = mm_volume(sy, g, u, a)
        torch.cuda.synchronize()
        assert kernels.launches == {**ZERO, name: 1}
        kernels.reset_launches()
        want = mm_volume_plain(sy, g, u, a)
        assert _same((got,), (want,))
        assert bool(want.isnan().any()) == (case == "sod")
        assert bool(want.isfinite().any())
    assert _same((u, acc), ins)
    solver.nsteps(st, 1)
    torch.cuda.synchronize()
    face = "mm_face_wflux_thinc" if sy.intsharp else "mm_face_wflux"
    assert kernels.launches == {**ZERO, "mm_limit": 3, face: 3,
                                "basis_accum": 3, "mm_volume_nc": 3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mm_face_gp_kernels_match_plain_versions(card, dtype):
    """K4 at multimat P1's 9 components, K5 at the interface advection's
    12 rows and K6 on its 22 Dirichlet face rows against their plain
    versions bit for bit, on the solvers' (limited) initial states."""
    p1, _ = _mm("mm_p1", card, dtype)
    iface, _ = _mm("mm_iface", card, dtype)
    U = p1._limit(p1.initial_state().u)
    C, g = p1.system.ncomp, p1.geom
    Uf, gf = iface.initial_state().u, iface.geom
    kernels.reset_launches()
    for got, want in zip(neighbor_mean_bounds(g, U, C),
                         neighbor_mean_bounds_plain(g, U[::4])):
        assert torch.equal(got, want)
    for idx in (gf.el, gf.er):
        assert torch.equal(face_gather(Uf, idx), face_gather_plain(Uf, idx))
    XL, XR = iface.system.dirichlet_face_rows(gf, Uf, 0.0)
    assert XL.shape == (iface.system.nrows, gf.nface) == (22, gf.nface)
    assert torch.equal(accumulate_faces(gf, XL, XR),
                       accumulate_faces_plain(gf, XL, XR))
    torch.cuda.synchronize()
    # dirichlet_face_rows gathers el and er through K5 itself
    assert kernels.launches == {**ZERO, "nbr_bounds": 1, "face_gather": 4,
                                "face_accum": 1}


@pytest.mark.parametrize("case", ["p0", "mm_p0", "mm_p1", "mm_iface"])
def test_p0_and_multimat_on_card_match_cpu(card, case):
    """Two float64 steps on the card against the CPU: Euler DG(P0) Sod
    (K12 + K13 at (1, 1)) and the three multimat paths; u atol 1e-11 of
    max(1, max|u|), dt rtol 1e-12, only the path's kernels launched."""
    from quinoa_tpu_torch.pde.dg import BC_EXTRAPOLATE
    from quinoa_tpu_torch.pde.problems import SodShocktube

    def solver(device):
        if case != "p0":
            return _mm(case, device)
        mesh = box_tet_mesh(8, 3, 2, hi=(1.0, 0.375, 0.25))
        bc = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
              **{i: BC_SYMMETRY for i in range(3, 7)}}
        g = build_dggeom(mesh, 1, bc, dtype=torch.float64, device=device)
        return (DGSolver(DGCompFlow(SodShocktube()), g, cfl=0.5),
                ("face_wflux", "basis_accum"))

    (a, used), (b, _) = solver(card), solver("cpu")
    kernels.reset_launches()
    sa = a.nsteps(a.initial_state(), 2)
    sb = b.nsteps(b.initial_state(), 2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(sa.u).all())
    scale = max(1.0, float(sb.u.abs().max()))
    assert float((sa.u.cpu() - sb.u).abs().max()) <= 1e-11 * scale
    assert abs(float(sa.dt) - float(sb.dt)) <= 1e-12 * float(sb.dt)
    assert {k for k, v in kernels.launches.items() if v} == set(used)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ndof", [1, 4, 10])
def test_lf_single_stream_kernels_match_plain_versions(card, ndof, dtype):
    """The Lax-Friedrichs flavour of K12 (and K13 after it) at P0, P1 and
    P2 against the plain versions bit for bit; its launches count under
    face_wflux_lf only."""
    system = DGCompFlow(SedovBlastwave(), riemann_flux="laxfriedrichs")
    g = _geom(card, dtype, ndof)
    rng = np.random.default_rng(11)
    U = rng.random((5 * ndof, g.nelem)) * 0.01
    U[0] += 1.0
    U[4 * ndof] += 2.5
    U = torch.as_tensor(U).to(dtype).to(card)
    kernels.reset_launches()
    wfl, mx = kernels.face_wflux(U, g.el, g.er, g.fn, g.farea, g.fmask,
                                 g.xi_l, g.xi_r, g.bctype, g.w_face,
                                 system.eos, "laxfriedrichs")
    pw, pm = face_wflux_plain(system, g, U)
    assert bool(torch.isfinite(pw).all())
    assert torch.equal(wfl, pw) and torch.equal(mx, pm)
    for a, b in zip(fused_face_pass(system, g, U),
                    basis_accum_plain(g, pw, pm)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert kernels.launches == {**ZERO, "face_wflux_lf": 2, "basis_accum": 1}


def _thinc(device, dtype, nmat=3):
    """THINC interface advection at P1 on a small extrapolate box."""
    from quinoa_tpu_torch.pde.dg import BC_EXTRAPOLATE
    from quinoa_tpu_torch.pde.multimat import MultiMatSolver, MultiMatSystem
    from quinoa_tpu_torch.pde.problems import MMInterfaceAdvection

    mesh, _ = hilbert_element_reorder(box_tet_mesh(6, 6, 2,
                                                   hi=(1.0, 1.0, 0.3)))
    g = build_dggeom(mesh, 4, {i: BC_EXTRAPOLATE for i in range(1, 7)},
                     dtype=dtype, device=device)
    system = MultiMatSystem(MMInterfaceAdvection(nmat=nmat), intsharp=True)
    return MultiMatSolver(system, g, cfl=0.4, limiter="superbeep1")


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nmat", [2, 3])
def test_thinc_face_kernel_matches_plain_version(card, nmat, dtype, pad):
    """The THINC flavour of K14 and K13 at its R rows against their plain
    versions bit for bit on the limited initial interface-advection state,
    with flagged face points, on a box that leaves both kernels a ragged
    last block; with pad, every 7th face is a pad face (the unit state and
    all-ones carriers).  Its launches count under mm_face_wflux_thinc
    only."""
    import dataclasses

    from quinoa_tpu_torch.ops.face_fused import (mm_face_pass,
                                                 mm_face_wflux_plain)

    solver = _thinc(card, dtype, nmat)
    sy, g = solver.system, solver.geom
    assert _ragged(g.nelem) and _ragged(g.nface)
    U = solver._limit(solver.initial_state().u)
    X = sy.thinc_carriers(g, U.reshape(sy.ncomp, 4, -1))
    assert int((X[5::8] > 0.5).sum()) > 0
    if pad:
        g = dataclasses.replace(g, fmask=torch.where(
            torch.arange(g.nface, device=card) % 7 == 0, 0.0, g.fmask))
    kernels.reset_launches()
    wfl, mx = kernels.mm_face_wflux(U, g.el, g.er, g.fn, g.farea, g.fmask,
                                    g.xi_l, g.xi_r, g.bctype, g.w_face,
                                    sy.eos, X, sy.thinc_beta)
    pw, pm = mm_face_wflux_plain(sy, g, U, X)
    assert bool(torch.isfinite(pw).all())
    assert torch.equal(wfl, pw) and torch.equal(mx, pm)
    for a, b in zip(mm_face_pass(sy, g, U, X), basis_accum_plain(g, pw, pm)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert kernels.launches == {**ZERO, "mm_face_wflux_thinc": 2,
                                "basis_accum": 1}


@pytest.mark.parametrize("case", ["p1_lf", "p1_lf_pdg", "mm_thinc"])
def test_lf_and_thinc_on_card_match_cpu(card, case):
    """Two float64 steps on the card against the CPU: Sod DG(P1) with
    Lax-Friedrichs and Superbee (with and without p-adaptivity: K12-LF,
    never K2) and THINC interface advection; u atol 1e-11 of max(1,
    max|u|), dt rtol 1e-12, only the path's kernels launched."""
    from quinoa_tpu_torch.pde.dg import BC_EXTRAPOLATE
    from quinoa_tpu_torch.pde.problems import SodShocktube

    def solver(device):
        if case == "mm_thinc":
            return _thinc(device, torch.float64)
        mesh = box_tet_mesh(8, 3, 2, hi=(1.0, 0.375, 0.25))
        bc = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
              **{i: BC_SYMMETRY for i in range(3, 7)}}
        g = build_dggeom(mesh, 4, bc, dtype=torch.float64, device=device)
        return DGSolver(DGCompFlow(SodShocktube(),
                                   riemann_flux="laxfriedrichs"), g,
                        cfl=0.5, limiter="superbeep1",
                        pref=case == "p1_lf_pdg")

    used = {"p1_lf": {"limit_vol", "face_wflux_lf", "basis_accum"},
            "p1_lf_pdg": {"limit_vol_pref", "face_wflux_lf",
                          "basis_accum"},
            "mm_thinc": {"mm_limit", "mm_face_wflux_thinc",
                         "basis_accum", "mm_volume_nc"}}[case]
    a, b = solver(card), solver("cpu")
    kernels.reset_launches()
    sa = a.nsteps(a.initial_state(), 2)
    sb = b.nsteps(b.initial_state(), 2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(sa.u).all())
    scale = max(1.0, float(sb.u.abs().max()))
    assert float((sa.u.cpu() - sb.u).abs().max()) <= 1e-11 * scale
    assert abs(float(sa.dt) - float(sb.dt)) <= 1e-12 * float(sb.dt)
    assert {k for k, v in kernels.launches.items() if v} == used


@pytest.mark.parametrize("nshard", [2, 4])
def test_sharded_dg_on_card_matches_cpu(card, nshard):
    """Sedov P1 on nshard shards resident on the card against the same
    sharded run on the CPU, float64, 2 steps: u atol 1e-11 of max(1,
    max|u|), dt rtol 1e-12, and K1, K12 and K13 launched 3 * nshard
    times a step."""
    from quinoa_tpu_torch.parallel import (SPMDDGSolver, ShardGroup,
                                           build_dg_shards)

    mesh, _ = hilbert_element_reorder(box_tet_mesh(6, 6, 4,
                                                   hi=(0.6, 0.6, 0.4)))
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
    out = {}
    for dev in (card, torch.device("cpu")):
        sh = build_dg_shards(mesh, nshard, 4, bc, dtype=torch.float64,
                             group=ShardGroup(nshard, [dev]))
        s = SPMDDGSolver(DGCompFlow(SedovBlastwave()), sh, cfl=0.5,
                         limiter="superbeep1")
        kernels.reset_launches()
        st = s.nsteps(s.initial_state(), 2)
        out[dev.type] = (s.gather_global(st), float(st.dt[0]),
                         dict(kernels.launches))
    (a, dta, la), (b, dtb, _) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-11 * max(1.0, np.abs(b).max()))
    assert np.isclose(dta, dtb, rtol=1e-12)
    assert la == {**ZERO, "limit_vol": 6 * nshard, "face_wflux": 6 * nshard,
                  "basis_accum": 6 * nshard}


def test_sharded_multimat_on_card_matches_cpu(card):
    """Multimat Sod P1 with consistent Superbee on 2 shards resident on the
    card against the same sharded run on the CPU, float64, 2 steps: u
    atol 1e-11 of max(1, max|u|), dt rtol 1e-12, and every shard's
    limiter through K15 and volume pass through K16 (3 launches each a
    shard a step, no K4)."""
    from quinoa_tpu_torch.parallel import (SPMDMultiMatSolver, ShardGroup,
                                           build_dg_shards)
    from quinoa_tpu_torch.pde.dg import BC_EXTRAPOLATE
    from quinoa_tpu_torch.pde.multimat import MultiMatSystem
    from quinoa_tpu_torch.pde.problems import MMSodShocktube

    mesh = box_tet_mesh(8, 3, 2, hi=(1.0, 0.375, 0.25))
    bc = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
          **{i: BC_SYMMETRY for i in range(3, 7)}}
    out = {}
    for dev in (card, torch.device("cpu")):
        sh = build_dg_shards(mesh, 2, 4, bc, dtype=torch.float64,
                             group=ShardGroup(2, [dev]))
        s = SPMDMultiMatSolver(MultiMatSystem(MMSodShocktube()), sh,
                               cfl=0.5, limiter="superbeep1")
        kernels.reset_launches()
        st = s.nsteps(s.initial_state(), 2)
        out[dev.type] = (s.gather_global(st), float(st.dt[0]),
                         dict(kernels.launches))
    (a, dta, la), (b, dtb, _) = out["cuda"], out["cpu"]
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-11 * max(1.0, np.abs(b).max()))
    assert np.isclose(dta, dtb, rtol=1e-12)
    assert la["mm_limit"] == la["mm_volume_nc"] == 12
    assert la["nbr_bounds"] == 0
