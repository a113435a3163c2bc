"""The problems the port gained, and the solver routes they open, against
quinoa_tpu's.

- RotatedSodShocktube, NLEnergyGrowth, RayleighTaylor, UserDefined,
  CylAdvect and ShearDiff: solution (and the transport velocity) at
  seeded points at two times, and the manufactured source (jax.jvp
  against torch.func.jvp): rtol 1e-12 (atol 1e-12 of the largest entry);
- dg_cell_avg;
- CGTransport with diffusion (ShearDiff): the element rhs contributions
  (1e-12 of their largest entry) and the dt (rtol 1e-12) at the default
  diffusivities and at 100 times them, where the diffusive limit
  L^2 / (2 D_max) binds;
- DGSolver with a source at P1, two steps: NLEnergyGrowth on symmetry
  walls with Superbee (the limit + volume kernel's route, the source
  integral added in torch) and RayleighTaylor on Dirichlet faces with
  Superbee (the face Gauss-point route); and DG(P2) on the face
  Gauss-point path: GaussHump transport and TaylorGreen on Dirichlet
  faces.  u atol 1e-11 of max(1, max|u|), dt rtol 1e-12;
- DiagCG and ALECG, two steps each, every boundary node pinned, with
  CylAdvect, ShearDiff (from t0 = 1; DiagCG with diffusion, ALECG without
  it, as the JAX package's ALECG reads no diffusivity), NLEnergyGrowth,
  RayleighTaylor and RotatedSodShocktube (time-dependent sources and
  Dirichlet values at each stage's time): u atol 1e-11 of max(1, max|u|),
  dt rtol 1e-12.

Float64 on the CPU, inputs made with numpy from a seed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quinoa_tpu.inciter import DiagCGSolver as JDiagCG
from quinoa_tpu.inciter.alecg import make_alecg as j_make_alecg
from quinoa_tpu.inciter.dg import DGSolver as JSolver
from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.mesh.reorder import hilbert_element_reorder
from quinoa_tpu.pde import problems as jp
from quinoa_tpu.pde.cg import CGTransport as JCGTransport
from quinoa_tpu.pde.cg import make_cggeom as j_make_cggeom
from quinoa_tpu.pde.cg_compflow import CGCompFlow as JCGCompFlow
from quinoa_tpu.pde.dg import (BC_DIRICHLET, BC_SYMMETRY, build_dggeom,
                               dg_cell_avg as j_dg_cell_avg)
from quinoa_tpu.pde.dg_compflow import DGCompFlow as JCompFlow
from quinoa_tpu.pde.dg_compflow import DGTransport as JTransport

from quinoa_tpu_torch import convert
from quinoa_tpu_torch.inciter import DiagCGSolver, make_alecg
from quinoa_tpu_torch.inciter.dg import DGSolver
from quinoa_tpu_torch.pde import problems as tp
from quinoa_tpu_torch.pde.cg import CGTransport, cg_gather, make_cggeom
from quinoa_tpu_torch.pde.cg_compflow import CGCompFlow
from quinoa_tpu_torch.pde.dg import dg_cell_avg
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow, DGTransport

REL = 1e-12
U_ATOL = 1e-11
DT_RTOL = 1e-12
SYM = {i: BC_SYMMETRY for i in range(1, 7)}
DIRICHLET = {i: BC_DIRICHLET for i in range(1, 7)}
COMPFLOW = ("RotatedSodShocktube", "NLEnergyGrowth", "RayleighTaylor",
            "UserDefined")
TRANSPORT = ("CylAdvect", "ShearDiff")


def _arrays(jg):
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg) if f.name != "tables"}
    arrays["tables"] = dict(jg.tables)
    return arrays


def _close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("name", COMPFLOW + TRANSPORT)
def test_problem_matches_jax(name):
    """solution, velocity (transport) and src (compflow) at seeded points
    in [-0.5, 1]^3 at two times (ShearDiff from t = 0.5, it needs t > 0);
    the manufactured sources are not zero."""
    xyz = -0.5 + 1.5 * np.random.default_rng(7).random((3, 300))
    J, T = getattr(jp, name)(), getattr(tp, name)()
    X = torch.as_tensor(xyz)
    for t in ((0.5, 1.25) if name == "ShearDiff" else (0.0, 0.37)):
        _close(T.solution(X, t), J.solution(jnp.asarray(xyz), t))
        if name in TRANSPORT:
            _close(T.velocity(X, t), J.velocity(jnp.asarray(xyz), t))
            continue
        want = np.asarray(J.src(jnp.asarray(xyz), t))
        got = T.src(X, t)
        _close(got, want)
        if name in ("NLEnergyGrowth", "RayleighTaylor"):
            assert np.abs(want).max() > 1e-3
            assert not T.steady
    if name in TRANSPORT:
        assert tuple(T.diffusivity) == tuple(J.diffusivity)


def test_dg_cell_avg_matches_jax():
    U = np.random.default_rng(8).random((5 * 4, 30))
    got = dg_cell_avg(torch.as_tensor(U), 5, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_dg_cell_avg(U, 5, 4)))


def test_diffusion_rhs_and_dt_match_jax():
    """ShearDiff's diffusion term in the DiagCG element rhs, and the dt
    with its diffusive limit, against the JAX package's CGTransport."""
    mesh = box_tet_mesh(6, 4, 4, lo=(0.0, -0.25, -0.25),
                        hi=(1.0, 0.25, 0.25))
    jg, tg = j_make_cggeom(mesh), make_cggeom(mesh, device="cpu")
    jsys, tsys = JCGTransport(jp.ShearDiff()), CGTransport(tp.ShearDiff())
    u = np.asarray(jsys.initialize(jg.coords, 1.0))
    U = torch.as_tensor(u)
    un = cg_gather(tg, U)
    got = tsys.rhs_contrib(1.0, 2e-3, tg, U, un)
    want = jsys.rhs_contrib(1.0, 2e-3, jg, jnp.asarray(u),
                            jnp.asarray(un.numpy()))
    _close(got, want)
    adv = CGTransport(tp.CylAdvect()).rhs_contrib(1.0, 2e-3, tg, U, un)
    assert float((got - adv).abs().max()) > 1e-6
    # at the default diffusivities the advective limit binds; at 100 times
    # them the diffusive one, L^2 / (2 D_max)
    L = float(tg.elem_length.min())
    for scale in (1.0, 100.0):
        d = tuple(scale * x for x in jp.ShearDiff().diffusivity)
        js_, ts_ = (JCGTransport(jp.ShearDiff(diffusivity=d)),
                    CGTransport(tp.ShearDiff(diffusivity=d)))
        dt_t = float(ts_.dt(tg, U))
        assert np.isclose(dt_t, float(js_.dt(jg, jnp.asarray(u))),
                          rtol=DT_RTOL)
        diffusive = np.isclose(dt_t, L * L / (2.0 * max(d)), rtol=1e-12)
        assert diffusive == (scale > 1.0)


#: DG cases: (problem, transport, ndof, faces, mesh cells, box hi, solver
#: keywords)
DG_CASES = {
    "nleg_p1_walls": ("NLEnergyGrowth", False, 4, SYM, (6, 6, 4),
                      (0.6, 0.6, 0.4), dict(limiter="superbeep1", cfl=0.5)),
    "rt_p1_dirichlet": ("RayleighTaylor", False, 4, DIRICHLET, (4, 4, 3),
                        (0.4, 0.4, 0.3), dict(limiter="superbeep1",
                                              cfl=0.5)),
    "gausshump_p2": ("GaussHump", True, 10, DIRICHLET, (4, 4, 2),
                     (1.0, 1.0, 0.5), dict(cfl=0.5)),
    "taylorgreen_p2_dirichlet": ("TaylorGreen", False, 10, DIRICHLET,
                                 (3, 3, 2), (1.0, 1.0, 0.67),
                                 dict(cfl=0.5)),
}


@pytest.mark.parametrize("case", list(DG_CASES))
def test_dg_route_matches_jax(case):
    problem, transport, ndof, bc, n, hi, kw = DG_CASES[case]
    mesh, _ = hilbert_element_reorder(box_tet_mesh(*n, hi=hi))
    jg = build_dggeom(mesh, ndof=ndof, bc_sidesets=bc)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    J, T = (JTransport, DGTransport) if transport else (JCompFlow,
                                                         DGCompFlow)
    js = JSolver(J(getattr(jp, problem)()), jg, **kw)
    ts = DGSolver(T(getattr(tp, problem)()), tg, **kw)
    assert (ts.route.face == "face_gp") == (bc is DIRICHLET)
    a, b = js.initial_state(), ts.initial_state()
    for n_ in (1, 2):
        a, b = js.step(a), ts.step(b)
        scale = max(1.0, float(np.abs(np.asarray(a.u)).max()))
        np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                                   atol=U_ATOL * scale)
        assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
        assert np.isclose(float(b.t), float(a.t), rtol=DT_RTOL)
    assert bool(torch.isfinite(b.u).all())


#: CG cases: (problem, transport, mesh keywords, cfl, t0)
CG_CASES = {
    "cyladvect": ("CylAdvect", True, dict(nx=12, ny=12, nz=3,
                                          hi=(1.0, 1.0, 0.25)), 0.8, 0.0),
    "sheardiff": ("ShearDiff", True, dict(nx=8, ny=4, nz=4,
                                          lo=(0.0, -0.25, -0.25),
                                          hi=(1.0, 0.25, 0.25)), 0.5, 1.0),
    "nlenergygrowth": ("NLEnergyGrowth", False,
                       dict(nx=5, ny=5, nz=5, lo=(-0.5, -0.5, -0.5),
                            hi=(0.5, 0.5, 0.5)), 0.4, 0.0),
    "rayleightaylor": ("RayleighTaylor", False,
                       dict(nx=5, ny=5, nz=5, lo=(-0.5, -0.5, -0.5),
                            hi=(0.5, 0.5, 0.5)), 0.5, 0.0),
    "rotatedsod": ("RotatedSodShocktube", False, dict(nx=6, ny=6, nz=6),
                   0.4, 0.0),
}


@pytest.mark.parametrize("solver", ["diagcg", "alecg"])
@pytest.mark.parametrize("case", list(CG_CASES))
def test_cg_solver_matches_jax(case, solver):
    problem, transport, mk, cfl, t0 = CG_CASES[case]
    mesh = box_tet_mesh(**mk)
    J, T = ((JCGTransport, CGTransport) if transport
            else (JCGCompFlow, CGCompFlow))
    jsys, tsys = J(getattr(jp, problem)()), T(getattr(tp, problem)())
    bc = mesh.all_bnodes()
    if solver == "diagcg":
        js = JDiagCG(jsys, j_make_cggeom(mesh), cfl=cfl, bcnodes=bc)
        ts = DiagCGSolver(tsys, make_cggeom(mesh, device="cpu"), cfl=cfl,
                          bcnodes=bc)
    else:
        js = j_make_alecg(jsys, mesh, cfl=cfl, bcnodes=bc)
        ts = make_alecg(tsys, mesh, cfl=cfl, bcnodes=bc, device="cpu")
    a, b = js.initial_state(t0), ts.initial_state(t0)
    for _ in range(2):
        a, b = js.step(a), ts.step(b)
        scale = max(1.0, float(np.abs(np.asarray(a.u)).max()))
        np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                                   atol=U_ATOL * scale)
        assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
        assert np.isclose(float(b.t), float(a.t), rtol=DT_RTOL)
    assert bool(torch.isfinite(b.u).all())
    assert float(b.t) > t0

