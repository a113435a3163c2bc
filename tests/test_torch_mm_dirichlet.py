"""The port's multi-material DG(P1) on Dirichlet faces (pde/multimat.py's
face Gauss-point route, THINC included) against quinoa_tpu/pde/multimat.py.

- one P1 stage rhs on the JAX package's consistently limited initial
  state of the interface advection (nmat 2 and 3, with and without THINC)
  against the JAX rhs with face_gp=True at t = 1e-3 (its Dirichlet ghost
  is the problem's solution at the face points then): atol 1e-11 of
  max(1, max|r|); THINC changes the rhs by far more than that;
- the stage-0 dt (the face sweep through the facade) rtol 1e-12;
- two MultiMatSolver steps with consistent Superbee and cfl 0.4, as the
  JAX solver takes them on the CPU: u atol 1e-9 of max(1, max|u|), the
  multimat P1 step rule of tests/test_torch_multimat.py (a Superbee ratio
  whose denominator is just above the limiter's 1e-14 threshold turns
  1e-17 rhs differences into 3e-11 a step), dt rtol 1e-12;
- the Dirichlet ghost of the facade: the solution at the face points for
  the C rows, the carriers copied from the left side;
- the route's kernels run their plain versions on CPU tensors.

Float64 on the CPU, a 5x5x4 box with Dirichlet on all six sides.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.pde import multimat as jm
from quinoa_tpu.pde.dg import BC_DIRICHLET, BC_INTERIOR, build_dggeom
from quinoa_tpu.pde.problems import multimat as jpm

from quinoa_tpu_torch import convert, kernels
from quinoa_tpu_torch.pde import multimat as tm
from quinoa_tpu_torch.pde.problems import multimat as tpm

RHS_ATOL = 1e-11
DT_RTOL = 1e-12
P1_STEP_ATOL = 1e-9
T_RHS = 1e-3
DIRICHLET = {i: BC_DIRICHLET for i in range(1, 7)}
CASES = [(2, False), (2, True), (3, False), (3, True)]
IDS = ["nmat2", "nmat2_thinc", "nmat3", "nmat3_thinc"]


def _arrays(jg):
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg) if f.name != "tables"}
    arrays["tables"] = dict(jg.tables)
    return arrays


@pytest.fixture(scope="module")
def geoms():
    jg = build_dggeom(box_tet_mesh(5, 5, 4, hi=(0.5, 0.5, 0.4)), ndof=4,
                      bc_sidesets=DIRICHLET)
    return jg, convert.geom_from_arrays(_arrays(jg), device="cpu")


def _case(geoms, nmat, thinc):
    """(JAX solver, port solver, the JAX package's limited initial
    state)."""
    jg, tg = geoms
    jsys = jm.MultiMatSystem(jpm.MMInterfaceAdvection(nmat=nmat),
                             intsharp=thinc)
    tsys = tm.MultiMatSystem(tpm.MMInterfaceAdvection(nmat=nmat),
                             intsharp=thinc)
    js = jm.MultiMatSolver(jsys, jg, cfl=0.4, limiter="superbeep1")
    ts = tm.MultiMatSolver(tsys, tg, cfl=0.4, limiter="superbeep1")
    u = np.array(js._limit(jg, js.initial_state().u, None))
    return js, ts, u


@pytest.mark.parametrize("nmat,thinc", CASES, ids=IDS)
def test_dirichlet_p1_rhs_matches_jax(geoms, nmat, thinc):
    js, ts, u = _case(geoms, nmat, thinc)
    jg, tg = geoms
    assert not js.system.fused_ok and ts.route.face == "mm_dirichlet"
    want = np.asarray(js.system.rhs(jg, jnp.asarray(u), T_RHS,
                                    face_gp=True))
    got = ts.system.rhs(tg, torch.as_tensor(u), T_RHS)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RHS_ATOL * scale)
    if thinc:
        assert int((ts.system.thinc_carriers(
            tg, torch.as_tensor(u).reshape(ts.system.ncomp, 4, -1))[5::8]
            > 0.5).sum()) > 0
        plain = tm.MultiMatSystem(tpm.MMInterfaceAdvection(nmat=nmat))
        diff = (plain.rhs(tg, torch.as_tensor(u), T_RHS) - got).abs().max()
        assert float(diff) > 1e3 * RHS_ATOL * scale
    want_dt = float(js.system.dt(jg, jnp.asarray(u)))
    got_dt = float(ts.system.dt(tg, torch.as_tensor(u)))
    assert np.isclose(got_dt, want_dt, rtol=DT_RTOL)


@pytest.mark.parametrize("nmat,thinc", CASES, ids=IDS)
def test_dirichlet_p1_solver_matches_jax(geoms, nmat, thinc):
    js, ts, _ = _case(geoms, nmat, thinc)
    a, b = js.initial_state(), ts.initial_state()
    for n in (1, 2):
        a, b = js.step(a), ts.step(b)
        scale = max(1.0, float(np.abs(np.asarray(a.u)).max()))
        np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                                   atol=P1_STEP_ATOL * scale)
        assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
        assert int(b.it) == n
    assert bool(torch.isfinite(b.u).all())


def test_facade_dirichlet_ghost(geoms):
    """The THINC facade's ghost on a Dirichlet face: the C rows are the
    problem's solution at the face points and t, the carrier rows the left
    side's; interior faces are not the ghost's."""
    _, tg = geoms
    tsys = tm.MultiMatSystem(tpm.MMInterfaceAdvection(), intsharp=True)
    fa = tsys.thinc_facade
    C = tsys.ncomp
    gp = tg.face_gp
    rng = np.random.default_rng(4)
    sL = torch.as_tensor(rng.random((fa.ncomp,) + tuple(gp.shape[1:])))
    ghost = fa.bc_state(tg.bctype, sL, tg.fn[:, None, :], gp, T_RHS)
    bnd = tg.bctype == BC_DIRICHLET
    assert int(bnd.sum()) > 0 and int((tg.bctype == BC_INTERIOR).sum()) > 0
    want = tsys.problem.solution(gp, T_RHS)
    assert torch.equal(ghost[:C][:, :, bnd], want[:, :, bnd])
    assert torch.equal(ghost[C:], sL[C:])


def test_dirichlet_p1_route_runs_plain_on_cpu(geoms):
    """A THINC step on the face Gauss-point route launches no kernel on
    CPU tensors."""
    kernels.reset_launches()
    _, ts, _ = _case(geoms, 3, True)
    ts.step(ts.initial_state())
    assert set(kernels.launches.values()) == {0}
