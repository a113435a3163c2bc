"""The port's multi-material DG (pde/multimat.py, kernel K14's and K13's
plain versions at R rows) against quinoa_tpu/pde/multimat.py.

- the EoS additions and the three problems' solutions;
- the multimat face pass (mm_face_wflux_plain + basis_accum_plain) against
  the JAX package's _FusedMMFacade through its XLA dg_rhs and dg_dt
  (nmat 2 and 3, P0 and P1): the R = C + 3*nmat + 1 sums atol 1e-11, the
  dt rtol 1e-12;
- the whole rhs and delt against the JAX fused path, _FusedMMFacade
  through the near/far Pallas kernels B2-B5 in interpret mode with an
  explicit plan (P0 and P1): atol 1e-11 of max(1, max|r|);
- rhs_p0 on Dirichlet faces (the gather + K6 route; P1 on Dirichlet
  faces is tests/test_torch_mm_dirichlet.py's), the P1 rhs with and
  without the consistent Superbee limiter, dt_p0 and dt against the XLA
  path; consistent_mm_phi, clean_alpha_closure and the limit itself;
- three MultiMatSolver steps at P0 (Sod; interface advection on
  Dirichlet faces) and P1 (Sod + Superbee): u atol 1e-11 of max(1, max|u|)
  at P0; at P1 atol 1e-9, because a Superbee ratio whose denominator is
  just above the limiter's 1e-14 threshold turns the rhs's 1e-17
  differences into 3e-11 after one step (the same stage from the same
  input agrees to 1e-17: test_p1_rhs_matches_jax);
- the JAX package's physical checks (tests/test_multimat.py:48-67,
  :136-178) on the port.

Float64 on the CPU, inputs made from a numpy seed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.ops.face_accum import build_accum_plan
from quinoa_tpu.pde import multimat as jm
from quinoa_tpu.pde.dg import (BC_DIRICHLET, BC_EXTRAPOLATE, BC_SYMMETRY,
                               build_dggeom)
from quinoa_tpu.pde.dg import dg_dt as j_dg_dt
from quinoa_tpu.pde.dg import dg_rhs as j_dg_rhs
from quinoa_tpu.pde.eos import StiffenedGas as JGas
from quinoa_tpu.pde.limiter import consistent_mm_phi as j_mm_phi
from quinoa_tpu.pde.problems import multimat as jpm

from quinoa_tpu_torch import convert, kernels
from quinoa_tpu_torch.ops.face_fused import (basis_accum_plain,
                                             mm_face_pass,
                                             mm_face_wflux_plain)
from quinoa_tpu_torch.pde import multimat as tm
from quinoa_tpu_torch.pde.dg import build_dggeom as t_build
from quinoa_tpu_torch.pde.dg import dg_dt_from_delt, dg_initialize
from quinoa_tpu_torch.pde.eos import StiffenedGas as TGas
from quinoa_tpu_torch.pde.limiter import consistent_mm_phi
from quinoa_tpu_torch.pde.problems import multimat as tpm

RHS_ATOL = 1e-11
DT_RTOL = 1e-12
P1_STEP_ATOL = 1e-9
SOD_BC = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
          **{i: BC_SYMMETRY for i in range(3, 7)}}
PROBLEMS = {"sod": (jpm.MMSodShocktube, tpm.MMSodShocktube),
            "iface": (jpm.MMInterfaceAdvection, tpm.MMInterfaceAdvection),
            "wave": (jpm.MMSmoothWave, tpm.MMSmoothWave)}


def _arrays(jg):
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg) if f.name != "tables"}
    arrays["tables"] = dict(jg.tables)
    return arrays


def _pair(problem, ndof, bc=SOD_BC, mesh=None):
    """(JAX system, JAX geometry, port system, port geometry)."""
    jp, tp = PROBLEMS[problem]
    mesh = mesh or box_tet_mesh(6, 3, 2, hi=(1.0, 0.5, 0.33))
    jg = build_dggeom(mesh, ndof=ndof, bc_sidesets=bc)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    return jm.MultiMatSystem(jp()), jg, tm.MultiMatSystem(tp()), tg


def _state(jsys, jg, seed, limit=True):
    """The initial projection with its partial densities and energies
    scaled by up to 2% and a momentum added (fractions untouched, so they
    still sum to 1); at P1 then limited (JAX's consistent Superbee), so
    the face states of the discontinuous fractions stay physical."""
    C, K, nmat = jsys.ncomp, jg.ndof, jsys.nmat
    u0 = np.asarray(jm.MultiMatSolver(jsys, jg).initial_state().u).reshape(
        C, K, -1)
    rng = np.random.default_rng(seed)
    u = u0.copy()
    u[nmat:] = u0[nmat:] * (1.0 + 0.02 * rng.random(u0[nmat:].shape))
    mom = slice(2 * nmat, 2 * nmat + 3)
    rho = u[nmat:2 * nmat, 0].sum(axis=0)
    u[mom, 0] += 0.1 * rho * rng.standard_normal((3, u.shape[2]))
    u = u.reshape(C * K, -1)
    if K > 1 and limit:
        u = np.array(jm.mm_consistent_limit(jsys, jg, jnp.asarray(u)))
    return u


def test_eos_additions_match_jax():
    rng = np.random.default_rng(2)
    U = np.stack([1.0 + rng.random(50), *(0.1 * rng.standard_normal((3, 50))),
                  3.0 + rng.random(50)])
    for gas in ((1.4, 0.0, 717.5), (1.6, 2.0, 83.33)):
        jgas, tgas = JGas(*gas), TGas(*gas)
        np.testing.assert_allclose(
            tgas.soundspeed_cons_cm(torch.as_tensor(U)).numpy(),
            np.asarray(jgas.soundspeed_cons_cm(jnp.asarray(U))), rtol=1e-15)
        assert tgas.density(1.0e5, 300.0) == jgas.density(1.0e5, 300.0)


@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_problems_match_jax(problem):
    """solution() at random points, at t = 0 and after an advection
    time."""
    jp, tp = (cls() for cls in PROBLEMS[problem])
    xyz = np.random.default_rng(3).random((3, 200))
    for t in (0.0, 0.013):
        want = np.asarray(jp.solution(jnp.asarray(xyz), t))
        got = tp.solution(torch.as_tensor(xyz), torch.tensor(t,
                          dtype=torch.float64)).numpy()
        assert got.shape == (3 * jp.nmat + 3, 200)
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-300)


@pytest.mark.parametrize("ndof", [1, 4])
@pytest.mark.parametrize("problem", ["sod", "iface"])
def test_face_pass_matches_facade_xla(problem, ndof):
    """K14 + K13 plain against _FusedMMFacade through the XLA dg_rhs (the
    face sums of every row, volume term held at zero) and dg_dt."""
    jsys, jg, tsys, tg = _pair(problem, ndof,
                               bc={i: BC_EXTRAPOLATE for i in range(1, 3)}
                               | {i: BC_SYMMETRY for i in range(3, 7)})
    U = _state(jsys, jg, 5)
    C, K, nx = jsys.ncomp, ndof, 3 * jsys.nmat + 1
    E = U.shape[1]
    Up = np.concatenate([U.reshape(C, K, E), np.zeros((nx, K, E))]).reshape(
        -1, E)
    facade = jm._FusedMMFacade(jsys)
    want = np.asarray(j_dg_rhs(facade, jg, jnp.asarray(Up), None, 0.0,
                               face_gp=False,
                               vol_rhs=jnp.zeros_like(jnp.asarray(Up))))
    wfl, mx = mm_face_wflux_plain(tsys, tg, torch.as_tensor(U))
    G = {1: 1, 4: 3}[ndof]
    assert wfl.shape == (tsys.nrows * G, tg.nface) == (
        (C + nx) * G, tg.nface)
    acc, delt = basis_accum_plain(tg, wfl, mx)
    assert np.isfinite(want).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(acc.numpy(), want, rtol=0,
                               atol=RHS_ATOL * scale)
    dt_j = float(j_dg_dt(facade, jg, jnp.asarray(Up), None))
    assert np.isclose(float(dg_dt_from_delt(tg, delt)), dt_j, rtol=DT_RTOL)
    got = mm_face_pass(tsys, tg, torch.as_tensor(U))
    assert torch.equal(got[0], acc) and torch.equal(got[1], delt)


@pytest.mark.parametrize("ndof", [1, 4])
def test_rhs_matches_fused_pallas(ndof):
    """The port's fused route (rhs with want_delt) against the JAX
    package's: _FusedMMFacade through the near/far Pallas kernels in
    interpret mode (rhs_p0's fused branch at P0, dg_rhs's at P1)."""
    jsys, jg, tsys, tg = _pair("sod", ndof,
                               mesh=box_tet_mesh(4, 3, 2,
                                                 hi=(1.0, 0.75, 0.5)))
    U = _state(jsys, jg, 6)
    plan = build_accum_plan(jg, TF=128, W=128)
    assert plan.fused is not None
    jsys.fused_ok = tsys.fused_ok = True
    r_j, delt_j = jsys.rhs(jg, jnp.asarray(U), 0.0, accum_plan=plan,
                           want_delt=True)
    r_t, delt_t = tsys.rhs(tg, torch.as_tensor(U), 0.0, want_delt=True)
    scale = max(1.0, float(np.abs(np.asarray(r_j)).max()))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0,
                               atol=RHS_ATOL * scale)
    np.testing.assert_allclose(delt_t.numpy(), np.asarray(delt_j),
                               rtol=1e-12)


def test_rhs_p0_dirichlet_matches_jax():
    """rhs_p0 on Dirichlet faces: face states through the gather, the
    Dirichlet ghost at the cell anchor, torch AUSM+up, sums through the
    accumulation (K6's plain version), and the P0 dt sweep."""
    bc = {i: BC_DIRICHLET for i in range(1, 7)}
    jsys, jg, tsys, tg = _pair("iface", 1, bc=bc,
                               mesh=box_tet_mesh(5, 5, 2, hi=(1.0, 1.0, 0.4)))
    U = _state(jsys, jg, 7)
    jsys.fused_ok = tsys.fused_ok = False
    want = np.asarray(jsys.rhs_p0(jg, jnp.asarray(U), 0.01))
    got = tsys.rhs_p0(tg, torch.as_tensor(U),
                      torch.tensor(0.01, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RHS_ATOL * float(np.abs(want).max()))
    assert np.isclose(float(tsys.dt_p0(tg, torch.as_tensor(U))),
                      float(jsys.dt_p0(jg, jnp.asarray(U))), rtol=DT_RTOL)
    with pytest.raises(ValueError):
        tsys.rhs_p0(tg, torch.as_tensor(U), 0.0, want_delt=True)


@pytest.fixture(scope="module")
def sod_p1():
    return _pair("sod", 4)


@pytest.mark.parametrize("limited", [False, True])
def test_p1_rhs_matches_jax(sod_p1, limited):
    """The P1 rhs (XLA-formulation volume integral, face pass, high-order
    non-conservative terms) on a sloped Sod state, raw or after the
    consistent Superbee limiter, against the JAX package's XLA rhs; the
    limited states agree bit for bit."""
    jsys, jg, tsys, tg = sod_p1
    U = _state(jsys, jg, 8, limit=False)
    if limited:
        jl = np.array(jm.mm_consistent_limit(jsys, jg, jnp.asarray(U)))
        tl = tm.mm_consistent_limit(tsys, tg, torch.as_tensor(U)).numpy()
        np.testing.assert_array_equal(tl, jl)
        U = jl
    jsys.fused_ok, tsys.fused_ok = False, True
    want = np.asarray(jsys.rhs(jg, jnp.asarray(U), 0.0))
    got = tsys.rhs(tg, torch.as_tensor(U), 0.0)
    assert float(np.abs(want).max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RHS_ATOL)


@pytest.mark.parametrize("problem", ["sod", "iface"])
def test_volume_pass_matches_jax(problem):
    """The P1 volume pass (mm_volume, K16's plain version on the CPU)
    against the JAX package's volume integral (dg_rhs's XLA formulation,
    quinoa_tpu/pde/dg.py:341-370, through its flux_cols) and its
    _nonconservative_ho: the flux volume integral alone, and the stage's
    rhs from face sums (random rows), ((face rows + volume integral) +
    non-conservative integral) * emask, atol 1e-11 of max(1, max|r|);
    nmat 2 (Sod) and 3 (the interface advection, whose trace fractions
    meet the floors)."""
    jsys, jg, tsys, tg = _pair(problem, 4)
    U = _state(jsys, jg, 9)
    C, nmat, E = jsys.ncomp, jsys.nmat, U.shape[-1]
    acc = np.random.default_rng(10).standard_normal((tsys.nrows * 4, E))
    accv = acc.reshape(tsys.nrows, 4, E)
    tb = jg.tables
    state = jnp.einsum("gk,cke->cge", jnp.asarray(tb["B_vol"]),
                       jnp.asarray(U).reshape(C, 4, E))
    Fj = jsys.flux_cols(state, None, 0.0)
    Fref = jnp.stack([sum(Fj[j] * jg.jacInv[m, j] for j in range(3))
                      for m in range(3)])
    wdB = jnp.asarray(tb["w_vol"][:, None, None] * tb["dBdxi_vol"])
    rv = np.asarray(jnp.einsum("gkm,mcge->cke", wdB, Fref)
                    * (jg.vol * jg.emask)).reshape(C * 4, E)
    rnc = np.asarray(jsys._nonconservative_ho(
        jg, jnp.asarray(U).reshape(C, 4, E), jnp.asarray(accv[C:C + 3 * nmat,
                                                              0]),
        jnp.asarray(accv[C + 3 * nmat, 0])))
    rhs = ((accv[:C] + rv.reshape(C, 4, E) + rnc)
           * np.asarray(jg.emask)).reshape(C * 4, E)
    Ut = torch.as_tensor(U)
    for got, want in ((tm.mm_volume(tsys, tg, Ut), rv),
                      (tm.mm_volume(tsys, tg, Ut, torch.as_tensor(acc)),
                       rhs)):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=RHS_ATOL * scale)


@pytest.mark.parametrize("ndof", [1, 4])
def test_dt_matches_jax(ndof):
    """dt_p0 (P0) and the facade's dg_dt sweep (P1)."""
    jsys, jg, tsys, tg = _pair("iface", ndof)
    U = _state(jsys, jg, 9)
    assert np.isclose(float(tsys.dt(tg, torch.as_tensor(U))),
                      float(jsys.dt(jg, jnp.asarray(U))), rtol=DT_RTOL)


def test_limiter_pieces_match_jax(sod_p1):
    """consistent_mm_phi on random coefficients; clean_alpha_closure on
    random fractions with ties in the cell means (the first maximum
    wins in both packages)."""
    rng = np.random.default_rng(10)
    for nmat in (2, 3):
        C = 3 * nmat + 3
        phi = rng.random((C, 40))
        np.testing.assert_array_equal(
            consistent_mm_phi(torch.as_tensor(phi), nmat).numpy(),
            np.asarray(j_mm_phi(jnp.asarray(phi), nmat)))
        u = rng.random((C * 4, 40))
        u[4, :10] = u[0, :10]          # tied means of materials 0 and 1
        np.testing.assert_array_equal(
            tm.clean_alpha_closure(torch.as_tensor(u), C, 4, nmat).numpy(),
            np.asarray(jm.clean_alpha_closure(jnp.asarray(u), C, 4, nmat)))


def _solvers(case):
    if case == "p0_iface":
        bc = {i: BC_DIRICHLET for i in range(1, 7)}
        jsys, jg, tsys, tg = _pair("iface", 1, bc=bc,
                                   mesh=box_tet_mesh(5, 5, 2,
                                                     hi=(1.0, 1.0, 0.4)))
        kw = dict(cfl=0.4)
    else:
        ndof = 4 if case == "p1_sod" else 1
        jsys, jg, tsys, tg = _pair("sod", ndof)
        kw = dict(cfl=0.5, limiter="superbeep1" if ndof == 4 else None)
    return (jm.MultiMatSolver(jsys, jg, **kw),
            tm.MultiMatSolver(tsys, tg, **kw))


@pytest.mark.parametrize("case", ["p0_sod", "p0_iface", "p1_sod"])
def test_solver_matches_jax(case):
    """Three MultiMatSolver steps against the JAX package's."""
    js, ts = _solvers(case)
    atol = P1_STEP_ATOL if case == "p1_sod" else RHS_ATOL
    assert ts.cflscale == js.cflscale
    a, b = js.initial_state(), ts.initial_state()
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                               atol=1e-14)
    for n in range(1, 4):
        a, b = js.step(a), ts.step(b)
        scale = max(1.0, float(np.abs(np.asarray(a.u)).max()))
        np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                                   atol=atol * scale)
        assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
        assert np.isclose(float(b.t), float(a.t), rtol=DT_RTOL)
        assert int(b.it) == n
    assert bool(torch.isfinite(b.u).all())


def test_mm_sod_shock_on_the_port():
    """tests/test_multimat.py::test_mm_sod_shock on the port: 40 P0 steps
    of the two-material Sod tube stay bounded and develop the shock."""
    mesh = box_tet_mesh(32, 2, 2, hi=(1.0, 0.0625, 0.0625))
    geom = t_build(mesh, 1, SOD_BC, device="cpu")
    solver = tm.MultiMatSolver(tm.MultiMatSystem(tpm.MMSodShocktube()),
                               geom, cfl=0.5)
    s = solver.nsteps(solver.initial_state(), 40)
    u = s.u.numpy()
    assert np.isfinite(u).all()
    nmat = 2
    rho = u[nmat:2 * nmat].sum(axis=0)
    assert rho.min() > 0.1 and rho.max() < 1.05
    assert u[tm.momentum_idx(nmat, 0)].max() > 0.05
    a = u[:nmat]
    assert a.min() > -1e-8 and a.max() < 1.0 + 1e-8
    assert float(s.t) > 0.005


class _MMUniform:
    """Uniform two-material flow (tests/test_multimat.py's probe)."""

    nmat = 2
    eos = (TGas(gamma=1.4), TGas(gamma=1.6))

    def solution(self, xyz, t):
        nmat = self.nmat
        one = torch.ones_like(xyz[0])
        a, r = [0.3 * one, 0.7 * one], [1.0, 2.0]
        u, v, w, p = 3.0, -1.0, 0.5, 2.0
        s = [None] * (3 * nmat + 3)
        rhob = 0.0
        for k in range(nmat):
            s[k] = a[k]
            s[nmat + k] = a[k] * r[k]
            s[2 * nmat + 3 + k] = a[k] * self.eos[k].totalenergy(r[k], u, v,
                                                                w, p)
            rhob = rhob + s[nmat + k]
        s[2 * nmat:2 * nmat + 3] = [rhob * u, rhob * v, rhob * w]
        return torch.stack(s)


def test_mm_p1_uniform_rhs_vanishes_on_the_port():
    """tests/test_multimat.py::test_mm_p1_uniform_rhs_vanishes on the
    port: a uniform state has zero DG(P1) rhs in every dof row."""
    g = t_build(box_tet_mesh(4, 4, 4), 4,
                {i: BC_EXTRAPOLATE for i in range(1, 7)}, device="cpu")
    system = tm.MultiMatSystem(_MMUniform())
    system.fused_ok = True
    r = system.rhs(g, dg_initialize(system, g, 0.0), 0.0)
    assert float(r.abs().max()) < 1e-12


def test_mm_p1_k0_rows_match_p0_on_the_port():
    """tests/test_multimat.py::test_mm_p1_k0_rows_match_p0 on the port:
    on a zero-slope P1 state the k = 0 rows of the P1 rhs equal the P0
    rhs."""
    mesh = box_tet_mesh(6, 6, 2, hi=(1.0, 1.0, 0.3))
    bc = {i: BC_EXTRAPOLATE for i in range(1, 7)}
    system = tm.MultiMatSystem(tpm.MMInterfaceAdvection())
    system.fused_ok = True
    C = system.ncomp
    g0 = t_build(mesh, 1, bc, device="cpu")
    g1 = t_build(mesh, 4, bc, device="cpu")
    u0 = tm.MultiMatSolver(system, g0, cfl=0.5).initial_state().u
    E = g0.nelem
    u1 = torch.zeros((C, 4, E), dtype=u0.dtype)
    u1[:, 0] = u0
    r0 = system.rhs_p0(g0, u0, 0.0)
    r1 = system.rhs(g1, u1.reshape(C * 4, E), 0.0).reshape(C, 4, E)
    scale = float(r0.abs().max())
    assert float((r1[:, 0] - r0).abs().max()) <= 1e-11 * max(scale, 1.0)


def test_unported_multimat_configurations_raise():
    """P1 on Dirichlet faces (THINC included), which raised before it was
    ported, matches the JAX package after one step (u atol 1e-9 of
    max(1, max|u|), the P1 step rule above; dt rtol 1e-12); P2 raises
    ValueError, and so do a limiter at P0 and an unknown one, as in the
    JAX package."""
    mesh = box_tet_mesh(2, 2, 2)
    dirichlet = {i: BC_DIRICHLET for i in range(1, 7)}
    for thinc in (True, False):
        _, jg, _, tg = _pair("sod", 4, bc=dirichlet, mesh=mesh)
        jsys = jm.MultiMatSystem(jpm.MMSodShocktube(), intsharp=thinc)
        tsys = tm.MultiMatSystem(tpm.MMSodShocktube(), intsharp=thinc)
        js = jm.MultiMatSolver(jsys, jg, cfl=0.5, limiter="superbeep1")
        ts = tm.MultiMatSolver(tsys, tg, cfl=0.5, limiter="superbeep1")
        a, b = js.step(js.initial_state()), ts.step(ts.initial_state())
        scale = max(1.0, float(np.abs(np.asarray(a.u)).max()))
        np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                                   atol=P1_STEP_ATOL * scale)
        assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
    system = tm.MultiMatSystem(tpm.MMSodShocktube())
    g1 = t_build(mesh, 1, SOD_BC, device="cpu")
    for kw in ({"limiter": "superbeep1"}, {"limiter": "wenop1"}):
        with pytest.raises(ValueError):
            tm.MultiMatSolver(system, g1, **kw)
    with pytest.raises(ValueError):
        tm.MultiMatSolver(system, t_build(mesh, 10, SOD_BC, device="cpu"))


def test_convert_carries_p0_multimat_state():
    """A JAX ndof-1 geometry and a C = 9 multimat state cross to the port
    and back unchanged, and the port steps from them."""
    jsys, jg, tsys, tg = _pair("sod", 1)
    js = jm.MultiMatSolver(jsys, jg, cfl=0.5)
    a = js.step(js.initial_state())
    sarr = {k: np.asarray(getattr(a, k)) for k in convert.STATE_FIELDS}
    st = convert.state_from_arrays(sarr, device="cpu")
    assert st.u.shape == (9, tg.nelem) and tg.ndof == 1
    for k, v in convert.state_to_arrays(st).items():
        np.testing.assert_array_equal(v, sarr[k], err_msg=k)
    ts = tm.MultiMatSolver(tsys, tg, cfl=0.5)
    b = ts.step(st)
    np.testing.assert_allclose(b.u.numpy(), np.asarray(js.step(a).u),
                               rtol=0, atol=RHS_ATOL)


def test_cpu_multimat_leaves_launch_counters_at_zero():
    """Both multimat routes on CPU tensors run the plain versions; the
    K14 wrapper refuses CPU tensors (no fallback)."""
    kernels.reset_launches()
    for case in ("p0_sod", "p0_iface", "p1_sod"):
        _, ts = _solvers(case)
        ts.step(ts.initial_state())
    assert set(kernels.launches.values()) == {0}
    _, _, tsys, tg = _pair("sod", 1)
    U = torch.zeros((9, tg.nelem), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.mm_face_wflux(U, tg.el, tg.er, tg.fn, tg.farea, tg.fmask,
                              tg.xi_l, tg.xi_r, tg.bctype, tg.w_face,
                              tsys.eos)
    assert set(kernels.launches.values()) == {0}
