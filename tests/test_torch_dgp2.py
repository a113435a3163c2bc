"""The port's single-stream face pass (kernels K12 + K13, plain versions)
and its DG(P2) slice against quinoa_tpu.

- K12's plain version against the JAX package's single-stream fused
  kernel (quinoa_tpu/ops/face_fused.py fused_face_pass, Pallas interpret
  mode with an explicit accumulation plan, as tests/test_dg.py builds
  it): the weighted flux against _debug_contrib=True, the charvel against
  emit_charvel=True, atol 1e-13;
- K13's plain version, and the pass as a whole, against that call's
  accumulated surface integral, atol 1e-11, and the dt from its charvel
  against dg_dt, rtol 1e-12;
- the pass at P1 with HLLC on top of a volume term against the JAX
  package's near/far pass (fused_face_pass_nearfar, interpret mode),
  rhs atol 1e-11, delt rtol 1e-12;
- the volume integral with the TaylorGreen source at P2 against the XLA
  dg_rhs minus its surface part, atol 1e-11;
- two steps of the P2 TaylorGreen solver against the JAX DGSolver (its
  XLA path on the CPU): u atol 1e-11, dt rtol 1e-12, L2 rtol 1e-12.

Float64 on the CPU, inputs made from a numpy seed.  The tolerances are
the ones the JAX package holds its own fused face passes to
(tests/test_dg.py); 1e-13 on the weighted flux, whose entries are O(1)
products, leaves room for a few ulp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quinoa_tpu.inciter.dg import DGDiagnostics as JDiag
from quinoa_tpu.inciter.dg import DGSolver as JSolver
from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.mesh.reorder import hilbert_element_reorder
from quinoa_tpu.ops.face_accum import build_accum_plan
from quinoa_tpu.ops.face_fused import fused_face_pass as j_fused_face_pass
from quinoa_tpu.ops.face_fused import fused_face_pass_nearfar as j_nearfar
from quinoa_tpu.pde.dg import BC_DIRICHLET, BC_SYMMETRY, build_dggeom
from quinoa_tpu.pde.dg import dg_dt as j_dg_dt
from quinoa_tpu.pde.dg import dg_rhs as j_dg_rhs
from quinoa_tpu.pde.dg_compflow import DGCompFlow as JCompFlow
from quinoa_tpu.pde.problems import SedovBlastwave as JSedov
from quinoa_tpu.pde.problems import TaylorGreen as JTaylorGreen

from quinoa_tpu_torch import convert
from quinoa_tpu_torch.inciter.dg import DGDiagnostics, DGSolver
from quinoa_tpu_torch.ops.face_fused import (basis_accum_plain,
                                             face_wflux_plain,
                                             fused_face_pass)
from quinoa_tpu_torch.pde.dg import _make_tables
from quinoa_tpu_torch.pde.dg import build_dggeom as t_build
from quinoa_tpu_torch.pde.dg import dg_dt_from_delt, dg_rhs, volume_rhs
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow as TCompFlow
from quinoa_tpu_torch.pde.dg_compflow import DGTransport as TTransport
from quinoa_tpu_torch.pde.problems import GaussHump as TGaussHump
from quinoa_tpu_torch.pde.problems import SedovBlastwave as TSedov
from quinoa_tpu_torch.pde.problems import TaylorGreen as TTaylorGreen

WFL_ATOL = 1e-13
RHS_ATOL = 1e-11
DT_RTOL = 1e-12
L2_RTOL = 1e-12


def _arrays(jg):
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg) if f.name != "tables"}
    arrays["tables"] = dict(jg.tables)
    return arrays


def _sedov_like(E, K, seed):
    """Physical modal state with perturbed higher dofs (the construction
    of tests/test_dg.py's fused-pass parity test)."""
    rng = np.random.default_rng(seed)
    U0 = np.zeros((5 * K, E))
    U0[0] = 1.0 + 0.05 * rng.random(E)
    U0[4 * K] = 2.5 + 0.05 * rng.random(E)
    U0[K] = 0.1 * rng.random(E)
    for ck in range(5 * K):
        if ck % K:
            U0[ck] = 0.01 * rng.random(E)
    return U0


@pytest.fixture(scope="module", params=[4, 10], ids=["p1", "p2"])
def face_case(request):
    """The 5x5x4 box of the JAX package's fused-pass test with symmetry
    and extrapolate faces, a Sedov-like state, and the JAX single-stream
    pass's outputs: (acc, mx) with emit_charvel, the weighted flux with
    _debug_contrib."""
    K = request.param
    mesh = box_tet_mesh(5, 5, 4, hi=(0.5, 0.5, 0.4))
    bc = {i: BC_SYMMETRY for i in range(1, 5)}
    jg = build_dggeom(mesh, ndof=K, bc_sidesets=bc)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    U0 = _sedov_like(jg.nelem, K, 3)
    system = JCompFlow(JSedov())
    plan = build_accum_plan(jg, TF=128, W=128)
    acc_j, mx_j = j_fused_face_pass(system, jg, plan, jnp.asarray(U0),
                                    emit_charvel=True)
    _, wfl_j = j_fused_face_pass(system, jg, plan, jnp.asarray(U0),
                                 _debug_contrib=True)
    return dict(K=K, jg=jg, tg=tg, U0=U0, acc_j=np.asarray(acc_j),
                mx_j=np.asarray(mx_j), wfl_j=np.asarray(wfl_j))


def test_face_wflux_matches_pallas(face_case):
    """K12's plain version: the weighted flux (C*G, F) and the per-face
    charvel against the JAX package's B11 in interpret mode."""
    c = face_case
    wfl, mx = face_wflux_plain(TCompFlow(TSedov()), c["tg"],
                               torch.as_tensor(c["U0"]))
    G = {4: 3, 10: 6}[c["K"]]
    assert wfl.shape == (5 * G, c["tg"].nface) == c["wfl_j"].shape
    np.testing.assert_allclose(wfl.numpy(), c["wfl_j"], rtol=0,
                               atol=WFL_ATOL)
    np.testing.assert_allclose(mx.numpy(), c["mx_j"], rtol=0, atol=WFL_ATOL)


def test_face_pass_matches_pallas(face_case):
    """K13's plain version and the pass as a whole: the surface integral
    against B11 + B12 in interpret mode, and the dt from delt against the
    JAX package's dg_dt sweep."""
    c = face_case
    tsys, tU = TCompFlow(TSedov()), torch.as_tensor(c["U0"])
    wfl, mx = face_wflux_plain(tsys, c["tg"], tU)
    acc, delt = basis_accum_plain(c["tg"], wfl, mx)
    np.testing.assert_allclose(acc.numpy(), c["acc_j"], rtol=0,
                               atol=RHS_ATOL)
    r, delt2 = fused_face_pass(tsys, c["tg"], tU)
    assert torch.equal(r, acc) and torch.equal(delt2, delt)
    dt_j = float(j_dg_dt(JCompFlow(JSedov()), c["jg"], jnp.asarray(c["U0"]),
                         None))
    assert np.isclose(float(dg_dt_from_delt(c["tg"], delt)), dt_j,
                      rtol=DT_RTOL)
    # on top of a volume term: acc starts from it
    rv = torch.as_tensor(np.random.default_rng(4).standard_normal(acc.shape))
    np.testing.assert_allclose(fused_face_pass(tsys, c["tg"], tU, rv)[0],
                               rv + acc, rtol=0, atol=RHS_ATOL)


def test_single_stream_equals_nearfar_at_p1():
    """At P1 with HLLC the port's face pass (K12 + K13) on top of a volume
    term equals the JAX package's near/far pass (B2-B5, Pallas interpret
    mode, near and far streams both live) plus that term: rhs atol 1e-11,
    delt rtol 1e-12."""
    mesh = box_tet_mesh(5, 5, 4, hi=(0.5, 0.5, 0.4))
    bc = {i: BC_SYMMETRY for i in range(1, 5)}
    jg = build_dggeom(mesh, ndof=4, bc_sidesets=bc)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    U0 = _sedov_like(tg.nelem, 4, 3)
    rv = np.random.default_rng(5).standard_normal((20, tg.nelem))
    plan = build_accum_plan(jg, TF=128, W=128)
    assert plan.fused.Fn > 0 and plan.fused.Ff > 0
    acc_j, delt_j = j_nearfar(JCompFlow(JSedov()), jg, plan, jnp.asarray(U0))
    r, delt = fused_face_pass(TCompFlow(TSedov()), tg, torch.as_tensor(U0),
                              torch.as_tensor(rv))
    np.testing.assert_allclose(r.numpy(), rv + np.asarray(acc_j), rtol=0,
                               atol=RHS_ATOL)
    np.testing.assert_allclose(delt.numpy(), np.asarray(delt_j), rtol=1e-12)


def test_pad_faces_carry_no_weighted_flux(face_case):
    """fmask = 0 faces evaluate a finite unit state whose zero weight
    removes them, even over all-zero (0/0) states (face_fused.py:150-155)."""
    c = face_case
    tg = c["tg"]
    pad = torch.zeros(tg.nface, dtype=torch.bool)
    pad[::7] = True
    g = dataclasses.replace(tg, fmask=torch.where(pad, 0.0, tg.fmask))
    U = torch.as_tensor(c["U0"]).clone()
    U[:, g.el[pad].long()] = 0.0
    wfl, mx = face_wflux_plain(TCompFlow(TSedov()), g, U)
    assert bool((wfl[:, pad] == 0).all()) and bool((mx[pad] == 0).all())


@pytest.fixture(scope="module")
def tg_mesh():
    return hilbert_element_reorder(box_tet_mesh(4, 4, 3,
                                                hi=(1.0, 1.0, 0.75)))[0]


def test_p2_tables_match_jax(tg_mesh):
    """_make_tables(10): 11 volume, 6 face and 14 initialisation points,
    every table equal to the JAX package's."""
    jt = build_dggeom(tg_mesh, ndof=10).tables
    tt = _make_tables(10)
    assert tt["w_vol"].shape == (11,) and tt["w_face"].shape == (6,)
    assert tt["w_init"].shape == (14,) and tt["B_vol"].shape == (11, 10)
    assert set(tt) == set(jt)
    for k in tt:
        np.testing.assert_allclose(tt[k], np.asarray(jt[k]), rtol=0,
                                   atol=1e-15, err_msg=k)


def test_volume_integral_with_source_matches_jax(tg_mesh):
    """The XLA-formulation volume integral with the TaylorGreen source at
    P2 against the JAX dg_rhs minus its surface part."""
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
    jg = build_dggeom(tg_mesh, ndof=10, bc_sidesets=bc)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    jsys = JCompFlow(JTaylorGreen())
    u0 = np.asarray(JSolver(jsys, jg).initial_state().u)
    rng = np.random.default_rng(8)
    U0 = u0 + 0.01 * rng.standard_normal(u0.shape)
    U, t = jnp.asarray(U0), 0.25
    full = np.asarray(j_dg_rhs(jsys, jg, U, None, t, face_gp=False))
    surf = np.asarray(j_dg_rhs(jsys, jg, U, None, t, face_gp=False,
                               vol_rhs=jnp.zeros_like(U)))
    tsys = TCompFlow(TTaylorGreen())
    rv = volume_rhs(tsys, tg, torch.as_tensor(U0), t)
    assert float(np.abs(full - surf).max()) > 1.0
    np.testing.assert_allclose(rv.numpy(), full - surf, rtol=0,
                               atol=RHS_ATOL)
    np.testing.assert_allclose(dg_rhs(tsys, tg, torch.as_tensor(U0), None, t,
                                      face_gp=False),
                               full, rtol=0, atol=RHS_ATOL)


@pytest.fixture(scope="module")
def p2_runs(tg_mesh):
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
    jg = build_dggeom(tg_mesh, ndof=10, bc_sidesets=bc)
    tg = t_build(tg_mesh, 10, bc, dtype=torch.float64, device="cpu")
    js = JSolver(JCompFlow(JTaylorGreen(), riemann_flux="hllc"), jg,
                 cfl=0.5, limiter=None)
    ts = DGSolver(TCompFlow(TTaylorGreen(), riemann_flux="hllc"), tg,
                  cfl=0.5, limiter=None)
    a, b = js.initial_state(), ts.initial_state()
    out = {}
    for n in (1, 2):
        a, b = js.step(a), ts.step(b)
        out[n] = (a, b)
    return js, jg, ts, tg, out


@pytest.mark.parametrize("nsteps", [1, 2])
def test_p2_solver_matches_jax(p2_runs, nsteps):
    """The bench.py --dgp2 configuration at a small size: DG(P2)
    TaylorGreen, HLLC, symmetry walls, cfl 0.5 (cflscale 1/5), no
    limiter."""
    js, jg, ts, tg, out = p2_runs
    a, b = out[nsteps]
    assert ts.cflscale == js.cflscale == 0.2
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                               atol=1e-11)
    assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
    assert np.isclose(float(b.t), float(a.t), rtol=DT_RTOL)
    assert int(b.it) == int(a.it) == nsteps
    for x, y in zip(DGDiagnostics(ts.system, tg).compute(b),
                    JDiag(js.system, jg).compute(a)):
        np.testing.assert_allclose(x, y, rtol=L2_RTOL, atol=1e-14)


def test_p2_diagnostics_match_jax(p2_runs):
    """DGDiagnostics at K = 10 (14 points) on a perturbed state."""
    js, jg, ts, tg, out = p2_runs
    a, b = out[2]
    u = np.asarray(a.u) * (1.0 + 0.01 * np.random.default_rng(6).random(
        a.u.shape))
    ja = dataclasses.replace(a, u=jnp.asarray(u))
    tb = dataclasses.replace(b, u=torch.as_tensor(u))
    assert len(DGDiagnostics(ts.system, tg).w) == 14
    for x, y in zip(DGDiagnostics(ts.system, tg).compute(tb),
                    JDiag(js.system, jg).compute(ja)):
        np.testing.assert_allclose(x, y, rtol=L2_RTOL, atol=1e-14)


def test_convert_round_trips_p2(p2_runs):
    """A JAX ndof-10 geometry (tables included) and state cross to the
    port and back unchanged."""
    js, jg, _, _, out = p2_runs
    arrays = _arrays(jg)
    tg = convert.geom_from_arrays(arrays, device="cpu")
    assert tg.ndof == 10 and tg.xi_l.shape == (3, 6, tg.nface)
    back = convert.geom_to_arrays(tg)
    for k, v in back.items():
        if k == "tables":
            for name, tab in v.items():
                np.testing.assert_array_equal(tab, np.asarray(
                    arrays["tables"][name]), err_msg=name)
        elif k in ("ndof", "nelem_real"):
            assert v == arrays[k]
        else:
            np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    a = out[2][0]
    sarr = {k: np.asarray(getattr(a, k)) for k in convert.STATE_FIELDS}
    st = convert.state_from_arrays(sarr, device="cpu")
    assert st.u.shape == (50, tg.nelem)
    for k, v in convert.state_to_arrays(st).items():
        np.testing.assert_array_equal(v, sarr[k], err_msg=k)


def test_p2_configurations_outside_the_port_raise():
    """The configurations that raised before they were ported run and match
    the JAX package after one step (u atol 1e-11 of max(1, max|u|), dt
    rtol 1e-12): a P2 limiter, p-adaptive P2, P2 on the face Gauss-point
    path (TaylorGreen on Dirichlet faces, GaussHump transport) and the
    manufactured source at P1, on a 3x3x2 box."""
    from quinoa_tpu.pde.dg_compflow import DGTransport as JTransport
    from quinoa_tpu.pde.problems import GaussHump as JGaussHump

    sym = {i: BC_SYMMETRY for i in range(1, 7)}
    dirichlet = {i: BC_DIRICHLET for i in range(1, 7)}
    tgp = (JCompFlow(JTaylorGreen()), TCompFlow(TTaylorGreen()))
    hump = (JTransport(JGaussHump()), TTransport(TGaussHump()))
    mesh = hilbert_element_reorder(box_tet_mesh(3, 3, 2,
                                                hi=(1.0, 1.0, 0.67)))[0]
    for (jsys, tsys), ndof, bc, kw in (
            (tgp, 10, sym, {"limiter": "superbeep1"}),
            (tgp, 10, sym, {"pref": True}),
            (tgp, 10, dirichlet, {}),
            (hump, 10, sym, {}),
            (tgp, 4, sym, {})):
        jg = build_dggeom(mesh, ndof=ndof, bc_sidesets=bc)
        tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
        js, ts = JSolver(jsys, jg, **kw), DGSolver(tsys, tg, **kw)
        a, b = js.step(js.initial_state()), ts.step(ts.initial_state())
        scale = max(1.0, float(np.abs(np.asarray(a.u)).max()))
        np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                                   atol=RHS_ATOL * scale, err_msg=str(kw))
        assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
