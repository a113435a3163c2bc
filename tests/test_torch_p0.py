"""The port's DG(P0) against quinoa_tpu: the K = 1 instance of the
single-stream face pass (kernels K12 + K13, plain versions) and the P0
solver.

- the P0 tables and geometry against the JAX package's;
- K12's and K13's plain versions at (K, G) = (1, 1) against the JAX
  package's near/far face pass (quinoa_tpu/ops/face_fused.py
  fused_face_pass_nearfar, B2-B5, what a TPU runs at P0) in Pallas
  interpret mode with an explicit accumulation plan, and against its XLA
  dg_rhs: atol 1e-11 on the rhs, rtol 1e-12 on the dt from the charvel;
- the P0 rhs with a manufactured source (VorticalFlow) against the XLA
  dg_rhs, atol 1e-11;
- three steps of DGSolver at P0 on SodShocktube (extrapolate and symmetry
  faces, the chip_smoke.py p0 path at a small size), VorticalFlow (a
  source) and GaussHump transport (Dirichlet faces, the face Gauss-point
  path) against the JAX DGSolver: u atol 1e-11 of max(1, max|u|), dt and
  t rtol 1e-12, L2 rtol 1e-12.

Float64 on the CPU, inputs made from a numpy seed; the tolerances are the
JAX package's own (tests/test_dg.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quinoa_tpu.inciter.dg import DGDiagnostics as JDiag
from quinoa_tpu.inciter.dg import DGSolver as JSolver
from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.ops.face_accum import build_accum_plan
from quinoa_tpu.ops.face_fused import fused_face_pass_nearfar as j_nearfar
from quinoa_tpu.pde.dg import (BC_DIRICHLET, BC_EXTRAPOLATE, BC_SYMMETRY,
                               build_dggeom)
from quinoa_tpu.pde.dg import dg_dt as j_dg_dt
from quinoa_tpu.pde.dg import dg_rhs as j_dg_rhs
from quinoa_tpu.pde.dg_compflow import DGCompFlow as JCompFlow
from quinoa_tpu.pde.dg_compflow import DGTransport as JTransport
from quinoa_tpu.pde.problems import GaussHump as JGaussHump
from quinoa_tpu.pde.problems import SodShocktube as JSod
from quinoa_tpu.pde.problems import VorticalFlow as JVortical

from quinoa_tpu_torch import convert
from quinoa_tpu_torch.inciter.dg import DGDiagnostics, DGSolver
from quinoa_tpu_torch.ops.face_fused import (basis_accum_plain,
                                             face_wflux_plain,
                                             fused_face_pass)
from quinoa_tpu_torch.pde.dg import _make_tables
from quinoa_tpu_torch.pde.dg import build_dggeom as t_build
from quinoa_tpu_torch.pde.dg import dg_dt_from_delt, dg_rhs
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow as TCompFlow
from quinoa_tpu_torch.pde.dg_compflow import DGTransport as TTransport
from quinoa_tpu_torch.pde.problems import GaussHump as TGaussHump
from quinoa_tpu_torch.pde.problems import SodShocktube as TSod
from quinoa_tpu_torch.pde.problems import VorticalFlow as TVortical

RHS_ATOL = 1e-11
DT_RTOL = 1e-12
L2_RTOL = 1e-12
#: extrapolate on the x faces, symmetry on the others (the Sod tube)
SOD_BC = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
          **{i: BC_SYMMETRY for i in range(3, 7)}}


def _arrays(jg):
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg) if f.name != "tables"}
    arrays["tables"] = dict(jg.tables)
    return arrays


@pytest.fixture(scope="module")
def sod():
    """A 6x3x3 Sod box at P0 in both packages and a perturbed physical
    state across the tube's jump."""
    mesh = box_tet_mesh(6, 3, 3, hi=(1.0, 0.5, 0.5))
    jg = build_dggeom(mesh, ndof=1, bc_sidesets=SOD_BC)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    u0 = np.asarray(JSolver(JCompFlow(JSod()), jg).initial_state().u)
    rng = np.random.default_rng(21)
    U0 = u0 * (1.0 + 0.02 * rng.random(u0.shape))
    U0[1:4] = 0.05 * rng.standard_normal((3, u0.shape[1]))
    return jg, tg, U0


def test_p0_tables_and_geometry_match_jax(sod):
    """_make_tables(1): one volume, face and initialisation point; the P0
    geometry the port builds equals the JAX package's."""
    jg, tg, _ = sod
    tt = _make_tables(1)
    assert tt["w_face"].shape == (1,) and tt["w_vol"].shape == (1,)
    assert set(tt) == set(jg.tables)
    for k in tt:
        np.testing.assert_allclose(tt[k], np.asarray(jg.tables[k]), rtol=0,
                                   atol=1e-15, err_msg=k)
    mine = t_build(box_tet_mesh(6, 3, 3, hi=(1.0, 0.5, 0.5)), 1, SOD_BC,
                   device="cpu")
    assert mine.ndof == 1 and mine.xi_l.shape == (3, 1, mine.nface)
    for k, v in convert.geom_to_arrays(mine).items():
        if k not in ("tables", "ndof", "nelem_real"):
            np.testing.assert_allclose(v, _arrays(jg)[k], rtol=0, atol=1e-14,
                                       err_msg=k)


def test_p0_face_pass_matches_pallas_and_xla(sod):
    """K12 + K13 plain at (1, 1) against the JAX near/far kernels B2-B5
    (interpret mode) and the XLA dg_rhs; delt's dt against dg_dt."""
    jg, tg, U0 = sod
    jsys, tsys = JCompFlow(JSod()), TCompFlow(TSod())
    tU = torch.as_tensor(U0)
    wfl, mx = face_wflux_plain(tsys, tg, tU)
    assert wfl.shape == (5, tg.nface)
    acc, delt = basis_accum_plain(tg, wfl, mx)
    plan = build_accum_plan(jg, TF=128, W=128)
    acc_p, delt_p = j_nearfar(jsys, jg, plan, jnp.asarray(U0))
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_p), rtol=0,
                               atol=RHS_ATOL)
    np.testing.assert_allclose(delt.numpy(), np.asarray(delt_p), rtol=1e-12)
    r_x = np.asarray(j_dg_rhs(jsys, jg, jnp.asarray(U0), None, 0.0,
                              face_gp=False))
    np.testing.assert_allclose(acc.numpy(), r_x, rtol=0, atol=RHS_ATOL)
    r, delt2 = fused_face_pass(tsys, tg, tU)
    assert torch.equal(r, acc) and torch.equal(delt2, delt)
    np.testing.assert_allclose(
        dg_rhs(tsys, tg, tU, None, 0.0, face_gp=False).numpy(), r_x, rtol=0,
        atol=RHS_ATOL)
    dt_j = float(j_dg_dt(jsys, jg, jnp.asarray(U0), None))
    assert np.isclose(float(dg_dt_from_delt(tg, delt)), dt_j, rtol=DT_RTOL)


def test_p0_rhs_with_source_matches_jax():
    """At P0 the volume integral is the source alone (the flux term needs
    a gradient): VorticalFlow's rhs against the XLA dg_rhs."""
    mesh = box_tet_mesh(3, 3, 3, lo=(-0.5, -0.5, -0.5), hi=(0.5, 0.5, 0.5))
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
    jg = build_dggeom(mesh, ndof=1, bc_sidesets=bc)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    jsys, tsys = JCompFlow(JVortical()), TCompFlow(TVortical())
    U0 = np.asarray(JSolver(jsys, jg).initial_state().u)
    want = np.asarray(j_dg_rhs(jsys, jg, jnp.asarray(U0), None, 0.3,
                               face_gp=False))
    got = dg_rhs(tsys, tg, torch.tensor(U0), None, 0.3, face_gp=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RHS_ATOL)


def _p0_case(case):
    """(JAX solver, port solver) of one P0 configuration."""
    if case == "sod":
        mesh = box_tet_mesh(8, 2, 2, hi=(1.0, 0.25, 0.25))
        bc, cfl = SOD_BC, 0.5
        systems = JCompFlow(JSod()), TCompFlow(TSod())
    elif case == "vortical":
        mesh = box_tet_mesh(3, 3, 3, lo=(-0.5, -0.5, -0.5),
                            hi=(0.5, 0.5, 0.5))
        bc, cfl = {i: BC_SYMMETRY for i in range(1, 7)}, 0.5
        systems = JCompFlow(JVortical()), TCompFlow(TVortical())
    else:
        mesh = box_tet_mesh(6, 6, 2, hi=(1.0, 1.0, 0.2))
        bc, cfl = {i: BC_DIRICHLET for i in range(1, 7)}, 0.8
        systems = JTransport(JGaussHump()), TTransport(TGaussHump())
    jg = build_dggeom(mesh, ndof=1, bc_sidesets=bc)
    tg = t_build(mesh, 1, bc, device="cpu")
    return (JSolver(systems[0], jg, cfl=cfl), jg,
            DGSolver(systems[1], tg, cfl=cfl), tg)


@pytest.mark.parametrize("case", ["sod", "vortical", "gausshump"])
def test_p0_solver_matches_jax(case):
    """Three DGSolver steps at P0 (cflscale 1, no limiter) against the
    JAX package's, and the diagnostics of the last state."""
    js, jg, ts, tg = _p0_case(case)
    assert ts.cflscale == js.cflscale == 1.0
    a, b = js.initial_state(), ts.initial_state()
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                               atol=1e-14)
    for n in range(1, 4):
        a, b = js.step(a), ts.step(b)
        scale = max(1.0, float(np.abs(np.asarray(a.u)).max()))
        np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                                   atol=RHS_ATOL * scale)
        assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
        assert np.isclose(float(b.t), float(a.t), rtol=DT_RTOL)
        assert int(b.it) == int(a.it) == n
    assert bool(torch.isfinite(b.u).all())
    for x, y in zip(DGDiagnostics(ts.system, tg).compute(b),
                    JDiag(js.system, jg).compute(a)):
        np.testing.assert_allclose(x, y, rtol=L2_RTOL, atol=1e-14)


def test_p0_configurations_outside_the_port_raise():
    """A limiter below P1 is a ValueError, as in the JAX package;
    p-adaptive P0, which raised before it was ported, runs the face
    Gauss-point route with an all-ones dofmask and matches the JAX
    package after two steps (u atol 1e-11 of max(1, max|u|), dt rtol
    1e-12)."""
    mesh = box_tet_mesh(4, 2, 2, hi=(1.0, 0.5, 0.5))
    jg = build_dggeom(mesh, ndof=1, bc_sidesets=SOD_BC)
    g = convert.geom_from_arrays(_arrays(jg), device="cpu")
    with pytest.raises(ValueError):
        DGSolver(TCompFlow(TSod()), g, limiter="superbeep1")
    js = JSolver(JCompFlow(JSod()), jg, cfl=0.5, pref=True)
    ts = DGSolver(TCompFlow(TSod()), g, cfl=0.5, pref=True)
    assert ts.route.face == "face_gp"
    a, b = js.initial_state(), ts.initial_state()
    for _ in range(2):
        a, b = js.step(a), ts.step(b)
        scale = max(1.0, float(np.abs(np.asarray(a.u)).max()))
        np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                                   atol=RHS_ATOL * scale)
        assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
    assert bool((b.ndofel == 1).all())
