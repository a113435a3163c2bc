"""The port's Lax-Friedrichs compressible-Euler DG against quinoa_tpu: the
Lax-Friedrichs flavour of the single-stream face pass (kernels K12 + K13,
plain versions) and the solver routes that take it.

- K12's plain version with riemann_flux="laxfriedrichs" at (K, G) = (1,
  1), (4, 3) and (10, 6) against the JAX package's single-stream fused
  kernel B11 (quinoa_tpu/ops/face_fused.py fused_face_pass) in Pallas
  interpret mode with an explicit accumulation plan, which traces
  DGCompFlow.riemann and so the same flux: the weighted flux and the
  charvel atol 1e-13;
- K13's plain version, and the pass as a whole, against the surface
  integral of the JAX XLA dg_rhs (volume term zero), atol 1e-11, and the
  dt from its charvel against dg_dt, rtol 1e-12.  B11's own sums are no
  reference here: its one-hot accumulation runs over face tiles padded
  with the unit state, whose pressure (-0.2) has a NaN sound speed that
  Lax-Friedrichs keeps, and NaN times the pad faces' zero weight poisons
  every element of the tile (HLLC falls through to a finite flux there);
- one DG(P1) stage on a small Sod box: the port's dg_rhs (volume integral
  in K1's order, then K12 + K13, as with HLLC) and its dt
  against the JAX XLA dg_rhs and dg_dt, rhs atol 1e-11 and dt rtol 1e-12
  (tests/test_dg.py:240-244);
- two DGSolver steps of Sod with Lax-Friedrichs at P0, P1 (Superbee, with
  and without p-adaptivity, and unlimited) and P2 against the JAX
  DGSolver: u atol 1e-11, dt rtol 1e-12;
- the routing: both fluxes take K12 + K13 at every order, the solver's
  DG(P1) pass included, and the pass refuses a Dirichlet face.

Float64 on the CPU, inputs made from a numpy seed.  Sod, not Sedov: a
Sedov stage's face points have negative pressures, whose NaN sound speed
Lax-Friedrichs carries into the flux (HLLC's wave selection falls through
it), so the JAX package itself gives NaN there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quinoa_tpu.inciter.dg import DGSolver as JSolver
from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.mesh.reorder import hilbert_element_reorder
from quinoa_tpu.ops.face_accum import build_accum_plan
from quinoa_tpu.ops.face_fused import fused_face_pass as j_fused_face_pass
from quinoa_tpu.pde.dg import BC_EXTRAPOLATE, BC_SYMMETRY, build_dggeom
from quinoa_tpu.pde.dg import dg_dt as j_dg_dt
from quinoa_tpu.pde.dg import dg_rhs as j_dg_rhs
from quinoa_tpu.pde.dg_compflow import DGCompFlow as JCompFlow
from quinoa_tpu.pde.problems import SodShocktube as JSod

from quinoa_tpu_torch import convert
from quinoa_tpu_torch.inciter.dg import DGSolver
from quinoa_tpu_torch.ops.face_fused import (basis_accum_plain,
                                             face_wflux_plain,
                                             fused_face_pass)
from quinoa_tpu_torch.pde.dg import BC_DIRICHLET as T_DIRICHLET
from quinoa_tpu_torch.pde.dg import BC_EXTRAPOLATE as T_EXTRAPOLATE
from quinoa_tpu_torch.pde.dg import dg_dt, dg_dt_from_delt, dg_rhs
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow as TCompFlow
from quinoa_tpu_torch.pde.dg_step import choose_route
from quinoa_tpu_torch.pde.problems import SodShocktube as TSod

WFL_ATOL = 1e-13
RHS_ATOL = 1e-11
DT_RTOL = 1e-12
LF = "laxfriedrichs"
#: extrapolate on the x faces, symmetry on the others (the Sod tube)
SOD_BC = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
          **{i: BC_SYMMETRY for i in range(3, 7)}}


def _arrays(jg):
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg) if f.name != "tables"}
    arrays["tables"] = dict(jg.tables)
    return arrays


def _sod_state(jsys, jg, seed):
    """The Sod initial projection with a momentum of 0.1 rho randn added
    to the means and every higher mode set to up to 1% of its component's
    mean magnitude (a physical state across the tube's jump)."""
    K = jg.ndof
    u = np.array(JSolver(jsys, jg).initial_state().u).reshape(5, K, -1)
    rng = np.random.default_rng(seed)
    E = u.shape[2]
    u[1:4, 0] += 0.1 * u[0, 0] * rng.standard_normal((3, E))
    if K > 1:
        u[:, 1:] = 0.01 * np.abs(u[:, :1]) * rng.random((5, K - 1, E))
    return u.reshape(5 * K, E)


@pytest.fixture(scope="module", params=[1, 4, 10], ids=["p0", "p1", "p2"])
def face_case(request):
    """A 5x4x3 Sod box with extrapolate and symmetry faces at ndof K, a
    perturbed state, and the JAX single-stream pass's outputs with
    Lax-Friedrichs: the charvel mx with emit_charvel, the weighted flux
    with _debug_contrib; and the XLA surface integral."""
    K = request.param
    mesh = box_tet_mesh(5, 4, 3, hi=(1.0, 0.8, 0.6))
    jg = build_dggeom(mesh, ndof=K, bc_sidesets=SOD_BC)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    system = JCompFlow(JSod(), riemann_flux=LF)
    U0 = _sod_state(system, jg, 3)
    plan = build_accum_plan(jg, TF=128, W=128)
    _, mx_j = j_fused_face_pass(system, jg, plan, jnp.asarray(U0),
                                emit_charvel=True)
    _, wfl_j = j_fused_face_pass(system, jg, plan, jnp.asarray(U0),
                                 _debug_contrib=True)
    U = jnp.asarray(U0)
    surf = j_dg_rhs(system, jg, U, None, 0.0, face_gp=False,
                    vol_rhs=jnp.zeros_like(U))
    return dict(K=K, jg=jg, tg=tg, U0=U0, surf_j=np.asarray(surf),
                mx_j=np.asarray(mx_j), wfl_j=np.asarray(wfl_j))


def test_lf_face_wflux_matches_pallas(face_case):
    """K12's plain version with Lax-Friedrichs: the weighted flux (C*G, F)
    and the per-face charvel against B11 in interpret mode."""
    c = face_case
    wfl, mx = face_wflux_plain(TCompFlow(TSod(), riemann_flux=LF), c["tg"],
                               torch.as_tensor(c["U0"]))
    assert wfl.shape == c["wfl_j"].shape
    assert np.isfinite(c["wfl_j"]).all()
    np.testing.assert_allclose(wfl.numpy(), c["wfl_j"], rtol=0,
                               atol=WFL_ATOL)
    np.testing.assert_allclose(mx.numpy(), c["mx_j"], rtol=0, atol=WFL_ATOL)
    # the flux is Lax-Friedrichs', not HLLC's
    hllc, _ = face_wflux_plain(TCompFlow(TSod()), c["tg"],
                               torch.as_tensor(c["U0"]))
    assert float((hllc - wfl).abs().max()) > 1e-6


def test_lf_face_pass_matches_xla(face_case):
    """K13's plain version and the pass as a whole with Lax-Friedrichs:
    the surface integral against the JAX XLA dg_rhs's, and the dt from
    delt against the JAX package's dg_dt sweep."""
    c = face_case
    tsys, tU = TCompFlow(TSod(), riemann_flux=LF), torch.as_tensor(c["U0"])
    acc, delt = basis_accum_plain(c["tg"], *face_wflux_plain(tsys, c["tg"],
                                                             tU))
    assert np.isfinite(c["surf_j"]).all()
    np.testing.assert_allclose(acc.numpy(), c["surf_j"], rtol=0,
                               atol=RHS_ATOL)
    r, delt2 = fused_face_pass(tsys, c["tg"], tU)
    assert torch.equal(r, acc) and torch.equal(delt2, delt)
    dt_j = float(j_dg_dt(JCompFlow(JSod(), riemann_flux=LF), c["jg"],
                         jnp.asarray(c["U0"]), None))
    assert np.isclose(float(dg_dt_from_delt(c["tg"], delt)), dt_j,
                      rtol=DT_RTOL)


@pytest.fixture(scope="module")
def sod_p1():
    mesh, _ = hilbert_element_reorder(box_tet_mesh(8, 3, 2,
                                                   hi=(1.0, 0.375, 0.25)))
    jg = build_dggeom(mesh, ndof=4, bc_sidesets=SOD_BC)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    return mesh, jg, tg


def test_lf_p1_stage_matches_xla(sod_p1):
    """One DG(P1) stage with Lax-Friedrichs: the port's rhs (K1's volume
    order, the single-stream face pass) and its dt from the pass's charvel
    against the JAX XLA dg_rhs and dg_dt."""
    _, jg, tg = sod_p1
    jsys = JCompFlow(JSod(), riemann_flux=LF)
    tsys = TCompFlow(TSod(), riemann_flux=LF)
    U0 = _sod_state(jsys, jg, 5)
    want = np.asarray(j_dg_rhs(jsys, jg, jnp.asarray(U0), None, 0.0,
                               face_gp=False))
    r, delt = dg_rhs(tsys, tg, torch.as_tensor(U0), None, 0.0, face_gp=False,
                     want_charvel=True)
    assert float(np.abs(want).max()) > 1e-3
    np.testing.assert_allclose(r.numpy(), want, rtol=0, atol=RHS_ATOL)
    dt_j = float(j_dg_dt(jsys, jg, jnp.asarray(U0), None))
    assert np.isclose(float(dg_dt_from_delt(tg, delt)), dt_j, rtol=DT_RTOL)
    assert np.isclose(float(dg_dt(tsys, tg, torch.as_tensor(U0))), dt_j,
                      rtol=DT_RTOL)


@pytest.mark.parametrize("ndof,kw", [
    (1, {}),
    (4, {"limiter": "superbeep1"}),
    (4, {"limiter": "superbeep1", "pref": True}),
    (4, {}),
    (10, {}),
], ids=["p0", "p1", "p1_pdg", "p1_unlimited", "p2"])
def test_lf_solver_matches_jax(sod_p1, ndof, kw):
    """Two Sod steps with Lax-Friedrichs against the JAX DGSolver (its XLA
    path on the CPU): DG(P0), DG(P1) with Superbee (the chip_smoke.py
    p1_lf path at a small size), p-adaptive and unlimited, DG(P2)."""
    mesh, jg, tg = sod_p1
    if ndof != 4:
        jg = build_dggeom(mesh, ndof=ndof, bc_sidesets=SOD_BC)
        tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    js = JSolver(JCompFlow(JSod(), riemann_flux=LF), jg, cfl=0.5, **kw)
    ts = DGSolver(TCompFlow(TSod(), riemann_flux=LF), tg, cfl=0.5, **kw)
    assert ts.cflscale == js.cflscale
    a, b = js.initial_state(), ts.initial_state()
    for n in range(1, 3):
        a, b = js.step(a), ts.step(b)
        assert np.isfinite(np.asarray(a.u)).all()
        np.testing.assert_array_equal(b.ndofel.numpy(), np.asarray(a.ndofel))
        np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                                   atol=RHS_ATOL)
        assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
        assert np.isclose(float(b.t), float(a.t), rtol=DT_RTOL)
        assert int(b.it) == n


def test_lf_routing(sod_p1):
    """Lax-Friedrichs and HLLC take K12 + K13 (fused_face_pass) at every
    order (the route's face pass, each flux's flavour), the solver's DG(P1)
    pass included; the pass refuses faces whose ghost needs the face
    coordinates (Dirichlet)."""
    _, _, tg = sod_p1
    lf, hllc = TCompFlow(TSod(), riemann_flux=LF), TCompFlow(TSod())
    for ndof in (1, 4, 10):
        g = dataclasses.replace(tg, ndof=ndof)
        assert choose_route(lf, [g]).face == "k12_lf"
        assert choose_route(hllc, [g]).face == "k12_hllc"
    for system in (lf, hllc):
        assert DGSolver(system, tg, limiter="superbeep1").p1_face_pass is (
            fused_face_pass)
    gd = dataclasses.replace(tg, bctype=torch.where(
        tg.bctype == T_EXTRAPOLATE, T_DIRICHLET, tg.bctype))
    U = torch.ones((5 * 4, tg.nelem), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="no Dirichlet/inlet "
                                                  "ghost"):
        fused_face_pass(lf, gd, U)
