"""The port's THINC interface sharpening for multimat DG(P1) against
quinoa_tpu/pde/multimat.py: the carriers, the THINC flavour of the
multimat face pass (kernel K14's plain version) and the solver.

- thinc_carriers (compact, 8 rows a material) against the JAX package's
  (5*nmat, K, E) carriers on a limited three-material interface-advection
  state and on a planar two-material interface (O(1) states, a copy of
  tests/test_multimat.py's _MMPlanarInterface), atol 1e-12, with flags
  set;
- one THINC stage rhs against the JAX unfused XLA rhs (_FusedMMFacade
  with thinc through dg_rhs), atol 1e-11 of max(1, max|r|);
- the same rhs and its delt against the JAX fused route, the near/far
  Pallas kernels B2-B5 tracing the THINC facade in interpret mode with an
  explicit plan: rhs atol 1e-9, the JAX package's own tolerance for its
  THINC kernels (tests/test_multimat.py:439-466), the stage-0 dt from
  delt rtol 1e-12;
- three MultiMatSolver steps with THINC on the planar interface, u atol
  1e-9 of max(1, max|u|) (the multimat P1 rule of test_torch_multimat.py:
  Superbee turns 1e-17 rhs differences into 3e-11 a step);
- intsharp at DG(P0) is accepted and ignored, as in the JAX package;
  THINC at DG(P1) on Dirichlet faces steps as the JAX package does
  (tests/test_torch_mm_dirichlet.py holds that route in full).

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
from quinoa_tpu.pde.eos import StiffenedGas as JGas
from quinoa_tpu.pde.problems import multimat as jpm

from quinoa_tpu_torch import convert, kernels
from quinoa_tpu_torch.ops.face_fused import (basis_accum_plain,
                                             mm_face_pass,
                                             mm_face_wflux_plain)
from quinoa_tpu_torch.pde import multimat as tm
from quinoa_tpu_torch.pde.dg import build_dggeom as t_build
from quinoa_tpu_torch.pde.eos import StiffenedGas as TGas
from quinoa_tpu_torch.pde.problems import multimat as tpm

CARRIER_ATOL = 1e-12
RHS_ATOL = 1e-11
PALLAS_ATOL = 1e-9
DT_RTOL = 1e-12
P1_STEP_ATOL = 1e-9
EXTRAPOLATE = {i: BC_EXTRAPOLATE for i in range(1, 7)}
#: the planar interface's faces (tests/test_multimat.py:419-420)
PLANAR_BC = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
             **{i: BC_SYMMETRY for i in range(3, 7)}}


class _Planar:
    """Planar two-material interface at x = 0.2 + t advected along x at
    unit speed with uniform pressure (tests/test_multimat.py:381-408),
    written for either package: xp is jnp or torch."""

    nmat = 2

    def __init__(self, gas):
        self.eos = (gas(gamma=1.4), gas(gamma=1.4))

    def solution(self, xyz, t):
        x = xyz[0]
        xp = jnp if isinstance(x, jnp.ndarray) else torch
        left = x - 1.0 * t < 0.2
        big = 1.0 - 1e-12
        a0 = xp.where(left, big, 1e-12)
        a1 = xp.where(left, 1e-12, big)
        r = xp.where(left, 1.0, 0.5)
        if xp is jnp:
            r, a0, a1 = (v.astype(x.dtype) for v in (r, a0, a1))
        else:
            r, a0, a1 = (v.to(x.dtype) for v in (r, a0, a1))
        zero = xp.zeros_like(x)
        s = [None] * 9
        s[0], s[1] = a0, a1
        for k, a in ((0, a0), (1, a1)):
            s[2 + k] = a * r
            s[7 + k] = a * self.eos[k].totalenergy(r, 1.0, 0.0, 0.0, 1.0)
        s[4] = s[2] + s[3]
        s[5] = zero
        s[6] = zero
        return xp.stack(s)


def _arrays(jg):
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg) if f.name != "tables"}
    arrays["tables"] = dict(jg.tables)
    return arrays


def _case(problem, mesh, bc):
    """(JAX system, JAX geometry, port system, port geometry), THINC on,
    and the JAX package's consistently limited initial state."""
    if problem == "iface":
        jp, tp = jpm.MMInterfaceAdvection(), tpm.MMInterfaceAdvection()
    else:
        jp, tp = _Planar(JGas), _Planar(TGas)
    jg = build_dggeom(mesh, ndof=4, bc_sidesets=bc)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    jsys = jm.MultiMatSystem(jp, intsharp=True)
    tsys = tm.MultiMatSystem(tp, intsharp=True)
    js = jm.MultiMatSolver(jsys, jg, cfl=0.4, limiter="superbeep1")
    u = np.array(js._limit(jg, js.initial_state().u, None))
    return jsys, jg, tsys, tg, u


@pytest.fixture(scope="module")
def iface():
    """The JAX THINC kernel test's configuration: three-material interface
    advection on a 5x5x4 box, extrapolate on every side."""
    return _case("iface", box_tet_mesh(5, 5, 4, hi=(0.5, 0.5, 0.4)),
                 EXTRAPOLATE)


@pytest.fixture(scope="module")
def planar():
    return _case("planar", box_tet_mesh(12, 2, 2, hi=(1.0, 1.0 / 6,
                                                      1.0 / 6)), PLANAR_BC)


@pytest.mark.parametrize("case", ["iface", "planar"])
def test_carriers_match_jax(case, request):
    """thinc_carriers, rebuilt into the JAX layout by thinc_modes, against
    the JAX package's; the interface cells are flagged."""
    jsys, jg, tsys, tg, u = request.getfixturevalue(case)
    C = jsys.ncomp
    want = np.asarray(jsys.thinc_carriers(jg, jnp.asarray(u).reshape(C, 4,
                                                                     -1)))
    X = tsys.thinc_carriers(tg, torch.as_tensor(u).reshape(C, 4, -1))
    assert X.shape == (8 * tsys.nmat, tg.nelem)
    got = tsys.thinc_modes(X, 4)
    assert got.shape == want.shape == (5 * tsys.nmat, 4, tg.nelem)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=CARRIER_ATOL)
    assert int((X[5::8] > 0.5).sum()) > 0


def test_thinc_rhs_matches_xla(iface):
    """One THINC stage: the port's P1 rhs (the THINC face pass with the
    carriers of the stage's state) against the JAX unfused XLA rhs; THINC
    changes the rhs by far more than the tolerance."""
    jsys, jg, tsys, tg, u = iface
    jsys.fused_ok, tsys.fused_ok = False, True
    want = np.asarray(jsys.rhs(jg, jnp.asarray(u), 0.0))
    got = tsys.rhs(tg, torch.as_tensor(u), 0.0)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RHS_ATOL * scale)
    plain = tm.MultiMatSystem(tpm.MMInterfaceAdvection())
    plain.fused_ok = True
    assert float((plain.rhs(tg, torch.as_tensor(u), 0.0) - got).abs().max()
                 ) > 1e3 * RHS_ATOL * scale


def test_thinc_rhs_matches_fused_pallas(iface):
    """The port's fused route with THINC (rhs with want_delt) against the
    JAX package's: _FusedMMFacade(thinc=True) through the near/far Pallas
    kernels in interpret mode; delt gives the stage-0 dt."""
    jsys, jg, tsys, tg, u = iface
    plan = build_accum_plan(jg, TF=128, W=128)
    assert plan.fused is not None
    jsys.fused_ok = tsys.fused_ok = True
    r_j, delt_j = jsys.rhs(jg, jnp.asarray(u), 0.0, accum_plan=plan,
                           want_delt=True)
    r_t, delt_t = tsys.rhs(tg, torch.as_tensor(u), 0.0, want_delt=True)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0,
                               atol=PALLAS_ATOL)
    np.testing.assert_allclose(delt_t.numpy(), np.asarray(delt_j),
                               rtol=DT_RTOL)
    # the charvel reads the raw face states: the dt is THINC's too
    plain = tm.MultiMatSystem(tpm.MMInterfaceAdvection())
    plain.fused_ok = True
    assert torch.equal(plain.rhs(tg, torch.as_tensor(u), 0.0,
                                 want_delt=True)[1], delt_t)


def test_thinc_face_pass_plain(iface):
    """mm_face_pass with the carriers runs K14's THINC plain version
    (R rows, the carriers accumulate nothing), refuses DG(P0), and the K14
    wrapper refuses CPU tensors without counting a launch."""
    _, _, tsys, tg, u = iface
    U = torch.as_tensor(u)
    X = tsys.thinc_carriers(tg, U.reshape(tsys.ncomp, 4, -1))
    wfl, mx = mm_face_wflux_plain(tsys, tg, U, X)
    assert wfl.shape == (3 * tsys.nrows, tg.nface)
    assert bool(torch.isfinite(wfl).all()) and bool(torch.isfinite(mx).all())
    acc, delt = mm_face_pass(tsys, tg, U, X)
    assert torch.equal(acc, basis_accum_plain(tg, wfl, mx)[0])
    g0 = t_build(box_tet_mesh(2, 2, 2), 1, EXTRAPOLATE, device="cpu")
    with pytest.raises(NotImplementedError):
        mm_face_pass(tsys, g0, torch.zeros((tsys.ncomp, g0.nelem),
                                           dtype=torch.float64),
                     torch.zeros((8 * tsys.nmat, g0.nelem),
                                 dtype=torch.float64))
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.mm_face_wflux(U, tg.el, tg.er, tg.fn, tg.farea, tg.fmask,
                              tg.xi_l, tg.xi_r, tg.bctype, tg.w_face,
                              tsys.eos, X, tsys.thinc_beta)
    assert set(kernels.launches.values()) == {0}


def test_thinc_pad_faces_stay_finite(iface):
    """A pad face (fmask 0) carries the unit state, its carriers included:
    flagged with q = q0, every fraction 1/nmat, a finite flux times a zero
    weight (a NaN there would poison K13's element sums)."""
    _, _, tsys, tg, u = iface
    pad = torch.zeros(tg.nface, dtype=torch.bool)
    pad[::5] = True
    g = dataclasses.replace(tg, fmask=torch.where(pad, 0.0, tg.fmask))
    U = torch.as_tensor(u)
    X = tsys.thinc_carriers(g, U.reshape(tsys.ncomp, 4, -1))
    wfl, mx = mm_face_wflux_plain(tsys, g, U, X)
    assert bool((wfl[:, pad] == 0).all()) and bool((mx[pad] == 0).all())
    unit = torch.ones((tsys.thinc_facade.ncomp, 1), dtype=torch.float64)
    s = tsys.thinc_facade._thinc_faces(unit)
    np.testing.assert_allclose(s[:tsys.nmat, 0].numpy(), 1.0 / tsys.nmat)
    assert bool(torch.isfinite(s).all())


def test_thinc_solver_matches_jax(planar):
    """Three MultiMatSolver steps with THINC on the planar interface
    against the JAX package's (its XLA path on the CPU)."""
    jsys, jg, tsys, tg, _ = planar
    js = jm.MultiMatSolver(jsys, jg, cfl=0.5, limiter="superbeep1")
    ts = tm.MultiMatSolver(tsys, tg, cfl=0.5, limiter="superbeep1")
    a, b = js.initial_state(), ts.initial_state()
    for n in range(1, 4):
        a, b = js.step(a), ts.step(b)
        scale = max(1.0, float(np.abs(np.asarray(a.u)).max()))
        np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                                   atol=P1_STEP_ATOL * scale)
        assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
        assert int(b.it) == n
    assert bool(torch.isfinite(b.u).all())


def test_intsharp_at_p0_is_ignored():
    """intsharp at DG(P0) steps exactly as without it (the JAX rhs_p0
    ignores it); THINC at DG(P1) on Dirichlet faces, which raised before
    it was ported, matches the JAX package after one step (u atol 1e-9 of
    max(1, max|u|), the multimat P1 step rule; dt rtol 1e-12)."""
    mesh = box_tet_mesh(5, 5, 2, hi=(1.0, 1.0, 0.4))
    g0 = t_build(mesh, 1, EXTRAPOLATE, device="cpu")
    out = []
    for sharp in (False, True):
        s = tm.MultiMatSolver(tm.MultiMatSystem(tpm.MMInterfaceAdvection(),
                                                intsharp=sharp), g0, cfl=0.4)
        assert s.system.intsharp is sharp
        out.append(s.nsteps(s.initial_state(), 2))
    assert torch.equal(out[0].u, out[1].u) and torch.equal(out[0].dt,
                                                           out[1].dt)
    mesh = box_tet_mesh(3, 3, 2, hi=(0.3, 0.3, 0.2))
    jg = build_dggeom(mesh, ndof=4,
                      bc_sidesets={i: BC_DIRICHLET for i in range(1, 7)})
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    js = jm.MultiMatSolver(jm.MultiMatSystem(jpm.MMInterfaceAdvection(),
                                             intsharp=True), jg, cfl=0.4,
                           limiter="superbeep1")
    ts = tm.MultiMatSolver(tm.MultiMatSystem(tpm.MMInterfaceAdvection(),
                                             intsharp=True), tg, cfl=0.4,
                           limiter="superbeep1")
    a, b = js.step(js.initial_state()), ts.step(ts.initial_state())
    scale = max(1.0, float(np.abs(np.asarray(a.u)).max()))
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                               atol=P1_STEP_ATOL * scale)
    assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
