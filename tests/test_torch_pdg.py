"""The port's p-adaptive DG against quinoa_tpu: the neighbour-mean bounds
(kernel K4's plain version) against the Pallas neighbor_mean_bounds kernel
in interpret mode, Superbee with a dofmask and precomputed bounds, the
sticky indicator and the one-ring promotion, the Sedov pdg solver and the
mixed P0/P1 diagnostics; and the solver's fused route (the limit +
volume pass with the dof counts, K1's p-adaptive flavour on a card)
against its split route (the same solver built on the split Superbee
route) on a jittered box, bit for bit, and with a source against both volume
formulations.

Float64 on the CPU on the 6x6x4 box of the JAX package's own bounds-kernel
test (far neighbours live at W=128).  Inputs are made with numpy from a
seed and handed to both packages; the geometry goes through convert.py.
Tolerances: bounds and the indicator are selects and comparisons (exact);
Superbee is min/max/select plus a 4-term sum (atol 1e-13, the JAX
package's own limiter tolerance); the solver takes the two-step solver
tolerance of tests/test_dg.py (u atol 1e-11, dt rtol 1e-12), and the
first stage's face pass (K12 + K13 on the masked state) against the
near/far Pallas pass its fused-pass tolerance (rhs atol 1e-11, dt rtol
1e-12).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quinoa_tpu.inciter.dg import DGDiagnostics as JDiag
from quinoa_tpu.inciter.dg import DGSolver as JSolver
from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.mesh.reorder import hilbert_element_reorder
from quinoa_tpu.ops.face_accum import build_accum_plan
from quinoa_tpu.ops.nbr_bounds import build_bounds_plan
from quinoa_tpu.ops.nbr_bounds import neighbor_mean_bounds as j_bounds
from quinoa_tpu.pde.dg import BC_SYMMETRY, build_dggeom
from quinoa_tpu.pde.dg import dg_dt_from_delt as j_dt_from_delt
from quinoa_tpu.pde.dg import dg_rhs as j_dg_rhs
from quinoa_tpu.pde.dg import eval_ndof_sticky as j_eval_ndof
from quinoa_tpu.pde.dg import propagate_ndof as j_propagate
from quinoa_tpu.pde.dg_compflow import DGCompFlow as JCompFlow
from quinoa_tpu.pde.limiter import superbee_p1 as j_superbee_p1
from quinoa_tpu.pde.problems import SedovBlastwave as JSedov

from quinoa_tpu_torch import convert
from quinoa_tpu_torch.inciter import dg as t_dg
from quinoa_tpu_torch.inciter.dg import DGDiagnostics, DGSolver
from quinoa_tpu_torch.mesh import hilbert_element_reorder as t_hilbert
from quinoa_tpu_torch.ops.nbr_bounds import (neighbor_mean_bounds,
                                             volume_rhs_plain)
from quinoa_tpu_torch.pde.dg import BC_SYMMETRY as T_SYM
from quinoa_tpu_torch.pde.dg import build_dggeom as t_build
from quinoa_tpu_torch.pde.dg import (dg_dt_from_delt, eval_ndof_sticky,
                                     propagate_ndof, source_rhs,
                                     volume_term)
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow as TCompFlow
from quinoa_tpu_torch.pde.dg_step import on_route
from quinoa_tpu_torch.pde.limiter import superbee_p1
from quinoa_tpu_torch.pde.problems import NLEnergyGrowth as TNLEG
from quinoa_tpu_torch.pde.problems import SedovBlastwave as TSedov

from jittered_box import jittered_box

C, K = 5, 4
ATOL_LIM = 1e-13
U_ATOL = 1e-11
RHS_ATOL = 1e-11
DT_RTOL = 1e-12
L2_RTOL = 1e-12


def _arrays(g):
    out = {f.name: np.asarray(getattr(g, f.name))
           for f in dataclasses.fields(g) if f.name != "tables"}
    out["tables"] = dict(g.tables)
    return out


@pytest.fixture(scope="module")
def case():
    mesh = box_tet_mesh(6, 6, 4, hi=(0.6, 0.6, 0.4))
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
    jg = build_dggeom(mesh, ndof=4, bc_sidesets=bc)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    rng = np.random.default_rng(21)
    E = jg.nelem
    U0 = rng.standard_normal((C * K, E)) * 0.1
    U0[[c * K for c in range(C)]] += 2.0
    ndofel = np.where(rng.random(E) < 0.4, 1, 4).astype(np.int32)
    return jg, tg, U0, ndofel


def _dofmask(ndofel, dtype=np.float64):
    return (np.arange(K)[:, None] < ndofel[None, :]).astype(dtype)


def test_neighbor_bounds_match_pallas_kernel(case):
    """K4's plain version against neighbor_mean_bounds (interpret mode,
    far neighbours live): bit for bit."""
    jg, tg, U0, _ = case
    plan = build_bounds_plan(jg, W=128)
    assert plan.nef > 0
    jmin, jmax = j_bounds(plan, jnp.asarray(U0[::K]), interpret=True)
    tmin, tmax = neighbor_mean_bounds(tg, torch.as_tensor(U0), C)
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
    assert (tmin.numpy() < U0[::K]).any() and (tmax.numpy() > U0[::K]).any()


def test_superbee_with_dofmask_and_bounds(case):
    """Superbee with a dofmask and precomputed bounds against the JAX
    package's; P0 elements keep their state."""
    jg, tg, U0, ndofel = case
    dm = _dofmask(ndofel)
    plan = build_bounds_plan(jg, W=128)
    jb = j_bounds(plan, jnp.asarray(U0[::K]), interpret=True)
    jl = np.asarray(j_superbee_p1(jg, jnp.asarray(U0), jnp.asarray(dm), C,
                                  bounds=jb))
    tU = torch.as_tensor(U0)
    tl = superbee_p1(tg, tU, torch.as_tensor(dm), C,
                     bounds=neighbor_mean_bounds(tg, tU, C)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL_LIM)
    p0 = ndofel == 1
    np.testing.assert_array_equal(tl[:, p0], U0[:, p0])
    assert not np.allclose(tl[:, ~p0], U0[:, ~p0])   # the limiter acted


def test_eval_and_propagate_ndof_exact(case):
    """The sticky indicator and the one-ring promotion, exactly."""
    jg, tg, U0, ndofel = case
    U = U0 * 0.02            # gradients straddle tolref 0.1
    je = np.asarray(j_eval_ndof(jg, jnp.asarray(U), jnp.asarray(ndofel), C,
                                0.1))
    te = eval_ndof_sticky(tg, torch.as_tensor(U), torch.as_tensor(ndofel),
                          C, 0.1)
    assert te.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy(), je)
    assert set(np.unique(je[ndofel == 4])) == {1, 4}
    np.testing.assert_array_equal(je[ndofel == 1], 1)   # sticky
    jp = np.asarray(j_propagate(jg, jnp.asarray(je)))
    tp = propagate_ndof(tg, te)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert (jp != je).any() and (jp == 1).any()


@pytest.fixture(scope="module")
def sedov_pdg():
    mesh, _ = hilbert_element_reorder(
        box_tet_mesh(6, 6, 4, hi=(0.6, 0.6, 0.4)))
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
    jg = build_dggeom(mesh, ndof=4, bc_sidesets=bc)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    kw = dict(cfl=0.5, limiter="superbeep1", pref=True)
    js = JSolver(JCompFlow(JSedov()), jg, **kw)
    ts = DGSolver(TCompFlow(TSedov()), tg, **kw)
    a, b = js.initial_state(), ts.initial_state()
    out = {}
    for n in (1, 2, 3):
        a, b = js.step(a), ts.step(b)
        out[n] = (a, b)
    return js, jg, ts, tg, out


@pytest.mark.parametrize("nsteps", [1, 2, 3])
def test_sedov_pdg_solver_matches_jax(sedov_pdg, nsteps):
    """Sedov p-adaptive DG(P1) + Superbee: the port's route (bounds, split
    Superbee, zeroing, fused face pass on the masked state) against the
    JAX package's XLA route on the CPU."""
    _, _, _, _, out = sedov_pdg
    a, b = out[nsteps]
    nd = np.asarray(a.ndofel)
    np.testing.assert_array_equal(b.ndofel.numpy(), nd)
    assert (nd == 1).any() and (nd == 4).any()
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                               atol=U_ATOL)
    assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
    assert np.isclose(float(b.t), float(a.t), rtol=DT_RTOL)


def test_mixed_p0_diagnostics_match_jax(sedov_pdg):
    """The mixed P0/P1 diagnostics: per-element active dofs, P0 error at
    the centroid."""
    js, jg, ts, tg, out = sedov_pdg
    a, b = out[3]
    assert (np.asarray(a.ndofel) == 1).any()
    for x, y in zip(DGDiagnostics(ts.system, tg).compute(b),
                    JDiag(js.system, jg).compute(a)):
        np.testing.assert_allclose(x, y, rtol=L2_RTOL, atol=1e-14)


def test_pdg_stage_face_pass_matches_pallas_nearfar(sedov_pdg, monkeypatch):
    """pdg's first RK stage: the masked P0/P1 state and volume term the
    port's solver hands its face pass (K12 + K13), through that pass,
    against the JAX dg_rhs on the same state and volume term through the
    near/far Pallas kernels B2-B5 (interpret mode, an explicit
    accumulation plan with near and far streams live): rhs atol 1e-11,
    dt from the charvel rtol 1e-12 (tests/test_dg.py's fused-pass
    tolerances)."""
    _, jg, ts, tg, _ = sedov_pdg
    seen = []
    face_pass = ts.p1_face_pass

    def spy(system, g, uf, vol_rhs):
        seen.append((uf, vol_rhs))
        return face_pass(system, g, uf, vol_rhs=vol_rhs)

    # the face pass of the solver's route (K12 + K13), seen from outside
    monkeypatch.setattr(t_dg, "fused_face_pass", spy)
    ndofel = ts.step(ts.initial_state()).ndofel.numpy()
    monkeypatch.undo()
    uf, rv = seen[0]
    assert (ndofel == 1).any() and (ndofel == 4).any()
    zero = (uf.reshape(C, K, -1)[:, 1:] == 0).all(dim=(0, 1)).numpy()
    assert zero.any() and not zero.all()     # the stage state is masked
    r, delt = face_pass(ts.system, tg, uf, vol_rhs=rv)
    plan = build_accum_plan(jg, TF=128, W=128)
    assert plan.fused.Fn > 0 and plan.fused.Ff > 0
    r_j, delt_j = j_dg_rhs(JCompFlow(JSedov()), jg, jnp.asarray(uf.numpy()),
                           None, 0.0, accum_plan=plan, face_gp=False,
                           want_charvel=True,
                           vol_rhs=jnp.asarray(rv.numpy()))
    r_j = np.asarray(r_j)
    np.testing.assert_allclose(r.numpy(), r_j, rtol=0, atol=RHS_ATOL)
    assert np.isclose(float(dg_dt_from_delt(tg, delt)),
                      float(j_dt_from_delt(jg, delt_j)), rtol=DT_RTOL)


def _fused_and_split(problem, nsteps=4, tolref=0.1):
    """[(fused state, split state)] after each of nsteps steps of
    p-adaptive DG(P1) + Superbee on a jittered box, each route from its
    own previous state.  The split route is the same solver's built on
    the split Superbee route: K4's bounds (its plain version here), superbee_p1
    with the dofmask, the stage-0 zeroing (u * dofmask, which feeds the
    anchor), the volume integral of u * dofmask (volume_rhs_plain, or
    volume_rhs with a source), the face pass on that masked state, the RK
    update and the restore of the inactive rows."""
    mesh, _ = t_hilbert(jittered_box())
    g = t_build(mesh, 4, {i: T_SYM for i in range(1, 7)},
                dtype=torch.float64, device="cpu")
    kw = dict(cfl=0.5, limiter="superbeep1", pref=True, tolref=tolref)
    fused = DGSolver(TCompFlow(problem), g, **kw)
    assert fused.route.limit == "k1_pref"
    system = TCompFlow(problem)
    split = on_route(DGSolver, dataclasses.replace(
        fused.route, limit="superbee_split",
        volume=volume_term(system, 4, face_gp=False)), system, g, **kw)
    a = b = fused.initial_state()
    out = []
    for _ in range(nsteps):
        a, b = fused.step(a), split.step(b)
        out.append((a, b))
    return out


def test_pdg_fused_limit_matches_split_route():
    """Sedov: the solver's fused limit + volume route equals the split
    route (K4 bounds, Superbee with the dofmask, stage-0 zeroing, the
    volume integral of the masked state, the face pass) in u, ndofel, t
    and dt, bit for bit, over four steps with P0 and P1 elements."""
    for a, b in _fused_and_split(TSedov()):
        nd = a.ndofel
        assert bool((nd == 1).any()) and bool((nd == 4).any())
        for f in ("u", "ndofel", "t", "dt"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("formulation", ["fused", "xla"])
def test_pdg_fused_limit_with_source(formulation, monkeypatch):
    """NLEnergyGrowth (a manufactured source) on the fused route: against
    the split route with the non-adaptive fused route's volume term
    (volume_rhs_plain + source_rhs) bit for bit; against the split route
    with the XLA formulation (volume_rhs, the source summed into the flux
    integral before the scaling) to round-off: u atol 1e-11 (U_ATOL),
    dt and t rtol 1e-12 (DT_RTOL), ndofel equal.  Its smooth solution
    keeps every element at P1 under tolref 0.1; at 1.0 about half of them
    go to P0."""
    if formulation == "fused":
        # only the split route calls volume_rhs at P1
        monkeypatch.setattr(
            t_dg, "volume_rhs", lambda system, g, u, t:
            volume_rhs_plain(system, g, u) + source_rhs(system, g, t))
    for a, b in _fused_and_split(TNLEG(), 3, tolref=1.0):
        nd = a.ndofel
        assert bool((nd == 1).any()) and bool((nd == 4).any())
        assert torch.equal(a.ndofel, b.ndofel)
        if formulation == "fused":
            for f in ("u", "t", "dt"):
                assert torch.equal(getattr(a, f), getattr(b, f)), f
        else:
            np.testing.assert_allclose(a.u.numpy(), b.u.numpy(), rtol=0,
                                       atol=U_ATOL)
            assert not torch.equal(a.u, b.u)     # the sum orders differ
            for f in ("t", "dt"):
                assert np.isclose(float(getattr(a, f)),
                                  float(getattr(b, f)), rtol=DT_RTOL), f
