"""The port's face Gauss-point DG path against quinoa_tpu: the face gather
(kernel K5's plain version) against the Pallas gather_left_states, the
face accumulation (K6's plain version) against the Pallas
accumulate_faces, both in interpret mode; the face-gp dg_rhs and dg_dt
with and without a dofmask; GaussHump transport and GaussHump pdg
solvers; compressible Euler on Dirichlet faces.

Float64 on the CPU on the 10x10x2 GaussHump box of tests/test_dg.py with
Dirichlet faces on all six sides.  Inputs are made with numpy from a seed
and handed to both packages; the geometry goes through convert.py.
Tolerances: the gather is a copy (exact); the accumulation sums the same
four rows in another order than the Pallas kernel (1e-13 of the largest
entry); rhs atol 1e-11 and dt rtol 1e-12 as the JAX package holds its own
face passes (tests/test_dg.py), and the same for two-step solvers.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quinoa_tpu.inciter.dg import DGDiagnostics as JDiag
from quinoa_tpu.inciter.dg import DGSolver as JSolver
from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.ops.face_accum import accumulate_faces as j_accumulate
from quinoa_tpu.ops.face_accum import build_accum_plan, gather_left_states
from quinoa_tpu.pde.dg import BC_DIRICHLET, BC_SYMMETRY, build_dggeom
from quinoa_tpu.pde.dg import dg_dt as j_dg_dt
from quinoa_tpu.pde.dg import dg_rhs as j_dg_rhs
from quinoa_tpu.pde.dg_compflow import DGCompFlow as JCompFlow
from quinoa_tpu.pde.dg_compflow import DGTransport as JTransport
from quinoa_tpu.pde.problems import GaussHump as JGaussHump
from quinoa_tpu.pde.problems import SedovBlastwave as JSedov

from quinoa_tpu_torch import convert
from quinoa_tpu_torch.inciter.dg import DGDiagnostics, DGSolver
from quinoa_tpu_torch.ops.face_accum import (accumulate_faces_plain,
                                             face_gather_plain)
from quinoa_tpu_torch.pde.dg import dg_dt, dg_rhs
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow as TCompFlow
from quinoa_tpu_torch.pde.dg_compflow import DGTransport as TTransport
from quinoa_tpu_torch.pde.problems import GaussHump as TGaussHump
from quinoa_tpu_torch.pde.problems import SedovBlastwave as TSedov

K = 4
ACC_RTOL = 1e-13
RHS_ATOL = 1e-11
DT_RTOL = 1e-12
U_ATOL = 1e-11
L2_RTOL = 1e-12


def _arrays(g):
    out = {f.name: np.asarray(getattr(g, f.name))
           for f in dataclasses.fields(g) if f.name != "tables"}
    out["tables"] = dict(g.tables)
    return out


@pytest.fixture(scope="module")
def geoms():
    mesh = box_tet_mesh(10, 10, 2, hi=(1.0, 1.0, 0.2))
    jg = build_dggeom(mesh, ndof=4,
                      bc_sidesets={i: BC_DIRICHLET for i in range(1, 7)})
    return jg, convert.geom_from_arrays(_arrays(jg), device="cpu")


def _hump_state(E, seed, C=1):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((C * K, E)) * 0.05
    U[[c * K for c in range(C)]] += 0.5
    return U


def _dofmask(E, seed):
    ndofel = np.where(np.random.default_rng(seed).random(E) < 0.4, 1, 4)
    return (np.arange(K)[:, None] < ndofel[None, :]).astype(np.float64)


@pytest.mark.parametrize("C", [1, 5])
def test_face_gather_matches_pallas_kernel(geoms, C):
    """K5's plain version with idx = el against gather_left_states."""
    jg, tg = geoms
    plan = build_accum_plan(jg, TF=128, W=128)
    U = _hump_state(jg.nelem, 1, C)
    want = np.asarray(gather_left_states(plan, jnp.asarray(U), C, K))
    got = face_gather_plain(torch.as_tensor(U), tg.el).numpy()
    np.testing.assert_array_equal(got.reshape(C, K, -1), want)


def test_face_accumulation_matches_pallas_kernel(geoms):
    """K6's plain version (no base) against accumulate_faces."""
    jg, tg = geoms
    plan = build_accum_plan(jg, TF=128, W=128)
    rng = np.random.default_rng(2)
    cL, cR = rng.standard_normal((2, 4, jg.nface))
    want = np.asarray(j_accumulate(plan, jnp.asarray(cL), jnp.asarray(cR)))
    got = accumulate_faces_plain(tg, torch.as_tensor(cL),
                                 torch.as_tensor(cR)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ACC_RTOL * np.abs(want).max())


@pytest.mark.parametrize("masked", [False, True])
def test_face_gp_rhs_and_dt_match_jax(geoms, masked):
    """GaussHump on Dirichlet faces at t = 0.3: rhs against dg_rhs
    (face_gp=True, XLA; without a dofmask also through the Pallas gather
    and accumulation), dt against dg_dt."""
    jg, tg = geoms
    jsys, tsys = JTransport(JGaussHump()), TTransport(TGaussHump())
    U = _hump_state(jg.nelem, 3)
    dm = _dofmask(jg.nelem, 4) if masked else None
    jdm = None if dm is None else jnp.asarray(dm)
    tdm = None if dm is None else torch.as_tensor(dm)
    want = np.asarray(jax.jit(lambda g, u: j_dg_rhs(
        jsys, g, u, jdm, 0.3, face_gp=True))(jg, jnp.asarray(U)))
    got = dg_rhs(tsys, tg, torch.as_tensor(U), tdm, torch.tensor(0.3),
                 face_gp=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RHS_ATOL)
    if masked:
        assert (got[dm == 0] == 0).all()
    else:
        plan = build_accum_plan(jg, TF=128, W=128)
        pallas = np.asarray(jax.jit(lambda g, p, u: j_dg_rhs(
            jsys, g, u, None, 0.3, accum_plan=p, face_gp=True))(
                jg, plan, jnp.asarray(U)))
        np.testing.assert_allclose(got, pallas, rtol=0, atol=RHS_ATOL)
    assert np.isclose(float(dg_dt(tsys, tg, torch.as_tensor(U), tdm)),
                      float(j_dg_dt(jsys, jg, jnp.asarray(U), jdm)),
                      rtol=DT_RTOL)


@pytest.mark.parametrize("flux", ["hllc", "laxfriedrichs"])
def test_compflow_dirichlet_face_gp_rhs_matches_jax(flux):
    """Compressible Euler with Dirichlet faces takes the face-gp path,
    where either flux runs in torch."""
    mesh = box_tet_mesh(4, 4, 3, hi=(0.4, 0.4, 0.3))
    bc = {i: BC_DIRICHLET for i in range(1, 4)}
    bc.update({i: BC_SYMMETRY for i in range(4, 7)})
    jg = build_dggeom(mesh, ndof=4, bc_sidesets=bc)
    tg = convert.geom_from_arrays(_arrays(jg), device="cpu")
    rng = np.random.default_rng(9)
    U = rng.random((5 * K, jg.nelem)) * 0.01
    U[0] += 1.0
    U[4 * K] += 2.5
    want = np.asarray(j_dg_rhs(JCompFlow(JSedov(), flux), jg,
                               jnp.asarray(U), None, 0.0, face_gp=True))
    tsys = TCompFlow(TSedov(), flux)
    got = dg_rhs(tsys, tg, torch.as_tensor(U), None, 0.0,
                 face_gp=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RHS_ATOL)


@pytest.fixture(scope="module")
def hump_runs(geoms):
    jg, tg = geoms
    out = {}
    for pref in (False, True):
        js = JSolver(JTransport(JGaussHump()), jg, cfl=0.8, pref=pref)
        ts = DGSolver(TTransport(TGaussHump()), tg, cfl=0.8, pref=pref)
        a, b = js.initial_state(), ts.initial_state()
        for _ in range(3):
            a, b = js.step(a), ts.step(b)
        out[pref] = (js, ts, a, b)
    return out


@pytest.mark.parametrize("pref", [False, True])
def test_gausshump_solver_matches_jax(geoms, hump_runs, pref):
    """GaussHump transport (and its pdg variant, the dofmask branch of
    the face-gp rhs): 3 steps, u, dt, ndofel and the diagnostics."""
    jg, tg = geoms
    js, ts, a, b = hump_runs[pref]
    nd = np.asarray(a.ndofel)
    np.testing.assert_array_equal(b.ndofel.numpy(), nd)
    if pref:
        assert (nd == 1).any() and (nd == 4).any()
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                               atol=U_ATOL)
    assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
    assert np.isclose(float(b.t), float(a.t), rtol=DT_RTOL)
    for x, y in zip(DGDiagnostics(ts.system, tg).compute(b),
                    JDiag(js.system, jg).compute(a)):
        np.testing.assert_allclose(x, y, rtol=L2_RTOL, atol=1e-14)
