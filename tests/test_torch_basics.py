"""quinoa_tpu_torch against quinoa_tpu: quadrature, basis, EoS, flux
functions, HLLC and the Sedov initial condition.

Float64 on the CPU; inputs are made with numpy from fixed seeds and handed
to both packages.  Both evaluate the same closed forms, so the tolerances
only absorb XLA's freedom to fuse multiply-adds (a few ulp).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quinoa_tpu.ops import basis as jbasis
from quinoa_tpu.ops import quadrature as jquad
from quinoa_tpu.ops import riemann as jriemann
from quinoa_tpu.pde import eos as jeos
from quinoa_tpu.pde.dg_compflow import DGCompFlow as JCompFlow
from quinoa_tpu.pde.problems import SedovBlastwave as JSedov
from quinoa_tpu.pde.problems.compflow import euler_flux_dir as j_flux_dir

from quinoa_tpu_torch.ops import basis as tbasis
from quinoa_tpu_torch.ops import quadrature as tquad
from quinoa_tpu_torch.ops import riemann as triemann
from quinoa_tpu_torch.pde import eos as teos
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow as TCompFlow
from quinoa_tpu_torch.pde.problems import SedovBlastwave as TSedov
from quinoa_tpu_torch.pde.problems.compflow import (
    euler_flux_dir as t_flux_dir,
)

F64 = torch.float64
ATOL = 1e-13  # f64 closed forms, up to FMA contraction in XLA


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _states(rng, n):
    """Physical conservative states (5, n): rho, momenta of both signs,
    total energy above the kinetic part."""
    rho = 0.5 + rng.random(n)
    vel = rng.standard_normal((3, n))
    p = 0.1 + rng.random(n)
    rE = p / 0.4 + 0.5 * rho * (vel**2).sum(0)
    return np.concatenate([rho[None], rho * vel, rE[None]])


def _normals(rng, n):
    v = rng.standard_normal((3, n))
    return v / np.linalg.norm(v, axis=0)


def test_quadrature_rules_identical():
    """The port's numpy copy carries the same rules and NG maps."""
    for ng in jquad.TET_RULES:
        for a, b in zip(jquad.gauss_tet(ng), tquad.gauss_tet(ng)):
            np.testing.assert_array_equal(a, b)
    for ng in jquad.TRI_RULES:
        for a, b in zip(jquad.gauss_tri(ng), tquad.gauss_tri(ng)):
            np.testing.assert_array_equal(a, b)
    for ndof in (1, 4, 10):
        for f in ("ng_vol", "ng_face", "ng_init", "ng_diag"):
            assert getattr(jquad, f)(ndof) == getattr(tquad, f)(ndof)


@pytest.mark.parametrize("ndof", [1, 4, 10])
def test_basis_matches(ndof):
    """eval_basis / eval_basis_cm / mass_diag, atol 1e-13."""
    xi = np.random.default_rng(ndof).random((7, 3))
    np.testing.assert_allclose(
        tbasis.eval_basis(ndof, _t(xi)).numpy(),
        np.asarray(jbasis.eval_basis(ndof, jnp.asarray(xi))),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        tbasis.eval_basis_cm(ndof, _t(xi.T)).numpy(),
        np.asarray(jbasis.eval_basis_cm(ndof, jnp.asarray(xi.T))),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(tbasis.mass_diag(ndof),
                               jbasis.mass_diag(ndof), rtol=0, atol=1e-15)


@pytest.mark.parametrize("ndof", [4, 10])
def test_dbdxi_closed_form_matches_autodiff(ndof):
    """The closed-form P1/P2 derivatives equal jax.jacfwd's, atol 1e-13."""
    xi = np.random.default_rng(10 + ndof).random((9, 3))
    np.testing.assert_allclose(
        tbasis.eval_dbdxi(ndof, _t(xi)).numpy(),
        np.asarray(jbasis.eval_dbdxi(ndof, jnp.asarray(xi))),
        rtol=0, atol=ATOL)


def test_eos_matches():
    """Stiffened gas (with a nonzero pstiff) pressure, sound speed and
    total energy, rtol 1e-14."""
    rng = np.random.default_rng(1)
    U = _states(rng, 50)
    for kw in ({}, {"gamma": 5.0 / 3.0, "pstiff": 0.3}):
        je, te = jeos.StiffenedGas(**kw), teos.StiffenedGas(**kw)
        pj = np.asarray(je.pressure_cons_cm(jnp.asarray(U)))
        pt = te.pressure_cons_cm(_t(U)).numpy()
        np.testing.assert_allclose(pt, pj, rtol=1e-14)
        aj = np.asarray(je.soundspeed(jnp.asarray(U[0]),
                                      jnp.abs(jnp.asarray(pj))))
        at = te.soundspeed(_t(U[0]), _t(np.abs(pj))).numpy()
        np.testing.assert_allclose(at, aj, rtol=1e-14)
        v = U[1] / U[0]
        np.testing.assert_allclose(
            te.totalenergy(_t(U[0]), _t(v), _t(v), _t(v), _t(pj)).numpy(),
            np.asarray(je.totalenergy(*(jnp.asarray(a) for a in
                                        (U[0], v, v, v, pj)))),
            rtol=1e-14)


def test_euler_flux_dir_matches():
    rng = np.random.default_rng(2)
    U = _states(rng, 40)
    p = np.asarray(jeos.StiffenedGas().pressure_cons_cm(jnp.asarray(U)))
    for j in range(3):
        np.testing.assert_allclose(
            t_flux_dir(_t(U), _t(p), j).numpy(),
            np.asarray(j_flux_dir(jnp.asarray(U), jnp.asarray(p), j)),
            rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("flux", ["hllc", "lax_friedrichs"])
def test_riemann_matches(flux):
    """HLLC (every wave branch is hit by the random states) and Rusanov
    on face states (5, n), atol 1e-12 on O(1-10) fluxes."""
    rng = np.random.default_rng(3)
    n = 400
    uL, uR, fn = _states(rng, n), _states(rng, n), _normals(rng, n)
    gas_j, gas_t = jeos.StiffenedGas(), teos.StiffenedGas()
    fj = np.asarray(getattr(jriemann, flux)(
        jnp.asarray(fn), jnp.asarray(uL), jnp.asarray(uR), gas_j))
    ft = getattr(triemann, flux)(_t(fn), _t(uL), _t(uR), gas_t).numpy()
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-12)


def test_compflow_bc_state_and_charvel_match():
    """Symmetry/extrapolate ghosts and |v.n| + a, atol 1e-13."""
    rng = np.random.default_rng(4)
    n = 60
    sL, fn = _states(rng, n), _normals(rng, n)
    bt = rng.choice([2, 3, 5], n).astype(np.int32)
    js, ts = JCompFlow(JSedov()), TCompFlow(TSedov())
    np.testing.assert_allclose(
        ts.bc_state(torch.as_tensor(bt), _t(sL), _t(fn), None, 0.0).numpy(),
        np.asarray(js.bc_state(jnp.asarray(bt), jnp.asarray(sL),
                               jnp.asarray(fn), None, 0.0)),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        ts.charvel(_t(sL), _t(fn)).numpy(),
        np.asarray(js.charvel(jnp.asarray(sL), jnp.asarray(fn))),
        rtol=0, atol=ATOL)


def test_sedov_solution_matches():
    """Sedov ICs on points in and out of the hot corner: bit-identical
    (the same selects and one division)."""
    rng = np.random.default_rng(5)
    xyz = rng.random((3, 200)) * 0.1
    np.testing.assert_array_equal(
        TSedov().solution(_t(xyz), 0.0).numpy(),
        np.asarray(JSedov().solution(jnp.asarray(xyz), 0.0)))
