"""The port's DG schemes beyond DG(P1) Superbee against quinoa_tpu's
DGSolver: the WENO limiter, rDG p0p1 (evolve_ndof), a limiter and
p-adaptivity at P2, p-adaptivity at P0.

- weno_p1 alone, with and without a dofmask, at P1 and P2, on a seeded
  Sedov-like state (its neighbours' slopes differ): atol 1e-11 of
  max(1, max|u|);
- two DGSolver steps of each scheme from the initial state: u atol 1e-11
  of max(1, max|u|), dt rtol 1e-12, ndofel equal, the JAX package's own
  two-step solver tolerance (tests/test_dg.py):
  * wenop1 on Sedov at P1 (6x6x4, symmetry walls, cfl 0.5) and at P2
    (TaylorGreen, 3x3x2);
  * p0p1 on tests/test_p0p1.py's deck (GaussHump, Dirichlet on every
    side, 8x8x4 over (1, 1, 0.5), cfl 0.8), built in code, without a
    limiter (the P1 dofs keep their projection exactly) and with
    superbeep1, and on Sedov with superbeep1 (the K1 route);
  * superbeep1 and pref at P2 (TaylorGreen), pref at P0 (Sod, whose
    dofmask is all ones: the face Gauss-point route).

Float64 on the CPU.  The JAX solvers run their XLA formulation here.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quinoa_tpu.inciter.dg import DGSolver as JSolver
from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.mesh.reorder import hilbert_element_reorder
from quinoa_tpu.pde import problems as jp
from quinoa_tpu.pde.dg import (BC_DIRICHLET, BC_EXTRAPOLATE, BC_SYMMETRY,
                               build_dggeom)
from quinoa_tpu.pde.dg_compflow import DGCompFlow as JCompFlow
from quinoa_tpu.pde.dg_compflow import DGTransport as JTransport
from quinoa_tpu.pde.limiter import weno_p1 as j_weno_p1

from quinoa_tpu_torch import convert
from quinoa_tpu_torch.inciter.dg import DGSolver
from quinoa_tpu_torch.pde import problems as tp
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow, DGTransport
from quinoa_tpu_torch.pde.limiter import weno_p1

U_ATOL = 1e-11
DT_RTOL = 1e-12
SYM = {i: BC_SYMMETRY for i in range(1, 7)}
DIRICHLET = {i: BC_DIRICHLET for i in range(1, 7)}
SOD_BC = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
          **{i: BC_SYMMETRY for i in range(3, 7)}}
#: (mesh cells, box hi), the meshes of the cases
MESHES = {"sedov": ((6, 6, 4), (0.6, 0.6, 0.4)),
          "tg": ((3, 3, 2), (1.0, 1.0, 0.67)),
          "deck": ((8, 8, 4), (1.0, 1.0, 0.5)),
          "sod": ((8, 2, 2), (1.0, 0.25, 0.25))}
#: case: (mesh, ndof, faces, problem, transport, solver keywords)
CASES = {
    "wenop1_p1": ("sedov", 4, SYM, "SedovBlastwave", False,
                  dict(limiter="wenop1", cfl=0.5)),
    "wenop1_p2": ("tg", 10, SYM, "TaylorGreen", False,
                  dict(limiter="wenop1", cfl=0.5, cweight=20.0)),
    "p0p1": ("deck", 4, DIRICHLET, "GaussHump", True,
             dict(evolve_ndof=1, cfl=0.8)),
    "p0p1_superbee": ("deck", 4, DIRICHLET, "GaussHump", True,
                      dict(evolve_ndof=1, cfl=0.8, limiter="superbeep1")),
    "p0p1_sedov": ("sedov", 4, SYM, "SedovBlastwave", False,
                   dict(evolve_ndof=1, cfl=0.5, limiter="superbeep1")),
    "superbee_p2": ("tg", 10, SYM, "TaylorGreen", False,
                    dict(limiter="superbeep1", cfl=0.5)),
    "pref_p2": ("tg", 10, SYM, "TaylorGreen", False,
                dict(limiter="superbeep1", pref=True, cfl=0.5)),
    "pref_p0": ("sod", 1, SOD_BC, "SodShocktube", False,
                dict(pref=True, cfl=0.5)),
}


def _arrays(jg):
    arrays = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg) if f.name != "tables"}
    arrays["tables"] = dict(jg.tables)
    return arrays


def _geoms(mesh_name, ndof, bc):
    (nx, ny, nz), hi = MESHES[mesh_name]
    mesh, _ = hilbert_element_reorder(box_tet_mesh(nx, ny, nz, hi=hi))
    jg = build_dggeom(mesh, ndof=ndof, bc_sidesets=bc)
    return jg, convert.geom_from_arrays(_arrays(jg), device="cpu")


def _solvers(case):
    mesh_name, ndof, bc, problem, transport, kw = CASES[case]
    jg, tg = _geoms(mesh_name, ndof, bc)
    if transport:
        jsys = JTransport(getattr(jp, problem)())
        tsys = DGTransport(getattr(tp, problem)())
    else:
        jsys = JCompFlow(getattr(jp, problem)())
        tsys = DGCompFlow(getattr(tp, problem)())
    return JSolver(jsys, jg, **kw), DGSolver(tsys, tg, **kw)


def _state(E, K, seed):
    """A Sedov-like modal state (5*K, E) with seeded slopes."""
    rng = np.random.default_rng(seed)
    U = np.zeros((5, K, E))
    U[0, 0] = 1.0 + 0.05 * rng.random(E)
    U[4, 0] = 2.5 + 0.05 * rng.random(E)
    U[:, 1:] = 0.02 * rng.standard_normal((5, K - 1, E))
    return U.reshape(5 * K, E)


@pytest.mark.parametrize("ndof,masked", [(4, False), (4, True), (10, False)],
                         ids=["p1", "p1_dofmask", "p2"])
def test_weno_p1_matches_jax(ndof, masked):
    jg, tg = _geoms("sedov" if ndof == 4 else "tg", ndof, SYM)
    E = jg.nelem
    U = _state(E, ndof, 3)
    dofmask = None
    if masked:
        ndofel = np.where(np.random.default_rng(5).random(E) < 0.4, 1, ndof)
        dofmask = (np.arange(ndof)[:, None] < ndofel[None]).astype(float)
    want = np.asarray(j_weno_p1(jg, jnp.asarray(U), None if dofmask is None
                                else jnp.asarray(dofmask), 5, 25.0))
    got = weno_p1(tg, torch.as_tensor(U), None if dofmask is None
                  else torch.as_tensor(dofmask), 5, 25.0)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=U_ATOL * scale)
    # the limiter moves the slopes (and leaves the means)
    Uv, Gv = U.reshape(5, ndof, E), got.numpy().reshape(5, ndof, E)
    assert np.abs(Gv[:, 1:4] - Uv[:, 1:4]).max() > 1e-3
    np.testing.assert_array_equal(Gv[:, 0], Uv[:, 0])
    if masked:
        p0 = dofmask[1] == 0
        np.testing.assert_array_equal(Gv[:, :, p0], Uv[:, :, p0])


@pytest.mark.parametrize("case", list(CASES))
def test_scheme_steps_match_jax(case):
    js, ts = _solvers(case)
    assert ts.evolve_ndof == js.evolve_ndof
    assert ts.cflscale == js.cflscale
    a0, b0 = js.initial_state(), ts.initial_state()
    a, b = a0, b0
    for n in (1, 2):
        a, b = js.step(a), ts.step(b)
        scale = max(1.0, float(np.abs(np.asarray(a.u)).max()))
        np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), rtol=0,
                                   atol=U_ATOL * scale)
        assert np.isclose(float(b.dt), float(a.dt), rtol=DT_RTOL)
        np.testing.assert_array_equal(b.ndofel.numpy(), np.asarray(a.ndofel))
        assert int(b.it) == n
    assert bool(torch.isfinite(b.u).all())
    K = ts.geom.ndof
    C = ts.system.ncomp
    if case == "p0p1":
        # without a limiter the reconstructed dofs keep their projection
        Uv, U0 = b.u.reshape(C, K, -1), b0.u.reshape(C, K, -1)
        assert torch.equal(Uv[:, 1:], U0[:, 1:])
        assert float((Uv[:, 0] - U0[:, 0]).abs().max()) > 1e-6
    if case.startswith("pref_"):
        # the indicator re-evaluates P1 elements only: every dof active
        assert bool((b.ndofel == K).all())
