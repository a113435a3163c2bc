"""The port's sharded DG solvers against quinoa_tpu's SPMD solvers and
against the port's own single-device solvers, on the CPU in float64.

Each scheme runs on S = 4 port shards (ShardGroup on the CPU) and on the
JAX package's SPMDDGSolver over 4 devices of the virtual 8-device CPU
mesh (tests/conftest.py), one step from the same initial state: the
gathered modal state within the single-device parity tests' tolerance
(u atol 1e-11 of max(1, max|u|), dt and t rtol 1e-12; tests/test_dg.py,
tests/test_torch_solver.py); then the JAX state after that step carried
into the port's shards (convert.py, the stacked arrays' shapes and
dtypes equal the port's) and one more step on each, the same way.  Then the sharded run against the port's
single-device solver for 5 steps at the JAX package's own equivalence
tolerances (tests/test_asynclogic.py:78 rtol 1e-9, atol 1e-12; pdg :180
rtol 3e-6, atol 5e-8), diagnostics at the same rtol.  The schemes: DG(P1)
Sedov with superbeep1, DG(P0) Sod, p-adaptive DG, DG(P2) TaylorGreen and
rDG p0p1 (the last two in test_torch_spmd_ho.py, which runs this file's
tests on them: xdist schedules whole files).  The JAX side's SPMD
programs compile for 10-30 s each, so each scheme compiles one (one step,
no diagnostics program).  Last, the sharded p-adaptive step's fused
limit + volume route against its split route (the solver built on the
split Superbee route) on a jittered box, bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from quinoa_tpu.mesh import box_tet_mesh as j_box
from quinoa_tpu.parallel.dg_shard import build_dg_shards as j_shards
from quinoa_tpu.parallel.dg_spmd import SPMDDGSolver as JSPMD
from quinoa_tpu.pde import problems as jprob
from quinoa_tpu.pde.dg_compflow import DGCompFlow as JFlow

from quinoa_tpu_torch import convert
from quinoa_tpu_torch.inciter.dg import DGDiagnostics, DGSolver
from quinoa_tpu_torch.mesh import box_tet_mesh
from quinoa_tpu_torch.parallel import (SPMDDGSolver, ShardGroup,
                                       build_dg_shards, dg_spmd)
from quinoa_tpu_torch.pde import problems as tprob
from quinoa_tpu_torch.pde.dg import build_dggeom
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow

from jittered_box import jittered_box

S = 4
U_ATOL = 1e-11
DT_RTOL = 1e-12
#: the JAX package's equivalence tolerances, sharded against one device
EQ = {"default": (1e-9, 1e-12), "pdg": (3e-6, 5e-8)}
SYM = {i: 2 for i in range(1, 7)}
SOD = {1: 3, 2: 3, 3: 2, 4: 2, 5: 2, 6: 2}

#: name: (problem, box n, box hi, ndof, bc, solver kwargs, flux)
CASES = {
    "p1_sedov": ("SedovBlastwave", (6, 6, 4), (0.6, 0.6, 0.4), 4, SYM,
                 dict(limiter="superbeep1"), "hllc"),
    "p0_sod": ("SodShocktube", (8, 4, 4), (1.0, 0.5, 0.5), 1, SOD, {},
               "hllc"),
    "pdg": ("SedovBlastwave", (6, 6, 4), (0.6, 0.6, 0.4), 4, SYM,
            dict(limiter="superbeep1", pref=True), "hllc"),
    "p2_taylorgreen": ("TaylorGreen", (4, 4, 3), (1.0, 1.0, 0.75), 10, SYM,
                       {}, "hllc"),
    "p0p1_sedov": ("SedovBlastwave", (6, 6, 4), (0.6, 0.6, 0.4), 4, SYM,
                   dict(limiter="superbeep1", evolve_ndof=1), "hllc"),
}
#: the cases this file runs; test_torch_spmd_ho.py runs the others
HERE = ("p0_sod", "p1_sedov", "pdg")


@pytest.fixture
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def _port(name):
    prob, n, hi, ndof, bc, kw, flux = CASES[name]
    mesh = box_tet_mesh(*n, hi=hi)
    system = DGCompFlow(getattr(tprob, prob)(), riemann_flux=flux)
    sh = build_dg_shards(mesh, S, ndof, bc, dtype=torch.float64,
                         group=ShardGroup(S, ["cpu"]))
    return mesh, system, SPMDDGSolver(system, sh, cfl=0.5, **kw)


@pytest.mark.parametrize("name", HERE)
def test_spmd_dg_matches_jax_spmd(f64, name):
    """One step from the same initial state; then the JAX solver's state
    after that step, carried into the port's shards
    (convert.sharded_state_from_stacked), one more step on each."""
    prob, n, hi, ndof, bc, kw, flux = CASES[name]
    _, _, port = _port(name)
    jsys = JFlow(getattr(jprob, prob)(), riemann_flux=flux)
    jsh = j_shards(j_box(*n, hi=hi), S, ndof, bc)
    js = JSPMD(jsys, jsh, Mesh(np.array(jax.devices()[:S]), ("shard",)),
               cfl=0.5, **kw)
    a1 = js.step(js.initial_state())
    a2 = js.step(a1)
    b1 = port.step(port.initial_state())
    _close(js, a1, port, b1, kw)
    stacked = convert.sharded_state_to_stacked(b1)
    for f in ("u", "ndofel", "t", "it", "dt"):
        want = np.asarray(getattr(a1, f))
        assert stacked[f].shape == want.shape, f
        assert stacked[f].dtype == want.dtype, f
    carried = convert.sharded_state_from_stacked(
        {f: np.asarray(getattr(a1, f)) for f in stacked}, type(b1),
        port.group.devices)
    _close(js, a2, port, port.step(carried), kw)


def _close(js, a, port, b, kw):
    ua, ub = js.gather_global(a), port.gather_global(b)
    np.testing.assert_allclose(ub, ua, rtol=0,
                               atol=U_ATOL * max(1.0, np.abs(ua).max()))
    for f in ("t", "dt"):
        want = np.asarray(getattr(a, f))
        got = np.array([float(x) for x in getattr(b, f)])
        np.testing.assert_allclose(got, want, rtol=DT_RTOL)
    assert [int(x) for x in b.it] == list(np.asarray(a.it))
    if kw.get("pref"):
        np.testing.assert_array_equal(port.gather_ndofel(b),
                                      _j_ndofel(js, a))


def _j_ndofel(js, state):
    nd = np.asarray(state.ndofel)
    eg = np.asarray(js.sharded.eglobal)
    own = np.asarray(js.sharded.owned) > 0
    out = np.zeros(js.sharded.nelem_global, np.int32)
    for s in range(nd.shape[0]):
        out[eg[s][own[s]]] = nd[s][own[s]]
    return out


@pytest.mark.parametrize("name", HERE)
def test_spmd_dg_matches_single_device(f64, name):
    prob, n, hi, ndof, bc, kw, flux = CASES[name]
    mesh, system, port = _port(name)
    g = build_dggeom(mesh, ndof, bc, dtype=torch.float64, device="cpu")
    single = DGSolver(system, g, cfl=0.5, **kw)
    a = single.nsteps(single.initial_state(), 5)
    b = port.nsteps(port.initial_state(), 5)
    rtol, atol = EQ.get(name, EQ["default"])
    np.testing.assert_allclose(port.gather_global(b), a.u.numpy(),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose([float(x) for x in b.t],
                               [float(a.t)] * S, rtol=1e-12)
    want = DGDiagnostics(system, g).compute(a)
    for got, ref in zip(port.diagnostics(b), want):
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    if kw.get("pref"):
        np.testing.assert_array_equal(port.gather_ndofel(b),
                                      a.ndofel.numpy())
        assert (a.ndofel.numpy() == 1).any()   # P0 and P1 elements both


def test_spmd_pdg_fused_limit_matches_split_route(f64, monkeypatch):
    """Sedov p-adaptive DG(P1) on S shards of a jittered box: the shards'
    fused limit + volume route and the split route (the solver built on
    the split Superbee route), three steps in lockstep, every shard's u,
    ndofel, t and dt bit for bit, with P0 and P1 elements."""
    mesh = jittered_box()
    system = DGCompFlow(tprob.SedovBlastwave())

    def solver():
        sh = build_dg_shards(mesh, S, 4, SYM, dtype=torch.float64,
                             group=ShardGroup(S, ["cpu"]))
        return SPMDDGSolver(system, sh, cfl=0.5, limiter="superbeep1",
                            pref=True)

    fused = solver()
    assert {dataclasses.astuple(sv.route) for sv in fused.shards} == {
        ("k1_pref", "k1", "k12_hllc", "charvel")}
    split_route = dataclasses.replace(fused.shards[0].route,
                                      limit="superbee_split", volume="plain")
    monkeypatch.setattr(dg_spmd, "choose_route",
                        lambda *a, **k: split_route)
    split = solver()
    assert all(sv.route == split_route for sv in split.shards)
    a = b = fused.initial_state()
    for _ in range(3):
        a, b = fused.step(a), split.step(b)
        for f in ("u", "ndofel", "t", "dt"):
            for x, y in zip(getattr(a, f), getattr(b, f)):
                assert torch.equal(x, y), f
    nd = fused.gather_ndofel(a)
    assert (nd == 1).any() and (nd == 4).any()
