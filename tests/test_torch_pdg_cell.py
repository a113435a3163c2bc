"""The benchmark's p-adaptive cell sedov_pdg.64 on the CPU at a small size:
its plain reference (portbench/configs/sedov_pdg/reference.py) follows the
port's p-adaptive DG(P1) step (the same element order, dof counts, states
to round-off and time steps), one reference step from the port's state,
with the dof counts rebuilt from u, is the port's step, and a whole run
through the benchmark's harness comes out correct, while each planted
fault, the float32 control and a port with the one-ring promotion left
out come out not correct."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PORTBENCH = os.path.join(REPO, "portbench")
if PORTBENCH not in sys.path:
    sys.path.insert(0, PORTBENCH)

from benchlib import catalog, meshgen  # noqa: E402
from benchlib.harness import _mesh  # noqa: E402

CELL = "sedov_pdg.64"
DIMS = (6, 6, 6)
SEED = 2**31 + 101


@pytest.fixture
def float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _pair(dims=(6, 6, 5), seed=2**31 + 17):
    """(port solver, reference solver, element order) of the configuration
    on a small jittered box."""
    from quinoa_tpu_torch.control.config import build_inciter, load_inciter
    from quinoa_tpu_torch.mesh.reorder import hilbert_element_reorder

    cfg = catalog.config("sedov_pdg")
    mesh = meshgen.box(dims, cfg["lo"], cfg["hi"], 0.1, seed)
    pmesh, eorder = hilbert_element_reorder(_mesh(torch, mesh))
    solver, _ = build_inciter(load_inciter(cfg["deck_text"]), pmesh,
                              device="cpu")
    ref = catalog.config_module(cfg, "reference")
    return solver, ref, ref.make(cfg["deck_text"], mesh, "cpu", "float64"), \
        eorder


def _ndofel(refmod, ref, u):
    """The reference's dof counts of the step from u (4 at P1, 1 at P0)."""
    C = ref.system.ncomp
    p1 = refmod.promote(ref.g, refmod.at_p1(u, C)
                        & refmod.indicator(ref.g, u, C, ref.tol))
    return torch.where(p1, 4, 1).to(torch.int32)


def _row_gap(prog, ref):
    scale = ref.abs().amax(dim=1, keepdim=True)
    return float(((prog - ref).abs() / scale).max())


def test_reference_follows_the_port(float64):
    solver, refmod, ref, eorder = _pair()
    assert solver.pref and solver.tolref == ref.tol == 0.1
    assert np.array_equal(ref.eorder, eorder)
    st, rs = solver.initial_state(), ref.initial_state()
    assert torch.allclose(st.u, rs.u, rtol=0,
                          atol=1e-12 * float(rs.u.abs().max()))
    C, K = solver.system.ncomp, solver.geom.ndof
    seen = set()
    for _ in range(5):
        nd = _ndofel(refmod, ref, rs.u)
        st, rs = solver.step(st), ref.step(rs)
        assert torch.equal(st.ndofel, nd)
        # both zero the slopes of the elements at P0
        for u in (st.u, rs.u):
            assert bool((u.reshape(C, K, -1)[:, 1:, nd == 1] == 0).all())
        seen |= set(st.ndofel.unique().tolist())
        assert _row_gap(st.u, rs.u) < 1e-10
        assert abs(float(st.dt) - rs.dt) <= 1e-13 * rs.dt
    assert seen == {1, 4}
    assert {1, 4} <= set(st.ndofel.unique().tolist())


def test_reference_step_from_the_port_state(float64):
    """The reference rebuilds the dof counts from u alone: a step from the
    port's state (its counts dropped) is the port's step."""
    solver, refmod, ref, _ = _pair()
    st = solver.nsteps(solver.initial_state(), 4)
    # a P0 element of the port ends its step with its slopes exactly zero
    C, K = solver.system.ncomp, solver.geom.ndof
    slopes = st.u.reshape(C, K, -1)[:, 1:]
    assert bool((slopes[:, :, st.ndofel == 1] == 0).all())
    nd = _ndofel(refmod, ref, st.u)
    nxt = solver.step(st)
    rs = ref.step(refmod.dg.State(u=st.u.clone(), t=float(st.t), dt=0.0))
    assert torch.equal(nxt.ndofel, nd)
    assert (nd == 1).any() and (nd == 4).any()
    assert _row_gap(nxt.u, rs.u) < 1e-10
    assert abs(float(nxt.dt) - rs.dt) <= 1e-13 * rs.dt


def test_reference_refuses_other_decks():
    cfg = catalog.config("sedov_pdg")
    ref = catalog.config_module(cfg, "reference")
    mesh = meshgen.box((2, 2, 2), cfg["lo"], cfg["hi"], 0.1, 3)
    for a, b in (("scheme pdg", "scheme dgp1"),
                 ("limiter superbeep1", "limiter wenop1"),
                 ("flux hllc", "flux laxfriedrichs")):
        with pytest.raises(ValueError, match="pdg"):
            ref.make(cfg["deck_text"].replace(a, b), mesh, "cpu", "float64")
    assert ref.tolref(cfg["deck_text"]) == 0.1
    assert ref.tolref(cfg["deck_text"].replace(
        "inciter\n", "inciter\n  pref tolref 0.25 end\n", 1)) == 0.25


#: the whole runs: the sound program, the planted faults of
#: portbench/control.py, the float32 control, and the port with its ring
#: promotion left out
RUNS = ("sound", "unchanged", "half", "altered", "float32", "no_promotion")

_SCRIPT = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from benchlib.harness import run_cell
from control import Broken

for how in sys.argv[3].split(","):
    kw = {}
    if how in ("unchanged", "half", "altered"):
        kw["wrap"] = lambda s, how=how: Broken(s, how)
    elif how == "float32":
        kw["control_dtype"] = "float32"
    elif how == "no_promotion":
        import quinoa_tpu_torch.inciter.dg as dg
        dg.propagate_ndof = lambda geom, ndofel: ndofel
    r = run_cell(%r, %d, 0.5, device="cpu", dims=%r, log=lambda s: None,
                 **kw)
    print(json.dumps({"how": how, "correct": r["correct"],
                      "checks": r["checks"], "steps": r["attempted"],
                      "metrics": sorted(r["metrics"])}), flush=True)
""" % (CELL, SEED, DIMS)


@pytest.fixture(scope="module")
def runs():
    """{run: result line} of one process with no JAX loaded (the harness
    refuses a run that ends with JAX or the JAX package among the loaded
    modules, and the test suite's conftest loads JAX)."""
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, PORTBENCH, REPO, ",".join(RUNS)],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return {r["how"]: r for r in map(json.loads, out.stdout.splitlines())}


def test_sound_run_is_correct(runs):
    r = runs["sound"]
    assert r["correct"], r["checks"]
    assert r["metrics"] == ["dof_updates_per_s", "setup_s", "step_ms_p95"]
    assert set(r["checks"]) == {"element_map", "init_gap", "start_gap",
                                "end_gap"}


@pytest.mark.parametrize("how", RUNS[1:])
def test_fault_control_and_missing_promotion_are_not_correct(runs, how):
    r = runs[how]
    assert not r["correct"], (how, r["checks"])
    assert r["steps"] >= 1
