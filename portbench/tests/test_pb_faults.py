"""A whole run on the CPU at a small size, past the look for a card: sound,
it comes out correct; with the timed path broken underneath (a step that
returns its state unchanged, half of the elements left out, one answer
altered where it is produced) it comes out not correct; and the control
(the reference in the precision below the configuration's, in the
program's place) comes out not correct."""

import pytest

from benchlib.harness import run_cell
from control import FAULTS, Broken

DIMS = {"sedov_dgp1.64": (6, 6, 6), "mm_sod_dgp1.64": (24, 3, 3)}
SEED = 2**31 + 101


def _run(cell, **kw):
    return run_cell(cell, SEED, 0.5, device="cpu", dims=DIMS[cell],
                    log=lambda s: None, **kw)


@pytest.mark.parametrize("cell", sorted(DIMS))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"dof_updates_per_s", "step_ms_p95", "setup_s"}


@pytest.mark.parametrize("how", FAULTS)
@pytest.mark.parametrize("cell", sorted(DIMS))
def test_broken_step_is_not_correct(cell, how):
    r = _run(cell, wrap=lambda s: Broken(s, how))
    assert not r["correct"], (how, r["checks"])


@pytest.mark.parametrize("cell", sorted(DIMS))
def test_control_is_not_correct(cell):
    from benchlib import catalog
    from benchlib.check import LOWER

    r = _run(cell, control_dtype=LOWER[catalog.cell(cell)["config"]["precision"]])
    assert not r["correct"], r["checks"]


def test_traced_run_reports_layers():
    r = _run("sedov_dgp1.64", trace=True, trace_steps=5)
    assert {"reorder_s", "build_s", "diag_ms"} <= set(r["metrics"]), r["metrics"]
    assert "busy_s" in r["device"] and "breakdown" in r
