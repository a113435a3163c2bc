"""The port's tracer (quinoa_tpu_torch/base/profiler.py) on the CPU: spans
nest with their parents, self times and step numbers; off, a span is the
shared no-op and nothing is recorded; the solvers' steps are bit for bit
the same with tracing on and off and record the spans of their stages;
sharded steps in lockstep keep their spans nested and close each before a
yield; host_syncs goes to the innermost span; --profile prints the nested
table and the counters; --trace-dir's trace holds the program's spans in
the profiler's time range."""

import contextlib
import io
import json
import time

import pytest
import torch

import quinoa_tpu_torch.io as tio
from quinoa_tpu_torch.base import profiler
from quinoa_tpu_torch.base.profiler import (PhaseProfiler, count, span,
                                            tracing)
from quinoa_tpu_torch.cli import main as t_main
from quinoa_tpu_torch.inciter.dg import DGDiagnostics, DGSolver
from quinoa_tpu_torch.mesh import box_tet_mesh, hilbert_element_reorder
from quinoa_tpu_torch.pde.dg import BC_EXTRAPOLATE, BC_SYMMETRY, build_dggeom
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow
from quinoa_tpu_torch.pde.multimat import MultiMatSolver, MultiMatSystem
from quinoa_tpu_torch.pde.problems import MMSodShocktube, SedovBlastwave

SYM = {i: BC_SYMMETRY for i in range(1, 7)}
SOD = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
       **{i: BC_SYMMETRY for i in range(3, 7)}}
#: the spans each solver's P1 step opens under `step`
SEDOV_SPANS = {"limit", "face_pass", "dt", "rk_update"}
MM_SPANS = {"limit", "volume", "face_pass", "dt", "rk_update"}
PDG_SPANS = SEDOV_SPANS | {"pref"}


@pytest.fixture
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def _spin(s):
    t = time.perf_counter() + s
    while time.perf_counter() < t:
        pass


def _sedov(pref=False):
    mesh, _ = hilbert_element_reorder(box_tet_mesh(4, 4, 3,
                                                   hi=(0.4, 0.4, 0.3)))
    g = build_dggeom(mesh, 4, SYM, dtype=torch.float64, device="cpu")
    return DGSolver(DGCompFlow(SedovBlastwave()), g, cfl=0.5,
                    limiter="superbeep1", pref=pref)


def _solver(which):
    return {"sedov": _sedov, "multimat": _mm,
            "pdg": lambda: _sedov(pref=True)}[which]()


def _mm():
    mesh, _ = hilbert_element_reorder(box_tet_mesh(12, 2, 2,
                                                   hi=(1.0, 0.125, 0.125)))
    g = build_dggeom(mesh, 4, SOD, dtype=torch.float64, device="cpu")
    return MultiMatSolver(MultiMatSystem(MMSodShocktube()), g, cfl=0.5,
                          limiter="superbeep1")


def _well_nested(prof):
    """Every record lies inside its parent, and siblings do not
    overlap."""
    recs = prof.records
    kids = {}
    for i, (name, parent, a, b, _) in enumerate(recs):
        assert 0 < a <= b, (name, a, b)
        if parent >= 0:
            pa, pb = recs[parent][2], recs[parent][3]
            assert pa <= a and b <= pb, (name, recs[parent][0])
        kids.setdefault(parent, []).append((a, b))
    for iv in kids.values():
        iv.sort()
        for (_, b0), (a1, _) in zip(iv, iv[1:]):
            assert b0 <= a1


def _children(prof, parent_name):
    recs = prof.records
    return {r[0] for r in recs
            if r[1] >= 0 and recs[r[1]][0] == parent_name}


def test_spans_nest_with_parent_self_time_and_step_numbers():
    prof = PhaseProfiler()
    with tracing(prof):
        with span("setup"):
            _spin(0.002)
        for _ in range(2):
            with span("step"):
                with span("a"):
                    _spin(0.004)
                    with span("b"):
                        _spin(0.003)
                with span("a"):
                    pass
            with span("diag"):
                pass
    names = [r[0] for r in prof.records]
    assert names == ["setup", "step", "a", "b", "a", "diag",
                     "step", "a", "b", "a", "diag"]
    # parents, and the step each span belongs to
    assert [r[1] for r in prof.records] == [-1, -1, 1, 2, 1, -1,
                                            -1, 6, 7, 6, -1]
    assert [r[4] for r in prof.records] == [0, 1, 1, 1, 1, 1,
                                            2, 2, 2, 2, 2]
    _well_nested(prof)
    t = {p: (s, ss, n) for p, s, ss, n in prof.times()}
    assert [p for p, *_ in prof.times()] == [
        ("setup",), ("step",), ("step", "a"), ("step", "a", "b"),
        ("diag",)]
    s_a, self_a, n_a = t[("step", "a")]
    s_b = t[("step", "a", "b")][0]
    assert n_a == 4 and t[("step",)][2] == 2
    assert s_b >= 0.006 and s_a >= 0.014
    assert self_a == pytest.approx(s_a - s_b, abs=1e-9)
    s_step, self_step, _ = t[("step",)]
    assert self_step == pytest.approx(s_step - s_a, abs=1e-9)
    assert profiler._TRACER is None


def test_off_is_the_shared_no_op_and_records_nothing(monkeypatch):
    prof = PhaseProfiler()
    assert profiler._TRACER is None
    a, b = span("step"), span("limit")
    assert a is b is profiler._NULL

    def trap(*_):
        raise AssertionError("read while tracing is off")

    # off: no clock reading, no record_function range
    monkeypatch.setattr(profiler.time, "perf_counter_ns", trap)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", trap)
    with span("step"):
        count("host_syncs")
        with span("limit"):
            count("host_syncs", 3)
    monkeypatch.undo()
    assert prof.records == [] and prof.counters == {}
    assert prof.times() == [] and prof.step == 0


def test_spans_must_nest():
    prof = PhaseProfiler()
    a, b = prof.phase("a"), prof.phase("b")
    a.__enter__()
    b.__enter__()
    with pytest.raises(RuntimeError, match="must nest"):
        a.__exit__(None, None, None)


def test_record_bound_keeps_the_table(monkeypatch):
    monkeypatch.setattr(PhaseProfiler, "MAX_RECORDS", 3)
    prof = PhaseProfiler()
    for _ in range(5):
        with prof.phase("step"):
            pass
    assert len(prof.records) == 3 and prof.dropped == 2
    assert prof.times()[0][3] == 5 and prof.step == 5


@pytest.mark.parametrize("which", ["sedov", "multimat", "pdg"])
def test_step_bit_identical_with_tracing_and_its_spans(f64, which):
    solver = _solver(which)
    s0 = solver.initial_state()
    off = solver.nsteps(s0, 2)
    prof = PhaseProfiler()
    with tracing(prof):
        on = solver.nsteps(s0, 2)
    for f in ("u", "t", "dt", "it", "ndofel"):
        assert torch.equal(getattr(off, f), getattr(on, f)), f
    _well_nested(prof)
    assert prof.step == 2
    assert {r[0] for r in prof.records if r[1] < 0} == {"step"}
    assert _children(prof, "step") == {"sedov": SEDOV_SPANS,
                                       "multimat": MM_SPANS,
                                       "pdg": PDG_SPANS}[which]
    if which == "pdg":
        # pref holds the indicator, the promotion and the dofmask of each
        # stage; the fused limiter writes the masked state with its volume
        # term, so limit has no split-route children and the step no
        # volume span
        assert _children(prof, "pref") == {"pref.eval", "pref.propagate",
                                           "pref.mask"}
        assert _children(prof, "limit") == set()
        n = {k: sum(1 for r in prof.records if r[0] == k)
             for k in ("pref.eval", "pref.propagate", "pref.mask",
                       "limit.bounds", "limit.superbee")}
        assert n == {"pref.eval": 2, "pref.propagate": 2, "pref.mask": 6,
                     "limit.bounds": 0, "limit.superbee": 0}
    # each stage limits, updates; the stage-0 dt once a step
    n = {k: sum(1 for r in prof.records if r[0] == k)
         for k in ("limit", "dt", "rk_update")}
    assert n == {"limit": 6, "dt": 2, "rk_update": 6}
    # no step syncs: the volume pass reads its tables from the geometry
    assert {p[-1]: v for (c, p), v in prof.counters.items()} == {}


@pytest.mark.parametrize("which", ["sedov", "multimat", "pdg"])
def test_diagnostics_syncs_go_to_the_innermost_span(f64, which):
    """The same syncs a row on every path; on the p-adaptive one the
    mixed P0/P1 test's one read also gives pref_p0_elements."""
    solver = _solver(which)
    st = solver.nsteps(solver.initial_state(), 1)
    diag = DGDiagnostics(solver.system, solver.geom)
    rows = diag.compute(st)
    prof = PhaseProfiler()
    with tracing(prof):
        assert diag.compute(st) == rows
    C = solver.system.ncomp
    G = len(diag.w)
    want = {("host_syncs", ("diag", "diag.read")): 3 * C,
            ("host_syncs", ("diag", "diag.sums")): 1 + 2 * G}
    n0 = int((st.ndofel == 1).sum())
    if which == "pdg":
        assert 0 < n0 < solver.geom.nelem
        want[("pref_p0_elements", ("diag", "diag.sums"))] = n0
    assert prof.counters == want
    assert prof.counter("host_syncs") == 3 * C + 1 + 2 * G
    assert prof.counter("pref_p0_elements") == n0


def test_planted_site_counts_in_the_innermost_span():
    prof = PhaseProfiler()
    with tracing(prof):
        count("host_syncs")
        with span("outer"):
            with span("inner"):
                count("host_syncs", 2)
            count("host_syncs")
            count("kernels_built")
    assert prof.counters == {
        ("host_syncs", ()): 1, ("host_syncs", ("outer", "inner")): 2,
        ("host_syncs", ("outer",)): 1, ("kernels_built", ("outer",)): 1}
    assert prof.counter("host_syncs") == 4


def test_spmd_step_spans_nested_and_closed_at_every_yield(f64, monkeypatch):
    """Two shards in lockstep: each shard's coroutine has no span open
    when it yields, and the records of the step nest."""
    from quinoa_tpu_torch.parallel import (SPMDDGSolver, ShardGroup,
                                           build_dg_shards, dg_spmd)

    mesh = box_tet_mesh(4, 4, 3, hi=(0.4, 0.4, 0.3))
    sh = build_dg_shards(mesh, 2, 4, {i: 2 for i in range(1, 7)},
                         dtype=torch.float64, group=ShardGroup(2, ["cpu"]))
    solver = SPMDDGSolver(DGCompFlow(SedovBlastwave()), sh, cfl=0.5,
                          limiter="superbeep1")
    prof = PhaseProfiler()
    yields = []

    def checked(gen):
        depth = len(prof._stack)
        req = next(gen)
        while True:
            yields.append(len(prof._stack) - depth)
            try:
                req = gen.send((yield req))
            except StopIteration as e:
                return e.value

    run = dg_spmd.run_lockstep
    monkeypatch.setattr(dg_spmd, "run_lockstep",
                        lambda gens, answer: run([checked(g) for g in gens],
                                                 answer))
    s0 = solver.initial_state()
    off = solver.step(s0)
    yields.clear()
    with tracing(prof):
        on = solver.step(s0)
    assert all(torch.equal(a, b) for a, b in zip(off.u, on.u))
    assert yields and set(yields) == {0}
    _well_nested(prof)
    top = [r for r in prof.records if r[1] < 0]
    assert [r[0] for r in top] == ["step"]
    assert _children(prof, "step") == SEDOV_SPANS
    # both shards limit in each of the three stages
    assert sum(1 for r in prof.records if r[0] == "limit") == 6


DECK = """inciter
  nstep 3
  cfl 0.5
  scheme dgp1 flux hllc limiter superbeep1
  compflow
    physics euler problem sedov_blastwave
    material gamma 1.4 end end
    bc_sym sideset 1 2 3 4 5 6 end end
  end
  diagnostics interval 1 end
end
"""


def _cli(tmp_path, *extra):
    deck, mp = tmp_path / "run.q", str(tmp_path / "box.exo")
    deck.write_text(DECK)
    tio.write_exodus(mp, box_tet_mesh(4, 4, 3, hi=(0.4, 0.4, 0.3)))
    out = io.StringIO()
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with contextlib.redirect_stdout(out):
            rc = t_main(["inciter", "-c", str(deck), "-i", mp, "-b",
                         "--diag", str(tmp_path / "diag"), *extra],
                        device="cpu")
    finally:
        torch.set_default_dtype(prev)
    assert rc == 0 and profiler._TRACER is None
    return out.getvalue()


def test_profile_prints_the_nested_table_and_counters(tmp_path):
    text = _cli(tmp_path, "--profile")
    lines = text.splitlines()
    head = lines.index(next(ln for ln in lines if ln.startswith("phase")))
    assert lines[head].split() == ["phase", "sec", "self", "%", "n"]
    rows = {ln.strip().split()[0]: ln for ln in lines[head + 1:]}
    for name in ("mesh", "reorder", "solver", "timestep", "diagnostics",
                 "(untimed)", "total"):
        assert name in rows, name
    # the program's spans, indented under the command's phases
    assert any(ln.startswith("  step ") for ln in lines)
    for name in ("limit", "face_pass", "dt", "rk_update"):
        assert any(ln.startswith(f"    {name} ") for ln in lines), name
    for name in ("build", "initial_state", "diag", "diag.write"):
        assert any(ln.startswith(f"  {name} ") for ln in lines), name
    assert any(ln.startswith("    geometry ") for ln in lines)
    step = next(ln for ln in lines if ln.startswith("  step ")).split()
    assert step[-1] == "3" and float(step[2]) <= float(step[1])
    # 3 diagnostics rows of Sedov's 5 components: 24 syncs each
    assert "host_syncs: 72 (diagnostics/diag/diag.read 45, " \
           "diagnostics/diag/diag.sums 27)" in text


def test_trace_dir_holds_the_program_spans_in_the_profiler_range(tmp_path):
    _cli(tmp_path, "--trace-dir", str(tmp_path / "tr"))
    with open(tmp_path / "tr" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    ours = [e for e in events if e.get("tid") == profiler.SPAN_TRACK
            and e.get("ph") == "X"]
    theirs = [e for e in events if e.get("tid") != profiler.SPAN_TRACK
              and e.get("ph") == "X"]
    assert {e["name"] for e in ours} >= {"step", "limit", "face_pass",
                                         "rk_update", "diag"}
    assert sum(e["name"] == "step" for e in ours) == 3
    lo = min(e["ts"] for e in theirs)
    hi = max(e["ts"] + e["dur"] for e in theirs)
    for e in ours:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, e
    # the spans lie over the operators they ran: a step holds aten ops
    step = next(e for e in ours if e["name"] == "step")
    assert any(e["name"].startswith("aten::")
               and step["ts"] <= e["ts"] <= step["ts"] + step["dur"]
               for e in theirs)
