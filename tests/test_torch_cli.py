"""The port's inciter command against quinoa_tpu's, on the CPU.

quinoa_tpu_torch.cli.main([...], device="cpu") and quinoa_tpu.cli.main
run the same deck on the same ExodusII box (written by the port), in
float64 (jax x64 from tests/conftest.py; torch's default dtype set to
float64 and restored).  Four decks: DG(P1) Sedov with HLLC and Superbee,
DiagCG + FCT SlotCyl, ALECG VorticalFlow (diagnostics at precision 14)
and multimat DG(P0) interface advection.  Checked:

- the diagnostics files row by row: it equal, t and dt rtol 1e-12, every
  norm rtol 1e-12 with an absolute floor of 1e-13 times the largest
  L2(sol) of the component's kind (Euler: density, momentum, energy;
  multimat: fractions, partial densities, momentum, energies).  A norm
  of a difference of O(scale) quantities (an L2 or Linf error, a z
  momentum that is zero but for round-off) is exact only to ulps of that
  scale;
- the field output files: the same variable names, values rtol 1e-12
  with the same floor per field;
- checkpoints across packages: a JAX checkpoint restarts the port's run
  and a port checkpoint restarts the JAX run, and the restarted rows
  equal the uninterrupted run's;
- --sync-io and the asynchronous writer give byte-equal files; -b
  writes no field output; format/precision shape the diag file;
- the options and commands once refused (--trace-dir, -H, meshconv,
  rngtest, fileconv) run; a SIGTERM drains: checkpoint, final output,
  exit 0;
- mesh refinement and tracers (AMR_DECKS): a t0ref deck, the three dtref
  branches (the multi-level cycle on DiagCG and on DG(P1), maxlevels 1,
  dtref_uniform) and --particles with and without dtref (each velocity
  source) give the JAX run's diagnostics rows (as above), the same
  t0ref and dtref lines on standard output, the same field output files
  (meshes equal, values as above) and the same .h5part steps (times rtol
  1e-12, positions atol 1e-12).
"""

import contextlib
import io
import os
import signal

import numpy as np
import pytest
import torch

from quinoa_tpu.cli import main as j_main

import quinoa_tpu_torch.io as tio
from quinoa_tpu_torch.cli import main as t_main
from quinoa_tpu_torch.mesh import box_tet_mesh

ROW_RTOL = 1e-12
FLOOR = 1e-13
NSTEP, RSFREQ = 5, 3

DECKS = {
    "dgp1_sedov": ("""
title "Sedov DG(P1)"
inciter
  nstep 5
  cfl 0.5
  scheme dgp1 flux hllc limiter superbeep1
  compflow
    physics euler problem sedov_blastwave
    material gamma 1.4 end end
    bc_sym sideset 1 2 3 4 5 6 end end
  end
  field_output interval 2 end
  diagnostics interval 1 end
end
""", (0.0, 0.0, 0.0), (0.6, 0.6, 0.4)),
    "diagcg_slotcyl": ("""
inciter
  nstep 5 cfl 0.8
  scheme diagcg
  transport physics advection problem slot_cyl depvar c
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end
  field_output interval 2 end
  diagnostics interval 1 end
end
""", (0.0, 0.0, 0.0), (1.0, 1.0, 0.5)),
    "alecg_vortical": ("""
inciter
  nstep 5 cfl 0.5
  scheme alecg
  compflow physics euler problem vortical_flow
    alpha 0.1 beta 1.0 p0 10.0
    material gamma 1.66666666666667 end end
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end
  field_output interval 2 end
  diagnostics interval 1 format scientific precision 14 end
end
""", (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)),
    "mm_p0": ("""
inciter
  nstep 5 cfl 0.4
  scheme dg
  multimat physics veleq problem interface_advection nmat 3
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end
  field_output interval 2 end
  diagnostics interval 1 end
end
""", (0.0, 0.0, 0.0), (1.0, 1.0, 0.5)),
}


@pytest.fixture
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def _port(argv):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return t_main(argv, device="cpu")
    finally:
        torch.set_default_dtype(prev)


def _inputs(d, name):
    """(deck path, mesh path) of DECKS[name] under directory d."""
    deck, lo, hi = DECKS[name]
    dp, mp = os.path.join(d, "run.q"), os.path.join(d, "box.exo")
    if not os.path.exists(mp):
        with open(dp, "w") as fh:
            fh.write(deck)
        tio.write_exodus(mp, box_tet_mesh(6, 6, 4, lo=lo, hi=hi))
    return dp, mp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per deck: the JAX run and the port's synchronous and asynchronous
    runs, NSTEP steps each with one checkpoint, at it = RSFREQ, and
    field output every 2 steps and at the end."""
    out = {}
    for name in DECKS:
        d = str(tmp_path_factory.mktemp(name))
        dp, mp = _inputs(d, name)
        for tag, fn, extra in (("jax", j_main, []),
                               ("port", _port, ["--sync-io"]),
                               ("async", _port, [])):
            base = os.path.join(d, tag)
            rc = fn(["inciter", "-c", dp, "-i", mp, "--diag", base + ".diag",
                     "-o", base, "-r", str(RSFREQ), "--checkpoint-dir",
                     base + ".ck", *extra])
            assert rc == 0, (name, tag)
        out[name] = d
    return out


def _rows(path):
    with open(path) as fh:
        return np.array([[float(x) for x in line.split()] for line in fh
                         if not line.startswith("#")])


def _kinds(name, ncomp):
    if name.startswith(("dgp1", "alecg")):
        return [[0], [1, 2, 3], [4]]
    if name.startswith("mm"):
        n = (ncomp - 3) // 3
        return [list(range(n)), list(range(n, 2 * n)),
                list(range(2 * n, 2 * n + 3)), list(range(2 * n + 3, ncomp))]
    return [[c] for c in range(ncomp)]


def _check_rows(name, got, want):
    """it equal, t and dt rtol 1e-12, norms rtol 1e-12 + FLOOR x kind
    scale."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], rtol=ROW_RTOL,
                               atol=0)
    ncomp = (want.shape[1] - 3) // 3
    scale = np.zeros((want.shape[0], ncomp))
    for kind in _kinds(name, ncomp):
        scale[:, kind] = np.abs(want[:, 3:3 + ncomp][:, kind]).max(
            axis=1, keepdims=True)
    atol = np.tile(FLOOR * scale, 3)
    err = np.abs(got[:, 3:] - want[:, 3:])
    bad = err > atol + ROW_RTOL * np.abs(want[:, 3:])
    assert not bad.any(), (name, np.argwhere(bad), got[bad], want[bad])


@pytest.mark.parametrize("name", sorted(DECKS))
def test_diag_rows_match_jax(runs, name):
    d = runs[name]
    want = _rows(os.path.join(d, "jax.diag"))
    assert want.shape[0] == NSTEP
    _check_rows(name, _rows(os.path.join(d, "port.diag")), want)
    with open(os.path.join(d, "jax.diag")) as a, \
            open(os.path.join(d, "port.diag")) as b:
        assert a.readline() == b.readline()   # the header


def _fields(path):
    names, _, nvals = tio.read_exodus_fields(path)
    enames, _, evals = tio.read_exodus_elem_fields(path)
    out = {n: nvals[-1, i] for i, n in enumerate(names)}
    out.update({n: evals[-1, i] for i, n in enumerate(enames)})
    return out


@pytest.mark.parametrize("name", sorted(DECKS))
def test_field_output_matches_jax(runs, name):
    d = runs[name]
    for it in (2, 4, NSTEP):
        want = _fields(os.path.join(d, f"jax.e-s.{it}.exo"))
        got = _fields(os.path.join(d, f"port.e-s.{it}.exo"))
        assert list(got) == list(want) and want
        for k, w in want.items():
            np.testing.assert_allclose(
                got[k], w, rtol=ROW_RTOL,
                atol=FLOOR * max(1.0, np.abs(w).max()), err_msg=k)
        jm = tio.read_exodus(os.path.join(d, f"jax.e-s.{it}.exo"))
        tm = tio.read_exodus(os.path.join(d, f"port.e-s.{it}.exo"))
        np.testing.assert_array_equal(tm.inpoel, jm.inpoel)
        np.testing.assert_array_equal(tm.coords, jm.coords)


@pytest.mark.parametrize("name", sorted(DECKS))
def test_sync_and_async_output_equal(runs, name):
    d = runs[name]
    for suffix in (".diag", ".e-s.2.exo", ".e-s.4.exo", f".e-s.{NSTEP}.exo",
                   ".ck/slot0/state.npz"):
        with open(os.path.join(d, "port" + suffix), "rb") as a, \
                open(os.path.join(d, "async" + suffix), "rb") as b:
            assert a.read() == b.read(), suffix


@pytest.mark.parametrize("name", sorted(DECKS))
def test_jax_checkpoint_restarts_port(runs, name):
    """The port restarts from the JAX run's checkpoint at it = RSFREQ and
    prints the uninterrupted JAX run's remaining rows."""
    d = runs[name]
    dp, mp = _inputs(d, name)
    out = os.path.join(d, "from_jax")
    assert _port(["inciter", "-c", dp, "-i", mp, "--diag", out + ".diag",
                  "-o", out, "--restart", os.path.join(d, "jax.ck")]) == 0
    want = _rows(os.path.join(d, "jax.diag"))[RSFREQ:]
    got = _rows(out + ".diag")
    assert got[0, 0] == RSFREQ + 1
    _check_rows(name, got, want)


@pytest.mark.parametrize("name", ["dgp1_sedov", "diagcg_slotcyl"])
def test_port_checkpoint_restarts_jax(runs, name):
    """The JAX package restarts from the port's checkpoint (a DGState and
    a CGState) and prints the port's uninterrupted rows."""
    d = runs[name]
    dp, mp = _inputs(d, name)
    out = os.path.join(d, "from_port")
    assert j_main(["inciter", "-c", dp, "-i", mp, "--diag", out + ".diag",
                   "-o", out, "--restart", os.path.join(d, "port.ck")]) == 0
    _check_rows(name, _rows(out + ".diag"),
                _rows(os.path.join(d, "port.diag"))[RSFREQ:])


def test_benchmark_mode_writes_no_field_output(tmp_path):
    dp, mp = _inputs(str(tmp_path), "diagcg_slotcyl")
    out = str(tmp_path / "bench")
    assert _port(["inciter", "-c", dp, "-i", mp, "--diag", out + ".diag",
                  "-o", out, "-b"]) == 0
    assert not list(tmp_path.glob("bench.e-s.*"))
    assert _rows(out + ".diag").shape[0] == NSTEP


def test_diag_format_precision(tmp_path):
    dp, mp = _inputs(str(tmp_path), "diagcg_slotcyl")
    with open(dp) as fh:
        deck = fh.read().replace("diagnostics interval 1 end",
                                 "diagnostics interval 2 format fixed "
                                 "precision 4 end")
    with open(dp, "w") as fh:
        fh.write(deck)
    out = str(tmp_path / "fmt")
    assert _port(["inciter", "-c", dp, "-i", mp, "--diag", out + ".diag",
                  "-o", out, "-b"]) == 0
    with open(out + ".diag") as fh:
        rows = [line.split() for line in fh if not line.startswith("#")]
    assert [r[0] for r in rows] == ["2", "4"]
    for tok in rows[0][1:]:
        assert "e" not in tok and len(tok.split(".")[1]) == 4


#: argv tails and deck edits once refused, with the word a refusal named:
#: --trace-dir runs now (the parallel options run since they were ported,
#: tests/test_torch_spmd_cli.py)
REFUSED = {
    "trace_dir": (["--trace-dir", "tr"], None, "--trace-dir"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_options_exit_2_before_any_step(tmp_path, capsys, case):
    """--trace-dir, once refused here, now runs and writes its trace."""
    tail, amr, word = REFUSED[case]
    dp, mp = _inputs(str(tmp_path), "diagcg_slotcyl")
    if amr:
        with open(dp) as fh:
            deck = fh.read().replace("  scheme diagcg", "  scheme diagcg\n  "
                                     + amr)
        with open(dp, "w") as fh:
            fh.write(deck)
    out = str(tmp_path / "r")
    if case == "trace_dir":
        tail = ["--trace-dir", str(tmp_path / "tr"), "-b"]
    rc = _port(["inciter", "-c", dp, "-i", mp, "--diag", out + ".diag",
                "-o", out, *tail])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 0 and not err
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert len(open(out + ".diag").read().splitlines()) == NSTEP + 1


@pytest.mark.parametrize("argv", [["-H"], ["inciter", "--helpkw"],
                                  ["meshconv"], ["rngtest"], ["fileconv"]])
def test_unported_commands_exit_2(tmp_path, capsys, argv):
    """The commands once refused here now run: -H prints the keyword
    list, meshconv converts a gmsh box, rngtest runs SmallCrush (seed 7,
    all pass), fileconv writes a netCDF-4 copy (walker --npes runs since
    it was ported, tests/test_torch_spmd_lb.py)."""
    src = str(tmp_path / "in.msh")
    tio.write_gmsh(src, box_tet_mesh(2, 2, 2))
    tails = {"meshconv": ["-i", src, "-o", str(tmp_path / "m.exo"), "-v"],
             "rngtest": ["--seed", "7"],
             "fileconv": ["-i", str(tmp_path / "m.exo"), "-o",
                          str(tmp_path / "f.exo"), "-v"]}
    if argv[0] == "fileconv":
        assert t_main(["meshconv", *tails["meshconv"]]) == 0
        capsys.readouterr()
    rc = t_main(argv + tails.get(argv[0], []), device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0 and not err
    first = out.splitlines()[0]
    assert {"meshconv": first.startswith(f"meshconv: {src} (gmsh) ->"),
            "rngtest": out.endswith("14/14 tests passed\n"),
            "fileconv": first.endswith("(netcdf4): 0 nodal + 0 element "
                                       "fields")}.get(
        argv[0], first.startswith("Control-file keywords"))


def test_version_license_usage_and_notes(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)   # -v writes the mesh PDFs here
    assert t_main(["--version"]) == 0
    assert capsys.readouterr().out.startswith("quinoa_tpu_torch ")
    assert t_main(["--license"]) == 0
    assert "BSD-3-Clause" in capsys.readouterr().out
    assert t_main([]) == 2 and t_main(["nope"]) == 2
    dp, mp = _inputs(str(tmp_path), "diagcg_slotcyl")
    out = str(tmp_path / "v")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    assert _port(["inciter", "-c", dp, "-i", mp, "--diag", out + ".diag",
                  "-o", out, "-b", "-v", "-l", "3", "--profile"]) == 0
    # the command leaves TF32 matmuls as torch's default has them (off)
    assert torch.backends.cuda.matmul.allow_tf32 is tf32 is False
    cap = capsys.readouterr()
    assert "--lbfreq has no effect" in cap.err
    for text in ("quinoa_tpu_torch inciter:", "mesh: ", "scheme=diagcg",
                 "it=4 ", "done: 5 steps", "timestep", "mesh read",
                 "reorder", "solver build", "diagnostics", "total",
                 "Mesh statistics: min/max/avg(ntets) = 864 / 864 / 864"):
        assert text in cap.out, text
    assert (tmp_path / "mesh_edge_pdf.txt").exists()


def test_the_card_is_the_default_device(tmp_path):
    """Without device=, the command runs on the card: with no card it
    raises before reading the mesh instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    dp, mp = _inputs(str(tmp_path), "diagcg_slotcyl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main(["inciter", "-c", dp, "-i", mp, "--diag",
                str(tmp_path / "d")])
    assert not os.path.exists(tmp_path / "d")


def test_sigterm_drains_to_a_checkpoint(tmp_path, monkeypatch, f64):
    """A SIGTERM during step 1 lets the step finish, writes a checkpoint
    and the final field output, and exits 0; --restart continues with the
    uninterrupted run's rows."""
    dp, mp = _inputs(str(tmp_path), "diagcg_slotcyl")
    full = str(tmp_path / "full")
    assert _port(["inciter", "-c", dp, "-i", mp, "--diag", full + ".diag",
                  "-o", full, "-b"]) == 0
    from quinoa_tpu_torch.inciter.diagcg import DiagCGSolver

    step = DiagCGSolver.step
    sent = []

    def step_then_term(self, state):
        if not sent:
            sent.append(1)
            # only into the command's drain handler, never the default
            # one, which would end the test process
            handler = signal.getsignal(signal.SIGTERM)
            assert type(getattr(handler, "__self__", None)).__name__ == \
                "_Preempt", handler
            signal.raise_signal(signal.SIGTERM)
        return step(self, state)

    monkeypatch.setattr(DiagCGSolver, "step", step_then_term)
    cut = str(tmp_path / "cut")
    assert t_main(["inciter", "-c", dp, "-i", mp, "--diag", cut + ".diag",
                   "-o", cut, "--checkpoint-dir", cut + ".ck"],
                  device="cpu") == 0
    assert _rows(cut + ".diag").shape[0] == 1
    assert os.path.exists(cut + ".e-s.1.exo")
    monkeypatch.setattr(DiagCGSolver, "step", step)
    rest = str(tmp_path / "rest")
    assert t_main(["inciter", "-c", dp, "-i", mp, "--diag", rest + ".diag",
                   "-o", rest, "-b", "--restart", cut + ".ck"],
                  device="cpu") == 0
    np.testing.assert_array_equal(_rows(rest + ".diag"),
                                  _rows(full + ".diag")[1:])


_SLOTCYL = """
inciter
  nstep {nstep}
  cfl 0.8
  scheme diagcg
  transport
    physics advection problem slot_cyl ncomp 1 depvar c
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end
  amr
    dtref true
    dtfreq 4
    refvar c end
    error jump
    tol_refine 0.2
    {extra}
  end
  field_output interval 4 end
  diagnostics interval 1 error l2 end
end
"""
_SEDOV = """
inciter
  nstep 5
  cfl 0.5
  scheme dgp1 flux hllc limiter superbeep1
  compflow
    physics euler problem sedov_blastwave
    material gamma 1.4 end end
    bc_sym sideset 1 2 3 4 5 6 end end
  end
  amr {amr} end
  field_output interval 2 end
  diagnostics interval 1 end
end
"""
_UNIT, _SLAB = ((0.0, 0.0, 0.0), (1.0, 1.0, 0.25)), \
    ((0.0, 0.0, 0.0), (0.6, 0.6, 0.4))
#: name -> (deck, box cells, lo, hi, extra argv); the names' prefixes
#: give _kinds the component kinds.  The DG(P1) Sedov dtref deck's
#: tol_refine fires on this box's density jumps within two steps.
AMR_DECKS = {
    "dgp1_t0ref": (_SEDOV.format(
        amr="t0ref true initial uniform initial coords coordref x- 0.3 end "
            "initial uniform_derefine"), (6, 6, 4), *_SLAB,
        ["--particles", "40"]),
    "dgp1_dtref": (_SEDOV.format(
        amr="dtref true dtfreq 2 error jump tol_refine 0.005"), (6, 6, 4),
        *_SLAB, ["--particles", "40"]),
    "diagcg_dtref": (_SLOTCYL.format(nstep=12, extra=""), (6, 6, 2),
                     *_UNIT, ["--particles", "50"]),
    "diagcg_dtref_maxlevels1": (_SLOTCYL.format(nstep=12,
                                                extra="maxlevels 1"),
                                (6, 6, 2), *_UNIT, []),
    "diagcg_dtref_uniform": (_SLOTCYL.format(nstep=9,
                                             extra="dtref_uniform true"),
                             (6, 6, 2), *_UNIT, []),
    "alecg_particles": (DECKS["alecg_vortical"][0], (6, 6, 4),
                        *DECKS["alecg_vortical"][1:], ["--particles", "30"]),
}


#: AMR deck -> (checkpoint interval, a step after its first dtref event)
REMESH_RESTART = {"diagcg_dtref_maxlevels1": 9, "dgp1_dtref": 3}


@pytest.mark.parametrize("name", sorted(REMESH_RESTART))
def test_restart_after_a_remesh_exits_2_before_any_step(tmp_path, capsys,
                                                        name):
    """A checkpoint written after a dtref event holds the refined mesh's
    fields; --restart rebuilds the solver from the input mesh, so the
    command refuses it with exit 2 and one line naming both shapes,
    before any step (DiagCG SlotCyl with maxlevels 1, dtref every 4,
    -r 9; DG(P1) Sedov with dtref every 2, -r 3)."""
    import re

    deck, n, lo, hi, _ = AMR_DECKS[name]
    dp, mp = str(tmp_path / "run.q"), str(tmp_path / "box.exo")
    with open(dp, "w") as fh:
        fh.write(deck)
    tio.write_exodus(mp, box_tet_mesh(*n, lo=lo, hi=hi))
    rs, ck = REMESH_RESTART[name], str(tmp_path / "ck")
    assert _port(["inciter", "-c", dp, "-i", mp, "--diag",
                  str(tmp_path / "a.diag"), "-o", str(tmp_path / "a"), "-b",
                  "-r", str(rs), "--checkpoint-dir", ck]) == 0
    capsys.readouterr()
    with np.load(os.path.join(ck, "slot0", "state.npz")) as data:
        written = tuple(data["u"].shape)
    rest = str(tmp_path / "rest")
    rc = _port(["inciter", "-c", dp, "-i", mp, "--diag", rest + ".diag",
                "-o", rest, "-b", "--restart", ck])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 2
    assert len(err) == 1 and "after a remesh" in err[0], err
    got, want = re.findall(r"\((\d+), (\d+)\)", err[0])
    assert tuple(map(int, got)) == written != tuple(map(int, want))
    assert not os.path.exists(rest + ".diag")   # no step, no diagnostics


def _lines(out, words=("t0ref:", "dtref @it=")):
    return [line for line in out.splitlines()
            if any(w in line for w in words)]


@pytest.fixture(scope="module")
def amr_runs(tmp_path_factory):
    """Per AMR deck: the JAX run and the port's, with -v; their standard
    output's t0ref and dtref lines.  The runs start in the deck's
    directory: the JAX command's -v writes mesh PDFs to the working
    directory."""
    out = {}
    cwd = os.getcwd()
    try:
        for name, (deck, n, lo, hi, extra) in AMR_DECKS.items():
            d = str(tmp_path_factory.mktemp(name))
            os.chdir(d)
            dp, mp = os.path.join(d, "run.q"), os.path.join(d, "box.exo")
            with open(dp, "w") as fh:
                fh.write(deck)
            tio.write_exodus(mp, box_tet_mesh(*n, lo=lo, hi=hi))
            lines = {}
            for tag, fn in (("jax", j_main), ("port", _port)):
                base = os.path.join(d, tag)
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = fn(["inciter", "-c", dp, "-i", mp, "--diag",
                             base + ".diag", "-o", base, "-v", *extra])
                assert rc == 0, (name, tag)
                lines[tag] = _lines(buf.getvalue())
            out[name] = (d, lines)
    finally:
        os.chdir(cwd)
    return out


@pytest.mark.parametrize("name", sorted(AMR_DECKS))
def test_amr_diag_rows_and_remesh_lines_match_jax(amr_runs, name):
    d, lines = amr_runs[name]
    assert lines["port"] == lines["jax"]
    if "dtref" in name:
        assert len(lines["jax"]) >= 2, lines["jax"]
    if "t0ref" in name:
        assert lines["jax"] and "t0ref:" in lines["jax"][0]
    want = _rows(os.path.join(d, "jax.diag"))
    nstep = int(AMR_DECKS[name][0].split("nstep")[1].split()[0])
    assert want.shape[0] == nstep
    _check_rows(name, _rows(os.path.join(d, "port.diag")), want)


@pytest.mark.parametrize("name", sorted(AMR_DECKS))
def test_amr_field_output_matches_jax(amr_runs, name):
    d, _ = amr_runs[name]
    files = sorted(f[len("jax"):] for f in os.listdir(d)
                   if f.startswith("jax.e-s."))
    assert files and files == sorted(f[len("port"):] for f in os.listdir(d)
                                     if f.startswith("port.e-s."))
    for suffix in files:
        want = _fields(os.path.join(d, "jax" + suffix))
        got = _fields(os.path.join(d, "port" + suffix))
        assert list(got) == list(want) and want
        for k, w in want.items():
            np.testing.assert_allclose(
                got[k], w, rtol=ROW_RTOL,
                atol=FLOOR * max(1.0, np.abs(w).max()), err_msg=k)
        jm = tio.read_exodus(os.path.join(d, "jax" + suffix))
        tm = tio.read_exodus(os.path.join(d, "port" + suffix))
        np.testing.assert_array_equal(tm.inpoel, jm.inpoel)
        np.testing.assert_array_equal(tm.coords, jm.coords)


@pytest.mark.parametrize("name", sorted(k for k in AMR_DECKS
                                        if "--particles" in AMR_DECKS[k][4]))
def test_particles_h5part_matches_jax(amr_runs, name):
    """The same H5Part steps: one at the start and one at each field
    output, their times, and the tracers' positions, some of which
    moved."""
    import h5py

    d, _ = amr_runs[name]
    with h5py.File(os.path.join(d, "jax.h5part"), "r") as fj, \
            h5py.File(os.path.join(d, "port.h5part"), "r") as ft:
        assert list(ft) == list(fj) and len(fj) >= 3
        moved = 0.0
        for step in fj:
            np.testing.assert_allclose(ft[step].attrs["TimeValue"],
                                       fj[step].attrs["TimeValue"],
                                       rtol=ROW_RTOL, atol=0)
            for c in "xyz":
                assert ft[step][c].dtype == np.float64
                np.testing.assert_allclose(ft[step][c][:], fj[step][c][:],
                                           rtol=0, atol=1e-12)
                moved = max(moved, float(np.abs(
                    fj[step][c][:] - fj["Step#0"][c][:]).max()))
        assert moved > 1e-6, moved


def test_particles_refuse_other_pdes(tmp_path):
    """--particles on a multimat deck ends with the JAX CLI's message."""
    dp, mp = _inputs(str(tmp_path), "mm_p0")
    with pytest.raises(SystemExit, match="transport and compflow"):
        _port(["inciter", "-c", dp, "-i", mp, "--diag",
               str(tmp_path / "x.diag"), "-o", str(tmp_path / "x"),
               "--particles", "5"])
