"""The port's walker command against quinoa_tpu's, on the CPU.

quinoa_tpu_torch.cli.main(["walker", ...], device="cpu") and
quinoa_tpu.cli.main run the same deck with the same seed, each in its
own working directory (the commands write PDFs there), in float64 (jax
x64 from tests/conftest.py; torch's default dtype set to float64 and
restored).  The stat files agree at the printed precision (a row's
values to one unit in their last printed digit), the txt PDFs of the
same runs likewise and with the same bins, and the PDF files of the
gmsh and exodus output types exist with the same names.  The decks are
the inline decks of tests/test_walker.py (the rng-seed deck at two
seeds, the PDF-options deck) and a coupled Position + Velocity +
Dissipation deck with three moment orders.  The configs loaded from the
decks are the JAX package's, field for field.  (walker --npes runs since
it was ported: tests/test_torch_spmd_lb.py.)

The port builds a deck's SDE systems in deck order, the same in every
process.  The JAX package builds them in the order it iterates the set
quinoa_tpu.control.qparser._SDE_BLOCKS, which changes with the hash
seed; the order fixes each system's offset and key, so the JAX side of
a comparison runs with that set swapped for the port's order
(``_jax_in_deck_order``).  Nothing in the JAX package changes.
"""

import contextlib
import dataclasses
import glob
import io
import os

import numpy as np
import pytest
import torch

from quinoa_tpu.cli import main as j_main
from quinoa_tpu.control.config import load_walker as j_load

from quinoa_tpu_torch.cli import main as t_main
from quinoa_tpu_torch.control.config import load_walker as t_load
from quinoa_tpu_torch.control.qparser import _SDE_BLOCKS, parse_deck

#: tests/test_walker.py:238-250, at its seeds
SEED_DECK = """
walker
  term 0.05  dt 0.01  npar 200
  rngs  r123_philox seed %d end  end
  diag_ou
    depvar o  ncomp 2  init zero  coeff const
    sigmasq 0.25 1.0 end  theta 1.0 1.0 end  mu 0.0 1.5 end
  end
  statistics interval 1 <o1o1> end
end
"""
#: tests/test_walker.py:295-317
PDF_DECK = """
walker
  term 0.02  dt 0.01  npar 500  ttyi 10
  rngs r123_threefry end end
  diag_ou
    depvar o  ncomp 2  init zero  coeff const
    sigmasq 0.25 1.0 end  theta 1.0 1.0 end  mu 0.0 1.5 end
    rng r123_threefry
  end
  statistics interval 1 <o1o1> end
  pdfs
    interval 2
    filetype txt
    format scientific
    precision 4
    policy multiple
    p1( o1 : 0.2 ; -2 2 )
  end
end
"""
LANGEVIN_DECK = """
title "coupled Langevin family"
walker
  nstep 12  term 1.0  dt 0.005  npar 700  ttyi 4
  rngs r123_threefry seed 3 end end
  position
    depvar x  velocity u  init jointgaussian  coeff const_shear
    icgaussian gaussian 0.0 1.0 end gaussian 0.0 1.0 end
               gaussian 0.0 1.0 end end
  end
  velocity
    depvar u  dissipation o  init jointgaussian  coeff const_shear
    icgaussian gaussian 0.0 0.5 end gaussian 0.0 0.5 end
               gaussian 0.0 0.5 end end
  end
  dissipation
    depvar o  velocity u  init jointgaussian  coeff const_coeff
    icgaussian gaussian 1.0 0.01 end end
  end
  statistics
    interval 3 format scientific precision 10
    <U1> <U2> <O> <u1u1> <u1u2> <u2u2> <o1o1> <x1u1> <u1u1u1>
  end
  pdfs
    interval 6 filetype %s
    %s
  end
end
"""
_ALL_PDFS = """f1( U1 : 0.05 )
    f2( u1 u2 : 0.1 0.1 )
    f3( X1 X2 O1 : 0.5 0.5 0.05 ; -4 4 -4 4 0 2 )"""
DECKS = {"seed1": SEED_DECK % 1, "seed2": SEED_DECK % 2, "pdf": PDF_DECK,
         "langevin": LANGEVIN_DECK % ("txt", _ALL_PDFS)}
#: the gmsh and exodus PDF output types (gmsh writes bi-variate PDFs)
FILETYPES = {"langevin_gmsh": LANGEVIN_DECK % ("gmshtxt",
                                               "f2( u1 u2 : 0.1 0.1 )"),
             "langevin_exodus": LANGEVIN_DECK % ("exodusii", _ALL_PDFS)}


#: the coupled Langevin deck with its blocks in the reverse order
REVERSED_DECK = """
walker
  nstep 4  term 1.0  dt 0.005  npar 300
  rngs r123_threefry seed 3 end end
  dissipation
    depvar o  velocity u  init jointgaussian  coeff const_coeff
    icgaussian gaussian 1.0 0.01 end end
  end
  velocity
    depvar u  dissipation o  init jointgaussian  coeff const_shear
    icgaussian gaussian 0.0 0.5 end gaussian 0.0 0.5 end
               gaussian 0.0 0.5 end end
  end
  position
    depvar x  velocity u  init jointgaussian  coeff const_shear
    icgaussian gaussian 0.0 1.0 end gaussian 0.0 1.0 end
               gaussian 0.0 1.0 end end
  end
  statistics
    interval 1 format scientific precision 10
    <U1> <O> <u1u1> <o1o1> <x1u1>
  end
end
"""


def _deck_order(deck):
    """The SDE block kinds of a deck in the port's order."""
    return [k for k in parse_deck(deck)["walker"][0] if k in _SDE_BLOCKS]


@contextlib.contextmanager
def _jax_in_deck_order(deck):
    """The JAX package's load_walker iterates a dict of the block kinds in
    the port's order in place of its set (membership is unchanged)."""
    import quinoa_tpu.control.qparser as jq

    saved, order = jq._SDE_BLOCKS, _deck_order(deck)
    jq._SDE_BLOCKS = dict.fromkeys(order + sorted(saved - set(order)))
    try:
        yield
    finally:
        jq._SDE_BLOCKS = saved


def _port(argv):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return t_main(argv, device="cpu")
    finally:
        torch.set_default_dtype(prev)


def _in_dir(d, fn, argv):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = fn(argv)
        return rc, out.getvalue()
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per deck: {'jax': dir, 'port': dir} of the two commands' runs (-v),
    and their standard output."""
    out = {}
    for name, deck in {**DECKS, **FILETYPES}.items():
        res = {}
        for tag, fn in (("jax", j_main), ("port", _port)):
            d = str(tmp_path_factory.mktemp(f"{name}_{tag}"))
            with open(os.path.join(d, "w.q"), "w") as fh:
                fh.write(deck)
            with _jax_in_deck_order(deck):
                rc, text = _in_dir(d, fn, ["walker", "-c", "w.q", "--stat",
                                           "stat.txt", "-v"])
            assert rc == 0, (name, tag)
            res[tag] = (d, text)
        out[name] = res
    return out


def _table(path):
    """(header lines, rows of token lists) of a stat or txt PDF file."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    head = [ln for ln in lines if ln.startswith("#")]
    rows = [ln.split() for ln in lines if ln and not ln.startswith("#")]
    return head, rows


def _same_at_printed_precision(a, b):
    """Equal token lists, numbers to one unit in their last printed
    digit."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x == y:
            continue
        mant = x.lower().split("e")[0]
        digits = len(mant.split(".")[1]) if "." in mant else 0
        exp = int(x.lower().split("e")[1]) if "e" in x.lower() else 0
        assert abs(float(x) - float(y)) <= 1.0001 * 10.0 ** (exp - digits), \
            (x, y)


@pytest.mark.parametrize("name", sorted(DECKS))
def test_stat_file_matches_jax(runs, name):
    (jd, _), (td, _) = runs[name]["jax"], runs[name]["port"]
    jh, jrows = _table(os.path.join(jd, "stat.txt"))
    th, trows = _table(os.path.join(td, "stat.txt"))
    assert th == jh and len(trows) == len(jrows) > 1
    for a, b in zip(trows, jrows):
        assert a[0] == b[0]
        _same_at_printed_precision(a, b)


def test_deck_seed_matters(runs):
    rows = {s: _table(os.path.join(runs[s]["port"][0], "stat.txt"))[1]
            for s in ("seed1", "seed2")}
    assert rows["seed1"] != rows["seed2"]


@pytest.mark.parametrize("name", ["pdf", "langevin"])
def test_txt_pdfs_match_jax(runs, name):
    (jd, _), (td, _) = runs[name]["jax"], runs[name]["port"]
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(jd, "*.txt")))
    assert names == sorted(os.path.basename(p)
                           for p in glob.glob(os.path.join(td, "*.txt")))
    pdfs = [n for n in names if n != "stat.txt"]
    assert pdfs
    for n in names:
        jh, jrows = _table(os.path.join(jd, n))
        th, trows = _table(os.path.join(td, n))
        assert th == jh and len(trows) == len(jrows), n
        for a, b in zip(trows, jrows):
            _same_at_printed_precision(a, b)
    if name == "pdf":   # precision 4, policy multiple
        assert pdfs == ["p1_0.02.txt"]
        tok = _table(os.path.join(td, pdfs[0]))[1][0][0]
        assert len(tok.split("e")[0].split(".")[1]) == 4


@pytest.mark.parametrize("name", sorted(FILETYPES))
def test_other_pdf_types_write_the_same_files(runs, name):
    (jd, _), (td, _) = runs[name]["jax"], runs[name]["port"]
    ext = ".msh" if "gmsh" in name else ".exo"
    jf = sorted(os.path.basename(p) for p in glob.glob(jd + "/*" + ext))
    assert jf and jf == sorted(os.path.basename(p)
                               for p in glob.glob(td + "/*" + ext))
    if ext == ".exo":
        from scipy.io import netcdf_file

        for n in jf:
            with netcdf_file(os.path.join(jd, n), "r", mmap=False) as a, \
                    netcdf_file(os.path.join(td, n), "r", mmap=False) as b:
                assert a.variables.keys() == b.variables.keys()
                for v in ("coordx", "coordy", "coordz"):
                    np.testing.assert_array_equal(b.variables[v][:],
                                                  a.variables[v][:])


def test_verbose_lines_match_jax(runs):
    (_, jt), (_, tt) = runs["langevin"]["jax"], runs["langevin"]["port"]
    jl, tl = jt.splitlines(), tt.splitlines()
    assert tl[0] == jl[0].replace("quinoa_tpu walker", "quinoa_tpu_torch "
                                  "walker")
    assert tl[1:] == jl[1:] and any("it=12" in ln for ln in tl)


@pytest.mark.parametrize("name", sorted(DECKS))
def test_config_is_the_jax_config(name):
    with _jax_in_deck_order(DECKS[name]):
        j = j_load(DECKS[name])
    t = t_load(DECKS[name])
    for f in dataclasses.fields(j):
        if f.name != "sdes":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert [type(s).__name__ for s in t.sdes] == \
        [type(s).__name__ for s in j.sdes]
    for a, b in zip(t.sdes, j.sdes):
        for f in dataclasses.fields(b):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        for attr in ("_couple_velocity", "_couple_dissipation"):
            assert getattr(a, attr, None) == getattr(b, attr, None)


_ORDER_SCRIPT = """
import sys
from quinoa_tpu_torch.control.config import load_walker
for path in sys.argv[1:]:
    print(" ".join(s.depvar for s in load_walker(open(path).read()).sdes))
"""


def test_systems_in_deck_order_under_any_hash_seed(tmp_path):
    """The port's load_walker builds the systems in deck order, whatever
    the interpreter's hash seed (each seed its own process)."""
    import subprocess
    import sys

    paths = []
    for name, deck in (("fwd", DECKS["langevin"]), ("rev", REVERSED_DECK)):
        paths.append(str(tmp_path / f"{name}.q"))
        (tmp_path / f"{name}.q").write_text(deck)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for hs in ("0", "1", "2", "3"):
        env = {**os.environ, "PYTHONHASHSEED": hs,
               "PYTHONPATH": root + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        out = subprocess.run([sys.executable, "-c", _ORDER_SCRIPT, *paths],
                             env=env, capture_output=True, text=True,
                             check=True).stdout.splitlines()
        assert out == ["x u o", "o u x"], (hs, out)


def test_deck_order_sets_keys_and_offsets(tmp_path):
    """The reversed Langevin deck: the port builds o, u, x (the forward
    deck x, u, o), and its stat rows are the JAX package's run in that
    order."""
    rows = {}
    for tag, fn in (("jax", j_main), ("port", _port)):
        d = tmp_path / tag
        d.mkdir()
        (d / "w.q").write_text(REVERSED_DECK)
        with _jax_in_deck_order(REVERSED_DECK):
            rc, _ = _in_dir(str(d), fn, ["walker", "-c", "w.q", "--stat",
                                         "stat.txt"])
        assert rc == 0
        rows[tag] = _table(str(d / "stat.txt"))[1]
    assert [s.depvar for s in t_load(REVERSED_DECK).sdes] == ["o", "u", "x"]
    assert len(rows["port"]) == len(rows["jax"]) > 1
    for a, b in zip(rows["port"], rows["jax"]):
        _same_at_printed_precision(a, b)
    fwd = t_load(DECKS["langevin"])
    assert [s.depvar for s in fwd.sdes] == ["x", "u", "o"]


def test_the_card_is_the_default_device(tmp_path):
    """Without device=, the command runs on the card: with no card it
    raises before it writes the stat file."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    dp = tmp_path / "w.q"
    dp.write_text(SEED_DECK % 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main(["walker", "-c", str(dp), "--stat", str(tmp_path / "s.txt")])
    assert not os.path.exists(tmp_path / "s.txt")
