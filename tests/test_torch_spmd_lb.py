"""The port's --lbfreq, dtref under -u, and sharded walker, on the CPU in
float64.

- --lbfreq 2 on a p-adaptive Sedov deck at --npes 2 and at --npes 2 -u
  0.5: the balancer fires (the -v line `lb @it=`) and the rows equal the
  unbalanced run's at rtol 1e-5, atol 1e-9 (tests/test_cli_spmd.py:222:
  migration carries u and ndofel exactly, the rest is round-off of other
  partitions' sum order over the remaining steps);
- dtref under --npes 2 -u 0.5 (each remesh a resharding event): the rows
  equal the single-device run's at rtol 1e-9, atol 1e-12
  (tests/test_asynclogic.py:125-154);
- walker --npes 4 on the coupled Langevin deck: the stat file equals the
  JAX command's --npes 4 file at the printed precision
  (test_torch_walker_cli.py's check), and the walker at nshard 4 equals
  the walker at nshard 1 on every SDE class of test_torch_walker.py (10
  steps: particles and moments rtol 1e-12; at nshard 4 the ensemble
  means, inside the steps and in the moments, fold four row blocks'
  sums in block order).
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from quinoa_tpu.cli import main as j_main

import quinoa_tpu_torch.io as tio
from quinoa_tpu_torch.cli import main as t_main
from quinoa_tpu_torch.mesh import box_tet_mesh

import test_torch_walker as tw
import test_torch_walker_cli as twc

PDG = """
inciter
  nstep 6 cfl 0.5
  scheme pdg limiter superbeep1 tolref 0.05
  compflow problem sedov_blastwave bc_sym sideset 1 2 3 4 5 6 end end
  end
  diagnostics interval 1 end
end
"""
DTREF = """
inciter
  nstep 6
  cfl 0.8
  ttyi 10
  scheme diagcg
  transport
    physics advection problem slot_cyl ncomp 1 depvar c
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end
  amr
    dtref true
    dtfreq 3
    error jump
  end
  diagnostics interval 1 error l2 end
end
"""
SHARDS = 4
WALKER_RTOL = 1e-12


def _port(argv):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = t_main(argv, device="cpu")
        return rc, out.getvalue()
    finally:
        torch.set_default_dtype(prev)


def _rows(path):
    with open(path) as fh:
        return np.array([[float(x) for x in line.split()] for line in fh
                         if not line.startswith("#")])


def _inputs(d, deck, n, hi):
    dp, mp = os.path.join(d, "run.q"), os.path.join(d, "box.exo")
    with open(dp, "w") as fh:
        fh.write(deck)
    tio.write_exodus(mp, box_tet_mesh(*n, hi=hi))
    return dp, mp


@pytest.mark.parametrize("tail", [["--npes", "2"],
                                  ["--npes", "2", "-u", "0.5"]])
def test_lbfreq_pdg_matches_unbalanced(tmp_path, tail):
    dp, mp = _inputs(str(tmp_path), PDG, (6, 6, 4), (0.6, 0.6, 0.4))
    common = ["inciter", "-c", dp, "-i", mp, "-b", *tail]
    rc, _ = _port(common + ["--diag", str(tmp_path / "ref")])
    assert rc == 0
    rc, out = _port(common + ["--diag", str(tmp_path / "lb"), "--lbfreq",
                              "2", "-v"])
    assert rc == 0
    assert "lb @it=" in out   # the balancer actually fired
    ref, lb = _rows(tmp_path / "ref"), _rows(tmp_path / "lb")
    assert ref.shape == lb.shape == (6, 18)
    np.testing.assert_allclose(lb, ref, rtol=1e-5, atol=1e-9)


def test_dtref_under_virtualization(tmp_path):
    dp, mp = _inputs(str(tmp_path), DTREF, (8, 8, 4), (1.0, 1.0, 0.5))
    common = ["inciter", "-c", dp, "-i", mp, "-b", "-v"]
    rc, out1 = _port(common + ["--diag", str(tmp_path / "d1")])
    assert rc == 0
    rc, outu = _port(common + ["--diag", str(tmp_path / "du"), "--npes",
                               "2", "-u", "0.5"])
    assert rc == 0
    events = [ln.split("(")[0].rstrip() for ln in outu.splitlines()
              if "dtref @it=" in ln]
    assert events and events == [ln for ln in out1.splitlines()
                                 if "dtref @it=" in ln]
    np.testing.assert_allclose(_rows(tmp_path / "du"), _rows(tmp_path / "d1"),
                               rtol=1e-9, atol=1e-12)


def test_walker_npes4_matches_jax_command(tmp_path):
    deck = twc.DECKS["langevin"]
    res = {}
    for tag, fn in (("jax", j_main), ("port", twc._port)):
        d = tmp_path / tag
        d.mkdir()
        (d / "w.q").write_text(deck)
        with twc._jax_in_deck_order(deck):
            rc, _ = twc._in_dir(str(d), fn, ["walker", "-c", "w.q",
                                             "--stat", "stat.txt",
                                             "--npes", "4"])
        assert rc == 0, tag
        res[tag] = twc._table(str(d / "stat.txt"))
    (jh, jrows), (th, trows) = res["jax"], res["port"]
    assert th == jh and len(trows) == len(jrows) > 1
    for a, b in zip(trows, jrows):
        assert a[0] == b[0]
        twc._same_at_printed_precision(a, b)


@pytest.fixture(scope="module")
def f64_module():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


@pytest.mark.parametrize("name", tw.CASES)
def test_sharded_walker_matches_one_tensor(f64_module, name):
    out = []
    for nshard in (1, SHARDS):
        w = tw._walker("port", name)
        w.nshard = nshard
        w.ordinary, w.central = tw._terms(w)
        P = w.initialize()
        P, hist = w.run(10, stat_every=5, P=P)
        out.append((P.numpy(), hist))
    (p1, h1), (ps, hs) = out
    np.testing.assert_allclose(ps, p1, rtol=WALKER_RTOL, atol=1e-14)
    assert [t for t, _ in hs] == [t for t, _ in h1]
    for (_, a), (_, b) in zip(hs, h1):
        assert a.keys() == b.keys()
        for k in b:
            assert np.isclose(a[k], b[k], rtol=WALKER_RTOL, atol=1e-14), k
