"""The port's inciter command with the parallel options against
quinoa_tpu's, on the CPU in float64.

The DiagCG SlotCyl deck (6 steps, field output every 3) runs through both
commands (the JAX one on the virtual 8-device CPU mesh) with --npes 4
--pieces 4 -r 4, --npes 2 -u 0.5 --pieces 4 (one piece per chare: 4
chunks), -u 0.5 at --npes 1, --npes 8 --slices 2 and --pieces 3 on one
device, and a DG(P0) Sod deck with --npes 4 --pieces 4.  Checked:

- the diag files row by row against the JAX command's (it equal, t and
  dt rtol 1e-12, norms rtol 1e-12 with test_torch_cli.py's floor: the
  printed precision) and against the port's single-device run (rtol
  1e-9, atol 1e-12: tests/test_asynclogic.py's equivalence);
- each piece file (its mesh, number maps and fields) against the JAX
  command's, per shard and per chare (tests/test_cli_spmd.py:58-182);
- sharded checkpoints across packages (tests/test_checkpoint_sharded.py
  :74): the JAX command restarts from the port's checkpoint at it = 4
  and the port's from the JAX one's, each printing the other's
  uninterrupted rows 5-6 (rtol 1e-12); a restart over a shard count that
  does not divide the checkpoint's raises RuntimeError, as in the JAX
  package.
"""

import os

import numpy as np
import pytest
import torch

from quinoa_tpu.cli import main as j_main

import quinoa_tpu_torch.io as tio
from quinoa_tpu_torch.cli import main as t_main
from quinoa_tpu_torch.mesh import box_tet_mesh
from test_torch_cli import _check_rows, _rows

EQ_RTOL, EQ_ATOL = 1e-9, 1e-12
PIECE_RTOL, PIECE_ATOL = 1e-12, 1e-13
NSTEP, RSFREQ = 6, 4

DECKS = {
    "diagcg": ("""
inciter
  nstep 6 cfl 0.8
  scheme diagcg
  transport physics advection problem slot_cyl depvar c
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end
  field_output interval 3 end
  diagnostics interval 1 end
end
""", (6, 6, 4), (1.0, 1.0, 0.5)),
    "p0_sod": ("""
inciter
  nstep 6 cfl 0.5
  scheme dg
  compflow physics euler problem sod_shocktube
    bc_extrapolate sideset 1 2 end end
    bc_sym sideset 3 4 5 6 end end
  end
  field_output interval 3 end
  diagnostics interval 1 end
end
""", (8, 4, 4), (1.0, 0.5, 0.5)),
}
#: tag: (deck, argv tail)
RUNS = {
    "n4": ("diagcg", ["--npes", "4", "--pieces", "4", "-r", str(RSFREQ)]),
    "n2u": ("diagcg", ["--npes", "2", "-u", "0.5", "--pieces", "4"]),
    "n1u": ("diagcg", ["-u", "0.5"]),
    "n8s2": ("diagcg", ["--npes", "8", "--slices", "2"]),
    "sod_n4": ("p0_sod", ["--npes", "4", "--pieces", "4"]),
    "p3": ("diagcg", ["--pieces", "3"]),
}


def _port(argv):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return t_main(argv, device="cpu")
    finally:
        torch.set_default_dtype(prev)


def _inputs(d, deck):
    text, n, hi = DECKS[deck]
    dp, mp = os.path.join(d, f"{deck}.q"), os.path.join(d, f"{deck}.exo")
    if not os.path.exists(mp):
        with open(dp, "w") as fh:
            fh.write(text)
        tio.write_exodus(mp, box_tet_mesh(*n, hi=hi))
    return dp, mp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every RUNS entry through both commands, and each deck's port
    single-device run, in one directory."""
    d = str(tmp_path_factory.mktemp("spmd_cli"))
    for tag, (deck, tail) in list(RUNS.items()) + [
            ("single_diagcg", ("diagcg", [])),
            ("single_p0_sod", ("p0_sod", []))]:
        dp, mp = _inputs(d, deck)
        for pkg, fn in (("port", _port), ("jax", j_main)):
            if tag.startswith("single") and pkg == "jax":
                continue
            base = os.path.join(d, f"{pkg}_{tag}")
            rc = fn(["inciter", "-c", dp, "-i", mp, "--diag",
                     base + ".diag", "-o", base, "--checkpoint-dir",
                     base + ".ck", *tail])
            assert rc == 0, (tag, pkg)
    return d


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_diag_rows_match_jax_command(runs, tag):
    want = _rows(os.path.join(runs, f"jax_{tag}.diag"))
    assert want.shape[0] == NSTEP
    _check_rows("sod" if "sod" in tag else "diagcg",
                _rows(os.path.join(runs, f"port_{tag}.diag")), want)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_diag_rows_match_single_device(runs, tag):
    deck = RUNS[tag][0]
    np.testing.assert_allclose(
        _rows(os.path.join(runs, f"port_{tag}.diag")),
        _rows(os.path.join(runs, f"port_single_{deck}.diag")),
        rtol=EQ_RTOL, atol=EQ_ATOL)


def _piece_files(d, pkg, tag, it, npiece):
    return sorted(f for f in os.listdir(d)
                  if f.startswith(f"{pkg}_{tag}.e-s.{it}.{npiece}."))


@pytest.mark.parametrize("tag,npiece", [("n4", 4), ("n2u", 4),
                                        ("sod_n4", 4), ("p3", 3)])
def test_pieces_match_jax_command(runs, tag, npiece):
    """--pieces 4 equal to --npes (one piece per shard) or to the chunk
    count under -u (one piece per chare), and --pieces 3 of a
    single-device run (cut by the deck's partitioner): each piece's mesh,
    maps and fields equal the JAX command's."""
    for it in (3, NSTEP):
        names = _piece_files(runs, "jax", tag, it, npiece)
        assert len(names) == npiece
        assert _piece_files(runs, "port", tag, it, npiece) == [
            n.replace("jax_", "port_") for n in names]
        for name in names:
            jp = os.path.join(runs, name)
            tp = os.path.join(runs, name.replace("jax_", "port_"))
            jm, tm = tio.read_exodus(jp), tio.read_exodus(tp)
            np.testing.assert_array_equal(tm.inpoel, jm.inpoel)
            np.testing.assert_array_equal(tm.coords, jm.coords)
            for a, b in zip(tio.read_exodus_maps(tp),
                            tio.read_exodus_maps(jp)):
                np.testing.assert_array_equal(a, b)
            for read in (tio.read_exodus_fields,
                         tio.read_exodus_elem_fields):
                tn, tt, tv = read(tp)
                jn, jt, jv = read(jp)
                assert tn == jn
                np.testing.assert_allclose(tt, jt, rtol=1e-15)
                np.testing.assert_allclose(
                    tv, jv, rtol=PIECE_RTOL,
                    atol=PIECE_ATOL * max(1.0, float(np.abs(jv).max())
                                          if jv.size else 1.0))


def test_port_checkpoint_restarts_jax_command(runs):
    dp, mp = _inputs(runs, "diagcg")
    out = os.path.join(runs, "jax_from_port")
    assert j_main(["inciter", "-c", dp, "-i", mp, "--diag", out + ".diag",
                   "-o", out, "--npes", "4", "-b", "--restart",
                   os.path.join(runs, "port_n4.ck")]) == 0
    got = _rows(out + ".diag")
    assert got[0, 0] == RSFREQ + 1
    _check_rows("diagcg", got,
                _rows(os.path.join(runs, "port_n4.diag"))[RSFREQ:])


def test_jax_checkpoint_restarts_port_command(runs):
    dp, mp = _inputs(runs, "diagcg")
    out = os.path.join(runs, "port_from_jax")
    assert _port(["inciter", "-c", dp, "-i", mp, "--diag", out + ".diag",
                  "-o", out, "--npes", "4", "-b", "--restart",
                  os.path.join(runs, "jax_n4.ck")]) == 0
    got = _rows(out + ".diag")
    assert got[0, 0] == RSFREQ + 1
    _check_rows("diagcg", got,
                _rows(os.path.join(runs, "jax_n4.diag"))[RSFREQ:])


def test_checkpoint_layout_matches_jax(runs):
    """The same files, field names, block shapes and dtypes."""
    import json

    slots = {}
    for pkg in ("port", "jax"):
        ck = os.path.join(runs, f"{pkg}_n4.ck")
        with open(os.path.join(ck, "latest")) as fh:
            slots[pkg] = os.path.join(ck, f"slot{int(fh.read()) % 2}")
    assert sorted(os.listdir(slots["port"])) == sorted(
        os.listdir(slots["jax"]))
    metas = {}
    for pkg, slot in slots.items():
        with open(os.path.join(slot, "meta.json")) as fh:
            metas[pkg] = json.load(fh)
    for k in ("fields", "scalar_fields", "sharded_fields", "nshard", "it",
              "npes"):
        assert metas["port"][k] == metas["jax"][k], k
    for f in os.listdir(slots["jax"]):
        if f.endswith(".npz"):
            a = np.load(os.path.join(slots["port"], f))
            b = np.load(os.path.join(slots["jax"], f))
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype


def test_restart_over_an_indivisible_shard_count_raises(runs):
    dp, mp = _inputs(runs, "diagcg")
    with pytest.raises(RuntimeError, match="cannot be distributed"):
        _port(["inciter", "-c", dp, "-i", mp, "--diag",
               os.path.join(runs, "bad.diag"), "-o",
               os.path.join(runs, "bad"), "--npes", "3", "-b", "--restart",
               os.path.join(runs, "port_n4.ck")])
