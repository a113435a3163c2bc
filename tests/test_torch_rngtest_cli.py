"""The port's rngtest command and -H against quinoa_tpu's CLI, on the CPU.

quinoa_tpu_torch.cli.main([...], device="cpu") and quinoa_tpu.cli.main
(run with jax's x64 off, as the JAX CLI runs) print the same lines and
exit with the same code:

- rngtest on a deck written into the test's directory with two rng
  entries and their seeds (SmallCrush once per rng), and with --seed and
  no deck;
- a deck entry the JAX CLI maps to the rbg generator (r123_philox), and
  --impl rbg, exit 2 before any test runs, with one line naming the entry;
- -H, -H <keyword>, --helpkw after a command and an unknown keyword give
  the JAX CLI's text.
"""

import contextlib
import io

import pytest

import jax

from quinoa_tpu.cli import main as j_main
from quinoa_tpu_torch.cli import main as t_main

DECK = """title "rngtest: two rngs"
rngtest
  smallcrush
    r123_threefry seed 7 end
    mkl_mcg31 seed 12 end
  end
end
"""


def _run(main, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, **kw)
    return rc, out.getvalue(), err.getvalue()


def _both(argv):
    with jax.enable_x64(False):
        want = _run(j_main, argv)
    return _run(t_main, argv, device="cpu"), want


def test_rngtest_deck_matches_jax_cli(tmp_path):
    deck = tmp_path / "two.q"
    deck.write_text(DECK)
    (rc, out, _), (jrc, jout, _) = _both(["rngtest", "-c", str(deck)])
    assert (rc, out) == (jrc, jout)
    assert rc == 0 and out.count("14/14 tests passed") == 2
    assert "rng=mkl_mcg31 (impl=threefry2x32), seed=12" in out


def test_rngtest_seed_flag_matches_jax_cli():
    (rc, out, _), (jrc, jout, _) = _both(["rngtest", "--seed", "3",
                                          "--battery", "smallcrush"])
    assert (rc, out) == (jrc, jout)
    assert out.startswith("smallcrush battery, rng=threefry2x32 "
                          "(impl=threefry2x32), seed=3\n")


@pytest.mark.parametrize("how", ["deck", "impl"])
def test_rngtest_refuses_rbg(tmp_path, how):
    if how == "deck":
        deck = tmp_path / "philox.q"
        deck.write_text(DECK.replace("mkl_mcg31 seed 12",
                                     "r123_philox seed 21234"))
        argv = ["rngtest", "-c", str(deck)]
    else:
        argv = ["rngtest", "--impl", "rbg"]
    rc, out, err = _run(t_main, argv, device="cpu")
    assert rc == 2 and out == ""
    lines = err.strip().splitlines()
    name = "r123_philox" if how == "deck" else "rbg"
    assert len(lines) == 1 and f"rng {name} (impl=rbg)" in lines[0]


@pytest.mark.parametrize("argv", [["-H"], ["-H", "nstep"],
                                  ["walker", "--helpkw", "velocity"],
                                  ["-H", "smallcrush"], ["-H", "nope"],
                                  ["rngtest", "-H"]])
def test_keyword_help_matches_jax_cli(argv):
    got, want = _both(argv)
    assert got == want and got[0] == 0 and got[1]
