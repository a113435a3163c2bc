"""The port's rngtest batteries against quinoa_tpu's, on the CPU.

- randint: quinoa_tpu_torch.rng.threefry.randint gives jax.random.randint's
  values for int32 (jax's x64 off, as the JAX CLI draws) and int64 (x64
  on), at spans 2, 64, 2^13, 2^26, 2^30 and minval 1;
- every test family of the batteries gives the JAX package's p-value on
  the same key, to RTOL, with x64 off and on (the JAX package under
  ``jax.enable_x64``), at SmallCrush parameters, the families outside
  SmallCrush at their defaults, the scomp_ ones at the reduced sizes of
  tests/test_rngtest.py;
- SmallCrush whole at seed 7: all 14 pass, the JAX package's p-values;
- the scomp_ host library, its plain versions and quinoa_tpu.native give
  the same LZ78 phrase counts and Berlekamp-Massey profiles;
- the batteries reject RANDU and degenerate bit streams, replaced at the
  draw seam (``battery.DRAWS``) as tests/test_rngtest.py replaces
  jax.random.

Crush and BigCrush whole are marked slow, as the JAX package's own are.
"""

import numpy as np
import pytest
import torch

import jax

from quinoa_tpu import native
from quinoa_tpu.rngtest import battery as jbat
from quinoa_tpu_torch.rng import threefry as tf
from quinoa_tpu_torch.rngtest import battery as bat
from quinoa_tpu_torch.rngtest import scomp

RTOL = 1e-12
SPANS = [(0, 2), (0, 64), (0, 2 ** 13), (0, 2 ** 26), (0, 2 ** 30),
         (1, 2 ** 30), (1, 2 ** 13)]

#: each family at SmallCrush's parameters (its defaults where SmallCrush
#: does not run it), the scomp_ ones smaller
FAMILIES = {
    "birthday_spacings": {}, "collision": {}, "gap": {}, "simp_poker": {},
    "coupon_collector": {}, "max_of_t": {}, "weight_distrib": {},
    "matrix_rank": {}, "hamming_indep": {}, "random_walk": {},
    "ks_uniform": {}, "permutation": {}, "serial_pairs": {},
    "autocorrelation": {}, "serial_over": {}, "collision_over": {},
    "runs_up": {}, "longest_head_run": {}, "sample_prod": {},
    "sample_mean": {}, "sample_corr": {}, "walk_last_return": {},
    "hamming_weight_blocks": {}, "close_pairs": {}, "gcd_test": {},
    "spectral_fourier": {},
    "lempel_ziv": dict(k=18, r=0, s=30, reps=4),
    "linear_comp_jump": dict(n=2 ** 14, r=0),
    "linear_comp_size": dict(n=2 ** 14, r=29),
}


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("span", SPANS, ids=lambda s: f"{s[0]}-{s[1]}")
def test_randint_matches_jax(x64, span):
    lo, hi = span
    for seed in (0, 7, 2 ** 31 + 3):
        with jax.enable_x64(x64):
            want = np.asarray(jax.random.randint(
                jax.random.fold_in(jax.random.key(seed), 5), (3, 1001),
                lo, hi))
        got = tf.randint(tf.fold_in(tf.key(seed), 5), (3, 1001), lo, hi,
                         torch.int64 if x64 else torch.int32, "cpu").numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_randint_edge_cases_match_jax():
    """maxval <= minval gives minval, a negative minval, the full int32
    range; a 64-bit span of 2^31 or more raises."""
    with jax.enable_x64(False):
        k = jax.random.key(3)
        for lo, hi in ((5, 5), (9, 2), (-7, 12), (-2 ** 31, 2 ** 31 - 1)):
            want = np.asarray(jax.random.randint(k, (777,), lo, hi))
            got = tf.randint(tf.key(3), (777,), lo, hi,
                             device="cpu").numpy()
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tf.randint(tf.key(3), (4,), 0, 2 ** 31, torch.int64, "cpu")
    with pytest.raises(TypeError):
        tf.randint(tf.key(3), (4,), 0, 2, torch.int16, "cpu")


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_pvalue_matches_jax(family, x64):
    kw = FAMILIES[family]
    with jax.enable_x64(x64):
        want = getattr(jbat, family)(
            jax.random.fold_in(jax.random.key(11), 4), **kw)
    bat.DRAWS.device, bat.DRAWS.x64 = torch.device("cpu"), x64
    got = getattr(bat, family)(tf.fold_in(tf.key(11), 4), **kw)
    assert got.name == want.name
    np.testing.assert_allclose(got.pvalue, want.pvalue, rtol=RTOL, atol=0)


def test_smallcrush_seed7_matches_jax():
    """run_battery(seed=7) passes all 14 tests with x64 off (the JAX CLI's
    draws) and on, with the JAX package's p-values in both."""
    for x64 in (False, True):
        with jax.enable_x64(x64):
            want, _ = jbat.run_battery(seed=7)
        got, failed = bat.run_battery(seed=7, device="cpu", x64=x64)
        assert not failed and len(got) == len(bat.SmallCrush) == 14
        assert [r.name for r in got] == [r.name for r in want]
        np.testing.assert_allclose([r.pvalue for r in got],
                                   [r.pvalue for r in want], rtol=RTOL,
                                   atol=0)


def _entry(test):
    """A battery entry as (the family it calls, its arguments): a function
    with its defaults, or a lambda with the constants it passes."""
    if test.__name__ != "<lambda>":
        return test.__name__, test.__defaults__
    code = test.__code__
    return ([n for n in code.co_names if n in FAMILIES], code.co_consts,
            code.co_varnames)


def test_batteries_keep_their_sizes_and_order():
    assert (len(bat.SmallCrush), len(bat.Crush), len(bat.BigCrush)) == (
        14, 96, 106)
    for mine, theirs in ((bat.SmallCrush, jbat.SmallCrush),
                         (bat.Crush, jbat.Crush),
                         (bat.BigCrush, jbat.BigCrush)):
        assert [_entry(t) for t in mine] == [_entry(t) for t in theirs]
    with pytest.raises(ValueError):
        bat.run_battery(seed=0, impl="rbg", device="cpu")


def test_battery_draws_on_the_card_by_default():
    """The seam's default device is the card: without one, a draw
    raises."""
    assert bat.Draws().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            bat.run_battery(seed=0, battery=[bat.gap])


@pytest.mark.parametrize("nbits", [7, 100, 1000, 4097])
def test_scomp_library_plain_and_native_agree(nbits):
    bits = np.random.default_rng(nbits).integers(0, 2, nbits)
    b = np.packbits(bits.astype(np.uint8))
    w = scomp.lz78_phrases(b, nbits)
    assert w == scomp.lz78_phrases_plain(b, nbits) == jbat._lz78_phrases_py(
        b, nbits)
    jumps, L = scomp.berlekamp_massey(b, nbits)
    pj, pL = scomp.berlekamp_massey_plain(b, nbits)
    assert L == pL and np.array_equal(jumps, pj)
    assert native.lz78_phrases(b, nbits) == w
    nj, nL = native.berlekamp_massey(b, nbits)
    assert nL == L and np.array_equal(nj, jumps)


def test_scomp_build_is_atomic(tmp_path, monkeypatch):
    """A build writes a file of its own and renames it into place: three
    processes building into one empty directory at once all load it."""
    import subprocess
    import sys

    monkeypatch.setattr(scomp, "BUILD_DIR", str(tmp_path))
    code = ("import sys, numpy as np\n"
            "from quinoa_tpu_torch.rngtest import scomp\n"
            f"scomp.BUILD_DIR = {str(tmp_path)!r}\n"
            "b = np.packbits(np.arange(64) % 3 == 0)\n"
            "print(scomp.lz78_phrases(b, 64))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0]
    assert len(set(outs)) == 1
    assert [f.name for f in tmp_path.iterdir()] == [
        scomp.library_path().rsplit("/", 1)[1]]


class Randu(bat.Draws):
    """RANDU (x <- 65539 x mod 2^31) through the seam, keys ignored:
    uniforms as x / 2^31, integers as the naive x mod span (modulo=True,
    tests/test_rngtest.py's second shim) or scaled uniforms."""

    def __init__(self, modulo):
        super().__init__(device="cpu")
        self.state, self.modulo = 1, modulo

    def _raw(self, n):
        out = np.empty(n, dtype=np.int64)
        s = self.state
        for i in range(n):
            s = (65539 * s) % 2 ** 31
            out[i] = s
        self.state = s
        return out

    def uniform(self, key, shape, dtype=None):
        n = int(np.prod(shape))
        return (self._raw(n) / 2 ** 31).reshape(shape)

    def randint(self, key, shape, minval, maxval, dtype=None):
        n = int(np.prod(shape))
        x = self._raw(n)
        if self.modulo:
            v = x % (maxval - minval) + minval
        else:
            v = (x / 2 ** 31 * (maxval - minval) + minval).astype(np.int64)
        return v.reshape(shape)


def test_randu_fails_equidistribution(monkeypatch):
    monkeypatch.setattr(bat, "DRAWS", Randu(modulo=False))
    subset = [bat.gap, bat.max_of_t, bat.weight_distrib, bat.random_walk,
              bat.ks_uniform, bat.hamming_indep]
    results, failed = bat.run_battery(seed=0, battery=subset, device="cpu")
    assert failed, [r.pvalue for r in results]


def test_randu_fails_crush_families(monkeypatch):
    monkeypatch.setattr(bat, "DRAWS", Randu(modulo=True))
    subset = [bat.serial_over, bat.collision_over, bat.hamming_weight_blocks,
              bat.longest_head_run, bat.runs_up, bat.walk_last_return]
    results, failed = bat.run_battery(seed=0, battery=subset, device="cpu")
    assert failed, [(r.name, r.pvalue) for r in results]
    k = tf.key(0)
    rg = bat.gcd_test(k, n=2 ** 14)
    rf = bat.spectral_fourier(k, nblocks=2 ** 4, L=2 ** 12)
    assert not rg.passed and not rf.passed, (rg, rf)


def test_scomp_rejects_degenerate_streams(monkeypatch):
    """An LFSR m-sequence (linear complexity 20) fails LinearComp, a
    period-128 stream LempelZiv, thousands of sigma out."""
    s = np.zeros(1 << 18, np.uint8)
    s[:20] = np.arange(20) % 2
    s[0] = 1
    for t in range(20, len(s)):
        s[t] = s[t - 20] ^ s[t - 17]
    lfsr = np.packbits(s)
    tile = np.random.default_rng(9).integers(0, 2, 128).astype(np.uint8)
    periodic = np.packbits(np.tile(tile, (1 << 18) // 128))
    k = tf.key(0)
    monkeypatch.setattr(bat, "_bit_stream", lambda key, nbits, r=0, s=32:
                        lfsr)
    rj = bat.linear_comp_jump(k, n=2 ** 14, r=0)
    monkeypatch.setattr(bat, "_bit_stream", lambda key, nbits, r=0, s=32:
                        periodic)
    rz = bat.lempel_ziv(k, k=18, r=0, s=30, reps=4)
    assert rj.pvalue < 1e-10 and rz.pvalue < 1e-10, (rj, rz)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["Crush", "BigCrush"])
def test_whole_battery_matches_jax(name):
    """Crush (seed 1) and BigCrush (seed 3) whole, x64 off: the JAX
    package's p-values."""
    seed = {"Crush": 1, "BigCrush": 3}[name]
    with jax.enable_x64(False):
        want, _ = jbat.run_battery(seed=seed, battery=getattr(jbat, name))
    got, _ = bat.run_battery(seed=seed, battery=getattr(bat, name),
                             device="cpu")
    np.testing.assert_allclose([r.pvalue for r in got],
                               [r.pvalue for r in want], rtol=RTOL, atol=0)
