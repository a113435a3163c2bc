"""The port's Threefry streams against jax.random, on the CPU.

quinoa_tpu_torch.rng.threefry draws from a key (two 32-bit words held
as Python ints) what jax.random (jax 0.9.0, threefry2x32,
jax_threefry_partitionable on) draws from the same key:

- key(seed), fold_in and split give the same key words;
- random bits (32 and 64 wide, 1-, 2- and 3-D shapes, after fold_in and
  after split) and uniforms (float32 and float64) are bit-identical;
- normals are within NORMAL_ULPS ulps: the port evaluates XLA's erfinv
  polynomial (and, in float64, XLA's log1p) operation by operation, but
  XLA's CPU code contracts the polynomials' multiply-adds into fused
  multiply-adds and torch does not (measured: 3 ulps at most in both
  precisions over 200,000 draws);
- choice with probabilities is identical;
- gamma, log-gamma and beta (alpha in 0.3, 1, 2.5, 10) agree to
  GAMMA_RTOL except for acceptance flips of Marsaglia and Tsang's test,
  which are counted and must be at most one in 10^4 elements (measured:
  none; largest relative difference 2.7e-14 in float64; in float32
  1.7e-5 for one beta element whose v = 1 + x c = 0.017 cancels, 4.1e-6
  for every other element);
- every sampler, RNG's and the init policies' included, draws on the
  card unless the caller asks for another device: without a card the
  default raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from quinoa_tpu.rng import RNG as JRNG
from quinoa_tpu_torch.rng import RNG
from quinoa_tpu_torch.rng import threefry as tf

DTYPES = {"float32": (jnp.float32, torch.float32, np.int32),
          "float64": (jnp.float64, torch.float64, np.int64)}
NORMAL_ULPS = 4
ERFINV_ULPS = 4
GAMMA_RTOL = {"float32": 2e-5, "float64": 1e-12}
MAX_FLIP_SHARE = 1e-4
N_GAMMA = 20000


def _kd(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def _ulps(a, b, itype):
    return np.abs(a.view(itype).astype(np.int64)
                  - b.view(itype).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 + 3, 2 ** 33 + 5])
def test_keys_fold_in_split_match_jax(seed):
    jk, k = jax.random.key(seed), tf.key(seed)
    assert _kd(jk) == k
    for d in (0, 3, 10_000, 2 ** 31 + 7, 2 ** 32 - 1):
        assert _kd(jax.random.fold_in(jk, d)) == tf.fold_in(k, d)
    for n in (2, 3, 5):
        assert [_kd(x) for x in jax.random.split(jk, n)] == tf.split(k, n)
    assert RNG(seed).key == k and RNG(seed).stream(7) == tf.fold_in(k, 7)
    assert _kd(JRNG(seed).stream(7)) == RNG(seed).stream(7)


def _derived_keys():
    """(jax key, port key) after fold_in and after split."""
    jk, k = jax.random.fold_in(jax.random.key(7), 3), tf.fold_in(tf.key(7), 3)
    js, ks = jax.random.split(jk, 3)[2], tf.split(k, 3)[2]
    return {"fold_in": (jk, k), "split": (js, ks)}


@pytest.mark.parametrize("how", ["fold_in", "split"])
@pytest.mark.parametrize("shape", [(5,), (7, 3), (2, 3, 4), ()])
@pytest.mark.parametrize("width", [32, 64])
def test_random_bits_bit_identical(how, shape, width):
    jk, k = _derived_keys()[how]
    want = np.asarray(jax.random.bits(
        jk, shape, jnp.uint32 if width == 32 else jnp.uint64))
    got = tf.random_bits(k, shape, width, "cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.uint64),
                                  want.astype(np.uint64))


@pytest.mark.parametrize("how", ["fold_in", "split"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(1000,), (100, 7), (3, 4, 5)])
def test_uniform_bit_identical(how, dtype, shape):
    jdt, tdt, itype = DTYPES[dtype]
    jk, k = _derived_keys()[how]
    want = np.asarray(jax.random.uniform(jk, shape, jdt))
    got = tf.uniform(k, shape, tdt, "cpu").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(itype), want.view(itype))
    assert np.asarray(JRNG.uniform(jk, shape, jdt)).view(itype).tobytes() \
        == RNG.uniform(k, shape, tdt, "cpu").numpy().view(itype).tobytes()


@pytest.mark.parametrize("how", ["fold_in", "split"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_normal_within_ulps(how, dtype):
    jdt, tdt, itype = DTYPES[dtype]
    jk, k = _derived_keys()[how]
    want = np.asarray(jax.random.normal(jk, (200_000,), jdt))
    got = tf.normal(k, (200_000,), tdt, "cpu").numpy()
    ulps = _ulps(got, want, itype)
    assert ulps.max() <= NORMAL_ULPS, ulps.max()
    assert (ulps == 0).mean() > 0.9
    small = RNG.gaussian(k, (40, 5), tdt, "cpu").numpy()
    np.testing.assert_array_equal(
        small, tf.normal(k, (40, 5), tdt, "cpu").numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_erfinv_is_xlas(dtype):
    """erfinv on points over (-1, 1), the branch switches and +-1 against
    lax.erf_inv; torch.erfinv, a different approximation, is farther."""
    jdt, tdt, itype = DTYPES[dtype]
    x = np.random.default_rng(5).uniform(-1, 1, 100_000).astype(jdt)
    x = np.concatenate([x, np.array([0.0, -1.0, 1.0, 0.5, -0.999999],
                                    dtype=jdt)])
    want = np.asarray(jax.jit(lax.erf_inv)(x))
    got = tf.erfinv(torch.from_numpy(x.copy())).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert _ulps(got[fin], want[fin], itype).max() <= ERFINV_ULPS
    theirs = torch.erfinv(torch.from_numpy(x.copy())).numpy()
    assert _ulps(theirs[fin], want[fin], itype).max() > ERFINV_ULPS


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("p", [(0.2, 0.5, 0.3), (0.5, 0.5), (1.0,),
                               (0.1, 0.0, 0.6, 0.3)])
def test_choice_identical(dtype, p):
    jdt, tdt, _ = DTYPES[dtype]
    jk, k = _derived_keys()["fold_in"]
    want = np.asarray(jax.random.choice(jk, len(p), (5000,),
                                        p=jnp.asarray(p, dtype=jdt)))
    got = tf.choice(k, len(p), (5000,), p, tdt, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


def _flips(got, want, rtol):
    """Elements whose values differ beyond rtol: acceptance flips."""
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    return int((rel > rtol).sum())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("alpha", [0.3, 1.0, 2.5, 10.0])
def test_gamma_and_loggamma(dtype, alpha):
    jdt, tdt, _ = DTYPES[dtype]
    jk, k = _derived_keys()["split"]
    want = np.asarray(jax.random.gamma(jk, alpha, (N_GAMMA,), jdt))
    got = tf.gamma(k, alpha, (N_GAMMA,), tdt, "cpu").numpy()
    assert np.all(got > 0) and np.all(np.isfinite(got))
    assert _flips(got, want, GAMMA_RTOL[dtype]) <= MAX_FLIP_SHARE * N_GAMMA
    lwant = np.asarray(jax.random.loggamma(jk, alpha, (N_GAMMA,), jdt))
    lgot = tf.loggamma(k, alpha, (N_GAMMA,), tdt, "cpu").numpy()
    # log space: compare exp, the samples themselves
    assert _flips(np.exp(lgot.astype(np.float64)),
                  np.exp(lwant.astype(np.float64)),
                  GAMMA_RTOL[dtype]) <= MAX_FLIP_SHARE * N_GAMMA
    scaled = RNG.gamma(k, alpha, (N_GAMMA,), scale=2.5, dtype=tdt,
                       device="cpu").numpy()
    np.testing.assert_array_equal(scaled, got * np.array(2.5, got.dtype))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ab", [(0.3, 2.5), (2.0, 2.0), (10.0, 1.0),
                                (1.0, 0.3)])
def test_beta(dtype, ab):
    jdt, tdt, _ = DTYPES[dtype]
    jk, k = _derived_keys()["fold_in"]
    want = np.asarray(jax.random.beta(jk, *ab, (N_GAMMA,), jdt))
    got = tf.beta(k, *ab, (N_GAMMA,), tdt, "cpu").numpy()
    assert np.all((got >= 0) & (got <= 1))
    assert _flips(got, want, GAMMA_RTOL[dtype]) <= MAX_FLIP_SHARE * N_GAMMA
    np.testing.assert_array_equal(
        RNG.beta(k, *ab, (N_GAMMA,), dtype=tdt, device="cpu").numpy(), got)


def test_gamma_per_element_alpha_and_shapes():
    """An alpha per element and a 2-D shape draw from split(key, size)
    in row-major order, as jax's _gamma_impl."""
    jk, k = _derived_keys()["split"]
    alpha = np.linspace(0.2, 6.0, 600).reshape(20, 30)
    want = np.asarray(jax.random.gamma(jk, alpha, (20, 30), jnp.float64))
    got = tf.gamma(k, alpha, (20, 30), torch.float64, "cpu").numpy()
    assert got.shape == (20, 30)
    np.testing.assert_allclose(got, want, rtol=GAMMA_RTOL["float64"])


def test_only_threefry():
    with pytest.raises(ValueError, match="threefry"):
        RNG(0, impl="rbg")
    with pytest.raises(TypeError):
        tf.uniform((0, 1), (3,), torch.float16, "cpu")


@pytest.mark.parametrize("draw", [
    lambda: tf.random_bits((0, 1), (3,)),
    lambda: tf.uniform((0, 1), (3,)),
    lambda: tf.normal((0, 1), (3,)),
    lambda: tf.choice((0, 1), 2, (3,), (0.5, 0.5)),
    lambda: tf.gamma((0, 1), 2.5, (3,)),
    lambda: tf.loggamma((0, 1), 2.5, (3,)),
    lambda: tf.beta((0, 1), 2.0, 2.0, (3,)),
    lambda: RNG.uniform((0, 1), (3,)),
    lambda: RNG.gaussian((0, 1), (3,)),
    lambda: RNG.beta((0, 1), 2.0, 2.0, (3,)),
    lambda: RNG.gamma((0, 1), 2.5, (3,)),
], ids=["bits", "uniform", "normal", "choice", "gamma", "loggamma", "beta",
        "RNG.uniform", "RNG.gaussian", "RNG.beta", "RNG.gamma"])
def test_the_card_is_the_default_device(draw):
    """Without device=, a sampler draws on the card: with no card it
    raises instead of drawing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default draws there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        draw()
