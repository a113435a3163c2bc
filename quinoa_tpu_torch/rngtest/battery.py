"""Statistical test batteries for counter-based RNGs.

The port's own copy of quinoa_tpu/rngtest/battery.py: the same 29 test
functions, SmallCrush (14 tests), Crush (96) and BigCrush (106), in the
same order and with the same parameters, the counterpart of the
reference's rngtest executable (src/RNGTest/: one TestU01 test per chare,
testu01suite.ci:29-36).  Each test yields a p-value and fails outside
[1e-3, 1 - 1e-3], TestU01's default.

Every draw goes through one seam, ``DRAWS`` (a ``Draws``): jax.random's
Threefry streams from the port's rng/threefry.py, made on its device and
copied to the host, bit for bit the JAX package's draws from the same
key.  ``x64`` mirrors jax's x64 flag: off (the JAX CLI's draws), uniforms
are float32 and randint int32; on, float64 and int64.  The statistics are
the JAX package's own numpy and scipy code on the host, so on the same
draws every p-value is the JAX package's.  A test replaces the generator
by replacing ``DRAWS`` with a subclass.  The scomp_ family's LZ78 and
Berlekamp-Massey run on the host through ``scomp``'s C++ library.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List

import numpy as np
import torch
from scipy import stats

from ..device import DEFAULT_DEVICE, resolve_device
from ..rng import threefry
from ..rng.threefry import fold_in
from . import scomp


class Draws:
    """The batteries' random numbers: uniform, randint and 32-bit words
    from jax.random's Threefry streams on ``device``, returned as numpy
    arrays of the dtypes jax gives (``x64`` as jax's flag); ``seconds``
    accumulates the time of the draws and their copies to the host."""

    def __init__(self, device=DEFAULT_DEVICE, x64: bool = False):
        self.device = device
        self.x64 = x64
        self.seconds = 0.0

    def _host(self, draw):
        t0 = time.perf_counter()
        out = draw().cpu().numpy()
        self.seconds += time.perf_counter() - t0
        return out

    def uniform(self, key, shape, dtype=None):
        """jax.random.uniform(key, shape, dtype): [0, 1)."""
        dtype = dtype or ("float64" if self.x64 else "float32")
        return self._host(lambda: threefry.uniform(
            key, shape, getattr(torch, dtype), self.device))

    def randint(self, key, shape, minval, maxval, dtype=None):
        """jax.random.randint(key, shape, minval, maxval, dtype)."""
        dtype = dtype or ("int64" if self.x64 else "int32")
        return self._host(lambda: threefry.randint(
            key, shape, minval, maxval, getattr(torch, dtype), self.device))

    def bits(self, key, shape):
        """jax.random.bits(key, shape, uint32)."""
        return self._host(lambda: threefry.random_bits(
            key, shape, 32, self.device)).astype(np.uint32)


#: the seam every test draws through
DRAWS = Draws()


@dataclasses.dataclass
class TestResult:
    name: str
    pvalue: float

    @property
    def passed(self) -> bool:
        return 1e-3 < self.pvalue < 1.0 - 1e-3


def _chi2_p(observed, expected):
    observed = np.asarray(observed, dtype=float)
    expected = np.asarray(expected, dtype=float)
    keep = expected > 5.0
    if keep.sum() < 2:
        return 0.5
    chi2 = ((observed[keep] - expected[keep]) ** 2 / expected[keep]).sum()
    return float(stats.chi2.sf(chi2, keep.sum() - 1))


# --- individual tests (SmallCrush-inspired) --------------------------------


def birthday_spacings(key, n=2**10, d=2**28, reps=32):
    """Poisson law of repeated spacings among sorted 'birthdays'
    (lambda = n^3/(4d) = 1 per replicate; summed over replicates)."""
    coll = 0
    for r in range(reps):
        u = DRAWS.randint(fold_in(key, r), (n,), 0, d)
        s = np.sort(np.asarray(u))
        sp = np.sort(np.diff(s))
        coll += (n - 1) - len(np.unique(sp))
    lam = reps * n**3 / (4.0 * d)
    p = stats.poisson.cdf(coll, lam)
    return TestResult("BirthdaySpacings", float(min(p, 1 - p) * 2))


def collision(key, n=2**14, d=2**24, reps=16):
    """Collisions in a sparse table: exact mean n - d(1-(1-1/d)^n),
    approximately Poisson in the sparse regime."""
    ncoll = 0
    for r in range(reps):
        u = np.asarray(DRAWS.randint(fold_in(key, r),
                                          (n,), 0, d))
        ncoll += n - len(np.unique(u))
    lam = reps * (n - d * (1.0 - (1.0 - 1.0 / d) ** n))
    p = stats.poisson.cdf(ncoll, lam)
    return TestResult("Collision", float(min(p, 1 - p) * 2))


def gap(key, n=2**18, alpha=0.0, beta=0.125, tmax=24):
    u = np.asarray(DRAWS.uniform(key, (n,)))
    inb = (u >= alpha) & (u < beta)
    idx = np.nonzero(inb)[0]
    if len(idx) < 10:
        return TestResult("Gap", 0.5)
    gaps = np.diff(idx) - 1
    gaps = np.clip(gaps, 0, tmax)
    p_ = beta - alpha
    probs = np.array(
        [p_ * (1 - p_) ** k for k in range(tmax)] + [(1 - p_) ** tmax]
    )
    obs = np.bincount(gaps, minlength=tmax + 1)
    return TestResult("Gap", _chi2_p(obs, probs * len(gaps)))


def simp_poker(key, n=2**16, d=8, k=8):
    u = np.asarray(DRAWS.randint(key, (n, k), 0, d))
    # vectorized distinct-count over ALL n hands (the former per-row
    # Python set() loop truncated to 2^13 hands, silently wasting the
    # enlarged Crush/BigCrush sample sizes)
    su = np.sort(u, axis=1)
    distinct = 1 + (np.diff(su, axis=1) != 0).sum(axis=1)
    # Stirling-number distribution of distinct values
    from math import comb, factorial

    def stirling2(nn, kk):
        return sum(
            (-1) ** i * comb(kk, i) * (kk - i) ** nn for i in range(kk + 1)
        ) // factorial(kk)

    probs = np.array(
        [
            factorial(d) / factorial(d - r) * stirling2(k, r) / d**k
            for r in range(1, min(d, k) + 1)
        ]
    )
    obs = np.bincount(distinct - 1, minlength=len(probs))[: len(probs)]
    return TestResult("SimpPoker", _chi2_p(obs, probs * len(distinct)))


def coupon_collector(key, n=2**16, d=8, tmax=40):
    u = np.asarray(DRAWS.randint(key, (n,), 0, d))
    lengths = []
    seen = set()
    start = 0
    for i, v in enumerate(u):
        seen.add(int(v))
        if len(seen) == d:
            lengths.append(i - start + 1)
            seen = set()
            start = i + 1
    if len(lengths) < 20:
        return TestResult("CouponCollector", 0.5)
    lengths = np.clip(np.asarray(lengths), d, tmax)
    # exact distribution via inclusion-exclusion
    from math import comb

    def cdf(t):
        return sum(
            (-1) ** i * comb(d, i) * (1 - i / d) ** t for i in range(d)
        )

    probs = np.array([cdf(t) - cdf(t - 1) for t in range(d, tmax)] +
                     [1 - cdf(tmax - 1)])
    obs = np.bincount(lengths - d, minlength=len(probs))[: len(probs)]
    return TestResult("CouponCollector", _chi2_p(obs, probs * len(lengths)))


def max_of_t(key, n=2**15, t=6, bins=32):
    u = np.asarray(DRAWS.uniform(key, (n, t))).max(axis=1)
    # CDF of max of t uniforms is x^t; transform to uniform and chi2-bin
    v = u**t
    obs = np.bincount((v * bins).astype(int).clip(0, bins - 1),
                      minlength=bins)
    return TestResult("MaxOft", _chi2_p(obs, np.full(bins, n / bins)))


def weight_distrib(key, n=2**15, k=24, lo=0.25, hi=0.75):
    u = np.asarray(DRAWS.uniform(key, (n, k)))
    w = ((u >= lo) & (u < hi)).sum(axis=1)
    probs = stats.binom.pmf(np.arange(k + 1), k, hi - lo)
    obs = np.bincount(w, minlength=k + 1)
    return TestResult("WeightDistrib", _chi2_p(obs, probs * n))


def matrix_rank(key, n=256, dim=32):
    """Rank distribution of random binary matrices over GF(2)."""
    bits = np.asarray(
        DRAWS.randint(key, (n, dim, dim), 0, 2), dtype=np.uint8
    )

    def rank2(m):
        m = m.copy()
        r = 0
        for c in range(dim):
            piv = np.nonzero(m[r:, c])[0]
            if len(piv) == 0:
                continue
            i = piv[0] + r
            m[[r, i]] = m[[i, r]]
            rows = np.nonzero(m[:, c])[0]
            rows = rows[rows != r]
            m[rows] ^= m[r]
            r += 1
            if r == dim:
                break
        return r

    ranks = np.array([rank2(m) for m in bits])
    # theoretical: P(rank = dim - j)
    def prank(j):
        r = dim - j
        p = 2.0 ** (-j * j)
        for i in range(r):
            p *= (1 - 2.0 ** (i - dim)) ** 2 / (1 - 2.0 ** (i - r))
        return p

    probs = np.array([prank(2), prank(1), prank(0)])
    obs = np.array(
        [(ranks <= dim - 2).sum(), (ranks == dim - 1).sum(),
         (ranks == dim).sum()]
    )
    return TestResult("MatrixRank", _chi2_p(obs, probs * n))


def hamming_indep(key, n=2**13):
    """Serial correlation of Hamming weights of successive words: under
    independence, r*sqrt(n) is asymptotically standard normal."""
    # 30 bits: int32-safe without x64
    bits = np.asarray(DRAWS.randint(key, (n,), 0, 2**30), dtype=np.uint64)
    hw = np.array([bin(int(x)).count("1") for x in bits], dtype=float)
    a = hw[:-1] - hw.mean()
    b = hw[1:] - hw.mean()
    r = (a * b).mean() / hw.var()
    z = r * np.sqrt(len(a))
    return TestResult("HammingIndep", float(2.0 * stats.norm.sf(abs(z))))


def random_walk(key, n=2**12, steps=128):
    """Final positions of +-1 random walks vs binomial law."""
    u = np.asarray(DRAWS.randint(key, (n, steps), 0, 2)) * 2 - 1
    pos = (u.sum(axis=1) + steps) // 2
    probs = stats.binom.pmf(np.arange(steps + 1), steps, 0.5)
    obs = np.bincount(pos, minlength=steps + 1)
    return TestResult("RandomWalk1", _chi2_p(obs, probs * n))


def ks_uniform(key, n=2**16):
    u = np.asarray(DRAWS.uniform(key, (n,)))
    return TestResult("KSUniform", float(stats.kstest(u, "uniform").pvalue))


def permutation(key, n=2**15, t=5):
    """sknuth_Permutation: order patterns of non-overlapping t-tuples are
    uniform over the t! permutations (exact multinomial chi2)."""
    import math

    u = np.asarray(DRAWS.uniform(key, (n, t)))
    idx = np.argsort(u, axis=1)
    # Lehmer code -> permutation index
    code = np.zeros(n, dtype=np.int64)
    for j in range(t):
        smaller = (idx[:, j + 1:] < idx[:, j:j + 1]).sum(axis=1)
        code = code * (t - j) + smaller
    nperm = math.factorial(t)
    obs = np.bincount(code, minlength=nperm)
    return TestResult("Permutation", _chi2_p(obs, np.full(nperm, n / nperm)))


def serial_pairs(key, n=2**16, d=64):
    """smultin_Serial (non-overlapping pairs): (u_{2i}, u_{2i+1}) cells in
    a d x d grid are uniform (exact chi2 with d^2-1 dof)."""
    v = np.asarray(
        DRAWS.randint(key, (2 * n,), 0, d, dtype="int32")
    ).astype(np.int64)
    cells = v[0::2] * d + v[1::2]
    obs = np.bincount(cells, minlength=d * d)
    return TestResult("SerialPairs", _chi2_p(obs, np.full(d * d, n / (d * d))))


def autocorrelation(key, n=2**18, lag=1):
    """sstring_AutoCor: lag-k autocorrelation of the bit stream is
    asymptotically normal with mean n/2 and variance n/4."""
    bits = np.asarray(
        DRAWS.randint(key, (n + lag,), 0, 2, dtype="int32")
    ).astype(np.int64)
    a = (bits[:-lag] ^ bits[lag:]).sum()
    z = (2.0 * a - n) / np.sqrt(n)
    return TestResult("AutoCorrelation", float(2.0 * stats.norm.sf(abs(z))))


# --- Crush-family tests (structurally distinct from the SmallCrush set;
# counterparts of the additional TestU01 families the reference's Crush
# battery runs, src/RNGTest/Crush.cpp: smultin_SerialOver/CollisionOver,
# sknuth_Run, sstring_LongestHeadRun/HammingWeight2, svaria_SampleProd/
# SampleMean/SampleCorr, swalk_RandomWalk1 statistics) -------------------


def serial_over(key, n=2**18, d=64):
    """smultin_SerialOver: Good's generalized serial test on OVERLAPPING
    pairs — X2(pairs) - X2(singles) is asymptotically chi2(d^2 - d)
    (the exact correction for tuple overlap)."""
    v = np.asarray(
        DRAWS.randint(key, (n,), 0, d, dtype="int32")
    ).astype(np.int64)
    pairs = v * d + np.roll(v, -1)  # circular overlap: n tuples
    N2 = np.bincount(pairs, minlength=d * d).astype(float)
    N1 = np.bincount(v, minlength=d).astype(float)
    e2, e1 = n / (d * d), n / d
    x2 = ((N2 - e2) ** 2 / e2).sum()
    x1 = ((N1 - e1) ** 2 / e1).sum()
    p = float(stats.chi2.sf(x2 - x1, d * d - d))
    return TestResult("SerialOver", p)


def collision_over(key, n=2**16, d=2**12):
    """smultin_CollisionOver (OPSO-style): collisions among n OVERLAPPING
    pairs in k = d^2 cells; sparse regime is Poisson(n^2/(2k)) (L'Ecuyer &
    Simard, overlapping collision asymptotics)."""
    v = np.asarray(
        DRAWS.randint(key, (n + 1,), 0, d, dtype="int32")
    ).astype(np.int64)
    cells = v[:-1] * d + v[1:]
    ncoll = n - len(np.unique(cells))
    lam = n * n / (2.0 * d * d)
    p = stats.poisson.cdf(ncoll, lam)
    return TestResult("CollisionOver", float(min(p, 1 - p) * 2))


#: Knuth TAOCP vol.2 3.3.2G run-test covariance constants
_RUNS_A = np.array(
    [
        [4529.4, 9044.9, 13568.0, 18091.0, 22615.0, 27892.0],
        [9044.9, 18097.0, 27139.0, 36187.0, 45234.0, 55789.0],
        [13568.0, 27139.0, 40721.0, 54281.0, 67852.0, 83685.0],
        [18091.0, 36187.0, 54281.0, 72414.0, 90470.0, 111580.0],
        [22615.0, 45234.0, 67852.0, 90470.0, 113262.0, 139476.0],
        [27892.0, 55789.0, 83685.0, 111580.0, 139476.0, 172860.0],
    ]
)
_RUNS_B = np.array(
    [1 / 6, 5 / 24, 11 / 120, 19 / 720, 29 / 5040, 1 / 840]
)


def runs_up(key, n=2**18):
    """sknuth_Run: runs-up length counts with Knuth's covariance-corrected
    quadratic form V ~ chi2(6) (TAOCP 3.3.2G — run lengths of a uniform
    sequence are dependent, so a plain chi2 is wrong)."""
    u = np.asarray(DRAWS.uniform(key, (n,)))
    desc = np.nonzero(u[1:] < u[:-1])[0]
    lengths = np.diff(np.concatenate([[-1], desc, [n - 1]]))
    lengths = np.clip(lengths, 1, 6)
    C = np.bincount(lengths - 1, minlength=6)[:6].astype(float)
    diff = C - n * _RUNS_B
    V = diff @ _RUNS_A @ diff / (n - 6)
    return TestResult("RunsUp", float(stats.chi2.sf(V, 6)))


def longest_head_run(key, nblocks=2**12, L=64):
    """sstring_LongestHeadRun: longest run of 1s per L-bit block; the law
    is EXACT via the no-run-longer-than-m counting recurrence (big-int
    arithmetic, no asymptotics)."""
    bits = np.asarray(
        DRAWS.randint(key, (nblocks, L), 0, 2, dtype="int32")
    )
    cur = np.zeros(nblocks, dtype=np.int64)
    best = np.zeros(nblocks, dtype=np.int64)
    for j in range(L):
        cur = (cur + 1) * bits[:, j]
        best = np.maximum(best, cur)

    def count_max_le(m):
        # strings of length l with longest 1-run <= m: first zero after
        # j <= m leading ones, plus the all-ones string when l <= m
        f = [1]  # f[0]
        for length in range(1, L + 1):
            tot = sum(f[length - 1 - j] for j in range(min(m, length - 1) + 1))
            if length <= m:
                tot += 1
            f.append(tot)
        return f[L]

    cdf = np.array([count_max_le(m) / 2.0**L for m in range(L + 1)])
    pmf = np.diff(np.concatenate([[0.0], cdf]))
    obs = np.bincount(best, minlength=L + 1).astype(float)
    # merge tails so every category is testable
    kmax = int(np.searchsorted(cdf, 1 - 4.0 / nblocks))
    kmin = int(np.searchsorted(pmf.cumsum(), 4.0 / nblocks))
    o = np.concatenate(
        [[obs[: kmin + 1].sum()], obs[kmin + 1: kmax],
         [obs[kmax:].sum()]]
    )
    e = np.concatenate(
        [[pmf[: kmin + 1].sum()], pmf[kmin + 1: kmax],
         [1.0 - cdf[kmax - 1]]]
    ) * nblocks
    return TestResult("LongestHeadRun", _chi2_p(o, e))


def sample_prod(key, m=2**14, t=8):
    """svaria_SampleProd: -log(prod of t uniforms) is EXACTLY Gamma(t,1);
    transform to uniform and KS."""
    u = np.asarray(DRAWS.uniform(key, (m, t)))
    # clamp at the dtype's tiny: 1e-300 underflows to 0 in f32, making
    # the clamp a no-op and log(0) = -inf poison the whole KS sample
    s = -np.log(np.maximum(u, np.finfo(u.dtype).tiny)).sum(axis=1)
    g = stats.gamma.cdf(s, t)
    return TestResult("SampleProd", float(stats.kstest(g, "uniform").pvalue))


def sample_mean(key, m=2**14, t=12):
    """svaria_SampleMean: sum of t uniforms follows the EXACT Irwin-Hall
    law; transform and KS."""
    from math import comb, factorial

    u = np.asarray(DRAWS.uniform(key, (m, t))).sum(axis=1)

    def ih_cdf(x):
        x = np.asarray(x)
        out = np.zeros_like(x)
        for k in range(t + 1):
            term = (-1.0) ** k * comb(t, k) * np.maximum(x - k, 0.0) ** t
            out = out + term
        return out / factorial(t)

    g = ih_cdf(u)
    return TestResult("SampleMean", float(stats.kstest(g, "uniform").pvalue))


def sample_corr(key, n=2**18, lag=1):
    """svaria_SampleCorr: lag-k autocorrelation of the uniforms themselves;
    r*sqrt(n) is asymptotically standard normal."""
    u = np.asarray(DRAWS.uniform(key, (n,)))
    a = u[:-lag] - u.mean()
    b = u[lag:] - u.mean()
    r = (a * b).mean() / u.var()
    z = r * np.sqrt(n - lag)
    return TestResult("SampleCorr", float(2.0 * stats.norm.sf(abs(z))))


def walk_last_return(key, nwalks=2**13, m=32):
    """swalk_RandomWalk1 (R statistic family): time of the LAST return to
    the origin of a 2m-step +-1 walk follows the EXACT discrete arcsine
    law P(2k) = C(2k,k) C(2m-2k,m-k) / 4^m."""
    from scipy.special import gammaln

    steps = np.asarray(
        DRAWS.randint(key, (nwalks, 2 * m), 0, 2, dtype="int32")
    ) * 2 - 1
    pos = steps.cumsum(axis=1)
    tgrid = np.arange(1, 2 * m + 1)
    lastz = ((pos == 0) * tgrid[None, :]).max(axis=1)  # 0 if never returns
    k = lastz // 2

    def logc(nn, kk):
        return gammaln(nn + 1) - gammaln(kk + 1) - gammaln(nn - kk + 1)

    ks = np.arange(m + 1)
    logp = (logc(2 * ks, ks) + logc(2 * (m - ks), m - ks)
            - 2 * m * np.log(2.0))
    probs = np.exp(logp)
    obs = np.bincount(k, minlength=m + 1).astype(float)
    return TestResult("WalkLastReturn", _chi2_p(obs, probs * nwalks))


def hamming_weight_blocks(key, nblocks=2**15, L=32):
    """sstring_HammingWeight2: Hamming weight of L-bit blocks is EXACTLY
    Binomial(L, 1/2)."""
    bits = np.asarray(
        DRAWS.randint(key, (nblocks, L), 0, 2, dtype="int32")
    )
    w = bits.sum(axis=1)
    probs = stats.binom.pmf(np.arange(L + 1), L, 0.5)
    obs = np.bincount(w, minlength=L + 1)
    return TestResult("HammingWeight2", _chi2_p(obs, probs * nblocks))


def close_pairs(key, n=2**10, t=3, reps=48):
    """snpair_ClosePairs (the NP min-distance statistic, Crush.cpp runs
    it at t = 2, 3, 7, ...): n uniform points in the t-torus; the
    minimum pairwise torus distance D obeys P(D > r) = exp(-lam(r))
    with lam(r) = n(n-1)/2 * V_t * r^t (V_t the t-ball volume; the
    torus metric removes edge effects, which is exactly why TestU01
    uses it).  U = 1 - exp(-lam(D)) is Uniform(0,1) per replicate;
    KS over replicates."""
    from math import gamma as _gamma, pi

    Vt = pi ** (t / 2.0) / _gamma(t / 2.0 + 1.0)
    iu = np.triu_indices(n, 1)
    us = np.empty(reps)
    for r in range(reps):
        pts = np.asarray(DRAWS.uniform(
            fold_in(key, r), (n, t), dtype="float32")
        ).astype(np.float64)
        d2 = np.zeros((n, n))
        for j in range(t):  # accumulate per-dim to keep memory at (n,n)
            dj = np.abs(pts[:, None, j] - pts[None, :, j])
            dj = np.minimum(dj, 1.0 - dj)  # torus metric
            d2 += dj * dj
        dmin = np.sqrt(d2[iu].min())
        lam = 0.5 * n * (n - 1) * Vt * dmin**t
        us[r] = -np.expm1(-lam)
    return TestResult("ClosePairs",
                      float(stats.kstest(us, "uniform").pvalue))


def gcd_test(key, n=2**18, e=30, kmax=64):
    """smarsa_GCD: the gcd of independent uniform integer pairs follows
    P(gcd = k) = (6/pi^2)/k^2 (asymptotically in the integer range 2^e;
    the k <= kmax head with an aggregated tail bin); chi^2 against the
    exact law."""
    a = np.asarray(DRAWS.randint(key, (n,), 1, 2**e)) \
        .astype(np.int64)
    b = np.asarray(DRAWS.randint(fold_in(key, 1),
                                      (n,), 1, 2**e)).astype(np.int64)
    g = np.minimum(np.gcd(a, b), kmax)
    obs = np.bincount(g, minlength=kmax + 1)[1:]
    probs = (6.0 / np.pi**2) / np.arange(1, kmax + 1) ** 2.0
    probs[-1] = 1.0 - probs[:-1].sum()  # tail bin P(gcd >= kmax)
    return TestResult("GCD", _chi2_p(obs, probs * n))


def spectral_fourier(key, nblocks=2**6, L=2**14):
    """sspectral_Fourier3's domain (the battery's only frequency-domain
    statistic): for blocks of L iid +-1 bits the normalized periodogram
    |f_j|^2 / L at interior frequencies is asymptotically iid Exp(1)
    (Re f_j, Im f_j are N(0, L/2)); pool over blocks and KS against
    Exp(1).  Periodic low-bit structure (e.g. RANDU's constant bit 0)
    shows up as degenerate spectral lines no time-domain test sees the
    same way."""
    bits = np.asarray(DRAWS.randint(key, (nblocks, L), 0, 2,
                                         dtype="int32")) * 2.0 - 1.0
    f = np.fft.rfft(bits, axis=1)[:, 1:L // 2]
    p = (np.abs(f) ** 2 / L).ravel()
    return TestResult("Fourier",
                      float(stats.kstest(p, "expon").pvalue))


def _bit_stream(key, nbits, r=0, s=32):
    """Draw ceil(nbits/s) 32-bit words from the generator under test and
    keep s bits starting r below the MSB of each word (TestU01's (r, s)
    bit-extraction convention) — packed MSB-first in bytes for the
    scomp library."""
    nwords = -(-nbits // s)
    words = np.asarray(DRAWS.bits(key, (nwords,)))
    chunks = []
    for lo in range(0, nwords, 1 << 20):  # bound the unpacked bit matrix
        w = words[lo:lo + (1 << 20)]
        bits = np.unpackbits(w.astype(">u4").view(np.uint8))
        bits = bits.reshape(-1, 32)[:, r:r + s].ravel()
        chunks.append(bits)
    bits = np.concatenate(chunks)[:nbits]
    return np.packbits(bits)


def lempel_ziv(key, k=25, r=0, s=30, reps=10):
    """scomp_LempelZiv (Crush.cpp:765): the number of LZ78 phrases W in
    n = 2^k bits is asymptotically normal (Aldous & Shields 1988) with
    variance ~ 0.266 n / (lg n)^3 (Kirschenhofer-Prodinger-Szpankowski);
    the asymptotic MEAN expansion converges far too slowly to use at
    these n (at k=20 it is off by 38%), so the null mean/stdev are
    Monte-Carlo calibrated per k with two independent trusted
    generators (PCG64 + Philox, agreeing within MC error) — a
    calibrated stand-in law, declared as such in COMPONENTS.md.
    Degenerate (compressible) generators sit thousands of sigma low."""
    cal = {  # k -> (null mean, null stdev, calibration reps)
        18: (20761.71, 5.4, 1200),
        20: (72654.10, 8.5, 800),
        25: (1762965.65, 32.8, 320),
        27: (6422494.95, 54.8, 160),
    }
    if k not in cal:
        raise ValueError(f"no LempelZiv calibration for k={k}")
    mu, sg, rcal = cal[k]
    n = 1 << k
    W = np.empty(reps)
    for i in range(reps):
        b = _bit_stream(fold_in(key, i), n, r=r, s=s)
        W[i] = scomp.lz78_phrases(b, n)
    # fold the calibration uncertainty of mu into the z denominator
    z = (W.mean() - mu) / (sg * np.sqrt(1.0 / reps + 1.0 / rcal))
    return TestResult("LempelZiv", float(2.0 * stats.norm.sf(abs(z))))


def _lc_jumps(key, n, r):
    b = _bit_stream(key, n, r=r, s=1)
    return scomp.berlekamp_massey(b, n)


def linear_comp_jump(key, n=120000, r=0):
    """scomp_LinearComp "Jump" statistic (Crush.cpp:747): the number of
    jumps in the linear complexity profile of n random bits.  Jump
    heights are iid Geometric(1/2) (Niederreiter's profile theorem) and
    the profile climbs to ~n/2, so the jump count is the renewal count
    at t = n/2 with mean interarrival 2 and variance 2: asymptotically
    N(n/4, n/8) (MC-verified: n=120000 gives mean 30020+-8, var
    13939+-1394)."""
    jumps, L = _lc_jumps(key, n, r)
    z = (len(jumps) - n / 4.0) / np.sqrt(n / 8.0)
    return TestResult("LinearCompJump", float(2.0 * stats.norm.sf(abs(z))))


def linear_comp_size(key, n=120000, r=0):
    """scomp_LinearComp "Size" statistic: chi^2 of the jump-size
    histogram against the exact Geometric(1/2) law P(h) = 2^-h
    (tail-pooled at expected count >= 8)."""
    jumps, L = _lc_jumps(key, n, r)
    J = len(jumps)
    kmax = max(2, int(np.log2(max(J, 2) / 8.0)))  # pool tail: E >= 8
    obs = np.bincount(np.minimum(jumps, kmax + 1), minlength=kmax + 2)[1:]
    p = 0.5 ** np.arange(1, kmax + 1)
    probs = np.append(p, 1.0 - p.sum())  # tail mass
    x2 = ((obs - J * probs) ** 2 / (J * probs)).sum()
    return TestResult("LinearCompSize",
                      float(stats.chi2.sf(x2, kmax)))


SmallCrush: List[Callable] = [
    birthday_spacings,
    collision,
    gap,
    simp_poker,
    coupon_collector,
    max_of_t,
    weight_distrib,
    matrix_rank,
    hamming_indep,
    random_walk,
    ks_uniform,
    permutation,
    serial_pairs,
    autocorrelation,
]

#: Crush-scale battery: the SmallCrush-class exact-law tests at ~16-64x
#: the sample sizes PLUS the structurally distinct Crush families
#: (close pairs, gcd, spectral, overlapping serial/collision, Knuth
#: runs, longest-head-run, sample-product/mean/correlation, walk
#: last-return, Hamming-weight blocks) — matching the reference's Crush
#: battery composition (src/RNGTest/Crush.cpp; see COMPONENTS.md §2.8
#: for the per-family fidelity ledger).  Runtime is minutes, not hours:
#: generation is on-device and each test reduces to counts.
Crush: List[Callable] = [
    lambda k: close_pairs(k, n=2**10, t=2, reps=48),
    lambda k: close_pairs(k, n=2**10, t=3, reps=48),
    lambda k: gcd_test(k, n=2**18),
    lambda k: spectral_fourier(k, nblocks=2**6, L=2**14),
    lambda k: birthday_spacings(k, n=2**12, d=2**30, reps=64),
    lambda k: collision(k, n=2**16, d=2**26, reps=32),
    lambda k: gap(k, n=2**22),
    lambda k: simp_poker(k, n=2**20),
    lambda k: coupon_collector(k, n=2**20),
    lambda k: max_of_t(k, n=2**19, t=8, bins=64),
    lambda k: weight_distrib(k, n=2**19),
    lambda k: matrix_rank(k, n=1024, dim=64),
    lambda k: hamming_indep(k, n=2**17),
    lambda k: random_walk(k, n=2**16, steps=256),
    lambda k: ks_uniform(k, n=2**20),
    lambda k: permutation(k, n=2**19, t=6),
    lambda k: serial_pairs(k, n=2**20, d=128),
    lambda k: autocorrelation(k, n=2**22),
    lambda k: serial_over(k, n=2**20, d=128),
    lambda k: collision_over(k, n=2**18, d=2**13),
    lambda k: runs_up(k, n=2**20),
    lambda k: longest_head_run(k, nblocks=2**14, L=64),
    lambda k: sample_prod(k, m=2**16, t=8),
    lambda k: sample_mean(k, m=2**16, t=12),
    lambda k: sample_corr(k, n=2**20),
    lambda k: walk_last_return(k, nwalks=2**15, m=32),
    lambda k: hamming_weight_blocks(k, nblocks=2**17, L=32),
]

_CrushCore = list(Crush)  # the 23 distinct families, shared with BigCrush

#: second tranche: the scomp_ compression/complexity instances at the
#: reference's Crush parameters (Crush.cpp:747 LinearComp n=120000 at
#: r=0 and r=29, each yielding the Jump and Size statistics;
#: Crush.cpp:765 LempelZiv N=10 reps of 2^25 bits), plus parameter
#: points bringing Crush to TestU01's 96 test instances (Crush.cpp
#: sweeps each family over several sample size / dimension / window /
#: lag points between the SmallCrush and BigCrush scales)
Crush = Crush + [
    lambda k: linear_comp_jump(k, n=120000, r=0),
    lambda k: linear_comp_size(k, n=120000, r=0),
    lambda k: linear_comp_jump(k, n=120000, r=29),
    lambda k: linear_comp_size(k, n=120000, r=29),
    lambda k: lempel_ziv(k, k=25, r=0, s=30, reps=10),
    lambda k: birthday_spacings(k, n=2**10, d=2**28, reps=48),
    lambda k: birthday_spacings(k, n=2**9, d=2**25, reps=96),
    lambda k: collision(k, n=2**15, d=2**24, reps=24),
    lambda k: collision(k, n=2**13, d=2**20, reps=48),
    lambda k: collision(k, n=2**12, d=2**18, reps=48),
    lambda k: gap(k, n=2**21, alpha=0.0, beta=0.25, tmax=20),
    lambda k: gap(k, n=2**21, alpha=0.5, beta=0.75, tmax=20),
    lambda k: gap(k, n=2**22, alpha=0.0, beta=0.0625, tmax=40),
    lambda k: simp_poker(k, n=2**19, d=16, k=8),
    lambda k: simp_poker(k, n=2**19, d=8, k=16),
    lambda k: simp_poker(k, n=2**19, d=4, k=8),
    lambda k: coupon_collector(k, n=2**20, d=4, tmax=24),
    lambda k: coupon_collector(k, n=2**20, d=16, tmax=80),
    lambda k: max_of_t(k, n=2**19, t=4, bins=32),
    lambda k: max_of_t(k, n=2**19, t=16, bins=32),
    lambda k: weight_distrib(k, n=2**19, k=32, lo=0.0, hi=0.5),
    lambda k: weight_distrib(k, n=2**19, k=32, lo=0.0, hi=0.125),
    lambda k: weight_distrib(k, n=2**19, k=48, lo=0.25, hi=0.75),
    lambda k: matrix_rank(k, n=2048, dim=32),
    lambda k: matrix_rank(k, n=512, dim=96),
    lambda k: matrix_rank(k, n=256, dim=128),
    lambda k: hamming_indep(k, n=2**16),
    lambda k: hamming_indep(k, n=2**15),
    lambda k: hamming_weight_blocks(k, nblocks=2**16, L=64),
    lambda k: hamming_weight_blocks(k, nblocks=2**15, L=128),
    lambda k: hamming_weight_blocks(k, nblocks=2**17, L=16),
    lambda k: random_walk(k, n=2**15, steps=128),
    lambda k: random_walk(k, n=2**15, steps=512),
    lambda k: random_walk(k, n=2**14, steps=2048),
    lambda k: walk_last_return(k, nwalks=2**14, m=64),
    lambda k: walk_last_return(k, nwalks=2**13, m=128),
    lambda k: walk_last_return(k, nwalks=2**15, m=16),
    lambda k: ks_uniform(k, n=2**21),
    lambda k: ks_uniform(k, n=2**19),
    lambda k: permutation(k, n=2**19, t=3),
    lambda k: permutation(k, n=2**19, t=5),
    lambda k: permutation(k, n=2**18, t=7),
    lambda k: serial_pairs(k, n=2**21, d=64),
    lambda k: serial_pairs(k, n=2**20, d=256),
    lambda k: serial_pairs(k, n=2**19, d=32),
    lambda k: serial_over(k, n=2**20, d=64),
    lambda k: serial_over(k, n=2**20, d=256),
    lambda k: serial_over(k, n=2**19, d=32),
    lambda k: collision_over(k, n=2**17, d=2**12),
    lambda k: collision_over(k, n=2**18, d=2**14),
    lambda k: collision_over(k, n=2**16, d=2**11),
    lambda k: autocorrelation(k, n=2**22, lag=2),
    lambda k: autocorrelation(k, n=2**22, lag=4),
    lambda k: autocorrelation(k, n=2**21, lag=8),
    lambda k: autocorrelation(k, n=2**21, lag=16),
    lambda k: runs_up(k, n=2**21),
    lambda k: runs_up(k, n=2**19),
    lambda k: longest_head_run(k, nblocks=2**13, L=128),
    lambda k: longest_head_run(k, nblocks=2**15, L=32),
    lambda k: longest_head_run(k, nblocks=2**14, L=96),
    lambda k: sample_prod(k, m=2**15, t=4),
    lambda k: sample_prod(k, m=2**15, t=16),
    lambda k: sample_prod(k, m=2**14, t=24),
    lambda k: sample_mean(k, m=2**15, t=6),
    lambda k: sample_mean(k, m=2**15, t=16),
    lambda k: sample_mean(k, m=2**14, t=24),
    lambda k: sample_corr(k, n=2**21, lag=2),
    lambda k: sample_corr(k, n=2**20, lag=4),
    lambda k: sample_corr(k, n=2**19, lag=16),
]
assert len(Crush) == 96, len(Crush)  # TestU01 Crush's test count


#: BigCrush-scale battery (src/RNGTest/BigCrush.cpp): the same exact-law
#: families at multiple parameter points and 4-16x the Crush stream
#: sizes — the reference's BigCrush is likewise its Crush families
#: re-parameterized and enlarged (106 parameterized instances over the
#: same test structures).
BigCrush: List[Callable] = _CrushCore + [
    # the distinct-statistic families at BigCrush scale (snpair_
    # ClosePairs runs up to t=7 in BigCrush.cpp; smarsa_GCD and
    # sspectral_Fourier3 at enlarged streams)
    lambda k: close_pairs(k, n=2**11, t=3, reps=64),
    lambda k: close_pairs(k, n=2**10, t=7, reps=64),
    lambda k: gcd_test(k, n=2**20),
    lambda k: spectral_fourier(k, nblocks=2**7, L=2**15),
    lambda k: birthday_spacings(k, n=2**13, d=2**30, reps=128),
    lambda k: collision(k, n=2**18, d=2**28, reps=32),
    lambda k: gap(k, n=2**24, alpha=0.0, beta=0.0625, tmax=32),
    lambda k: gap(k, n=2**22, alpha=0.5, beta=0.625, tmax=32),
    lambda k: simp_poker(k, n=2**22),
    lambda k: coupon_collector(k, n=2**22, d=16, tmax=80),
    lambda k: max_of_t(k, n=2**21, t=16, bins=64),
    lambda k: weight_distrib(k, n=2**21),
    lambda k: matrix_rank(k, n=2048, dim=64),
    lambda k: hamming_indep(k, n=2**19),
    lambda k: random_walk(k, n=2**17, steps=512),
    lambda k: ks_uniform(k, n=2**22),
    lambda k: permutation(k, n=2**21, t=7),
    lambda k: serial_pairs(k, n=2**22, d=256),
    lambda k: autocorrelation(k, n=2**24, lag=1),
    lambda k: autocorrelation(k, n=2**24, lag=2),
    lambda k: serial_over(k, n=2**22, d=256),
    lambda k: collision_over(k, n=2**20, d=2**14),
    lambda k: runs_up(k, n=2**22),
    lambda k: longest_head_run(k, nblocks=2**16, L=64),
    lambda k: sample_prod(k, m=2**18, t=16),
    lambda k: sample_mean(k, m=2**18, t=20),
    lambda k: sample_corr(k, n=2**22, lag=2),
    lambda k: walk_last_return(k, nwalks=2**17, m=32),
    lambda k: hamming_weight_blocks(k, nblocks=2**19, L=32),
]

#: third tranche: the remaining parameter points that bring the battery
#: to the reference BigCrush's 106 instances (BigCrush.cpp runs each
#: family at several (sample size, dimension, window, lag) points; the
#: exact-law analogs below sweep the same axes)
BigCrush = BigCrush + [
    # birthday spacings at more dimensions (BigCrush: d = 2^7..2^30;
    # keep the collision intensity n^3/4d well below n so the Poisson
    # spacing law holds)
    lambda k: birthday_spacings(k, n=2**9, d=2**25, reps=256),
    lambda k: birthday_spacings(k, n=2**11, d=2**28, reps=192),
    # collisions at small/large cell counts
    lambda k: collision(k, n=2**16, d=2**22, reps=48),
    lambda k: collision(k, n=2**14, d=2**18, reps=64),
    # gap windows (BigCrush sweeps alpha/beta)
    lambda k: gap(k, n=2**22, alpha=0.0, beta=0.5, tmax=16),
    lambda k: gap(k, n=2**22, alpha=0.25, beta=0.75, tmax=16),
    lambda k: gap(k, n=2**23, alpha=0.0, beta=0.03125, tmax=48),
    lambda k: gap(k, n=2**22, alpha=0.9375, beta=1.0, tmax=48),
    # poker at more alphabet sizes / hand widths
    lambda k: simp_poker(k, n=2**20, d=16, k=16),
    lambda k: simp_poker(k, n=2**20, d=32, k=8),
    lambda k: simp_poker(k, n=2**20, d=4, k=16),
    # coupon collector at more alphabet sizes
    lambda k: coupon_collector(k, n=2**21, d=4, tmax=24),
    lambda k: coupon_collector(k, n=2**21, d=32, tmax=160),
    # max-of-t at more tuple widths
    lambda k: max_of_t(k, n=2**20, t=4, bins=64),
    lambda k: max_of_t(k, n=2**20, t=32, bins=64),
    # weight distribution at more windows (BigCrush: several [lo,hi))
    lambda k: weight_distrib(k, n=2**20, k=32, lo=0.0, hi=0.25),
    lambda k: weight_distrib(k, n=2**20, k=32, lo=0.0, hi=0.0625),
    lambda k: weight_distrib(k, n=2**20, k=32, lo=0.75, hi=1.0),
    # matrix ranks at more shapes
    lambda k: matrix_rank(k, n=4096, dim=32),
    lambda k: matrix_rank(k, n=512, dim=128),
    # hamming independence / weights at more block sizes
    lambda k: hamming_indep(k, n=2**18),
    lambda k: hamming_weight_blocks(k, nblocks=2**18, L=64),
    lambda k: hamming_weight_blocks(k, nblocks=2**16, L=128),
    # random walks at more lengths (BigCrush: L = 50..10000)
    lambda k: random_walk(k, n=2**16, steps=64),
    lambda k: random_walk(k, n=2**15, steps=1024),
    lambda k: walk_last_return(k, nwalks=2**16, m=64),
    lambda k: walk_last_return(k, nwalks=2**15, m=128),
    # uniformity / spacing at full BigCrush stream sizes
    lambda k: ks_uniform(k, n=2**23),
    # permutations at the remaining orders
    lambda k: permutation(k, n=2**20, t=3),
    # serial pairs / overlapping serial at more dimensions
    lambda k: serial_pairs(k, n=2**22, d=64),
    lambda k: serial_pairs(k, n=2**21, d=512),
    lambda k: serial_over(k, n=2**21, d=512),
    lambda k: collision_over(k, n=2**19, d=2**12),
    lambda k: collision_over(k, n=2**18, d=2**16),
    # autocorrelation at more lags
    lambda k: autocorrelation(k, n=2**23, lag=4),
    lambda k: autocorrelation(k, n=2**23, lag=8),
    lambda k: autocorrelation(k, n=2**22, lag=16),
    # runs at doubled stream
    lambda k: runs_up(k, n=2**23),
    lambda k: longest_head_run(k, nblocks=2**17, L=32),
    # sample statistics at more tuple widths / lags
    lambda k: sample_prod(k, m=2**17, t=4),
    lambda k: sample_prod(k, m=2**17, t=24),
    lambda k: sample_mean(k, m=2**17, t=16),
    lambda k: sample_corr(k, n=2**22, lag=4),
    lambda k: sample_corr(k, n=2**21, lag=8),
    # scomp_ compression/complexity at the reference's BigCrush
    # parameters (BigCrush.cpp:860-886: LinearComp n=400020 at r=0 and
    # r=29, Jump+Size each; LempelZiv N=10 reps of 2^27 bits at
    # (r=0,s=30) and (r=15,s=15))
    lambda k: linear_comp_jump(k, n=400020, r=0),
    lambda k: linear_comp_size(k, n=400020, r=0),
    lambda k: linear_comp_jump(k, n=400020, r=29),
    lambda k: linear_comp_size(k, n=400020, r=29),
    lambda k: lempel_ziv(k, k=27, r=0, s=30, reps=10),
    lambda k: lempel_ziv(k, k=27, r=15, s=15, reps=10),
]
assert len(BigCrush) == 106, len(BigCrush)  # BigCrush.cpp's instance count


def run_battery(seed: int = 0, battery=None, impl: str = "threefry2x32",
                device=DEFAULT_DEVICE, x64: bool = False):
    """Run a battery on ``device`` (the card unless the caller asks for
    another) with jax's x64 flag ``x64``: test i draws from
    fold_in(key(seed), i).  Returns (results, failed_names).  Only the
    threefry2x32 family is ported."""
    if impl != "threefry2x32":
        raise ValueError(f"rngtest impl {impl!r}: the port has "
                         "threefry2x32 only")
    battery = battery or SmallCrush
    DRAWS.device = resolve_device(device)
    DRAWS.x64 = x64
    k = threefry.key(seed)
    results = [test(fold_in(k, i)) for i, test in enumerate(battery)]
    failed = [r.name for r in results if not r.passed]
    return results, failed
