"""Threefry-2x32 streams that reproduce jax.random's, bit for bit.

The port's own copy of the parts of jax.random the walker draws from
(jax 0.9.0 with ``jax_threefry_partitionable`` on, its default): the
Threefry-2x32 hash (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC'11 -- the reference's Random123 generator), the key
arithmetic (seed, fold_in, split), random bits, and the uniform, normal,
categorical (``choice`` with probabilities), gamma and beta samplers
built on them.

A key is a pair of Python ints in [0, 2^32): deriving one (a per-step
``fold_in``) costs no device launch.  Samplers take the key, the shape,
the dtype and the device (the card unless the caller asks for another,
as the port's builders), and return a tensor there.  The 32-bit words
live in int64 tensors, every add and shift masked to 32 bits: torch has
no shifts on uint32 on the CPU.  The same functions take Python ints,
which is how the keys are hashed on the host.

``normal`` is sqrt(2) * erfinv(u) with XLA's erfinv polynomial (the
constants of its float32 and float64 expansions, copied below), not
torch.erfinv, which is a different approximation.

Random bits, uniforms, normals, choices and the gamma sampler's
acceptance decisions and log-space values are the same bits on the card
and on the CPU: every log and square root they take is the module's own
(``_log64``, ``_log1p64``, ``_sqrt``), built from IEEE additions,
multiplications and divisions, because the card's torch.log and
torch.sqrt round differently from the CPU's for about 1% of float64
arguments.  Two last steps stay torch's and may differ by an ulp between
devices: the power that scales a gamma draw with alpha < 1, and the
exponentials that turn beta's two log-gammas into a ratio.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ..device import DEFAULT_DEVICE, resolve_device

#: a threefry key: two 32-bit words
Key = Tuple[int, int]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds of the hash jax lowers
    (jax/_src/prng.py _threefry2x32_lowering): keys and counters are
    Python ints or int64 tensors holding 32-bit words, broadcast
    together; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + (ks[(i + 2) % 3] + i + 1)) & M32
    return x1, x2


def key(seed: int) -> Key:
    """jax.random.key(seed) for threefry2x32: the seed's high and low
    32-bit words (prng.py threefry_seed)."""
    seed = int(seed)
    return (seed >> 32) & M32, seed & M32


def fold_in(k: Key, data: int) -> Key:
    """jax.random.fold_in: the hash of (0, data) under k."""
    return threefry2x32(k[0], k[1], 0, int(data) & M32)


def split(k: Key, num: int = 2):
    """jax.random.split(k, num) as a list of keys: key i is the hash of
    the counter i's high and low words under k."""
    return [threefry2x32(k[0], k[1], i >> 32, i & M32) for i in range(num)]


def _counters(shape, device):
    """The flat index of every element of shape, as its high and low
    32-bit words (prng.py iota_2x32_shape)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & M32


def _bit_words(k, shape, device):
    """The two hash words of each element of shape under k
    (_threefry_random_bits_partitionable before they are combined)."""
    hi, lo = _counters(tuple(shape), device)
    return threefry2x32(k[0], k[1], hi, lo)


def random_bits(k: Key, shape: Sequence[int], width: int = 32,
                device=DEFAULT_DEVICE) -> torch.Tensor:
    """jax.random.bits(k, shape, uint32 or uint64) as an int64 tensor:
    32-bit draws are the xor of the two words, 64-bit draws their
    concatenation (a uint64 reinterpreted as int64)."""
    device = resolve_device(device)
    b1, b2 = _bit_words(k, shape, device)
    if width == 32:
        return b1 ^ b2
    if width == 64:
        return (b1 << 32) | b2
    raise ValueError("width must be 32 or 64")


_ONE_BITS = {torch.float32: 0x3F800000, torch.float64: 0x3FF0000000000000}


def _unit(b1, b2, dtype):
    """Floats in [0, 1) from the hash words, as jax's _uniform: the top
    mantissa bits of the draw under the exponent of 1.0, minus 1."""
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | _ONE_BITS[dtype]
        f = bits.to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        # the uint64 draw (b1 << 32 | b2) >> 12, built without a signed
        # 64-bit shift
        bits = (b1 << 20) | (b2 >> 12) | _ONE_BITS[dtype]
        f = bits.view(torch.float64)
    else:
        raise TypeError(f"uniform takes float32 or float64, not {dtype}")
    return f - 1.0


def uniform(k: Key, shape: Sequence[int], dtype=torch.float64,
            device=DEFAULT_DEVICE) -> torch.Tensor:
    """jax.random.uniform(k, shape, dtype): [0, 1) in dtype."""
    device = resolve_device(device)
    return _unit(*_bit_words(k, shape, device), dtype)


# XLA's erfinv (StableHLO's chlo.erf_inv expansion, as jax 0.9.0 compiles
# it for the CPU): w = -log1p(-x^2), then a polynomial in a shifted w or
# sqrt(w), one coefficient set per branch, highest order first.
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),                                   # w < 5, in w - 2.5
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
     2.83297682),                                   # w >= 5, in sqrt(w) - 3
)
_ERFINV64 = (
    (-3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
     1.1157877678025181e-17, -1.3331716628546209e-16,
     2.0972767875968562e-17, 6.6376381343583238e-15,
     -4.0545662729752069e-14, -8.1519341976054722e-14,
     2.6335093153082323e-12, -1.2975133253453532e-11,
     -5.4154120542946279e-11, 1.0512122733215323e-09,
     -4.1126339803469837e-09, -2.9070369957882005e-08,
     4.2347877827932404e-07, -1.3654692000834679e-06,
     -1.3882523362786469e-05, 0.00018673420803405714,
     -0.000740702534166267, -0.0060336708714301491, 0.24015818242558962,
     1.6536545626831027),  # w < 6.25, in w - 3.125
    (2.2137376921775787e-09, 9.0756561938885391e-08,
     -2.7517406297064545e-07, 1.8239629214389228e-08,
     1.5027403968909828e-06, -4.013867526981546e-06,
     2.9234449089955446e-06, 1.2475304481671779e-05,
     -4.7318229009055734e-05, 6.8284851459573175e-05,
     2.4031110387097894e-05, -0.00035503752036284748,
     0.0009532893797373805, -0.0016882755560235047, 0.0024914420961078508,
     -0.0037512085075692412, 0.0053709145535900636, 1.0052589676941592,
     3.0838856104922208),  # w < 16, in sqrt(w) - 3.25
    (-2.7109920616438573e-11, -2.5556418169965252e-10,
     1.5076572693500548e-09, -3.789465440126737e-09, 7.61570120807834e-09,
     -1.496002662714924e-08, 2.9147953450901081e-08,
     -6.7711997758452339e-08, 2.2900482228026655e-07, -9.9298272942317e-07,
     4.5260625972231537e-06, -1.9681778105531671e-05,
     7.5995277030017761e-05, -0.00021503011930044477,
     -0.00013871931833623122, 1.0103004648645344,
     4.8499064014085844),  # w >= 16, in sqrt(w) - 5
)


#: XLA's float64 log1p (Cephes): x - x^2/2 + x^3 P(x)/Q(x) for
#: |x| < sqrt(2) - 1, log(1 + x) beyond
_LOG1P64_P = (4.52700008624452e-05, 0.49854102823193375, 6.578732594206104,
              29.911919328553072, 60.94966798098779, 57.11296359058554,
              20.039553499201283)
_LOG1P64_Q = (1.0, 15.062909083469192, 83.04756596796722,
              221.76239823732857, 309.09872225312057, 216.42788614495947,
              60.11866049760384)
_LOG1P64_SMALL = 0.41421356237309503


def _horner(coeffs, z):
    p = torch.full_like(z, coeffs[0])
    for c in coeffs[1:]:
        p = p * z + c
    return p


#: fdlibm's e_log.c: ln2 split in two, and the polynomial in s^2 of
#: log((1 + s) / (1 - s))
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_LG = (6.666666666666735130e-01, 3.999999999940941908e-01,
       2.857142874366239149e-01, 2.222219843214978396e-01,
       1.818357216161805012e-01, 1.531383769920937332e-01,
       1.479819860511658591e-01)


def _log64(x):
    """log of positive normal float64 x by fdlibm's algorithm (within an
    ulp of the correctly rounded value) in IEEE additions,
    multiplications and divisions alone, so every device rounds it
    alike: x = 2^k (1 + f) with 1 + f in [sqrt(2)/2, sqrt(2)),
    log(1 + f) = f - (f^2/2 - s (f^2/2 + R(s^2))), s = f / (2 + f)."""
    m, e = torch.frexp(x)                     # m in [0.5, 1)
    low = m < 0.7071067811865476
    m = torch.where(low, m * 2.0, m)
    k = (e - low.to(e.dtype)).to(x.dtype)
    f = m - 1.0
    s = f / (2.0 + f)
    z = s * s
    w = z * z
    t1 = w * (_LG[1] + w * (_LG[3] + w * _LG[5]))
    t2 = z * (_LG[0] + w * (_LG[2] + w * (_LG[4] + w * _LG[6])))
    R = t2 + t1
    hfsq = 0.5 * f * f
    return k * _LN2_HI - ((hfsq - (s * (hfsq + R) + k * _LN2_LO)) - f)


_SPLIT = 134217729.0  # 2^27 + 1: Veltkamp's split of a float64


def _sqrt(x):
    """The correctly rounded square root (XLA's), on every device:
    torch.sqrt is an ulp off it for about 1% of arguments, on the CPU
    and on the card, and differently on each.  A float64 root takes one
    correction by the exact residual x - r^2 (Dekker's product); a
    float32 root is the float64 one rounded (innocuous double rounding
    for a square root)."""
    if x.dtype == torch.float32:
        return _sqrt(x.double()).float()
    r = torch.sqrt(x)
    t = r * _SPLIT
    hi = t - (t - r)
    lo = r - hi
    p = r * r
    q = ((hi * hi - p) + 2.0 * (hi * lo)) + lo * lo     # r^2 = p + q
    return r + ((x - p) - q) / (2.0 * r)


def _log1p64(x):
    """XLA's float64 log-plus-one: its CPU emitter's Cephes rational below
    sqrt(2) - 1, within an ulp of it where torch.log1p is 128 off near
    the switch, log(1 + x) beyond (by _log64).  Every operation is an
    IEEE one, so the card and the CPU give the same bits."""
    x2 = x * x
    small = x + (x2 * -0.5 + (x * x2) * (_horner(_LOG1P64_P, x)
                                          / _horner(_LOG1P64_Q, x)))
    return torch.where(x.abs() < _LOG1P64_SMALL, small,
                       _log64(torch.clamp(x + 1.0, min=1e-300)))


def _log(x):
    """log of x >= 0 by _log64 in either precision (float32 through
    float64, rounded once), -inf at 0."""
    y = _log64(x.double() if x.dtype == torch.float32 else x)
    y = torch.where(x == 0.0, -math.inf, y)
    return y.to(x.dtype)


def _log1p(x):
    """log(1 + x) for x > -1 by _log1p64 in either precision."""
    return _log1p64(x.double() if x.dtype == torch.float32 else x).to(x.dtype)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's erf_inv for float32 and float64, operation for operation:
    each branch's polynomial is evaluated on the whole tensor and the
    branch of each element selected, as XLA's selects do."""
    if x.dtype == torch.float32:
        # log1p in float64, rounded once: the same float32 w on every
        # device (XLA's own float32 log1p is within 2 ulps of it)
        w = (-_log1p64((-x * x).double())).float()
        small = w < 5.0
        z = torch.where(small, w - 2.5, _sqrt(w) - 3.0)
        p = torch.where(small, _horner(_ERFINV32[0], z),
                        _horner(_ERFINV32[1], z))
    elif x.dtype == torch.float64:
        w = -_log1p64(-x * x)
        small = w < 6.25
        mid = w < 16.0
        r = _sqrt(w)
        z = torch.where(small, w - 3.125,
                        torch.where(mid, r - 3.25, r - 5.0))
        p = torch.where(small, _horner(_ERFINV64[0], z),
                        torch.where(mid, _horner(_ERFINV64[1], z),
                                    _horner(_ERFINV64[2], z)))
    else:
        raise TypeError(f"erfinv takes float32 or float64, not {x.dtype}")
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _normal_from_words(b1, b2, dtype):
    """jax's _normal_real from the hash words: sqrt(2) erfinv(u), u on
    [lo, 1) with lo = nextafter(-1, 0) in dtype.  jax scales the unit
    draw as max(lo, unit * (1 - lo) + lo); 1 - lo rounds to 2 in both
    precisions, so the product is exact and XLA's fused multiply-add
    rounds as the two operations here do."""
    lo = -1.0 + float(torch.finfo(dtype).eps) / 2.0
    u = torch.clamp(_unit(b1, b2, dtype) * 2.0 + lo, min=lo)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype).item()
    return erfinv(u) * sqrt2


def normal(k: Key, shape: Sequence[int], dtype=torch.float64,
           device=DEFAULT_DEVICE) -> torch.Tensor:
    """jax.random.normal: sqrt(2) erfinv(u) with u uniform on
    [nextafter(-1, 0), 1) in dtype."""
    device = resolve_device(device)
    return _normal_from_words(*_bit_words(k, shape, device), dtype)


def choice(k: Key, n: int, shape: Sequence[int], p, dtype=torch.float64,
           device=DEFAULT_DEVICE) -> torch.Tensor:
    """jax.random.choice(k, n, shape, p=p) with replacement: the first
    index whose cumulative probability reaches c[-1] (1 - u)."""
    device = resolve_device(device)
    c = torch.cumsum(torch.as_tensor(p, dtype=dtype, device=device), 0)
    if c.numel() != n:
        raise ValueError(f"p has {c.numel()} entries for {n} choices")
    r = c[-1] * (1.0 - uniform(k, shape, dtype, device))
    return torch.searchsorted(c, r.reshape(-1)).reshape(tuple(shape))


def _split_words(k1, k2, i):
    """Key i of split(key, num) for a batch of keys (k1, k2)."""
    return threefry2x32(k1, k2, 0, i)


def _gamma_batch(k1, k2, alpha, log_space):
    """Marsaglia and Tsang's gamma sampler (jax/_src/random.py
    _gamma_one) on a batch: element e draws from its own key (k1[e],
    k2[e]), in the order _gamma_one draws, and the loops run until every
    element has left them, each element's state frozen once it has, as
    jax's batched while loops do.  Returns log-gamma samples if
    log_space, else gamma samples."""
    dtype = alpha.dtype
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - 1.0 / 3.0
    c = torch.full_like(d, 1.0 / 3.0) / _sqrt(d)
    sub1, sub2 = _split_words(k1, k2, 1)
    k1, k2 = _split_words(k1, k2, 0)
    X = torch.zeros_like(alpha)
    V = torch.ones_like(alpha)
    U = torch.full_like(alpha, 2.0)

    def rejected(X, V, U):
        return (U >= 1.0 - 0.0331 * (X * X)) & (
            _log(U) >= X * 0.5 + d * ((1.0 - V) + _log(V)))

    todo = rejected(X, V, U)
    while bool(todo.any()):
        xk1, xk2 = _split_words(k1, k2, 1)
        uk1, uk2 = _split_words(k1, k2, 2)
        n1, n2 = _split_words(k1, k2, 0)
        x = torch.zeros_like(alpha)
        v = torch.full_like(alpha, -1.0)
        again = v <= 0.0
        while bool(again.any()):
            s1, s2 = _split_words(xk1, xk2, 1)
            nk1, nk2 = _split_words(xk1, xk2, 0)
            xn = _normal_from_words(*threefry2x32(s1, s2, 0, 0), dtype)
            vn = 1.0 + xn * c
            xk1 = torch.where(again, nk1, xk1)
            xk2 = torch.where(again, nk2, xk2)
            x = torch.where(again, xn, x)
            v = torch.where(again, vn, v)
            again = v <= 0.0
        Un = _unit(*threefry2x32(uk1, uk2, 0, 0), dtype)
        k1 = torch.where(todo, n1, k1)
        k2 = torch.where(todo, n2, k2)
        X = torch.where(todo, x * x, X)
        V = torch.where(todo, (v * v) * v, V)
        U = torch.where(todo, Un, U)
        todo = rejected(X, V, U)
    u = _unit(*threefry2x32(sub1, sub2, 0, 0), dtype)
    inv_alpha = torch.ones_like(alpha) / alpha
    if log_space:
        logs = _log1p(-u)
        log_boost = torch.where(boost | (logs == 0.0),
                                torch.zeros_like(alpha), logs * inv_alpha)
        return (_log(d) + _log(V)) + log_boost
    samples = 1.0 - u
    scale = torch.where(boost, torch.ones_like(alpha),
                        torch.pow(samples, inv_alpha))
    return (d * V) * scale


def _gamma(k: Key, a, shape, dtype, device, log_space):
    shape = tuple(shape)
    alpha = torch.broadcast_to(torch.as_tensor(a, dtype=dtype, device=device),
                               shape).reshape(-1)
    # one key per element: split(k, size), as jax's _gamma_impl
    k1, k2 = _bit_words(k, (alpha.numel(),), device)
    return _gamma_batch(k1, k2, alpha.contiguous(), log_space).reshape(shape)


def gamma(k: Key, a, shape: Sequence[int], dtype=torch.float64,
          device=DEFAULT_DEVICE) -> torch.Tensor:
    """jax.random.gamma(k, a, shape): unit-scale Gamma(a) samples."""
    device = resolve_device(device)
    return _gamma(k, a, shape, dtype, device, log_space=False)


def loggamma(k: Key, a, shape: Sequence[int], dtype=torch.float64,
             device=DEFAULT_DEVICE) -> torch.Tensor:
    """jax.random.loggamma(k, a, shape): log of Gamma(a) samples."""
    device = resolve_device(device)
    return _gamma(k, a, shape, dtype, device, log_space=True)


def beta(k: Key, a, b, shape: Sequence[int], dtype=torch.float64,
         device=DEFAULT_DEVICE) -> torch.Tensor:
    """jax.random.beta(k, a, b, shape): two log-gammas from split(k),
    combined as ga / (ga + gb) after subtracting their maximum."""
    ka, kb = split(k)
    lga = loggamma(ka, a, shape, dtype, device)
    lgb = loggamma(kb, b, shape, dtype, device)
    m = torch.maximum(lga, lgb)
    ga = torch.exp(lga - m)
    gb = torch.exp(lgb - m)
    return ga / (ga + gb)
