"""Particle initialization policies.

The port's own copy of quinoa_tpu/diffeq/initpolicy.py (the reference's
InitPolicy.hpp: RAW, ZERO, JOINTDELTA, JOINTBETA, JOINTGAUSSIAN,
JOINTCORRGAUSSIAN, JOINTGAMMA, JOINTDIRICHLET): functions
(key, npar, ..., dtype, device) -> (npar, ncomp) tensors drawing the same
numbers from the same keys as the JAX package (rng.threefry).  dtype None
is torch's default float; device is the card unless the caller asks for
another.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..rng import threefry


def _dtype(dtype):
    return dtype or torch.get_default_dtype()


def init_raw(key, npar, ncomp, dtype=None, device=DEFAULT_DEVICE):
    """Leave particles as-is (zeros here; the reference leaves memory raw)."""
    return torch.zeros((npar, ncomp), dtype=_dtype(dtype),
                       device=resolve_device(device))


def init_zero(key, npar, ncomp, dtype=None, device=DEFAULT_DEVICE):
    return torch.zeros((npar, ncomp), dtype=_dtype(dtype),
                       device=resolve_device(device))


def init_jointdelta(key, npar, spikes: Sequence[Sequence[Tuple[float, float]]],
                    dtype=None, device=DEFAULT_DEVICE):
    """Spikes per component: [(value, probability), ...]; probabilities sum
    to 1 per component."""
    dtype, device = _dtype(dtype), resolve_device(device)
    cols = []
    for c, sp in enumerate(spikes):
        vals = torch.tensor([v for v, _ in sp], dtype=dtype, device=device)
        probs = np.asarray([p for _, p in sp])
        if not np.isclose(probs.sum(), 1.0):
            raise ValueError("spike probabilities must sum to 1")
        idx = threefry.choice(threefry.fold_in(key, c), len(sp), (npar,),
                              probs, dtype, device)
        cols.append(vals[idx])
    return torch.stack(cols, dim=1)


def init_jointbeta(key, npar,
                   betapdf: Sequence[Tuple[float, float, float, float]],
                   dtype=None, device=DEFAULT_DEVICE):
    """Per component (alpha, beta, lo, extent): lo + extent*Beta(a,b)."""
    dtype, device = _dtype(dtype), resolve_device(device)
    cols = []
    for c, (a, b, lo, ext) in enumerate(betapdf):
        x = threefry.beta(threefry.fold_in(key, c), a, b, (npar,), dtype,
                          device)
        cols.append(ext * x + lo)
    return torch.stack(cols, dim=1)


def init_jointgaussian(key, npar, gaussians: Sequence[Tuple[float, float]],
                       dtype=None, device=DEFAULT_DEVICE):
    """Per component (mean, variance), independent."""
    dtype, device = _dtype(dtype), resolve_device(device)
    mu = torch.tensor([m for m, _ in gaussians], dtype=dtype, device=device)
    sd = torch.sqrt(torch.tensor([v for _, v in gaussians], dtype=dtype,
                                 device=device))
    z = threefry.normal(key, (npar, len(gaussians)), dtype, device)
    return mu + sd * z


def init_jointcorrgaussian(key, npar, mean, cov, dtype=None,
                           device=DEFAULT_DEVICE):
    """Correlated joint Gaussian with full covariance (Cholesky)."""
    dtype, device = _dtype(dtype), resolve_device(device)
    mu = torch.tensor(mean, dtype=dtype, device=device)
    L = torch.linalg.cholesky(torch.tensor(cov, dtype=dtype, device=device))
    z = threefry.normal(key, (npar, mu.shape[0]), dtype, device)
    return mu + z @ L.T


def init_jointgamma(key, npar, gammas: Sequence[Tuple[float, float]],
                    dtype=None, device=DEFAULT_DEVICE):
    """Per component (shape, scale), independent."""
    dtype, device = _dtype(dtype), resolve_device(device)
    cols = []
    for c, (a, scale) in enumerate(gammas):
        cols.append(scale * threefry.gamma(threefry.fold_in(key, c), a,
                                           (npar,), dtype, device))
    return torch.stack(cols, dim=1)


def init_jointdirichlet(key, npar, alphas, dtype=None,
                        device=DEFAULT_DEVICE):
    """Dirichlet(alpha_1..alpha_N) samples via normalized unit-scale
    gammas (InitPolicy.hpp:320-355): returns (npar, N) with sum 1."""
    dtype, device = _dtype(dtype), resolve_device(device)
    cols = [threefry.gamma(threefry.fold_in(key, c), a, (npar,), dtype,
                           device) for c, a in enumerate(alphas)]
    Y = torch.stack(cols, dim=1)
    return Y / Y.sum(dim=1, keepdim=True)
