"""Stochastic/ordinary differential equation systems (the walker's
kernels) and their particle initialization policies.

The port's own copy of quinoa_tpu/diffeq (the reference's src/DiffEq/):
each system's ``advance`` is an ensemble-vectorized Euler-Maruyama
update of the (npar, nprop) particle tensor, its Gaussian increments the
same Threefry draws as the JAX package's (rng.threefry).
"""

from .systems import (
    DiagOrnsteinUhlenbeck,
    OrnsteinUhlenbeck,
    Beta,
    NumberFractionBeta,
    MassFractionBeta,
    MixNumberFractionBeta,
    MixMassFractionBeta,
    Dirichlet,
    GeneralizedDirichlet,
    MixDirichlet,
    Gamma,
    SkewNormal,
    WrightFisher,
    Position,
    Dissipation,
    Velocity,
)
from .initpolicy import (
    init_zero,
    init_raw,
    init_jointdelta,
    init_jointbeta,
    init_jointgaussian,
    init_jointcorrgaussian,
    init_jointgamma,
    init_jointdirichlet,
)

__all__ = [
    "DiagOrnsteinUhlenbeck",
    "OrnsteinUhlenbeck",
    "Beta",
    "NumberFractionBeta",
    "MassFractionBeta",
    "MixNumberFractionBeta",
    "MixMassFractionBeta",
    "Dirichlet",
    "GeneralizedDirichlet",
    "MixDirichlet",
    "Gamma",
    "SkewNormal",
    "WrightFisher",
    "Position",
    "Dissipation",
    "Velocity",
    "init_zero",
    "init_raw",
    "init_jointdelta",
    "init_jointbeta",
    "init_jointgaussian",
    "init_jointcorrgaussian",
    "init_jointgamma",
    "init_jointdirichlet",
]
