"""Counter-based random number generation.

The port's own copy of quinoa_tpu/rng/rng.py, the counterpart of the
reference's tk::RNG wrapper over Random123 (src/RNG/RNG.hpp:35-63):
numbered streams are keys folded from the seed's key, and every draw is
the same as the JAX package's from the same key (``threefry``).  Only
the threefry family is ported; the JAX package's other ``impl`` values
name TPU generators.
"""

from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE
from . import threefry


class RNG:
    """Value-semantic RNG with numbered streams (tk::RNG analog).  Its
    samplers draw on ``device``, the card unless the caller asks for
    another (rng.threefry resolves it)."""

    def __init__(self, seed: int = 0, impl: str = "threefry"):
        if impl != "threefry":
            raise ValueError(f"RNG impl {impl!r}: the port has threefry only")
        self.impl = impl
        self.key = threefry.key(seed)

    def stream(self, i: int) -> threefry.Key:
        return threefry.fold_in(self.key, i)

    @staticmethod
    def uniform(key, shape, dtype=None, device=DEFAULT_DEVICE):
        return threefry.uniform(key, shape, dtype or torch.get_default_dtype(),
                                device)

    @staticmethod
    def gaussian(key, shape, dtype=None, device=DEFAULT_DEVICE):
        return threefry.normal(key, shape, dtype or torch.get_default_dtype(),
                               device)

    @staticmethod
    def beta(key, a, b, shape, dtype=None, device=DEFAULT_DEVICE):
        return threefry.beta(key, a, b, shape,
                             dtype or torch.get_default_dtype(), device)

    @staticmethod
    def gamma(key, a, shape, scale=1.0, dtype=None,
              device=DEFAULT_DEVICE):
        dtype = dtype or torch.get_default_dtype()
        return threefry.gamma(key, a, shape, dtype, device) * scale
