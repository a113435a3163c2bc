"""Counter-based random numbers: the port's Threefry-2x32 streams, the
same draws as quinoa_tpu's jax.random streams (``threefry``), and the
``RNG`` wrapper the walker and its tests use (``rng``)."""

from .rng import RNG

__all__ = ["RNG"]
