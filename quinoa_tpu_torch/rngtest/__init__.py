"""The rngtest batteries (the port's own copy of quinoa_tpu/rngtest):
SmallCrush, Crush and BigCrush over jax.random's Threefry streams drawn
on the card, statistics on the host."""

from .battery import BigCrush, Crush, SmallCrush, TestResult, run_battery

__all__ = ["SmallCrush", "Crush", "BigCrush", "run_battery", "TestResult"]
