"""Base toolkit: the per-phase wall-clock profiler (the port's own copy
of quinoa_tpu/base's PhaseProfiler)."""

from .profiler import PhaseProfiler

__all__ = ["PhaseProfiler"]
