"""Base toolkit: the per-phase wall-clock profiler and the tabulated
function (the port's own copies of quinoa_tpu/base's PhaseProfiler and
Table)."""

from .profiler import PhaseProfiler
from .table import Table

__all__ = ["PhaseProfiler", "Table"]
