"""Base toolkit: the per-phase wall-clock profiler and the torch trace,
the timer, the progress meter and the tabulated function (the port's own
copies of quinoa_tpu/base's PhaseProfiler, Timer, Progress and Table)."""

from .profiler import PhaseProfiler, torch_trace
from .progress import Progress
from .table import Table
from .timer import Timer

__all__ = ["PhaseProfiler", "Progress", "Table", "Timer", "torch_trace"]
