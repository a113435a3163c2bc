"""Base toolkit: the per-phase wall-clock profiler and the torch trace,
the timer, the progress meter, the tabulated function and the load
distributor (the port's own copies of quinoa_tpu/base's PhaseProfiler,
Timer, Progress, Table and linear_load_distributor)."""

from .load import linear_load_distributor
from .profiler import PhaseProfiler, torch_trace
from .progress import Progress
from .table import Table
from .timer import Timer

__all__ = ["PhaseProfiler", "Progress", "Table", "Timer",
           "linear_load_distributor", "torch_trace"]
