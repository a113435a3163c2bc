"""The DG(P1) and ALECG solvers and their diagnostics."""

from .alecg import ALECGSolver, make_alecg
from .dg import DGDiagnostics, DGSolver, DGState
from .diagcg import CGState
from .diagnostics import Diagnostics

__all__ = ["ALECGSolver", "CGState", "DGDiagnostics", "DGSolver", "DGState",
           "Diagnostics", "make_alecg"]
