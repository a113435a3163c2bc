"""The DG(P1), ALECG and DiagCG solvers and their diagnostics."""

from .alecg import ALECGSolver, make_alecg
from .dg import DGDiagnostics, DGSolver, DGState
from .diagcg import CGState, DiagCGSolver, diagcg_advance
from .diagnostics import Diagnostics

__all__ = ["ALECGSolver", "CGState", "DGDiagnostics", "DGSolver", "DGState",
           "DiagCGSolver", "Diagnostics", "diagcg_advance", "make_alecg"]
