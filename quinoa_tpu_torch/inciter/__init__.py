"""The DG(P1) solver and its diagnostics."""

from .dg import DGDiagnostics, DGSolver, DGState

__all__ = ["DGDiagnostics", "DGSolver", "DGState"]
