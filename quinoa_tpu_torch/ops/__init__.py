"""Quadrature, basis, Riemann solvers and the DG kernel wrappers."""
