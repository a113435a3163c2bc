"""Plain reference of sedov_dgp1: Euler, HLLC, Superbee, SSP-RK3 DG(P1)
from the deck's settings, with the Sedov initial state of Quinoa's
src/PDE/CompFlow/Problem/SedovBlastwave.cpp (a hot corner column
x, y < 0.05 at p = 783.4112 in a gas at rest, density 1, p = 1e-6)."""

import torch

from reference import dg, euler, geometry
from reference.deck import parse

P_HOT, P_AMBIENT, RCORNER = 783.4112, 1.0e-6, 0.05


def initialize(xyz, system):
    x, y = xyz[0], xyz[1]
    hot = (x < RCORNER) & (y < RCORNER)
    p = torch.where(hot, torch.full_like(x, P_HOT), torch.full_like(x, P_AMBIENT))
    z = torch.zeros_like(x)
    return torch.stack([torch.ones_like(x), z, z, z, p / (system.gamma - 1.0)])


def make(deck_text, mesh, device, precision):
    """The float64 reference solver of the deck on the raw mesh
    {coords, inpoel, bface}, its elements in Hilbert order, its initial
    state sampled at quadrature points in the configuration's
    precision."""
    d = parse(deck_text)
    if (d["scheme"], d["limiter"], d["flux"] or "hllc") != ("dgp1", "superbeep1", "hllc"):
        raise ValueError("this reference is DG(P1), Superbee and HLLC only")
    codes = {**{s: geometry.BC_EXTRAPOLATE for s in d["bc_extrapolate"]},
             **{s: geometry.BC_SYMMETRY for s in d["bc_sym"]}}
    g, eorder = geometry.build(mesh["coords"], mesh["inpoel"], mesh["bface"], codes,
                       device)
    system = euler.Euler(d["gamma"][0], initialize)
    return dg.Solver(system, g, d["cfl"], eorder, getattr(torch, precision))
