"""Plain reference of mm_sod_dgp1: two-material Euler, AUSM+up,
consistent Superbee, SSP-RK3 DG(P1) from the deck's settings, with the
initial state of Quinoa's src/PDE/MultiMat/Problem/SodShocktube.cpp
(material 0 left of x = 0.5 at density 1, p = 1; material 1 right of it
at density 0.125, p = 0.1; the absent material at fraction 1e-12)."""

import torch

from reference import dg, geometry, multimat
from reference.deck import parse

ALPHAMIN = 1.0e-12


def initialize(xyz, system):
    x = xyz[0]
    left = x < 0.5

    def pick(a, b):
        return torch.where(left, torch.full_like(x, a), torch.full_like(x, b))

    nm = system.nmat
    big = 1.0 - (nm - 1) * ALPHAMIN
    al = [pick(big, ALPHAMIN), pick(ALPHAMIN, big)]
    r, p = pick(1.0, 0.125), pick(1.0, 0.1)
    z = torch.zeros_like(x)
    rows = [None] * system.ncomp
    for k in range(nm):
        rows[system.a(k)] = al[k]
        rows[system.d(k)] = al[k] * r
        rows[system.e(k)] = al[k] * (p / (system.gammas[k] - 1.0))
    for i in range(3):
        rows[system.m(i)] = z
    return torch.stack(rows)


def make(deck_text, mesh, device, precision):
    """The float64 reference solver of the deck on the raw mesh
    {coords, inpoel, bface}, its elements in Hilbert order, its initial
    state sampled at quadrature points in the configuration's precision;
    the trace floors of the primitive variables are those of that
    precision (50 of its machine epsilons)."""
    d = parse(deck_text)
    if d["nmat"] != 2 or d["scheme"] != "dgp1":
        raise ValueError("this reference is the two-material Sod tube at DG(P1)")
    codes = {**{s: geometry.BC_EXTRAPOLATE for s in d["bc_extrapolate"]},
             **{s: geometry.BC_SYMMETRY for s in d["bc_sym"]}}
    g, eorder = geometry.build(mesh["coords"], mesh["inpoel"], mesh["bface"], codes,
                       device)
    system = multimat.MultiMat(
        d["gamma"], initialize, 50.0 * torch.finfo(getattr(torch, precision)).eps)
    return dg.Solver(system, g, d["cfl"], eorder, getattr(torch, precision))
