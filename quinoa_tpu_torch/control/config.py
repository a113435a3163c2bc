"""Typed inciter configuration from parsed decks, and the solver builder.

The port's own copy of the inciter part of quinoa_tpu/control/config.py
(the reference's Inciter InputDeck, src/Control/Inciter/InputDeck/
InputDeck.hpp, and the InciterDriver setup): ``load_inciter`` turns the
parsed tree into an ``InciterConfig`` exactly as the JAX package does, and
``build_inciter`` constructs the port's solver the deck names, in ``dtype``
on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE

from .qparser import parse_deck, first, occurrences


def _f(tree, key, default=None):
    v = first(tree, key)
    return float(v) if v is not None else default


def _i(tree, key, default=None):
    v = first(tree, key)
    return int(v) if v is not None else default


def _floats(tree, key, default=()):
    v = first(tree, key)
    return tuple(float(x) for x in v) if v else tuple(default)


def _sidesets(block) -> List[int]:
    out: List[int] = []
    for b in occurrences(block, "sideset") if block else []:
        out += [int(x) for x in b]
    return out


@dataclasses.dataclass
class InciterConfig:
    title: str = ""
    nstep: int = 10**9
    term: float = float("inf")
    t0: float = 0.0
    dt: Optional[float] = None
    cfl: Optional[float] = None
    ttyi: int = 1
    ctau: float = 1.0
    fct: bool = True
    scheme: str = "diagcg"
    flux: str = "hllc"
    limiter: Optional[str] = None
    cweight: float = 30.0
    pref: bool = False
    tolref: float = 0.1  # reference default: InputDeck.hpp:232
    pde: str = "transport"  # transport | compflow
    problem: str = "slot_cyl"
    ncomp: int = 1
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    gamma: float = 1.4
    pstiff: float = 0.0
    bc_dirichlet: List[int] = dataclasses.field(default_factory=list)
    bc_sym: List[int] = dataclasses.field(default_factory=list)
    bc_extrapolate: List[int] = dataclasses.field(default_factory=list)
    bc_inlet: List[int] = dataclasses.field(default_factory=list)
    bc_outlet: List[int] = dataclasses.field(default_factory=list)
    diag_interval: int = 1
    #: TxtFloatFormat for the diag file (format/precision keywords in
    #: the diagnostics block); scientific/12 preserves existing output
    diag_format: str = "scientific"
    diag_precision: int = 12
    field_interval: int = 10**9
    # AMR (amr block: src/Control/Inciter/InputDeck + Refiner options)
    t0ref: bool = False
    amr_initial: List[str] = dataclasses.field(default_factory=list)
    coordref: Dict[str, float] = dataclasses.field(default_factory=dict)
    dtref: bool = False
    dtref_uniform: bool = False
    dtfreq: int = 3
    amr_error: str = "jump"
    # flat node-id pairs from `edgelist ... end` (AMRInitial edgelist,
    # Refiner::edgelistRefine, src/Inciter/Refiner.cpp:1002-1040);
    # 0-based node ids as read from the mesh file
    amr_edgelist: Tuple[int, ...] = ()
    amr_tol: float = 0.2
    amr_tolderef: float = 0.05
    # depth cap for the incremental multi-level dtref cycle
    # (amr/adapt.py).  DEFAULT 4 = the reference's hard-coded
    # MAX_REFINEMENT_LEVEL (refinement.hpp:28,60): during-timestep AMR
    # refines incrementally from the CURRENT mesh through the
    # persistent-intermediates machine, compounding to depth 4, exactly
    # as Refiner.cpp:241-260 reuses one long-lived mesh_adapter per
    # event.  `maxlevels 1` opts out to the single-level
    # retag-from-base scheme (an extension this repo keeps for cheap
    # one-level tracking runs).
    amr_maxlevels: int = 4
    partitioner: str = "sfc"  # rcb/rib/hsfc/mj/phg (partition.py), else sfc


_SCHEME_NDOF = {"dg": 1, "p0p1": 4, "dgp1": 4, "dgp2": 10, "pdg": 4}

_PROBLEMS_TRANSPORT = {
    "slot_cyl": "SlotCyl",
    "gauss_hump": "GaussHump",
    "cyl_advect": "CylAdvect",
    "shear_diff": "ShearDiff",
}
_PROBLEMS_COMPFLOW = {
    "user_defined": "UserDefined",
    "vortical_flow": "VorticalFlow",
    "nl_energy_growth": "NLEnergyGrowth",
    "rayleigh_taylor": "RayleighTaylor",
    "taylor_green": "TaylorGreen",
    "sod_shocktube": "SodShocktube",
    "rotated_sod_shocktube": "RotatedSodShocktube",
    "sedov_blastwave": "SedovBlastwave",
}

_LIMITERS = {"nolimiter": None, "wenop1": "wenop1", "superbeep1": "superbeep1"}


def load_inciter(deck_text: str) -> InciterConfig:
    tree = parse_deck(deck_text)
    cfg = InciterConfig()
    cfg.title = first(tree, "title", "")
    inc = first(tree, "inciter")
    if inc is None:
        raise ValueError("deck has no inciter block")
    cfg.nstep = _i(inc, "nstep", cfg.nstep)
    cfg.term = _f(inc, "term", cfg.term)
    cfg.t0 = _f(inc, "t0", 0.0)
    cfg.dt = _f(inc, "dt")
    cfg.cfl = _f(inc, "cfl")
    cfg.ttyi = _i(inc, "ttyi", 1)
    cfg.ctau = _f(inc, "ctau", 1.0)
    cfg.fct = first(inc, "fct", "true") != "false"
    cfg.scheme = first(inc, "scheme", "diagcg")
    cfg.flux = first(inc, "flux", "hllc")
    cfg.limiter = _LIMITERS.get(first(inc, "limiter", "nolimiter"))
    cfg.cweight = _f(inc, "cweight", 30.0)
    pref = first(inc, "pref")
    if pref is not None:
        cfg.pref = True
        cfg.tolref = _f(pref, "tolref", 0.1)

    for pde in ("transport", "compflow", "multimat"):
        blk = first(inc, pde)
        if blk is not None:
            cfg.pde = pde
            cfg.problem = first(blk, "problem", cfg.problem)
            cfg.ncomp = _i(blk, "ncomp", 1)
            mat = first(blk, "material")
            if mat is not None:
                g = _floats(mat, "gamma", (1.4,))
                cfg.gamma = g[0]
                cfg.pstiff = _floats(mat, "pstiff", (0.0,))[0]
                cfg.params["gammas"] = g
                cfg.params["cvs"] = _floats(mat, "cv", (717.5,) * len(g))
            nm = _i(blk, "nmat")
            if nm is not None:
                cfg.params["nmat"] = nm
            ints = _i(blk, "intsharp")
            if ints is not None:
                cfg.params["intsharp"] = ints
            ip = _f(blk, "intsharp_param")
            if ip is not None:
                cfg.params["intsharp_param"] = ip
            for p in ("alpha", "beta", "p0", "r0", "ce", "kappa",
                      "betax", "betay", "betaz"):
                v = _f(blk, p)
                if v is not None:
                    cfg.params[p] = v
            for p in ("diffusivity", "u0", "lambda"):
                v = _floats(blk, p, ())
                if v:
                    cfg.params[p] = v
            cfg.bc_dirichlet = _sidesets(first(blk, "bc_dirichlet"))
            cfg.bc_sym = _sidesets(first(blk, "bc_sym"))
            cfg.bc_extrapolate = _sidesets(first(blk, "bc_extrapolate"))
            cfg.bc_inlet = _sidesets(first(blk, "bc_inlet"))
            cfg.bc_outlet = _sidesets(first(blk, "bc_outlet"))
            break

    part = first(inc, "partitioning")
    if part is not None:
        # all five reference algorithms are implemented
        # (PartitioningAlgorithm.hpp:61-65 -> parallel/partition.py)
        alg = first(part, "algorithm", "mj")
        cfg.partitioner = alg if alg in (
            "rcb", "rib", "hsfc", "mj", "phg") else "sfc"

    amr = first(inc, "amr")
    if amr is not None:
        cfg.t0ref = first(amr, "t0ref", "false") == "true"
        cfg.amr_initial = occurrences(amr, "initial")
        cfg.dtref = first(amr, "dtref", "false") == "true"
        cfg.dtref_uniform = first(amr, "dtref_uniform", "false") == "true"
        cfg.dtfreq = _i(amr, "dtfreq", 3)
        cfg.amr_error = first(amr, "error", "jump")
        el = first(amr, "edgelist")
        if el:
            cfg.amr_edgelist = tuple(int(x) for x in el)
            if len(cfg.amr_edgelist) % 2 == 1:
                raise ValueError(
                    "edgelist must contain an even number of node ids "
                    "(node pairs; Grammar.hpp:483)")
        cfg.amr_tol = _f(amr, "tol_refine", 0.2)
        cfg.amr_tolderef = _f(amr, "tol_derefine", 0.05)
        cfg.amr_maxlevels = int(_f(amr, "maxlevels", 4))
        # halfspace extents live in the coordref sub-block
        # (Grammar.hpp half_world; older test decks also wrote them
        # directly in amr, so accept both)
        for blk in (first(amr, "coordref"), amr):
            if blk is None:
                continue
            for hs in ("x-", "x+", "y-", "y+", "z-", "z+"):
                v = _f(blk, hs)
                if v is not None and hs not in cfg.coordref:
                    cfg.coordref[hs] = v

    diag = first(inc, "diagnostics")
    if diag is not None:
        cfg.diag_interval = _i(diag, "interval", 1)
        cfg.diag_format = first(diag, "format", cfg.diag_format)
        cfg.diag_precision = _i(diag, "precision", cfg.diag_precision)
    plot = first(inc, "plotvar") or first(inc, "field_output")
    if plot is not None:
        cfg.field_interval = _i(plot, "interval", cfg.field_interval)
    return cfg



def _bc_codes(cfg: InciterConfig, dg, inflow: bool) -> Dict[int, int]:
    """Side-set id -> DG BC code, later keywords overriding earlier ones
    as the JAX builder assigns them (inlet/outlet only off multimat)."""
    bc = {}
    pairs = [(cfg.bc_dirichlet, dg.BC_DIRICHLET), (cfg.bc_sym, dg.BC_SYMMETRY),
             (cfg.bc_extrapolate, dg.BC_EXTRAPOLATE)]
    if inflow:
        pairs += [(cfg.bc_inlet, dg.BC_INLET), (cfg.bc_outlet, dg.BC_OUTLET)]
    for sidesets, code in pairs:
        for ss in sidesets:
            bc[ss] = code
    return bc


def build_inciter(cfg: InciterConfig, mesh, dtype: Optional[torch.dtype] = None,
                  device=DEFAULT_DEVICE):
    """Construct the solver named by the deck for a host mesh.

    Returns (solver, diagnostics): DiagCG, ALECG, multimat or DG per
    cfg.scheme and cfg.pde, with the JAX builder's branches and
    parameter mapping.  dtype None is torch's default float, the
    counterpart of the JAX builders' default (jax's default float); the
    solver lives on ``device``, the card unless the caller asks for
    another.
    """
    from ..pde import dg
    from ..pde import problems as prob_mod
    from ..pde.eos import StiffenedGas

    if dtype is None:
        dtype = torch.get_default_dtype()
    cfl = cfg.cfl if cfg.cfl is not None else 0.5
    kwargs = {}
    if cfg.pde == "transport":
        cls = getattr(prob_mod, _PROBLEMS_TRANSPORT[cfg.problem])
        if cfg.problem == "shear_diff":
            if "u0" in cfg.params:
                kwargs["u0"] = cfg.params["u0"]
            if "lambda" in cfg.params:
                kwargs["lam"] = cfg.params["lambda"]
            if "diffusivity" in cfg.params:
                kwargs["diffusivity"] = cfg.params["diffusivity"]
        problem = cls(ncomp=cfg.ncomp, **kwargs)
    elif cfg.pde == "multimat":
        problem = None  # constructed in the multimat branch below
    else:
        # only the deck parameters that are fields of the problem, plus
        # its equation of state (never a mapping beyond these)
        cls = getattr(prob_mod, _PROBLEMS_COMPFLOW[cfg.problem])
        fields = {f.name for f in dataclasses.fields(cls)}
        for k, v in cfg.params.items():
            if k in fields:
                kwargs[k] = v
        if "eos" in fields:
            kwargs["eos"] = StiffenedGas(gamma=cfg.gamma, pstiff=cfg.pstiff)
        problem = cls(**kwargs)

    if cfg.scheme in ("diagcg", "alecg"):
        from ..inciter import DiagCGSolver, Diagnostics, make_alecg
        from ..pde.cg import CGTransport, make_cggeom
        from ..pde.cg_compflow import CGCompFlow

        system = (CGTransport(problem) if cfg.pde == "transport"
                  else CGCompFlow(problem))
        bcnodes = [mesh.bnode[ss] for ss in cfg.bc_dirichlet
                   if ss in mesh.bnode]
        bcnodes = np.unique(np.concatenate(bcnodes)) if bcnodes else None
        if cfg.scheme == "alecg":
            # RK3 + edge-Rusanov scheme (Scheme.hpp:44-48 kw::alecg)
            solver = make_alecg(system, mesh, cfl=cfl, const_dt=cfg.dt,
                                bcnodes=bcnodes, dtype=dtype, device=device)
            return solver, Diagnostics(system, solver.geom)
        geom = make_cggeom(mesh, dtype=dtype, device=device)
        solver = DiagCGSolver(system, geom, cfl=cfl, const_dt=cfg.dt,
                              ctau=cfg.ctau, fct=cfg.fct, bcnodes=bcnodes)
        return solver, Diagnostics(system, geom)

    from ..inciter.dg import DGDiagnostics

    if cfg.pde == "multimat":
        from ..pde.multimat import MultiMatSolver, MultiMatSystem

        nmat = cfg.params.get("nmat", 2)
        eos = tuple(
            StiffenedGas(gamma=g, cv=cv)
            for g, cv in zip(cfg.params.get("gammas", (1.4,) * nmat),
                             cfg.params.get("cvs", (717.5,) * nmat)))
        mm_problems = {"interface_advection": prob_mod.MMInterfaceAdvection,
                       "sod_shocktube": prob_mod.MMSodShocktube,
                       "smooth_wave": prob_mod.MMSmoothWave}
        if cfg.problem not in mm_problems:
            raise ValueError(f"unknown multimat problem {cfg.problem!r}")
        problem = mm_problems[cfg.problem](nmat=nmat, eos=eos)
        # scheme dg = DG(P0), the reference fork's parity surface
        # (DGMultiMat.hpp:154 asserts ndof==1); scheme dgp1 = DG(P1)
        # with consistent material-fraction limiting
        if cfg.scheme not in ("dg", "dgp1"):
            raise ValueError(
                f"multimat supports scheme dg (P0) or dgp1, not "
                f"{cfg.scheme!r}")
        mm_ndof = _SCHEME_NDOF[cfg.scheme]
        geom = dg.build_dggeom(mesh, ndof=mm_ndof,
                               bc_sidesets=_bc_codes(cfg, dg, inflow=False),
                               dtype=dtype, device=device)
        system = MultiMatSystem(
            problem,
            intsharp=bool(cfg.params.get("intsharp", 0)),
            thinc_beta=cfg.params.get("intsharp_param", 2.5))
        solver = MultiMatSolver(
            system, geom, cfl=cfl, const_dt=cfg.dt,
            limiter=("superbeep1" if mm_ndof == 4 else None))
        return solver, DGDiagnostics(system, geom)

    if cfg.scheme in _SCHEME_NDOF:
        from ..inciter.dg import DGSolver
        from ..pde.dg_compflow import DGCompFlow, DGTransport

        geom = dg.build_dggeom(mesh, ndof=_SCHEME_NDOF[cfg.scheme],
                               bc_sidesets=_bc_codes(cfg, dg, inflow=True),
                               dtype=dtype, device=device)
        system = (DGTransport(problem) if cfg.pde == "transport"
                  else DGCompFlow(problem, riemann_flux=cfg.flux))
        solver = DGSolver(
            system, geom, cfl=cfl, const_dt=cfg.dt, limiter=cfg.limiter,
            cweight=cfg.cweight, pref=(cfg.scheme == "pdg") or cfg.pref,
            tolref=cfg.tolref,
            # P0P1 = rDG: evolve the cell average only, faces see the
            # (frozen/limited) P1 dofs (Scheme.hpp:45, Grammar.hpp:378)
            evolve_ndof=1 if cfg.scheme == "p0p1" else None)
        return solver, DGDiagnostics(system, geom)

    raise ValueError(f"unknown scheme {cfg.scheme!r}")


def apply_t0ref(cfg: InciterConfig, mesh, problem=None):
    """Initial (t < 0) adaptive refinement passes (the Refiner's t0ref),
    as the JAX package's apply_t0ref: each `initial ...` mode in deck
    order, one multi-pass refinement pass each over the intermediates
    state carried between them; uniform_derefine undoes the most recent
    refinement pass.  Returns the refined host mesh.  The `ic` mode tags
    by the error of problem's initial solution and raises without a
    problem, as the JAX package's does."""
    from ..amr import derefine_mesh, tag_edges_by_coords, tag_edges_by_error
    from ..amr.multipass import AMRState, refine_pass
    from ..mesh.derived import gen_inpoed

    state = AMRState()  # persistent intermediates across the passes
    hist = []  # (coarse mesh, refmap) per applied refinement pass
    for mode in cfg.amr_initial:
        if mode == "uniform":
            # mark_uniform_refinement: tag every (unlocked) edge
            tags = gen_inpoed(mesh.inpoel).astype(np.int64)
        elif mode == "coords":
            kw = {}
            names = {"x-": "xminus", "x+": "xplus", "y-": "yminus",
                     "y+": "yplus", "z-": "zminus", "z+": "zplus"}
            for k, v in cfg.coordref.items():
                kw[names[k]] = v
            tags = tag_edges_by_coords(mesh, **kw)
        elif mode == "ic":
            if problem is None:
                raise ValueError("initial-conditions t0ref needs a problem")
            xyz = torch.as_tensor(mesh.coords.T,
                                  dtype=torch.get_default_dtype())
            u = problem.solution(xyz, 0.0).cpu().numpy()
            tags = tag_edges_by_error(mesh, u, method=cfg.amr_error,
                                      tol=cfg.amr_tol)
        elif mode == "edgelist":
            # exactly the user-listed edges that exist in the mesh
            # (Refiner::edgelistRefine)
            want = {tuple(sorted(cfg.amr_edgelist[i:i + 2]))
                    for i in range(0, len(cfg.amr_edgelist), 2)}
            edges = gen_inpoed(mesh.inpoel)
            hit = np.array([tuple(e) in want for e in edges.tolist()])
            tags = edges[hit] if hit.any() else np.zeros((0, 2), np.int64)
            if not len(tags):
                continue
        elif mode == "uniform_derefine":
            if hist:
                coarse, rmap = hist.pop()
                new, _, _ = derefine_mesh(
                    coarse, rmap, np.ones(coarse.nelem, dtype=bool))
                mesh = coarse if new is None else new
                # the popped pass was all-1:8 (its rmap would have been
                # refused below otherwise): no partial template is live
                state = AMRState()
            continue
        else:
            raise ValueError(f"unknown amr initial mode {mode!r}")
        coarse = mesh
        mesh, rmap, state = refine_pass(mesh, tags, state)
        # uniform_derefine can only undo a pass whose parent map is
        # complete (no 2:8/4:8 rebuilds folded in)
        if (rmap.parent >= 0).all():
            hist.append((coarse, rmap))
        else:
            hist.clear()
    return mesh
