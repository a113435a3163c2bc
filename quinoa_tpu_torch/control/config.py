"""Typed inciter and walker configuration from parsed decks, and their
builders.

The port's own copy of quinoa_tpu/control/config.py (the reference's Inciter and Walker
InputDecks, src/Control/*/InputDeck/InputDeck.hpp, and the drivers'
setup): ``load_inciter`` and ``load_walker`` turn the parsed tree into an
``InciterConfig`` or a ``WalkerConfig`` exactly as the JAX package does;
``build_inciter`` and ``build_walker`` construct the port's solver or
walker the deck names, in ``dtype`` on ``device``, and
``build_inciter_spmd`` the sharded solver over a list of devices.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base.profiler import span
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


def _problem(cfg: InciterConfig):
    """The deck's transport or compflow problem, with the JAX builder's
    parameter mapping (None for multimat, whose system _mm_system
    builds)."""
    from ..pde import problems as prob_mod
    from ..pde.eos import StiffenedGas

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
        return cls(ncomp=cfg.ncomp, **kwargs)
    if cfg.pde == "multimat":
        return None
    # only the deck parameters that are fields of the problem, plus its
    # equation of state (never a mapping beyond these)
    cls = getattr(prob_mod, _PROBLEMS_COMPFLOW[cfg.problem])
    fields = {f.name for f in dataclasses.fields(cls)}
    for k, v in cfg.params.items():
        if k in fields:
            kwargs[k] = v
    if "eos" in fields:
        kwargs["eos"] = StiffenedGas(gamma=cfg.gamma, pstiff=cfg.pstiff)
    return cls(**kwargs)


def _mm_system(cfg: InciterConfig):
    """(MultiMatSystem, ndof) of a multimat deck: scheme dg = DG(P0), the
    reference fork's parity surface (DGMultiMat.hpp:154 asserts ndof==1);
    scheme dgp1 = DG(P1) with consistent material-fraction limiting."""
    from ..pde import problems as prob_mod
    from ..pde.eos import StiffenedGas
    from ..pde.multimat import MultiMatSystem

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
    if cfg.scheme not in ("dg", "dgp1"):
        raise ValueError(
            f"multimat supports scheme dg (P0) or dgp1, not {cfg.scheme!r}")
    system = MultiMatSystem(
        problem,
        intsharp=bool(cfg.params.get("intsharp", 0)),
        thinc_beta=cfg.params.get("intsharp_param", 2.5))
    return system, _SCHEME_NDOF[cfg.scheme]


def _bcnodes(cfg: InciterConfig, mesh):
    """The Dirichlet nodes of a CG deck's side sets, or None."""
    bcnodes = [mesh.bnode[ss] for ss in cfg.bc_dirichlet
               if ss in mesh.bnode]
    return np.unique(np.concatenate(bcnodes)) if bcnodes else None


def build_inciter(cfg: InciterConfig, mesh, dtype: Optional[torch.dtype] = None,
                  device=DEFAULT_DEVICE):
    """Construct the solver named by the deck for a host mesh.

    Returns (solver, diagnostics): DiagCG, ALECG, multimat or DG per
    cfg.scheme and cfg.pde, with the JAX builder's branches and
    parameter mapping.  dtype None is torch's default float, the
    counterpart of the JAX builders' default (jax's default float); the
    solver lives on ``device``, the card unless the caller asks for
    another.  Spans (base/profiler.py): build, and inside it geometry
    (pde/dg.py build_dggeom, or make_cggeom) and solver, the solver's
    constructor.
    """
    with span("build"):
        return _build_inciter(cfg, mesh, dtype, device)


def _build_inciter(cfg, mesh, dtype, device):
    from ..pde import dg

    if dtype is None:
        dtype = torch.get_default_dtype()
    cfl = cfg.cfl if cfg.cfl is not None else 0.5
    problem = _problem(cfg)

    if cfg.scheme in ("diagcg", "alecg"):
        from ..inciter import DiagCGSolver, Diagnostics, make_alecg
        from ..pde.cg import CGTransport, make_cggeom
        from ..pde.cg_compflow import CGCompFlow

        system = (CGTransport(problem) if cfg.pde == "transport"
                  else CGCompFlow(problem))
        bcnodes = _bcnodes(cfg, mesh)
        if cfg.scheme == "alecg":
            # RK3 + edge-Rusanov scheme (Scheme.hpp:44-48 kw::alecg)
            with span("solver"):
                solver = make_alecg(system, mesh, cfl=cfl, const_dt=cfg.dt,
                                    bcnodes=bcnodes, dtype=dtype,
                                    device=device)
                return solver, Diagnostics(system, solver.geom)
        with span("geometry"):
            geom = make_cggeom(mesh, dtype=dtype, device=device)
        with span("solver"):
            solver = DiagCGSolver(system, geom, cfl=cfl, const_dt=cfg.dt,
                                  ctau=cfg.ctau, fct=cfg.fct,
                                  bcnodes=bcnodes)
            return solver, Diagnostics(system, geom)

    from ..inciter.dg import DGDiagnostics

    if cfg.pde == "multimat":
        from ..pde.multimat import MultiMatSolver

        system, mm_ndof = _mm_system(cfg)
        geom = dg.build_dggeom(mesh, ndof=mm_ndof,
                               bc_sidesets=_bc_codes(cfg, dg, inflow=False),
                               dtype=dtype, device=device)
        with span("solver"):
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
        with span("solver"):
            solver = DGSolver(
                system, geom, cfl=cfl, const_dt=cfg.dt, limiter=cfg.limiter,
                cweight=cfg.cweight, pref=(cfg.scheme == "pdg") or cfg.pref,
                tolref=cfg.tolref,
                # P0P1 = rDG: evolve the cell average only, faces see the
                # (frozen/limited) P1 dofs (Scheme.hpp:45, Grammar.hpp:378)
                evolve_ndof=1 if cfg.scheme == "p0p1" else None)
            return solver, DGDiagnostics(system, geom)

    raise ValueError(f"unknown scheme {cfg.scheme!r}")


def build_inciter_spmd(cfg: InciterConfig, mesh, npes: int, devices=None,
                       virtualization: float = 0.0, hierarchy=None,
                       epart=None, elem_weights=None,
                       dtype: Optional[torch.dtype] = None):
    """The sharded solver named by the deck over npes shards, as the JAX
    build_inciter_spmd builds it (quinoa_tpu/control/config.py:406-642):
    the host mesh is partitioned into npes shards (or, with
    virtualization > 0, into linearLoadDistributor-many chunks packed
    onto them), and the scheme's sharded solver runs them.  ``devices``
    (the JAX package's device mesh) lists the devices the shards go on,
    shard s on devices[s % len(devices)]; default the card.  Returns the
    solver; its diagnostics() folds the owned sums over the shards.
    """
    from ..parallel import ShardGroup
    from ..pde import dg

    if epart is not None and (cfg.scheme not in _SCHEME_NDOF
                              or cfg.pde == "multimat"
                              or virtualization > 0.0):
        raise ValueError("an explicit element partition (load "
                         "balancing) requires a DG scheme without -u")
    if elem_weights is not None and (cfg.scheme not in _SCHEME_NDOF
                                     or cfg.pde == "multimat"
                                     or virtualization <= 0.0):
        raise ValueError("element weights (chunk re-packing) require a "
                         "DG scheme under -u")
    if dtype is None:
        dtype = torch.get_default_dtype()
    if devices is None:
        devices = [DEFAULT_DEVICE]
    from ..device import resolve_device

    group = ShardGroup(npes, [resolve_device(d) for d in devices])
    cfl = cfg.cfl if cfg.cfl is not None else 0.5

    if cfg.pde == "multimat":
        from ..parallel import SPMDMultiMatSolver, build_dg_shards

        # the JAX builder cuts multimat into npes shards whatever -u says
        system, mm_ndof = _mm_system(cfg)
        sharded = build_dg_shards(
            mesh, npes, ndof=mm_ndof,
            bc_sidesets=_bc_codes(cfg, dg, inflow=False),
            algorithm=cfg.partitioner, hierarchy=hierarchy, dtype=dtype,
            group=group)
        return SPMDMultiMatSolver(
            system, sharded, cfl=cfl, const_dt=cfg.dt,
            limiter=("superbeep1" if mm_ndof == 4 else None))

    problem = _problem(cfg)
    if virtualization > 0.0 and hierarchy is not None:
        raise ValueError(
            "multi-slice hierarchy with virtualization is not "
            "supported yet: chunk LPT packing would have to be "
            "slice-aware to preserve the intra-slice halo locality")
    if virtualization > 0.0 and cfg.scheme not in (
            "diagcg", "alecg", "dg", "p0p1", "dgp1", "dgp2", "pdg"):
        raise ValueError(
            "virtualization (overdecomposition) is implemented for "
            "diagcg, alecg, and the DG schemes; run others with "
            "virtualization 0")

    if cfg.scheme in ("diagcg", "alecg"):
        from ..parallel import (SPMDALECGSolver, SPMDDiagCGSolver,
                                build_alecg_shards, build_cg_shards)
        from ..parallel import overdecomp
        from ..pde.cg import CGTransport
        from ..pde.cg_compflow import CGCompFlow

        system = (CGTransport(problem) if cfg.pde == "transport"
                  else CGCompFlow(problem))
        bcnodes = _bcnodes(cfg, mesh)
        over = None
        kw = dict(bcnodes=bcnodes, algorithm=cfg.partitioner, dtype=dtype,
                  group=group)
        if cfg.scheme == "alecg":
            if virtualization > 0.0:
                over = overdecomp.build_overdecomposed_alecg(
                    mesh, npes, virtualization, system.ncomp, **kw)
                sharded = over.sharded
            else:
                sharded = build_alecg_shards(mesh, npes, system.ncomp,
                                             hierarchy=hierarchy, **kw)
            solver = SPMDALECGSolver(system, sharded, cfl=cfl,
                                     const_dt=cfg.dt)
        else:
            if virtualization > 0.0:
                # linearLoadDistributor-many chunks, LPT-packed and
                # merged per shard (parallel/overdecomp.py)
                over = overdecomp.build_overdecomposed_cg(
                    mesh, npes, virtualization, system.ncomp, **kw)
                sharded = over.sharded
            else:
                sharded = build_cg_shards(mesh, npes, system.ncomp,
                                          hierarchy=hierarchy, **kw)
            solver = SPMDDiagCGSolver(system, sharded, cfl=cfl,
                                      const_dt=cfg.dt, ctau=cfg.ctau,
                                      fct=cfg.fct)
        # chunk bookkeeping for per-chare field writes (MeshWriter's
        # file-per-chare contract, MeshWriter.hpp:33-100)
        solver.overdecomp = over
        return solver

    if cfg.scheme in _SCHEME_NDOF:
        from ..parallel import SPMDDGSolver, build_dg_shards
        from ..parallel.overdecomp import build_overdecomposed_dg
        from ..pde.dg_compflow import DGCompFlow, DGTransport

        bc = _bc_codes(cfg, dg, inflow=True)
        system = (DGTransport(problem) if cfg.pde == "transport"
                  else DGCompFlow(problem, riemann_flux=cfg.flux))
        ndof = _SCHEME_NDOF[cfg.scheme]
        if virtualization > 0.0:
            over = build_overdecomposed_dg(
                mesh, npes, virtualization, ndof, bc_sidesets=bc,
                algorithm=cfg.partitioner, elem_weights=elem_weights,
                dtype=dtype, group=group)
            sharded = over.sharded
        else:
            over = None
            sharded = build_dg_shards(
                mesh, npes, ndof, bc_sidesets=bc, algorithm=cfg.partitioner,
                hierarchy=hierarchy, epart=epart, dtype=dtype, group=group)
        solver = SPMDDGSolver(
            system, sharded, cfl=cfl, const_dt=cfg.dt, limiter=cfg.limiter,
            cweight=cfg.cweight,
            evolve_ndof=1 if cfg.scheme == "p0p1" else None,
            pref=(cfg.scheme == "pdg") or cfg.pref, tolref=cfg.tolref)
        solver.overdecomp = over
        return solver

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


# ---------------------------------------------------------------------------
# walker
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WalkerConfig:
    title: str = ""
    nstep: int = 10**9
    term: float = float("inf")
    dt: float = 0.01
    npar: int = 1000
    ttyi: int = 1
    stat_interval: int = 1
    #: TxtFloatFormat for stat.txt (statistics block format/precision)
    stat_format: str = "scientific"
    stat_precision: int = 12
    ordinary: List[Tuple] = dataclasses.field(default_factory=list)
    central: List[Tuple] = dataclasses.field(default_factory=list)
    sdes: List[Any] = dataclasses.field(default_factory=list)
    pdf_interval: int = 0
    pdf_filetype: str = "txt"
    #: TxtFloatFormat for txt PDFs (default/fixed/scientific) + digits
    #: (PDFWriter.cpp:25-48); ours defaults to scientific/12 (a strict
    #: superset of the reference's 6-digit default — ndiff-compatible)
    pdf_format: str = "scientific"
    pdf_precision: int = 12
    #: PDFPolicy: overwrite (one file, rewritten) or multiple (filename
    #: gains a time suffix per output, Distributor.cpp:405-411);
    #: `evolution` parses but is dead code in the reference fork too
    pdf_policy: str = "overwrite"
    #: PDFCentering for mesh-based (gmsh/exodus) PDF output: elem
    #: (density on cells) or node (averaged to lattice nodes)
    pdf_centering: str = "elem"
    #: list of (name, term, binsizes, extents-or-None)
    pdfs: List[Tuple] = dataclasses.field(default_factory=list)
    #: seed from the deck's rngs block (`<rng> seed N end`), or None
    rng_seed: Optional[int] = None


_MOM_RE = re.compile(r"([A-Za-z])(\d*)")


def _parse_pdf_spec(spec: str):
    """'f2( o1 o2 : 0.2 0.2 ; -2 2 -4 4 )' ->
    (name, term, binsizes, extents or None, central flags).

    Case carries the same meaning as in moment requests (StatCtr):
    UPPERCASE variables sample the raw value (ordinary PDF), lowercase
    the FLUCTUATION value - <value> (central PDF,
    Statistics::accumulateCenPDF)."""
    name = spec.split("(", 1)[0].strip()
    body = spec.split("(", 1)[1].rsplit(")", 1)[0]
    if ";" in body:
        main, ext = body.split(";", 1)
        nums = [float(x) for x in ext.split()]
        extents = [(nums[2 * i], nums[2 * i + 1]) for i in range(len(nums) // 2)]
    else:
        main, extents = body, None
    vars_, bins = main.split(":")
    mm = _MOM_RE.findall(vars_)
    term = tuple((m[0].lower(), int(m[1]) - 1) for m in mm)
    central = tuple(m[0].islower() for m in mm)
    binsizes = [float(x) for x in bins.split()]
    return (name, term, binsizes, extents, central)


def _parse_moment(m: str) -> Tuple[bool, Tuple]:
    """'<x1x2>' -> (central?, ((depvar, comp0), ...)); uppercase=ordinary.
    An index-less variable means component 1 ('<R>' == '<R1>')."""
    body = m.strip("<>")
    vars_ = _MOM_RE.findall(body)
    central = any(ch.islower() for ch, _ in vars_)
    term = tuple((ch.lower(), (int(ix) if ix else 1) - 1) for ch, ix in vars_)
    return central, term


def _build_sde(kind: str, blk) -> Any:
    from .. import diffeq as dq
    from ..diffeq import initpolicy as ip

    depvar = first(blk, "depvar", "x")
    ncomp = _i(blk, "ncomp", None)

    def fl(key, default=()):
        return _floats(blk, key, default)

    if kind == "diag_ou":
        sde = dq.DiagOrnsteinUhlenbeck(
            depvar=depvar, sigmasq=fl("sigmasq"), theta=fl("theta"),
            mu=fl("mu"),
        )
    elif kind == "ornstein-uhlenbeck":
        n = len(fl("theta"))
        s2 = np.asarray(fl("sigmasq"))
        if s2.size == n * (n + 1) // 2:
            # upper-triangular rows, as the reference decks write the
            # symmetric covariance (OrnsteinUhlenbeck.hpp sigmasq)
            cov = np.zeros((n, n))
            cov[np.triu_indices(n)] = s2
            cov = cov + np.triu(cov, 1).T
        else:
            cov = s2.reshape(n, n)
        sde = dq.OrnsteinUhlenbeck(
            depvar=depvar, sigmasq=tuple(map(tuple, cov)),
            theta=fl("theta"), mu=fl("mu"),
        )
    elif kind == "beta":
        sde = dq.Beta(depvar=depvar, b=fl("b"), S=fl("S"), kappa=fl("kappa"))
    elif kind == "numfracbeta":
        sde = dq.NumberFractionBeta(
            depvar=depvar, b=fl("b"), S=fl("S"), kappa=fl("kappa"),
            rho2=fl("rho2"), rcomma=fl("rcomma"),
        )
    elif kind == "massfracbeta":
        sde = dq.MassFractionBeta(
            depvar=depvar, b=fl("b"), S=fl("S"), kappa=fl("kappa"),
            rho2=fl("rho2"), r=fl("r"),
        )
    elif kind == "mixnumfracbeta":
        sde = dq.MixNumberFractionBeta(
            depvar=depvar, bprime=fl("bprime"), S=fl("S"),
            kprime=fl("kappaprime"), rho2=fl("rho2"), rcomma=fl("rcomma"),
        )
    elif kind == "mixmassfracbeta":
        coeff = first(blk, "coeff", "decay")
        hts = hp = None
        if coeff == "hydrotimescale":
            from ..diffeq.hydro import hydro_table

            hts = tuple(hydro_table(n) for n in
                        (first(blk, "hydrotimescales") or ()))
            hp = tuple(hydro_table(n) for n in
                       (first(blk, "hydroproductions") or ()))
        sde = dq.MixMassFractionBeta(
            depvar=depvar, bprime=fl("bprime"), S=fl("S"),
            kprime=fl("kappaprime"), rho2=fl("rho2"), r=fl("r"),
            coeff=coeff, hts=hts, hp=hp,
        )
    elif kind == "dirichlet":
        sde = dq.Dirichlet(depvar=depvar, b=fl("b"), S=fl("S"),
                           kappa=fl("kappa"))
    elif kind == "gendir":
        # the deck keyword for the c_ij vector is `c` (kw::sde_c)
        sde = dq.GeneralizedDirichlet(
            depvar=depvar, b=fl("b"), S=fl("S"), kappa=fl("kappa"),
            cij=(fl("c") or fl("cij")),
        )
    elif kind == "mixdirichlet":
        norm = first(blk, "normalization", "light")
        # rho pre-sorted by normalization (Grammar.hpp:495-506); r_i =
        # rho_N/rho_i -+ 1 (MixDir_r)
        rho_s = tuple(sorted(fl("rho"), reverse=(norm == "light")))
        if norm == "light":
            r_v = tuple(rho_s[-1] / x + 1.0 for x in rho_s[:-1])
        else:
            r_v = tuple(rho_s[-1] / x - 1.0 for x in rho_s[:-1])
        sde = dq.MixDirichlet(
            depvar=depvar, b=fl("b"), S=fl("S"), kprime=fl("kappaprime"),
            rho=rho_s, r=r_v, coeff=first(blk, "coeff", "const_coeff"),
            normalization=norm,
        )
    elif kind == "gamma":
        sde = dq.Gamma(depvar=depvar, b=fl("b"), S=fl("S"),
                       kappa=fl("kappa"))
    elif kind == "skew-normal":
        sde = dq.SkewNormal(depvar=depvar, T=fl("T" if "T" in blk else "timescale"),
                            sigmasq=fl("sigmasq"), lam=fl("lambda"))
    elif kind == "wright-fisher":
        sde = dq.WrightFisher(depvar=depvar, omega=fl("omega"))
    elif kind == "position":
        # const_shear prescribes the hard-coded unit shear du1/dx2 = 1
        # (PositionCoeffPolicy / VelocityCoeffPolicy.cpp:22)
        pdU = (_SHEAR_DU if first(blk, "coeff", "const_shear")
               == "const_shear" else (0.0,) * 9)
        sde = dq.Position(depvar=depvar, dU=pdU)
        sde._couple_velocity = first(blk, "velocity")
    elif kind == "dissipation":
        sde = dq.Dissipation(
            depvar=depvar, c3=_f(blk, "C3", 1.0), c4=_f(blk, "C4", 0.25),
            com1=_f(blk, "COM1", 0.44), com2=_f(blk, "COM2", 0.9),
        )
        sde._couple_velocity = first(blk, "velocity")
    elif kind == "velocity":
        vcoeff = first(blk, "coeff", "const_shear")
        vhts = None
        if vcoeff == "hydrotimescale":
            from ..diffeq.hydro import hydro_table

            names = first(blk, "hydrotimescales") or ()
            vhts = hydro_table(names[0]) if names else None
        solve = first(blk, "solve", "fullvar")
        # the shear enters the fluctuation solve only (Velocity.hpp:84
        # zeroes m_dU for FULLVAR)
        vdU = (_SHEAR_DU if vcoeff == "const_shear"
               and solve == "fluctuation" else (0.0,) * 9)
        sde = dq.Velocity(depvar=depvar, c0=_f(blk, "c0", 2.1),
                          coeff=vcoeff, hts=vhts, dU=vdU,
                          variant=first(blk, "variant", "slm"))
        sde._couple_dissipation = first(blk, "dissipation")
    else:
        raise ValueError(f"unknown SDE block {kind!r}")

    # init policy
    init = first(blk, "init", "zero")
    n = sde.ncomp
    if init in ("zero", "raw"):
        sde.init = lambda k, np_, **kw: ip.init_zero(k, np_, n, **kw)
    elif init == "jointdelta":
        ic = first(blk, "icdelta") or {}
        spikes = [
            [(float(sp[i]), float(sp[i + 1])) for i in range(0, len(sp), 2)]
            for sp in occurrences(ic, "spike")
        ]
        sde.init = lambda k, np_, **kw: ip.init_jointdelta(k, np_, spikes,
                                                           **kw)
    elif init == "jointbeta":
        ic = first(blk, "icbeta") or {}
        pdfs = [
            tuple(float(x) for x in bp)
            for bp in occurrences(ic, "betapdf")
        ]
        sde.init = lambda k, np_, **kw: ip.init_jointbeta(k, np_, pdfs, **kw)
    elif init == "jointgaussian":
        ic = first(blk, "icgaussian") or {}
        gs = [
            (float(g[0]), float(g[1]))
            for g in occurrences(ic, "gaussian")
        ]
        sde.init = lambda k, np_, **kw: ip.init_jointgaussian(k, np_, gs,
                                                              **kw)
    elif init == "jointdirichlet":
        ic = first(blk, "icdirichlet") or {}
        als = first(ic, "dirichletpdf") or ()
        alphas = [float(x) for x in als]
        sde.init = lambda k, np_, **kw: ip.init_jointdirichlet(
            k, np_, alphas, **kw)
    elif init == "jointgamma":
        ic = first(blk, "icgamma") or {}
        gps = [
            (float(g[0]), float(g[1]))
            for g in occurrences(ic, "gammapdf")
        ]
        sde.init = lambda k, np_, **kw: ip.init_jointgamma(k, np_, gps, **kw)
    else:
        sde.init = lambda k, np_, **kw: ip.init_zero(k, np_, n, **kw)
    return sde


def load_walker(deck_text: str) -> WalkerConfig:
    tree = parse_deck(deck_text)
    cfg = WalkerConfig()
    cfg.title = first(tree, "title", "")
    w = first(tree, "walker")
    if w is None:
        raise ValueError("deck has no walker block")
    cfg.nstep = _i(w, "nstep", cfg.nstep)
    cfg.term = _f(w, "term", cfg.term)
    cfg.dt = _f(w, "dt", 0.01)
    cfg.npar = _i(w, "npar", 1000)
    cfg.ttyi = _i(w, "ttyi", 1)

    rngs = first(w, "rngs")
    if rngs:
        # entries are `<rng-name> [seed N | *_method m ...] end`; the
        # stream is jax threefry either way, but the deck seed is honored
        for opts in rngs.values():
            for toks in opts:
                if "seed" in toks:
                    cfg.rng_seed = int(toks[toks.index("seed") + 1])

    stats = first(w, "statistics")
    if stats is not None:
        cfg.stat_interval = _i(stats, "interval", 1)
        cfg.stat_format = first(stats, "format", cfg.stat_format)
        cfg.stat_precision = _i(stats, "precision", cfg.stat_precision)
        for m in occurrences(stats, "_moments"):
            central, term = _parse_moment(m)
            (cfg.central if central else cfg.ordinary).append(term)

    pdfs = first(w, "pdfs")
    if pdfs is not None:
        cfg.pdf_interval = _i(pdfs, "interval", 1)
        cfg.pdf_filetype = first(pdfs, "filetype", "txt")
        cfg.pdf_format = first(pdfs, "format", cfg.pdf_format)
        cfg.pdf_precision = _i(pdfs, "precision", cfg.pdf_precision)
        cfg.pdf_policy = first(pdfs, "policy", cfg.pdf_policy)
        cfg.pdf_centering = first(pdfs, "centering", cfg.pdf_centering)
        for spec in occurrences(pdfs, "_pdfs"):
            cfg.pdfs.append(_parse_pdf_spec(spec))

    from .qparser import _SDE_BLOCKS

    # deck order: the kinds as they first appear in the walker block, a
    # kind's blocks as they appear.  The order fixes each system's offset
    # and its key (fold_in(key, i)), so it must not depend on the hash
    # seed, as iterating the set _SDE_BLOCKS would.
    for kind in w:
        if kind in _SDE_BLOCKS:
            for blk in occurrences(w, kind):
                cfg.sdes.append(_build_sde(kind, blk))
    return cfg


#: hard-coded homogeneous-shear mean velocity gradient (du1/dx2 = 1),
#: VelocityCoeffPolicy.cpp:22
_SHEAR_DU = (0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def build_walker(cfg: WalkerConfig, seed: int = 0,
                 dtype: Optional[torch.dtype] = None, device=DEFAULT_DEVICE,
                 nshard: int = 1):
    """The Walker of a deck's systems, couplings resolved to offsets, in
    dtype (None: torch's default) on ``device`` (the card unless the
    caller asks for another); nshard > 1 folds its ensemble means over
    that many row blocks (walker --npes, the JAX builder's mesh)."""
    from ..walker import Walker

    systems = Walker.layout(cfg.sdes)
    # resolve cross-system couplings (deck `velocity u` / `dissipation o`
    # inside position/velocity/dissipation blocks) to particle offsets
    by_dv = {s.depvar: s for s in systems}
    for s in systems:
        cv = getattr(s, "_couple_velocity", None)
        if cv and cv in by_dv:
            s.velocity_offset = by_dv[cv].offset
        cd = getattr(s, "_couple_dissipation", None)
        if cd and cd in by_dv:
            s.dissipation_offset = by_dv[cd].offset
    return Walker(
        systems,
        npar=cfg.npar,
        dt=cfg.dt,
        seed=seed,
        ordinary=cfg.ordinary,
        central=cfg.central,
        dtype=dtype,
        device=device,
        nshard=nshard,
    )
