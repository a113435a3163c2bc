"""The route each DG and multimat branch of build_inciter picks when it
builds its solver (pde/dg_step.py choose_route): the limit pass, the
volume term, the face pass and the source of stage 0's dt, for P0, P1 and
P2, HLLC and Lax-Friedrichs, Superbee, WENO and no limiter, rDG p0p1,
p-adaptive P0, P1 and P2, Euler with a source, transport, Dirichlet faces,
a constant dt, multimat P0 and P1 with and without THINC and Dirichlet
faces, and sharded solvers whose Dirichlet face lies on one shard only
(every shard takes the group's route).  Construction only, on a 2x2x2
box on the CPU."""

import dataclasses

import pytest
import torch

from quinoa_tpu_torch.control import build_inciter, load_inciter
from quinoa_tpu_torch.control.config import build_inciter_spmd
from quinoa_tpu_torch.mesh import box_tet_mesh

SYM = "bc_sym sideset 1 2 3 4 5 6 end end"
SOD = "bc_extrapolate sideset 1 2 end end bc_sym sideset 3 4 5 6 end end"
#: Dirichlet on the z = 0 side, which one of two shards touches
DIR5 = "bc_dirichlet sideset 5 end end bc_sym sideset 1 2 3 4 6 end end"
DIR = "bc_dirichlet sideset 1 2 3 4 5 6 end end"
SEDOV = "compflow physics euler problem sedov_blastwave " + SYM
NLEG = "compflow problem nl_energy_growth "


def _deck(scheme, body, extra=""):
    return (f"inciter nstep 3 cfl 0.5 scheme {scheme} {extra}\n"
            f"  {body} end\nend\n")


def _mm(scheme, bc, extra=""):
    return _deck(scheme, f"multimat problem sod_shocktube nmat 2 {extra} "
                 + bc)


#: name -> (deck, shards or None, (limit, volume, face, dt))
CASES = {
    "p0_hllc": (_deck("dg", "compflow problem sod_shocktube " + SOD), None,
                ("none", "none", "k12_hllc", "charvel")),
    "p0_lf": (_deck("dg flux laxfriedrichs",
                    "compflow problem sod_shocktube " + SOD), None,
              ("none", "none", "k12_lf", "charvel")),
    "p0_const_dt": (_deck("dg", "compflow problem sod_shocktube " + SOD,
                          "dt 1.0e-3"), None,
                    ("none", "none", "k12_hllc", "const")),
    "p1_superbee": (_deck("dgp1", SEDOV, "limiter superbeep1"), None,
                    ("k1", "k1", "k12_hllc", "charvel")),
    "p1_lf_superbee": (_deck("dgp1 flux laxfriedrichs",
                             "compflow problem sod_shocktube " + SOD,
                             "limiter superbeep1"), None,
                       ("k1", "k1", "k12_lf", "charvel")),
    "p1_weno": (_deck("dgp1", SEDOV, "limiter wenop1"), None,
                ("weno", "plain", "k12_hllc", "charvel")),
    "p1_none": (_deck("dgp1", SEDOV), None,
                ("none", "plain", "k12_hllc", "charvel")),
    "p1_dirichlet": (_deck("dgp1", "compflow problem sedov_blastwave "
                           + DIR5, "limiter superbeep1"), None,
                     ("k1", "k1", "face_gp", "sweep")),
    "p2_none": (_deck("dgp2", SEDOV), None,
                ("none", "xla", "k12_hllc", "charvel")),
    "p2_lf": (_deck("dgp2 flux laxfriedrichs",
                    "compflow problem sod_shocktube " + SOD), None,
              ("none", "xla", "k12_lf", "charvel")),
    "p2_superbee": (_deck("dgp2", SEDOV, "limiter superbeep1"), None,
                    ("superbee_split", "xla", "k12_hllc", "charvel")),
    "p0p1": (_deck("p0p1", SEDOV, "limiter superbeep1"), None,
             ("k1", "k1", "k12_hllc", "charvel")),
    "pdg_p1": (_deck("pdg", SEDOV, "limiter superbeep1"), None,
               ("k1_pref", "k1", "k12_hllc", "charvel")),
    "pdg_p1_weno": (_deck("pdg", SEDOV, "limiter wenop1"), None,
                    ("weno", "plain", "k12_hllc", "charvel")),
    "pdg_p0": (_deck("dg", "compflow problem sod_shocktube " + SOD,
                     "pref tolref 0.1 end"), None,
               ("none", "xla", "face_gp", "sweep")),
    "pdg_p2": (_deck("dgp2", SEDOV, "limiter superbeep1 pref tolref 0.1 "
                     "end"), None,
               ("superbee_split", "xla", "face_gp", "sweep")),
    "source_p1": (_deck("dgp1", NLEG + SYM, "limiter superbeep1"), None,
                  ("k1", "k1_source", "k12_hllc", "charvel")),
    "source_pdg": (_deck("pdg", NLEG + SYM, "limiter superbeep1"), None,
                   ("k1_pref", "k1_source", "k12_hllc", "charvel")),
    "source_dirichlet": (_deck("dgp1", NLEG + DIR, "limiter superbeep1"),
                         None, ("k1", "k1_source", "face_gp", "sweep")),
    "transport_p0": (_deck("dg", "transport problem cyl_advect " + DIR),
                     None, ("none", "xla", "face_gp", "sweep")),
    "transport_p1": (_deck("dgp1", "transport problem gauss_hump ncomp 1 "
                           "bc_extrapolate sideset 1 2 3 4 5 6 end end",
                           "limiter superbeep1"), None,
                     ("superbee_split", "plain", "face_gp", "sweep")),
    "transport_pdg": (_deck("pdg", "transport problem gauss_hump ncomp 1 "
                            + DIR), None,
                      ("none", "plain", "face_gp", "sweep")),
    "mm_p0": (_mm("dg", SOD), None, ("none", "none", "k14", "charvel")),
    "mm_p0_thinc": (_mm("dg", SOD, "intsharp 1"), None,
                    ("none", "none", "k14", "charvel")),
    "mm_p0_dirichlet": (_mm("dg", DIR5), None,
                        ("none", "none", "mm_dirichlet", "sweep")),
    "mm_p1": (_mm("dgp1", SOD), None, ("k15", "k16", "k14", "charvel")),
    "mm_p1_thinc": (_mm("dgp1", SOD, "intsharp 1"), None,
                    ("k15", "k16", "k14_thinc", "charvel")),
    "mm_p1_dirichlet": (_mm("dgp1", DIR5), None,
                        ("k15", "k16", "mm_dirichlet", "sweep")),
    "mm_p1_thinc_dirichlet": (_mm("dgp1", DIR5, "intsharp 1"), None,
                              ("k15", "k16", "mm_dirichlet", "sweep")),
    "mm_p1_const_dt": (_mm("dgp1 dt 1.0e-5", SOD), None,
                       ("k15", "k16", "k14", "const")),
    "spmd_p1_dirichlet": (_deck("dgp1", "compflow problem sedov_blastwave "
                                + DIR5, "limiter superbeep1"), 2,
                          ("k1", "k1", "face_gp", "sweep")),
    "spmd_pdg": (_deck("pdg", SEDOV, "limiter superbeep1"), 2,
                 ("k1_pref", "k1", "k12_hllc", "charvel")),
    "spmd_mm_p1_dirichlet": (_mm("dgp1", DIR5), 2,
                             ("k15", "k16", "mm_dirichlet", "sweep")),
}


def build(deck, shards, dtype=torch.float64):
    """The solver of a CASES deck on the 2x2x2 box: (solver, the solvers
    that step, one a shard)."""
    cfg, mesh = load_inciter(deck), box_tet_mesh(2, 2, 2)
    if shards is None:
        solver = build_inciter(cfg, mesh, dtype=dtype, device="cpu")[0]
        return solver, [solver]
    solver = build_inciter_spmd(cfg, mesh, shards, devices=["cpu"],
                                dtype=dtype)
    return solver, solver.shards


@pytest.mark.parametrize("case", list(CASES))
def test_build_inciter_picks_the_route(case):
    deck, shards, want = CASES[case]
    _, steppers = build(deck, shards)
    for sv in steppers:
        assert dataclasses.astuple(sv.route) == want
    if shards is not None:
        # the Dirichlet face lies on one shard, the route is the group's
        has = [bool((sv.geom.bctype == 1).any()) for sv in steppers]
        assert has.count(True) == (0 if case == "spmd_pdg" else 1)
